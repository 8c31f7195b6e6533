// Hand-written Hopper kernels of the heat-diffusion perf path.
//
// Two kernels, each one explicit diffusion step on a 2D or 3D field:
//
//   rmt_masked_step   — out = T + Cm * lap(T) on an UNPADDED field, where
//                       lap = sum_ax ((T[i+1] + T[i-1]) - 2 T) * inv_d2[ax]
//                       and neighbours outside the field read as 0.
//                       Replaces rocm_mpi_tpu/ops/pallas_kernels.py
//                       masked_step (_per_step_kernel, and at small sizes
//                       the one-step form of _multi_step_kernel).
//   rmt_fused_step_cm — out = c + Cm * lap from a width-1-PADDED block Tp,
//                       where c = Tp[core] and
//                       lap = sum_ax ((hi - 2 c) + lo) * inv_d2[ax].
//                       Replaces pallas_kernels.py fused_step_cm
//                       (_fused_kernel_whole_cm / _fused_kernel_striped_cm).
//
// The two sum in different orders, each exactly as its TPU kernel does, so
// each stays bitwise-comparable with its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/kernels.py). Build with -fmad=false: a contracted
// multiply-add rounds once where the plain version rounds twice.
//
// Bound on the card: memory. Per cell the step reads T (or Tp) and Cm and
// writes out — 12 bytes in f32 against ~11 flops, far below the H100's
// ratio of peak flops to bytes. The design keeps that to one pass each:
// threads are laid out along the last (contiguous) axis so a warp reads
// whole 128-byte lines, and the 2·ndim neighbour reads of a cell hit the
// lines its block's other threads already pulled into L1/L2. No TPU
// stripes or 3-slot blocks: a plain 2D grid of 32x8 blocks (plus the
// leading axis on grid.z in 3D), ragged edges masked, 64-bit offsets.
//
// bf16 is storage-only: loads are widened to f32, the step is computed in
// f32 and rounded to bf16 once on store (pallas_kernels._upcast_for_compute).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;  // along the last, contiguous axis
constexpr int kBlockY = 8;   // along the second-to-last axis

enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename S> struct Compute { using type = S; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S> __device__ __forceinline__ S narrow(typename Compute<S>::type v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Cell index of this thread: (i0, i1, i2) over an (n0, n1, n2) field, with
// n2 == 1 in 2D. Returns false for threads past the ragged edge.
template <int NDIM>
__device__ __forceinline__ bool cell(int64_t n0, int64_t n1, int64_t n2,
                                     int64_t* i0, int64_t* i1, int64_t* i2) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  if (NDIM == 2) {
    *i0 = y;
    *i1 = x;
    *i2 = 0;
  } else {
    *i0 = blockIdx.z;
    *i1 = y;
    *i2 = x;
  }
  return *i0 < n0 && *i1 < n1 && *i2 < n2;
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
masked_step_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                   S* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                   typename Compute<S>::type inv0,
                   typename Compute<S>::type inv1,
                   typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!cell<NDIM>(n0, n1, n2, &i0, &i1, &i2)) return;
  const int64_t s1 = n2;       // stride of axis 1 (1 in 2D)
  const int64_t s0 = n1 * n2;  // stride of axis 0
  const int64_t idx = i0 * s0 + i1 * s1 + i2;
  const C zero = C(0);
  const C two = C(2);
  const C c = widen(T[idx]);

  // Axis 0, then 1, then 2: lap = (t0 + t1) + t2, as the TPU kernel sums.
  const C up0 = i0 + 1 < n0 ? widen(T[idx + s0]) : zero;
  const C dn0 = i0 > 0 ? widen(T[idx - s0]) : zero;
  C lap = ((up0 + dn0) - two * c) * inv0;
  if (NDIM == 2) {
    const C up1 = i1 + 1 < n1 ? widen(T[idx + 1]) : zero;
    const C dn1 = i1 > 0 ? widen(T[idx - 1]) : zero;
    lap = lap + ((up1 + dn1) - two * c) * inv1;
  } else {
    const C up1 = i1 + 1 < n1 ? widen(T[idx + s1]) : zero;
    const C dn1 = i1 > 0 ? widen(T[idx - s1]) : zero;
    lap = lap + ((up1 + dn1) - two * c) * inv1;
    const C up2 = i2 + 1 < n2 ? widen(T[idx + 1]) : zero;
    const C dn2 = i2 > 0 ? widen(T[idx - 1]) : zero;
    lap = lap + ((up2 + dn2) - two * c) * inv2;
  }
  out[idx] = narrow<S>(c + widen(Cm[idx]) * lap);
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_step_cm_kernel(const S* __restrict__ Tp, const S* __restrict__ Cm,
                     S* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                     typename Compute<S>::type inv0,
                     typename Compute<S>::type inv1,
                     typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!cell<NDIM>(n0, n1, n2, &i0, &i1, &i2)) return;
  // (n0, n1[, n2]) is the core; Tp is the core grown by 2 on every axis.
  const int64_t ps1 = NDIM == 3 ? n2 + 2 : 1;  // padded stride of axis 1
  const int64_t ps0 = (n1 + 2) * ps1;          // padded stride of axis 0
  const int64_t pidx = (i0 + 1) * ps0 + (i1 + 1) * ps1 + (NDIM == 3 ? i2 + 1 : 0);
  const int64_t idx = (i0 * n1 + i1) * n2 + i2;
  const C two = C(2);
  const C c = widen(Tp[pidx]);

  C lap = ((widen(Tp[pidx + ps0]) - two * c) + widen(Tp[pidx - ps0])) * inv0;
  lap = lap + ((widen(Tp[pidx + ps1]) - two * c) + widen(Tp[pidx - ps1])) * inv1;
  if (NDIM == 3) {
    lap = lap + ((widen(Tp[pidx + 1]) - two * c) + widen(Tp[pidx - 1])) * inv2;
  }
  out[idx] = narrow<S>(c + widen(Cm[idx]) * lap);
}

// Grid of one launch: x over the last axis, y over the second-to-last,
// z over the leading axis in 3D. Returns false if a dimension overflows.
bool launch_grid(int ndim, int64_t n0, int64_t n1, int64_t n2, dim3* grid) {
  const int64_t last = ndim == 2 ? n1 : n2;
  const int64_t second = ndim == 2 ? n0 : n1;
  const int64_t gx = (last + kBlockX - 1) / kBlockX;
  const int64_t gy = (second + kBlockY - 1) / kBlockY;
  const int64_t gz = ndim == 2 ? 1 : n0;
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
               static_cast<unsigned>(gz));
  return true;
}

template <typename S>
int launch_masked(int ndim, const void* T, const void* Cm, void* out,
                  int64_t n0, int64_t n1, int64_t n2, double inv0,
                  double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!launch_grid(ndim, n0, n1, n2, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* t = static_cast<const S*>(T);
  const auto* cm = static_cast<const S*>(Cm);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    masked_step_kernel<S, 2><<<grid, block, 0, stream>>>(
        t, cm, o, n0, n1, 1, C(inv0), C(inv1), C(0));
  } else {
    masked_step_kernel<S, 3><<<grid, block, 0, stream>>>(
        t, cm, o, n0, n1, n2, C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_fused_cm(int ndim, const void* Tp, const void* Cm, void* out,
                    int64_t n0, int64_t n1, int64_t n2, double inv0,
                    double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!launch_grid(ndim, n0, n1, n2, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* tp = static_cast<const S*>(Tp);
  const auto* cm = static_cast<const S*>(Cm);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    fused_step_cm_kernel<S, 2><<<grid, block, 0, stream>>>(
        tp, cm, o, n0, n1, 1, C(inv0), C(inv1), C(0));
  } else {
    fused_step_cm_kernel<S, 3><<<grid, block, 0, stream>>>(
        tp, cm, o, n0, n1, n2, C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the unpadded (core) extents, n2 = 1 in 2D; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch, -1 for an
// unsupported dtype or rank, -2 for a grid that overflows a launch
// dimension. The launch is asynchronous on `stream`; nothing here
// synchronises or allocates.
extern "C" int rmt_masked_step(int dtype, int ndim, const void* T,
                               const void* Cm, void* out, int64_t n0,
                               int64_t n1, int64_t n2, double inv0,
                               double inv1, double inv2, void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_masked<float>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kF64:
      return launch_masked<double>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kBF16:
      return launch_masked<__nv_bfloat16>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}

extern "C" int rmt_fused_step_cm(int dtype, int ndim, const void* Tp,
                                 const void* Cm, void* out, int64_t n0,
                                 int64_t n1, int64_t n2, double inv0,
                                 double inv1, double inv2, void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fused_cm<float>(ndim, Tp, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kF64:
      return launch_fused_cm<double>(ndim, Tp, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kBF16:
      return launch_fused_cm<__nv_bfloat16>(ndim, Tp, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}
