// Hand-written Hopper kernels of the heat-diffusion `kp` rung: one step as
// three launches on the staggered grid, from a width-1-padded 2D block Tp
// of shape (lx + 2, ly + 2), the reference's kernel-programming ladder
// (Flux!, Residual!, Update!).
//
//   rmt_kp_flux     — Fourier's law on the faces, q = -λ ∂T:
//                     qx[i, j] = ((-λ)·(Tp[i+1, j+1] - Tp[i, j+1]))·inv_d0,
//                     shape (lx + 1, ly);
//                     qy[i, j] = ((-λ)·(Tp[i+1, j+1] - Tp[i+1, j]))·inv_d1,
//                     shape (lx, ly + 1).
//                     Replaces rocm_mpi_tpu/ops/pallas_kernels.py
//                     _flux_kernel (the first pallas_call of
//                     kp_step_padded).
//   rmt_kp_residual — conservation of energy, dTdt = (-div)/Cp with
//                     div = (qx[i+1, j] - qx[i, j])·inv_d0
//                         + (qy[i, j+1] - qy[i, j])·inv_d1, shape (lx, ly).
//                     Replaces _residual_kernel.
//   rmt_kp_update   — out = Tp[i+1, j+1] + dt·dTdt[i, j]. Replaces
//                     _update_kernel.
//
// inv_d = 1/h (not 1/h²), λ and dt are doubles applied in the compute
// type, each kernel in its Pallas body's operation order, built with
// -fmad=false: every launch is bitwise equal to its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/kp.py). bf16 is storage-only per launch: loads
// are widened to f32 and each store rounds, so qx, qy and dTdt are bf16
// between the launches, as the TPU kernels' outputs are.
//
// The three launches are the point of the rung: the fused `perf` kernel
// removes two of them and the two round trips of the intermediates through
// device memory, so they stay three kernels. Each is memory-bound (a few
// flops a cell against 3-4 field passes: flux reads Tp and writes qx, qy;
// the residual reads qx, qy, Cp and writes dTdt; the update reads Tp and
// dTdt and writes out). Flux and residual, as stencil.cu: one thread per
// output cell in 32x8 blocks along the last (contiguous) axis, the
// neighbour reads served from lines the block already pulled into L1/L2.
// The flux launch covers (lx + 1, ly + 1) and each thread writes the face
// of each output its cell has, so the extra row of qx and the extra column
// of qy take no second launch. The update has no neighbours and moves 16
// bytes of a row per thread (its design note is at rmt_kp_update_kernel).

#include "stencil_common.cuh"

namespace {

using rmt::Compute;
using rmt::kBF16;
using rmt::kBlockX;
using rmt::kBlockY;
using rmt::kF32;
using rmt::kF64;
using rmt::narrow;
using rmt::widen;

// This thread's cell (i, j) of an (n0, n1) launch; false past the edge.
__device__ __forceinline__ bool cell(int64_t n0, int64_t n1, int64_t* i, int64_t* j) {
  *j = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  *i = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  return *i < n0 && *j < n1;
}

template <typename S>
__global__ void __launch_bounds__(kBlockX * kBlockY)
rmt_kp_flux_kernel(const S* __restrict__ Tp, S* __restrict__ qx, S* __restrict__ qy,
            int64_t lx, int64_t ly, typename Compute<S>::type nlam,
            typename Compute<S>::type inv0, typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  int64_t i, j;
  if (!cell(lx + 1, ly + 1, &i, &j)) return;
  const int64_t ps = ly + 2;  // row stride of Tp
  if (j < ly) {
    const C hi = widen(Tp[(i + 1) * ps + j + 1]);
    const C lo = widen(Tp[i * ps + j + 1]);
    qx[i * ly + j] = narrow<S>((nlam * (hi - lo)) * inv0);
  }
  if (i < lx) {
    const C hi = widen(Tp[(i + 1) * ps + j + 1]);
    const C lo = widen(Tp[(i + 1) * ps + j]);
    qy[i * (ly + 1) + j] = narrow<S>((nlam * (hi - lo)) * inv1);
  }
}

template <typename S>
__global__ void __launch_bounds__(kBlockX * kBlockY)
rmt_kp_residual_kernel(const S* __restrict__ qx, const S* __restrict__ qy,
                const S* __restrict__ Cp, S* __restrict__ dTdt, int64_t lx, int64_t ly,
                typename Compute<S>::type inv0, typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  int64_t i, j;
  if (!cell(lx, ly, &i, &j)) return;
  const int64_t idx = i * ly + j;
  const int64_t qy_idx = i * (ly + 1) + j;
  const C div = (widen(qx[idx + ly]) - widen(qx[idx])) * inv0 +
                (widen(qy[qy_idx + 1]) - widen(qy[qy_idx])) * inv1;
  dTdt[idx] = narrow<S>((-div) / widen(Cp[idx]));
}

// kp_update: 16 bytes of a row a thread (4 f32, 2 f64, 8 bf16), one block
// row per core row (a grid-stride loop covers rows past the 65535 a grid
// holds). Two layouts:
// - `vec` (ly a multiple of the width, 16-byte-aligned dTdt and out, the
//   usual case): a thread moves its own 16 bytes of dTdt and out as one
//   vector each, with the streaming hints (each is touched once). Tp's
//   core rows start one element past a row of stride ly + 2, never on the
//   16-byte grid, so its window is read element by element and the L1
//   merges a warp's neighbouring requests.
// - otherwise (a ragged row): a warp's 32 threads take its 32·width
//   elements in turn, every access scalar and coalesced, the row's tail
//   masked.
// Measured on an H100 against the alternatives (realigning 16-byte chunks
// of Tp by warp shuffle; a persistent grid walking two or four rows a
// thread; hints on the scalar accesses; 32 bytes a thread; 128 or 512
// threads a block), this layout was the fastest or within noise of it.
constexpr int kUpdBytes = 16;
constexpr int kUpdThreads = 256;

template <typename S>
struct alignas(kUpdBytes) Chunk {
  static constexpr int kN = kUpdBytes / static_cast<int>(sizeof(S));
  S v[kN];
};

template <typename S>
__global__ void __launch_bounds__(kUpdThreads)
rmt_kp_update_kernel(const S* __restrict__ Tp, const S* __restrict__ dTdt, S* __restrict__ out,
              int64_t lx, int64_t ly, bool vec, typename Compute<S>::type dt) {
  using Ch = Chunk<S>;
  constexpr int kN = Ch::kN;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kUpdThreads + threadIdx.x;
  // vec: elements j0 .. j0 + kN - 1; else j0 + 32e for e < kN, where j0
  // is this lane's first element in its warp's 32·kN.
  const int64_t j0 = vec ? chunk * kN : (chunk - lane) * kN + lane;
  for (int64_t row = blockIdx.y; row < lx; row += gridDim.y) {
    const S* t = Tp + (row + 1) * (ly + 2) + 1;
    const S* r = dTdt + row * ly;
    S* w = out + row * ly;
    if (vec) {
      if (j0 >= ly) return;
      Ch d;
      *reinterpret_cast<int4*>(&d) = __ldcs(reinterpret_cast<const int4*>(r + j0));
      Ch o;
#pragma unroll
      for (int e = 0; e < kN; ++e) o.v[e] = narrow<S>(widen(t[j0 + e]) + dt * widen(d.v[e]));
      __stcs(reinterpret_cast<int4*>(w + j0), *reinterpret_cast<const int4*>(&o));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int64_t j = j0 + 32 * e;
        if (j < ly) w[j] = narrow<S>(widen(t[j]) + dt * widen(r[j]));
      }
    }
  }
}

// Grid of an (n0, n1) launch; false if empty or a dimension overflows.
bool grid_of(int64_t n0, int64_t n1, dim3* grid) {
  const int64_t gx = (n1 + kBlockX - 1) / kBlockX;
  const int64_t gy = (n0 + kBlockY - 1) / kBlockY;
  if (n0 < 1 || n1 < 1 || gx > 2147483647LL || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
  return true;
}

template <typename S>
int launch_flux(const void* Tp, void* qx, void* qy, int64_t lx, int64_t ly, double lam,
                double inv0, double inv1, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!grid_of(lx + 1, ly + 1, &grid)) return -2;
  rmt_kp_flux_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const S*>(Tp), static_cast<S*>(qx), static_cast<S*>(qy), lx, ly, C(-lam),
      C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_residual(const void* qx, const void* qy, const void* Cp, void* dTdt, int64_t lx,
                    int64_t ly, double inv0, double inv1, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!grid_of(lx, ly, &grid)) return -2;
  rmt_kp_residual_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const S*>(qx), static_cast<const S*>(qy), static_cast<const S*>(Cp),
      static_cast<S*>(dTdt), lx, ly, C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_update(const void* Tp, const void* dTdt, void* out, int64_t lx, int64_t ly,
                  double dt, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  if (lx < 1 || ly < 1) return -2;
  // One block row per core row; a block covers 256 chunks of the row.
  const int64_t gx = ((ly + kN - 1) / kN + kUpdThreads - 1) / kUpdThreads;
  const int64_t gy = lx < 65535 ? lx : 65535;
  if (gx > 2147483647LL) return -2;
  const bool vec = ly % kN == 0 && reinterpret_cast<uintptr_t>(dTdt) % kUpdBytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kUpdBytes == 0;
  rmt_kp_update_kernel<S><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1),
                     kUpdThreads, 0, stream>>>(
      static_cast<const S*>(Tp), static_cast<const S*>(dTdt), static_cast<S*>(out), lx, ly,
      vec, C(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (lx, ly)
// is the core's shape (Tp is (lx + 2, ly + 2)); `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch, -1 for an unsupported dtype,
// -2 for an empty core or a grid that overflows a launch dimension. The
// launch is asynchronous on `stream`; nothing here synchronises or
// allocates.
extern "C" int rmt_kp_flux(int dtype, const void* Tp, void* qx, void* qy, int64_t lx,
                           int64_t ly, double lam, double inv0, double inv1, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_flux<float>(Tp, qx, qy, lx, ly, lam, inv0, inv1, s);
    case kF64: return launch_flux<double>(Tp, qx, qy, lx, ly, lam, inv0, inv1, s);
    case kBF16: return launch_flux<__nv_bfloat16>(Tp, qx, qy, lx, ly, lam, inv0, inv1, s);
    default: return -1;
  }
}

extern "C" int rmt_kp_residual(int dtype, const void* qx, const void* qy, const void* Cp,
                               void* dTdt, int64_t lx, int64_t ly, double inv0, double inv1,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_residual<float>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, s);
    case kF64: return launch_residual<double>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, s);
    case kBF16:
      return launch_residual<__nv_bfloat16>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, s);
    default: return -1;
  }
}

extern "C" int rmt_kp_update(int dtype, const void* Tp, const void* dTdt, void* out,
                             int64_t lx, int64_t ly, double dt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_update<float>(Tp, dTdt, out, lx, ly, dt, s);
    case kF64: return launch_update<double>(Tp, dTdt, out, lx, ly, dt, s);
    case kBF16: return launch_update<__nv_bfloat16>(Tp, dTdt, out, lx, ly, dt, s);
    default: return -1;
  }
}
