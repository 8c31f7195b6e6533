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
// dTdt and writes out). Design, as stencil.cu: one thread per output cell
// in 32x8 blocks along the last (contiguous) axis, the neighbour reads
// served from lines the block already pulled into L1/L2. The flux launch
// covers (lx + 1, ly + 1) and each thread writes the face of each output
// its cell has, so the extra row of qx and the extra column of qy take no
// second launch.

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
flux_kernel(const S* __restrict__ Tp, S* __restrict__ qx, S* __restrict__ qy,
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
residual_kernel(const S* __restrict__ qx, const S* __restrict__ qy,
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

template <typename S>
__global__ void __launch_bounds__(kBlockX * kBlockY)
update_kernel(const S* __restrict__ Tp, const S* __restrict__ dTdt, S* __restrict__ out,
              int64_t lx, int64_t ly, typename Compute<S>::type dt) {
  int64_t i, j;
  if (!cell(lx, ly, &i, &j)) return;
  const int64_t idx = i * ly + j;
  out[idx] = narrow<S>(widen(Tp[(i + 1) * (ly + 2) + j + 1]) + dt * widen(dTdt[idx]));
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
  flux_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
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
  residual_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const S*>(qx), static_cast<const S*>(qy), static_cast<const S*>(Cp),
      static_cast<S*>(dTdt), lx, ly, C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_update(const void* Tp, const void* dTdt, void* out, int64_t lx, int64_t ly,
                  double dt, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!grid_of(lx, ly, &grid)) return -2;
  update_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const S*>(Tp), static_cast<const S*>(dTdt), static_cast<S*>(out), lx, ly,
      C(dt));
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
