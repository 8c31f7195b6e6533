// Hand-written Hopper kernels of the acoustic-wave workload (leapfrog
// U⁺ = 2U − U⁻ + dt²·c²·∇²U on a 2D or 3D field).
//
//   rmt_wave_step — out = (2c − U⁻) + (dt²·C2)·lap from the width-1-padded
//       displacement, c = Up[core], lap = Σ_ax ((hi − 2c) + lo)·inv_d2[ax].
//       Replaces rocm_mpi_tpu/ops/wave_kernels.py wave_step_padded_pallas
//       (_wave_kernel_whole): the `perf` step on any process grid.
//   rmt_wave_step_masked — out = M·cand + (1 − M)·c, cand = (2c − U⁻) +
//       Cw·lap, over a BOX of the core read from a source grown by `off`
//       cells per axis (the padded buffer, off = 1, or the raw shard,
//       off = 0, for boxes whose stencil stays inside it). The hold is
//       arithmetic, not a branch: a branch would give +0.0 where the JAX
//       kernel gives −0.0 + 0.0. Replaces wave_step_padded_masked_pallas
//       (_wave_kernel_whole_masked): the region kernel of the `hide`
//       variant, each box written into the shared output in place.
//   rmt_wave_multi_step — `n_steps` masked leapfrog steps in one launch on
//       an unpadded block, neighbours outside it read as 0, returning the
//       pair (U, U⁻). Replaces _wave_multi_step_kernel (via
//       wave_multi_step_masked and wave_multi_step): the VMEM-resident
//       loop and the deep-halo sweep's local compute. Two body forms, the
//       TPU kernel's: the A-form A·U + c·S − M·U⁻ (c = Cw·inv, A = (1 + M)
//       − 2·ndim·c, S = Σ_ax (hi + lo)) for chunks ≥ 4 on equal spacing,
//       else the direct form (U + M·(U − U⁻)) + Cw·lap.
//
// Each keeps its TPU kernel's operation order and the build uses
// -fmad=false, so each launch is bitwise equal to its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/wave.py). bf16 is storage-only: widened on load,
// computed in f32, rounded once per launch.
//
// Bound on the card. The two per-step kernels are memory-bound: five
// passes of the field per step (padded U, U⁻, C2 or M and Cw, out) against
// ~12 flops a cell. As in stencil.cu: one thread per core cell, 32x8 blocks
// along the last axis, neighbour reads from lines the block already holds.
// rmt_wave_multi_step is bound by neither: at the deep blocks and the 252²
// field it runs on, a step is well under a microsecond of work. It keeps
// the design of rmt_multi_step_cm (multistep.cu): a persistent cooperative
// launch, the state in L2 in two compute-type buffers, a grid barrier
// between steps, __ldcg reads. A cell reads U⁻ only at its own index, so
// U⁺ overwrites U⁻ in place and two buffers hold the pair for any n. The
// A-form's c and A are recomputed from M and Cw every step rather than kept
// in prologue arrays: the same operations on the same operands give the
// prologue's bits, and one read of M and Cw is fewer bytes than A and c.
// The barrier (about a microsecond) is what the loop pays per step.

#include <cooperative_groups.h>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

namespace {

using rmt::Box;
using rmt::Compute;
using rmt::kBF16;
using rmt::kBlockX;
using rmt::kBlockY;
using rmt::kF32;
using rmt::kF64;
using rmt::narrow;
using rmt::Region;
using rmt::widen;

constexpr int kThreads = 256;
enum Form : int { kDirect = 0, kAForm = 1 };

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
wave_step_kernel(const S* __restrict__ Up, const S* __restrict__ Uprev,
                 const S* __restrict__ C2, S* __restrict__ out, int64_t n1,
                 int64_t n2, Box box, typename Compute<S>::type dt2,
                 typename Compute<S>::type inv0, typename Compute<S>::type inv1,
                 typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(box, &i0, &i1, &i2)) return;
  const Region<NDIM> r(n1, n2, 1);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const C c = widen(Up[p]);
  const C lap = rmt::lap_at<S, NDIM>(Up, r, p, c, inv0, inv1, inv2);
  out[idx] = narrow<S>((C(2) * c - widen(Uprev[idx])) + (dt2 * widen(C2[idx])) * lap);
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
wave_step_masked_kernel(const S* __restrict__ src, const S* __restrict__ Uprev,
                        const S* __restrict__ M, const S* __restrict__ Cw,
                        S* __restrict__ out, int64_t n1, int64_t n2, Box box, int off,
                        typename Compute<S>::type inv0, typename Compute<S>::type inv1,
                        typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(box, &i0, &i1, &i2)) return;
  const Region<NDIM> r(n1, n2, off);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const C c = widen(src[p]);
  const C lap = rmt::lap_at<S, NDIM>(src, r, p, c, inv0, inv1, inv2);
  const C cand = (C(2) * c - widen(Uprev[idx])) + widen(Cw[idx]) * lap;
  const C m = widen(M[idx]);
  out[idx] = narrow<S>(m * cand + (C(1) - m) * c);
}

// ---------------------------------------------------------------------------
// rmt_wave_multi_step
// ---------------------------------------------------------------------------

// U at the start of step `step`: the input for step 0, else the buffer the
// previous step wrote.
template <typename S, typename C>
__device__ __forceinline__ C cur_at(int step, const S* __restrict__ U, C* buf0,
                                    C* buf1, int64_t i) {
  if (step == 0) return widen(U[i]);
  return __ldcg(((step - 1) & 1) ? buf1 + i : buf0 + i);
}

// U⁻ at the start of step `step`: the input U⁻, then the input U, then the
// buffer two steps back — the one this step overwrites in place.
template <typename S, typename C>
__device__ __forceinline__ C prev_at(int step, const S* __restrict__ U,
                                     const S* __restrict__ Uprev, C* buf0, C* buf1,
                                     int64_t i) {
  if (step == 0) return widen(Uprev[i]);
  if (step == 1) return widen(U[i]);
  return __ldcg((step & 1) ? buf1 + i : buf0 + i);
}

template <typename S, int NDIM, int FORM>
__global__ void __launch_bounds__(kThreads)
wave_multi_step_kernel(const S* __restrict__ U, const S* __restrict__ Uprev,
                       const S* __restrict__ M, const S* __restrict__ Cw,
                       S* __restrict__ oU, S* __restrict__ oUprev,
                       typename Compute<S>::type* buf0, typename Compute<S>::type* buf1,
                       int n_steps, int64_t n0, int64_t n1, int64_t n2,
                       typename Compute<S>::type inv0, typename Compute<S>::type inv1,
                       typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  cg::grid_group grid = cg::this_grid();
  const int64_t s1 = n2;       // stride of axis 1 (1 in 2D, where n2 == 1)
  const int64_t s0 = n1 * n2;  // stride of axis 0
  const int64_t cells = n0 * s0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const C zero = C(0);
  const C two = C(2);
  for (int step = 0; step < n_steps; ++step) {
    const bool last = step == n_steps - 1;
    C* dst = (step & 1) ? buf1 : buf0;
    for (int64_t i = first; i < cells; i += stride) {
      const int64_t i0 = i / s0;
      const int64_t rem = i - i0 * s0;
      const int64_t i1 = rem / n2;
      const int64_t i2 = rem - i1 * n2;
      const C t = cur_at<S, C>(step, U, buf0, buf1, i);
      const C tp = prev_at<S, C>(step, U, Uprev, buf0, buf1, i);
      const C p0 = (i0 + 1 < n0 ? cur_at<S, C>(step, U, buf0, buf1, i + s0) : zero) +
                   (i0 > 0 ? cur_at<S, C>(step, U, buf0, buf1, i - s0) : zero);
      const C p1 = (i1 + 1 < n1 ? cur_at<S, C>(step, U, buf0, buf1, i + s1) : zero) +
                   (i1 > 0 ? cur_at<S, C>(step, U, buf0, buf1, i - s1) : zero);
      C p2 = zero;
      if (NDIM == 3) {
        p2 = (i2 + 1 < n2 ? cur_at<S, C>(step, U, buf0, buf1, i + 1) : zero) +
             (i2 > 0 ? cur_at<S, C>(step, U, buf0, buf1, i - 1) : zero);
      }
      const C m = widen(M[i]);
      const C cw = widen(Cw[i]);
      C v;
      if (FORM == kAForm) {
        const C c = cw * inv0;
        const C a = (C(1) + m) - C(2 * NDIM) * c;
        C s = p0 + p1;
        if (NDIM == 3) s = s + p2;
        v = (a * t + c * s) - m * tp;
      } else {
        C lap = (p0 - two * t) * inv0;
        lap = lap + (p1 - two * t) * inv1;
        if (NDIM == 3) lap = lap + (p2 - two * t) * inv2;
        v = (t + m * (t - tp)) + cw * lap;
      }
      if (last) {
        oU[i] = narrow<S>(v);
        oUprev[i] = narrow<S>(t);
      } else {
        dst[i] = v;
      }
    }
    if (!last) grid.sync();
  }
}

template <typename S, int NDIM, int FORM>
int launch_multi(const void* U, const void* Uprev, const void* M, const void* Cw,
                 void* oU, void* oUprev, void* scratch, int n_steps, int64_t n0,
                 int64_t n1, int64_t n2, double inv0, double inv1, double inv2,
                 cudaStream_t stream) {
  using C = typename Compute<S>::type;
  auto kernel = wave_multi_step_kernel<S, NDIM, FORM>;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return -3;
  const int64_t cells = n0 * n1 * n2;
  const int64_t want = (cells + kThreads - 1) / kThreads;
  const int64_t fit = static_cast<int64_t>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(want < fit ? want : fit);

  const S* u = static_cast<const S*>(U);
  const S* up = static_cast<const S*>(Uprev);
  const S* m = static_cast<const S*>(M);
  const S* cw = static_cast<const S*>(Cw);
  S* ou = static_cast<S*>(oU);
  S* oup = static_cast<S*>(oUprev);
  C* b0 = static_cast<C*>(scratch);
  C* b1 = b0 + cells;
  C c0 = C(inv0), c1 = C(inv1), c2 = C(inv2);
  void* args[] = {&u, &up, &m, &cw, &ou, &oup, &b0, &b1, &n_steps,
                  &n0, &n1, &n2, &c0, &c1, &c2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int dispatch_multi(int ndim, int form, const void* U, const void* Uprev,
                   const void* M, const void* Cw, void* oU, void* oUprev,
                   void* scratch, int n, int64_t n0, int64_t n1, int64_t n2,
                   double inv0, double inv1, double inv2, cudaStream_t s) {
  if (ndim == 2 && form == kDirect)
    return launch_multi<S, 2, kDirect>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, 1,
                                       inv0, inv1, 0.0, s);
  if (ndim == 2)
    return launch_multi<S, 2, kAForm>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, 1,
                                      inv0, inv1, 0.0, s);
  if (form == kDirect)
    return launch_multi<S, 3, kDirect>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, n2,
                                       inv0, inv1, inv2, s);
  return launch_multi<S, 3, kAForm>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, n2,
                                    inv0, inv1, inv2, s);
}

// ---------------------------------------------------------------------------
// The per-step launches
// ---------------------------------------------------------------------------

template <typename S>
int launch_step(int ndim, const void* Up, const void* Uprev, const void* C2, void* out,
                int64_t n1, int64_t n2, Box box, double dt2, double inv0, double inv1,
                double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, box, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* up = static_cast<const S*>(Up);
  const auto* uprev = static_cast<const S*>(Uprev);
  const auto* c2 = static_cast<const S*>(C2);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    wave_step_kernel<S, 2><<<grid, block, 0, stream>>>(up, uprev, c2, o, n1, 1, box, C(dt2),
                                                       C(inv0), C(inv1), C(0));
  } else {
    wave_step_kernel<S, 3><<<grid, block, 0, stream>>>(up, uprev, c2, o, n1, n2, box, C(dt2),
                                                       C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_masked(int ndim, const void* src, const void* Uprev, const void* M,
                  const void* Cw, void* out, int64_t n1, int64_t n2, Box box, int off,
                  double inv0, double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, box, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* s = static_cast<const S*>(src);
  const auto* uprev = static_cast<const S*>(Uprev);
  const auto* m = static_cast<const S*>(M);
  const auto* cw = static_cast<const S*>(Cw);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    wave_step_masked_kernel<S, 2><<<grid, block, 0, stream>>>(
        s, uprev, m, cw, o, n1, 1, box, off, C(inv0), C(inv1), C(0));
  } else {
    wave_step_masked_kernel<S, 3><<<grid, block, 0, stream>>>(
        s, uprev, m, cw, o, n1, n2, box, off, C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (n0, n1,
// n2) are the core's extents, n2 = 1 in 2D; `stream` is a cudaStream_t.
// Return codes: 0 on success, >0 a CUDA error (the launch's, or
// cudaGetLastError() after it), -1 an unsupported dtype, rank, form, step
// count or box, -2 a grid that overflows a launch dimension, -3 no
// co-resident block for the cooperative launch. Launches are asynchronous
// on `stream`; nothing here synchronises or allocates.

// Whole block: `Up` is the core grown by one cell per axis; U⁻, C2 and out
// have the core's extents. `dt2` is dt·dt, applied in the compute type.
extern "C" int rmt_wave_step(int dtype, int ndim, const void* Up, const void* Uprev,
                             const void* C2, void* out, int64_t n0, int64_t n1,
                             int64_t n2, double dt2, double inv0, double inv1,
                             double inv2, void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  const Box box{0, 0, 0, n0, n1, ndim == 2 ? 1 : n2};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_step<float>(ndim, Up, Uprev, C2, out, n1, n2, box, dt2, inv0, inv1, inv2, s);
    case kF64:
      return launch_step<double>(ndim, Up, Uprev, C2, out, n1, n2, box, dt2, inv0, inv1, inv2, s);
    case kBF16:
      return launch_step<__nv_bfloat16>(ndim, Up, Uprev, C2, out, n1, n2, box, dt2, inv0, inv1,
                                        inv2, s);
    default:
      return -1;
  }
}

// Region form: the box is [lo, lo + e) per axis of the core; `src` is the
// core grown by `off` (0 or 1) cells on every axis; U⁻, M, Cw and out have
// the core's extents and out is written only inside the box.
extern "C" int rmt_wave_step_masked(int dtype, int ndim, const void* src,
                                    const void* Uprev, const void* M, const void* Cw,
                                    void* out, int64_t n0, int64_t n1, int64_t n2,
                                    int64_t lo0, int64_t lo1, int64_t lo2, int64_t e0,
                                    int64_t e1, int64_t e2, int off, double inv0,
                                    double inv1, double inv2, void* stream) {
  const Box box{lo0, lo1, ndim == 2 ? 0 : lo2, e0, e1, ndim == 2 ? 1 : e2};
  if (!rmt::box_fits(box, off, ndim, n0, n1, n2)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_masked<float>(ndim, src, Uprev, M, Cw, out, n1, n2, box, off, inv0, inv1,
                                  inv2, s);
    case kF64:
      return launch_masked<double>(ndim, src, Uprev, M, Cw, out, n1, n2, box, off, inv0, inv1,
                                   inv2, s);
    case kBF16:
      return launch_masked<__nv_bfloat16>(ndim, src, Uprev, M, Cw, out, n1, n2, box, off, inv0,
                                          inv1, inv2, s);
    default:
      return -1;
  }
}

// `form`: 0 direct, 1 A-form. `scratch` holds 2·n0·n1·n2 elements of the
// compute type (f32 for bf16). oU and oUprev must not alias the inputs.
extern "C" int rmt_wave_multi_step(int dtype, int ndim, int form, int n_steps,
                                   const void* U, const void* Uprev, const void* M,
                                   const void* Cw, void* oU, void* oUprev, void* scratch,
                                   int64_t n0, int64_t n1, int64_t n2, double inv0,
                                   double inv1, double inv2, void* stream) {
  if ((ndim != 2 && ndim != 3) || (form != kDirect && form != kAForm) || n_steps < 1)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_multi<float>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch, n_steps,
                                   n0, n1, n2, inv0, inv1, inv2, s);
    case kF64:
      return dispatch_multi<double>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch, n_steps,
                                    n0, n1, n2, inv0, inv1, inv2, s);
    case kBF16:
      return dispatch_multi<__nv_bfloat16>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch,
                                           n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}
