// Hand-written Hopper kernels of the heat-diffusion perf path, and the
// unmasked padded step beside them.
//
// Three kernels, each one explicit diffusion step on a 2D or 3D field:
//
//   rmt_masked_step   — out = T + Cm * lap(T) on an UNPADDED field, where
//                       lap = sum_ax ((T[i+1] + T[i-1]) - 2 T) * inv_d2[ax]
//                       and neighbours outside the field read as 0.
//                       Replaces rocm_mpi_tpu/ops/pallas_kernels.py
//                       masked_step (_per_step_kernel, and at small sizes
//                       the one-step form of _multi_step_kernel).
//   rmt_fused_step_cm — out = c + Cm * lap over a BOX of the core, read
//                       from a source grown by `off` cells per axis: the
//                       width-1-padded block (off = 1) or the raw shard
//                       (off = 0, for boxes whose stencil stays inside it),
//                       where c = src[i + off] and
//                       lap = sum_ax ((hi - 2 c) + lo) * inv_d2[ax].
//                       Replaces pallas_kernels.py fused_step_cm
//                       (_fused_kernel_whole_cm / _fused_kernel_striped_cm):
//                       the whole block is box = core, off = 1; the `hide`
//                       variant launches one box per region of the overlap
//                       decomposition (parallel/overlap.py), writing each
//                       into the shared output in place — the
//                       dynamic_update_slice splice without a copy.
//   rmt_fused_step_padded — out = c + ((dt·λ)/Cp) * lap over the whole
//                       core of the width-1-padded block, the same lap as
//                       rmt_fused_step_cm, with the coefficient formed per
//                       cell from Cp and the double dt·λ rounded once to
//                       the compute type. Replaces pallas_kernels.py
//                       fused_step_padded (_fused_kernel_whole and, above
//                       the TPU's VMEM budget, _fused_kernel_striped): the
//                       split is a limit of the TPU, so one grid covers
//                       every size. No model path calls it (nor does the
//                       JAX package's); it is held here as the unmasked
//                       contract's kernel.
//
// Each sums in its TPU kernel's order (the last two share lap_at), so each
// stays bitwise-comparable with its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/kernels.py). Build with -fmad=false: a contracted
// multiply-add rounds once where the plain version rounds twice.
//
// Bound on the card: memory. Per cell the step reads T (or Tp) and Cm (or
// Cp) and writes out — 12 bytes in f32 against ~11 flops, far below the H100's
// ratio of peak flops to bytes. The design keeps that to one pass each:
// threads are laid out along the last (contiguous) axis so a warp reads
// whole 128-byte lines, and the 2·ndim neighbour reads of a cell hit the
// lines its block's other threads already pulled into L1/L2. No TPU
// stripes or 3-slot blocks: a plain 2D grid of 32x8 blocks (plus the
// leading axis on grid.z in 3D), ragged edges masked, 64-bit offsets.
//
// bf16 is storage-only: loads are widened to f32, the step is computed in
// f32 and rounded to bf16 once on store (pallas_kernels._upcast_for_compute).

#include "stencil_common.cuh"

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

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
masked_step_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                   S* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                   typename Compute<S>::type inv0,
                   typename Compute<S>::type inv1,
                   typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(Box{0, 0, 0, n0, n1, n2}, &i0, &i1, &i2)) return;
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
fused_step_cm_kernel(const S* __restrict__ src, const S* __restrict__ Cm,
                     S* __restrict__ out, int64_t n1, int64_t n2, Box box, int off,
                     typename Compute<S>::type inv0,
                     typename Compute<S>::type inv1,
                     typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(box, &i0, &i1, &i2)) return;
  const Region<NDIM> r(n1, n2, off);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const C c = widen(src[p]);
  const C lap = rmt::lap_at<S, NDIM>(src, r, p, c, inv0, inv1, inv2);
  out[idx] = narrow<S>(c + widen(Cm[idx]) * lap);
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_step_padded_kernel(const S* __restrict__ Tp, const S* __restrict__ Cp,
                         S* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                         typename Compute<S>::type dtlam,
                         typename Compute<S>::type inv0,
                         typename Compute<S>::type inv1,
                         typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(Box{0, 0, 0, n0, n1, n2}, &i0, &i1, &i2)) return;
  const Region<NDIM> r(n1, n2, 1);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const C c = widen(Tp[p]);
  const C lap = rmt::lap_at<S, NDIM>(Tp, r, p, c, inv0, inv1, inv2);
  out[idx] = narrow<S>(c + (dtlam / widen(Cp[idx])) * lap);
}

template <typename S>
int launch_masked(int ndim, const void* T, const void* Cm, void* out,
                  int64_t n0, int64_t n1, int64_t n2, double inv0,
                  double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, Box{0, 0, 0, n0, n1, ndim == 2 ? 1 : n2}, &grid)) return -2;
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
int launch_fused_cm(int ndim, const void* src, const void* Cm, void* out,
                    int64_t n1, int64_t n2, Box box, int off, double inv0,
                    double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, box, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* s = static_cast<const S*>(src);
  const auto* cm = static_cast<const S*>(Cm);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    fused_step_cm_kernel<S, 2><<<grid, block, 0, stream>>>(
        s, cm, o, n1, 1, box, off, C(inv0), C(inv1), C(0));
  } else {
    fused_step_cm_kernel<S, 3><<<grid, block, 0, stream>>>(
        s, cm, o, n1, n2, box, off, C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_fused_padded(int ndim, const void* Tp, const void* Cp, void* out, int64_t n0,
                        int64_t n1, int64_t n2, double dtlam, double inv0, double inv1,
                        double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, Box{0, 0, 0, n0, n1, ndim == 2 ? 1 : n2}, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  const auto* t = static_cast<const S*>(Tp);
  const auto* cp = static_cast<const S*>(Cp);
  auto* o = static_cast<S*>(out);
  if (ndim == 2) {
    fused_step_padded_kernel<S, 2><<<grid, block, 0, stream>>>(
        t, cp, o, n0, n1, 1, C(dtlam), C(inv0), C(inv1), C(0));
  } else {
    fused_step_padded_kernel<S, 3><<<grid, block, 0, stream>>>(
        t, cp, o, n0, n1, n2, C(dtlam), C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the unpadded (core) extents, n2 = 1 in 2D; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch, -1 for an
// unsupported dtype or rank (or a box outside the core), -2 for a grid
// that overflows a launch dimension. The launch is asynchronous on `stream`;
// nothing here synchronises or allocates.
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

// The box is [lo, lo + e) per axis of the core (n0, n1, n2); `src` is the
// core grown by `off` (0 or 1) cells on every axis; Cm and out have the
// core's extents and out is written only inside the box.
extern "C" int rmt_fused_step_cm(int dtype, int ndim, const void* src,
                                 const void* Cm, void* out, int64_t n0,
                                 int64_t n1, int64_t n2, int64_t lo0, int64_t lo1,
                                 int64_t lo2, int64_t e0, int64_t e1, int64_t e2,
                                 int off, double inv0, double inv1, double inv2,
                                 void* stream) {
  const Box box{lo0, lo1, ndim == 2 ? 0 : lo2, e0, e1, ndim == 2 ? 1 : e2};
  if (!rmt::box_fits(box, off, ndim, n0, n1, n2)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fused_cm<float>(ndim, src, Cm, out, n1, n2, box, off, inv0, inv1, inv2, s);
    case kF64:
      return launch_fused_cm<double>(ndim, src, Cm, out, n1, n2, box, off, inv0, inv1, inv2, s);
    case kBF16:
      return launch_fused_cm<__nv_bfloat16>(ndim, src, Cm, out, n1, n2, box, off, inv0, inv1,
                                            inv2, s);
    default:
      return -1;
  }
}

// `Tp` is the core (n0, n1, n2) grown by one cell on every axis; Cp and out
// have the core's extents. `dtlam` is the double dt·λ.
extern "C" int rmt_fused_step_padded(int dtype, int ndim, const void* Tp, const void* Cp,
                                     void* out, int64_t n0, int64_t n1, int64_t n2,
                                     double dtlam, double inv0, double inv1, double inv2,
                                     void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fused_padded<float>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0, inv1,
                                        inv2, s);
    case kF64:
      return launch_fused_padded<double>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0, inv1,
                                         inv2, s);
    case kBF16:
      return launch_fused_padded<__nv_bfloat16>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0,
                                                inv1, inv2, s);
    default:
      return -1;
  }
}
