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
// ratio of peak flops to bytes. The design keeps that to one pass each.
// rmt_masked_step moves 16 bytes of a row a lane and walks runs of rows
// with the rows around it in registers (its design note is at
// masked_step_kernel): one-cell-a-thread loads of two bytes left bf16 at
// 0.46 of its bound on an H100. The other two give one thread to each core
// cell, laid out along the last (contiguous) axis so a warp reads whole
// 128-byte lines, and the 2·ndim neighbour reads of a cell hit the lines
// its block's other threads already pulled into L1/L2: a plain 2D grid of
// 32x8 blocks (plus the leading axis on grid.z in 3D), ragged edges masked,
// 64-bit offsets. No TPU stripes or 3-slot blocks in either.
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

// masked_step: 16 bytes of a row a lane (4 f32, 2 f64, 8 bf16: kN cells),
// a warp a strip of 32·kN consecutive cells of the last axis, walked down a
// run of up to kMsRunRows rows along axis 0 (a "row" is the strip's cells at
// one index of axis 0, and in 3D one index of axis 1). A lane keeps the rows
// above, at and below the one it computes in registers, and has the next
// row's loads in flight while it computes this one, so each T row comes
// from memory once a run. The neighbours along the last axis come from the
// lanes beside by shuffle; only the strip's two outer neighbours are loaded
// apart, by lanes 0 and 31. In 3D the rows at axis-1 indices ± 1 are read
// as rows too (through L1/L2). Cells past the field read as 0, so the edge
// ghosts are 0 by predicate. Two layouts of a lane's kN cells, picked by the
// wrapper with plain comparisons (ops/kernels.masked_layout):
// - VEC (f32 and bf16, the last axis a multiple of kN cells, T, Cm and out
//   16-byte aligned): kN consecutive cells, T loaded and Cm loaded and out
//   stored as one 16-byte vector each, Cm and out with the streaming hints
//   (each is touched once);
// - otherwise (f64, a ragged last axis, or an operand off the 16-byte
//   grid: a view with a storage offset): cells lane + 32e of the strip,
//   every access scalar and coalesced, the row's tail masked. The shuffles
//   are rotations across the warp: lane 0's left neighbour of cell e is
//   lane 31's cell e - 1.
// The sum runs axis 0, then 1, then 2, as the TPU kernel sums. Runs of 4
// rows measured fastest at 12288² on an H100 (scripts/torch_kernel_ab.py:
// runs of 1, 2, 8, 16 and 64 rows, and loads two rows ahead, were slower
// in f64 and no faster in f32 or bf16): the walk saves the neighbour rows'
// reads, and short runs keep enough warps, each with its loads in flight.
constexpr int kMsBytes = 16;        // a lane's cells of a row, and their alignment in VEC
constexpr int kMsWarps = 4;         // warps a block: independent strips
constexpr int kMsRunRows = 4;       // the longest run a warp walks
constexpr int kMsFillWarps = 8192;  // runs are cut shorter until this many warps

// Whether a storage type takes the VEC layout: f64's two-cell vectors
// measured slower on an H100 than its scalar cells (12288²: 1.27 ms against
// 1.185, scripts/torch_kernel_ab.py), so the wrapper never asks for them.
template <typename S>
constexpr bool kVecLayout = sizeof(S) < 8;

template <typename S>
struct alignas(kMsBytes) MsRow {
  static constexpr int kN = kMsBytes / static_cast<int>(sizeof(S));
  S v[kN];
};

template <typename S>
__device__ __forceinline__ S ms_zero() {
  return narrow<S>(typename Compute<S>::type(0));
}

// A lane's cells of one row, `p` at the row's first cell: 0 where the row
// (row_in false) or a cell lies outside the field. `stream` loads with the
// streaming hint.
template <typename S, bool VEC>
__device__ __forceinline__ MsRow<S> ms_load(const S* __restrict__ p, bool row_in,
                                            int64_t col, int64_t n_last, bool stream) {
  constexpr int kN = MsRow<S>::kN;
  MsRow<S> r;
  if constexpr (VEC) {
    if (row_in && col < n_last) {
      const int4* q = reinterpret_cast<const int4*>(p + col);
      *reinterpret_cast<int4*>(&r) = stream ? __ldcs(q) : *q;
      return r;
    }
#pragma unroll
    for (int e = 0; e < kN; ++e) r.v[e] = ms_zero<S>();
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e)
      r.v[e] = row_in && col + 32 * e < n_last ? p[col + 32 * e] : ms_zero<S>();
  }
  return r;
}

template <typename S, int NDIM, bool VEC>
__global__ void __launch_bounds__(kMsWarps * 32)
masked_step_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                   S* __restrict__ out, int64_t n0, int64_t n_mid, int64_t n_last,
                   int64_t strips, int64_t items, int run_rows,
                   typename Compute<S>::type inv0,
                   typename Compute<S>::type inv1,
                   typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  using Row = MsRow<S>;
  constexpr int kN = Row::kN;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kMsWarps + (threadIdx.x >> 5);
  if (item >= items) return;  // the whole warp: nothing below synchronises the block
  // item = (run · n_mid + mid) · strips + strip
  const int64_t strip = item % strips;
  const int64_t rest = item / strips;
  const int64_t mid = rest % n_mid;
  const int64_t r0 = (rest / n_mid) * run_rows;
  const int64_t r1 = r0 + run_rows < n0 ? r0 + run_rows : n0;
  const int64_t plane = n_mid * n_last;  // stride of axis 0
  const int64_t first = strip * 32 * kN;  // the strip's first cell
  const int64_t col = first + (VEC ? lane * kN : lane);  // this lane's first cell
  const S* t_at = T + mid * n_last;
  const S* c_at = Cm + mid * n_last;
  S* o_at = out + mid * n_last;
  const bool has_m_hi = NDIM == 3 && mid + 1 < n_mid;
  const bool has_m_lo = NDIM == 3 && mid > 0;
  // The strip's outer neighbours of a row: lane 0's left, lane 31's right.
  const int64_t outer = lane == 0 ? first - 1 : first + 32 * kN;
  const bool outer_in = (lane == 0 || lane == 31) && outer >= 0 && outer < n_last;
  auto edge_of = [&](int64_t g) -> S {
    return outer_in && g >= 0 && g < n0 ? t_at[g * plane + outer] : ms_zero<S>();
  };
  auto row_of = [&](const S* base, int64_t g, bool stream) -> Row {
    return ms_load<S, VEC>(base + g * plane, g >= 0 && g < n0, col, n_last, stream);
  };
  Row up = row_of(t_at, r0 - 1, false);
  Row cen = row_of(t_at, r0, false);
  Row dn = row_of(t_at, r0 + 1, false);
  S edge = edge_of(r0);
  S edge_dn = edge_of(r0 + 1);
  Row cm = row_of(c_at, r0, true);
  Row mhi, mlo;
  if constexpr (NDIM == 3) {
    mhi = row_of(t_at + n_last, has_m_hi ? r0 : -1, false);
    mlo = row_of(t_at - n_last, has_m_lo ? r0 : -1, false);
  }
  const C two = C(2);
  for (int64_t g = r0; g < r1; ++g) {
    // The next row's loads, in flight while this one is computed.
    const bool more = g + 1 < r1;
    const Row nx = row_of(t_at, more ? g + 2 : -1, false);
    const S edge_nx = edge_of(more ? g + 2 : -1);
    const Row cm_nx = row_of(c_at, more ? g + 1 : -1, true);
    Row mhi_nx, mlo_nx;
    if constexpr (NDIM == 3) {
      mhi_nx = row_of(t_at + n_last, more && has_m_hi ? g + 1 : -1, false);
      mlo_nx = row_of(t_at - n_last, more && has_m_lo ? g + 1 : -1, false);
    }
    C c[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) c[e] = widen(cen.v[e]);
    // The neighbours along the last axis: lo[e] at cell - 1, hi[e] at +1.
    C lo[kN], hi[kN];
    const C outer_v = widen(edge);
    if constexpr (VEC) {
      const C from_l = __shfl_up_sync(kAll, c[kN - 1], 1);
      const C from_r = __shfl_down_sync(kAll, c[0], 1);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        lo[e] = e > 0 ? c[e - 1] : (lane == 0 ? outer_v : from_l);
        hi[e] = e + 1 < kN ? c[e + 1] : (lane == 31 ? outer_v : from_r);
      }
    } else {
      C rot_l[kN], rot_r[kN];  // cell e of the lane before, and after (cyclic)
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        rot_l[e] = __shfl_sync(kAll, c[e], (lane + 31) & 31);
        rot_r[e] = __shfl_sync(kAll, c[e], (lane + 1) & 31);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        lo[e] = lane > 0 ? rot_l[e] : (e > 0 ? rot_l[e - 1] : outer_v);
        hi[e] = lane < 31 ? rot_r[e] : (e + 1 < kN ? rot_r[e + 1] : outer_v);
      }
    }
    Row o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      // Axis 0, then 1, then 2: lap = (t0 + t1) + t2, as the TPU kernel sums.
      C lap = ((widen(dn.v[e]) + widen(up.v[e])) - two * c[e]) * inv0;
      if constexpr (NDIM == 3) {
        lap = lap + ((widen(mhi.v[e]) + widen(mlo.v[e])) - two * c[e]) * inv1;
        lap = lap + ((hi[e] + lo[e]) - two * c[e]) * inv2;
      } else {
        lap = lap + ((hi[e] + lo[e]) - two * c[e]) * inv1;
      }
      o.v[e] = narrow<S>(c[e] + widen(cm.v[e]) * lap);
    }
    S* w = o_at + g * plane;
    if constexpr (VEC) {
      if (col < n_last)
        __stcs(reinterpret_cast<int4*>(w + col), *reinterpret_cast<const int4*>(&o));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (col + 32 * e < n_last) w[col + 32 * e] = o.v[e];
    }
    up = cen;
    cen = dn;
    dn = nx;
    edge = edge_dn;
    edge_dn = edge_nx;
    cm = cm_nx;
    if constexpr (NDIM == 3) {
      mhi = mhi_nx;
      mlo = mlo_nx;
    }
  }
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

template <typename S, int NDIM, bool VEC>
int launch_masked_nd(const S* t, const S* cm, S* o, int64_t n0, int64_t n_mid,
                     int64_t n_last, double inv0, double inv1, double inv2,
                     cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = MsRow<S>::kN;
  if (n0 < 1 || n_mid < 1 || n_last < 1) return -2;
  const int64_t strips = (n_last + 32 * kN - 1) / (32 * kN);
  // Runs of kMsRunRows rows, cut shorter where the field gives fewer than
  // kMsFillWarps warps of them (a small field: more, shorter walks).
  const int64_t cols = strips * n_mid;
  int64_t run_rows = cols * n0 / kMsFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > kMsRunRows ? kMsRunRows : run_rows;
  const int64_t items = cols * ((n0 + run_rows - 1) / run_rows);
  const int64_t blocks = (items + kMsWarps - 1) / kMsWarps;
  if (blocks > 2147483647LL) return -2;
  masked_step_kernel<S, NDIM, VEC><<<static_cast<unsigned>(blocks), kMsWarps * 32, 0, stream>>>(
      t, cm, o, n0, n_mid, n_last, strips, items, static_cast<int>(run_rows), C(inv0),
      C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

// `vec`: the wrapper's layout choice (VEC above); a launch that asks for it
// on a field it does not fit is refused (-1) rather than misread.
template <typename S>
int launch_masked(int ndim, const void* T, const void* Cm, void* out,
                  int64_t n0, int64_t n1, int64_t n2, double inv0,
                  double inv1, double inv2, int vec, cudaStream_t stream) {
  constexpr int kN = MsRow<S>::kN;
  const auto* t = static_cast<const S*>(T);
  const auto* cm = static_cast<const S*>(Cm);
  auto* o = static_cast<S*>(out);
  const int64_t n_last = ndim == 2 ? n1 : n2;
  if (vec && (!kVecLayout<S> || n_last % kN != 0 ||
              ((reinterpret_cast<uintptr_t>(T) | reinterpret_cast<uintptr_t>(Cm) |
                reinterpret_cast<uintptr_t>(out)) % kMsBytes) != 0))
    return -1;
  if constexpr (kVecLayout<S>) {
    if (vec && ndim == 2)
      return launch_masked_nd<S, 2, true>(t, cm, o, n0, 1, n1, inv0, inv1, 0.0, stream);
    if (vec)
      return launch_masked_nd<S, 3, true>(t, cm, o, n0, n1, n2, inv0, inv1, inv2, stream);
  }
  if (ndim == 2)
    return launch_masked_nd<S, 2, false>(t, cm, o, n0, 1, n1, inv0, inv1, 0.0, stream);
  return launch_masked_nd<S, 3, false>(t, cm, o, n0, n1, n2, inv0, inv1, inv2, stream);
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

// `vec` 1 takes the 16-byte layout (f32 and bf16 only, the last axis a
// multiple of 16 bytes, T, Cm and out on the 16-byte grid; -1 otherwise),
// 0 the scalar one.
extern "C" int rmt_masked_step(int dtype, int ndim, const void* T,
                               const void* Cm, void* out, int64_t n0,
                               int64_t n1, int64_t n2, double inv0,
                               double inv1, double inv2, int vec, void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_masked<float>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec, s);
    case kF64:
      return launch_masked<double>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec, s);
    case kBF16:
      return launch_masked<__nv_bfloat16>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec,
                                          s);
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
