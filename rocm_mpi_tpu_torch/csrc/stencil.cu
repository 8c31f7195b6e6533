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
//                       where the data already lies: the core T (any
//                       strides, the last axis contiguous) and its 2·ndim
//                       ghost faces, one pointer each (null: a domain edge,
//                       read as 0), where c = T[i] and
//                       lap = sum_ax ((hi - 2 c) + lo) * inv_d2[ax].
//                       Replaces pallas_kernels.py fused_step_cm
//                       (_fused_kernel_whole_cm / _fused_kernel_striped_cm):
//                       the padded-block call passes views into the block
//                       (its core and its ghost rows and columns); the
//                       sharded steps pass the shard and the receive
//                       buffers of the face exchange (parallel/halo.py
//                       exchange_faces), so no step copies the shard into
//                       a padded buffer; the `hide` variant launches one
//                       box per region of the overlap decomposition
//                       (parallel/overlap.py), writing each into the
//                       shared output in place. f64 launches take a
//                       kernel of their own (rmt_fused_step_cm_f64_kernel:
//                       the same reads and sum, cut for f64's stream).
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
// Each sums in its TPU kernel's order (the last two in lap_at's), so each
// stays bitwise-comparable with its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/kernels.py). Build with -fmad=false: a contracted
// multiply-add rounds once where the plain version rounds twice.
//
// Bound on the card: memory. Per cell the step reads T (or Tp) and Cm (or
// Cp) and writes out — 12 bytes in f32 against ~11 flops, far below the H100's
// ratio of peak flops to bytes. The design keeps that to one pass each.
// All three move 16 bytes of a row a lane (fused_step_cm's f64 route 32 in
// 2D) and walk runs of rows with the rows around it in registers (the
// design notes are at rmt_masked_step_kernel, rmt_fused_step_cm_kernel,
// rmt_fused_step_cm_f64_kernel and rmt_fused_step_padded_kernel):
// one-cell-a-thread loads of two bytes left
// bf16 at 0.45-0.46 of its bound on an H100. rmt_fused_step_padded took the
// layout last; at 12288² on an H100 80GB HBM3 at 700.00 W
// (scripts/torch_kernel_ab.py, old against new in one call, device ms a
// launch) it went f32 0.7120-0.7121 → 0.5915-0.5917 ms (0.76 → 0.91 of
// the bytes bound), bf16 0.5886-0.5890 → 0.3291-0.3292 (0.46 → 0.82); f64
// keeps the one-cell-a-thread form (1.1712-1.1715, 1.1729-1.1730 in the
// new tree). No TPU stripes or 3-slot blocks in any.
//
// bf16 is storage-only: loads are widened to f32, the step is computed in
// f32 and rounded to bf16 once on store (pallas_kernels._upcast_for_compute).

#include <type_traits>

#include "stencil_common.cuh"

namespace {

using rmt::Box;
using rmt::Compute;
using rmt::kBF16;
using rmt::kF32;
using rmt::kF64;
using rmt::narrow;
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
rmt_masked_step_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
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

// fused_step_cm, the face form: masked_step's layout (16 bytes of a row a
// lane or scalar cells, runs of rows in registers, last-axis neighbours by
// shuffle) over a box of the core, with the ghosts read where the exchange
// left them instead of from a padded copy of the shard. A warp walks a
// strip of the box's last axis at one axis-1 index (3D) down a run of
// axis-0 rows. What a lane reads, by where the neighbour lies:
// - inside the core: T, through its strides (the padded caller's core is
//   a view into the block; the sharded steps' core is the shard itself);
// - the axis-0 rows above the first and below the last row: the axis-0
//   faces, read as rows;
// - in 3D, the axis-1 rows beside the first and last axis-1 index: the
//   axis-1 faces, read as rows;
// - the last-axis neighbours at the shard's two edges: the last-axis
//   faces, one cell a row, read by the lane that needs it into a register
//   of its own (lanes 0 and 31 for the strip's outer neighbours, and the
//   lane whose cell lies just past the core);
// - a null face reads as 0 (a domain edge, where Cm = 0 holds the cell).
// Loads are predicated on the box grown by one cell along the last axis,
// so a narrow box (a hide slab) reads only its own lines. The strips start
// on the kN-cell grid in the VEC layout, so a box at any column keeps its
// 16-byte vectors; a vector that straddles the box's edge is stored cell
// by cell. The sum is fused_step_cm's, ((hi - 2c) + lo) · inv per axis,
// axis 0, then 1, then 2 (lap_at's order).
constexpr int kFaces = 6;
// Runs of up to 8 rows, and registers capped so 6 blocks fit an SM (80 a
// thread): the face form's per-warp set-up costs more than masked_step's,
// so its runs are longer; on an H100 at a 6144² and a 128³ shard this
// pair read fastest of runs of 4, 8 and 16, capped or not
// (scripts/torch_face_variants.py builds and times the variants).
constexpr int kFaceRunRows = 8;
constexpr int kFaceMinBlocks = 6;

// The 2·ndim ghost faces: face (axis a, side s: 0 below, 1 above) at
// 2a + s, null where there is none; `s` the face's strides along its other
// axes, in axis order (the last axis of a row face is contiguous).
template <typename S>
struct FaceSet {
  const S* p[kFaces];
  int64_t s[kFaces][2];
};

// The core (n0, n_mid, n_last; n_mid = 1 in 2D), T's strides along axes 0
// and 1 (its last axis contiguous), the box [lo, hi) per axis, and the
// launch's cut: strips of 32·kN cells from `a0` along the last axis, runs
// of `run_rows` rows along axis 0, `items` warps in all.
struct FaceGeom {
  int64_t n0, n_mid, n_last;
  int64_t ts0, ts1;
  int64_t lo0, lo_mid, lo_last, hi0, hi_mid, hi_last;
  int64_t a0, strips, items;
  int run_rows;
};

// Where one warp's rows come from in the face form, fixed before its walk
// (every face index a constant, so nothing indexes the parameters at run
// time), and the loads of a row: straight-line and predicated, as
// ms_load's, so each row's loads issue together ahead of the compute that
// needs them. Member functions, force-inlined, so the state stays in
// registers. A row may come from T or from a face, so no load is provably
// based on one restrict pointer: the loads are non-coherent (__ldg;
// nothing the kernel writes aliases them, the wrapper checks) or
// streaming (__ldcs, Cm), both free to be scheduled ahead of the stores.
template <typename S, int NDIM, bool VEC>
struct FaceWalk {
  using Row = MsRow<S>;
  static constexpr int kN = Row::kN;
  const S* t_at;   // T at this warp's axis-1 index m
  int64_t ts0;     // T's axis-0 stride
  int64_t n0;      // the core's rows
  int64_t col;     // this lane's first cell
  const S* f0_lo;  // the axis-0 faces' rows at m (null: zeros)
  const S* f0_hi;
  const S* fl_hi;  // the last-axis face above at m: row i at fl_hi[i · fl_hi_s]
  int64_t fl_hi_s;
  unsigned need;   // bit e: this lane reads cell e from the row (VEC: bit 0, the vector)
  unsigned past;   // bit e: this lane's cell e is the one just past the core, and read

  // This lane's cells of the row at `base` (null: zeros) that it reads
  // inside the core, each load straight into its register (zeroed first):
  // no instruction touches a loaded register before the compute that
  // uses it, so the loads of the next row stay in flight meanwhile.
  __device__ __forceinline__ Row load(const S* base, bool stream) const {
    Row r;
#pragma unroll
    for (int e = 0; e < kN; ++e) r.v[e] = ms_zero<S>();
    if constexpr (VEC) {
      if (base != nullptr && (need & 1u)) {
        const int4* q = reinterpret_cast<const int4*>(base + col);
        *reinterpret_cast<int4*>(&r) = stream ? __ldcs(q) : __ldg(q);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        if (base != nullptr && ((need >> e) & 1u)) {
          const S* at = base + col + 32 * e;
          r.v[e] = stream ? __ldcs(at) : __ldg(at);
        }
      }
    }
    return r;
  }

  // Row i of axis 0 (when `on`; else zeros): T in the core, the axis-0
  // faces at i = -1 and n0.
  __device__ __forceinline__ Row row(int64_t i, bool on) const {
    const S* base = i >= 0 && i < n0 ? t_at + i * ts0 : (i < 0 ? f0_lo : f0_hi);
    return load(on ? base : nullptr, false);
  }

  // The cell just past the core in row i of T (when `on` and this lane
  // reads it; else 0): the last-axis face above, in a register of its own.
  __device__ __forceinline__ S past_of(int64_t i, bool on) const {
    return on && past != 0u && fl_hi != nullptr && i >= 0 && i < n0
               ? __ldg(fl_hi + i * fl_hi_s)
               : ms_zero<S>();
  }
};

template <typename S, int NDIM, bool VEC>
__global__ void __launch_bounds__(kMsWarps * 32, kFaceMinBlocks)
rmt_fused_step_cm_kernel(const S* __restrict__ T, FaceSet<S> f, const S* __restrict__ Cm,
                     S* __restrict__ out, FaceGeom g, typename Compute<S>::type inv0,
                     typename Compute<S>::type inv1, typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  using Row = MsRow<S>;
  constexpr int kN = Row::kN;
  constexpr int kLast = 2 * (NDIM - 1);  // the last axis's first face
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kMsWarps + (threadIdx.x >> 5);
  if (item >= g.items) return;  // the whole warp: nothing below synchronises the block
  // item = (run · e_mid + mid) · strips + strip
  // (in 32 bits where the launch fits them: a 64-bit division costs a
  // warp several times a 32-bit one, and every warp divides twice)
  const int64_t e_mid = g.hi_mid - g.lo_mid;
  int64_t strip, mid, run;
  if (g.items <= 0xffffffffLL) {
    const uint32_t it = static_cast<uint32_t>(item), st = static_cast<uint32_t>(g.strips);
    const uint32_t rs = it / st, em = static_cast<uint32_t>(e_mid);
    strip = it - rs * st;
    mid = rs % em;
    run = rs / em;
  } else {
    const int64_t rs = item / g.strips;
    strip = item - rs * g.strips;
    mid = rs % e_mid;
    run = rs / e_mid;
  }
  const int64_t m = g.lo_mid + mid;
  const int64_t r0 = g.lo0 + run * g.run_rows;
  const int64_t r1 = r0 + g.run_rows < g.hi0 ? r0 + g.run_rows : g.hi0;
  const int64_t first = g.a0 + strip * 32 * kN;  // the strip's first cell
  const int64_t plane = g.n_mid * g.n_last;      // Cm's and out's axis-0 stride
  const S* c_at = Cm + m * g.n_last;
  S* o_at = out + m * g.n_last;
  // The last-axis cells a row is read at: the box and one neighbour a side.
  const int64_t need_lo = g.lo_last - 1;
  const int64_t need_hi = g.hi_last;
  FaceWalk<S, NDIM, VEC> w;
  w.t_at = T + m * g.ts1;
  w.ts0 = g.ts0;
  w.n0 = g.n0;
  w.col = first + (VEC ? lane * kN : lane);
  w.f0_lo = f.p[0];
  w.f0_hi = f.p[1];
  const S* fl_lo = f.p[kLast];
  const int64_t fl_lo_s = f.s[kLast][0];
  w.fl_hi = f.p[kLast + 1];
  w.fl_hi_s = f.s[kLast + 1][0];
  if constexpr (NDIM == 3) {
    if (w.f0_lo != nullptr) w.f0_lo += m * f.s[0][0];
    if (w.f0_hi != nullptr) w.f0_hi += m * f.s[1][0];
    if (fl_lo != nullptr) fl_lo += m * f.s[kLast][1];
    if (w.fl_hi != nullptr) w.fl_hi += m * f.s[kLast + 1][1];
  }
  // The cells this lane reads of a row (the box and one neighbour a side,
  // inside the core), and the one just past the core if it reads it.
  w.need = 0;
  w.past = 0;
  if constexpr (VEC) {
    w.need = w.col < g.n_last && w.col + kN - 1 >= need_lo && w.col <= need_hi ? 1u : 0u;
    w.past = w.col == g.n_last && need_hi == g.n_last ? 1u : 0u;
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int64_t x = w.col + 32 * e;
      const bool read = x >= need_lo && x <= need_hi;
      w.need |= (read && x < g.n_last ? 1u : 0u) << e;
      w.past |= (read && x == g.n_last ? 1u : 0u) << e;
    }
  }
  // In 3D, the rows at m ± 1: row i at base + i · stride, from T inside
  // the core, from the axis-1 faces just outside it (null: zeros).
  const S* mh_base = nullptr;
  const S* ml_base = nullptr;
  int64_t mh_s = g.ts0, ml_s = g.ts0;
  if constexpr (NDIM == 3) {
    if (m + 1 < g.n_mid) {
      mh_base = T + (m + 1) * g.ts1;
    } else {
      mh_base = f.p[3];
      mh_s = f.s[3][0];
    }
    if (m > 0) {
      ml_base = T + (m - 1) * g.ts1;
    } else {
      ml_base = f.p[2];
      ml_s = f.s[2][0];
    }
  }
  // The strip's outer neighbours: lane 0's left, lane 31's right, from T,
  // or from a last-axis face at the core's edge; row i at edge_base[i · edge_s].
  const int64_t outer = lane == 0 ? first - 1 : first + 32 * kN;
  const S* edge_base = nullptr;
  int64_t edge_s = g.ts0;
  if ((lane == 0 || lane == 31) && outer >= need_lo && outer <= need_hi) {
    if (outer < 0) {
      edge_base = fl_lo;
      edge_s = fl_lo_s;
    } else if (outer >= g.n_last) {
      edge_base = w.fl_hi;
      edge_s = w.fl_hi_s;
    } else {
      edge_base = w.t_at + outer;
    }
  }
  const S zero = ms_zero<S>();
  auto edge_of = [&](int64_t i, bool on) -> S {
    return on && edge_base != nullptr && i >= 0 && i < g.n0 ? __ldg(edge_base + i * edge_s)
                                                            : zero;
  };
  Row up = w.row(r0 - 1, true);
  Row cen = w.row(r0, true);
  Row dn = w.row(r0 + 1, true);
  S edge = edge_of(r0, true);
  S edge_dn = edge_of(r0 + 1, true);
  S past = w.past_of(r0, true);
  S past_dn = w.past_of(r0 + 1, true);
  Row cm = w.load(c_at + r0 * plane, true);
  Row mhi, mlo;
  if constexpr (NDIM == 3) {
    mhi = w.load(mh_base == nullptr ? nullptr : mh_base + r0 * mh_s, false);
    mlo = w.load(ml_base == nullptr ? nullptr : ml_base + r0 * ml_s, false);
  }
  const C two = C(2);
  for (int64_t i = r0; i < r1; ++i) {
    // The next row's loads, in flight while this one is computed.
    const bool more = i + 1 < r1;
    const Row nx = w.row(i + 2, more);
    const S edge_nx = edge_of(i + 2, more);
    const S past_nx = w.past_of(i + 2, more);
    const Row cm_nx = w.load(more ? c_at + (i + 1) * plane : nullptr, true);
    Row mhi_nx, mlo_nx;
    if constexpr (NDIM == 3) {
      mhi_nx = w.load(more && mh_base != nullptr ? mh_base + (i + 1) * mh_s : nullptr, false);
      mlo_nx = w.load(more && ml_base != nullptr ? ml_base + (i + 1) * ml_s : nullptr, false);
    }
    // This lane's cells; the one just past the core (if it reads it) from
    // the last-axis face, chosen here, where it is used.
    C c[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) c[e] = (w.past >> e) & 1u ? widen(past) : widen(cen.v[e]);
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
      // ((hi - 2c) + lo) · inv, axis 0, then 1, then 2, as lap_at sums.
      C lap = ((widen(dn.v[e]) - two * c[e]) + widen(up.v[e])) * inv0;
      if constexpr (NDIM == 3) {
        lap = lap + ((widen(mhi.v[e]) - two * c[e]) + widen(mlo.v[e])) * inv1;
        lap = lap + ((hi[e] - two * c[e]) + lo[e]) * inv2;
      } else {
        lap = lap + ((hi[e] - two * c[e]) + lo[e]) * inv1;
      }
      o.v[e] = narrow<S>(c[e] + widen(cm.v[e]) * lap);
    }
    S* dst = o_at + i * plane;
    if constexpr (VEC) {
      if (w.col >= g.lo_last && w.col + kN <= g.hi_last) {
        __stcs(reinterpret_cast<int4*>(dst + w.col), *reinterpret_cast<const int4*>(&o));
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e)
          if (w.col + e >= g.lo_last && w.col + e < g.hi_last) dst[w.col + e] = o.v[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int64_t x = w.col + 32 * e;
        if (x >= g.lo_last && x < g.hi_last) dst[x] = o.v[e];
      }
    }
    up = cen;
    cen = dn;
    dn = nx;
    edge = edge_dn;
    edge_dn = edge_nx;
    past = past_dn;
    past_dn = past_nx;
    cm = cm_nx;
    if constexpr (NDIM == 3) {
      mhi = mhi_nx;
      mlo = mlo_nx;
    }
  }
}

// fused_step_cm's f64 route: the face form cut for f64's stream on an H100,
// taken by every f64 launch (launch_fused_cm picks it by the storage type;
// f32 and bf16 keep rmt_fused_step_cm_kernel above). The same reads, the
// same last-axis neighbours by shuffle and the same sum as that kernel;
// what differs is the cut. Bound: memory. The shared kernel read 0.85 of
// the bytes bound in f64 on the hide cell's interior box (12288² rank,
// [32, 12256) × [4, 12284)), where masked_step reads 0.915 over the shard;
// this route reads 0.915 there, and 0.900 over the five hide boxes.
// - A lane holds kF64Cells2 cells of a row in 2D (kF64Cells3 in 3D), lane
//   + seg·e of its strip: the f64 stream wanted more bytes in flight a
//   warp. Interior box, 2 cells a lane 1.2379 ms (64 registers; caps for
//   more blocks an SM were no faster) against 4 cells' 1.1875 (96); 3D,
//   which carries the rows at m ± 1 too, takes 2 (128³: 0.0232 ms against
//   4 cells' 0.0311).
// - Runs of up to kF64RunRows rows, no register cap: runs of 2 / 3 / 4
//   took the interior box in 1.1915 / 1.1636 / 1.1744 ms (8: 1.2467
//   against 4's 1.1876 in another call).
// - The strips start on their own grid (seg · cells), so a box that
//   starts off it (the hide interior at column 4) reads whole lines, its
//   first strip's stores masked to the box.
// - A warp is split into segments of `seg` lanes (4, 8, 16 or 32: the
//   narrowest whose strip holds the box's last axis), each walking its own
//   run of rows, so a narrow box (a hide column slab, 4 cells wide) packs
//   32 / seg runs into a warp instead of leaving most of its lanes idle
//   (0.0112 → 0.0038 ms a slab); the shuffles stay inside a segment
//   (their width), and every segment of a warp loops the launch's run
//   length, its own rows predicated.
// - out is stored with the streaming hint (interior box 1.1825 → 1.1746
//   ms, 128³ 0.0263 → 0.0233), Cm read plainly in 2D and with the
//   streaming hint in 3D (each the faster there), T non-coherent.
// (device ms a launch, scripts/torch_face_variants.py, each comparison
// timed side by side in one call, H100 80GB HBM3 at 700.00 W.)
constexpr int kF64Cells2 = 4;  // a lane's cells of a row in 2D
constexpr int kF64Cells3 = 2;  // and in 3D, which also carries the rows at m ± 1
constexpr int kF64RunRows = 3;
constexpr int kF64MinSeg = 4;

template <int NDIM>
__global__ void __launch_bounds__(kMsWarps * 32)
rmt_fused_step_cm_f64_kernel(const double* __restrict__ T, FaceSet<double> f,
                             const double* __restrict__ Cm, double* __restrict__ out, FaceGeom g,
                             int seg, double inv0, double inv1, double inv2) {
  constexpr int kN = NDIM == 2 ? kF64Cells2 : kF64Cells3;
  constexpr int kLast = 2 * (NDIM - 1);  // the last axis's first face
  constexpr unsigned kAll = 0xffffffffu;
  struct Row {
    double v[kN];
  };
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int sl = lane & (seg - 1);  // this lane within its segment
  const int segs = 32 / seg;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kMsWarps + (threadIdx.x >> 5);
  if (warp * segs >= g.items) return;  // the whole warp: nothing below synchronises the block
  // item = (run · e_mid + mid) · strips + strip, one a segment; a segment
  // past the last item walks the last item's rows and reads and writes
  // nothing (it only takes part in its warp's shuffles).
  int64_t item = warp * segs + lane / seg;
  const bool live = item < g.items;
  if (!live) item = g.items - 1;
  int64_t strip, mid = 0, run;
  if (g.items <= 0xffffffffLL) {
    const uint32_t it = static_cast<uint32_t>(item), st = static_cast<uint32_t>(g.strips);
    const uint32_t rs = it / st;
    strip = it - rs * st;
    if constexpr (NDIM == 3) {
      const uint32_t em = static_cast<uint32_t>(g.hi_mid - g.lo_mid);
      mid = rs % em;
      run = rs / em;
    } else {
      run = rs;
    }
  } else {
    const int64_t rs = item / g.strips;
    strip = item - rs * g.strips;
    if constexpr (NDIM == 3) {
      mid = rs % (g.hi_mid - g.lo_mid);
      run = rs / (g.hi_mid - g.lo_mid);
    } else {
      run = rs;
    }
  }
  // Rows and columns in 32 bits (the launcher refuses a larger core).
  const int n0 = static_cast<int>(g.n0);
  const int n_last = static_cast<int>(g.n_last);
  const int r0 = static_cast<int>(g.lo0 + run * g.run_rows);
  const int r1 = r0 + g.run_rows < g.hi0 ? r0 + g.run_rows : static_cast<int>(g.hi0);
  const int first = static_cast<int>(g.a0 + strip * seg * kN);  // the strip's first cell
  const int col = first + sl;                                    // this lane's first cell
  const int64_t m = NDIM == 3 ? g.lo_mid + mid : 0;
  const int64_t plane = g.n_mid * g.n_last;  // Cm's and out's axis-0 stride
  const int64_t ts0 = g.ts0;
  // Every pointer below is at this lane's first cell of row 0.
  const double* c_at = Cm + m * g.n_last + col;
  double* o_at = out + m * g.n_last + col;
  const double* t_at = T + m * g.ts1 + col;
  const double* f0_lo = f.p[0] == nullptr ? nullptr : f.p[0] + m * f.s[0][0] + col;
  const double* f0_hi = f.p[1] == nullptr ? nullptr : f.p[1] + m * f.s[1][0] + col;
  // The cells this lane reads of a row (the box and one neighbour a side):
  // `need` inside the core, `past` the one just past it, read from the
  // last-axis face above; and those it writes (the box's), `keep`.
  const int need_lo = static_cast<int>(g.lo_last) - 1;
  const int need_hi = static_cast<int>(g.hi_last);
  unsigned need = 0, past = 0, keep = 0;
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int x = col + seg * e;
    const bool read = live && x >= need_lo && x <= need_hi;
    need |= (read && x < n_last ? 1u : 0u) << e;
    past |= (read && x == n_last ? 1u : 0u) << e;
    keep |= (live && x > need_lo && x < need_hi ? 1u : 0u) << e;
  }
  const double* fl_hi = f.p[kLast + 1];
  const int64_t fl_hi_s = f.s[kLast + 1][0];
  if (fl_hi != nullptr && NDIM == 3) fl_hi += m * f.s[kLast + 1][1];
  if (past == 0u) fl_hi = nullptr;
  // In 3D, the rows at m ± 1: row i at base + i · stride, from T inside
  // the core, from the axis-1 faces just outside it (null: zeros).
  const double* mh_base = nullptr;
  const double* ml_base = nullptr;
  int64_t mh_s = ts0, ml_s = ts0;
  if constexpr (NDIM == 3) {
    if (m + 1 < g.n_mid) {
      mh_base = t_at + g.ts1;
    } else if (f.p[3] != nullptr) {
      mh_base = f.p[3] + col;
      mh_s = f.s[3][0];
    }
    if (m > 0) {
      ml_base = t_at - g.ts1;
    } else if (f.p[2] != nullptr) {
      ml_base = f.p[2] + col;
      ml_s = f.s[2][0];
    }
  }
  // The strip's outer neighbours: the segment's first lane's left, its
  // last lane's right, from T, or from a last-axis face at the core's
  // edge; row i at edge_base[i · edge_s].
  const int outer = sl == 0 ? first - 1 : first + seg * kN;
  const double* edge_base = nullptr;
  int64_t edge_s = ts0;
  if (live && (sl == 0 || sl == seg - 1) && outer >= need_lo && outer <= need_hi) {
    if (outer < 0) {
      edge_base = f.p[kLast];
      edge_s = f.s[kLast][0];
      if (edge_base != nullptr && NDIM == 3) edge_base += m * f.s[kLast][1];
    } else if (outer >= n_last) {
      edge_base = f.p[kLast + 1];
      edge_s = fl_hi_s;
      if (edge_base != nullptr && NDIM == 3) edge_base += m * f.s[kLast + 1][1];
    } else {
      edge_base = t_at + (outer - col);
    }
  }
  // This lane's cells of row i of axis 0 (when `on`; else zeros): T in the
  // core (the cell past it from the last-axis face), the axis-0 faces at
  // i = -1 and n0; each load straight into its register.
  auto row = [&](int i, bool on) -> Row {
    Row r;
    const bool core = i >= 0 && i < n0;
    const double* base = core ? t_at + i * ts0 : (i < 0 ? f0_lo : f0_hi);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      r.v[e] = 0.0;
      if (on && base != nullptr && ((need >> e) & 1u)) r.v[e] = __ldg(base + seg * e);
      if (on && core && fl_hi != nullptr && ((past >> e) & 1u)) r.v[e] = __ldg(fl_hi + i * fl_hi_s);
    }
    return r;
  };
  // The same cells of a row at `base` (null: zeros), inside the core.
  auto load = [&](const double* base, bool stream) -> Row {
    Row r;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      r.v[e] = 0.0;
      if (base != nullptr && ((need >> e) & 1u)) {
        const double* at = base + seg * e;
        r.v[e] = !stream ? __ldg(at) : NDIM == 3 ? __ldcs(at) : *at;
      }
    }
    return r;
  };
  auto edge_of = [&](int i, bool on) -> double {
    return on && edge_base != nullptr && i >= 0 && i < n0 ? __ldg(edge_base + i * edge_s) : 0.0;
  };
  Row up = row(r0 - 1, true);
  Row cen = row(r0, true);
  Row dn = row(r0 + 1, true);
  double edge = edge_of(r0, true);
  Row cm = load(c_at + r0 * plane, true);
  Row mhi, mlo;
  if constexpr (NDIM == 3) {
    mhi = load(mh_base == nullptr ? nullptr : mh_base + r0 * mh_s, false);
    mlo = load(ml_base == nullptr ? nullptr : ml_base + r0 * ml_s, false);
  }
  const int up_lane = (sl + seg - 1) & (seg - 1);
  const int dn_lane = (sl + 1) & (seg - 1);
  // Every segment loops the launch's run length (the shuffles need the
  // whole warp); rows past its own run are neither read nor written.
  for (int k = 0; k < g.run_rows; ++k) {
    const int i = r0 + k;
    // The next row's loads, in flight while this one is computed.
    const bool more = i + 1 < r1;
    const Row nx = row(i + 2, more);
    const double edge_nx = edge_of(i + 1, more);
    const Row cm_nx = load(more ? c_at + (i + 1) * plane : nullptr, true);
    Row mhi_nx, mlo_nx;
    if constexpr (NDIM == 3) {
      mhi_nx = load(more && mh_base != nullptr ? mh_base + (i + 1) * mh_s : nullptr, false);
      mlo_nx = load(more && ml_base != nullptr ? ml_base + (i + 1) * ml_s : nullptr, false);
    }
    const double* c = cen.v;
    // The neighbours along the last axis: lo[e] at cell - 1, hi[e] at +1;
    // cell e of the segment's lane before, and after (cyclic).
    double lo[kN], hi[kN], rot_l[kN], rot_r[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      rot_l[e] = __shfl_sync(kAll, c[e], up_lane, seg);
      rot_r[e] = __shfl_sync(kAll, c[e], dn_lane, seg);
    }
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      lo[e] = sl > 0 ? rot_l[e] : (e > 0 ? rot_l[e - 1] : edge);
      hi[e] = sl < seg - 1 ? rot_r[e] : (e + 1 < kN ? rot_r[e + 1] : edge);
    }
    const bool on = i < r1;
    double* dst = o_at + i * plane;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      // ((hi - 2c) + lo) · inv, axis 0, then 1, then 2, as lap_at sums.
      double lap = ((dn.v[e] - 2.0 * c[e]) + up.v[e]) * inv0;
      if constexpr (NDIM == 3) {
        lap = lap + ((mhi.v[e] - 2.0 * c[e]) + mlo.v[e]) * inv1;
        lap = lap + ((hi[e] - 2.0 * c[e]) + lo[e]) * inv2;
      } else {
        lap = lap + ((hi[e] - 2.0 * c[e]) + lo[e]) * inv1;
      }
      if (on && ((keep >> e) & 1u)) __stcs(dst + seg * e, c[e] + cm.v[e] * lap);
    }
    up = cen;
    cen = dn;
    dn = nx;
    edge = edge_nx;
    cm = cm_nx;
    if constexpr (NDIM == 3) {
      mhi = mhi_nx;
      mlo = mlo_nx;
    }
  }
}

// fused_step_padded: masked_step's lane tiling (16 bytes of a row a lane,
// runs of rows with the rows above and below carried in registers, widened
// once, the next row's loads in flight, last-axis neighbours by shuffle),
// read from the width-1-padded source Tp instead of an unpadded field.
// Tp's core rows start one cell into a row of stride n_last + 2, never all
// on the 16-byte grid, so a lane reads its cells of a Tp row element by
// element (the L1 merges a warp's requests, as kp_update and kp_flux read
// Tp); a row's cells are read up to column n_last, the ghost column, so
// the lane that holds it hands it to its neighbour by shuffle. The strip's
// two outer neighbours are loaded from the padded ring by lanes 0 and 31
// (real ghosts, not zeros); the rows above the first and below the last
// core row, and in 3D the rows at axis-1 indices ± 1, are Tp's ghost rows,
// read as rows. Layouts (padded_layout below):
// - VEC (the wrapper allows it: f32 and bf16, the last axis a multiple of
//   kN = 16 / itemsize cells, Cp and out on the 16-byte grid): kN
//   consecutive cells, Cp loaded and out stored as one 16-byte vector each
//   with the streaming hints;
// - scalar cells (a ragged last axis, Cp or out off the grid): kN cells
//   lane + 32e of the strip, every access scalar and coalesced;
// - and, in f64 and for a field that gives fewer than kMsFillWarps warps
//   of 16-byte lanes (252², a 96×64×48 block), one cell a thread
//   (rmt_fused_step_padded_cell_kernel below).
// The sum is lap_at's, ((hi - 2c) + lo) · inv per axis, axis 0, then 1,
// then 2, and the coefficient the division dtlam / Cp, as the plain
// version forms it (masked_step sums ((dn + up) - 2c): not this order).
// Runs of up to kPadRunRows rows (kPadRunRowsBf16 in bf16), cut shorter
// until the launch has kMsFillWarps warps, as masked_step cuts its runs:
// in bf16, with twice f32's cells a lane, runs of 4 took 0.3416 ms at
// 12288² against 0.3291-0.3292 for 8 (scripts/torch_kernel_ab.py, a
// variant tree of this package timed beside it, one call, H100 80GB HBM3
// at 700.00 W).
constexpr int kPadRunRows = 4;
constexpr int kPadRunRowsBf16 = 8;

template <typename S, int NDIM, bool VEC>
__global__ void __launch_bounds__(kMsWarps * 32)
rmt_fused_step_padded_kernel(const S* __restrict__ Tp, const S* __restrict__ Cp,
                         S* __restrict__ out, int64_t n0, int64_t n_mid, int64_t n_last,
                         int64_t strips, int64_t items, int run_rows,
                         typename Compute<S>::type dtlam,
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
  // item = (run · n_mid + mid) · strips + strip, in 32 bits where the
  // launch fits them, as the face form divides
  int64_t strip, mid, run;
  if (items <= 0xffffffffLL) {
    const uint32_t it = static_cast<uint32_t>(item), st = static_cast<uint32_t>(strips);
    const uint32_t rs = it / st, nm = static_cast<uint32_t>(n_mid);
    strip = it - rs * st;
    mid = rs % nm;
    run = rs / nm;
  } else {
    const int64_t rs = item / strips;
    strip = item - rs * strips;
    mid = rs % n_mid;
    run = rs / n_mid;
  }
  const int64_t r0 = run * run_rows;
  const int64_t r1 = r0 + run_rows < n0 ? r0 + run_rows : n0;
  const int64_t pl = n_last + 2;                           // Tp's last-axis extent
  const int64_t ps0 = NDIM == 3 ? (n_mid + 2) * pl : pl;   // Tp's axis-0 stride
  const int64_t plane = n_mid * n_last;                    // Cp's and out's axis-0 stride
  const int64_t first = strip * 32 * kN;                    // the strip's first cell
  const int64_t col = first + (VEC ? lane * kN : lane);     // this lane's first cell
  // Core row g (-1 .. n0: the ghost rows included) at this warp's axis-1
  // index: cell j (-1 .. n_last) at t_at[(g + 1) · ps0 + j].
  const S* t_at = Tp + (NDIM == 3 ? (mid + 1) * pl : 0) + 1;
  const S* c_at = Cp + mid * n_last;
  S* o_at = out + mid * n_last;
  const S zero = ms_zero<S>();
  // This lane's cells of the Tp row at `base` (up to the ghost column n_last).
  auto row_of = [&](const S* base, int64_t g, bool on) -> Row {
    Row r;
    const S* p = base + (g + 1) * ps0;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int64_t j = col + (VEC ? e : 32 * e);
      r.v[e] = on && j <= n_last ? p[j] : zero;
    }
    return r;
  };
  // This lane's cells of Cp's row g (in the core only).
  auto cp_of = [&](int64_t g, bool on) -> Row {
    Row r;
    const S* p = c_at + g * plane;
    if constexpr (VEC) {
      if (on && col < n_last) {
        *reinterpret_cast<int4*>(&r) = __ldcs(reinterpret_cast<const int4*>(p + col));
        return r;
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) r.v[e] = zero;
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) r.v[e] = on && col + 32 * e < n_last ? p[col + 32 * e] : zero;
    }
    return r;
  };
  // The strip's outer neighbours of a row: lane 0's left (always in the
  // row: the ghost column -1 at the first strip), lane 31's right.
  const int64_t outer = lane == 0 ? first - 1 : first + 32 * kN;
  const bool outer_in = lane == 0 || (lane == 31 && outer <= n_last);
  auto edge_of = [&](int64_t g, bool on) -> S {
    return on && outer_in ? t_at[(g + 1) * ps0 + outer] : zero;
  };
  // The carried rows, widened once each as they arrive.
  struct Wide {
    C v[kN];
  };
  auto wide = [](const Row& r) -> Wide {
    Wide w;
#pragma unroll
    for (int e = 0; e < kN; ++e) w.v[e] = widen(r.v[e]);
    return w;
  };
  Wide up = wide(row_of(t_at, r0 - 1, true));
  Wide cen = wide(row_of(t_at, r0, true));
  Wide dn = wide(row_of(t_at, r0 + 1, true));
  S edge = edge_of(r0, true);
  Row cp = cp_of(r0, true);
  Row mhi, mlo;
  if constexpr (NDIM == 3) {
    mhi = row_of(t_at + pl, r0, true);
    mlo = row_of(t_at - pl, r0, true);
  }
  const C two = C(2);
  for (int64_t g = r0; g < r1; ++g) {
    // The next row's loads, in flight while this one is computed.
    const bool more = g + 1 < r1;
    const Row nx = row_of(t_at, g + 2, more);
    const S edge_nx = edge_of(g + 1, more);
    const Row cp_nx = cp_of(g + 1, more);
    Row mhi_nx, mlo_nx;
    if constexpr (NDIM == 3) {
      mhi_nx = row_of(t_at + pl, g + 1, more);
      mlo_nx = row_of(t_at - pl, g + 1, more);
    }
    const C* c = cen.v;
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
      // ((hi - 2c) + lo) · inv, axis 0, then 1, then 2, as lap_at sums.
      C lap = ((dn.v[e] - two * c[e]) + up.v[e]) * inv0;
      if constexpr (NDIM == 3) {
        lap = lap + ((widen(mhi.v[e]) - two * c[e]) + widen(mlo.v[e])) * inv1;
        lap = lap + ((hi[e] - two * c[e]) + lo[e]) * inv2;
      } else {
        lap = lap + ((hi[e] - two * c[e]) + lo[e]) * inv1;
      }
      o.v[e] = narrow<S>(c[e] + (dtlam / widen(cp.v[e])) * lap);
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
    dn = wide(nx);
    edge = edge_nx;
    cp = cp_nx;
    if constexpr (NDIM == 3) {
      mhi = mhi_nx;
      mlo = mlo_nx;
    }
  }
}

// fused_step_padded, one cell a thread: 32x8 blocks along the last axis
// (the leading axis on grid.z in 3D), the 2·ndim neighbour reads from the
// lines the block pulled into L1/L2, lap_at's sum: the kernel before the
// lane tiling. Below the fill the tiling's few warps each walk a longer
// chain with more registers (60-160 a thread against 20-32) and lose to
// this form: 252² f32 0.0066 ms against 0.0058, the 96×64×48 block
// 0.0111 against 0.0070-0.0071 in f32, 0.0099 against 0.0074-0.0075 in
// f64, 0.0159 against 0.0072 in bf16. In f64 the tiling's scalar cells
// read 1.1712 ms at 12288² and 0.2998 at 6144² against this form's
// 1.1729-1.1730 and 0.2972-0.2973 (an earlier call: 1.1836-1.1858 against
// 1.1793), no gain, so f64 keeps this form at every size and builds no
// tiling (device ms, scripts/torch_kernel_ab.py, a variant tree whose rule
// takes the tiling timed beside this one, one call, H100 80GB HBM3 at
// 700.00 W).
template <typename S, int NDIM>
__global__ void __launch_bounds__(rmt::kBlockX * rmt::kBlockY)
rmt_fused_step_padded_cell_kernel(const S* __restrict__ Tp, const S* __restrict__ Cp,
                              S* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                              typename Compute<S>::type dtlam,
                              typename Compute<S>::type inv0,
                              typename Compute<S>::type inv1,
                              typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(Box{0, 0, 0, n0, n1, n2}, &i0, &i1, &i2)) return;
  const rmt::Region<NDIM> r(n1, n2, 1);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const C c = widen(Tp[p]);
  const C lap = rmt::lap_at<S, NDIM>(Tp, r, p, c, inv0, inv1, inv2);
  out[idx] = narrow<S>(c + (dtlam / widen(Cp[idx])) * lap);
}

template <typename S, int NDIM, bool VEC>
int launch_masked_nd(const S* t, const S* cm, S* o, int64_t n0, int64_t n_mid,
                     int64_t n_last, double inv0, double inv1, double inv2, int run_cap,
                     cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = MsRow<S>::kN;
  if (n0 < 1 || n_mid < 1 || n_last < 1) return -2;
  const int64_t strips = (n_last + 32 * kN - 1) / (32 * kN);
  // Runs of kMsRunRows rows (at most `run_cap` where it is > 0: the tuning
  // plane's run_rows), cut shorter where the field gives fewer than
  // kMsFillWarps warps of them (a small field: more, shorter walks). A
  // cell's arithmetic does not depend on its run.
  const int64_t cols = strips * n_mid;
  const int64_t longest = run_cap > 0 && run_cap < kMsRunRows ? run_cap : kMsRunRows;
  int64_t run_rows = cols * n0 / kMsFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > longest ? longest : run_rows;
  const int64_t items = cols * ((n0 + run_rows - 1) / run_rows);
  const int64_t blocks = (items + kMsWarps - 1) / kMsWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_masked_step_kernel<S, NDIM, VEC><<<static_cast<unsigned>(blocks), kMsWarps * 32, 0, stream>>>(
      t, cm, o, n0, n_mid, n_last, strips, items, static_cast<int>(run_rows), C(inv0),
      C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

// `vec`: the wrapper's layout choice (VEC above); a launch that asks for it
// on a field it does not fit is refused (-1) rather than misread.
template <typename S>
int launch_masked(int ndim, const void* T, const void* Cm, void* out,
                  int64_t n0, int64_t n1, int64_t n2, double inv0,
                  double inv1, double inv2, int vec, int run_cap, cudaStream_t stream) {
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
      return launch_masked_nd<S, 2, true>(t, cm, o, n0, 1, n1, inv0, inv1, 0.0, run_cap,
                                          stream);
    if (vec)
      return launch_masked_nd<S, 3, true>(t, cm, o, n0, n1, n2, inv0, inv1, inv2, run_cap,
                                          stream);
  }
  if (ndim == 2)
    return launch_masked_nd<S, 2, false>(t, cm, o, n0, 1, n1, inv0, inv1, 0.0, run_cap,
                                         stream);
  return launch_masked_nd<S, 3, false>(t, cm, o, n0, n1, n2, inv0, inv1, inv2, run_cap,
                                       stream);
}

template <typename S, int NDIM, bool VEC>
int launch_fused_cm_nd(const S* t, const FaceSet<S>& f, const S* cm, S* o, FaceGeom g,
                       double inv0, double inv1, double inv2, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = MsRow<S>::kN;
  // Strips on the kN-cell grid in VEC (the box's first vector may start
  // before the box), from the box's first cell otherwise.
  g.a0 = VEC ? g.lo_last - g.lo_last % kN : g.lo_last;
  g.strips = (g.hi_last - g.a0 + 32 * kN - 1) / (32 * kN);
  const int64_t e0 = g.hi0 - g.lo0;
  // Runs of kFaceRunRows rows, cut shorter where the box gives fewer than
  // kMsFillWarps warps of them, as masked_step cuts them.
  const int64_t cols = g.strips * (g.hi_mid - g.lo_mid);
  int64_t run_rows = cols * e0 / kMsFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > kFaceRunRows ? kFaceRunRows : run_rows;
  g.run_rows = static_cast<int>(run_rows);
  g.items = cols * ((e0 + run_rows - 1) / run_rows);
  const int64_t blocks = (g.items + kMsWarps - 1) / kMsWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_fused_step_cm_kernel<S, NDIM, VEC><<<static_cast<unsigned>(blocks), kMsWarps * 32, 0, stream>>>(
      t, f, cm, o, g, C(inv0), C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

// The f64 route's cut (rmt_fused_step_cm_f64_kernel): the narrowest
// segment whose strip, on its own grid, holds the box's last axis (32
// lanes where none does), strips on that grid, and runs of kF64RunRows
// rows, cut shorter where the box gives fewer than kMsFillWarps warps of
// them.
template <int NDIM>
int launch_fused_cm_f64(const double* t, const FaceSet<double>& f, const double* cm, double* o,
                        FaceGeom g, double inv0, double inv1, double inv2, cudaStream_t stream) {
  constexpr int kN = NDIM == 2 ? kF64Cells2 : kF64Cells3;
  if (g.n0 > INT32_MAX || g.n_last > INT32_MAX - 32 * kN) return -2;  // rows, columns in 32 bits
  int seg = 32;
  for (int s = kF64MinSeg; s < 32; s *= 2) {
    const int64_t w = static_cast<int64_t>(s) * kN;
    if (g.hi_last - (g.lo_last - g.lo_last % w) <= w) {
      seg = s;
      break;
    }
  }
  const int64_t width = static_cast<int64_t>(seg) * kN;
  const int64_t segs = 32 / seg;
  g.a0 = g.lo_last - g.lo_last % width;
  g.strips = (g.hi_last - g.a0 + width - 1) / width;
  const int64_t e0 = g.hi0 - g.lo0;
  const int64_t cols = g.strips * (g.hi_mid - g.lo_mid);
  int64_t run_rows = cols * e0 / (static_cast<int64_t>(kMsFillWarps) * segs);
  run_rows = run_rows < 1 ? 1 : run_rows > kF64RunRows ? kF64RunRows : run_rows;
  g.run_rows = static_cast<int>(run_rows);
  g.items = cols * ((e0 + run_rows - 1) / run_rows);
  const int64_t blocks = ((g.items + segs - 1) / segs + kMsWarps - 1) / kMsWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_fused_step_cm_f64_kernel<NDIM><<<static_cast<unsigned>(blocks), kMsWarps * 32, 0, stream>>>(
      t, f, cm, o, g, seg, inv0, inv1, inv2);
  return static_cast<int>(cudaGetLastError());
}

// `vec`: the wrapper's layout choice (ops/kernels.face_layout); a launch
// that asks for the 16-byte layout where a row read as vectors is off the
// 16-byte grid is refused (-1) rather than misread, as is a row face whose
// last axis is not contiguous.
template <typename S>
int launch_fused_cm(int ndim, const void* T, const int64_t* t_strides, const int64_t* faces,
                    const int64_t* face_strides, const void* Cm, void* out, int64_t n0,
                    int64_t n1, int64_t n2, const Box& box, double inv0, double inv1,
                    double inv2, int vec, cudaStream_t stream) {
  constexpr int kN = MsRow<S>::kN;
  const bool three = ndim == 3;
  FaceSet<S> f;
  for (int k = 0; k < kFaces; ++k) {
    const bool given = k < 2 * ndim && faces[k] != 0;
    f.p[k] = given ? reinterpret_cast<const S*>(static_cast<uintptr_t>(faces[k])) : nullptr;
    f.s[k][0] = k < 2 * ndim ? face_strides[2 * k] : 0;
    f.s[k][1] = k < 2 * ndim ? face_strides[2 * k + 1] : 0;
  }
  FaceGeom g{};
  g.n0 = n0;
  g.n_mid = three ? n1 : 1;
  g.n_last = three ? n2 : n1;
  g.ts0 = t_strides[0];
  g.ts1 = three ? t_strides[1] : 0;
  g.lo0 = box.lo0;
  g.hi0 = box.lo0 + box.e0;
  g.lo_mid = three ? box.lo1 : 0;
  g.hi_mid = three ? box.lo1 + box.e1 : 1;
  g.lo_last = three ? box.lo2 : box.lo1;
  g.hi_last = three ? box.lo2 + box.e2 : box.lo1 + box.e1;
  uintptr_t grid = reinterpret_cast<uintptr_t>(T) | reinterpret_cast<uintptr_t>(Cm) |
                   reinterpret_cast<uintptr_t>(out);
  bool rows_on_grid = g.n_last % kN == 0 && g.ts0 % kN == 0 && g.ts1 % kN == 0;
  for (int k = 0; k < 2 * (ndim - 1); ++k) {  // the faces read as rows
    if (f.p[k] == nullptr) continue;
    const int64_t last_stride = three ? f.s[k][1] : f.s[k][0];
    if (g.n_last > 1 && last_stride != 1) return -1;
    grid |= reinterpret_cast<uintptr_t>(f.p[k]);
    if (three) rows_on_grid = rows_on_grid && f.s[k][0] % kN == 0;
  }
  if (vec && (!kVecLayout<S> || !rows_on_grid || grid % kMsBytes != 0)) return -1;
  const auto* t = static_cast<const S*>(T);
  const auto* cm = static_cast<const S*>(Cm);
  auto* o = static_cast<S*>(out);
  if constexpr (std::is_same_v<S, double>) {  // f64: its own route
    if (!three) return launch_fused_cm_f64<2>(t, f, cm, o, g, inv0, inv1, 0.0, stream);
    return launch_fused_cm_f64<3>(t, f, cm, o, g, inv0, inv1, inv2, stream);
  } else {
    if constexpr (kVecLayout<S>) {
      if (vec && !three)
        return launch_fused_cm_nd<S, 2, true>(t, f, cm, o, g, inv0, inv1, 0.0, stream);
      if (vec) return launch_fused_cm_nd<S, 3, true>(t, f, cm, o, g, inv0, inv1, inv2, stream);
    }
    if (!three) return launch_fused_cm_nd<S, 2, false>(t, f, cm, o, g, inv0, inv1, 0.0, stream);
    return launch_fused_cm_nd<S, 3, false>(t, f, cm, o, g, inv0, inv1, inv2, stream);
  }
}

template <typename S, int NDIM, bool VEC>
int launch_fused_padded_nd(const S* t, const S* cp, S* o, int64_t n0, int64_t n_mid,
                           int64_t n_last, double dtlam, double inv0, double inv1, double inv2,
                           cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = MsRow<S>::kN;
  const int64_t strips = (n_last + 32 * kN - 1) / (32 * kN);
  // Runs of kPadRunRows rows (kPadRunRowsBf16 in bf16), cut shorter where
  // the field gives fewer than kMsFillWarps warps of them.
  const int64_t longest = sizeof(S) == 2 ? kPadRunRowsBf16 : kPadRunRows;
  const int64_t cols = strips * n_mid;
  int64_t run_rows = cols * n0 / kMsFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > longest ? longest : run_rows;
  const int64_t items = cols * ((n0 + run_rows - 1) / run_rows);
  const int64_t blocks = (items + kMsWarps - 1) / kMsWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_fused_step_padded_kernel<S, NDIM, VEC>
      <<<static_cast<unsigned>(blocks), kMsWarps * 32, 0, stream>>>(
          t, cp, o, n0, n_mid, n_last, strips, items, static_cast<int>(run_rows), C(dtlam),
          C(inv0), C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_fused_padded_cell(int ndim, const S* t, const S* cp, S* o, int64_t n0, int64_t n1,
                             int64_t n2, double dtlam, double inv0, double inv1, double inv2,
                             cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, Box{0, 0, 0, n0, n1, ndim == 2 ? 1 : n2}, &grid)) return -2;
  const dim3 block(rmt::kBlockX, rmt::kBlockY);
  if (ndim == 2) {
    rmt_fused_step_padded_cell_kernel<S, 2><<<grid, block, 0, stream>>>(
        t, cp, o, n0, n1, 1, C(dtlam), C(inv0), C(inv1), C(0));
  } else {
    rmt_fused_step_padded_cell_kernel<S, 3><<<grid, block, 0, stream>>>(
        t, cp, o, n0, n1, n2, C(dtlam), C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

// The layout of a launch over the core (n0, n1, n2) (0 scalar cells, 1 the
// 16-byte vectors, 2 one cell a thread): one cell a thread in f64 and
// where the field gives fewer than kMsFillWarps warps of 16-byte lanes
// (one row each), else the vectors where the wrapper allows them
// (`vectors`), else scalar cells.
template <typename S>
int padded_layout(int ndim, int64_t n0, int64_t n1, int64_t n2, bool vectors) {
  if constexpr (!kVecLayout<S>) {
    return 2;
  } else {
    constexpr int kN = MsRow<S>::kN;
    const int64_t n_last = ndim == 2 ? n1 : n2;
    const int64_t n_mid = ndim == 2 ? 1 : n1;
    const int64_t strips = (n_last + 32 * kN - 1) / (32 * kN);
    if (strips * n_mid * n0 < kMsFillWarps) return 2;
    return vectors ? 1 : 0;
  }
}

// A launch that allows the vectors where they do not fit (f64, a last axis
// no multiple of kN, Cp or out off the 16-byte grid) is refused (-1)
// rather than misread.
template <typename S>
int launch_fused_padded(int ndim, const void* Tp, const void* Cp, void* out, int64_t n0,
                        int64_t n1, int64_t n2, double dtlam, double inv0, double inv1,
                        double inv2, bool vectors, cudaStream_t stream) {
  constexpr int kN = MsRow<S>::kN;
  if (n0 < 1 || n1 < 1 || n2 < 1) return -2;
  const auto* t = static_cast<const S*>(Tp);
  const auto* cp = static_cast<const S*>(Cp);
  auto* o = static_cast<S*>(out);
  const bool two = ndim == 2;
  const int64_t n_last = two ? n1 : n2;
  if (vectors && (!kVecLayout<S> || n_last % kN != 0 ||
                  ((reinterpret_cast<uintptr_t>(Cp) | reinterpret_cast<uintptr_t>(out)) %
                   kMsBytes) != 0))
    return -1;
  const int layout = padded_layout<S>(ndim, n0, n1, n2, vectors);
  if constexpr (kVecLayout<S>) {
    if (layout == 1 && two)
      return launch_fused_padded_nd<S, 2, true>(t, cp, o, n0, 1, n1, dtlam, inv0, inv1, 0.0,
                                                stream);
    if (layout == 1)
      return launch_fused_padded_nd<S, 3, true>(t, cp, o, n0, n1, n2, dtlam, inv0, inv1, inv2,
                                                stream);
    if (layout == 0 && two)
      return launch_fused_padded_nd<S, 2, false>(t, cp, o, n0, 1, n1, dtlam, inv0, inv1, 0.0,
                                                 stream);
    if (layout == 0)
      return launch_fused_padded_nd<S, 3, false>(t, cp, o, n0, n1, n2, dtlam, inv0, inv1,
                                                 inv2, stream);
  }
  return launch_fused_padded_cell<S>(ndim, t, cp, o, n0, n1, n2, dtlam, inv0, inv1, inv2,
                                     stream);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the unpadded (core) extents, n2 = 1 in 2D; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch, -1 for an
// unsupported dtype or rank (or a box outside the core), -2 for a grid
// that overflows a launch dimension. The launch is asynchronous on `stream`;
// nothing here synchronises or allocates.

// `run_cap` > 0 caps the rows a warp walks (the tuning plane's run_rows);
// 0 keeps the rule of launch_masked_nd. `vec` 1 takes the 16-byte layout
// (f32 and bf16 only, the last axis a multiple of 16 bytes, T, Cm and out
// on the 16-byte grid; -1 otherwise), 0 the scalar one.
extern "C" int rmt_masked_step(int dtype, int ndim, const void* T,
                               const void* Cm, void* out, int64_t n0,
                               int64_t n1, int64_t n2, double inv0,
                               double inv1, double inv2, int run_cap, int vec,
                               void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  if (run_cap < 0) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_masked<float>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec, run_cap,
                                  s);
    case kF64:
      return launch_masked<double>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec, run_cap,
                                   s);
    case kBF16:
      return launch_masked<__nv_bfloat16>(ndim, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, vec,
                                          run_cap, s);
    default:
      return -1;
  }
}

// The box is [lo, lo + e) per axis of the core (n0, n1, n2). `T` is the
// core with strides `t_strides` (axes 0 and 1; the last axis contiguous);
// `faces` the 2·ndim face pointers, face (axis a, side s) at 2a + s, 0 for
// none (read as zeros); `face_strides` two per face, its strides along its
// other axes in axis order. Cm and out are contiguous with the core's
// extents; out is written only inside the box. `vec` as rmt_masked_step's.
extern "C" int rmt_fused_step_cm(int dtype, int ndim, const void* T, const int64_t* t_strides,
                                 const int64_t* faces, const int64_t* face_strides,
                                 const void* Cm, void* out, int64_t n0, int64_t n1,
                                 int64_t n2, int64_t lo0, int64_t lo1, int64_t lo2, int64_t e0,
                                 int64_t e1, int64_t e2, double inv0, double inv1,
                                 double inv2, int vec, void* stream) {
  const Box box{lo0, lo1, ndim == 2 ? 0 : lo2, e0, e1, ndim == 2 ? 1 : e2};
  if (!rmt::box_fits(box, 1, ndim, n0, n1, n2)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fused_cm<float>(ndim, T, t_strides, faces, face_strides, Cm, out, n0, n1,
                                    n2, box, inv0, inv1, inv2, vec, s);
    case kF64:
      return launch_fused_cm<double>(ndim, T, t_strides, faces, face_strides, Cm, out, n0, n1,
                                     n2, box, inv0, inv1, inv2, vec, s);
    case kBF16:
      return launch_fused_cm<__nv_bfloat16>(ndim, T, t_strides, faces, face_strides, Cm, out,
                                            n0, n1, n2, box, inv0, inv1, inv2, vec, s);
    default:
      return -1;
  }
}

// `Tp` is the core (n0, n1, n2) grown by one cell on every axis; Cp and out
// have the core's extents. `dtlam` is the double dt·λ. `vectors` allows
// the 16-byte vectors (f32 and bf16, the last axis a multiple of 16 bytes,
// Cp and out on the 16-byte grid; -1 otherwise); the launch takes them
// unless the field is too small to fill the card that way. Tp is read cell
// by cell in every layout.
extern "C" int rmt_fused_step_padded(int dtype, int ndim, const void* Tp, const void* Cp,
                                     void* out, int64_t n0, int64_t n1, int64_t n2,
                                     double dtlam, double inv0, double inv1, double inv2,
                                     int vectors, void* stream) {
  if (ndim != 2 && ndim != 3) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32:
      return launch_fused_padded<float>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0, inv1,
                                        inv2, v, s);
    case kF64:
      return launch_fused_padded<double>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0, inv1,
                                         inv2, v, s);
    case kBF16:
      return launch_fused_padded<__nv_bfloat16>(ndim, Tp, Cp, out, n0, n1, n2, dtlam, inv0,
                                                inv1, inv2, v, s);
    default:
      return -1;
  }
}

// The layout a fused_step_padded launch of these arguments takes: 0 scalar
// cells, 1 the 16-byte vectors, 2 one cell a thread; -1 for an unsupported
// dtype or rank.
extern "C" int rmt_fused_step_padded_layout(int dtype, int ndim, int64_t n0, int64_t n1,
                                            int64_t n2, int vectors) {
  if (ndim != 2 && ndim != 3) return -1;
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32: return padded_layout<float>(ndim, n0, n1, n2, v);
    case kF64: return padded_layout<double>(ndim, n0, n1, n2, v);
    case kBF16: return padded_layout<__nv_bfloat16>(ndim, n0, n1, n2, v);
    default: return -1;
  }
}
