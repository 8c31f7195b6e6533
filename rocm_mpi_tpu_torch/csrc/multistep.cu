// Hand-written Hopper kernels of the heat-diffusion multi-step schedules.
//
// Two kernels, each advancing a 2D or 3D block several explicit steps in
// one launch, with neighbours outside the block read as 0:
//
//   rmt_multi_step_cm — `n_steps` steps of one of the four body forms of
//       rocm_mpi_tpu/ops/pallas_kernels.py _multi_step_kernel (direct,
//       A/c, eqc, conly; the Python planner picks the form). Replaces
//       _multi_step_kernel, reached through fused_multi_step and
//       multi_step_cm: the VMEM-resident loop and the deep-halo sweep's
//       local compute on small blocks.
//   rmt_tb_sweep — `k` direct-form steps by temporal blocking. Replaces
//       pallas_kernels.py _tb_kernel (via _make_tb_sweep), reached
//       through fused_multi_step_hbm and multi_step_cm_hbm: the
//       single-GPU large-field loop and the deep sweep's local compute
//       on large blocks.
//
// Each form keeps its TPU kernel's operation order, and the build uses
// -fmad=false, so each launch is bitwise equal to its plain PyTorch
// version (rocm_mpi_tpu_torch/ops/multistep.py). bf16 is storage-only:
// widened on load, the whole launch computed in f32, rounded once on
// store (pallas_kernels._upcast_for_compute).
//
// rmt_multi_step_cm — design. The TPU kernel keeps the block in VMEM for
// the whole chunk. Bound: neither bytes nor flops — at the sizes it runs on
// (the 252² field, the 316² deep block) a step is a few hundred nanoseconds
// of arithmetic, and what a step costs is the synchronisation between steps
// and the latency of the reads. So the block stays on chip for the whole
// launch (the cluster route, csrc/resident.cuh, as wave.cu's and swe.cu's
// multi-step kernels): one thread-block cluster of 16 CTAs (8 where the card
// grants no more) holds it in distributed shared memory, CTA r a band of
// rows along axis 0 in two compute-type buffers of T with a halo row each
// side, read from device memory once and written once. Each step reads
// only the CTA's own shared memory; its new edge rows go straight into the
// neighbours' halo rows (st.async), counted on their mbarriers, so no
// cluster barrier (and no cluster-scope fence: scripts/bench_cluster_sync.cu)
// runs between steps. Each cell's step reads only the previous step's
// neighbours, so the bands give the whole block's bits. One field and no
// second state leave registers free: where the band cuts into one run of
// at most kRegCells rows a warp (reg_seg_rows; every main-path block), each
// lane walks its run's cells with the cells below and at its row carried
// and keeps each cell's coefficient (Cm, or c = Cm·inv0 for the
// equal-spacing forms) in registers for the whole launch, so only T's
// neighbours pass through shared memory, and a cell costs few more
// instructions than its arithmetic (on 16 SMs a step is bound by
// instruction throughput: a walk by slices with a cursor a cell ran 1.5×
// longer, tables of per-cell offsets spilled at the 64 registers a thread
// has, and taking the band's last row first, to push it early, doubled the
// step, all measured on an H100); else the lanes walk the band's cells in
// slices (resident.cuh Walk), Cm staged into shared memory behind the
// buffers where it fits, else read from device memory each step. The A/c
// form's and eqc's other coefficients are recomputed each step: the same
// operations on the same operands give the prologue's bits. A block too
// large for one cluster's shared memory takes the cooperative route, chosen
// by size before the launch (ops/resident.py): a persistent cooperative
// launch ping-pongs between two compute-type buffers in L2 that the
// wrapper allocates, with a grid barrier (cooperative_groups grid sync)
// between steps and __ldcg reads (never a stale L1 line).

// rmt_tb_sweep — design. Bound: memory — one read of T and Cm and one
// write per k steps (3 passes; at 12304² f32, 1.82 GB, 0.54 ms on an H100
// SXM), against ~11 operations a cell and step that the redundant halo
// work multiplies. The light cone of the TPU's stripes carries over: a
// region with a halo of k cells, zero beyond it, gives its core exactly
// after k steps (the error of the zero ring moves one cell a step; k <=
// halo is the _tb_kernel contract), and cells beyond the block's edge hold
// T = 0 and Cm = 0, so each step leaves them exactly 0 (0 + 0·lap) and
// cells at the edge see the same zeros as the plain version.
//
// 2D streams along axis 0 (the time-skewed wavefront). A warp owns a
// strip of 128 loaded columns, 4 a lane (a core of 128 - 2k and k halo
// columns a side), over a segment of rows (its core plus k a side), and
// walks it once, top to bottom. Each row step loads one row of T and Cm
// (the next row's loads are in flight while this one computes) and
// advances each time level s = 1..k by one row, level s one row behind
// level s - 1; level k emits a finished core row, written straight out.
// A lane keeps two rows of each level in registers (k is a template
// argument and the row loop is unrolled by three, so the rotating slots
// are registers), gets the columns beside its four by shuffle, and reads
// Cm of the lagging rows from its own ring of k + 1 rows in shared memory.
// Warps never wait on each other: no barrier, no data passed between
// warps. Halo work is (128/(128 - 2k))·(1 + 2k/rows) per core cell (1.14
// × ~1.02 at k = 8 on 12304²). The segment height comes from the Python
// plan (ops/multistep.tb_plan), sized so the strips × segments fill the
// card's resident warps in whole waves.
//
// 3D keeps light-cone tiles in shared memory: each block loads a core
// tile plus k halo cells a side — T and Cm — runs k steps there
// ping-ponging two T buffers and writes its core. The tile starts at 16³
// of core and halves its largest axis until it fits a block's shared
// memory (at k = 8, 8x8x16 in f32): the halo dominates, and a 3D sweep
// does far more redundant work than a 2D one. No model runs it on the
// card yet.

#include <cooperative_groups.h>

#include "resident.cuh"
#include "stencil_common.cuh"

namespace cg = cooperative_groups;

namespace {

using rmt::Compute;
using rmt::kBF16;
using rmt::kF32;
using rmt::kF64;
using rmt::narrow;
using rmt::widen;

constexpr int kThreads = 256;
// The 2D tb_sweep: columns a lane holds, loaded columns of a warp's strip,
// and warps (independent strips) a block. ops/multistep.py reads these
// two lines (tb_layout) rather than restating them.
constexpr int kTbLaneCols = 4;
constexpr int kTbStripCols = 32 * kTbLaneCols;
constexpr int kTbWarpsPerBlock = 4;

enum Form : int { kDirect = 0, kAC = 1, kEQC = 2, kCOnly = 3 };

// rmt_multi_step_cm's cluster route: the longest run a warp (cells a lane)
// whose coefficients stay in registers (ops/resident.py reads this line),
// and where a launch reads Cm (the plan's choice, `cm_at`).
constexpr int kRegCells = 8;
enum CmAt : int { kCmDevice = 0, kCmShared = 1, kCmRegisters = 2 };

// The register layout of a band of `rows` rows: one run of rows a warp,
// a warp-column (32 cells of the last axis at one axis-1 index; n_mid ·
// ceil(n_last / 32) of them) cut into warps / columns segments. Returns the
// rows of a segment, the cells a lane keeps, or -1 when the band has more
// warp-columns than a CTA has warps (ops/resident.py reg_rows).
__host__ __device__ inline int reg_seg_rows(int rows, int n_mid, int n_last, int warps) {
  const int cols = n_mid * ((n_last + 31) / 32);
  if (cols > warps) return -1;
  const int segs = warps / cols;
  return (rows + segs - 1) / segs;
}

// The per-cell coefficient `k` that `update` takes: c = cm·inv0 for the
// equal-spacing forms (eqc, conly), cm itself for direct and A/c.
template <typename C, int FORM>
__device__ __forceinline__ C coef_of(C cm, C inv0) {
  return (FORM == kEQC || FORM == kCOnly) ? cm * inv0 : cm;
}

// One step of one cell in body form FORM. `t` is the cell, `k` its
// coefficient (coef_of), p_ax = (neighbour at +1) + (neighbour at -1) along
// axis ax (the TPU kernel's roll(T,-1,ax) + roll(T,1,ax)). Operation order
// as in _multi_step_kernel:
//   direct: lap = Σ_ax (p_ax - 2t)·inv_ax;          t + cm·lap
//   A/c:    c_ax = cm·inv_ax, A = 1 - 2·((c0 + c1) + c2);
//           ((A·t + c0·p0) + c1·p1) + c2·p2
//   eqc:    c = cm·inv0, s = (p0 + p1) + p2;        (1 - 2nd·c)·t + c·s
//   conly:  c = cm·inv0;                            t + c·(s - 2nd·t)
template <typename C, int NDIM, int FORM>
__device__ __forceinline__ C update(C t, C k, C p0, C p1, C p2, C inv0,
                                    C inv1, C inv2) {
  const C two = C(2);
  if (FORM == kDirect) {
    C lap = (p0 - two * t) * inv0;
    lap = lap + (p1 - two * t) * inv1;
    if (NDIM == 3) lap = lap + (p2 - two * t) * inv2;
    return t + k * lap;
  } else if (FORM == kAC) {
    const C c0 = k * inv0;
    const C c1 = k * inv1;
    C sum = c0 + c1;
    C c2 = C(0);
    if (NDIM == 3) {
      c2 = k * inv2;
      sum = sum + c2;
    }
    const C a = C(1) - two * sum;
    C acc = a * t;
    acc = acc + c0 * p0;
    acc = acc + c1 * p1;
    if (NDIM == 3) acc = acc + c2 * p2;
    return acc;
  } else {
    C s = p0 + p1;
    if (NDIM == 3) s = s + p2;
    const C nd2 = C(2 * NDIM);
    if (FORM == kEQC) {
      const C coef = C(1) - nd2 * k;
      return coef * t + k * s;
    }
    return t + k * (s - nd2 * t);
  }
}

// ---------------------------------------------------------------------------
// rmt_multi_step_cm
// ---------------------------------------------------------------------------

// Value of cell `i` at the start of step `step`: the input (storage type)
// for step 0, else the buffer the previous step wrote.
template <typename S, typename C>
__device__ __forceinline__ C fetch(int step, const S* __restrict__ T,
                                   C* buf0, C* buf1, int64_t i) {
  if (step == 0) return widen(T[i]);
  return __ldcg(((step - 1) & 1) ? buf1 + i : buf0 + i);
}

template <typename S, int NDIM, int FORM>
__global__ void __launch_bounds__(kThreads)
rmt_multi_step_cm_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                  S* __restrict__ out, typename Compute<S>::type* buf0,
                  typename Compute<S>::type* buf1, int n_steps, int64_t n0,
                  int64_t n1, int64_t n2, typename Compute<S>::type inv0,
                  typename Compute<S>::type inv1,
                  typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  cg::grid_group grid = cg::this_grid();
  const int64_t s1 = n2;       // stride of axis 1 (1 in 2D, where n2 == 1)
  const int64_t s0 = n1 * n2;  // stride of axis 0
  const int64_t cells = n0 * s0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const C zero = C(0);
  for (int step = 0; step < n_steps; ++step) {
    const bool last = step == n_steps - 1;
    C* dst = (step & 1) ? buf1 : buf0;
    for (int64_t i = first; i < cells; i += stride) {
      const int64_t i0 = i / s0;
      const int64_t r = i - i0 * s0;
      const int64_t i1 = r / n2;
      const int64_t i2 = r - i1 * n2;
      const C t = fetch<S, C>(step, T, buf0, buf1, i);
      const C p0 = (i0 + 1 < n0 ? fetch<S, C>(step, T, buf0, buf1, i + s0) : zero) +
                   (i0 > 0 ? fetch<S, C>(step, T, buf0, buf1, i - s0) : zero);
      const C p1 = (i1 + 1 < n1 ? fetch<S, C>(step, T, buf0, buf1, i + s1) : zero) +
                   (i1 > 0 ? fetch<S, C>(step, T, buf0, buf1, i - s1) : zero);
      C p2 = zero;
      if (NDIM == 3) {
        p2 = (i2 + 1 < n2 ? fetch<S, C>(step, T, buf0, buf1, i + 1) : zero) +
             (i2 > 0 ? fetch<S, C>(step, T, buf0, buf1, i - 1) : zero);
      }
      const C v = update<C, NDIM, FORM>(t, coef_of<C, FORM>(widen(Cm[i]), inv0), p0, p1, p2,
                                        inv0, inv1, inv2);
      if (last) {
        out[i] = narrow<S>(v);
      } else {
        dst[i] = v;
      }
    }
    if (!last) grid.sync();
  }
}

// The cluster route: CTA r of one cluster holds its band of T (see
// resident.cuh for the band plan) in two compute-type buffers of rows_max + 2
// rows: row r of the band at row r + 1, and around it the halo rows, the
// neighbour bands' edge rows (0 beyond the block). Step s reads buffer s % 2
// and writes the other; it reads only its own shared memory, writes each
// new edge row into the neighbour's halo row as well, with st.async, and
// waits on its own mbarrier for the halo rows its neighbours write
// (resident.cuh: the halo exchange). When REG, each warp walks one run of
// at most kRegCells rows of one warp-column (reg_seg_rows), the lane's
// coefficients in registers, loaded once; else each lane walks its warp's
// slice of the band (resident.cuh Walk) and each step reads Cm from
// `cm_src`, shared memory when `stage` (loaded there once) or device
// memory. Either walk carries the cells below and at its row. The last
// step is the loop body again with the stores to `out` in place of the
// stores and pushes to shared memory.
template <typename S, int NDIM, int FORM, bool REG>
__global__ void __launch_bounds__(rmt::kResidentThreads, 1)
rmt_multi_step_cm_resident_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                          S* __restrict__ out, int n_steps, int n0, int n_mid, int n_last,
                          int stage, typename Compute<S>::type inv0,
                          typename Compute<S>::type inv1, typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());
  const rmt::Band band = rmt::band_of(n0, nc, rank);
  const int plane = n_mid * n_last;
  const int cap = (band.rows_max + 2) * plane;  // cells of a buffer
  const int cells = band.rows * plane;          // cells of this band
  const int64_t base = static_cast<int64_t>(band.start) * plane;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // halo arrivals of even, odd steps
  C* buf = reinterpret_cast<C*>(smem + rmt::kBarrierBytes);  // T: even steps, then odd
  S* staged = reinterpret_cast<S*>(buf + 2 * cap);            // Cm, when staged
  if (!REG && stage)
    rmt::load_bands<false>(staged, Cm + base, cells, static_cast<S*>(nullptr),
                           static_cast<const S*>(nullptr), 0);
  const S* cm_src = stage ? staged : Cm + base;
  // The first buffer takes the band and its halo rows from T (0 beyond the
  // block); the second's halo rows start at 0 and stay 0 at the block's
  // edges.
  const int lo_row = band.start > 0 ? 1 : 0;
  const int hi_row = band.start + band.rows < n0 ? 1 : 0;
  rmt::zero_rows(buf + cap, plane);
  rmt::zero_rows(buf + cap + (band.rows + 1) * plane, plane);
  if (!lo_row) rmt::zero_rows(buf, plane);
  if (!hi_row) rmt::zero_rows(buf + (band.rows + 1) * plane, plane);
  rmt::load_bands<true>(buf + (1 - lo_row) * plane, T + base - lo_row * plane,
                        (band.rows + lo_row + hi_row) * plane, static_cast<C*>(nullptr),
                        static_cast<const S*>(nullptr), 0);
  const int warps = static_cast<int>(blockDim.x >> 5);
  const rmt::Walk walk(band.rows, n_mid, n_last, warps);
  const rmt::Walk::Slice slice = walk.slice(static_cast<int>(threadIdx.x >> 5));
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int count = slice.stop - slice.it;  // cells of this lane a step (some past n_last)
  // REG: this warp's run (reg_seg_rows), rows [ra, ra + nrun) of column
  // (r_mi, r_c); each of its cells' coefficient in kreg.
  int nrun = 0, ra = 0, r_mi = 0, r_c = 0;
  C kreg[kRegCells];
  if constexpr (REG) {
    const int cols = n_mid * walk.chunks;
    const int segs = warps / cols;
    const int seg_rows = reg_seg_rows(band.rows, n_mid, n_last, warps);
    const int col = static_cast<int>(threadIdx.x >> 5) / segs;
    ra = min((static_cast<int>(threadIdx.x >> 5) % segs) * seg_rows, band.rows);
    r_mi = col / walk.chunks;
    r_c = (col - r_mi * walk.chunks) * 32 + lane;
    if (col < cols && r_c < n_last) nrun = min(seg_rows, band.rows - ra);
#pragma unroll
    for (int q = 0; q < kRegCells; ++q) {
      kreg[q] = C(0);
      if (q < nrun)
        kreg[q] = coef_of<C, FORM>(widen(Cm[base + (ra + q) * plane + r_mi * n_last + r_c]), inv0);
    }
  }
  // The neighbours' halo rows this CTA's edge rows go to (the band below's
  // top halo row, the band above's bottom one, at the same buffer offsets)
  // and their mbarriers, as shared::cluster addresses; 0 where there is none.
  const uint32_t here = rmt::smem_u32(buf);
  const uint32_t lo_dst = rank > 0 ? rmt::map_rank(
      here + (rmt::band_of(n0, nc, rank - 1).rows + 1) * plane * sizeof(C), rank - 1) : 0;
  const uint32_t lo_bar = rank > 0 ? rmt::map_rank(rmt::smem_u32(bar), rank - 1) : 0;
  const uint32_t hi_dst = rank + 1 < nc ? rmt::map_rank(here, rank + 1) : 0;
  const uint32_t hi_bar = rank + 1 < nc ? rmt::map_rank(rmt::smem_u32(bar), rank + 1) : 0;
  const uint32_t expect = ((rank > 0) + (rank + 1 < nc)) * plane * sizeof(C);
  if (threadIdx.x == 0) {
    rmt::mbar_init(bar);
    rmt::mbar_init(bar + 1);
    if (nc > 1 && n_steps > 1) rmt::mbar_expect(bar, expect);      // the halo step 0 writes
    if (nc > 1 && n_steps > 2) rmt::mbar_expect(bar + 1, expect);  // and step 1
  }
  cluster.sync();

  // One step; LAST writes `out` instead.
  auto step_body = [&](int step, auto last_tag) {
    constexpr bool LAST = decltype(last_tag)::value;
    const int off = (step & 1) ? cap : 0;
    const C* __restrict__ cur = buf + off + plane;    // T of this step at its row 0
    C* __restrict__ nxt = buf + (cap - off) + plane;  // T of the next step
    const uint32_t push_at = static_cast<uint32_t>((cap - off) * sizeof(C));
    const uint32_t bar_at = static_cast<uint32_t>((step & 1) * sizeof(uint64_t));
    if constexpr (REG) {
      // The warp's run: the cells below and at each row carried down it,
      // the lane's neighbours along axes 1 and 2 fixed for the run.
      if (nrun > 0) {
        const int inplane = r_mi * n_last + r_c;
        const int j0 = ra * plane + inplane;
        const bool has_l = r_c > 0, has_r = r_c + 1 < n_last;
        const bool has_mlo = r_mi > 0, has_mhi = r_mi + 1 < n_mid;
        const bool push_lo = ra == 0 && lo_dst;
        const bool push_hi = ra + nrun == band.rows && hi_dst;
        const uint32_t at = push_at + static_cast<uint32_t>(inplane * sizeof(C));
        C lo = cur[j0 - plane];
        C t = cur[j0];
#pragma unroll
        for (int q = 0; q < kRegCells; ++q) {
          if (q < nrun) {
            const int j = j0 + q * plane;
            const C hi = cur[j + plane];
            const C right = has_r ? cur[j + 1] : C(0);
            const C left = has_l ? cur[j - 1] : C(0);
            C p1;
            C p2 = C(0);
            if constexpr (NDIM == 2) {
              p1 = right + left;
            } else {
              p1 = (has_mhi ? cur[j + n_last] : C(0)) + (has_mlo ? cur[j - n_last] : C(0));
              p2 = right + left;
            }
            const C v = update<C, NDIM, FORM>(t, kreg[q], hi + lo, p1, p2, inv0, inv1, inv2);
            if constexpr (LAST) {
              out[base + j] = narrow<S>(v);
            } else {
              nxt[j] = v;
              if (q == 0 && push_lo) rmt::push(lo_dst + at, v, lo_bar + bar_at);
              if (q + 1 == nrun && push_hi) rmt::push(hi_dst + at, v, hi_bar + bar_at);
            }
            lo = t;
            t = hi;
          }
        }
      }
      return;
    }
    int r = slice.r0, mi = slice.mi, ch = slice.ch;
    C lo = C(0), t = C(0);  // the walk carries the cells below and at its row
    for (int q0 = 0; q0 < count; q0 += kRegCells) {
#pragma unroll
      for (int q = 0; q < kRegCells; ++q) {
        if (q0 + q < count) {
          const int c = ch * 32 + lane;
          if (c < n_last) {
            const int inplane = mi * n_last + c;
            const int j = r * plane + inplane;
            if (q0 + q == 0 || r == 0) {  // a run's first row
              lo = cur[j - plane];
              t = cur[j];
            }
            const C hi = cur[j + plane];
            const C right = c + 1 < n_last ? cur[j + 1] : C(0);
            const C left = c > 0 ? cur[j - 1] : C(0);
            C p1;
            C p2 = C(0);
            if constexpr (NDIM == 2) {
              p1 = right + left;
            } else {
              p1 = (mi + 1 < n_mid ? cur[j + n_last] : C(0)) + (mi > 0 ? cur[j - n_last] : C(0));
              p2 = right + left;
            }
            const C v = update<C, NDIM, FORM>(t, coef_of<C, FORM>(widen(cm_src[j]), inv0),
                                              hi + lo, p1, p2, inv0, inv1, inv2);
            if constexpr (LAST) {
              out[base + j] = narrow<S>(v);
            } else {
              nxt[j] = v;
              const uint32_t at = push_at + static_cast<uint32_t>(inplane * sizeof(C));
              if (r == 0 && lo_dst) rmt::push(lo_dst + at, v, lo_bar + bar_at);
              if (r + 1 == band.rows && hi_dst) rmt::push(hi_dst + at, v, hi_bar + bar_at);
            }
            lo = t;
            t = hi;
          }
          walk.next_cell(&r, &mi, &ch);
        }
      }
    }
  };
  for (int step = 0; step < n_steps; ++step) {
    if (step > 0) {
      // The halo the last step wrote; then its mbarrier takes the next
      // step's, before any push of this step lets a neighbour run ahead
      // (expect > 0: a phase cannot complete before the neighbours push).
      if (nc > 1) {
        rmt::mbar_wait(bar + ((step - 1) & 1), ((step - 1) >> 1) & 1);
        if (threadIdx.x == 0 && step + 1 < n_steps - 1)
          rmt::mbar_expect(bar + ((step - 1) & 1), expect);
      }
      __syncthreads();
    }
    if (step + 1 < n_steps) {
      step_body(step, std::false_type{});
    } else {
      step_body(step, std::true_type{});
    }
  }
  cluster.sync();  // no CTA leaves while a store it made to a neighbour may be in flight
}

// Bytes of shared memory a CTA of the cluster route: the mbarriers, two
// compute-type buffers of `rows` + 2 rows of `plane` cells, and Cm when
// staged.
template <typename S>
size_t resident_bytes(int64_t rows, int64_t plane, int stage) {
  using C = typename Compute<S>::type;
  const size_t cells = static_cast<size_t>(rows * plane);
  return rmt::kBarrierBytes + 2 * (cells + 2 * plane) * sizeof(C) +
         (stage ? cells * sizeof(S) : 0);
}

// One cache a (dtype, rank, form, REG): the cluster kernel's caps and (in
// the REG one) the cooperative kernel's co-resident blocks, per device.
template <typename S, int NDIM, int FORM, bool REG>
rmt::CapsCache& caps_cache() {
  static rmt::CapsCache cache;
  return cache;
}

// The caps of the REG instantiation stand for both: the two differ in no
// resource the grant depends on (threads, dynamic shared memory).
template <typename S, int NDIM, int FORM>
int caps_of(int dev, int* out) {
  rmt::ClusterCaps caps;
  const cudaError_t err = rmt::cluster_caps(rmt_multi_step_cm_resident_kernel<S, NDIM, FORM, true>, dev,
                                            &caps_cache<S, NDIM, FORM, true>(), &caps);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = caps.cluster;
  out[1] = caps.smem_limit;
  return 0;
}

template <typename S, int NDIM, int FORM, bool REG>
int launch_resident(const S* t, const S* cm, S* o, int n_steps, int64_t n0, int64_t n1,
                    int64_t n2, typename Compute<S>::type c0, typename Compute<S>::type c1,
                    typename Compute<S>::type c2, int cluster, int stage, int dev,
                    cudaStream_t stream) {
  auto kernel = rmt_multi_step_cm_resident_kernel<S, NDIM, FORM, REG>;
  rmt::ClusterCaps caps;
  cudaError_t err = rmt::cluster_caps(kernel, dev, &caps_cache<S, NDIM, FORM, REG>(), &caps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = n1 * n2;
  const int64_t rows = (n0 + cluster - 1) / cluster;
  const size_t bytes = resident_bytes<S>(rows, plane, stage);
  if (!rmt::plan_fits(caps, cluster, n0, bytes) || plane > (int64_t{1} << 30)) return -1;
  const int64_t n_mid = NDIM == 2 ? 1 : n1;
  const int64_t n_last = NDIM == 2 ? n1 : n2;
  if (REG) {
    const int seg = reg_seg_rows(static_cast<int>(rows), static_cast<int>(n_mid),
                                 static_cast<int>(n_last), rmt::kResidentThreads / 32);
    if (seg < 1 || seg > kRegCells) return -1;
  }
  err = rmt::launch_cluster(kernel, cluster, bytes, stream, t, cm, o, n_steps,
                            static_cast<int>(n0), static_cast<int>(n_mid),
                            static_cast<int>(n_last), stage, c0, c1, c2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NDIM, int FORM>
int launch_multi(const void* T, const void* Cm, void* out, void* scratch, int n_steps,
                 int64_t n0, int64_t n1, int64_t n2, double inv0, double inv1, double inv2,
                 int cluster, int cm_at, int dev, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  const S* t = static_cast<const S*>(T);
  const S* cm = static_cast<const S*>(Cm);
  S* o = static_cast<S*>(out);
  C c0 = C(inv0), c1 = C(inv1), c2 = C(inv2);
  if (cluster > 0 && cm_at == kCmRegisters)
    return launch_resident<S, NDIM, FORM, true>(t, cm, o, n_steps, n0, n1, n2, c0, c1, c2,
                                                cluster, 0, dev, stream);
  if (cluster > 0)
    return launch_resident<S, NDIM, FORM, false>(t, cm, o, n_steps, n0, n1, n2, c0, c1, c2,
                                                 cluster, cm_at == kCmShared, dev, stream);
  if (scratch == nullptr) return -1;
  auto kernel = rmt_multi_step_cm_kernel<S, NDIM, FORM>;
  int fit = 0;
  cudaError_t err = rmt::coop_blocks(kernel, dev, kThreads, &caps_cache<S, NDIM, FORM, true>(),
                                     &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1) return -3;
  const int64_t cells = n0 * n1 * n2;
  const int64_t want = (cells + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < fit ? want : fit);
  C* b0 = static_cast<C*>(scratch);
  C* b1 = b0 + cells;
  void* args[] = {&t, &cm, &o, &b0, &b1, &n_steps, &n0, &n1, &n2, &c0, &c1, &c2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of (ndim, form): F<NDIM, FORM>(args...), -1 for a form
// out of range.
#define RMT_MULTI_DISPATCH(F, ndim, form, ...)                                  \
  switch ((ndim) * 4 + (form)) {                                                \
    case 2 * 4 + kDirect: return F<S, 2, kDirect>(__VA_ARGS__);                 \
    case 2 * 4 + kAC: return F<S, 2, kAC>(__VA_ARGS__);                         \
    case 2 * 4 + kEQC: return F<S, 2, kEQC>(__VA_ARGS__);                       \
    case 2 * 4 + kCOnly: return F<S, 2, kCOnly>(__VA_ARGS__);                   \
    case 3 * 4 + kDirect: return F<S, 3, kDirect>(__VA_ARGS__);                 \
    case 3 * 4 + kAC: return F<S, 3, kAC>(__VA_ARGS__);                         \
    case 3 * 4 + kEQC: return F<S, 3, kEQC>(__VA_ARGS__);                       \
    case 3 * 4 + kCOnly: return F<S, 3, kCOnly>(__VA_ARGS__);                   \
    default: return -1;                                                         \
  }

template <typename S>
int dispatch_multi(int ndim, int form, const void* T, const void* Cm, void* out,
                   void* scratch, int n_steps, int64_t n0, int64_t n1, int64_t n2,
                   double inv0, double inv1, double inv2, int cluster, int cm_at, int dev,
                   cudaStream_t s) {
  if (form < 0 || form > kCOnly) return -1;
  if (ndim == 2) {
    n2 = 1;
    inv2 = 0.0;
  }
  RMT_MULTI_DISPATCH(launch_multi, ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0,
                     inv1, inv2, cluster, cm_at, dev, s)
}

template <typename S>
int dispatch_caps(int ndim, int form, int dev, int* out) {
  if (form < 0 || form > kCOnly) return -1;
  RMT_MULTI_DISPATCH(caps_of, ndim, form, dev, out)
}

// ---------------------------------------------------------------------------
// rmt_tb_sweep, 2D: column strips streamed along axis 0
// ---------------------------------------------------------------------------

// Four compute-type values: one lane's columns of a row.
template <typename C>
struct alignas(16) Quad {
  C v[kTbLaneCols];
};

// Shared bytes of a 2D block: each lane's ring of k + 1 Cm rows in the
// compute type.
template <typename C>
constexpr int64_t tb2_smem_bytes(int k) {
  return static_cast<int64_t>(kTbWarpsPerBlock) * 32 * (k + 1) * kTbLaneCols *
         static_cast<int64_t>(sizeof(C));
}

// Row `g` of this lane's four columns c0 .. c0 + 3 of T and Cm, widened;
// 0 outside the block. `in` holds a bit per column inside [0, n1). (Four
// scalar loads a lane, which the L1 merges across the warp, measured
// faster on an H100 than one vector load: fewer registers.)
template <typename S, typename C>
__device__ __forceinline__ void tb2_load(const S* __restrict__ T, const S* __restrict__ Cm,
                                         int64_t g, int64_t n0, int64_t n1, int64_t c0,
                                         unsigned in, Quad<C>* t, Quad<C>* cm) {
  const bool row_in = g >= 0 && g < n0;
  const int64_t at = g * n1 + c0;
#pragma unroll
  for (int e = 0; e < kTbLaneCols; ++e) {
    const bool here = row_in && ((in >> e) & 1u);
    t->v[e] = here ? widen(T[at + e]) : C(0);
    cm->v[e] = here ? widen(Cm[at + e]) : C(0);
  }
}

// One row step of a warp's strip, with P = (iteration index) mod 3 fixed at
// compile time so the rotating row slots of every level are registers.
// Level s (1..K) advances row g - s from level s - 1's rows g - s - 1,
// g - s and g - s + 1; level L keeps row ρ in slot (ρ - g_begin) mod 3.
template <typename S, int K, int P>
__device__ __forceinline__ void tb2_row(
    typename Compute<S>::type (&v)[K][3][kTbLaneCols],
    const Quad<typename Compute<S>::type>& t_row, Quad<typename Compute<S>::type>* ring,
    int i, int64_t g, int64_t r0, int64_t r1, int64_t n1, int64_t c0, unsigned core,
    S* __restrict__ out, typename Compute<S>::type inv0,
    typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  const C zero = C(0);
#pragma unroll
  for (int e = 0; e < kTbLaneCols; ++e) v[0][P][e] = t_row.v[e];
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    constexpr int kSlots = 3;
    const int sd = ((P - s + 1) % kSlots + kSlots) % kSlots;  // row g - s + 1
    const int sc = ((P - s) % kSlots + kSlots) % kSlots;      // row g - s
    const int su = ((P - s - 1) % kSlots + kSlots) % kSlots;  // row g - s - 1
    const C(&up)[kTbLaneCols] = v[s - 1][su];
    const C(&cen)[kTbLaneCols] = v[s - 1][sc];
    const C(&down)[kTbLaneCols] = v[s - 1][sd];
    // Cm of row g - s: ring slot (i - s) mod (K + 1); slots not yet
    // written hold the zeros of rows above the first loaded one.
    const Quad<C> cm = ring[(((i - s) % (K + 1)) + (K + 1)) % (K + 1) * 32];
    // The neighbours beyond the strip's two outer columns are unknown; the
    // shuffle hands lanes 0 and 31 a finite value of their own instead.
    // Like any halo error it moves one column a level and never reaches
    // the core, and a column beyond the block's edge still stays exactly
    // 0 (its Cm is 0), so no lane needs a select.
    const C edge_l = __shfl_up_sync(0xffffffffu, cen[kTbLaneCols - 1], 1);
    const C edge_r = __shfl_down_sync(0xffffffffu, cen[0], 1);
    C nv[kTbLaneCols];
#pragma unroll
    for (int e = 0; e < kTbLaneCols; ++e) {
      const C left = e > 0 ? cen[e - 1] : edge_l;
      const C right = e + 1 < kTbLaneCols ? cen[e + 1] : edge_r;
      nv[e] = update<C, 2, kDirect>(cen[e], cm.v[e], down[e] + up[e], right + left, zero,
                                    inv0, inv1, zero);
    }
    if (s < K) {
#pragma unroll
      for (int e = 0; e < kTbLaneCols; ++e) v[s][sc][e] = nv[e];
    } else {
      const int64_t row = g - K;
      if (row >= r0 && row < r1) {
#pragma unroll
        for (int e = 0; e < kTbLaneCols; ++e)
          if ((core >> e) & 1u) out[row * n1 + c0 + e] = narrow<S>(nv[e]);
      }
    }
  }
}

// A warp owns a strip of 128 loaded columns (4 a lane) — a core of
// 128 - 2K plus K halo columns a side — over a segment of `seg_rows` core
// rows plus K halo rows a side. It walks the rows once, top to bottom:
// each row step loads one row (the next is prefetched into registers while
// this one is computed) and advances every time level by one row, level s
// lagging level s - 1 by a row, so level K emits one finished core row a
// step. Warps are independent: neighbours across lanes come by shuffle,
// nothing is synchronised, and shared memory holds only each lane's ring
// of Cm rows.
template <typename S, int K>
__global__ void __launch_bounds__(kTbWarpsPerBlock * 32)
rmt_tb_sweep_2d_kernel(const S* __restrict__ T, const S* __restrict__ Cm, S* __restrict__ out,
           int64_t n0, int64_t n1, int64_t strips, int64_t tiles, int64_t seg_rows,
           typename Compute<S>::type inv0, typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  constexpr int kCore = kTbStripCols - 2 * K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTbWarpsPerBlock + warp;
  if (tile >= tiles) return;  // the whole warp: nothing below synchronises the block
  const int64_t strip = tile % strips;
  const int64_t r0 = (tile / strips) * seg_rows;
  const int64_t r1 = r0 + seg_rows < n0 ? r0 + seg_rows : n0;
  const int64_t c0 = strip * kCore - K + lane * kTbLaneCols;
  // Bits per column: inside the block, and in the strip's core.
  unsigned in = 0, core = 0;
#pragma unroll
  for (int e = 0; e < kTbLaneCols; ++e) {
    const int lc = lane * kTbLaneCols + e;
    if (c0 + e >= 0 && c0 + e < n1) in |= 1u << e;
    if (lc >= K && lc < K + kCore && c0 + e < n1) core |= 1u << e;
  }
  // This lane's ring: slot q at ring[q * 32] (a warp's slot is 32
  // consecutive Quads, so its loads are conflict-free).
  Quad<C>* ring = reinterpret_cast<Quad<C>*>(smem_raw) + warp * 32 * (K + 1) + lane;
#pragma unroll
  for (int q = 0; q <= K; ++q) {
#pragma unroll
    for (int e = 0; e < kTbLaneCols; ++e) ring[q * 32].v[e] = C(0);
  }
  C v[K][3][kTbLaneCols];
#pragma unroll
  for (int l = 0; l < K; ++l)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < kTbLaneCols; ++e) v[l][q][e] = C(0);
  // Rows above the block are 0 in truth as in the zeroed state, so the
  // first segment starts at row 0; every segment ends K rows past its core,
  // where level K finishes the core's last row.
  const int64_t g_begin = r0 - K > 0 ? r0 - K : 0;
  const int64_t g_end = r1 + K;
  Quad<C> t_next, cm_next;
  tb2_load<S, C>(T, Cm, g_begin, n0, n1, c0, in, &t_next, &cm_next);
  int i = 0;
  for (int64_t g = g_begin; g < g_end; g += 3, i += 3) {
#define RMT_TB2_STEP(P)                                                           \
    {                                                                             \
      const int64_t gp = g + P;                                                   \
      if (gp >= g_end) break;                                                     \
      const Quad<C> t_row = t_next;                                               \
      ring[((i + P) % (K + 1)) * 32] = cm_next;                                   \
      if (gp + 1 < g_end) tb2_load<S, C>(T, Cm, gp + 1, n0, n1, c0, in, &t_next, &cm_next); \
      tb2_row<S, K, P>(v, t_row, ring, i + P, gp, r0, r1, n1, c0, core, out, inv0, inv1); \
    }
    RMT_TB2_STEP(0)
    RMT_TB2_STEP(1)
    RMT_TB2_STEP(2)
#undef RMT_TB2_STEP
  }
}

// Per device, once for each 2D kernel: its shared bytes against the
// device's opt-in limit a block (-3 if they exceed it), and the function
// attribute that allows them (only needed above the 48 KB default).
// Returns 0, -1 for a device index out of range, -3, or a CUDA error.
using rmt::kMaxDevices;

template <typename S, int K>
int tb2_prepare(int dev) {
  using C = typename Compute<S>::type;
  static bool ready[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (ready[dev]) return 0;
  const int64_t smem = tb2_smem_bytes<C>(K);
  int optin = 0;
  const cudaError_t got =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (smem > optin) return -3;
  if (smem > 48 * 1024) {
    auto kernel = rmt_tb_sweep_2d_kernel<S, K>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ready[dev] = true;
  return 0;
}

template <typename S, int K>
int launch_tb2(const void* T, const void* Cm, void* out, int64_t n0, int64_t n1,
               int64_t seg_rows, double inv0, double inv1, int dev, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kCore = kTbStripCols - 2 * K;
  if (seg_rows < 1 || n0 < 1 || n1 < 1) return -1;
  const int rc = tb2_prepare<S, K>(dev);
  if (rc != 0) return rc;
  const int64_t strips = (n1 + kCore - 1) / kCore;
  const int64_t tiles = strips * ((n0 + seg_rows - 1) / seg_rows);
  const int64_t blocks = (tiles + kTbWarpsPerBlock - 1) / kTbWarpsPerBlock;
  if (blocks > 2147483647LL) return -2;
  rmt_tb_sweep_2d_kernel<S, K><<<static_cast<unsigned>(blocks), kTbWarpsPerBlock * 32,
                     static_cast<size_t>(tb2_smem_bytes<C>(K)), stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cm), static_cast<S*>(out), n0, n1,
      strips, tiles, seg_rows, C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int K>
int tb2_warps_per_sm(int dev) {
  using C = typename Compute<S>::type;
  const int rc = tb2_prepare<S, K>(dev);
  if (rc != 0) return rc < 0 ? rc : -rc;  // every failure below 1
  int blocks = 0;
  auto kernel = rmt_tb_sweep_2d_kernel<S, K>;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kTbWarpsPerBlock * 32,
      static_cast<size_t>(tb2_smem_bytes<C>(K)));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * kTbWarpsPerBlock;
}

// The 2D kernel's depth K is a template argument (its level state is
// registers): one instantiation per K in 1..16.
#define RMT_TB2_K_CASES(F)                                                              \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15) F(16)

template <typename S>
int tb2_dispatch(int k, const void* T, const void* Cm, void* out, int64_t n0, int64_t n1,
                 int64_t seg_rows, double inv0, double inv1, int dev, cudaStream_t s) {
  switch (k) {
#define RMT_CASE(K) \
    case K: return launch_tb2<S, K>(T, Cm, out, n0, n1, seg_rows, inv0, inv1, dev, s);
    RMT_TB2_K_CASES(RMT_CASE)
#undef RMT_CASE
    default: return -1;
  }
}

template <typename S>
int tb2_occupancy(int k, int dev) {
  switch (k) {
#define RMT_CASE(K) case K: return tb2_warps_per_sm<S, K>(dev);
    RMT_TB2_K_CASES(RMT_CASE)
#undef RMT_CASE
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// rmt_tb_sweep, 3D: light-cone tiles in shared memory
// ---------------------------------------------------------------------------

// Tile coordinates (j0, j1, j2) of tile cell j over extents (e0, e1, e2).
__device__ __forceinline__ void tile_coords(int j, int e1, int e2, int* j0,
                                            int* j1, int* j2) {
  *j0 = j / (e1 * e2);
  const int r = j - *j0 * (e1 * e2);
  *j1 = r / e2;
  *j2 = r - *j1 * e2;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
rmt_tb_sweep_3d_kernel(const S* __restrict__ T, const S* __restrict__ Cm, S* __restrict__ out, int k,
           int64_t n0, int64_t n1, int64_t n2, int t0, int t1, int t2,
           typename Compute<S>::type inv0, typename Compute<S>::type inv1,
           typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Tile = core (t0, t1, t2) plus k halo cells per side on each axis.
  const int e0 = t0 + 2 * k;
  const int e1 = t1 + 2 * k;
  const int e2 = t2 + 2 * k;
  const int tile = e0 * e1 * e2;
  C* a = reinterpret_cast<C*>(smem_raw);
  C* b = a + tile;
  C* cm = b + tile;
  // Block coordinates of tile cell (0, 0, 0).
  const int64_t o0 = static_cast<int64_t>(blockIdx.z) * t0 - k;
  const int64_t o1 = static_cast<int64_t>(blockIdx.y) * t1 - k;
  const int64_t o2 = static_cast<int64_t>(blockIdx.x) * t2 - k;
  const int64_t s1 = n2;
  const int64_t s0 = n1 * n2;
  const C zero = C(0);
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    int j0, j1, j2;
    tile_coords(j, e1, e2, &j0, &j1, &j2);
    const int64_t g0 = o0 + j0, g1 = o1 + j1, g2 = o2 + j2;
    const bool inside = g0 >= 0 && g0 < n0 && g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
    const int64_t g = g0 * s0 + g1 * s1 + g2;
    a[j] = inside ? widen(T[g]) : zero;
    cm[j] = inside ? widen(Cm[g]) : zero;
  }
  __syncthreads();

  const int st0 = e1 * e2;  // tile strides
  const int st1 = e2;
  for (int step = 0; step < k; ++step) {
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      int j0, j1, j2;
      tile_coords(j, e1, e2, &j0, &j1, &j2);
      const C p0 = (j0 + 1 < e0 ? a[j + st0] : zero) + (j0 > 0 ? a[j - st0] : zero);
      const C p1 = (j1 + 1 < e1 ? a[j + st1] : zero) + (j1 > 0 ? a[j - st1] : zero);
      const C p2 = (j2 + 1 < e2 ? a[j + 1] : zero) + (j2 > 0 ? a[j - 1] : zero);
      b[j] = update<C, 3, kDirect>(a[j], cm[j], p0, p1, p2, inv0, inv1, inv2);
    }
    __syncthreads();
    C* swap = a;
    a = b;
    b = swap;
  }

  const int core = t0 * t1 * t2;
  for (int j = threadIdx.x; j < core; j += blockDim.x) {
    int j0, j1, j2;
    tile_coords(j, t1, t2, &j0, &j1, &j2);
    const int64_t g0 = o0 + k + j0, g1 = o1 + k + j1, g2 = o2 + k + j2;
    if (g0 < n0 && g1 < n1 && g2 < n2) {
      const int tj = (j0 + k) * st0 + (j1 + k) * st1 + j2 + k;
      out[g0 * s0 + g1 * s1 + g2] = narrow<S>(a[tj]);
    }
  }
}

// Shared bytes of a 3D tile: two T buffers and Cm, each (core + 2k)
// cells per axis of the compute type.
template <typename C>
int64_t tile_bytes(int k, const int* t) {
  int64_t cells = 1;
  for (int ax = 0; ax < 3; ++ax) cells *= t[ax] + 2 * k;
  return 3 * cells * static_cast<int64_t>(sizeof(C));
}

template <typename S>
int launch_tb3(int k, const void* T, const void* Cm, void* out, int64_t n0, int64_t n1,
               int64_t n2, double inv0, double inv1, double inv2, int dev,
               cudaStream_t stream) {
  using C = typename Compute<S>::type;
  // Per device, read once: the block's shared-memory limit, and the
  // largest dynamic size set on the kernel so far.
  static int optin[kMaxDevices] = {};
  static int64_t allowed[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (optin[dev] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The halo is most of a 3D tile, so take the largest tile shared memory
  // holds (one block per SM): start at 16³ of core and halve the largest
  // axis until it fits.
  int t[3] = {16, 16, 16};
  while (tile_bytes<C>(k, t) > optin[dev]) {
    int big = 0;
    for (int ax = 1; ax < 3; ++ax)
      if (t[ax] > t[big]) big = ax;
    if (t[big] == 1) break;
    t[big] /= 2;
  }
  const int64_t smem = tile_bytes<C>(k, t);
  if (smem > optin[dev]) return -3;  // the light cone does not fit shared memory
  if (smem > allowed[dev]) {
    auto kernel = rmt_tb_sweep_3d_kernel<S>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = smem;
  }
  const int64_t gx = (n2 + t[2] - 1) / t[2];
  const int64_t gy = (n1 + t[1] - 1) / t[1];
  const int64_t gz = (n0 + t[0] - 1) / t[0];
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  rmt_tb_sweep_3d_kernel<S><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cm), static_cast<S*>(out), k, n0, n1,
      n2, t[0], t[1], t[2], C(inv0), C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int tb_ndim(int ndim, int k, const void* T, const void* Cm, void* out, int64_t n0,
            int64_t n1, int64_t n2, int64_t seg_rows, double inv0, double inv1,
            double inv2, int dev, cudaStream_t s) {
  if (ndim == 2)
    return tb2_dispatch<S>(k, T, Cm, out, n0, n1, seg_rows, inv0, inv1, dev, s);
  return launch_tb3<S>(k, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, dev, s);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the block's extents, n2 = 1 in 2D; `stream` is a cudaStream_t.
// Return codes: 0 on success, >0 a CUDA error (the launch's, or
// cudaGetLastError() after it), -1 an unsupported dtype, rank, form, step
// count or plan, -2 a grid that overflows a launch dimension, -3 a launch
// that cannot fit (no co-resident block; a light cone larger than shared
// memory). Launches are asynchronous on `stream`; nothing here allocates.

// `form`: 0 direct, 1 A/c, 2 eqc, 3 conly. The route is the caller's plan
// (ops/resident.py), made before the launch: `cluster` > 0 launches one
// cluster of that many CTAs (at most the size rmt_multi_step_cm_caps
// grants, and at most n0), reading Cm where `cm_at` says (0 device memory,
// 1 staged into shared memory, 2 registers, which needs at most kRegCells
// cells a lane); a plan whose bytes a CTA exceed the card's limit, or that
// keeps more cells a lane in registers, returns -1, and `scratch` is not
// read. `cluster` == 0 takes the cooperative route, whose `scratch` holds
// 2·n0·n1·n2 elements of the compute type (f32 for bf16). `dev` is the
// current device's index. `out` must not alias `T`.
extern "C" int rmt_multi_step_cm(int dtype, int ndim, int form, int n_steps,
                                 const void* T, const void* Cm, void* out,
                                 void* scratch, int64_t n0, int64_t n1,
                                 int64_t n2, double inv0, double inv1,
                                 double inv2, int cluster, int cm_at, int dev,
                                 void* stream) {
  if ((ndim != 2 && ndim != 3) || n_steps < 1 || cluster < 0 || cm_at < kCmDevice ||
      cm_at > kCmRegisters)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_multi<float>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0,
                                   inv1, inv2, cluster, cm_at, dev, s);
    case kF64:
      return dispatch_multi<double>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0,
                                    inv1, inv2, cluster, cm_at, dev, s);
    case kBF16:
      return dispatch_multi<__nv_bfloat16>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1,
                                           n2, inv0, inv1, inv2, cluster, cm_at, dev, s);
    default:
      return -1;
  }
}

// What device `dev` (the current one) grants the cluster route of one
// (dtype, ndim, form): out[0] the largest cluster size (16, 8, or 0 for
// none), out[1] the dynamic shared memory a CTA may use. Asked once per
// device; the launches reuse the answer.
extern "C" int rmt_multi_step_cm_caps(int dtype, int ndim, int form, int dev, int* out) {
  if (ndim != 2 && ndim != 3) return -1;
  switch (dtype) {
    case kF32: return dispatch_caps<float>(ndim, form, dev, out);
    case kF64: return dispatch_caps<double>(ndim, form, dev, out);
    case kBF16: return dispatch_caps<__nv_bfloat16>(ndim, form, dev, out);
    default: return -1;
  }
}

// `k` direct-form steps, 1 <= k <= 16. `out` must not alias `T`. 2D takes
// `seg_rows` core rows a segment from the plan of ops/multistep.tb_plan;
// 3D ignores it. `dev` is the current device's index.
extern "C" int rmt_tb_sweep(int dtype, int ndim, int k, const void* T,
                            const void* Cm, void* out, int64_t n0, int64_t n1,
                            int64_t n2, int64_t seg_rows, double inv0, double inv1,
                            double inv2, int dev, void* stream) {
  if ((ndim != 2 && ndim != 3) || k < 1 || k > 16) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return tb_ndim<float>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, inv0, inv1, inv2, dev, s);
    case kF64:
      return tb_ndim<double>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, inv0, inv1, inv2, dev, s);
    case kBF16:
      return tb_ndim<__nv_bfloat16>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, inv0, inv1, inv2, dev, s);
    default:
      return -1;
  }
}

// Warps of the 2D tb_sweep kernel of (dtype, k) that one SM of device
// `dev` holds at once (> 0), or a failure below 1 (-1, -3 as above, or
// minus a CUDA error); the plan sizes its segments by it.
extern "C" int rmt_tb_warps_per_sm(int dtype, int k, int dev) {
  switch (dtype) {
    case kF32: return tb2_occupancy<float>(k, dev);
    case kF64: return tb2_occupancy<double>(k, dev);
    case kBF16: return tb2_occupancy<__nv_bfloat16>(k, dev);
    default: return -1;
  }
}
