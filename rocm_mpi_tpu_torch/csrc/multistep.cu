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
// 3D lifts the same wavefront one dimension (a 2.5D stream along axis 0).
// A block owns a tile of the (axis 1, axis 2) cross-section — its core plus
// k halo cells a side on both axes — over a segment of planes, and walks it
// once: each plane step loads one plane of T and Cm (the next one's loads
// in flight), and level s computes one plane over its cone, the inner
// (e - 2s)² of the tile, one plane behind level s - 1. A thread owns the
// same cells at every level, so the axis-0 neighbour just computed is a
// register; the other neighbours come from each level's ring of three
// planes in shared memory, sized to its cone, with one barrier a plane
// step (design notes at rmt_tb_sweep_3d_kernel). Tile, segment, threads
// and where Cm is kept come from the Python plan (ops/multistep.tb3_plan),
// which fills the card in whole waves and keeps the rings within shared
// memory for every k in 1..16 and every dtype. The light-cone tiles this
// replaced recomputed the whole tile every step (about 18 cells for each
// core cell at k = 8) and took k <= 12 only. HeatDiffusion.run_hbm_blocked
// runs it at the 3D app's 128³ (a 32-plane slab of 2.1 MB is within the
// JAX package's slab budget), and run_deep's hbm-tb route on blocks whose
// slab fits.
//
// Measured on an H100 (scripts/torch_kernel_ab.py and per-call CUDA
// events, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6 row 4): at 128³
// k = 8 f32 a sweep takes 0.2205 ms against the old tiles' 1.9393, at
// 144³ 0.2400 against 2.8282. It computes 2.3-2.6 cell updates for each
// core update and is bound by neither bytes nor flops but by the
// instructions around each update: with the update's arithmetic and four
// in-plane reads left out (timing-only variants of an earlier form, 0.2312
// ms) a 128³ sweep still took 0.1685 ms; without the loads of T and Cm
// 0.2075, without the barrier 0.2245, without reading Cm 0.2254 (that
// form's f32 k = 8 kernel is 2232 SASS instructions, 385 IMAD and 218
// IADD3 against 336 FADD/FMUL).
// Plans tried with earlier forms at 128³ and 144³ k = 8 (tile e1 × e2,
// threads, planes a segment): 32×32 with 256 / 512 / 1024 threads, 24×32,
// 40×32, 32×64, 36×64, 40×64, 48×48, 48×64, 64×64, segments of 8 to 72
// planes, Cm through the shared ring or from device memory (the ring 2-6 %
// faster at a given plan): the best within 10 % of each other, the best
// 32×64, 1024 threads, 24 planes; the plan's pick read 9 % above the best
// in f32, the best in f64, 21 % above it in bf16. Earlier forms (a level's
// slot and cone reckoned per cell, k a runtime value: 0.2627 ms at best;
// levels outer without k unrolled: 0.43) were slower.

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
// rmt_tb_sweep, 3D: cross-section tiles streamed along axis 0
// ---------------------------------------------------------------------------

// Cells of the tile's cross-section a thread owns (the plan keeps e1 ·
// tb3_pitch(e2) within kTb3MaxCells · threads), and the most threads a
// block. ops/multistep.py reads these two lines (tb3_limits) rather than
// restating them.
constexpr int kTb3MaxCells = 3;
constexpr int kTb3MaxThreads = 1024;
// Every ring holds three planes, a cell's three side by side: level s's
// plane g - s is written in step g while level s + 1 reads planes
// g - s - 1 (the centre) and g - s - 2 (up). Level 0's ring is the tile of T
// in the storage type.
constexpr int kTb3Slots = 3;

// A row of the tile takes whole warps: its lanes along axis 2.
__host__ __device__ inline int tb3_pitch(int e2) { return (e2 + 31) / 32 * 32; }

// Bytes of `planes` planes of the e1 × e2 tile in the storage type,
// rounded up to 16 so that what lies behind them is aligned.
template <typename S>
__host__ __device__ inline int64_t tb3_tile_bytes(int planes, int e1, int e2) {
  return (static_cast<int64_t>(planes) * e1 * e2 * static_cast<int64_t>(sizeof(S)) + 15) /
         16 * 16;
}

// Shared bytes of a 3D block (ops/multistep.tb3_smem_bytes mirrors it):
// level 0's ring (three planes of the tile of T), with `cm_ring` the ring
// of Cm (k + 1 planes of the tile, each cell's own), then the ring of each
// level L = 1 .. k - 1 over its cone (e1 - 2L) × (e2 - 2L) in the compute
// type. Level k goes straight out.
template <typename S>
__host__ __device__ inline int64_t tb3_smem_bytes(int k, int e1, int e2, bool cm_ring) {
  using C = typename Compute<S>::type;
  int64_t cone = 0;
  for (int L = 1; L < k; ++L) cone += static_cast<int64_t>(e1 - 2 * L) * (e2 - 2 * L);
  return tb3_tile_bytes<S>(kTb3Slots, e1, e2) + (cm_ring ? tb3_tile_bytes<S>(k + 1, e1, e2) : 0) +
         kTb3Slots * cone * static_cast<int64_t>(sizeof(C));
}

// A block owns a tile of the (axis 1, axis 2) cross-section — e1 × e2
// loaded cells, a core of (e1 - 2K) × (e2 - 2K) and K halo cells a side —
// over a segment of `seg` core planes plus K halo planes a side, and walks
// it once along axis 0. Plane step g stores plane g of T (loaded into
// registers in step g - 1, its loads in flight while that step computed)
// into level 0's ring and advances each level s = 1..K by one plane: level
// s computes plane g - s over its cone [s, e - s) on both axes from level
// s - 1's planes g - s - 1 (up), g - s (centre and its four in-plane
// neighbours) and g - s + 1 (down). A thread owns the same cells at every
// level, so the down value is the one it computed for level s - 1 just
// before (for level 1, its own T of plane g), in a register; up and centre
// come from level s - 1's ring in shared memory, whose plane written this
// step is one no one reads, so a plane step needs one barrier. Level K
// writes a finished core plane straight out. K is a template argument: the
// levels are unrolled, each level's slots and cone offset reckoned once a
// step for all of a thread's cells, and a cell costs one index a level (its
// place in level s's cone is its place in the tile less
// s·(2·j1 + e2 + 1) - 2s²); a ring keeps a cell's three planes side by
// side, so a level's centre, up and written plane are one address apart
// (stored plane by plane instead, a 128³ sweep measured 0.2555 ms against
// 0.2205). A thread advances all its cells a level at a time (independent
// chains in flight). Cells and
// planes outside the block stay 0, as the plain version reads them,
// without arithmetic: their ring cells are never written (the rings start
// at 0), and a level's plane outside the block is written as 0. Cm of
// plane g is loaded with T's and, with `cm_ring`, stored into a ring of
// K + 1 planes where level s reads its plane g - s, each thread its own
// cells (no barrier); where that ring does not fit shared memory (the
// plan's choice), level s reads Cm of plane g - s from device memory
// (__ldg).
template <typename S, int K>
__global__ void __launch_bounds__(kTb3MaxThreads)
rmt_tb_sweep_3d_kernel(const S* __restrict__ T, const S* __restrict__ Cm, S* __restrict__ out,
                       int64_t n0, int64_t n1, int64_t n2, int e1, int e2, int tiles2,
                       int64_t seg, bool cm_ring, typename Compute<S>::type inv0,
                       typename Compute<S>::type inv1, typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  constexpr int kQ = kTb3MaxCells;
  constexpr int kR = K + 1;  // planes of the Cm ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int plane = e1 * e2;
  S* l0 = reinterpret_cast<S*>(smem_raw);
  S* cmr = reinterpret_cast<S*>(smem_raw + tb3_tile_bytes<S>(kTb3Slots, e1, e2));
  C* lv = reinterpret_cast<C*>(reinterpret_cast<unsigned char*>(cmr) +
                               (cm_ring ? tb3_tile_bytes<S>(kR, e1, e2) : 0));
  const int pitch = tb3_pitch(e2);
  const int64_t s0 = n1 * n2;  // stride of axis 0
  // Block coordinates of tile cell (0, 0), and the segment's core planes.
  const int t1 = static_cast<int>(blockIdx.x) / tiles2;
  const int t2 = static_cast<int>(blockIdx.x) - t1 * tiles2;
  const int64_t o1 = static_cast<int64_t>(t1) * (e1 - 2 * K) - K;
  const int64_t o2 = static_cast<int64_t>(t2) * (e2 - 2 * K) - K;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * seg;
  const int64_t r1 = r0 + seg < n0 ? r0 + seg : n0;
  // This thread's cells c = threadIdx.x + q · blockDim.x (q < nq) of the
  // e1 × pitch lanes: `i0` its place in the tile (j1 · e2 + j2), `d`
  // 2·j1 + e2 + 1; `reach` the levels it computes (its cone; 0 outside the
  // block, -1 for a lane past the tile), so level K writes the cells that
  // reach K; `at` its offset in a plane of the block (-1 outside it).
  const int nq = (e1 * pitch + static_cast<int>(blockDim.x) - 1) / static_cast<int>(blockDim.x);
  int i0[kQ], d[kQ], reach[kQ], at[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int c = static_cast<int>(threadIdx.x) + q * static_cast<int>(blockDim.x);
    const int j1 = c / pitch;
    const int j2 = c - j1 * pitch;
    int r = j1 < j2 ? j1 : j2;
    r = r < e1 - 1 - j1 ? r : e1 - 1 - j1;
    r = r < e2 - 1 - j2 ? r : e2 - 1 - j2;
    const int64_t g1 = o1 + j1, g2 = o2 + j2;
    const bool inside = g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
    reach[q] = j1 >= e1 || j2 >= e2 ? -1 : inside ? (r < K ? r : K) : 0;
    at[q] = inside ? static_cast<int>(g1 * n2 + g2) : -1;
    i0[q] = j1 * e2 + j2;
    d[q] = 2 * j1 + e2 + 1;
  }
  // Every ring starts at 0: the planes before the first one loaded.
  {
    const int64_t words = tb3_smem_bytes<S>(K, e1, e2, cm_ring) / 4;
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw);
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0u;
  }
  // Planes before the block are 0 in truth as in the zeroed rings, so the
  // first segment starts at plane 0; every segment ends K planes past its
  // core, where level K finishes the core's last plane. Plane x sits in
  // slot (x - g_begin) mod 3 of a level's ring, mod K + 1 of the Cm ring.
  const int64_t g_begin = r0 - K > 0 ? r0 - K : 0;
  const int64_t g_end = r1 + K;
  const C zero = C(0);
  // This thread's T and Cm of plane g, and of g + 1 in flight (Cm only
  // for the ring).
  S tg[kQ], tn[kQ], cg[kQ], cn[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const bool on = q < nq && at[q] >= 0 && g_begin < n0;
    tg[q] = on ? T[g_begin * s0 + at[q]] : narrow<S>(zero);
    cg[q] = on && cm_ring ? Cm[g_begin * s0 + at[q]] : narrow<S>(zero);
  }
  __syncthreads();  // the zeroed rings, before level 0's first plane lands
  int r3 = 0;       // plane g's slot in the levels' rings
  int rr = 0;       // and in the Cm ring
  for (int64_t g = g_begin; g < g_end; ++g) {
    // Plane g into level 0's ring, where no one reads in this step, and
    // its Cm into the Cm ring's slot no level reads in this step.
    {
      S* c_at = cmr + rr * plane;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (q >= nq) break;
        if (reach[q] < 0) continue;
        l0[3 * i0[q] + r3] = tg[q];
        if (cm_ring) c_at[i0[q]] = cg[q];
      }
    }
    if (g + 1 < g_end) {
      const int64_t at_next = (g + 1) * s0;
      const bool in_next = g + 1 < n0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const bool on = q < nq && at[q] >= 0 && in_next;
        tn[q] = on ? T[at_next + at[q]] : narrow<S>(zero);
        cn[q] = on && cm_ring ? Cm[at_next + at[q]] : narrow<S>(zero);
      }
    }
    int rc = rr == 0 ? K : rr - 1;  // plane g - 1's slot in the Cm ring
    // Cm of plane p for cell q: its place in the Cm ring's plane `ring`,
    // or device memory.
    auto cm_of = [&](int q, const S* ring, int64_t p) -> C {
      return widen(cm_ring ? ring[i0[q]] : __ldg(Cm + p * s0 + at[q]));
    };
    C v[kQ];  // level s at plane g - s, cell by cell
    {  // level 1 at plane g - 1, from level 0's ring
      const int r3c = r3 == 0 ? 2 : r3 - 1;  // plane g - 1
      const int r3u = r3c == 0 ? 2 : r3c - 1;  // plane g - 2
      const int64_t p = g - 1;
      if (p >= 0 && p < n0) {
        const S* cmp = cmr + rc * plane;
        const int w3 = 3 * e2;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (q >= nq) break;
          if (reach[q] < 1) continue;
          const S* cell = l0 + 3 * i0[q];
          const S* cen = cell + r3c;
          v[q] = update<C, 3, kDirect>(widen(cen[0]), cm_of(q, cmp, p),
                                       widen(tg[q]) + widen(cell[r3u]),
                                       widen(cen[w3]) + widen(cen[-w3]),
                                       widen(cen[3]) + widen(cen[-3]), inv0, inv1, inv2);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kQ; ++q) v[q] = zero;
      }
    }
    // Levels 2..K. Ring s starts at `off` in lv, its cone `size` cells in
    // rows of w, a cell's three planes side by side; this step writes its
    // plane g - s (slot `ws`) and reads g - s - 1 (slot (ws + 2) mod 3, the
    // centre) and g - s - 2 (slot (ws + 1) mod 3, up).
    int off = 0;
    int ws = r3 == 0 ? 2 : r3 - 1;  // level 1's plane g - 1
#pragma unroll
    for (int s = 1; s < K; ++s) {
      const int w = e2 - 2 * s;
      const int size = (e1 - 2 * s) * w;
      const int cs = ws == 0 ? 2 : ws - 1;
      const int us = cs == 0 ? 2 : cs - 1;
      C* ring = lv + off;
      const int w3 = 3 * w;
      const int64_t p = g - s - 1;  // level s + 1's plane
      const bool in = p >= 0 && p < n0;
      rc = rc == 0 ? K : rc - 1;
      const S* cmp = cmr + rc * plane;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (q >= nq) break;
        if (reach[q] < s) continue;
        C* cell = ring + 3 * (i0[q] - s * d[q] + 2 * s * s);
        cell[ws] = v[q];
        if (reach[q] == s) continue;
        const C* cen = cell + cs;
        v[q] = in ? update<C, 3, kDirect>(cen[0], cm_of(q, cmp, p), v[q] + cell[us],
                                          cen[w3] + cen[-w3], cen[3] + cen[-3], inv0,
                                          inv1, inv2)
                  : zero;
      }
      off += kTb3Slots * size;
      ws = cs;
    }
    const int64_t p = g - K;  // level K's plane
    if (p >= r0 && p < r1) {
      S* dst = out + p * s0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (q >= nq) break;
        if (reach[q] == K) dst[at[q]] = narrow<S>(v[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      tg[q] = tn[q];
      cg[q] = cn[q];
    }
    r3 = r3 == 2 ? 0 : r3 + 1;
    rr = rr == K ? 0 : rr + 1;
    __syncthreads();
  }
}

// The 3D kernel's depth K is a template argument: one instantiation per K
// in 1..16 (as the 2D kernel's, RMT_TB2_K_CASES).
template <typename S>
using Tb3Kernel = void (*)(const S*, const S*, S*, int64_t, int64_t, int64_t, int, int, int,
                           int64_t, bool, typename Compute<S>::type, typename Compute<S>::type,
                           typename Compute<S>::type);

template <typename S>
Tb3Kernel<S> tb3_kernel(int k) {
  switch (k) {
#define RMT_CASE(K) case K: return rmt_tb_sweep_3d_kernel<S, K>;
    RMT_TB2_K_CASES(RMT_CASE)
#undef RMT_CASE
    default: return nullptr;
  }
}

// Per device and instantiation, once: the kernel may take the device's
// opt-in shared memory a block. Returns 0, -1 for a device index or k out
// of range, or a CUDA error.
template <typename S>
int tb3_prepare(int k, int dev, int* optin) {
  static int limit[17][kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices || k < 1 || k > 16) return -1;
  if (limit[k][dev] == 0) {
    int got = 0;
    cudaError_t err = cudaDeviceGetAttribute(&got, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(tb3_kernel<S>(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               got);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[k][dev] = got;
  }
  *optin = limit[k][dev];
  return 0;
}

// A plan the kernel takes: 1 <= k <= 16, a core on both axes, whole warps
// up to kTb3MaxThreads, at most kTb3MaxCells cells a thread, shared bytes
// within the device's limit. Returns the shared bytes, or -1.
template <typename S>
int64_t tb3_check(int k, int e1, int e2, int threads, bool cm_ring, int optin) {
  if (k < 1 || k > 16 || e1 - 2 * k < 1 || e2 - 2 * k < 1 || threads < 32 ||
      threads > kTb3MaxThreads || threads % 32 != 0 ||
      static_cast<int64_t>(e1) * tb3_pitch(e2) > static_cast<int64_t>(kTb3MaxCells) * threads)
    return -1;
  const int64_t smem = tb3_smem_bytes<S>(k, e1, e2, cm_ring);
  return smem <= optin ? smem : -1;
}

template <typename S>
int launch_tb3(int k, const void* T, const void* Cm, void* out, int64_t n0, int64_t n1,
               int64_t n2, int64_t seg, int e1, int e2, int threads, bool cm_ring, double inv0,
               double inv1, double inv2, int dev, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  int optin = 0;
  const int rc = tb3_prepare<S>(k, dev, &optin);
  if (rc != 0) return rc;
  const int64_t smem = tb3_check<S>(k, e1, e2, threads, cm_ring, optin);
  if (smem < 0 || seg < 1 || n0 < 1 || n1 < 1 || n2 < 1) return -1;
  if (n1 * n2 > 2147483647LL) return -2;  // a cell's offset in a plane is an int
  const int64_t tiles2 = (n2 + e2 - 2 * k - 1) / (e2 - 2 * k);
  const int64_t tiles = (n1 + e1 - 2 * k - 1) / (e1 - 2 * k) * tiles2;
  const int64_t segments = (n0 + seg - 1) / seg;
  if (tiles > 2147483647LL || segments > 65535) return -2;
  tb3_kernel<S>(k)<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(segments)),
                     threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cm), static_cast<S*>(out), n0, n1, n2,
      e1, e2, static_cast<int>(tiles2), seg, cm_ring, C(inv0), C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a 3D plan that one SM of device `dev` holds at once (> 0), or
// a failure below 1 (-1 for a plan the kernel does not take, minus a CUDA
// error).
template <typename S>
int tb3_blocks_per_sm(int k, int e1, int e2, int threads, bool cm_ring, int dev) {
  int optin = 0;
  const int rc = tb3_prepare<S>(k, dev, &optin);
  if (rc != 0) return rc < 0 ? rc : -rc;
  const int64_t smem = tb3_check<S>(k, e1, e2, threads, cm_ring, optin);
  if (smem < 0) return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tb3_kernel<S>(k), threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks;
}

template <typename S>
int tb_ndim(int ndim, int k, const void* T, const void* Cm, void* out, int64_t n0,
            int64_t n1, int64_t n2, int64_t seg_rows, int e1, int e2, int threads,
            int cm_ring, double inv0, double inv1, double inv2, int dev, cudaStream_t s) {
  if (ndim == 2)
    return tb2_dispatch<S>(k, T, Cm, out, n0, n1, seg_rows, inv0, inv1, dev, s);
  return launch_tb3<S>(k, T, Cm, out, n0, n1, n2, seg_rows, e1, e2, threads, cm_ring != 0,
                       inv0, inv1, inv2, dev, s);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the block's extents, n2 = 1 in 2D; `stream` is a cudaStream_t.
// Return codes: 0 on success, >0 a CUDA error (the launch's, or
// cudaGetLastError() after it), -1 an unsupported dtype, rank, form, step
// count or plan, -2 a grid that overflows a launch dimension, -3 a launch
// that cannot fit (no co-resident block). Launches are asynchronous on
// `stream`; nothing here allocates.

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

// `k` direct-form steps, 1 <= k <= 16. `out` must not alias `T`. The plan
// is the caller's: 2D takes `seg_rows` core rows a segment from
// ops/multistep.tb_plan and ignores the rest; 3D takes `seg_rows` core
// planes a segment, the e1 × e2 tile, `threads` a block and whether Cm
// goes through a ring in shared memory (`cm_ring`) from
// ops/multistep.tb3_plan (-1 for a plan the kernel does not take). `dev`
// is the current device's index.
extern "C" int rmt_tb_sweep(int dtype, int ndim, int k, const void* T,
                            const void* Cm, void* out, int64_t n0, int64_t n1,
                            int64_t n2, int64_t seg_rows, int e1, int e2, int threads,
                            int cm_ring, double inv0, double inv1, double inv2, int dev,
                            void* stream) {
  if ((ndim != 2 && ndim != 3) || k < 1 || k > 16) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return tb_ndim<float>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, e1, e2, threads,
                            cm_ring, inv0, inv1, inv2, dev, s);
    case kF64:
      return tb_ndim<double>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, e1, e2, threads,
                             cm_ring, inv0, inv1, inv2, dev, s);
    case kBF16:
      return tb_ndim<__nv_bfloat16>(ndim, k, T, Cm, out, n0, n1, n2, seg_rows, e1, e2, threads,
                                    cm_ring, inv0, inv1, inv2, dev, s);
    default:
      return -1;
  }
}

// Blocks of a 3D tb_sweep plan (k, e1 × e2 tile, threads, cm_ring) that
// one SM of device `dev` holds at once (> 0), or a failure below 1; the
// plan weighs its candidates by it.
extern "C" int rmt_tb3_blocks_per_sm(int dtype, int k, int e1, int e2, int threads, int cm_ring,
                                     int dev) {
  const bool ring = cm_ring != 0;
  switch (dtype) {
    case kF32: return tb3_blocks_per_sm<float>(k, e1, e2, threads, ring, dev);
    case kF64: return tb3_blocks_per_sm<double>(k, e1, e2, threads, ring, dev);
    case kBF16: return tb3_blocks_per_sm<__nv_bfloat16>(k, e1, e2, threads, ring, dev);
    default: return -1;
  }
}

// Shared bytes a block of a 3D plan takes (-1 for an unsupported dtype):
// what ops/multistep.tb3_smem_bytes computes, asked of the kernel.
extern "C" int64_t rmt_tb3_smem_bytes(int dtype, int k, int e1, int e2, int cm_ring) {
  const bool ring = cm_ring != 0;
  switch (dtype) {
    case kF32: return tb3_smem_bytes<float>(k, e1, e2, ring);
    case kF64: return tb3_smem_bytes<double>(k, e1, e2, ring);
    case kBF16: return tb3_smem_bytes<__nv_bfloat16>(k, e1, e2, ring);
    default: return -1;
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
