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
// field it runs on, a step is well under a microsecond of arithmetic, and
// what a step costs is the synchronisation between steps and the latency of
// the reads. So its blocks stay on chip for the whole launch, as the TPU
// kernel keeps them in VMEM: one thread-block cluster (resident.cuh) holds
// the block in distributed shared memory, CTA r a band of rows along axis 0
// in two compute-type buffers of U with a halo row each side. A cell reads
// U⁻ only at its own index, so U⁺ overwrites U⁻ in place and the two
// buffers hold the pair for any n. Each step reads only the CTA's own shared
// memory; its new edge rows go straight into the neighbours' halo rows
// (st.async), counted on their mbarriers, so no cluster barrier (and no
// cluster-scope fence: scripts/bench_cluster_sync.cu) runs between steps.
// Each lane walks a run of rows of one column with the cells above and
// below in registers. U and U⁻ are read from device memory once and the
// pair written once; M and Cw are staged into shared memory where the plan
// leaves room, else read through L1. The A-form's c and A are recomputed from M and Cw
// every step rather than kept: the same operations on the same operands give
// the prologue's bits, and M and Cw are fewer bytes. What a step costs now
// is the latency of each lane's chain of shared-memory reads and arithmetic
// (1024 threads a CTA hide more of it than 512). A block too large for one
// cluster's shared memory (the raw wrapper takes any size; the JAX admission
// keeps the model paths within it) takes the cooperative route, chosen by
// size before the launch (ops/resident.py): a persistent cooperative launch,
// the state in L2 in two buffers, a grid barrier a step, __ldcg reads.

#include <cooperative_groups.h>

#include "resident.cuh"
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
rmt_wave_step_kernel(const S* __restrict__ Up, const S* __restrict__ Uprev,
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
rmt_wave_step_masked_kernel(const S* __restrict__ src, const S* __restrict__ Uprev,
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
rmt_wave_multi_step_kernel(const S* __restrict__ U, const S* __restrict__ Uprev,
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

// The cluster route: CTA r of one cluster holds its band of U (see
// resident.cuh for the band plan) in two compute-type buffers of rows_max + 2
// rows: row r of the band at row r + 1, and around it the halo rows, the
// neighbour bands' edge rows (0 beyond the block). A step reads only its own
// shared memory; it writes each new edge row into the neighbour's halo row
// as well, with st.async, and waits on its own mbarrier for the halo rows
// its neighbours write (resident.cuh: the halo exchange). When STAGE, the
// band's M and Cw follow the buffers in the storage type (read from shared
// memory), else they are read from device memory through L1. The last step
// is the loop body again with the stores to device memory in place of the
// stores and pushes to shared memory, so no step tests which one it is.
template <typename S, int NDIM, int FORM, bool STAGE>
__global__ void __launch_bounds__(rmt::kResidentThreads, 1)
rmt_wave_multi_step_resident_kernel(const S* __restrict__ U, const S* __restrict__ Uprev,
                     const S* __restrict__ M, const S* __restrict__ Cw, S* __restrict__ oU,
                     S* __restrict__ oUprev, int n_steps, int n0, int n_mid, int n_last,
                     typename Compute<S>::type inv0, typename Compute<S>::type inv1,
                     typename Compute<S>::type inv2) {
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
  C* buf = reinterpret_cast<C*>(smem + rmt::kBarrierBytes);  // U: even steps, then odd
  S* staged = reinterpret_cast<S*>(buf + 2 * cap);            // M, then Cw, when STAGE
  if (STAGE) rmt::load_bands<false>(staged, M + base, cells, staged + cells, Cw + base, cells);
  const S* __restrict__ m = STAGE ? staged : M + base;
  const S* __restrict__ cw = STAGE ? staged + cells : Cw + base;
  // U with its halo rows (0 beyond the block), U⁻ without: it is read only
  // at its own cell. The second buffer's halo rows start at 0 and hold 0
  // at the block's edges for good.
  const int lo_row = band.start > 0 ? 1 : 0;
  const int hi_row = band.start + band.rows < n0 ? 1 : 0;
  rmt::zero_rows(buf + cap, plane);
  rmt::zero_rows(buf + cap + (band.rows + 1) * plane, plane);
  if (!lo_row) rmt::zero_rows(buf, plane);
  if (!hi_row) rmt::zero_rows(buf + (band.rows + 1) * plane, plane);
  rmt::load_bands<true>(buf + (1 - lo_row) * plane, U + base - lo_row * plane,
                        (band.rows + lo_row + hi_row) * plane, buf + cap + plane, Uprev + base,
                        cells);
  // The neighbours' halo rows this CTA's edge rows go to (the band below's
  // top halo row, the band above's bottom one, at the same buffer offsets)
  // and their mbarriers, as shared::cluster addresses; 0 where there is none.
  const uint32_t here = rmt::smem_u32(buf);
  const uint32_t lo_dst = rank > 0 ? rmt::map_rank(
      here + (rmt::band_of(n0, nc, rank - 1).rows + 1) * plane * sizeof(C), rank - 1) : 0;
  const uint32_t lo_bar = rank > 0 ? rmt::map_rank(rmt::smem_u32(bar), rank - 1) : 0;  // bar[0]
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

  const int warps = static_cast<int>(blockDim.x >> 5);
  const rmt::Walk walk(band.rows, n_mid, n_last, warps);
  const rmt::Walk::Slice slice = walk.slice(static_cast<int>(threadIdx.x >> 5));
  const int lane = static_cast<int>(threadIdx.x & 31);
  // One step; LAST writes the pair to device memory instead.
  auto step_body = [&](int step, auto last_tag) {
    constexpr bool LAST = decltype(last_tag)::value;
    const C two = C(2);
    const int off = (step & 1) ? cap : 0;
    const C* __restrict__ cur = buf + off + plane;  // U of this step at its row 0
    C* __restrict__ oth = buf + (cap - off) + plane;  // U⁻ in, U⁺ out, by each cell's thread
    const uint32_t push_at = static_cast<uint32_t>((cap - off) * sizeof(C));
    const uint32_t bar_at = static_cast<uint32_t>((step & 1) * sizeof(uint64_t));
    for (int it = slice.it, r0 = slice.r0, mi = slice.mi, wc = slice.ch; it < slice.stop;
         walk.next(slice, &it, &r0, &mi, &wc)) {
      const int r1 = walk.run_end(slice, it, r0);
      const int c = wc * 32 + lane;
      if (c >= n_last) continue;
      const int inplane = mi * n_last + c;
      const bool has_l = c > 0;
      const bool has_r = c + 1 < n_last;
      int j = r0 * plane + inplane;
      C lo = cur[j - plane];  // the walk carries the cells below and at its row
      C t = cur[j];
#pragma unroll 2
      for (int r = r0; r < r1; ++r, j += plane) {
        const C hi = cur[j + plane];
        const C tp = oth[j];
        const C p0 = hi + lo;
        C p1;
        C p2 = C(0);
        if constexpr (NDIM == 2) {
          p1 = (has_r ? cur[j + 1] : C(0)) + (has_l ? cur[j - 1] : C(0));
        } else {
          p1 = (mi + 1 < n_mid ? cur[j + n_last] : C(0)) + (mi > 0 ? cur[j - n_last] : C(0));
          p2 = (has_r ? cur[j + 1] : C(0)) + (has_l ? cur[j - 1] : C(0));
        }
        const C mv = widen(m[j]);
        const C cwv = widen(cw[j]);
        C v;
        if constexpr (FORM == kAForm) {
          const C cc = cwv * inv0;
          const C a = (C(1) + mv) - C(2 * NDIM) * cc;
          C sum = p0 + p1;
          if (NDIM == 3) sum = sum + p2;
          v = (a * t + cc * sum) - mv * tp;
        } else {
          C lap = (p0 - two * t) * inv0;
          lap = lap + (p1 - two * t) * inv1;
          if (NDIM == 3) lap = lap + (p2 - two * t) * inv2;
          v = (t + mv * (t - tp)) + cwv * lap;
        }
        if constexpr (LAST) {
          oU[base + j] = narrow<S>(v);
          oUprev[base + j] = narrow<S>(t);
        } else {
          oth[j] = v;
          const uint32_t at = push_at + static_cast<uint32_t>(inplane * sizeof(C));
          if (r == 0 && lo_dst) rmt::push(lo_dst + at, v, lo_bar + bar_at);
          if (r + 1 == band.rows && hi_dst) rmt::push(hi_dst + at, v, hi_bar + bar_at);
        }
        lo = t;
        t = hi;
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
  cluster.sync();  // no CTA leaves while a store it issued to a neighbour may be in flight
}

// Bytes of shared memory a CTA of the cluster route: the mbarrier, two
// compute-type buffers of `rows` + 2 rows of `plane` cells, and M and Cw
// when staged.
template <typename S>
size_t resident_bytes(int64_t rows, int64_t plane, int stage) {
  using C = typename Compute<S>::type;
  const size_t cells = static_cast<size_t>(rows * plane);
  return rmt::kBarrierBytes + 2 * (cells + 2 * plane) * sizeof(C) +
         (stage ? 2 * cells * sizeof(S) : 0);
}

// One cache a (dtype, rank, form): the cluster kernel's caps and the
// cooperative kernel's co-resident blocks, per device.
template <typename S, int NDIM, int FORM, bool STAGE>
rmt::CapsCache& caps_cache() {
  static rmt::CapsCache cache;
  return cache;
}

// The caps of the staged instantiation stand for both: the two differ in
// no resource the grant depends on (threads, dynamic shared memory).
template <typename S, int NDIM, int FORM>
int caps_of(int dev, int* out) {
  rmt::ClusterCaps caps;
  const cudaError_t err = rmt::cluster_caps(rmt_wave_multi_step_resident_kernel<S, NDIM, FORM, true>, dev,
                                            &caps_cache<S, NDIM, FORM, true>(), &caps);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = caps.cluster;
  out[1] = caps.smem_limit;
  return 0;
}

template <typename S, int NDIM, int FORM, bool STAGE>
int launch_resident(const S* u, const S* up, const S* m, const S* cw, S* ou, S* oup,
                    int n_steps, int64_t n0, int64_t n1, int64_t n2,
                    typename Compute<S>::type c0, typename Compute<S>::type c1,
                    typename Compute<S>::type c2, int cluster, int dev, cudaStream_t stream) {
  auto kernel = rmt_wave_multi_step_resident_kernel<S, NDIM, FORM, STAGE>;
  rmt::ClusterCaps caps;
  cudaError_t err = rmt::cluster_caps(kernel, dev, &caps_cache<S, NDIM, FORM, STAGE>(), &caps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = n1 * n2;
  const size_t bytes = resident_bytes<S>((n0 + cluster - 1) / cluster, plane, STAGE);
  if (!rmt::plan_fits(caps, cluster, n0, bytes) || plane > (int64_t{1} << 30)) return -1;
  const int n_mid = NDIM == 2 ? 1 : static_cast<int>(n1);
  const int n_last = NDIM == 2 ? static_cast<int>(n1) : static_cast<int>(n2);
  err = rmt::launch_cluster(kernel, cluster, bytes, stream, u, up, m, cw, ou, oup, n_steps,
                            static_cast<int>(n0), n_mid, n_last, c0, c1, c2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NDIM, int FORM>
int launch_multi(const void* U, const void* Uprev, const void* M, const void* Cw,
                 void* oU, void* oUprev, void* scratch, int n_steps, int64_t n0,
                 int64_t n1, int64_t n2, double inv0, double inv1, double inv2,
                 int cluster, int stage, int dev, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  const S* u = static_cast<const S*>(U);
  const S* up = static_cast<const S*>(Uprev);
  const S* m = static_cast<const S*>(M);
  const S* cw = static_cast<const S*>(Cw);
  S* ou = static_cast<S*>(oU);
  S* oup = static_cast<S*>(oUprev);
  C c0 = C(inv0), c1 = C(inv1), c2 = C(inv2);
  if (cluster > 0 && stage)
    return launch_resident<S, NDIM, FORM, true>(u, up, m, cw, ou, oup, n_steps, n0, n1, n2,
                                                c0, c1, c2, cluster, dev, stream);
  if (cluster > 0)
    return launch_resident<S, NDIM, FORM, false>(u, up, m, cw, ou, oup, n_steps, n0, n1, n2,
                                                 c0, c1, c2, cluster, dev, stream);
  if (scratch == nullptr) return -1;
  auto kernel = rmt_wave_multi_step_kernel<S, NDIM, FORM>;
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
                   double inv0, double inv1, double inv2, int cluster, int stage, int dev,
                   cudaStream_t s) {
  if (ndim == 2 && form == kDirect)
    return launch_multi<S, 2, kDirect>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, 1,
                                       inv0, inv1, 0.0, cluster, stage, dev, s);
  if (ndim == 2)
    return launch_multi<S, 2, kAForm>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, 1,
                                      inv0, inv1, 0.0, cluster, stage, dev, s);
  if (form == kDirect)
    return launch_multi<S, 3, kDirect>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, n2,
                                       inv0, inv1, inv2, cluster, stage, dev, s);
  return launch_multi<S, 3, kAForm>(U, Uprev, M, Cw, oU, oUprev, scratch, n, n0, n1, n2,
                                    inv0, inv1, inv2, cluster, stage, dev, s);
}

template <typename S>
int dispatch_caps(int ndim, int form, int dev, int* out) {
  if (ndim == 2 && form == kDirect) return caps_of<S, 2, kDirect>(dev, out);
  if (ndim == 2) return caps_of<S, 2, kAForm>(dev, out);
  if (form == kDirect) return caps_of<S, 3, kDirect>(dev, out);
  return caps_of<S, 3, kAForm>(dev, out);
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
    rmt_wave_step_kernel<S, 2><<<grid, block, 0, stream>>>(up, uprev, c2, o, n1, 1, box, C(dt2),
                                                       C(inv0), C(inv1), C(0));
  } else {
    rmt_wave_step_kernel<S, 3><<<grid, block, 0, stream>>>(up, uprev, c2, o, n1, n2, box, C(dt2),
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
    rmt_wave_step_masked_kernel<S, 2><<<grid, block, 0, stream>>>(
        s, uprev, m, cw, o, n1, 1, box, off, C(inv0), C(inv1), C(0));
  } else {
    rmt_wave_step_masked_kernel<S, 3><<<grid, block, 0, stream>>>(
        s, uprev, m, cw, o, n1, n2, box, off, C(inv0), C(inv1), C(inv2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (n0, n1,
// n2) are the core's extents, n2 = 1 in 2D; `stream` is a cudaStream_t.
// Return codes: 0 on success, >0 a CUDA error (the launch's, or
// cudaGetLastError() after it), -1 an unsupported dtype, rank, form, step
// count, box or plan, -2 a grid that overflows a launch dimension, -3 no
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

// `form`: 0 direct, 1 A-form. The route is the caller's plan
// (ops/resident.py), made before the launch: `cluster` > 0 launches one
// cluster of that many CTAs (at most the size rmt_wave_multi_step_caps
// grants, and at most n0), with M and Cw staged into shared memory when
// `stage`; a plan whose bytes a CTA exceed the card's limit returns -1, and
// `scratch` is not read. `cluster` == 0 takes the cooperative route, whose
// `scratch` holds 2·n0·n1·n2 elements of the compute type (f32 for bf16).
// `dev` is the current device's index. oU and oUprev must not alias the
// inputs.
extern "C" int rmt_wave_multi_step(int dtype, int ndim, int form, int n_steps,
                                   const void* U, const void* Uprev, const void* M,
                                   const void* Cw, void* oU, void* oUprev, void* scratch,
                                   int64_t n0, int64_t n1, int64_t n2, double inv0,
                                   double inv1, double inv2, int cluster, int stage, int dev,
                                   void* stream) {
  if ((ndim != 2 && ndim != 3) || (form != kDirect && form != kAForm) || n_steps < 1 ||
      cluster < 0)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_multi<float>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch, n_steps,
                                   n0, n1, n2, inv0, inv1, inv2, cluster, stage, dev, s);
    case kF64:
      return dispatch_multi<double>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch, n_steps,
                                    n0, n1, n2, inv0, inv1, inv2, cluster, stage, dev, s);
    case kBF16:
      return dispatch_multi<__nv_bfloat16>(ndim, form, U, Uprev, M, Cw, oU, oUprev, scratch,
                                           n_steps, n0, n1, n2, inv0, inv1, inv2, cluster,
                                           stage, dev, s);
    default:
      return -1;
  }
}

// What device `dev` (the current one) grants the cluster route of one
// (dtype, ndim, form): out[0] the largest cluster size (16, 8, or 0 for
// none), out[1] the dynamic shared memory a CTA may use. Asked once per
// device; the launches reuse the answer.
extern "C" int rmt_wave_multi_step_caps(int dtype, int ndim, int form, int dev, int* out) {
  if ((ndim != 2 && ndim != 3) || (form != kDirect && form != kAForm)) return -1;
  switch (dtype) {
    case kF32: return dispatch_caps<float>(ndim, form, dev, out);
    case kF64: return dispatch_caps<double>(ndim, form, dev, out);
    case kBF16: return dispatch_caps<__nv_bfloat16>(ndim, form, dev, out);
    default: return -1;
  }
}
