// Hand-written Hopper kernels of the shallow-water workload: the linearised
// equations on a C-grid, stepped forward-backward over the coupled state
// (h, u_0, …, u_{ndim-1}), every field of one shape:
//
//     h'   = h − Σ_a cH_a·(u_a − u_a[−e_a])
//     u_a' = M_a·(u_a − cg_a·(h'[+e_a] − h'))
//
//   rmt_swe_step — one step over a BOX of the core, read from sources grown
//       by `off` cells per axis (the width-1 padded buffers of the halo
//       exchange, off = 1, or the raw shard, off = 0, for a box whose
//       stencil stays inside it), each output leaf written only inside the
//       box. Replaces rocm_mpi_tpu/ops/swe_kernels.py
//       swe_step_padded_pallas (_swe_kernel_whole): the `perf` step (the
//       box of the whole core) and the `hide` variant's region kernel.
//   rmt_swe_multi_step — `n_steps` steps in one launch on an unpadded
//       block. Replaces _swe_multi_step_kernel (via swe_multi_step_masked
//       and swe_multi_step): the VMEM-resident loop and the deep-halo
//       sweep's local compute.
//
// The coupling. u_a' at a cell needs h' at the cell and at its +e_a
// neighbour, and that h' reads u_b one cell back along b: a diagonal
// neighbour u_b[c + e_a − e_b]. _swe_padded_math computes h' on the core
// plus the high pad for that reason. Here each thread computes h' at its
// own cell and again at each of its ndim high neighbours, from the SOURCE
// (never from another thread's or box's output), with the operands and
// operation order of _swe_padded_math: the divergence summed in axis order,
// cH and cg formed in double by the caller and rounded to the compute type.
// So the recomputed h' has the bits of the h' the neighbour stores, a box
// needs nothing from any other box, and the diagonal read comes from the
// padded source, whose corners the exchange's two-stage trick filled.
//
// The wrap. The TPU multi-step kernel takes neighbours by roll, which
// wraps around the block. rmt_swe_multi_step reads zeros instead: u_a one
// cell below the block is 0, and h' one cell above it is 0. On the global
// field the wrapped u_a is a wall face (0 by its mask) and the u_a' that
// reads the wrapped h' is a wall face (M_a == 0), so both give the same
// values up to the sign of a zero; on a deep block both reach only the
// ghost ring the sweep crops.
//
// Each keeps its TPU kernel's operation order and the build uses
// -fmad=false, so each launch is bitwise equal to its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/swe.py). bf16 is storage-only: widened on load,
// computed in f32, rounded once per launch.
//
// Bound on the card. rmt_swe_step is memory-bound: 3·ndim + 2 passes of the
// field per step (ndim+1 padded reads, ndim masks, ndim+1 writes) against
// 7·ndim operations a cell. As in stencil.cu: one thread per core cell,
// 32x8 blocks along the last axis, the neighbour and diagonal reads served
// from lines the block already holds; the recomputed h' costs operations,
// not bytes. rmt_swe_multi_step runs on blocks of at most 2 MiB of state
// (the JAX admission), where a step is under a microsecond of work and
// what a step costs is the barrier between steps and the latency of the
// reads. So the block stays on chip for the whole launch, as the TPU kernel
// keeps it in VMEM: one thread-block cluster (resident.cuh) holds it in
// distributed shared memory, CTA r a band of rows along axis 0 in two
// compute-type buffers of (h, u_0, …). Each step computes h' once a cell
// over the band and the next band's first row (that row's h' recomputed
// from the neighbour's state through DSMEM, with the same operands and
// order, so its bits are the neighbour's own), then, after a CTA barrier,
// u_a' from it; one cluster barrier a step separates the steps. The state
// is read from device memory once and written once; the face masks are
// staged into shared memory where the plan leaves room, else read through
// L1. A block too large for one cluster's shared memory (the raw wrapper
// takes any size) takes the cooperative route, chosen by size before the
// launch (ops/resident.py): a persistent cooperative launch, the state in
// L2 in two buffers of ndim+1 fields, one grid barrier a step, __ldcg reads,
// each cell recomputing its high neighbours' h' from the old buffer so
// that one barrier separates the steps.

#include <cooperative_groups.h>

#include "resident.cuh"
#include "stencil_common.cuh"

namespace coop = cooperative_groups;

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

// The state's leaves (u[2] unused in 2D), the face masks, the outputs.
template <typename S>
struct StateIn {
  const S* h;
  const S* u[3];
};
template <typename S>
struct Masks {
  const S* m[3];
};
template <typename S>
struct StateOut {
  S* h;
  S* u[3];
};
// cH_a = dt·H/d_a and cg_a = dt·g/d_a in the compute type.
template <typename C>
struct Coeffs {
  C cH[3];
  C cg[3];
};

// ---------------------------------------------------------------------------
// rmt_swe_step
// ---------------------------------------------------------------------------

// h' at source index q: h[q] − ((cH_0·(u_0[q] − u_0[q − st_0]) + cH_1·(…))
// + cH_2·(…)) — _swe_padded_math's order.
template <typename S, int NDIM>
__device__ __forceinline__ typename Compute<S>::type h_new(
    const StateIn<S>& s, const int64_t* st, int64_t q,
    const Coeffs<typename Compute<S>::type>& k) {
  using C = typename Compute<S>::type;
  C div = k.cH[0] * (widen(s.u[0][q]) - widen(s.u[0][q - st[0]]));
#pragma unroll
  for (int a = 1; a < NDIM; ++a)
    div = div + k.cH[a] * (widen(s.u[a][q]) - widen(s.u[a][q - st[a]]));
  return widen(s.h[q]) - div;
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kBlockX * kBlockY)
rmt_swe_step_kernel(StateIn<S> src, Masks<S> masks, StateOut<S> out, int64_t n1, int64_t n2,
                Box box, int off, Coeffs<typename Compute<S>::type> k) {
  using C = typename Compute<S>::type;
  int64_t i0, i1, i2;
  if (!rmt::box_cell<NDIM>(box, &i0, &i1, &i2)) return;
  const Region<NDIM> r(n1, n2, off);
  const int64_t p = r.src(i0, i1, i2);
  const int64_t idx = r.core(i0, i1, i2);
  const int64_t st[3] = {r.ps0, r.ps1, 1};
  const C hc = h_new<S, NDIM>(src, st, p, k);
  out.h[idx] = narrow<S>(hc);
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    const C hn = h_new<S, NDIM>(src, st, p + st[a], k);
    out.u[a][idx] =
        narrow<S>(widen(masks.m[a][idx]) * (widen(src.u[a][p]) - k.cg[a] * (hn - hc)));
  }
}

// ---------------------------------------------------------------------------
// rmt_swe_multi_step
// ---------------------------------------------------------------------------

// Field f (0: h, 1 + a: u_a) of the state at the start of step `step`: the
// input for step 0, else the buffer the previous step wrote, whose field f
// starts at f·cells.
template <typename S>
__device__ __forceinline__ typename Compute<S>::type state_at(
    int step, const StateIn<S>& in, const typename Compute<S>::type* prev, int64_t cells,
    int f, int64_t i) {
  if (step == 0) return widen(f == 0 ? in.h[i] : in.u[f - 1][i]);
  return __ldcg(prev + f * cells + i);
}

// h' at cell c (coordinates c[0..2], linear index i) of the state at the
// start of `step`, u_a one cell below the block read as 0.
template <typename S, int NDIM>
__device__ __forceinline__ typename Compute<S>::type h_new_at(
    int step, const StateIn<S>& in, const typename Compute<S>::type* prev, int64_t cells,
    const int64_t* s, const int64_t* c, int64_t i,
    const Coeffs<typename Compute<S>::type>& k) {
  using C = typename Compute<S>::type;
  const C zero = C(0);
  C div = k.cH[0] * (state_at<S>(step, in, prev, cells, 1, i) -
                     (c[0] > 0 ? state_at<S>(step, in, prev, cells, 1, i - s[0]) : zero));
#pragma unroll
  for (int a = 1; a < NDIM; ++a) {
    div = div +
          k.cH[a] * (state_at<S>(step, in, prev, cells, 1 + a, i) -
                     (c[a] > 0 ? state_at<S>(step, in, prev, cells, 1 + a, i - s[a]) : zero));
  }
  return state_at<S>(step, in, prev, cells, 0, i) - div;
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kThreads)
rmt_swe_multi_step_kernel(StateIn<S> in, Masks<S> masks, StateOut<S> out,
                      typename Compute<S>::type* buf0, typename Compute<S>::type* buf1,
                      int n_steps, int64_t n0, int64_t n1, int64_t n2,
                      Coeffs<typename Compute<S>::type> k) {
  using C = typename Compute<S>::type;
  coop::grid_group grid = coop::this_grid();
  const int64_t s[3] = {n1 * n2, n2, 1};  // strides (2D: n2 == 1)
  const int64_t n[3] = {n0, n1, n2};
  const int64_t cells = n0 * n1 * n2;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int step = 0; step < n_steps; ++step) {
    const bool last = step == n_steps - 1;
    C* dst = (step & 1) ? buf1 : buf0;
    const C* prev = (step & 1) ? buf0 : buf1;  // read only when step > 0
    for (int64_t i = first; i < cells; i += stride) {
      const int64_t c0 = i / s[0];
      const int64_t rem = i - c0 * s[0];
      const int64_t c[3] = {c0, rem / n2, rem - (rem / n2) * n2};
      const C hc = h_new_at<S, NDIM>(step, in, prev, cells, s, c, i, k);
      C v[3];
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        C hn = C(0);  // h' one cell above the block reads as 0
        if (c[a] + 1 < n[a]) {
          int64_t cn[3] = {c[0], c[1], c[2]};
          cn[a] += 1;
          hn = h_new_at<S, NDIM>(step, in, prev, cells, s, cn, i + s[a], k);
        }
        v[a] = widen(masks.m[a][i]) *
               (state_at<S>(step, in, prev, cells, 1 + a, i) - k.cg[a] * (hn - hc));
      }
      if (last) {
        out.h[i] = narrow<S>(hc);
#pragma unroll
        for (int a = 0; a < NDIM; ++a) out.u[a][i] = narrow<S>(v[a]);
      } else {
        dst[i] = hc;
#pragma unroll
        for (int a = 0; a < NDIM; ++a) dst[(1 + a) * cells + i] = v[a];
      }
    }
    if (!last) grid.sync();
  }
}

// The cluster route. CTA r holds its band (resident.cuh) of the state in
// two buffers of the compute type: h for rows 0 … rows (row `rows` the next
// band's first row, whose h' the CTA computes itself), then each velocity
// for rows −1 … rows (row r at r + 1; the halo rows are the neighbour
// bands' edge rows, 0 beyond the block). A step reads only its own shared
// memory; it writes its new first row of each velocity into the band
// below's top halo row and its new last row of u_0 into the band above's
// bottom one, with st.async, and waits on its own mbarrier for the halo
// rows its neighbours write (resident.cuh: the halo exchange). When
// `stage`, the band's face masks follow the buffers in the storage type.
template <typename S, int NDIM>
__global__ void __launch_bounds__(rmt::kResidentThreads, 1)
rmt_swe_multi_step_resident_kernel(StateIn<S> in, Masks<S> masks, StateOut<S> out, int n_steps, int n0,
                    int n_mid, int n_last, int stage, Coeffs<typename Compute<S>::type> k) {
  using C = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());
  const rmt::Band band = rmt::band_of(n0, nc, rank);
  const int plane = n_mid * n_last;
  const int hcap = (band.rows_max + 1) * plane;  // cells of h
  const int ucap = (band.rows_max + 2) * plane;  // cells of a velocity
  const int bsz = hcap + NDIM * ucap;            // one buffer
  const int cells = band.rows * plane;
  const int64_t base = static_cast<int64_t>(band.start) * plane;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // halo arrivals of even, odd steps
  C* buf = reinterpret_cast<C*>(smem + rmt::kBarrierBytes);  // even steps' state, then odd
  const S* mk[NDIM];
#pragma unroll
  for (int a = 0; a < NDIM; ++a) mk[a] = masks.m[a] + base;
  if (stage) {
    S* sm = reinterpret_cast<S*>(buf + 2 * bsz);
    rmt::load_bands<false>(sm, mk[0], cells, sm + cells, mk[1], cells);
    if (NDIM == 3) rmt::load_bands<false>(sm + 2 * cells, mk[NDIM - 1], cells, sm, mk[0], 0);
#pragma unroll
    for (int a = 0; a < NDIM; ++a) mk[a] = sm + a * cells;
  }
  // The velocities with their halo rows (0 beyond the block; the second
  // buffer's start at 0 and hold 0 at the block's edges for good), h with
  // the next band's first row.
  const int lo_row = band.start > 0 ? 1 : 0;
  const int hi_row = band.start + band.rows < n0 ? 1 : 0;
  const int64_t from = base - lo_row * plane;  // the velocities' first row, halo included
  const int count = (band.rows + lo_row + hi_row) * plane;
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    C* ua = buf + hcap + a * ucap;
    rmt::zero_rows(ua + bsz, plane);
    rmt::zero_rows(ua + bsz + (band.rows + 1) * plane, plane);
    if (!lo_row) rmt::zero_rows(ua, plane);
    if (!hi_row) rmt::zero_rows(ua + (band.rows + 1) * plane, plane);
  }
  C* vel = buf + hcap + (1 - lo_row) * plane;
  rmt::load_bands<true>(vel, in.u[0] + from, count, vel + ucap, in.u[1] + from, count);
  rmt::load_bands<true>(buf, in.h + base, (band.rows + hi_row) * plane,
                        vel + (NDIM - 1) * ucap, in.u[NDIM - 1] + from, NDIM == 3 ? count : 0);
  // Where this CTA's new edge rows go (the band below's top halo rows, row
  // rows_below + 1 of each velocity; the band above's bottom one of u_0,
  // row 0; at the same buffer offsets as this CTA's own) and the
  // neighbours' mbarriers, as shared::cluster addresses; 0 where none.
  const uint32_t here = rmt::smem_u32(buf + hcap);
  const uint32_t lo_dst = rank > 0 ? rmt::map_rank(
      here + (rmt::band_of(n0, nc, rank - 1).rows + 1) * plane * sizeof(C), rank - 1) : 0;
  const uint32_t lo_bar = rank > 0 ? rmt::map_rank(rmt::smem_u32(bar), rank - 1) : 0;  // bar[0]
  const uint32_t hi_dst = rank + 1 < nc ? rmt::map_rank(here, rank + 1) : 0;
  const uint32_t hi_bar = rank + 1 < nc ? rmt::map_rank(rmt::smem_u32(bar), rank + 1) : 0;
  const uint32_t expect = ((rank > 0 ? 1 : 0) + (rank + 1 < nc ? NDIM : 0)) * plane * sizeof(C);
  if (threadIdx.x == 0) {
    rmt::mbar_init(bar);
    rmt::mbar_init(bar + 1);
    if (nc > 1 && n_steps > 1) rmt::mbar_expect(bar, expect);      // the halo step 0 writes
    if (nc > 1 && n_steps > 2) rmt::mbar_expect(bar + 1, expect);  // and step 1
  }
  cluster.sync();

  const int rows_h = band.rows + hi_row;  // rows of h' a step computes
  const int warps = static_cast<int>(blockDim.x >> 5);
  const rmt::Walk walk(band.rows, n_mid, n_last, warps);
  const rmt::Walk::Slice slice = walk.slice(static_cast<int>(threadIdx.x >> 5));
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (int step = 0; step < n_steps; ++step) {
    const bool last = step == n_steps - 1;
    const int off = (step & 1) ? bsz : 0;
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
    const uint32_t bar_at = static_cast<uint32_t>((step & 1) * sizeof(uint64_t));
    const uint32_t push_at = static_cast<uint32_t>((bsz - off) * sizeof(C));
    const C* ch = buf + off;            // this step's h
    const C* cu = buf + off + hcap + plane;  // its u_0 at row 0; u_a at + a·ucap
    C* nh = buf + (bsz - off);          // the next h: h' of this step
    C* nu = nh + hcap + plane;          // the next u_0 at row 0
    // h' = h − Σ_a cH_a·(u_a − u_a[−e_a]), u_a one cell below the block 0;
    // the run that ends the band goes on to the next band's first row.
    for (int it = slice.it, r0 = slice.r0, mi = slice.mi, wc = slice.ch; it < slice.stop;
         walk.next(slice, &it, &r0, &mi, &wc)) {
      int r1 = walk.run_end(slice, it, r0);
      const int c = wc * 32 + lane;
      if (c >= n_last) continue;
      const int inplane = mi * n_last + c;
      if (r1 == band.rows) r1 = rows_h;
      int j = r0 * plane + inplane;
      C u0lo = cu[j - plane];
#pragma unroll 2
      for (int r = r0; r < r1; ++r, j += plane) {
        const C u0 = cu[j];
        C div = k.cH[0] * (u0 - u0lo);
        if constexpr (NDIM == 2) {
          const C* u1 = cu + ucap + j;
          div = div + k.cH[1] * (u1[0] - (c > 0 ? u1[-1] : C(0)));
        } else {
          const C* u1 = cu + ucap + j;
          const C* u2 = cu + 2 * ucap + j;
          div = div + k.cH[1] * (u1[0] - (mi > 0 ? u1[-n_last] : C(0)));
          div = div + k.cH[2] * (u2[0] - (c > 0 ? u2[-1] : C(0)));
        }
        nh[j] = ch[j] - div;
        u0lo = u0;
      }
    }
    __syncthreads();
    // u_a' = M_a·(u_a − cg_a·(h'[+e_a] − h')), h' one cell above the block 0.
    for (int it = slice.it, r0 = slice.r0, mi = slice.mi, wc = slice.ch; it < slice.stop;
         walk.next(slice, &it, &r0, &mi, &wc)) {
      int r1 = walk.run_end(slice, it, r0);
      const int c = wc * 32 + lane;
      if (c >= n_last) continue;
      const int inplane = mi * n_last + c;
      int j = r0 * plane + inplane;
      C hc = nh[j];
#pragma unroll 2
      for (int r = r0; r < r1; ++r, j += plane) {
        const C hup = r + 1 < rows_h ? nh[j + plane] : C(0);
        C hn[NDIM];
        hn[0] = hup;
        if constexpr (NDIM == 2) {
          hn[1] = c + 1 < n_last ? nh[j + 1] : C(0);
        } else {
          hn[1] = mi + 1 < n_mid ? nh[j + n_last] : C(0);
          hn[2] = c + 1 < n_last ? nh[j + 1] : C(0);
        }
        C v[NDIM];
#pragma unroll
        for (int a = 0; a < NDIM; ++a)
          v[a] = widen(mk[a][j]) * (cu[a * ucap + j] - k.cg[a] * (hn[a] - hc));
        if (last) {
          out.h[base + j] = narrow<S>(hc);
#pragma unroll
          for (int a = 0; a < NDIM; ++a) out.u[a][base + j] = narrow<S>(v[a]);
        } else {
#pragma unroll
          for (int a = 0; a < NDIM; ++a) nu[a * ucap + j] = v[a];
          const uint32_t at = push_at + static_cast<uint32_t>(inplane * sizeof(C));
          if (r == 0 && lo_dst) {
#pragma unroll
            for (int a = 0; a < NDIM; ++a)
              rmt::push(lo_dst + at + static_cast<uint32_t>(a * ucap * sizeof(C)), v[a],
                        lo_bar + bar_at);
          }
          if (r + 1 == band.rows && hi_dst) rmt::push(hi_dst + at, v[0], hi_bar + bar_at);
        }
        hc = hup;
      }
    }
  }
  cluster.sync();  // no CTA leaves while a store it issued to a neighbour may be in flight
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename S>
void unpack(const void* const* src, const void* const* m, void* const* o, StateIn<S>* in,
            Masks<S>* masks, StateOut<S>* out) {
  in->h = static_cast<const S*>(src[0]);
  out->h = static_cast<S*>(o[0]);
  for (int a = 0; a < 3; ++a) {
    in->u[a] = static_cast<const S*>(src[1 + a]);
    masks->m[a] = static_cast<const S*>(m[a]);
    out->u[a] = static_cast<S*>(o[1 + a]);
  }
}

template <typename C>
Coeffs<C> coeffs(const double* cH, const double* cg) {
  Coeffs<C> k;
  for (int a = 0; a < 3; ++a) {
    k.cH[a] = C(cH[a]);
    k.cg[a] = C(cg[a]);
  }
  return k;
}

template <typename S>
int launch_step(int ndim, const void* const* src, const void* const* m, void* const* o,
                int64_t n1, int64_t n2, Box box, int off, const double* cH, const double* cg,
                cudaStream_t stream) {
  using C = typename Compute<S>::type;
  dim3 grid;
  if (!rmt::box_grid(ndim, box, &grid)) return -2;
  const dim3 block(kBlockX, kBlockY);
  StateIn<S> in;
  Masks<S> masks;
  StateOut<S> out;
  unpack<S>(src, m, o, &in, &masks, &out);
  const Coeffs<C> k = coeffs<C>(cH, cg);
  if (ndim == 2) {
    rmt_swe_step_kernel<S, 2><<<grid, block, 0, stream>>>(in, masks, out, n1, 1, box, off, k);
  } else {
    rmt_swe_step_kernel<S, 3><<<grid, block, 0, stream>>>(in, masks, out, n1, n2, box, off, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory a CTA of the cluster route: the mbarrier, two
// buffers of h (rows + 1 rows) and NDIM velocities (rows + 2 rows) in the
// compute type, and the NDIM face masks when staged.
template <typename S>
size_t resident_bytes(int ndim, int64_t rows, int64_t plane, int stage) {
  using C = typename Compute<S>::type;
  const size_t band = static_cast<size_t>(rows * plane);
  const size_t p = static_cast<size_t>(plane);
  const size_t state = 2 * ((band + p) + ndim * (band + 2 * p)) * sizeof(C);
  return rmt::kBarrierBytes + state + (stage ? ndim * band * sizeof(S) : 0);
}

// One cache a (dtype, rank): the cluster kernel's caps and the cooperative
// kernel's co-resident blocks, per device.
template <typename S, int NDIM>
rmt::CapsCache& caps_cache() {
  static rmt::CapsCache cache;
  return cache;
}

template <typename S, int NDIM>
int caps_of(int dev, int* out) {
  rmt::ClusterCaps caps;
  const cudaError_t err =
      rmt::cluster_caps(rmt_swe_multi_step_resident_kernel<S, NDIM>, dev, &caps_cache<S, NDIM>(), &caps);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = caps.cluster;
  out[1] = caps.smem_limit;
  return 0;
}

template <typename S, int NDIM>
int launch_multi(const void* const* src, const void* const* m, void* const* o, void* scratch,
                 int n_steps, int64_t n0, int64_t n1, int64_t n2, const double* cH,
                 const double* cg, int cluster, int stage, int dev, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  rmt::CapsCache& cache = caps_cache<S, NDIM>();
  StateIn<S> in;
  Masks<S> masks;
  StateOut<S> out;
  unpack<S>(src, m, o, &in, &masks, &out);
  Coeffs<C> k = coeffs<C>(cH, cg);
  cudaError_t err;
  if (cluster > 0) {
    auto kernel = rmt_swe_multi_step_resident_kernel<S, NDIM>;
    rmt::ClusterCaps caps;
    err = rmt::cluster_caps(kernel, dev, &cache, &caps);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t plane = n1 * n2;
    const size_t bytes =
        resident_bytes<S>(NDIM, (n0 + cluster - 1) / cluster, plane, stage);
    if (!rmt::plan_fits(caps, cluster, n0, bytes) || plane > (int64_t{1} << 30)) return -1;
    const int n_mid = NDIM == 2 ? 1 : static_cast<int>(n1);
    const int n_last = NDIM == 2 ? static_cast<int>(n1) : static_cast<int>(n2);
    err = rmt::launch_cluster(kernel, cluster, bytes, stream, in, masks, out, n_steps,
                              static_cast<int>(n0), n_mid, n_last, stage, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return -1;
  auto kernel = rmt_swe_multi_step_kernel<S, NDIM>;
  int fit = 0;
  err = rmt::coop_blocks(kernel, dev, kThreads, &cache, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1) return -3;
  const int64_t cells = n0 * n1 * n2;
  const int64_t want = (cells + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < fit ? want : fit);
  C* b0 = static_cast<C*>(scratch);
  C* b1 = b0 + (NDIM + 1) * cells;
  void* args[] = {&in, &masks, &out, &b0, &b1, &n_steps, &n0, &n1, &n2, &k};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int dispatch_multi(int ndim, const void* const* src, const void* const* m, void* const* o,
                   void* scratch, int n, int64_t n0, int64_t n1, int64_t n2,
                   const double* cH, const double* cg, int cluster, int stage, int dev,
                   cudaStream_t s) {
  if (ndim == 2)
    return launch_multi<S, 2>(src, m, o, scratch, n, n0, n1, 1, cH, cg, cluster, stage, dev, s);
  return launch_multi<S, 3>(src, m, o, scratch, n, n0, n1, n2, cH, cg, cluster, stage, dev, s);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (n0, n1,
// n2) are the core's extents, n2 = 1 in 2D; the third velocity, mask and
// output pointers and the third coefficients are unused in 2D; `stream` is
// a cudaStream_t. Return codes: 0 on success, >0 a CUDA error (the
// launch's, or cudaGetLastError() after it), -1 an unsupported dtype, rank,
// step count, box or plan, -2 a grid that overflows a launch dimension, -3 no
// co-resident block for the cooperative launch. Launches are asynchronous
// on `stream`; nothing here synchronises or allocates.

// Region form: the box is [lo, lo + e) per axis of the core; the sources
// (h, u0, u1, u2) are the core grown by `off` (0 or 1) cells on every axis;
// the masks and outputs have the core's extents and the outputs are
// written only inside the box.
extern "C" int rmt_swe_step(int dtype, int ndim, const void* h, const void* u0,
                            const void* u1, const void* u2, const void* m0, const void* m1,
                            const void* m2, void* oh, void* ou0, void* ou1, void* ou2,
                            int64_t n0, int64_t n1, int64_t n2, int64_t lo0, int64_t lo1,
                            int64_t lo2, int64_t e0, int64_t e1, int64_t e2, int off,
                            double cH0, double cH1, double cH2, double cg0, double cg1,
                            double cg2, void* stream) {
  const Box box{lo0, lo1, ndim == 2 ? 0 : lo2, e0, e1, ndim == 2 ? 1 : e2};
  if (!rmt::box_fits(box, off, ndim, n0, n1, n2)) return -1;
  const void* src[4] = {h, u0, u1, u2};
  const void* m[3] = {m0, m1, m2};
  void* o[4] = {oh, ou0, ou1, ou2};
  const double cH[3] = {cH0, cH1, cH2};
  const double cg[3] = {cg0, cg1, cg2};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_step<float>(ndim, src, m, o, n1, n2, box, off, cH, cg, s);
    case kF64:
      return launch_step<double>(ndim, src, m, o, n1, n2, box, off, cH, cg, s);
    case kBF16:
      return launch_step<__nv_bfloat16>(ndim, src, m, o, n1, n2, box, off, cH, cg, s);
    default:
      return -1;
  }
}

// The route is the caller's plan (ops/resident.py), made before the
// launch: `cluster` > 0 launches one cluster of that many CTAs (at most the
// size rmt_swe_multi_step_caps grants, and at most n0), with the face masks
// staged into shared memory when `stage`; a plan whose bytes a CTA exceed
// the card's limit returns -1, and `scratch` is not read. `cluster` == 0
// takes the cooperative route, whose `scratch` holds 2·(ndim+1)·n0·n1·n2
// elements of the compute type (f32 for bf16). `dev` is the current
// device's index. The outputs must not alias the inputs.
extern "C" int rmt_swe_multi_step(int dtype, int ndim, int n_steps, const void* h,
                                  const void* u0, const void* u1, const void* u2,
                                  const void* m0, const void* m1, const void* m2, void* oh,
                                  void* ou0, void* ou1, void* ou2, void* scratch, int64_t n0,
                                  int64_t n1, int64_t n2, double cH0, double cH1, double cH2,
                                  double cg0, double cg1, double cg2, int cluster, int stage,
                                  int dev, void* stream) {
  if ((ndim != 2 && ndim != 3) || n_steps < 1 || cluster < 0) return -1;
  const void* src[4] = {h, u0, u1, u2};
  const void* m[3] = {m0, m1, m2};
  void* o[4] = {oh, ou0, ou1, ou2};
  const double cH[3] = {cH0, cH1, cH2};
  const double cg[3] = {cg0, cg1, cg2};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_multi<float>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH, cg,
                                   cluster, stage, dev, s);
    case kF64:
      return dispatch_multi<double>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH, cg,
                                    cluster, stage, dev, s);
    case kBF16:
      return dispatch_multi<__nv_bfloat16>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH,
                                           cg, cluster, stage, dev, s);
    default:
      return -1;
  }
}

// What device `dev` (the current one) grants the cluster route of one
// (dtype, ndim): out[0] the largest cluster size (16, 8, or 0 for none),
// out[1] the dynamic shared memory a CTA may use. Asked once per device;
// the launches reuse the answer.
extern "C" int rmt_swe_multi_step_caps(int dtype, int ndim, int dev, int* out) {
  if (ndim != 2 && ndim != 3) return -1;
  switch (dtype) {
    case kF32: return ndim == 2 ? caps_of<float, 2>(dev, out) : caps_of<float, 3>(dev, out);
    case kF64: return ndim == 2 ? caps_of<double, 2>(dev, out) : caps_of<double, 3>(dev, out);
    case kBF16:
      return ndim == 2 ? caps_of<__nv_bfloat16, 2>(dev, out)
                       : caps_of<__nv_bfloat16, 3>(dev, out);
    default: return -1;
  }
}
