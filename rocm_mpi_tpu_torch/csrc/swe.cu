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
// not bytes. rmt_swe_multi_step runs on blocks of at most 2 MiB of state,
// where a step is under a microsecond of work: it keeps the design of
// rmt_wave_multi_step — a persistent cooperative launch, the state in L2
// in two compute-type buffers of ndim+1 fields, one grid barrier a step,
// __ldcg reads. Recomputing the high neighbours' h' from the old buffer
// lets one barrier separate the steps (h' and u' of a step need no
// barrier between them); the barrier is what the loop pays per step.

#include <cooperative_groups.h>

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
swe_step_kernel(StateIn<S> src, Masks<S> masks, StateOut<S> out, int64_t n1, int64_t n2,
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
swe_multi_step_kernel(StateIn<S> in, Masks<S> masks, StateOut<S> out,
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
    swe_step_kernel<S, 2><<<grid, block, 0, stream>>>(in, masks, out, n1, 1, box, off, k);
  } else {
    swe_step_kernel<S, 3><<<grid, block, 0, stream>>>(in, masks, out, n1, n2, box, off, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NDIM>
int launch_multi(const void* const* src, const void* const* m, void* const* o, void* scratch,
                 int n_steps, int64_t n0, int64_t n1, int64_t n2, const double* cH,
                 const double* cg, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  auto kernel = swe_multi_step_kernel<S, NDIM>;
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

  StateIn<S> in;
  Masks<S> masks;
  StateOut<S> out;
  unpack<S>(src, m, o, &in, &masks, &out);
  Coeffs<C> k = coeffs<C>(cH, cg);
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
                   const double* cH, const double* cg, cudaStream_t s) {
  if (ndim == 2) return launch_multi<S, 2>(src, m, o, scratch, n, n0, n1, 1, cH, cg, s);
  return launch_multi<S, 3>(src, m, o, scratch, n, n0, n1, n2, cH, cg, s);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (n0, n1,
// n2) are the core's extents, n2 = 1 in 2D; the third velocity, mask and
// output pointers and the third coefficients are unused in 2D; `stream` is
// a cudaStream_t. Return codes: 0 on success, >0 a CUDA error (the
// launch's, or cudaGetLastError() after it), -1 an unsupported dtype, rank,
// step count or box, -2 a grid that overflows a launch dimension, -3 no
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

// `scratch` holds 2·(ndim+1)·n0·n1·n2 elements of the compute type (f32 for
// bf16). The outputs must not alias the inputs.
extern "C" int rmt_swe_multi_step(int dtype, int ndim, int n_steps, const void* h,
                                  const void* u0, const void* u1, const void* u2,
                                  const void* m0, const void* m1, const void* m2, void* oh,
                                  void* ou0, void* ou1, void* ou2, void* scratch, int64_t n0,
                                  int64_t n1, int64_t n2, double cH0, double cH1, double cH2,
                                  double cg0, double cg1, double cg2, void* stream) {
  if ((ndim != 2 && ndim != 3) || n_steps < 1) return -1;
  const void* src[4] = {h, u0, u1, u2};
  const void* m[3] = {m0, m1, m2};
  void* o[4] = {oh, ou0, ou1, ou2};
  const double cH[3] = {cH0, cH1, cH2};
  const double cg[3] = {cg0, cg1, cg2};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_multi<float>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH, cg, s);
    case kF64:
      return dispatch_multi<double>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH, cg, s);
    case kBF16:
      return dispatch_multi<__nv_bfloat16>(ndim, src, m, o, scratch, n_steps, n0, n1, n2, cH,
                                           cg, s);
    default:
      return -1;
  }
}
