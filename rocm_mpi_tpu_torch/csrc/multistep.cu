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
// the whole chunk. On Hopper a 316² f32 deep block (400 KB), or the 252²
// field with two ping-pong copies, is larger than one SM's 227 KB of
// shared memory, so the block lives in L2 instead (50 MB): a persistent
// cooperative launch (no more blocks than fit on the card at once) runs
// the steps, ping-ponging between two compute-type buffers the wrapper
// allocates, with a grid-wide barrier (cooperative_groups grid sync)
// between steps. Steps read those buffers with __ldcg (L2, never a stale
// L1 line). The A/c/eqc coefficients are recomputed from Cm in each step
// rather than kept in prologue arrays: the same operations on the same
// operands give the same bits, and one read of Cm is fewer bytes than
// reading A and c. Bound: neither bytes nor flops — at these sizes a step
// is a few hundred nanoseconds of work, and the grid barrier between
// steps (about a microsecond) is what the loop pays.
//
// rmt_tb_sweep — design. The Hopper reading of the TPU's stripe and
// ghost-block light cone: each block loads a core tile plus a halo of k
// cells on every side into shared memory — T, and Cm beside it, both zero
// beyond the block's edge — runs k steps there ping-ponging two T
// buffers, and writes only its core tile. Cells of the tile's outer ring
// see zeros instead of their true neighbours; that error moves inward one
// cell per step and after k steps has not reached the core (k <= halo,
// the _tb_kernel contract k <= g). Cells beyond the block's edge hold
// T = 0 and Cm = 0, so each step leaves them exactly 0 (0 + 0·lap) and
// cells next to the edge see the same zeros as the plain version. Cm sits
// in shared memory because reading it from L2 every step left the warps
// waiting on that load. The TPU's (g, tm) stripe geometry is not carried
// over. A 2D tile is 128 columns (a tile row is four warps wide) by as
// many rows, in multiples of 8, as fit the shared-memory target; each
// warp walks its rows top to bottom keeping the cells above and at the
// current row in registers, so a cell step loads three neighbours and Cm
// from shared memory. A 3D tile starts at 16³ of core and halves its
// largest axis until the buffers fit all of a block's shared memory (at
// k = 8, an 8x8x16 core in f32, 4x4x8 in f64: the halo dominates, and a 3D
// sweep does far more redundant work than a 2D one). Bound: memory — one read of T and
// Cm and one write per k steps; the redundant halo work and the
// shared-memory traffic are what this simple design pays on top.

#include <cooperative_groups.h>

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
// Shared memory a tb_sweep block aims to stay under, so that two blocks
// share an SM (228 KB each, 1 KB of it reserved per block); tiles shrink
// until they fit it.
constexpr int kTileSmemTarget = 112 * 1024;
// Columns of a 2D tb_sweep tile: four warps wide.
constexpr int kTileCols = 128;

enum Form : int { kDirect = 0, kAC = 1, kEQC = 2, kCOnly = 3 };

// One step of one cell in body form FORM. `t` is the cell, `cm` its
// coefficient, p_ax = (neighbour at +1) + (neighbour at -1) along axis ax
// (the TPU kernel's roll(T,-1,ax) + roll(T,1,ax)). Operation order as in
// _multi_step_kernel:
//   direct: lap = Σ_ax (p_ax - 2t)·inv_ax;          t + cm·lap
//   A/c:    c_ax = cm·inv_ax, A = 1 - 2·((c0 + c1) + c2);
//           ((A·t + c0·p0) + c1·p1) + c2·p2
//   eqc:    c = cm·inv0, s = (p0 + p1) + p2;        (1 - 2nd·c)·t + c·s
//   conly:  c = cm·inv0;                            t + c·(s - 2nd·t)
template <typename C, int NDIM, int FORM>
__device__ __forceinline__ C update(C t, C cm, C p0, C p1, C p2, C inv0,
                                    C inv1, C inv2) {
  const C two = C(2);
  if (FORM == kDirect) {
    C lap = (p0 - two * t) * inv0;
    lap = lap + (p1 - two * t) * inv1;
    if (NDIM == 3) lap = lap + (p2 - two * t) * inv2;
    return t + cm * lap;
  } else if (FORM == kAC) {
    const C c0 = cm * inv0;
    const C c1 = cm * inv1;
    C sum = c0 + c1;
    C c2 = C(0);
    if (NDIM == 3) {
      c2 = cm * inv2;
      sum = sum + c2;
    }
    const C a = C(1) - two * sum;
    C acc = a * t;
    acc = acc + c0 * p0;
    acc = acc + c1 * p1;
    if (NDIM == 3) acc = acc + c2 * p2;
    return acc;
  } else {
    const C c = cm * inv0;
    C s = p0 + p1;
    if (NDIM == 3) s = s + p2;
    const C nd2 = C(2 * NDIM);
    if (FORM == kEQC) {
      const C coef = C(1) - nd2 * c;
      return coef * t + c * s;
    }
    return t + c * (s - nd2 * t);
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
multi_step_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
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
      const C v = update<C, NDIM, FORM>(t, widen(Cm[i]), p0, p1, p2, inv0, inv1, inv2);
      if (last) {
        out[i] = narrow<S>(v);
      } else {
        dst[i] = v;
      }
    }
    if (!last) grid.sync();
  }
}

template <typename S, int NDIM, int FORM>
int launch_multi_step(const void* T, const void* Cm, void* out, void* scratch,
                      int n_steps, int64_t n0, int64_t n1, int64_t n2,
                      double inv0, double inv1, double inv2,
                      cudaStream_t stream) {
  using C = typename Compute<S>::type;
  auto kernel = multi_step_kernel<S, NDIM, FORM>;
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

  const S* t = static_cast<const S*>(T);
  const S* cm = static_cast<const S*>(Cm);
  S* o = static_cast<S*>(out);
  C* b0 = static_cast<C*>(scratch);
  C* b1 = b0 + cells;
  C c0 = C(inv0), c1 = C(inv1), c2 = C(inv2);
  void* args[] = {&t, &cm, &o, &b0, &b1, &n_steps, &n0, &n1, &n2, &c0, &c1, &c2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NDIM>
int dispatch_form(int form, const void* T, const void* Cm, void* out,
                  void* scratch, int n_steps, int64_t n0, int64_t n1,
                  int64_t n2, double inv0, double inv1, double inv2,
                  cudaStream_t s) {
  switch (form) {
    case kDirect:
      return launch_multi_step<S, NDIM, kDirect>(T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    case kAC:
      return launch_multi_step<S, NDIM, kAC>(T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    case kEQC:
      return launch_multi_step<S, NDIM, kEQC>(T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    case kCOnly:
      return launch_multi_step<S, NDIM, kCOnly>(T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}

template <typename S>
int dispatch_ndim(int ndim, int form, const void* T, const void* Cm,
                  void* out, void* scratch, int n_steps, int64_t n0,
                  int64_t n1, int64_t n2, double inv0, double inv1,
                  double inv2, cudaStream_t s) {
  if (ndim == 2)
    return dispatch_form<S, 2>(form, T, Cm, out, scratch, n_steps, n0, n1, 1, inv0, inv1, 0.0, s);
  return dispatch_form<S, 3>(form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
}

// ---------------------------------------------------------------------------
// rmt_tb_sweep
// ---------------------------------------------------------------------------

// 2D: one step of the tile. Warp w walks rows [w·R, (w+1)·R) of the tile
// top to bottom, its lanes on neighbouring columns (conflict-free shared
// loads); a lane keeps the cells above and at the current row in
// registers, so a cell step loads three neighbours and its Cm.
template <typename C>
__device__ __forceinline__ void tb_step_2d(const C* a, C* b, const C* cm, int e0,
                                           int e1, C inv0, C inv1) {
  const C zero = C(0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const int rows = (e0 + kWarps - 1) / kWarps;
  const int r_begin = warp * rows;
  const int r_end = r_begin + rows < e0 ? r_begin + rows : e0;
  if (r_begin >= r_end) return;
  for (int c = lane; c < e1; c += 32) {
    C up = r_begin > 0 ? a[(r_begin - 1) * e1 + c] : zero;
    C cen = a[r_begin * e1 + c];
    for (int r = r_begin; r < r_end; ++r) {
      const int j = r * e1 + c;
      const C down = r + 1 < e0 ? a[j + e1] : zero;
      const C left = c > 0 ? a[j - 1] : zero;
      const C right = c + 1 < e1 ? a[j + 1] : zero;
      b[j] = update<C, 2, kDirect>(cen, cm[j], down + up, right + left, zero, inv0,
                                   inv1, zero);
      up = cen;
      cen = down;
    }
  }
}

// Tile coordinates (j0, j1, j2) of tile cell j over extents (e0, e1, e2).
__device__ __forceinline__ void tile_coords(int j, int e1, int e2, int* j0,
                                            int* j1, int* j2) {
  *j0 = j / (e1 * e2);
  const int r = j - *j0 * (e1 * e2);
  *j1 = r / e2;
  *j2 = r - *j1 * e2;
}

template <typename S, int NDIM>
__global__ void __launch_bounds__(kThreads)
tb_sweep_kernel(const S* __restrict__ T, const S* __restrict__ Cm,
                S* __restrict__ out, int k, int64_t n0, int64_t n1,
                int64_t n2, int t0, int t1, int t2,
                typename Compute<S>::type inv0,
                typename Compute<S>::type inv1,
                typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Tile = core (t0, t1, t2) plus k halo cells per side on each of the
  // NDIM axes (axis 2 has extent 1 and no halo in 2D).
  const int e0 = t0 + 2 * k;
  const int e1 = t1 + 2 * k;
  const int e2 = NDIM == 3 ? t2 + 2 * k : 1;
  const int tile = e0 * e1 * e2;
  C* a = reinterpret_cast<C*>(smem_raw);
  C* b = a + tile;
  C* cm = b + tile;
  // Block coordinates of tile cell (0, 0, 0).
  int64_t o0, o1, o2;
  if (NDIM == 2) {
    o0 = static_cast<int64_t>(blockIdx.y) * t0 - k;
    o1 = static_cast<int64_t>(blockIdx.x) * t1 - k;
    o2 = 0;
  } else {
    o0 = static_cast<int64_t>(blockIdx.z) * t0 - k;
    o1 = static_cast<int64_t>(blockIdx.y) * t1 - k;
    o2 = static_cast<int64_t>(blockIdx.x) * t2 - k;
  }
  const int64_t s1 = n2;
  const int64_t s0 = n1 * n2;
  const C zero = C(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  if (NDIM == 2) {
    // Rows by warp, columns by lane: coalesced loads, no index division.
    for (int r = warp; r < e0; r += kWarps) {
      const int64_t g0 = o0 + r;
      const bool row_in = g0 >= 0 && g0 < n0;
      for (int c = lane; c < e1; c += 32) {
        const int64_t g1 = o1 + c;
        const bool inside = row_in && g1 >= 0 && g1 < n1;
        const int64_t g = g0 * n1 + g1;
        a[r * e1 + c] = inside ? widen(T[g]) : zero;
        cm[r * e1 + c] = inside ? widen(Cm[g]) : zero;
      }
    }
  } else {
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      int j0, j1, j2;
      tile_coords(j, e1, e2, &j0, &j1, &j2);
      const int64_t g0 = o0 + j0, g1 = o1 + j1, g2 = o2 + j2;
      const bool inside = g0 >= 0 && g0 < n0 && g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
      const int64_t g = g0 * s0 + g1 * s1 + g2;
      a[j] = inside ? widen(T[g]) : zero;
      cm[j] = inside ? widen(Cm[g]) : zero;
    }
  }
  __syncthreads();

  const int st0 = e1 * e2;  // tile strides
  const int st1 = e2;
  for (int step = 0; step < k; ++step) {
    if (NDIM == 2) {
      tb_step_2d<C>(a, b, cm, e0, e1, inv0, inv1);
    } else {
      for (int j = threadIdx.x; j < tile; j += blockDim.x) {
        int j0, j1, j2;
        tile_coords(j, e1, e2, &j0, &j1, &j2);
        const C p0 = (j0 + 1 < e0 ? a[j + st0] : zero) + (j0 > 0 ? a[j - st0] : zero);
        const C p1 = (j1 + 1 < e1 ? a[j + st1] : zero) + (j1 > 0 ? a[j - st1] : zero);
        const C p2 = (j2 + 1 < e2 ? a[j + 1] : zero) + (j2 > 0 ? a[j - 1] : zero);
        b[j] = update<C, NDIM, kDirect>(a[j], cm[j], p0, p1, p2, inv0, inv1, inv2);
      }
    }
    __syncthreads();
    C* swap = a;
    a = b;
    b = swap;
  }

  if (NDIM == 2) {
    for (int r = warp; r < t0; r += kWarps) {
      const int64_t g0 = o0 + k + r;
      if (g0 >= n0) break;
      for (int c = lane; c < t1; c += 32) {
        const int64_t g1 = o1 + k + c;
        if (g1 < n1) out[g0 * n1 + g1] = narrow<S>(a[(r + k) * e1 + c + k]);
      }
    }
  } else {
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
}

// Shared bytes of a tile: two T buffers and Cm, each (core + 2k) cells
// per axis of the compute type.
template <typename C>
int64_t tile_bytes(int ndim, int k, const int* t) {
  int64_t cells = 1;
  for (int ax = 0; ax < ndim; ++ax) cells *= t[ax] + 2 * k;
  return 3 * cells * static_cast<int64_t>(sizeof(C));
}

template <typename S, int NDIM>
int launch_tb(int k, const void* T, const void* Cm, void* out, int64_t n0,
              int64_t n1, int64_t n2, double inv0, double inv1, double inv2,
              cudaStream_t stream) {
  using C = typename Compute<S>::type;
  auto kernel = tb_sweep_kernel<S, NDIM>;
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int t[3] = {16, 16, 16};
  if (NDIM == 2) {
    // kTileCols columns; rows a multiple of 8 (one per warp and pass),
    // as many as fit the target, at least 2k + 8.
    const int64_t row_bytes = 3 * kTileCols * static_cast<int64_t>(sizeof(C));
    int e0 = static_cast<int>(kTileSmemTarget / row_bytes) / 8 * 8;
    if (e0 > 96) e0 = 96;
    if (e0 < 2 * k + 8) e0 = 2 * k + 8;
    t[0] = e0 - 2 * k;
    t[1] = kTileCols - 2 * k;
    t[2] = 1;
  } else {
    // 3D: the halo is most of the tile, so take the largest tile shared
    // memory holds (one block per SM) rather than two smaller ones.
    while (tile_bytes<C>(NDIM, k, t) > optin) {
      int big = 0;
      for (int ax = 1; ax < NDIM; ++ax)
        if (t[ax] > t[big]) big = ax;
      if (t[big] == 1) break;
      t[big] /= 2;
    }
  }
  const int64_t smem = tile_bytes<C>(NDIM, k, t);
  if (smem > optin) return -3;  // the light cone does not fit shared memory
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t last = NDIM == 2 ? n1 : n2;
  const int64_t second = NDIM == 2 ? n0 : n1;
  const int64_t gx = (last + t[NDIM - 1] - 1) / t[NDIM - 1];
  const int64_t gy = (second + t[NDIM - 2] - 1) / t[NDIM - 2];
  const int64_t gz = NDIM == 2 ? 1 : (n0 + t[0] - 1) / t[0];
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return -2;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(Cm), static_cast<S*>(out),
      k, n0, n1, n2, t[0], t[1], t[2], C(inv0), C(inv1), C(inv2));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int tb_ndim(int ndim, int k, const void* T, const void* Cm, void* out,
            int64_t n0, int64_t n1, int64_t n2, double inv0, double inv1,
            double inv2, cudaStream_t s) {
  if (ndim == 2) return launch_tb<S, 2>(k, T, Cm, out, n0, n1, 1, inv0, inv1, 0.0, s);
  return launch_tb<S, 3>(k, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; shapes
// are the block's extents, n2 = 1 in 2D; `stream` is a cudaStream_t.
// Return codes: 0 on success, >0 a CUDA error (the launch's, or
// cudaGetLastError() after it), -1 an unsupported dtype, rank, form or
// step count, -2 a grid that overflows a launch dimension, -3 a launch
// that cannot fit (no co-resident block; a light cone larger than shared
// memory). Launches are asynchronous on `stream`; nothing here allocates.

// `form`: 0 direct, 1 A/c, 2 eqc, 3 conly. `scratch` holds 2·n0·n1·n2
// elements of the compute type (f32 for bf16). `out` must not alias `T`.
extern "C" int rmt_multi_step_cm(int dtype, int ndim, int form, int n_steps,
                                 const void* T, const void* Cm, void* out,
                                 void* scratch, int64_t n0, int64_t n1,
                                 int64_t n2, double inv0, double inv1,
                                 double inv2, void* stream) {
  if ((ndim != 2 && ndim != 3) || n_steps < 1) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_ndim<float>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    case kF64:
      return dispatch_ndim<double>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    case kBF16:
      return dispatch_ndim<__nv_bfloat16>(ndim, form, T, Cm, out, scratch, n_steps, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}

// `k` direct-form steps, 1 <= k <= 16. `out` must not alias `T`.
extern "C" int rmt_tb_sweep(int dtype, int ndim, int k, const void* T,
                            const void* Cm, void* out, int64_t n0, int64_t n1,
                            int64_t n2, double inv0, double inv1, double inv2,
                            void* stream) {
  if ((ndim != 2 && ndim != 3) || k < 1 || k > 16) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return tb_ndim<float>(ndim, k, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kF64:
      return tb_ndim<double>(ndim, k, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    case kBF16:
      return tb_ndim<__nv_bfloat16>(ndim, k, T, Cm, out, n0, n1, n2, inv0, inv1, inv2, s);
    default:
      return -1;
  }
}
