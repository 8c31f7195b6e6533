// Hand-written Hopper kernels of the heat-diffusion `kp` rung: one step as
// three launches on the staggered grid, from a width-1-padded 2D block Tp
// of shape (lx + 2, ly + 2), the reference's kernel-programming ladder
// (Flux!, Residual!, Update!).
//
//   rmt_kp_flux     — Fourier's law on the faces, q = -λ ∂T:
//                     qx[i, j] = ((-λ)·(Tp[i+1, j+1] - Tp[i, j+1]))·inv_d0,
//                     shape (lx + 1, ly);
//                     qy[i, j] = ((-λ)·(Tp[i+1, j+1] - Tp[i+1, j]))·inv_d1,
//                     shape (lx, ly + 1).
//                     Replaces rocm_mpi_tpu/ops/pallas_kernels.py
//                     _flux_kernel (the first pallas_call of
//                     kp_step_padded).
//   rmt_kp_residual — conservation of energy, dTdt = (-div)/Cp with
//                     div = (qx[i+1, j] - qx[i, j])·inv_d0
//                         + (qy[i, j+1] - qy[i, j])·inv_d1, shape (lx, ly).
//                     Replaces _residual_kernel.
//   rmt_kp_update   — out = Tp[i+1, j+1] + dt·dTdt[i, j]. Replaces
//                     _update_kernel.
//
// inv_d = 1/h (not 1/h²), λ and dt are doubles applied in the compute
// type, each kernel in its Pallas body's operation order, built with
// -fmad=false: every launch is bitwise equal to its plain PyTorch version
// (rocm_mpi_tpu_torch/ops/kp.py). bf16 is storage-only per launch: loads
// are widened to f32 and each store rounds, so qx, qy and dTdt are bf16
// between the launches, as the TPU kernels' outputs are.
//
// The three launches are the point of the rung: the fused `perf` kernel
// removes two of them and the two round trips of the intermediates through
// device memory, so they stay three kernels. Each is memory-bound (a few
// flops a cell against 3-4 field passes: flux reads Tp and writes qx, qy;
// the residual reads qx, qy, Cp and writes dTdt; the update reads Tp and
// dTdt and writes out). All three move 16 bytes of a row a lane (their
// design notes are at rmt_kp_flux_kernel, rmt_kp_residual_kernel and
// rmt_kp_update_kernel): at one cell a thread the flux read 0.46 of its
// bound in bf16 on an H100 and the residual 0.62, as masked_step did
// before it took 16 bytes a lane.

#include "stencil_common.cuh"

namespace {

using rmt::Compute;
using rmt::kBF16;
using rmt::kBlockX;
using rmt::kBlockY;
using rmt::kF32;
using rmt::kF64;
using rmt::narrow;
using rmt::widen;

// This thread's cell (i, j) of an (n0, n1) launch; false past the edge.
__device__ __forceinline__ bool cell(int64_t n0, int64_t n1, int64_t* i, int64_t* j) {
  *j = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  *i = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  return *i < n0 && *j < n1;
}

// kp_update: 16 bytes of a row a thread (4 f32, 2 f64, 8 bf16), one block
// row per core row (a grid-stride loop covers rows past the 65535 a grid
// holds). Two layouts:
// - `vec` (ly a multiple of the width, 16-byte-aligned dTdt and out, the
//   usual case): a thread moves its own 16 bytes of dTdt and out as one
//   vector each, with the streaming hints (each is touched once). Tp's
//   core rows start one element past a row of stride ly + 2, never on the
//   16-byte grid, so its window is read element by element and the L1
//   merges a warp's neighbouring requests.
// - otherwise (a ragged row): a warp's 32 threads take its 32·width
//   elements in turn, every access scalar and coalesced, the row's tail
//   masked.
// Measured on an H100 against the alternatives (realigning 16-byte chunks
// of Tp by warp shuffle; a persistent grid walking two or four rows a
// thread; hints on the scalar accesses; 32 bytes a thread; 128 or 512
// threads a block), this layout was the fastest or within noise of it.
constexpr int kUpdBytes = 16;
constexpr int kUpdThreads = 256;

template <typename S>
struct alignas(kUpdBytes) Chunk {
  static constexpr int kN = kUpdBytes / static_cast<int>(sizeof(S));
  S v[kN];
};

template <typename S>
__global__ void __launch_bounds__(kUpdThreads)
rmt_kp_update_kernel(const S* __restrict__ Tp, const S* __restrict__ dTdt, S* __restrict__ out,
              int64_t lx, int64_t ly, bool vec, typename Compute<S>::type dt) {
  using Ch = Chunk<S>;
  constexpr int kN = Ch::kN;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kUpdThreads + threadIdx.x;
  // vec: elements j0 .. j0 + kN - 1; else j0 + 32e for e < kN, where j0
  // is this lane's first element in its warp's 32·kN.
  const int64_t j0 = vec ? chunk * kN : (chunk - lane) * kN + lane;
  for (int64_t row = blockIdx.y; row < lx; row += gridDim.y) {
    const S* t = Tp + (row + 1) * (ly + 2) + 1;
    const S* r = dTdt + row * ly;
    S* w = out + row * ly;
    if (vec) {
      if (j0 >= ly) return;
      Ch d;
      *reinterpret_cast<int4*>(&d) = __ldcs(reinterpret_cast<const int4*>(r + j0));
      Ch o;
#pragma unroll
      for (int e = 0; e < kN; ++e) o.v[e] = narrow<S>(widen(t[j0 + e]) + dt * widen(d.v[e]));
      __stcs(reinterpret_cast<int4*>(w + j0), *reinterpret_cast<const int4*>(&o));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int64_t j = j0 + 32 * e;
        if (j < ly) w[j] = narrow<S>(widen(t[j]) + dt * widen(r[j]));
      }
    }
  }
}

// kp_flux: 16 bytes of a row a lane (kN cells: 4 f32, 2 f64, 8 bf16), a
// warp a strip of 32·kN consecutive columns walked down a run of qx rows.
// With R_r the core columns of Tp's row r (R_r[j] = Tp[r, j + 1], j = -1 ..
// ly), qx row i is R_{i+1} - R_i and qy row i is R_{i+1}[j] - R_{i+1}[j - 1]:
// each Tp row comes from memory once a run, loaded one row ahead, and is
// kept in registers as the next row's lo row. The left neighbour of qy
// comes from the lane beside by shuffle; lane 0 loads the strip's outer
// cell R[first - 1], which always lies in the row. qy's extra column j = ly
// lies in the last strip, or, when the strips end at ly, is lane 31's: it
// loads R[ly] as its outer cell. So one launch writes both outputs, the
// extra row and column included. Layouts (flux_layout below):
// - VEC (the wrapper allows it: ly a multiple of kN, qx on the 16-byte
//   grid, not f64, whose vectors measured slower than its scalar cells:
//   1.3260 ms against 1.2464-1.2468 at 12288²): kN consecutive
//   cells; qx stored as one 16-byte vector with the streaming hint; qy's
//   rows (stride ly + 1) are off the grid on every other row, so a warp
//   stages its qy row in shared memory and stores it as coalesced scalar
//   cells (cell first + 32e + lane);
// - scalar cells (a ragged row, qx off the grid, f64): kN cells lane + 32e
//   of the strip, every access scalar and coalesced;
// - and, for a field that gives fewer than kFluxFillWarps warps of 16-byte
//   lanes (the kp app's 128²), one cell a thread (rmt_kp_flux_cell_kernel
//   below).
// Tp's rows (stride ly + 2, core at offset 1) are never all on the 16-byte
// grid: in VEC a lane reads its kN cells element by element and the L1
// merges a warp's requests, as kp_update reads Tp. The alternative, a lane
// reading the aligned 16-byte chunk under its cells and realigning it with
// its neighbour's by shuffle and funnel shift, measured slower: 12288² f32
// 0.8101 ms against 0.6350, bf16 0.3567 against 0.3359-0.3360.
// Runs of up to kFluxRunRows qx rows (kFluxRunRowsBf16 in bf16), cut
// shorter until the launch has kFluxFillWarps warps, as masked_step cuts
// its runs: at 12288² runs of 4 took f32 0.6524 ms, f64 1.2819, bf16 0.3368
// against 0.6350, 1.2464-1.2468 and 0.3359-0.3360 for these (runs of one
// row, and three in bf16: a warp's second row saves a Tp row's read but
// costs warps).
// All figures: one call of scripts/torch_kernel_ab.py, device ms a launch,
// NVIDIA H100 80GB HBM3 at 700.00 W, the alternatives variant trees of
// this package timed beside it (--roots). At 12288², old against new: f32
// 0.7263-0.7264 → 0.6350 ms (0.74 → 0.85 of the bytes bound; an earlier
// call read 0.6362-0.6364), f64 1.2625-1.2636 → 1.2464-1.2468 (0.86 →
// 0.87), bf16 0.5919-0.5920 → 0.3359-0.3360 (0.46 → 0.81). Why f32 stays
// under masked_step's 0.91 is not measured apart; a guess is that qy's
// scalar stores off the 16-byte grid cost more than its third of the bytes.
constexpr int kFluxWarps = 4;         // warps a block: independent strips
constexpr int kFluxRunRows = 1;       // the longest run of qx rows a warp walks
constexpr int kFluxRunRowsBf16 = 3;   // the same in bf16
constexpr int kFluxFillWarps = 8192;  // fewer warps than this: shorter runs, then one cell a thread

template <typename S, bool VEC>
__global__ void __launch_bounds__(kFluxWarps * 32)
rmt_kp_flux_kernel(const S* __restrict__ Tp, S* __restrict__ qx, S* __restrict__ qy,
                   int64_t lx, int64_t ly, int64_t strips, int64_t items, int run_rows,
                   typename Compute<S>::type nlam, typename Compute<S>::type inv0,
                   typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  using Ch = Chunk<S>;
  constexpr int kN = Ch::kN;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int4 stage[VEC ? kFluxWarps : 1][32];  // VEC: a warp's qy row, restaged
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kFluxWarps + warp;
  if (item >= items) return;  // the whole warp: nothing below synchronises the block
  // item = run · strips + strip, in 32 bits where the launch fits them
  int64_t strip, run;
  if (items <= 0xffffffffLL) {
    const uint32_t it = static_cast<uint32_t>(item), st = static_cast<uint32_t>(strips);
    run = it / st;
    strip = it - static_cast<uint32_t>(run) * st;
  } else {
    run = item / strips;
    strip = item - run * strips;
  }
  const int64_t r0 = run * run_rows;
  const int64_t r1 = r0 + run_rows < lx + 1 ? r0 + run_rows : lx + 1;
  const int64_t ps = ly + 2;             // Tp's row stride
  const int64_t first = strip * 32 * kN;  // the strip's first column
  const int64_t col = first + (VEC ? lane * kN : lane);  // this lane's first cell
  const S* t = Tp + 1;                   // R_r[j] at t[r · ps + j]
  const S zero = narrow<S>(C(0));
  // This lane's cells of R_r (when `on`), 0 past column ly.
  auto row_of = [&](int64_t r, bool on) -> Ch {
    Ch v;
    const S* p = t + r * ps;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int64_t j = col + (VEC ? e : 32 * e);
      v.v[e] = on && j <= ly ? p[j] : zero;
    }
    return v;
  };
  // The strip's outer cells: lane 0's R[first - 1], and lane 31's R[ly]
  // where the strips end at ly (qy's extra column).
  const int64_t outer = lane == 0 ? first - 1 : first + 32 * kN;
  const bool outer_in = lane == 0 || (lane == 31 && outer == ly);
  auto edge_of = [&](int64_t r, bool on) -> S {
    return on && outer_in ? t[r * ps + outer] : zero;
  };
  Ch lo = row_of(r0, true);
  Ch hi = row_of(r0 + 1, true);
  S edge = edge_of(r0 + 1, true);
  for (int64_t i = r0; i < r1; ++i) {
    // The next row's loads, in flight while this one is computed.
    const bool more = i + 1 < r1;
    const Ch nx = row_of(i + 2, more);
    const S edge_nx = edge_of(i + 2, more);
    C h[kN];
    Ch ox;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      h[e] = widen(hi.v[e]);
      ox.v[e] = narrow<S>((nlam * (h[e] - widen(lo.v[e]))) * inv0);
    }
    S* wx = qx + i * ly;
    if constexpr (VEC) {
      if (col < ly) __stcs(reinterpret_cast<int4*>(wx + col), *reinterpret_cast<const int4*>(&ox));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (col + 32 * e < ly) wx[col + 32 * e] = ox.v[e];
    }
    if (i < lx) {  // qy row i, from R_{i+1} (the whole warp takes this branch)
      const C outer_v = widen(edge);
      C left[kN];  // R_{i+1} at cell - 1
      if constexpr (VEC) {
        const C from_l = __shfl_up_sync(kAll, h[kN - 1], 1);
#pragma unroll
        for (int e = 0; e < kN; ++e) left[e] = e > 0 ? h[e - 1] : (lane == 0 ? outer_v : from_l);
      } else {
        C rot_l[kN];  // cell e of the lane before (cyclic)
#pragma unroll
        for (int e = 0; e < kN; ++e) rot_l[e] = __shfl_sync(kAll, h[e], (lane + 31) & 31);
#pragma unroll
        for (int e = 0; e < kN; ++e)
          left[e] = lane > 0 ? rot_l[e] : (e > 0 ? rot_l[e - 1] : outer_v);
      }
      Ch oy;
#pragma unroll
      for (int e = 0; e < kN; ++e) oy.v[e] = narrow<S>((nlam * (h[e] - left[e])) * inv1);
      S* wy = qy + i * (ly + 1);
      if constexpr (VEC) {
        stage[warp][lane] = *reinterpret_cast<const int4*>(&oy);
        __syncwarp();
        const S* cells = reinterpret_cast<const S*>(stage[warp]);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const int64_t j = first + 32 * e + lane;
          if (j <= ly) wy[j] = cells[32 * e + lane];
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e)
          if (col + 32 * e <= ly) wy[col + 32 * e] = oy.v[e];
      }
      if (lane == 31 && outer == ly)
        wy[ly] = narrow<S>((nlam * (outer_v - h[kN - 1])) * inv1);
    }
    lo = hi;
    hi = nx;
    edge = edge_nx;
  }
}

// kp_flux, one cell a thread: (lx + 1, ly + 1) threads in 32x8 blocks
// along the last axis, each writing the faces its cell has, the neighbour
// reads from lines the block pulled into L1/L2: the kernel before the lane
// tiling. Below the fill the tiling's few warps each walk a longer chain
// with more registers (48-80 a thread against 16-18); at the kp app's 128²
// f64 the tiling took 0.0059 ms a launch against this form's 0.0055-0.0057
// (device ms, the same script and call), so the launcher keeps this form
// there.
template <typename S>
__global__ void __launch_bounds__(kBlockX * kBlockY)
rmt_kp_flux_cell_kernel(const S* __restrict__ Tp, S* __restrict__ qx, S* __restrict__ qy,
                        int64_t lx, int64_t ly, typename Compute<S>::type nlam,
                        typename Compute<S>::type inv0, typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  int64_t i, j;
  if (!cell(lx + 1, ly + 1, &i, &j)) return;
  const int64_t ps = ly + 2;  // row stride of Tp
  if (j < ly) {
    const C hi = widen(Tp[(i + 1) * ps + j + 1]);
    const C lo = widen(Tp[i * ps + j + 1]);
    qx[i * ly + j] = narrow<S>((nlam * (hi - lo)) * inv0);
  }
  if (i < lx) {
    const C hi = widen(Tp[(i + 1) * ps + j + 1]);
    const C lo = widen(Tp[(i + 1) * ps + j]);
    qy[i * (ly + 1) + j] = narrow<S>((nlam * (hi - lo)) * inv1);
  }
}

// kp_residual: the flux's walk (rmt_kp_flux_kernel above). A warp takes a
// strip of 32·kN consecutive columns (kN = 16 / itemsize cells a lane) down
// a run of core rows. Core row i reads qx rows i and i + 1: qx row i + 1 is
// loaded one row ahead and kept in registers as the next row's row i, so
// each qx row comes from memory once a run, not twice a cell as at one cell
// a thread. qy's rows (stride ly + 1) are off the 16-byte grid every other
// row: a lane reads its cells of qy row i element by element and the L1
// merges a warp's requests (realigning by shuffle measured 6-28 % slower
// for the flux's Tp, which sits the same way); the j + 1 neighbour comes
// from the lane beside by shuffle, and lane 31 loads the strip's extra cell
// qy[i, first + 32·kN] where it lies in the row. Layouts (residual_layout
// below), as the flux's:
// - VEC (the wrapper allows it: ly a multiple of kN, qx, Cp and dTdt on the
//   16-byte grid, not f64, whose vectors measured slower than its scalar
//   cells, below): kN consecutive cells; qx and
//   Cp loaded as 16-byte vectors, dTdt stored as one, Cp and dTdt with the
//   streaming hints (each is touched once);
// - scalar cells (a ragged row, an operand off the grid, f64): kN cells
//   lane + 32e of the strip, every access scalar and coalesced;
// - and, for a field that gives fewer than kResFillWarps warps of 16-byte
//   lanes (the kp app's 128²), one cell a thread
//   (rmt_kp_residual_cell_kernel below).
// Runs of up to kResRunRows core rows, cut shorter until the launch has
// kResFillWarps warps. Measured at 12288² (scripts/torch_kernel_ab.py
// --kernels kp_residual, device ms a launch, NVIDIA H100 80GB HBM3 at
// 700.00 W, the alternatives as variant trees of this package, one call):
// one cell a thread (the old kernel) f32 0.8319, f64 1.5368, bf16 0.5848;
// these layouts with runs of 4 rows f32 0.7726, f64 1.5367, bf16 0.4003,
// runs of one row (three in bf16) 0.7728, 1.5574, 0.4042; f64 as 16-byte
// vectors 1.6669. In a second call runs of 2 read 0.7809 / 1.5538 /
// 0.4184 and runs of 8 0.8070 / 1.6065 / 0.4098 against these 0.7838 /
// 1.5559 / 0.4077 (the old kernel there 0.8417 / 1.5574 / 0.5881). At the
// kp app's 128² every layout is at the launch floor: one cell a thread
// 0.0052-0.0054 ms device time in every dtype, an empty kernel's
// 0.0049-0.0050, so the launcher keeps it there.
constexpr int kResWarps = 4;          // warps a block: independent strips
constexpr int kResRunRows = 4;        // the longest run of core rows a warp walks
constexpr int kResRunRowsBf16 = 4;    // the same in bf16
constexpr int kResFillWarps = 8192;   // fewer warps than this: shorter runs, then one cell a thread

template <typename S, bool VEC>
__global__ void __launch_bounds__(kResWarps * 32)
rmt_kp_residual_kernel(const S* __restrict__ qx, const S* __restrict__ qy,
                       const S* __restrict__ Cp, S* __restrict__ dTdt, int64_t lx, int64_t ly,
                       int64_t strips, int64_t items, int run_rows,
                       typename Compute<S>::type inv0, typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  using Ch = Chunk<S>;
  constexpr int kN = Ch::kN;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kResWarps + (threadIdx.x >> 5);
  if (item >= items) return;  // the whole warp: nothing below synchronises the block
  int64_t strip, run;
  if (items <= 0xffffffffLL) {
    const uint32_t it = static_cast<uint32_t>(item), st = static_cast<uint32_t>(strips);
    run = it / st;
    strip = it - static_cast<uint32_t>(run) * st;
  } else {
    run = item / strips;
    strip = item - run * strips;
  }
  const int64_t r0 = run * run_rows;
  const int64_t r1 = r0 + run_rows < lx ? r0 + run_rows : lx;
  const int64_t first = strip * 32 * kN;                 // the strip's first column
  const int64_t col = first + (VEC ? lane * kN : lane);  // this lane's first cell
  const int64_t extra = first + 32 * kN;                 // qy's cell past the strip
  const S zero = narrow<S>(C(0));
  // This lane's cells of a row of `n` cells at p (0 past n).
  auto cells_of = [&](const S* p, int64_t n) -> Ch {
    Ch v;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int64_t j = col + (VEC ? e : 32 * e);
      v.v[e] = j < n ? p[j] : zero;
    }
    return v;
  };
  auto qx_of = [&](int64_t r) -> Ch {
    if constexpr (VEC) {
      Ch v;
      if (col < ly) {
        *reinterpret_cast<int4*>(&v) = *reinterpret_cast<const int4*>(qx + r * ly + col);
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) v.v[e] = zero;
      }
      return v;
    } else {
      return cells_of(qx + r * ly, ly);
    }
  };
  auto cp_of = [&](int64_t r) -> Ch {
    if constexpr (VEC) {
      Ch v;
      if (col < ly) {
        *reinterpret_cast<int4*>(&v) = __ldcs(reinterpret_cast<const int4*>(Cp + r * ly + col));
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) v.v[e] = zero;
      }
      return v;
    } else {
      return cells_of(Cp + r * ly, ly);
    }
  };
  // qy row r: this lane's cells j <= ly (the cell j = ly is a left lane's
  // j + 1), and lane 31's extra cell.
  auto qy_of = [&](int64_t r) -> Ch { return cells_of(qy + r * (ly + 1), ly + 1); };
  auto extra_of = [&](int64_t r) -> S {
    return lane == 31 && extra <= ly ? qy[r * (ly + 1) + extra] : zero;
  };
  Ch lo = qx_of(r0);
  Ch hi = qx_of(r0 + 1);
  Ch y = qy_of(r0);
  S y_extra = extra_of(r0);
  Ch cp = cp_of(r0);
  for (int64_t i = r0; i < r1; ++i) {
    // The next row's loads, in flight while this one is computed.
    const bool more = i + 1 < r1;
    Ch hi_nx, y_nx, cp_nx;
    S y_extra_nx = zero;
    if (more) {
      hi_nx = qx_of(i + 2);
      y_nx = qy_of(i + 1);
      y_extra_nx = extra_of(i + 1);
      cp_nx = cp_of(i + 1);
    }
    C yc[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) yc[e] = widen(y.v[e]);
    const C outer = widen(y_extra);
    C right[kN];  // qy at cell + 1
    if constexpr (VEC) {
      const C from_r = __shfl_down_sync(kAll, yc[0], 1);
#pragma unroll
      for (int e = 0; e < kN; ++e)
        right[e] = e + 1 < kN ? yc[e + 1] : (lane < 31 ? from_r : outer);
    } else {
      C rot_r[kN];  // cell e of the lane after (cyclic)
#pragma unroll
      for (int e = 0; e < kN; ++e) rot_r[e] = __shfl_sync(kAll, yc[e], (lane + 1) & 31);
#pragma unroll
      for (int e = 0; e < kN; ++e)
        right[e] = lane < 31 ? rot_r[e] : (e + 1 < kN ? rot_r[e + 1] : outer);
    }
    Ch o;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const C div = (widen(hi.v[e]) - widen(lo.v[e])) * inv0 + (right[e] - yc[e]) * inv1;
      o.v[e] = narrow<S>((-div) / widen(cp.v[e]));
    }
    S* w = dTdt + i * ly;
    if constexpr (VEC) {
      if (col < ly) __stcs(reinterpret_cast<int4*>(w + col), *reinterpret_cast<const int4*>(&o));
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e)
        if (col + 32 * e < ly) w[col + 32 * e] = o.v[e];
    }
    if (more) {
      lo = hi;
      hi = hi_nx;
      y = y_nx;
      y_extra = y_extra_nx;
      cp = cp_nx;
    }
  }
}

// kp_residual, one cell a thread: (lx, ly) threads in 32x8 blocks along the
// last axis, the neighbour reads served from lines the block already pulled
// into L1/L2 — the kernel before the lane tiling, kept for a field too small
// to fill the card with 16-byte lanes.
template <typename S>
__global__ void __launch_bounds__(kBlockX * kBlockY)
rmt_kp_residual_cell_kernel(const S* __restrict__ qx, const S* __restrict__ qy,
                            const S* __restrict__ Cp, S* __restrict__ dTdt, int64_t lx,
                            int64_t ly, typename Compute<S>::type inv0,
                            typename Compute<S>::type inv1) {
  using C = typename Compute<S>::type;
  int64_t i, j;
  if (!cell(lx, ly, &i, &j)) return;
  const int64_t idx = i * ly + j;
  const int64_t qy_idx = i * (ly + 1) + j;
  const C div = (widen(qx[idx + ly]) - widen(qx[idx])) * inv0 +
                (widen(qy[qy_idx + 1]) - widen(qy[qy_idx])) * inv1;
  dTdt[idx] = narrow<S>((-div) / widen(Cp[idx]));
}

// Grid of an (n0, n1) launch; false if empty or a dimension overflows.
bool grid_of(int64_t n0, int64_t n1, dim3* grid) {
  const int64_t gx = (n1 + kBlockX - 1) / kBlockX;
  const int64_t gy = (n0 + kBlockY - 1) / kBlockY;
  if (n0 < 1 || n1 < 1 || gx > 2147483647LL || gy > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
  return true;
}

template <typename S, bool VEC>
int launch_flux_nd(const S* Tp, S* qx, S* qy, int64_t lx, int64_t ly, double lam, double inv0,
                   double inv1, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  const int64_t strips = (ly + 32 * kN - 1) / (32 * kN);
  // Runs of kFluxRunRows qx rows (kFluxRunRowsBf16 in bf16), cut shorter
  // where the field gives fewer than kFluxFillWarps warps of them. A
  // cell's arithmetic does not depend on its run.
  const int64_t longest = sizeof(S) == 2 ? kFluxRunRowsBf16 : kFluxRunRows;
  int64_t run_rows = strips * (lx + 1) / kFluxFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > longest ? longest : run_rows;
  const int64_t items = strips * ((lx + 1 + run_rows - 1) / run_rows);
  const int64_t blocks = (items + kFluxWarps - 1) / kFluxWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_kp_flux_kernel<S, VEC><<<static_cast<unsigned>(blocks), kFluxWarps * 32, 0, stream>>>(
      Tp, qx, qy, lx, ly, strips, items, static_cast<int>(run_rows), C(-lam), C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

// The layout of a launch (0 scalar cells, 1 the 16-byte vectors, 2 one cell
// a thread): one cell a thread where the field gives fewer than
// kFluxFillWarps warps of 16-byte lanes (one qx row each), else the vectors
// where the wrapper allows them (`vectors`), else scalar cells.
template <typename S>
int flux_layout(int64_t lx, int64_t ly, bool vectors) {
  constexpr int kN = Chunk<S>::kN;
  const int64_t strips = (ly + 32 * kN - 1) / (32 * kN);
  if (strips * (lx + 1) < kFluxFillWarps) return 2;
  return vectors ? 1 : 0;
}

// A launch that allows the vectors where they do not fit (f64, ly no
// multiple of kN, qx off the 16-byte grid) is refused (-1) rather than
// misread.
template <typename S>
int launch_flux(const void* Tp, void* qx, void* qy, int64_t lx, int64_t ly, double lam,
                double inv0, double inv1, bool vectors, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  if (lx < 1 || ly < 1) return -2;
  if (vectors && (sizeof(S) == 8 || ly % kN != 0 ||
                  reinterpret_cast<uintptr_t>(qx) % kUpdBytes != 0))
    return -1;
  const auto* t = static_cast<const S*>(Tp);
  auto* x = static_cast<S*>(qx);
  auto* y = static_cast<S*>(qy);
  switch (flux_layout<S>(lx, ly, vectors)) {
    case 0:
      return launch_flux_nd<S, false>(t, x, y, lx, ly, lam, inv0, inv1, stream);
    case 1:
      if constexpr (sizeof(S) < 8)
        return launch_flux_nd<S, true>(t, x, y, lx, ly, lam, inv0, inv1, stream);
      return -1;
    default: {
      dim3 grid;
      if (!grid_of(lx + 1, ly + 1, &grid)) return -2;
      rmt_kp_flux_cell_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
          t, x, y, lx, ly, C(-lam), C(inv0), C(inv1));
      return static_cast<int>(cudaGetLastError());
    }
  }
}

template <typename S, bool VEC>
int launch_residual_nd(const S* qx, const S* qy, const S* Cp, S* dTdt, int64_t lx, int64_t ly,
                       double inv0, double inv1, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  const int64_t strips = (ly + 32 * kN - 1) / (32 * kN);
  // Runs of kResRunRows core rows (kResRunRowsBf16 in bf16), cut shorter
  // where the field gives fewer than kResFillWarps warps of them. A cell's
  // arithmetic does not depend on its run.
  const int64_t longest = sizeof(S) == 2 ? kResRunRowsBf16 : kResRunRows;
  int64_t run_rows = strips * lx / kResFillWarps;
  run_rows = run_rows < 1 ? 1 : run_rows > longest ? longest : run_rows;
  const int64_t items = strips * ((lx + run_rows - 1) / run_rows);
  const int64_t blocks = (items + kResWarps - 1) / kResWarps;
  if (blocks > 2147483647LL) return -2;
  rmt_kp_residual_kernel<S, VEC><<<static_cast<unsigned>(blocks), kResWarps * 32, 0, stream>>>(
      qx, qy, Cp, dTdt, lx, ly, strips, items, static_cast<int>(run_rows), C(inv0), C(inv1));
  return static_cast<int>(cudaGetLastError());
}

// The layout of a residual launch (0 scalar cells, 1 the 16-byte vectors, 2
// one cell a thread): one cell a thread where the field gives fewer than
// kResFillWarps warps of 16-byte lanes (one core row each), else the
// vectors where the wrapper allows them (`vectors`), else scalar cells.
template <typename S>
int residual_layout(int64_t lx, int64_t ly, bool vectors) {
  constexpr int kN = Chunk<S>::kN;
  const int64_t strips = (ly + 32 * kN - 1) / (32 * kN);
  if (strips * lx < kResFillWarps) return 2;
  return vectors ? 1 : 0;
}

// A launch that allows the vectors where they do not fit (f64, ly no
// multiple of kN, qx, Cp or dTdt off the 16-byte grid) is refused (-1)
// rather than misread.
template <typename S>
int launch_residual(const void* qx, const void* qy, const void* Cp, void* dTdt, int64_t lx,
                    int64_t ly, double inv0, double inv1, bool vectors, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  if (lx < 1 || ly < 1) return -2;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(qx) | reinterpret_cast<uintptr_t>(Cp) |
                         reinterpret_cast<uintptr_t>(dTdt);
  if (vectors && (sizeof(S) == 8 || ly % kN != 0 || bits % kUpdBytes != 0)) return -1;
  const auto* x = static_cast<const S*>(qx);
  const auto* y = static_cast<const S*>(qy);
  const auto* c = static_cast<const S*>(Cp);
  auto* o = static_cast<S*>(dTdt);
  switch (residual_layout<S>(lx, ly, vectors)) {
    case 0:
      return launch_residual_nd<S, false>(x, y, c, o, lx, ly, inv0, inv1, stream);
    case 1:
      if constexpr (sizeof(S) < 8)
        return launch_residual_nd<S, true>(x, y, c, o, lx, ly, inv0, inv1, stream);
      return -1;
    default: {
      dim3 grid;
      if (!grid_of(lx, ly, &grid)) return -2;
      rmt_kp_residual_cell_kernel<S><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
          x, y, c, o, lx, ly, C(inv0), C(inv1));
      return static_cast<int>(cudaGetLastError());
    }
  }
}

template <typename S>
int launch_update(const void* Tp, const void* dTdt, void* out, int64_t lx, int64_t ly,
                  double dt, cudaStream_t stream) {
  using C = typename Compute<S>::type;
  constexpr int kN = Chunk<S>::kN;
  if (lx < 1 || ly < 1) return -2;
  // One block row per core row; a block covers 256 chunks of the row.
  const int64_t gx = ((ly + kN - 1) / kN + kUpdThreads - 1) / kUpdThreads;
  const int64_t gy = lx < 65535 ? lx : 65535;
  if (gx > 2147483647LL) return -2;
  const bool vec = ly % kN == 0 && reinterpret_cast<uintptr_t>(dTdt) % kUpdBytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kUpdBytes == 0;
  rmt_kp_update_kernel<S><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1),
                     kUpdThreads, 0, stream>>>(
      static_cast<const S*>(Tp), static_cast<const S*>(dTdt), static_cast<S*>(out), lx, ly,
      vec, C(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. `dtype` is 0 f32, 1 f64, 2 bf16; (lx, ly)
// is the core's shape (Tp is (lx + 2, ly + 2)); `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch, -1 for an unsupported dtype,
// -2 for an empty core or a grid that overflows a launch dimension. The
// launch is asynchronous on `stream`; nothing here synchronises or
// allocates.
// kp_flux: `vectors` allows the 16-byte vectors (f32 and bf16, ly a
// multiple of 16 bytes, qx on the 16-byte grid; -1 otherwise); the launch
// takes them unless the field is too small to fill the card that way.
extern "C" int rmt_kp_flux(int dtype, const void* Tp, void* qx, void* qy, int64_t lx,
                           int64_t ly, double lam, double inv0, double inv1, int vectors,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32: return launch_flux<float>(Tp, qx, qy, lx, ly, lam, inv0, inv1, v, s);
    case kF64: return launch_flux<double>(Tp, qx, qy, lx, ly, lam, inv0, inv1, v, s);
    case kBF16:
      return launch_flux<__nv_bfloat16>(Tp, qx, qy, lx, ly, lam, inv0, inv1, v, s);
    default: return -1;
  }
}

// The layout a kp_flux launch of these arguments takes: 0 scalar cells, 1
// the 16-byte vectors, 2 one cell a thread; -1 for an unsupported dtype.
extern "C" int rmt_kp_flux_layout(int dtype, int64_t lx, int64_t ly, int vectors) {
  switch (dtype) {
    case kF32: return flux_layout<float>(lx, ly, vectors != 0);
    case kF64: return flux_layout<double>(lx, ly, vectors != 0);
    case kBF16: return flux_layout<__nv_bfloat16>(lx, ly, vectors != 0);
    default: return -1;
  }
}

// kp_residual: `vectors` allows the 16-byte vectors (f32 and bf16, ly a
// multiple of 16 bytes, qx, Cp and dTdt on the 16-byte grid; -1
// otherwise); the launch takes them unless the field is too small to fill
// the card that way.
extern "C" int rmt_kp_residual(int dtype, const void* qx, const void* qy, const void* Cp,
                               void* dTdt, int64_t lx, int64_t ly, double inv0, double inv1,
                               int vectors, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32: return launch_residual<float>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, v, s);
    case kF64: return launch_residual<double>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, v, s);
    case kBF16:
      return launch_residual<__nv_bfloat16>(qx, qy, Cp, dTdt, lx, ly, inv0, inv1, v, s);
    default: return -1;
  }
}

// The layout a kp_residual launch of these arguments takes, coded as
// rmt_kp_flux_layout's.
extern "C" int rmt_kp_residual_layout(int dtype, int64_t lx, int64_t ly, int vectors) {
  switch (dtype) {
    case kF32: return residual_layout<float>(lx, ly, vectors != 0);
    case kF64: return residual_layout<double>(lx, ly, vectors != 0);
    case kBF16: return residual_layout<__nv_bfloat16>(lx, ly, vectors != 0);
    default: return -1;
  }
}

extern "C" int rmt_kp_update(int dtype, const void* Tp, const void* dTdt, void* out,
                             int64_t lx, int64_t ly, double dt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_update<float>(Tp, dTdt, out, lx, ly, dt, s);
    case kF64: return launch_update<double>(Tp, dTdt, out, lx, ly, dt, s);
    case kBF16: return launch_update<__nv_bfloat16>(Tp, dTdt, out, lx, ly, dt, s);
    default: return -1;
  }
}
