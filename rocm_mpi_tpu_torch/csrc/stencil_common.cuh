// Shared pieces of the hand-written stencil kernels (stencil.cu, wave.cu,
// multistep.cu): the dtype codes, bf16's storage-only widening, and the
// thread layout of the one-cell-per-thread kernels over a box of the core.
//
// bf16 is storage-only: loads are widened to f32, the update is computed
// in f32 and rounded to bf16 once on store (pallas_kernels._upcast_for_compute).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rmt {

constexpr int kBlockX = 32;  // along the last, contiguous axis
constexpr int kBlockY = 8;   // along the second-to-last axis

enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename S> struct Compute { using type = S; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S> __device__ __forceinline__ S narrow(typename Compute<S>::type v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A box of the core (the shard): cells [lo, lo + e) on each axis. A 2D
// field is seen as (n0, n1, 1), with lo2 = 0 and e2 = 1.
struct Box {
  int64_t lo0, lo1, lo2;
  int64_t e0, e1, e2;
};

// Shard coordinates (i0, i1, i2) of this thread's cell of `box`: x runs
// along the last axis, y along the second-to-last, z over axis 0 in 3D.
// Returns false for threads past the box's ragged edge.
template <int NDIM>
__device__ __forceinline__ bool box_cell(const Box& b, int64_t* i0, int64_t* i1,
                                         int64_t* i2) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t j0 = NDIM == 2 ? y : static_cast<int64_t>(blockIdx.z);
  const int64_t j1 = NDIM == 2 ? x : y;
  const int64_t j2 = NDIM == 2 ? 0 : x;
  if (j0 >= b.e0 || j1 >= b.e1 || j2 >= b.e2) return false;
  *i0 = b.lo0 + j0;
  *i1 = b.lo1 + j1;
  *i2 = b.lo2 + j2;
  return true;
}

// Index maps of a region launch. The core arrays (out and the core-only
// operands) have extents (n0, n1, n2); the stencil source is the core grown
// by `off` cells on every axis (off = 1: the width-1 padded buffer of the
// halo exchange; off = 0: the raw shard, for boxes whose stencil never
// leaves it). 2D: n2 == 1 and axis 2 is neither grown nor offset.
template <int NDIM>
struct Region {
  int64_t s0, s1;    // strides of the core arrays' axes 0 and 1
  int64_t ps0, ps1;  // strides of the source's axes 0 and 1
  int off;

  __device__ __forceinline__ Region(int64_t n1, int64_t n2, int off_) : off(off_) {
    s1 = n2;
    s0 = n1 * n2;
    ps1 = NDIM == 3 ? n2 + 2 * off : 1;
    ps0 = (n1 + 2 * off) * ps1;
  }
  __device__ __forceinline__ int64_t core(int64_t i0, int64_t i1, int64_t i2) const {
    return i0 * s0 + i1 * s1 + i2;
  }
  __device__ __forceinline__ int64_t src(int64_t i0, int64_t i1, int64_t i2) const {
    return (i0 + off) * ps0 + (i1 + off) * ps1 + (NDIM == 3 ? i2 + off : 0);
  }
};

// lap = sum_ax ((hi - 2c) + lo) * inv_ax at source index p, with c the
// widened cell value — pallas_kernels._lap_from_padded's order.
template <typename S, int NDIM>
__device__ __forceinline__ typename Compute<S>::type lap_at(
    const S* __restrict__ src, const Region<NDIM>& r, int64_t p,
    typename Compute<S>::type c, typename Compute<S>::type inv0,
    typename Compute<S>::type inv1, typename Compute<S>::type inv2) {
  using C = typename Compute<S>::type;
  const C two = C(2);
  C lap = ((widen(src[p + r.ps0]) - two * c) + widen(src[p - r.ps0])) * inv0;
  lap = lap + ((widen(src[p + r.ps1]) - two * c) + widen(src[p - r.ps1])) * inv1;
  if (NDIM == 3) lap = lap + ((widen(src[p + 1]) - two * c) + widen(src[p - 1])) * inv2;
  return lap;
}

// True when `box` lies inside the core (n0, n1, n2) and, read from a source
// grown by `off` (0 or 1) cells, its stencil stays inside that source.
inline bool box_fits(const Box& b, int off, int ndim, int64_t n0, int64_t n1,
                     int64_t n2) {
  if ((ndim != 2 && ndim != 3) || (off != 0 && off != 1)) return false;
  const int64_t lo[3] = {b.lo0, b.lo1, b.lo2};
  const int64_t e[3] = {b.e0, b.e1, b.e2};
  const int64_t n[3] = {n0, n1, n2};
  for (int ax = 0; ax < ndim; ++ax) {
    if (lo[ax] < 0 || e[ax] < 1 || lo[ax] + e[ax] > n[ax]) return false;
    if (off == 0 && (lo[ax] < 1 || lo[ax] + e[ax] > n[ax] - 1)) return false;
  }
  return true;
}

// Grid of a region launch over box extents (e0, e1, e2). Returns false if
// a launch dimension overflows or the box is empty.
inline bool box_grid(int ndim, const Box& b, dim3* grid) {
  const int64_t last = ndim == 2 ? b.e1 : b.e2;
  const int64_t second = ndim == 2 ? b.e0 : b.e1;
  const int64_t gx = (last + kBlockX - 1) / kBlockX;
  const int64_t gy = (second + kBlockY - 1) / kBlockY;
  const int64_t gz = ndim == 2 ? 1 : b.e0;
  if (gx < 1 || gy < 1 || gz < 1) return false;
  if (gx > 2147483647LL || gy > 65535 || gz > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
               static_cast<unsigned>(gz));
  return true;
}

}  // namespace rmt
