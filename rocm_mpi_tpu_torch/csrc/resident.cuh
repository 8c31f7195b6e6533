// The cluster-resident loop shared by the multi-step kernels (multistep.cu,
// wave.cu, swe.cu): one thread-block cluster of C CTAs holds a whole block in its
// distributed shared memory for every step of a launch, the CTAs trading
// their bands' edge rows through their mbarriers (the halo exchange, below)
// instead of meeting at a barrier each step.
//
// The band plan. CTA r of the cluster owns the band of rows [start, start +
// rows) along axis 0 (a "row" is a plane of n1·n2 cells in 3D): the first
// n0 % C bands hold ceil(n0 / C) rows, the rest floor(n0 / C), so every band
// holds at least one row when C <= n0. Each CTA lays its shared memory out
// for `rows_max` = ceil(n0 / C) rows, so the same offset names the same row
// field in every CTA and a neighbour's edge row is found by the neighbour's
// own band size. The plan (C, and whether the read-only operands are staged
// into shared memory) is made by the caller, ops/resident.py, from the card's
// capacity that `cluster_caps` reports; the launchers recompute the bytes a
// CTA and refuse a plan that does not fit.
//
// The host path. `cluster_caps` sets the kernel's attributes (the opt-in
// dynamic shared memory limit, non-portable cluster sizes) and asks the
// occupancy calculator which cluster size, 16 or 8 CTAs at the full shared
// memory of a CTA, the card grants; `coop_blocks` asks the same once for a
// cooperative launch. Each caches its answer per device in a cache that
// belongs to the kernel's instantiation, so a launch after the first one
// makes no runtime query.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "stencil_common.cuh"

namespace rmt {

// Threads a CTA of the cluster route. A step is bound by the latency of
// each lane's chain of shared-memory reads and arithmetic, which more warps
// hide: 1024 threads read faster than 512 at 252² on an H100, though the
// cap of 64 registers a thread makes the f64 instantiations spill a few
// words (nvcc -Xptxas -v).
constexpr int kResidentThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int kClusterSizes[2] = {16, 8};  // tried in this order

// Band of CTA `rank` in a cluster of `nc` over `n0` rows.
struct Band {
  int start;     // first row
  int rows;      // rows owned
  int rows_max;  // rows of the largest band: the shared memory layout's
};

__host__ __device__ __forceinline__ Band band_of(int n0, int nc, int rank) {
  const int base = n0 / nc;
  const int rem = n0 - base * nc;
  Band b;
  b.start = rank * base + (rank < rem ? rank : rem);
  b.rows = base + (rank < rem ? 1 : 0);
  b.rows_max = base + (rem > 0 ? 1 : 0);
  return b;
}

// What a device grants one instantiation of a cluster kernel: the largest
// cluster size (16 or 8; 0 when neither is granted) at `smem_limit` bytes of
// dynamic shared memory a CTA, the device's opt-in limit.
struct ClusterCaps {
  int cluster;
  int smem_limit;
};

// Per-device caches, one of each per kernel instantiation (a static in the
// launcher's template). `known` is written last, so a reader that sees it
// set sees the values; two threads that race compute the same values.
struct CapsCache {
  ClusterCaps caps[kMaxDevices];
  int blocks[kMaxDevices];  // co-resident blocks of the cooperative launch
  volatile bool known[kMaxDevices];
  volatile bool coop_known[kMaxDevices];
};

template <typename Kernel>
cudaError_t cluster_caps(Kernel kernel, int dev, CapsCache* cache, ClusterCaps* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache->known[dev]) {
    *out = cache->caps[dev];
    return cudaSuccess;
  }
  ClusterCaps caps{0, 0};
  cudaError_t err =
      cudaDeviceGetAttribute(&caps.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               caps.smem_limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  for (int c : kClusterSizes) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kResidentThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(caps.smem_limit);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) == cudaSuccess && active >= 1) {
      caps.cluster = c;
      break;
    }
    cudaGetLastError();  // a size the card refuses is an answer, not a fault
  }
  cache->caps[dev] = caps;
  cache->known[dev] = true;
  *out = caps;
  return cudaSuccess;
}

// Co-resident blocks of `threads` threads for a cooperative launch of
// `kernel` on device `dev`: SMs × blocks a SM, asked once per device.
template <typename Kernel>
cudaError_t coop_blocks(Kernel kernel, int dev, int threads, CapsCache* cache, int* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache->coop_known[dev]) {
    int sms = 0;
    int per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    cache->blocks[dev] = sms * per_sm;
    cache->coop_known[dev] = true;
  }
  *out = cache->blocks[dev];
  return cudaSuccess;
}

// Launch `kernel` as one cluster of `c` CTAs of kResidentThreads threads,
// with `bytes` of dynamic shared memory a CTA.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int c, size_t bytes,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kResidentThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Validates a cluster plan of `c` CTAs over n0 rows against the caps:
// 1 <= c <= the granted size and c <= n0, `bytes` within the limit.
inline bool plan_fits(const ClusterCaps& caps, int c, int64_t n0, size_t bytes) {
  return c >= 1 && c <= caps.cluster && c <= n0 && n0 <= (int64_t{1} << 30) &&
         bytes <= static_cast<size_t>(caps.smem_limit);
}

// The halo exchange between steps. A CTA writes each new edge row
// straight into the neighbour's halo row with st.async, which counts the
// bytes on the neighbour's mbarrier (complete_tx); the neighbour waits on
// its own mbarrier for the bytes it expects before it reads them. This is
// the whole synchronisation between CTAs after the prologue: a cluster
// barrier a step would cost a cluster-scope release fence (MEMBAR.ALL.GPU)
// on top of the barrier, most of a step at these sizes
// (scripts/bench_cluster_sync.cu). The reuse of a halo row
// two steps later is safe because each value a CTA pushes depends on the
// halo rows it read: the neighbour cannot push step s + 2 into a row before
// it has received, and so this CTA has read, everything of step s + 1 that
// depends on that row. Two mbarriers take the halos of even and odd steps,
// so that the pushes of step s + 1, which may start as soon as a neighbour
// has this CTA's pushes of step s, never count towards step s's phase. A
// phase is one step's halo: one local arrival (arrive.expect_tx with the
// bytes), made before this CTA's pushes of the step before, so before any
// neighbour can push into it, and the neighbours' complete_tx.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address) in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The local arrival of a phase, with the bytes it expects.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete. A halo that never arrives is
// a bug: after about a second of waiting the kernel traps (the launch fails)
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// Stores `v` at shared::cluster address `addr`, counting its bytes on the
// mbarrier at shared::cluster address `bar` (both in the same CTA).
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void push(uint32_t addr, double v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                   addr),
               "l"(__double_as_longlong(v)), "r"(bar)
               : "memory");
}

// Dynamic shared memory of a CTA: the two mbarriers, then the buffers.
constexpr int kBarrierBytes = 16;

// Copies src1[0, n1) and src2[0, n2) (device memory) to dst1 and dst2
// (shared memory), widened to the compute type when WIDEN, with
// kLoadsInFlight loads of each a thread issued before the first store, so
// that the band's load pays the memory's latency a few times, not once for
// each element a thread copies. n2 = 0 copies one array.
constexpr int kLoadsInFlight = 8;

template <bool WIDEN, typename D, typename S>
__device__ __forceinline__ void load_bands(D* dst1, const S* __restrict__ src1, int n1,
                                           D* dst2, const S* __restrict__ src2, int n2) {
  const int n = n1 > n2 ? n1 : n2;
  const int step = static_cast<int>(blockDim.x);
  for (int j0 = threadIdx.x; j0 < n; j0 += kLoadsInFlight * step) {
    S v1[kLoadsInFlight];
    S v2[kLoadsInFlight];
#pragma unroll
    for (int k = 0; k < kLoadsInFlight; ++k) {
      const int j = j0 + k * step;
      if (j < n1) v1[k] = src1[j];
      if (j < n2) v2[k] = src2[j];
    }
#pragma unroll
    for (int k = 0; k < kLoadsInFlight; ++k) {
      const int j = j0 + k * step;
      if constexpr (WIDEN) {
        if (j < n1) dst1[j] = widen(v1[k]);
        if (j < n2) dst2[j] = widen(v2[k]);
      } else {
        if (j < n1) dst1[j] = v1[k];
        if (j < n2) dst2[j] = v2[k];
      }
    }
  }
}

// Zeroes dst[0, n) (shared memory).
template <typename D>
__device__ __forceinline__ void zero_rows(D* dst, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = D(0);
}

// The walk of a band. A lane owns one cell of the last (contiguous) axis
// and walks down a run of consecutive rows of it, keeping the cells above
// and below in registers (as multistep.cu's tb_sweep does), so that a step
// reads each row of the band once from shared memory. A warp-column is 32
// consecutive cells of the last axis (at one middle index in 3D): ncol =
// n_mid · ceil(n_last / 32) of them. The band's rows × ncol (row,
// warp-column) items, column by column, are cut into one slice a warp of at
// most `per_warp` items; a warp walks its slice as runs, one a warp-column
// it touches (usually one or two). A slice's start is worked out once a
// launch, so a step walks it with no integer division.
struct Walk {
  int rows, n_mid, n_last, chunks, per_warp, total;

  // Where a warp's slice starts: item `it` (row r0 of warp-column (mi, ch))
  // and where it stops.
  struct Slice {
    int it, stop, r0, mi, ch;
  };

  __device__ __forceinline__ Walk(int rows_, int n_mid_, int n_last_, int warps)
      : rows(rows_), n_mid(n_mid_), n_last(n_last_), chunks((n_last_ + 31) >> 5) {
    total = rows * n_mid * chunks;
    per_warp = (total + warps - 1) / warps;
  }

  __device__ __forceinline__ Slice slice(int warp) const {
    Slice s;
    s.it = min(warp * per_warp, total);
    s.stop = min(s.it + per_warp, total);
    const int col = rows > 0 ? s.it / rows : 0;
    s.r0 = s.it - col * rows;
    s.mi = col / chunks;
    s.ch = col - s.mi * chunks;
    return s;
  }

  // A slice's runs, walked as
  //   for (int it = s.it, r0 = s.r0, m = s.mi, wc = s.ch; it < s.stop;
  //        walk.next(s, &it, &r0, &m, &wc)) { r1 = walk.run_end(s, it, r0); … }
  // rows [r0, r1) of warp-column (m, wc); the lane's last index is wc·32 +
  // lane, and the lanes past the ragged end of the last axis skip the run.
  // (A plain loop, not a lambda: the kernels' restrict-qualified buffers
  // keep their qualifier, and the loads of one row can be issued ahead of
  // the store of the row before.)
  __device__ __forceinline__ int run_end(const Slice& s, int it, int r0) const {
    return min(rows, r0 + (s.stop - it));
  }
  __device__ __forceinline__ void next(const Slice& s, int* it, int* r0, int* mi,
                                       int* ch) const {
    *it += run_end(s, *it, *r0) - *r0;
    *r0 = 0;
    if (++*ch == chunks) {
      *ch = 0;
      ++*mi;
    }
  }

  // A slice walked cell by cell rather than run by run: s.stop - s.it
  // cells, the first at row s.r0 of warp-column (s.mi, s.ch); each call
  // moves (r, mi, ch) to the next, and a new run starts where r comes back
  // to 0.
  __device__ __forceinline__ void next_cell(int* r, int* mi, int* ch) const {
    if (++*r == rows) {
      *r = 0;
      if (++*ch == chunks) {
        *ch = 0;
        ++*mi;
      }
    }
  }
};

}  // namespace rmt
