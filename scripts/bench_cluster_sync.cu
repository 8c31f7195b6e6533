// What a step of a cluster-resident loop pays to synchronise its CTAs, on
// one CUDA card of compute capability 9.0 (csrc/resident.cuh's design rests
// on these numbers).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o bench_cluster_sync scripts/bench_cluster_sync.cu && ./bench_cluster_sync
//
// One cluster of 16 CTAs (8 where the card grants no more) loops n steps;
// each step every thread stores one word into the next CTA's shared memory
// (a DSMEM store, as a halo exchange does) and then synchronises by:
//
//   cluster.sync      cooperative_groups' cluster barrier (arrive.release,
//                     wait.acquire: a cluster-scope release fence);
//   relaxed barrier   barrier.cluster.arrive.relaxed + wait: the barrier
//                     alone, which orders no memory;
//   syncthreads       a CTA barrier only.
//
// The time a step is (t(n2) − t(n1)) / (n2 − n1) from CUDA events around
// single launches, so the launch's own cost cancels; the launch of 10 steps
// is printed too. Threads a CTA: 256, 512, 1024.

#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

enum Mode : int { kClusterSync = 0, kRelaxed = 1, kSyncthreads = 2 };

template <int MODE>
__global__ void loop(int n, float* sink) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  float* next = cluster.map_shared_rank(sm, (cluster.block_rank() + 1) % cluster.num_blocks());
  float acc = static_cast<float>(threadIdx.x);
  for (int i = 0; i < n; ++i) {
    next[threadIdx.x] = acc;
    if (MODE == kClusterSync) {
      cluster.sync();
    } else if (MODE == kRelaxed) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
    }
    acc += sm[(threadIdx.x + 1) % blockDim.x];
  }
  cluster.sync();
  if (acc == -1.0f) sink[0] = acc;
}

template <int MODE>
float launch_ms(int ctas, int threads, int n, float* sink) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = threads * sizeof(float);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, loop<MODE>, n, sink);  // warm
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, loop<MODE>, n, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}

template <int MODE>
int report(const char* name, int ctas, float* sink) {
  cudaFuncSetAttribute(loop<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int threads : {256, 512, 1024}) {
    const int n1 = 10, n2 = 20010;
    const float t1 = launch_ms<MODE>(ctas, threads, n1, sink);
    const float t2 = launch_ms<MODE>(ctas, threads, n2, sink);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      std::printf("%s: %s\n", name, cudaGetErrorString(err));
      return 1;
    }
    std::printf("%-16s %2d CTAs x %4d threads: %.4f us a step (a launch of %d steps %.4f ms)\n",
                name, ctas, threads, (t2 - t1) * 1e3f / (n2 - n1), n1, t1);
  }
  return 0;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess || prop.major < 9) {
    std::printf("needs a CUDA card of compute capability 9.0 or later\n");
    return 1;
  }
  float* sink = nullptr;
  cudaMalloc(&sink, sizeof(float));
  int ctas = 16;
  {
    cudaFuncSetAttribute(loop<kClusterSync>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(1024);
    cfg.dynamicSmemBytes = 1024 * sizeof(float);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, loop<kClusterSync>, &cfg) != cudaSuccess ||
        active < 1) {
      cudaGetLastError();
      ctas = 8;
    }
  }
  std::printf("%s, clusters of %d CTAs\n", prop.name, ctas);
  int rc = report<kClusterSync>("cluster.sync", ctas, sink);
  rc |= report<kRelaxed>("relaxed barrier", ctas, sink);
  rc |= report<kSyncthreads>("syncthreads", ctas, sink);
  cudaFree(sink);
  return rc;
}
