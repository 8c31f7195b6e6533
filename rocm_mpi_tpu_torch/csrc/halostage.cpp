// Native host-staged halo-exchange engine — the PyTorch port's copy of
// native/halostage.cpp (the JAX package's engine). From the "Semantics"
// paragraph on, this file is that one byte for byte;
// tests/test_torch_host_staged.py holds the two equal.
//
// Role in the stack: the native engine of the host-staged oracle (the
// reference's IGG_ROCMAWARE_MPI=0 path, where halos are staged through host
// memory instead of handed device-direct to the interconnect). The Python
// HostStagedStepper (rocm_mpi_tpu_torch/parallel/halo.py) is the readable
// oracle; this library is its native engine: the same
// pack → stage → unpack → per-shard-update cycle, but multithreaded C++
// with one thread pool task per shard. Built with g++ at first use and
// loaded via ctypes; see rocm_mpi_tpu_torch/parallel/native_halo.py.
//
// Semantics (must stay bit-identical to HostStagedStepper.step):
//   * global row-major field T of `ndim` (2 or 3) axes, shard grid `dims`,
//     non-overlapping shards of shape global/dims;
//   * each shard assembles a width-1 padded block: core memcpy'd, face
//     ghosts copied from neighbor shards through host memory, missing
//     ghosts (domain edge) zero;
//   * fused 5/7-point update: out = T + dt*lam/Cp * laplacian;
//   * global-boundary cells are Dirichlet-fixed (never updated).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDim = 3;

struct Geom {
  int ndim;
  int64_t shape[kMaxDim];   // global cells per axis
  int64_t dims[kMaxDim];    // shard grid
  int64_t local[kMaxDim];   // shape / dims
  int64_t stride[kMaxDim];  // row-major strides of the global array
  double inv_d2[kMaxDim];
  double lam, dt;
};

inline int64_t gidx(const Geom& g, const int64_t* c) {
  int64_t off = 0;
  for (int a = 0; a < g.ndim; ++a) off += c[a] * g.stride[a];
  return off;
}

// Update one shard (cartesian coords `sc`) of the global field.
void update_shard(const Geom& g, const double* T, const double* Cp,
                  double* out, const int64_t* sc) {
  // Padded block: local + 2 per axis, zero-initialized (edge ghosts).
  int64_t pshape[kMaxDim], pstride[kMaxDim];
  int64_t pelems = 1;
  for (int a = 0; a < g.ndim; ++a) pshape[a] = g.local[a] + 2;
  for (int a = g.ndim - 1; a >= 0; --a) {
    pstride[a] = (a == g.ndim - 1) ? 1 : pstride[a + 1] * pshape[a + 1];
  }
  for (int a = 0; a < g.ndim; ++a) pelems *= pshape[a];
  std::vector<double> block(pelems, 0.0);

  int64_t lo[kMaxDim];  // global origin of this shard
  for (int a = 0; a < g.ndim; ++a) lo[a] = sc[a] * g.local[a];

  // Stage row-wise: the last axis is stride-1 in both the global field and
  // the padded block, so every staged row is one contiguous memcpy. A cell
  // of the padded block at p (0..local+1) maps to global coord lo + p - 1.
  // Core rows copy their core columns plus the in-domain last-axis face
  // ghosts; face-ghost rows (exactly one non-last axis outside the core)
  // copy core columns only; edge/corner rows are never read by the
  // 5/7-point stencil and stay zero.
  const int last = g.ndim - 1;
  int64_t p[kMaxDim] = {0};
  auto stage = [&](auto&& self, int axis) -> void {
    if (axis == last) {
      int64_t gcoord[kMaxDim];
      int outside = 0;
      for (int a = 0; a < last; ++a) {
        gcoord[a] = lo[a] + p[a] - 1;
        if (gcoord[a] < 0 || gcoord[a] >= g.shape[a]) return;  // off-domain
        if (p[a] == 0 || p[a] == g.local[a] + 1) ++outside;
      }
      if (outside > 1) return;  // edge/corner row: not read, skip
      // Padded last-axis positions [first, stop) to stage for this row.
      int64_t first = 1, stop = g.local[last] + 1;
      if (outside == 0) {  // core row: include in-domain face ghosts
        if (lo[last] > 0) first = 0;
        if (lo[last] + g.local[last] < g.shape[last]) stop = g.local[last] + 2;
      }
      gcoord[last] = lo[last] + first - 1;
      int64_t poff = first;
      for (int a = 0; a < last; ++a) poff += p[a] * pstride[a];
      std::memcpy(&block[poff], &T[gidx(g, gcoord)],
                  static_cast<size_t>(stop - first) * sizeof(double));
      return;
    }
    if (axis >= kMaxDim) return;  // unreachable; bounds recursion depth
    for (p[axis] = 0; p[axis] < g.local[axis] + 2; ++p[axis]) {
      self(self, axis + 1);
    }
  };
  stage(stage, 0);

  // Per-shard fused update from the staged block.
  int64_t c[kMaxDim];
  auto update = [&](auto&& self, int axis) -> void {
    if (axis == g.ndim) {
      int64_t gcoord[kMaxDim], poff = 0;
      bool boundary = false;
      for (int a = 0; a < g.ndim; ++a) {
        gcoord[a] = lo[a] + c[a];
        poff += (c[a] + 1) * pstride[a];
        if (gcoord[a] == 0 || gcoord[a] == g.shape[a] - 1) boundary = true;
      }
      int64_t go = gidx(g, gcoord);
      if (boundary) {  // Dirichlet: global edge cells never change
        out[go] = T[go];
        return;
      }
      double lap = 0.0, center = block[poff];
      for (int a = 0; a < g.ndim; ++a) {
        lap += (block[poff + pstride[a]] - 2.0 * center +
                block[poff - pstride[a]]) *
               g.inv_d2[a];
      }
      out[go] = center + g.dt * g.lam / Cp[go] * lap;
      return;
    }
    if (axis >= kMaxDim) return;  // unreachable; bounds recursion depth
    for (c[axis] = 0; c[axis] < g.local[axis]; ++c[axis]) {
      self(self, axis + 1);
    }
  };
  update(update, 0);
}

}  // namespace

extern "C" {

// One host-staged diffusion step. Returns 0 on success, nonzero on invalid
// geometry. `threads` <= 0 means hardware concurrency.
int rmt_host_staged_step(const double* T, const double* Cp, double* out,
                         const int64_t* shape, const int64_t* dims, int ndim,
                         const double* inv_d2, double lam, double dt,
                         int threads) {
  if (ndim < 1 || ndim > kMaxDim) return 1;
  Geom g;
  g.ndim = ndim;
  g.lam = lam;
  g.dt = dt;
  int64_t nshards = 1;
  for (int a = 0; a < ndim; ++a) {
    if (shape[a] <= 0 || dims[a] <= 0 || shape[a] % dims[a] != 0) return 2;
    g.shape[a] = shape[a];
    g.dims[a] = dims[a];
    g.local[a] = shape[a] / dims[a];
    g.inv_d2[a] = inv_d2[a];
    nshards *= dims[a];
  }
  for (int a = ndim - 1; a >= 0; --a) {
    g.stride[a] = (a == ndim - 1) ? 1 : g.stride[a + 1] * g.shape[a + 1];
  }

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = threads > 0 ? threads : (hw ? static_cast<int>(hw) : 1);
  if (nthreads > nshards) nthreads = static_cast<int>(nshards);

  auto worker = [&](int64_t first, int64_t last) {
    for (int64_t s = first; s < last; ++s) {
      int64_t sc[kMaxDim], rem = s;
      for (int a = ndim - 1; a >= 0; --a) {
        sc[a] = rem % g.dims[a];
        rem /= g.dims[a];
      }
      update_shard(g, T, Cp, out, sc);
    }
  };

  if (nthreads <= 1) {
    worker(0, nshards);
  } else {
    std::vector<std::thread> pool;
    int64_t per = (nshards + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int64_t first = t * per;
      int64_t last = first + per > nshards ? nshards : first + per;
      if (first >= last) break;
      pool.emplace_back(worker, first, last);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Version/capability probe for the ctypes loader.
int rmt_abi_version() { return 1; }

}  // extern "C"
