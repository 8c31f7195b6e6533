"""The sharded scan driver of the port (rocm_mpi_tpu_torch/models/scan.py
`scan_route` and the capture, parallel/halo.py's persistent exchange
buffers) on the CPU:

* the route table: CUDA graphs on one CUDA rank and on CUDA ranks over
  NCCL, the eager loop over gloo, the eager schedule on one CPU rank; the
  models hand the process group's backend to it;
* the capture runs in the thread-local mode, and a capture that fails
  raises instead of falling back to the eager loop (a stand-in for
  torch.cuda's graph capture);
* on 4 gloo ranks against the JAX package on 4 CPU devices: the reworked
  exchange's ghosts and wire state in 2D and 3D, widths 1 and 4, every
  wire mode; from its second call on, a stateless exchange reuses the
  same send and receive buffers and allocates nothing;
* on 4 gloo ranks, run(driver="scan") bitwise equal to run(driver="step")
  for every per-step variant the scan driver takes, with the f32 and the
  bf16 wire, in 2D and 3D.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rank_worker as rank_worker
import test_torch_transport_worker as worker
from rocm_mpi_tpu.parallel import wire as jwire
from rocm_mpi_tpu.parallel.halo import exchange_halo as jax_exchange_halo
from rocm_mpi_tpu.parallel.mesh import init_global_grid as jax_grid
from rocm_mpi_tpu.utils.compat import shard_map
from rocm_mpi_tpu_torch.models import scan
from rocm_mpi_tpu_torch.ops import kernels
from rocm_mpi_tpu_torch.parallel import wire
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

NPROCS = 4
STEPS = 3
CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")

# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

ROUTES = [
    (CUDA, 1, None, "scan-graph"), (CUDA, 1, "nccl", "scan-graph"),
    (CUDA, 1, "gloo", "scan-graph"), (CUDA, 2, "nccl", "scan-graph"),
    (CUDA, 4, "nccl", "scan-graph"), (CUDA, 4, "gloo", "scan-loop"),
    (CUDA, 2, "gloo", "scan-loop"), (CPU, 4, "gloo", "scan-loop"), (CPU, 2, "gloo", "scan-loop"),
    (CPU, 1, None, "scan-eager"), (CPU, 1, "gloo", "scan-eager"),
]


@pytest.mark.parametrize("device, nprocs, backend, route", ROUTES)
def test_scan_route_table(device, nprocs, backend, route):
    assert scan.scan_route(device, nprocs, backend) == route


@pytest.mark.parametrize("name", ["diffusion", "wave", "swe"])
def test_models_hand_the_backend_to_the_route(monkeypatch, name):
    # A 2×2 grid seen from rank 0 in a process with no group: the model asks
    # scan_route with the group's backend and the grid's rank count.
    import importlib

    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.parallel import distributed

    module = importlib.import_module(f"rocm_mpi_tpu_torch.models.{name}")
    asked = []

    def spy(device, nprocs, backend):
        asked.append((device, nprocs, backend))
        return scan.scan_route(device, nprocs, backend)

    monkeypatch.setattr(module, "scan_route", spy)
    monkeypatch.setattr(distributed, "backend", lambda: "nccl")
    model_cls, cfg_cls = {"diffusion": (HeatDiffusion, DiffusionConfig),
                          "wave": (AcousticWave, WaveConfig),
                          "swe": (ShallowWater, SWEConfig)}[name]
    cfg = cfg_cls(global_shape=(32, 24), nt=24, warmup=8, dtype="f64", dims=(2, 2))
    grid = init_global_grid(32, 24, dims=(2, 2), nprocs=4, rank=0)
    advance, _ = model_cls(cfg, grid=grid, device="cpu").scan_advance_fn("perf")
    assert asked == [(CPU, 4, "nccl")] and advance.loop.route == "scan-loop"


# ---------------------------------------------------------------------------
# The capture, through a stand-in for torch.cuda's graph capture
# ---------------------------------------------------------------------------


class _Graph:
    modes = []
    fail = False

    def capture_begin(self, pool=None, capture_error_mode="global"):
        _Graph.modes.append(capture_error_mode)
        if _Graph.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _Graph.modes, _Graph.fail = [], False
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _double(src, out, consts):
    return torch.mul(src[0], 2.0, out=out)


def test_capture_is_thread_local(stand_in):
    loop = scan.ScanLoop(_double, scan.graph_plan(4, 2), "scan-graph")
    T = torch.ones(6, 4)
    loop((T,), (), 8)
    assert _Graph.modes == ["thread_local"] * loop.plan.graphs and loop.graphs


def test_a_failed_capture_raises_and_nothing_falls_back(stand_in):
    _Graph.fail = True
    loop = scan.ScanLoop(_double, scan.graph_plan(4, 2), "scan-graph")
    T = torch.ones(6, 4)
    with pytest.raises(RuntimeError, match="capturing"):
        loop((T,), (), 8)
    # Only the warm-up step ran, on scratch copies: no chunk stepped the
    # state eagerly, and the route is still the graph's.
    assert loop.route == "scan-graph" and not loop.graphs
    assert torch.equal(T, torch.ones(6, 4))


# ---------------------------------------------------------------------------
# 4 gloo ranks: the exchange
# ---------------------------------------------------------------------------

GEOMETRIES = {"2d": ((32, 24), (2, 2)), "3d": ((12, 8, 16), (2, 1, 2))}
EXCHANGES = {
    f"{mode}-{dtype}-w{width}-{geo}": (*GEOMETRIES[geo], width, mode, dtype)
    for mode in wire.WIRE_MODES for width in (1, 4) for geo in GEOMETRIES
    for dtype in (("f64", "f32") if geo == "2d" else ("f64",))
}
STATELESS = sorted(k for k, v in EXCHANGES.items() if not wire.is_stateful(v[3]))


@pytest.fixture(scope="module")
def exchange_ranks():
    spec = dict(exchanges=EXCHANGES, steps=STEPS)
    return spawn_ranks(NPROCS, worker.run_exchange_rank, (spec,), backend="gloo", timeout=300)


def _jax_exchanges(shape, dims, width, mode, dtype):
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
    grid = jax_grid(*shape, dims=dims, devices=jax.devices()[:NPROCS])
    G = worker.global_field(shape)
    state = jwire.init_exchange_state(grid, width, mode, jdt)
    stateful = jwire.is_stateful(mode)

    def local(u, *ws):
        out = jax_exchange_halo(u, grid, width, wire_mode=mode,
                                wire_state=ws if stateful else None)
        return (out[0], *out[1]) if stateful else (out,)

    n = 1 + len(state)
    fn = jax.jit(shard_map(local, mesh=grid.mesh, in_specs=(grid.spec,) * n,
                           out_specs=(grid.spec,) * n, check_vma=False))
    out = []
    for t in range(STEPS):
        u = jax.device_put(jnp.asarray(G * (1.0 + t / 10), jdt), grid.sharding)
        padded, *state = fn(u, *state)
        out.append((np.asarray(padded), [np.asarray(s) for s in state]))
    return out


def _block(arr, coords, dims):
    size = tuple(n // d for n, d in zip(arr.shape, dims))
    return arr[tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, size))]


@pytest.mark.parametrize("key", sorted(EXCHANGES))
def test_exchange_and_state_equal_jax(exchange_ranks, key):
    # As tests/test_torch_wire.py holds them: the stateless modes bitwise,
    # the int8 modes within a few ulps of the slab's magnitude (XLA:CPU
    # fuses the jitted codec's multiply-adds).
    shape, dims, width, mode, dtype = EXCHANGES[key]
    eps = np.finfo(np.float64 if dtype == "f64" else np.float32).eps
    fused_tol = dict(rtol=0, atol=4 * eps * 1.2)
    want = _jax_exchanges(shape, dims, width, mode, dtype)
    for rank, out in enumerate(exchange_ranks):
        coords = init_global_grid(*shape, dims=dims, nprocs=NPROCS, rank=rank).coords
        for t, ((padded, state), (jpadded, jstate)) in enumerate(zip(out["exchange"][key],
                                                                     want)):
            msg = f"rank {rank} exchange {t}"
            if wire.is_stateful(mode):
                np.testing.assert_allclose(padded, _block(jpadded, coords, dims), **fused_tol,
                                           err_msg=msg)
            else:
                np.testing.assert_array_equal(padded, _block(jpadded, coords, dims),
                                              err_msg=msg)
            assert len(state) == len(jstate)
            for s, js in zip(state, jstate):
                np.testing.assert_allclose(s, _block(js, coords, dims), **fused_tol,
                                           err_msg=msg)


@pytest.mark.parametrize("key", STATELESS)
def test_exchange_reuses_its_buffers(exchange_ranks, key):
    for rank, out in enumerate(exchange_ranks):
        reuse = out["reuse"][key]
        # One geometry, one set of buffers: a send and a receive buffer for
        # each neighbour this rank has.
        assert reuse["keys"] == 1 and reuse["first"]
        assert all(p == reuse["first"] for p in reuse["later"]), f"rank {rank}"
        assert reuse["allocations"] == [], f"rank {rank}: {reuse['allocations']}"


def test_payload_dtype_packs_as_the_codec():
    # The stateless exchange packs a slab with copy_ into a payload buffer of
    # wire.payload_dtype: bitwise slab_codec's payload, and back.
    slab = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 40)) * 1e3)
    for mode in ("f32", "bf16"):
        codec = wire.slab_codec(mode)
        (want,), _ = codec.send(slab, ())
        got = torch.empty(slab.shape, dtype=wire.payload_dtype(mode, slab.dtype)).copy_(slab)
        assert got.dtype == want.dtype and torch.equal(got, want)
        decoded, _ = codec.recv((got,), (), slab.dtype)
        assert torch.equal(torch.empty_like(slab).copy_(got), decoded)
    with pytest.raises(ValueError, match="int8 codes"):
        wire.payload_dtype("int8", torch.float64)


# ---------------------------------------------------------------------------
# 4 gloo ranks: scan == step
# ---------------------------------------------------------------------------

SCAN_VARIANTS = {"diffusion": ("ap", "fused", "shard", "perf", "kp", "hide"),
                 "wave": ("ap", "shard", "perf", "hide"),
                 "swe": ("ap", "shard", "perf", "hide")}
# ap and fused stand in for JAX's GSPMD communication: always the f32 wire.
WIRED = ("shard", "perf", "kp", "hide")
SCAN_CASES = [
    (name, variant, mode, *GEOMETRIES[geo])
    for name, variants in SCAN_VARIANTS.items() for variant in variants
    for geo in GEOMETRIES for mode in ("f32", "bf16")
    if not (variant == "kp" and geo == "3d") and (mode == "f32" or variant in WIRED)
]


@pytest.fixture(scope="module")
def scan_ranks():
    spec = dict(cases=SCAN_CASES, nt=12, warmup=3)
    return spawn_ranks(NPROCS, rank_worker.run_sharded_scan_rank, (spec,), backend="gloo",
                       timeout=300)


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{len(c[3])}d")
def test_sharded_scan_equals_step(scan_ranks, case):
    for rank, out in enumerate(scan_ranks):
        same, route, q = out[case]
        assert same, f"rank {rank}"
        assert route == "scan-loop" and q == 3
