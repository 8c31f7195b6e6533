"""The port's scan driver (rocm_mpi_tpu_torch/models/scan.py and the three
models' scan_advance_fn / run(driver="scan")) against the JAX package's
scan drivers on the CPU: q over a grid of windows and chunks, the floor of
n // q, the f64 results; scan bitwise equal to step for every variant on
one rank and on 4 gloo ranks (the loop route); the graph plan for periods 2
and 3; the graph route's replay schedule and launch counts through a
stand-in for torch.cuda's graph capture; the config seam; the apps'
--driver and --fact."""

import contextlib
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

import test_torch_rank_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.models.swe import ShallowWater as JaxSWE
from rocm_mpi_tpu.models.swe import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.models.wave import AcousticWave as JaxWave
from rocm_mpi_tpu.models.wave import WaveConfig as JaxWaveConfig
from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
from rocm_mpi_tpu_torch.models import scan
from rocm_mpi_tpu_torch.ops import kernels
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

TOL64 = dict(rtol=1e-12, atol=1e-14)
MODELS = {
    "diffusion": (HeatDiffusion, DiffusionConfig, JaxHeatDiffusion, JaxConfig),
    "wave": (AcousticWave, WaveConfig, JaxWave, JaxWaveConfig),
    "swe": (ShallowWater, SWEConfig, JaxSWE, JaxSWEConfig),
}


def _kw(shape=(24, 20), nt=24, warmup=8, dtype="f64", dims=None):
    return dict(global_shape=shape, lengths=(10.0,) * len(shape), nt=nt, warmup=warmup,
                dtype=dtype, dims=dims or (1,) * len(shape))


def _ours(name, **kw):
    return MODELS[name][0](MODELS[name][1](**_kw(**kw)), device="cpu")


def _jax(name, **kw):
    return MODELS[name][2](MODELS[name][3](**_kw(**kw)), devices=jax.devices()[:1])


def _variants(name):
    model = _ours(name)
    return model.variants if name == "diffusion" else model.VARIANTS


def _fields(name, res) -> tuple:
    if name == "diffusion":
        return (res.T,)
    if name == "wave":
        return (res.U,)
    return (res.h, *res.us)


def _state(name, model):
    """(advance's state arguments, its constants) from the initial state."""
    if name == "diffusion":
        T, Cp = model.init_state()
        return (T,), (Cp,)
    if name == "wave":
        U, Uprev, C2 = model.init_state()
        return (U, Uprev), (C2,)
    h, us = model.init_state()
    return (h, us), (model.face_masks(),)


def _first(name, out):
    """The leading field of an advance's result, as a numpy array."""
    lead = out if name == "diffusion" else out[0]
    return np.asarray(lead)


# ---------------------------------------------------------------------------
# q, the floor and the JAX scan run
# ---------------------------------------------------------------------------

# (nt, warmup, chunk): whole windows, warmup 0 (q = nt), a prime timed
# window (q = 1), and explicit chunks that keep or degrade.
WINDOWS = [(24, 8, None), (20, 0, None), (23, 0, None), (1000, 10, None), (107, 10, None),
           (40, 8, 8), (40, 8, 16), (40, 8, 3), (24, 0, 5), (48, 16, 16), (1000, 0, 256)]


@pytest.mark.parametrize("nt, warmup, chunk", WINDOWS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_q_and_warning_match_jax(name, nt, warmup, chunk):
    ours, ref = _ours(name), _jax(name)
    variant = "perf"
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        _, q = ours.scan_advance_fn(variant, nt=nt, warmup=warmup, chunk=chunk)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        _, q_ref = ref.scan_advance_fn(variant, nt=nt, warmup=warmup, chunk=chunk)
    assert q == q_ref
    assert [str(w.message) for w in ours_w] == [str(w.message) for w in ref_w]
    assert bool(ours_w) == (chunk is not None and q != chunk)
    # The warning points at the caller, as JAX's does.
    assert all(w.filename == __file__ for w in ours_w)


@pytest.mark.parametrize("n", [13, 12, 3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_advance_floors_n_by_q_as_jax(name, n):
    # q = 4: 13 and 12 steps both run 12, 3 steps run none.
    ours, ref = _ours(name), _jax(name)
    advance, q = ours.scan_advance_fn("perf", nt=24, warmup=8, chunk=4)
    jadvance, jq = ref.scan_advance_fn("perf", nt=24, warmup=8, chunk=4)
    assert q == jq == 4
    args, consts = _state(name, ours)

    def to_jax(xs):
        return tuple(jax.numpy.array(x.numpy()) if isinstance(x, torch.Tensor)
                     else tuple(jax.numpy.array(u.numpy()) for u in x) for x in xs)

    # JAX's copies first: the port's advance takes the state as its buffer.
    jargs, jconsts = to_jax(args), to_jax(consts)
    got = advance(*args, *consts, n)
    want = jadvance(*jargs, *jconsts, n)
    np.testing.assert_allclose(_first(name, got), _first(name, want), **TOL64)
    args2, consts2 = _state(name, ours)
    stepped = ours.advance_fn("perf")(*args2, *consts2, (n // q) * q)
    assert np.array_equal(_first(name, got), _first(name, stepped))


@pytest.mark.parametrize("name, variant", [("diffusion", "perf"), ("diffusion", "kp"),
                                           ("wave", "perf"), ("swe", "perf")])
def test_scan_run_matches_jax_scan_run_f64(name, variant):
    ours = _ours(name, nt=25, warmup=5)
    ref = _jax(name, nt=25, warmup=5)
    got = ours.run(variant, driver="scan")
    want = ref.run(variant, driver="scan")
    assert (got.route, got.k) == ("scan-eager", 5)
    for a, b in zip(_fields(name, got), _fields(name, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL64)


# ---------------------------------------------------------------------------
# scan == step
# ---------------------------------------------------------------------------

CASES = [(name, variant) for name in sorted(MODELS) for variant in _variants(name)]


@pytest.mark.parametrize("windows", [(24, 8), (25, 5), (21, 0)], ids=["c8", "c5", "c21"])
@pytest.mark.parametrize("name, variant", CASES)
def test_scan_equals_step_one_rank(name, variant, windows):
    nt, warmup = windows
    dtype = "f32" if windows == (24, 8) else "f64"
    model = _ours(name, nt=nt, warmup=warmup, dtype=dtype)
    step = model.run(variant)
    got = model.run(variant, driver="scan")
    assert (step.route, step.k) == (None, None)
    assert got.route == "scan-eager" and got.k == (nt if warmup == 0 else warmup)
    for a, b in zip(_fields(name, step), _fields(name, got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_advance_reuses_its_buffers_and_takes_other_state():
    model = _ours("diffusion", nt=24, warmup=8)
    advance, q = model.scan_advance_fn("perf")
    T, Cp = model.init_state()
    T1 = advance(T, Cp, 8)
    loop = advance.loop
    slots = loop.slots
    T2 = advance(T1, Cp, 8)
    assert loop.slots is slots and any(T2 is s for s in slots)
    # A state that is no slot is copied in; the result is the same steps.
    T0, _ = model.init_state()
    T3 = advance(T0.clone(), Cp, 16)
    ref = model.advance_fn("perf")(model.init_state()[0], Cp, 16)
    assert torch.equal(T3, ref) and any(T3 is s for s in slots)
    # A new coefficient is copied into the bound one.
    T4 = advance(model.init_state()[0], Cp * 2.0, 8)
    assert torch.equal(T4, model.advance_fn("perf")(model.init_state()[0], Cp * 2.0, 8))


def test_sharded_route_is_decided_before_any_launch():
    grid = init_global_grid(32, 24, dims=(2, 2), nprocs=4, rank=0)
    cfg = DiffusionConfig(global_shape=(32, 24), nt=24, warmup=8, dtype="f64", dims=(2, 2))
    model = HeatDiffusion(cfg, grid=grid, device="cpu")
    advance, q = model.scan_advance_fn("perf")
    assert advance.loop.route == "scan-loop" and advance.loop.slots is None and q == 8
    # The route table itself: tests/test_torch_sharded_scan.py.


# ---------------------------------------------------------------------------
# 4 gloo ranks: the loop route
# ---------------------------------------------------------------------------

SHARDED = dict(shape=(32, 24), dims=(2, 2), nt=12, warmup=3, dtype="f64")


@pytest.fixture(scope="module")
def scan_ranks():
    return spawn_ranks(4, worker.run_scan_rank, (SHARDED,), backend="gloo", timeout=240)


@pytest.mark.parametrize("name, variant", CASES)
def test_scan_loop_route_equals_step_on_4_ranks(scan_ranks, name, variant):
    for out in scan_ranks:
        same, route, q = out["runs"][(name, variant)]
        assert same and route == "scan-loop" and q == 3
        assert set(out["launches"].values()) == {0}


# ---------------------------------------------------------------------------
# The graph plan
# ---------------------------------------------------------------------------


def _simulate(plan, n, phase=0):
    """Slot indices in role order after n // q · q single steps from
    `phase`, by rotating a list one step at a time."""
    p = plan.period
    order = [(i - phase) % p for i in range(p)]
    for _ in range((n // plan.q) * plan.q):
        order = [order[-1]] + order[:-1]
    return order


@pytest.mark.parametrize("period", [2, 3])
@pytest.mark.parametrize("q, cap, c, graphs2, graphs3", [
    (10, 256, 10, 1, 3), (5, 256, 5, 2, 3), (6, 256, 6, 1, 1), (1000, 256, 250, 1, 3),
    (1024, 256, 256, 1, 3), (997, 256, 1, 2, 3), (768, 256, 256, 1, 3), (12, 4, 4, 1, 3),
    (9, 256, 9, 2, 1), (1, 256, 1, 2, 3)])
def test_graph_plan(period, q, cap, c, graphs2, graphs3):
    plan = scan.graph_plan(q, period, cap)
    assert plan.c == c and q % plan.c == 0 and plan.c <= cap
    assert plan.graphs == {2: graphs2, 3: graphs3}[period]
    assert plan.phases[0] == 0 and len(set(plan.phases)) == plan.graphs
    for n in (0, q - 1, q, 3 * q + 1):
        sched = plan.schedule(n)
        assert len(sched) == (n // q) * (q // c) == plan.replays(n)
        assert set(sched) <= set(plan.phases)
        # Each replay starts where the last one ended.
        for a, b in zip(sched, sched[1:]):
            assert b == (a + c) % period
        end = (len(sched) * c) % period
        assert [s for s in scan.roles(list(range(period)), end)] == _simulate(plan, n)


def test_roles_rotate_as_the_step_driver():
    # Diffusion: (T, spare) -> (spare, T); the wave: (U, U-, spare) ->
    # (spare, U, U-), as advance_fn rebinds them.
    assert scan.roles(("a", "b"), 1) == ("b", "a")
    assert scan.roles(("u", "v", "w"), 1) == ("w", "u", "v")
    assert scan.roles(("u", "v", "w"), 2) == ("v", "w", "u")
    with pytest.raises(ValueError):
        scan.graph_plan(0, 2)


# ---------------------------------------------------------------------------
# The graph route, through a stand-in for torch.cuda's capture: kernels
# recorded at capture and run only at replay
# ---------------------------------------------------------------------------


class _FakeGraph:
    capturing = None
    made = 0

    def __init__(self):
        self.ops = []
        _FakeGraph.made += 1

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = capture_error_mode
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None

    def replay(self):
        for op in self.ops:
            op()


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _FakeGraph.made = 0
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _toy_kernel(src, out, C):
    """A leapfrog (period 3) or diffusion (period 2) update into `out`."""
    U = src[0]
    lap = torch.roll(U, 1, 0) + torch.roll(U, -1, 0) - 2.0 * U
    new = (2.0 * U - src[1] if len(src) == 2 else U) + C * lap
    out.copy_(new)


def _toy_step(src, out, consts):
    """As a kernel wrapper: one launch counted where it is issued; under
    capture the launch is recorded, not run."""
    kernels.LAUNCHES["masked_step"] += 1
    op = functools.partial(_toy_kernel, src, out, consts[0])
    if _FakeGraph.capturing is not None:
        _FakeGraph.capturing.ops.append(op)
    else:
        op()
    return out


@pytest.mark.parametrize("period, q, cap", [(2, 10, 256), (2, 5, 256), (2, 1000, 256),
                                            (3, 10, 256), (3, 1000, 256), (3, 9, 256),
                                            (3, 12, 4)])
def test_graph_route_replays_the_eager_schedule(fake_cuda, period, q, cap):
    g = torch.Generator().manual_seed(0)
    state = tuple(torch.rand(12, 8, generator=g, dtype=torch.float64)
                  for _ in range(period - 1))
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    plan = scan.graph_plan(q, period, cap)
    graphs = scan.ScanLoop(_toy_step, plan, "scan-graph")
    eager = scan.ScanLoop(_toy_step, plan, "scan-eager")
    a = tuple(t.clone() for t in state)
    b = tuple(t.clone() for t in state)
    total = 0
    for n in (q, 2 * q + 1, 3 * q):
        kernels.reset_launches()
        a = graphs(a, (C,), n)
        assert kernels.LAUNCHES["masked_step"] == (n // q) * q  # replays only
        b = eager(b, (C,), n)
        total += (n // q) * q
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert _FakeGraph.made == len(graphs.graphs) == plan.graphs
    assert all(sum(r.values()) == plan.c for r in graphs.recorded.values())
    # The same steps one after another.
    ref = [t.clone() for t in state] + [torch.empty(12, 8, dtype=torch.float64)]
    for _ in range(total):
        _toy_kernel(tuple(ref[:-1]), ref[-1], C)
        ref = [ref[-1]] + ref[:-1]
    for x, y in zip(a, ref[:-1]):
        assert torch.equal(x, y)


def test_finalize_releases_the_graphs_before_the_process_group(fake_cuda, monkeypatch):
    # Over NCCL a captured graph holds work on the group's communicator,
    # and destroy_process_group waits for ever while one is alive: the
    # loops' graphs go first, and a loop captures anew when called again.
    from rocm_mpi_tpu_torch.parallel import distributed

    T = torch.rand(12, 8, dtype=torch.float64)
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    loop = scan.ScanLoop(_toy_step, scan.graph_plan(4, 2), "scan-graph")
    eager = scan.ScanLoop(_toy_step, scan.graph_plan(4, 2), "scan-eager")
    a, b = (T.clone(),), (T.clone(),)
    a, b = loop(a, (C,), 8), eager(b, (C,), 8)
    assert loop.graphs and loop in scan._CAPTURED and eager not in scan._CAPTURED
    seen = []
    monkeypatch.setattr(distributed, "is_distributed", lambda: True)
    monkeypatch.setattr(distributed.dist, "destroy_process_group",
                        lambda: seen.append(dict(loop.graphs)))
    distributed.finalize()
    assert seen == [{}] and not loop.recorded and loop not in scan._CAPTURED
    a, b = loop(a, (C,), 8), eager(b, (C,), 8)
    assert loop.graphs and torch.equal(a[0], b[0])


def test_graph_route_never_steps_the_state_outside_a_replay(fake_cuda):
    T = torch.rand(12, 8, dtype=torch.float64)
    T0 = T.clone()
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    loop = scan.ScanLoop(_toy_step, scan.graph_plan(4, 2), "scan-graph")
    (out,) = loop((T,), (C,), 3)  # fewer than q steps: no capture, no step
    assert out is T and torch.equal(T, T0) and not loop.graphs
    loop._capture()  # the scratch step and the captures leave T alone
    assert torch.equal(T, T0) and kernels.LAUNCHES["masked_step"] == 0


# ---------------------------------------------------------------------------
# The config seam, the old asserts' replacements, the apps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_seam(name, tmp_path):
    from rocm_mpi_tpu_torch.tuning import resolve

    model = _ours(name)
    for config in (None, "default"):
        assert model.scan_advance_fn("perf", config=config)[1] == 8
    # With a cold cache, "auto" is the default chunk (the tuning plane's
    # warm cases: tests/test_torch_tuning.py).
    resolve.configure(tmp_path / "cold.json")
    try:
        assert model.scan_advance_fn("perf", config="auto")[1] == 8
        assert model.run("perf", driver="scan", config="auto").k == 8
    finally:
        resolve.configure(None)
    with pytest.raises(ValueError, match="config must be"):
        model.scan_advance_fn("perf", config="x")
    with pytest.raises(ValueError, match="driver"):
        model.run("perf", driver="loop")
    # As in JAX, an explicit chunk leaves the config unread.
    assert model.scan_advance_fn("perf", chunk=4, config="auto")[1] == 4


@pytest.mark.parametrize("app, extra", [
    ("diffusion_2d_perf", []), ("diffusion_2d_kp", []), ("diffusion_2d_ap", []),
    ("diffusion_2d_perf_hide", []), ("wave_2d", []), ("swe_2d", []),
])
def test_apps_default_to_scan_and_step_reproduces(app, extra, capsys, tmp_path):
    import importlib

    mod = importlib.import_module(f"rocm_mpi_tpu_torch.apps.{app}")
    base = ["--device", "cpu", "--nx", "24", "--ny", "20", "--nt", "12", "--warmup", "4"]
    assert mod.main(base + extra) == 0
    scan_out = capsys.readouterr().out
    assert "driver scan (route scan-eager, q 4)" in scan_out
    assert mod.main(base + extra + ["--driver", "step"]) == 0
    step_out = capsys.readouterr().out
    assert "driver step" in step_out

    def maxima(text):
        return [line for line in text.splitlines() if line.startswith("maximum")]

    assert maxima(scan_out) == maxima(step_out) and maxima(scan_out)


def test_fact_scales_every_axis():
    from rocm_mpi_tpu_torch.apps import _common, swe_2d, wave_2d

    args = _common.make_parser("perf", nx=64, ny=48, nt=10, dtype="f32").parse_args(
        ["--fact", "2"])
    assert _common.grid_shape(args) == (2048, 2048)
    args = wave_2d.make_parser().parse_args(["--fact", "1", "--nz", "8"])
    assert _common.grid_shape(args, 3) == (1024, 1024, 1024)
    args = swe_2d.make_parser().parse_args(["--nx", "30", "--ny", "20"])
    assert _common.grid_shape(args) == (30, 20) and args.fact == 0


def test_one_rank_steps_make_no_distributed_call(monkeypatch):
    # What a capture must not see: on one rank the exchange posts nothing.
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("torch.distributed called on one rank")

    for fn in ("batch_isend_irecv", "isend", "irecv", "barrier", "all_reduce", "P2POp"):
        monkeypatch.setattr(dist, fn, refuse)
    for name, variant in CASES:
        model = _ours(name, nt=12, warmup=4)
        assert model.run(variant, driver="scan").route == "scan-eager"
