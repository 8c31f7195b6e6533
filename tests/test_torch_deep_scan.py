"""The multi-step schedules as one loop of sweeps (rocm_mpi_tpu_torch/
models/scan.sweep_loop): HeatDiffusion's run_deep / deep_advance_fn,
run_vmem_resident and run_hbm_blocked, and the wave's and the shallow
water's run_deep and run_vmem_resident, on the CPU.

On one CPU rank the loop runs its replay schedule eagerly ("scan-eager"):
each path is held bit for bit to the eager sweep loop it replaces (the
ops' Python loops over launches, and the deep schedule's prepare and
sweeps one call after another), and to the JAX package's same path
within the tolerance tests/test_torch_multistep.py, test_torch_wave.py
and test_torch_swe.py use for it: f64 rtol 1e-12 / atol 1e-14, f32 rtol
2e-5 / atol 2e-6. Inputs are seeded numpy fields
(test_torch_transport_worker.seeded_state), sizes at most 64², depths
k in {2, 4, 8}. The graph route is reached through a stand-in for
torch.cuda's capture (kernels recorded at capture, run at replay), which
must replay the same sweeps. On 4 gloo ranks ("scan-loop") run_deep in
the f32, bf16 and int8_delta wire modes equals the eager loop on every
rank, bitwise, and JAX's 4-device run_deep (f64 rtol 1e-12 / atol 1e-14).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_transport_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeat
from rocm_mpi_tpu.models.swe import ShallowWater as JaxSWE
from rocm_mpi_tpu.models.swe import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.models.wave import AcousticWave as JaxWave
from rocm_mpi_tpu.models.wave import WaveConfig as JaxWaveConfig
from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater, scan
from rocm_mpi_tpu_torch.ops import kernels, multistep
from rocm_mpi_tpu_torch.ops import swe as S
from rocm_mpi_tpu_torch.ops import wave as W
from rocm_mpi_tpu_torch.parallel import wire
from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}
MODELS = {
    "diffusion": (HeatDiffusion, DiffusionConfig, JaxHeat, JaxConfig),
    "wave": (AcousticWave, WaveConfig, JaxWave, JaxWaveConfig),
    "swe": (ShallowWater, SWEConfig, JaxSWE, JaxSWEConfig),
}
SHAPE = (32, 24)
NT, WARMUP = 48, 16
NPROCS = 4
GLOO = dict(global_shape=(32, 24), lengths=(10.0, 10.0), nt=24, warmup=8, dims=(2, 2),
            dtype="f64")
GLOO_K = 4
GLOO_RUNS = [(w, m) for w in MODELS for m in ("f32", "bf16", "int8_delta")]


def _cfg(name, shape=SHAPE, dtype="f64", nt=NT, warmup=WARMUP, dims=None, **kw):
    cfg_cls = MODELS[name][1]
    return cfg_cls(global_shape=shape, lengths=(10.0,) * len(shape), nt=nt, warmup=warmup,
                   dtype=dtype, dims=dims or (1,) * len(shape), **kw)


def _ours(name, seed=0, **kw):
    """The port's model on the CPU, its init_state the seeded state."""
    model = MODELS[name][0](_cfg(name, **kw), device="cpu")
    model.init_state = lambda: worker.seeded_state(model, seed)
    return model


def _jax(name, state, devices=1, **kw):
    """The JAX model of the same configuration, its init_state the given
    numpy state (placed with the model's sharding)."""
    jax_cls, jax_cfg = MODELS[name][2], MODELS[name][3]
    cfg = _cfg(name, **kw)
    fields = dict(global_shape=cfg.global_shape, lengths=cfg.lengths, nt=cfg.nt,
                  warmup=cfg.warmup, dtype=cfg.dtype, dims=cfg.dims,
                  wire_mode=cfg.wire_mode)
    model = jax_cls(jax_cfg(**fields), devices=jax.devices()[:devices])

    def put(a):
        return jax.device_put(jnp.asarray(a), model.grid.sharding)

    if name == "swe":
        model.init_state = lambda: (put(state[0]), tuple(put(u) for u in state[1]))
    else:
        model.init_state = lambda: tuple(put(a) for a in state)
    return model


def _state_numpy(model):
    """The seeded state of a one-rank model as numpy (the global field)."""
    st = model.init_state()
    if isinstance(model, ShallowWater):
        return np.asarray(st[0]), [np.asarray(u) for u in st[1]]
    return tuple(np.asarray(t) for t in st)


def _leaves(name, res):
    return {"diffusion": lambda: [res.T], "wave": lambda: [res.U],
            "swe": lambda: [res.h, *res.us]}[name]()


def _advance(name, model, advance, state, n):
    """One call of a deep advance on `state` (a tuple as init_state gives
    it); returns the state tuple."""
    if name == "diffusion":
        return (advance(state[0], state[1], n), state[1])
    if name == "wave":
        return (*advance(state[0], state[1], state[2], n), state[2])
    return advance(state[0], state[1], model.face_masks(), n)


def _state_leaves(name, state):
    return {"diffusion": lambda: [state[0]], "wave": lambda: list(state[:2]),
            "swe": lambda: [state[0], *state[1]]}[name]()


# ---------------------------------------------------------------------------
# One CPU rank: the loop against the eager sweep loop and against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["f32", "int8_delta"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_run_deep_is_the_eager_sweep_loop(name, k, mode):
    model = _ours(name, wire_mode=mode)
    res = model.run_deep(block_steps=k)
    assert (res.route, res.k, res.loop_route, res.capture_ms) == ("vmem", k, "scan-eager", 0.0)
    want, sched = worker.eager_deep(model, k, mode, (WARMUP, NT - WARMUP))
    got = _leaves(name, res)
    want = want[:1] if name == "wave" else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sched.route == res.route


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_deep_advance_matches_jax(name, k, dtype):
    # Two calls (the warmup window, then the rest) from the seeded state.
    ours = _ours(name, dtype=dtype)
    state = _state_numpy(ours)
    ref = _jax(name, state, dtype=dtype)
    advance, kk = ours.deep_advance_fn(block_steps=k)
    jadvance, jk = ref.deep_advance_fn(block_steps=k)
    assert kk == jk == k
    got = ours.init_state()
    want = ref.init_state()
    for n in (WARMUP, NT - WARMUP):
        got = _advance(name, ours, advance, got, n)
        want = _advance(name, ref, jadvance, want, n)
    assert advance.loop.route == "scan-eager" and advance.schedule.route == "vmem"
    for g, w in zip(_state_leaves(name, got), _state_leaves(name, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])


def _eager_single_shard(name, meth, model, k):
    """The ops' eager loop over launches for `meth`, over the warmup and
    the timed windows, from the model's (seeded) state."""
    cfg = model.config
    calls = (cfg.warmup, cfg.nt - cfg.warmup)
    if name == "diffusion":
        T, Cp = model.init_state()
        fn = multistep.fused_multi_step if meth == "run_vmem_resident" else \
            multistep.fused_multi_step_hbm
        kw = {"chunk": k, "warn_on_cap": False} if meth == "run_vmem_resident" else \
            {"block_steps": k}
        for n in calls:
            T = fn(T, Cp, cfg.lam, model.dt_value, cfg.spacing, n, **kw)
        return [T]
    if name == "wave":
        U, Uprev, C2 = model.init_state()
        for n in calls:
            U, Uprev = W.wave_multi_step(U, Uprev, C2, model.dt_value, cfg.spacing, n, chunk=k,
                                         warn_on_cap=False)
        return [U]
    h, us = model.init_state()
    for n in calls:
        h, us = S.swe_multi_step(h, us, model.face_masks(), cfg.dt, cfg.spacing, cfg.H0,
                                 cfg.g, n, chunk=k, warn_on_cap=False)
    return [h, *us]


SINGLE = [("diffusion", "run_vmem_resident", (32, 24), "vmem-loop", 16),
          ("diffusion", "run_vmem_resident", (12, 10, 8), "vmem-loop", 16),
          ("diffusion", "run_hbm_blocked", (64, 40), "hbm-tb", 8),
          ("diffusion", "run_hbm_blocked", (32, 12, 10), "hbm-tb", 8),
          ("wave", "run_vmem_resident", (32, 24), "vmem-loop", 16),
          ("swe", "run_vmem_resident", (32, 24), "vmem-loop", 16)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("name,meth,shape,route,k", SINGLE)
def test_single_shard_schedule_is_the_eager_loop_and_matches_jax(name, meth, shape, route, k,
                                                                 dtype):
    ours = _ours(name, shape=shape, dtype=dtype)
    res = getattr(ours, meth)()
    assert (res.route, res.k, res.loop_route) == (route, k, "scan-eager")
    got = _leaves(name, res)
    for g, w in zip(got, _eager_single_shard(name, meth, ours, k)):
        assert torch.equal(g, w)
    want = _leaves(name, getattr(_jax(name, _state_numpy(ours), shape=shape, dtype=dtype),
                                 meth)())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])


def test_vmem_resident_pow2_pad_is_the_eager_loop():
    ours = _ours("diffusion", shape=(30, 20))
    res = ours.run_vmem_resident(pad_pow2=True)
    T, Cp = ours.init_state()
    cfg = ours.config
    for n in (WARMUP, NT - WARMUP):
        T = multistep.fused_multi_step(T, Cp, cfg.lam, ours.dt_value, cfg.spacing, n, chunk=16,
                                       warn_on_cap=False, pad_pow2=True)
    assert tuple(res.T.shape) == (30, 20) and torch.equal(res.T, T)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_warmup_and_rest_equal_one_call(name):
    ours = _ours(name)
    split, _ = ours.deep_advance_fn(block_steps=8)
    whole, _ = ours.deep_advance_fn(block_steps=8)
    a = ours.init_state()
    for n in (WARMUP, NT - WARMUP):
        a = _advance(name, ours, split, a, n)
    b = _advance(name, ours, whole, ours.init_state(), NT)
    for x, y in zip(_state_leaves(name, a), _state_leaves(name, b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_count_off_the_plan_runs_every_sweep(name):
    # q is 2 sweeps of 8 (gcd(16, 32) = 16 steps); a call of 24 steps runs
    # three sweeps, as JAX's fori_loop does, not the plan's floor of two.
    ours = _ours(name)
    advance, k = ours.deep_advance_fn(block_steps=8)
    assert advance.loop.plan.q == 2 and advance.loop.exact
    got = _advance(name, ours, advance, ours.init_state(), 24)
    want, _ = worker.eager_deep(ours, 8, "f32", (24,))
    for g, w in zip(_state_leaves(name, got), want):
        assert torch.equal(g, w)
    again = _advance(name, ours, advance, got, 0)  # no sweep, no copy
    for g, a in zip(_state_leaves(name, got), _state_leaves(name, again)):
        assert a is g
    with pytest.raises(ValueError, match="multiple of the depth"):
        _advance(name, ours, advance, ours.init_state(), 12)


def test_stateful_calls_each_start_from_a_zero_wire_state():
    # On one rank no ghost arrives, but the codec still sends every slab:
    # its state after a call is the eager loop's, and a second call starts
    # again from zeros (the JAX package's per-call first-sweep contract).
    ours = _ours("diffusion", wire_mode="int8_delta")
    advance, k = ours.deep_advance_fn(block_steps=4)
    T, Cp = ours.init_state()
    sched = advance.schedule
    for _ in range(2):
        T = advance(T, Cp, 8)
        state = advance.loop.current()[0][1:]
        assert any(bool(s.abs().max() > 0) for s in state)
    # The eager reference: one call of two sweeps from a zero state.
    T0, _ = ours.init_state()
    Cm = sched.prepare(Cp)
    ws = sched.init_wire(T0.dtype, T0.device)
    for _ in range(2):
        T0, ws = sched.sweep(T0, Cm, ws)
    first = T0.contiguous()
    Cm = sched.prepare(Cp)
    ws = sched.init_wire(T0.dtype, T0.device)
    for _ in range(2):
        first, ws = sched.sweep(first, Cm, ws)
    assert torch.equal(T, first.contiguous())
    for s, w in zip(state, ws):
        assert torch.equal(s, w)


def test_int8_messages_live_on_the_grid_and_codes_are_unchanged():
    grid = init_global_grid(24, 20, dims=(1, 1), nprocs=1, rank=0)
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.random((24, 20)))
    state = wire.init_exchange_state(grid.local_shape, 3, "int8_delta", torch.float64)
    _, state = exchange_halo(u, grid, width=3, wire_mode="int8_delta", wire_state=state)
    (key,) = grid.exchange_buffers
    ptrs = sorted(t.data_ptr() for msgs in grid.exchange_buffers[key].values()
                  for pair in msgs for t in pair)
    _, state2 = exchange_halo(u * 1.1, grid, width=3, wire_mode="int8_delta",
                              wire_state=state)
    assert sorted(t.data_ptr() for msgs in grid.exchange_buffers[key].values()
                  for pair in msgs for t in pair) == ptrs
    # Writing the codes into given buffers changes no bit of them.
    x = torch.from_numpy(rng.standard_normal((3, 20)))
    q, scale = wire._quantize_int8(x)
    out = (torch.empty(3, 20, dtype=torch.int8), torch.empty(1, dtype=torch.float64))
    q2, scale2 = wire._quantize_int8(x, out)
    assert q2 is out[0] and torch.equal(q, q2) and torch.equal(scale, scale2)


# ---------------------------------------------------------------------------
# The graph route, through a stand-in for torch.cuda's capture
# ---------------------------------------------------------------------------


class _FakeGraph:
    capturing = None
    made = 0
    fail = False

    def __init__(self):
        self.ops = []
        _FakeGraph.made += 1

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None
        if _FakeGraph.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

    def replay(self):
        for op in self.ops:
            op()


@pytest.fixture
def fake_graphs(monkeypatch):
    """Every sweep loop takes the graph route; a capture records each
    sweep (bound to its slots, as a graph binds pointers) and a replay
    runs the records."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(scan, "scan_route", lambda device, nprocs, backend: "scan-graph")
    step_into = scan.ScanLoop._step_into

    def recorded(self, slots, phase):
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.ops.append(functools.partial(step_into, self, slots, phase))
        else:
            step_into(self, slots, phase)

    monkeypatch.setattr(scan.ScanLoop, "_step_into", recorded)
    _FakeGraph.made, _FakeGraph.fail = 0, False
    kernels.reset_launches()
    yield
    kernels.reset_launches()


@pytest.mark.parametrize("mode", ["f32", "int8_delta"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_route_replays_the_eager_sweeps(fake_graphs, name, mode):
    model = _ours(name, wire_mode=mode)
    res = model.run_deep(block_steps=4)
    assert res.loop_route == "scan-graph" and res.route == "vmem"
    want, _ = worker.eager_deep(model, 4, mode, (WARMUP, NT - WARMUP))
    for g, w in zip(_leaves(name, res), want[:1] if name == "wave" else want):
        assert torch.equal(g, w)
    # q = gcd(4, 8) = 4 sweeps, c = 4: one graph, captured at the first call.
    assert _FakeGraph.made == 1


@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_route_captures_a_remainder_once(fake_graphs, name):
    model = _ours(name)
    advance, _ = model.deep_advance_fn(block_steps=8)  # q = 2 sweeps
    loop = advance.loop
    state = model.init_state()
    calls = (24, 16, 24, 8)  # 3, 2, 3 and 1 sweeps
    for n in calls:
        state = _advance(name, model, advance, state, n)
    # Phase 0: the chunk of 2; a remainder sweep from phase 0 and from 1;
    # the chunk from phase 1, after an odd call.
    assert set(loop.graphs) == {(0, 2), (0, 1), (1, 2), (1, 1)} and _FakeGraph.made == 4
    want, _ = worker.eager_deep(model, 8, "f32", calls)
    for g, w in zip(_state_leaves(name, state), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,meth", [("diffusion", "run_vmem_resident"),
                                       ("diffusion", "run_hbm_blocked"),
                                       ("wave", "run_vmem_resident"),
                                       ("swe", "run_vmem_resident")])
def test_graph_route_single_shard_schedules(fake_graphs, name, meth):
    shape = (64, 40) if meth == "run_hbm_blocked" else SHAPE
    model = _ours(name, shape=shape)
    res = getattr(model, meth)()
    assert res.loop_route == "scan-graph"
    for g, w in zip(_leaves(name, res), _eager_single_shard(name, meth, model, res.k)):
        assert torch.equal(g, w)


def test_a_capture_that_fails_raises_naming_the_sweep(fake_graphs):
    _FakeGraph.fail = True
    model = _ours("diffusion")
    with pytest.raises(RuntimeError, match="capture of .* deep sweep of 8 steps on local "
                       "route vmem .* does not fall back"):
        model.run_deep(block_steps=8)


# ---------------------------------------------------------------------------
# 4 gloo ranks: the loop route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo_ranks():
    spec = dict(cfg=GLOO, k=GLOO_K, runs=GLOO_RUNS, seed=5)
    return spawn_ranks(NPROCS, worker.run_deep_scan_rank, (spec,), backend="gloo",
                       timeout=300)


@pytest.mark.parametrize("workload,mode", GLOO_RUNS)
def test_gloo_run_deep_is_the_eager_loop_and_matches_jax(gloo_ranks, workload, mode):
    for out in gloo_ranks:
        r = out[(workload, mode)]
        assert (r["route"], r["loop_route"], r["k"]) == ("vmem", "scan-loop", GLOO_K)
        assert r["bitwise_eager"]
    # The JAX package's 4-device run from the same seeded global state
    # (a one-rank model's seeded state is the whole global field).
    windows = dict(shape=GLOO["global_shape"], nt=GLOO["nt"], warmup=GLOO["warmup"])
    state = _state_numpy(_ours(workload, seed=5, **windows))
    ref = _jax(workload, state, devices=NPROCS, dims=GLOO["dims"], wire_mode=mode, **windows)
    res = ref.run_deep(block_steps=GLOO_K)
    want = _leaves(workload, res)
    got = gloo_ranks[0][(workload, mode)]["fields"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL["f64"])
