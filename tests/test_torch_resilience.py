"""The port's resilience plane (rocm_mpi_tpu_torch/resilience/, the fault
sites and preemption in utils/checkpoint.py, the apps' --retries and
--inject-fault) on the CPU, held against the JAX package: the fault
grammar and firing, the policy and preemption tables, save_wall_p90,
supervised runs bitwise equal to the straight run (and within f64
tolerance of the JAX package's run from the same initial state),
preemption in the segmented loop, the storage kinds through the fault
plan, restores onto another process grid (2×2 gloo ranks onto 1×2, 2×1
and one rank) and the rebuilt per-grid machinery."""

import errno
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import test_torch_elastic_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxDiffusionConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.parallel import halo as jax_halo
from rocm_mpi_tpu.parallel import mesh as jax_mesh
from rocm_mpi_tpu.resilience import faults as jax_faults
from rocm_mpi_tpu.resilience import policy as jax_policy
from rocm_mpi_tpu.resilience import preempt as jax_preempt
from rocm_mpi_tpu.resilience import reshard as jax_reshard
from rocm_mpi_tpu.utils import checkpoint as jax_ckpt
from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion, scan
from rocm_mpi_tpu_torch.parallel import deep_halo, halo, mesh
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.resilience import (
    InjectedCrash,
    faults,
    policy,
    preempt,
    reshard,
    run_supervised,
)
from rocm_mpi_tpu_torch.resilience.supervisor import default_retryable
from rocm_mpi_tpu_torch.utils import checkpoint as ckpt
from test_torch_scan import _toy_step, fake_cuda  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NT, EVERY = 32, 8
TOL64 = dict(rtol=1e-12, atol=1e-14)  # tests/test_torch_checkpoint.py's f64 tolerance


@pytest.fixture(autouse=True)
def _clean_state():
    """No armed faults, no pending preemption, no save-wall history and no
    events, in both packages, before and after every test."""
    for f, p in ((faults, preempt), (jax_faults, jax_preempt)):
        f.install(None)
        p.reset()
    ckpt._SAVE_WALLS.clear()
    telemetry.clear_events()
    yield
    for f, p in ((faults, preempt), (jax_faults, jax_preempt)):
        f.install(None)
        p.uninstall()
    ckpt._SAVE_WALLS.clear()
    telemetry.clear_events()


def _model(nt=NT, shape=(32, 32)):
    """(advance(state, n) -> state, (T,)): diffusion perf, f64, one rank."""
    cfg = DiffusionConfig(global_shape=shape, nt=nt, warmup=0, dtype="f64", dims=(1, 1))
    model = HeatDiffusion(cfg, device="cpu")
    T, Cp = model.init_state()
    advance = model.advance_fn("perf")
    return (lambda s, n: (advance(s[0], Cp, n),)), (T,)


def _straight(adv, state, n=NT):
    return adv((state[0].clone(),), n)


def _events(name=None):
    return [r for r in telemetry.records(kind="event") if name is None or r["name"] == name]


# ---------------------------------------------------------------------------
# The fault grammar and its firing, against the JAX package
# ---------------------------------------------------------------------------

# Every spec the JAX package's tests use (tests/test_resilience.py,
# test_elastic.py, test_storage_preempt.py, test_serving.py, test_fleet.py).
SPECS = [
    "crash@step=12", "crash@step=4", "crash@step=8,at=segment-pre", "crash@segment=2",
    "delay=1.5@step=2,rank=1;kill@step=4", "die@step=2,rank=1,at=serve-batch",
    "die@step=8,rank=1", "kill@step=3,rank=1", "kill@step=2,rank=1,at=serve-batch",
    "stall@step=8,rank=1,at=segment-pre", "stall@step=3,rank=1,at=serve-batch",
    "stall@step=14,rank=1", "truncate-latest", "truncate-latest@step=16;crash@step=16",
    "enospc@step=4", "enospc@step=8,times=2;enospc@step=12", "io-error@step=4,at=restore",
    "io-error@step=4,times=3", "io-error@step=6,times=3;io-slow=0.1@step=8;",
    "io-error@step=6,times=3;queue-flood=8@step=2", "io-error@step=8,times=2;io-error@step=12",
    "io-error@step=8;io-slow=0.5@step=4;enospc@step=12,times=3",
    "io-slow=1.2@step=8;io-slow=1.2@step=12", "io-slow@step=4", "batch-error@step=1",
    "batch-error@step=1;batch-error@step=2;batch-error@step=3",
    "batch-error@step=2;lane-nan@request=1", "lane-nan@request=2,times=9;lane-nan@request=4,times=9;",
    "lane-nan@request=3,times=2;batch-error@step=2;", "queue-flood=10@step=2;lane-nan@request=3,times=9;",
    "queue-flood@step=1", "slow-batch=0.05@step=2,times=2;", "slow-batch=0.05@step=3;batch-error@step=4",
    "slow-batch@step=4", "replica-kill@step=2,rank=1", "replica-stall@step=1,rank=0",
]
BAD_SPECS = ["explode@step=3", "crash", "crash@when=now", "io-error", "io-error@step=4,times=0",
             "die", "kill@request=3", "lane-nan@step=3", "batch-error", "replica-kill@rank=1"]


def _clauses(plan):
    return [(c.kind, c.step, c.segment, c.rank, c.site, c.times, c.delay_s, c.request, repr(c))
            for c in plan.clauses]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_as_in_jax(spec):
    assert _clauses(faults.FaultPlan.parse(spec)) == _clauses(jax_faults.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as jax_err:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as port_err:
        faults.FaultPlan.parse(spec)
    assert str(port_err.value) == str(jax_err.value)


def _fire(module, spec, calls, rank):
    """The outcome of each fault_point(site, step) call in turn under
    `spec` on `rank`, and each clause's fire count."""
    os.environ["RMT_PROCESS_ID"] = str(rank)
    plan = module.install(spec)
    seen = []
    for site, step in calls:
        try:
            module.fault_point(site, step=step)
            seen.append("ok")
        except module.InjectedCrash:
            seen.append("crash")
        except OSError as exc:
            seen.append(f"oserror {errno.errorcode[exc.errno]}")
    return seen, [c.fires for c in plan.clauses]


FIRING = [
    ("crash@step=5", [("segment", 5), ("segment", 5)], 0),
    ("crash@step=8", [("segment-pre", 8), ("save", 8), ("segment", 8)], 0),
    ("crash@step=8,at=segment-pre", [("segment", 8), ("segment-pre", 8), ("segment-pre", 8)], 0),
    ("crash@step=4,rank=1", [("segment", 4)], 0),
    ("crash@step=4,rank=1", [("segment", 4)], 1),
    ("crash@segment=2", [("segment", 4), ("segment", 8), ("segment", 12)], 0),
    ("crash@step=3,times=2", [("segment", 3)] * 3, 0),
    ("io-error@step=8,times=2", [("save", 8)] * 3 + [("segment", 8)], 0),
    ("enospc@step=4", [("segment", 4), ("save", 4), ("save", 4)], 0),
    ("io-error@step=4,at=restore", [("save", 4), ("restore", 4), ("restore", 4)], 0),
    ("crash@step=2;crash@step=2,at=window", [("window", 2), ("step", 2), ("window", 2)], 0),
    ("batch-error@step=2;crash@step=2", [("segment", 2), ("serve-batch", 2)], 0),
    ("crash@step=1,at=serve-batch", [("segment", 1), ("serve-batch", 1)], 0),
    ("delay=0.01@step=1;crash@step=1", [("init", None), ("step", 1), ("step", 1)], 0),
]


@pytest.mark.parametrize("spec,calls,rank", FIRING)
def test_fault_firing_as_in_jax(monkeypatch, spec, calls, rank):
    """Fire counts, times= re-arming, rank scoping and opt-in sites: the
    same sequence of fault_point calls gives the same outcomes."""
    monkeypatch.setenv("RMT_PROCESS_ID", "0")
    assert _fire(faults, spec, calls, rank) == _fire(jax_faults, spec, calls, rank)


def test_serving_and_replica_faults_as_in_jax(monkeypatch):
    monkeypatch.setenv("RMT_PROCESS_ID", "0")
    spec = ("lane-nan@request=3,times=2;batch-error@step=2;slow-batch=0.05@step=4;"
            "replica-kill@step=2,rank=1;replica-stall@step=3")

    def run(module):
        module.install(spec)
        got = [repr(module.serving_fault("lane-nan", request=r)) for r in (1, 3, 3, 3)]
        got += [repr(module.serving_fault("batch-error", step=s)) for s in (1, 2, 2)]
        got += [repr(module.serving_fault("slow-batch", step=4))]
        got += [repr(module.replica_fault("replica-kill", step=2, replica=r)) for r in (0, 1)]
        got += [repr(module.replica_fault("replica-stall", step=3, replica=5))]
        with pytest.raises(ValueError):
            module.serving_fault("crash", step=1)
        return got

    assert run(faults) == run(jax_faults)


def test_env_plan_installs_once_and_install_supersedes_it(monkeypatch):
    for module in (faults, jax_faults):
        monkeypatch.setattr(module, "_ENV_CONSUMED", False)
        monkeypatch.setattr(module, "_PLAN", None)
        monkeypatch.setenv(module.ENV_VAR, "crash@step=3")
        plan = module.install_from_env()
        assert [c.kind for c in plan.clauses] == ["crash"] and module.active_plan() is plan
        monkeypatch.setenv(module.ENV_VAR, "kill@step=9")
        assert module.install_from_env() is plan  # at most once a process
        assert module.install(None) is None and module.install_from_env() is None
    assert (faults.RC_INJECTED_KILL, faults.RC_INJECTED_DIE) == (43, 0) == (
        jax_faults.RC_INJECTED_KILL, jax_faults.RC_INJECTED_DIE)


def test_the_rank_comes_from_the_environment(monkeypatch):
    monkeypatch.delenv("RMT_PROCESS_ID", raising=False)
    monkeypatch.setenv("RANK", "3")
    assert faults._rank() == 3  # torchrun's variable; no process group formed
    monkeypatch.setenv("RMT_PROCESS_ID", "2")
    assert faults._rank() == 2


# ---------------------------------------------------------------------------
# Policy and preemption tables, save_wall_p90
# ---------------------------------------------------------------------------


def test_elastic_policy_tables_as_in_jax():
    plans = [lambda b: b, lambda b: 2, lambda b: max(b - b % 2, 1)]
    for kw in ({}, {"min_ranks": 2}, {"grow": False}, {"min_grow_interval_steps": 8}):
        ours, theirs = policy.ElasticPolicy(**kw), jax_policy.ElasticPolicy(**kw)
        for n in range(1, 6):
            assert ours.give_up(n) == theirs.give_up(n)
            for plan in plans:
                for dead in range(0, 4):
                    assert ours.shrink_target(n, dead, plan) == theirs.shrink_target(n, dead, plan)
                for budget in range(1, 9):
                    assert ours.grow_target(n, budget, plan) == theirs.grow_target(n, budget,
                                                                                  plan)
            for budget in range(1, 9):
                for step, last in ((None, None), (12, 8), (16, 8), (16, None), (4, 0)):
                    assert (ours.wants_grow(n, budget, step=step, last_change_step=last)
                            == theirs.wants_grow(n, budget, step=step, last_change_step=last))


def test_request_retry_and_circuit_policies_as_in_jax():
    for kw in ({}, {"budget": 0}, {"backoff_base_s": 0.1, "backoff_cap_s": 0.3}):
        ours, theirs = policy.RequestRetryPolicy(**kw), jax_policy.RequestRetryPolicy(**kw)
        assert [ours.backoff_s(r) for r in range(6)] == [theirs.backoff_s(r) for r in range(6)]
    for bad in ({"budget": -1}, {"backoff_s": -1.0}):
        key = next(iter(bad))
        kw = {"backoff_base_s": -1.0} if key == "backoff_s" else bad
        with pytest.raises(ValueError):
            policy.RequestRetryPolicy(**kw)
    assert policy.CircuitPolicy(k=0).enabled is jax_policy.CircuitPolicy(k=0).enabled is False
    with pytest.raises(ValueError):
        policy.CircuitPolicy(cooldown_drains=0)


@pytest.mark.parametrize("walls", [[], [2.0], [2.0] + [1.0] * 9, [0.3, 0.9, 0.1, 5.0, 0.7],
                                   [float(i) for i in range(40)]])
def test_save_wall_p90_as_in_jax(walls):
    ckpt._SAVE_WALLS.clear()
    jax_ckpt._SAVE_WALLS.clear()
    try:
        ckpt._SAVE_WALLS.extend(walls)
        jax_ckpt._SAVE_WALLS.extend(walls)
        assert ckpt.save_wall_p90() == jax_ckpt.save_wall_p90()
    finally:
        jax_ckpt._SAVE_WALLS.clear()


@pytest.mark.parametrize("grace", [None, 60.0, 5.0, 1.0, 0.0])
def test_budget_allows_save_as_in_jax(grace):
    for p90 in (None, 0.5, 1.0, 5.0, 50.0):
        for module in (preempt, jax_preempt):
            module.reset()
            if grace is not None:
                module.request(grace_s=grace)
        assert preempt.budget_allows_save(p90) == jax_preempt.budget_allows_save(p90)


def test_request_latch_and_notice():
    assert preempt.requested() is False and preempt.note_noticed() is False
    preempt.request(grace_s=30.0)
    first = preempt.remaining_grace_s()
    preempt.request(grace_s=500.0)  # the first request wins
    assert preempt.remaining_grace_s() <= first
    assert preempt.note_noticed() is True and preempt.note_noticed() is False
    preempt.reset()
    assert preempt.requested() is False
    assert (preempt.RC_PREEMPTED, preempt.DEFAULT_GRACE_S, preempt.ENV_GRACE) == (
        jax_preempt.RC_PREEMPTED, jax_preempt.DEFAULT_GRACE_S, jax_preempt.ENV_GRACE)


def test_install_from_env_and_the_sigterm_handler(monkeypatch):
    monkeypatch.delenv(preempt.ENV_GRACE, raising=False)
    assert preempt.install_from_env() is False
    monkeypatch.setenv(preempt.ENV_GRACE, "not-a-number")
    assert preempt.install_from_env() is False
    monkeypatch.setenv(preempt.ENV_GRACE, "45.5")
    assert preempt.install_from_env() is True
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not preempt.requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        rem = preempt.remaining_grace_s()
        assert preempt.requested() and rem is not None and 40.0 < rem <= 45.5
    finally:
        preempt.uninstall()
    assert preempt.requested() is False


def test_forwarder_relays_sigterm_to_live_ranks():
    sent = []

    class _Proc:
        def __init__(self, live=True):
            self.live = live

        def poll(self):
            return None if self.live else 0

        def send_signal(self, sig):
            sent.append(sig)

    restore = preempt.install_forwarder([_Proc(), _Proc(live=False), _Proc()])
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not preempt.requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert preempt.requested() and sent == [signal.SIGTERM, signal.SIGTERM]
    finally:
        restore()
        preempt.reset()


def test_preempted_is_resumable_never_retried():
    exc = preempt.Preempted(step=8, saved=True)
    assert exc.code == preempt.RC_PREEMPTED == 75 and isinstance(exc, SystemExit)
    assert default_retryable(exc) is False
    assert default_retryable(InjectedCrash("x")) and default_retryable(OSError("x"))
    assert default_retryable(torch.cuda.OutOfMemoryError("x"))  # torch's CUDA errors
    assert not default_retryable(ValueError("x")) and not default_retryable(TypeError("x"))


def test_the_grid_agrees_a_notice_only_where_the_ranks_armed_the_handler(monkeypatch):
    """On a grid of several ranks the boundary's poll is one gather, and
    ranks that armed no SIGTERM handler skip it: none can be told."""
    import types

    gathers = []

    def gather(obj, grid):
        gathers.append(obj)
        return [obj, (False, None, None)]

    monkeypatch.setattr(ckpt, "_distributed", lambda: True)
    monkeypatch.setattr(ckpt, "_gather", gather)
    grid = types.SimpleNamespace(nprocs=2, group=None)
    assert ckpt._preempt_notice(grid) is None and gathers == []
    assert preempt.install(30.0) is True
    assert preempt.armed() is True
    assert ckpt._preempt_notice(grid) is None and len(gathers) == 1
    preempt.request()
    remaining, p90 = ckpt._preempt_notice(grid)
    assert len(gathers) == 2 and 0.0 < remaining <= 30.0 and p90 is None
    preempt.uninstall()
    assert preempt.armed() is False


# ---------------------------------------------------------------------------
# Preemption in the segmented loop (test_storage_preempt.py's cases)
# ---------------------------------------------------------------------------


def test_preempt_with_grace_lands_the_emergency_save(tmp_path):
    adv, state = _model(nt=16)
    preempt.request(grace_s=60.0)
    with pytest.raises(preempt.Preempted) as ei:
        ckpt.run_segmented(adv, state, 16, tmp_path, every=4)
    assert ei.value.saved is True and ei.value.step == 4 and ei.value.code == 75
    assert ckpt.latest_valid_step(tmp_path) == 4
    names = [r["name"] for r in _events()]
    assert "preempt.noticed" in names and "preempt.save" in names
    save = _events("preempt.save")[0]
    assert save["step"] == 4 and save["remaining_grace_s"] <= 60.0


def test_preempt_without_grace_skips_the_save_and_leaves_no_torn_step(tmp_path):
    adv, state = _model(nt=16)
    out = ckpt.run_segmented(adv, state, 8, tmp_path, every=4)
    telemetry.clear_events()
    preempt.request(grace_s=0.0)
    with pytest.raises(preempt.Preempted) as ei:
        ckpt.run_segmented(adv, out, 16, tmp_path, every=4, start_step=8)
    assert ei.value.saved is False and ei.value.step == 8
    assert ckpt.all_steps(tmp_path) == [4, 8]
    assert not list(tmp_path.glob(".*.partial"))
    skip = _events("preempt.skip-save")
    assert len(skip) == 1 and skip[0]["last_valid_step"] == 8
    assert not _events("preempt.save")


def test_preempt_noticed_after_the_save_stops_at_that_boundary(tmp_path, monkeypatch):
    adv, state = _model(nt=16)
    real = ckpt._guarded_save

    def hooked(*a, **kw):
        durable = real(*a, **kw)
        if not preempt.requested():
            preempt.request(grace_s=60.0)
        return durable

    monkeypatch.setattr(ckpt, "_guarded_save", hooked)
    with pytest.raises(preempt.Preempted) as ei:
        ckpt.run_segmented(adv, state, 16, tmp_path, every=4)
    assert ei.value.step == 4 and ei.value.saved is True
    stop = _events("preempt.stop")
    assert len(stop) == 1 and stop[0]["saved"] is True


def test_the_budget_decision_reads_the_measured_p90(tmp_path):
    """Saves measured slower than the grace allows: the boundary skips."""
    adv, state = _model(nt=16)
    ckpt._SAVE_WALLS.extend([10.0] * 5)  # a 10 s p90 against a 5 s grace
    preempt.request(grace_s=5.0)
    with pytest.raises(preempt.Preempted) as ei:
        ckpt.run_segmented(adv, state, 16, tmp_path, every=4)
    assert ei.value.saved is False and ckpt.all_steps(tmp_path) == []
    assert _events("preempt.skip-save")[0]["save_wall_p90_s"] == 10.0


# ---------------------------------------------------------------------------
# The storage kinds through the fault plan
# ---------------------------------------------------------------------------


def _policy(**kw):
    return ckpt.StoragePolicy(**{"retries": 2, "backoff_s": 0.001, **kw})


def test_transient_io_error_retries_at_the_save_site(tmp_path):
    adv, state = _model(nt=16)
    faults.install("io-error@step=8,times=2")
    out = ckpt.run_segmented(adv, state, 16, tmp_path, every=4, storage=_policy())
    assert torch.equal(out[0], _straight(*_model(nt=16), n=16)[0])
    assert ckpt.all_steps(tmp_path) == [8, 12, 16]
    assert [r["attempt"] for r in _events("ckpt.retry")] == [0, 1]
    assert not list(tmp_path.glob(".*.partial"))


def test_io_error_outage_degrades_then_recovers_with_the_result_unchanged(tmp_path):
    adv, state = _model(nt=16)
    faults.install("io-error@step=8,times=3")
    out = ckpt.run_segmented(adv, state, 16, tmp_path, every=4, storage=_policy(), keep=8)
    assert torch.equal(out[0], _straight(*_model(nt=16), n=16)[0])
    assert ckpt.all_steps(tmp_path) == [4, 12, 16]
    degraded = _events("ckpt.degraded")
    assert degraded[0]["reason"] == "io-error" and degraded[0]["last_valid_step"] == 4
    assert _events("ckpt.recovered")[0]["step"] == 12


def test_enospc_prunes_then_the_save_lands(tmp_path):
    adv, state = _model(nt=16)
    faults.install("enospc@step=12")
    ckpt.run_segmented(adv, state, 16, tmp_path, every=4, storage=_policy(), keep=8)
    assert _events("ckpt.enospc-prune")[0]["pruned_steps"] == [4]
    assert ckpt.all_steps(tmp_path) == [8, 12, 16]


def test_io_slow_trips_the_watchdog(tmp_path):
    adv, state = _model(nt=12)
    faults.install("io-slow=0.3@step=8")
    ckpt.run_segmented(adv, state, 12, tmp_path, every=4,
                       storage=_policy(slow_save_timeout_s=0.2), keep=8)
    assert _events("ckpt.degraded")[0]["reason"] == "io-slow"
    assert ckpt.all_steps(tmp_path) == [4, 8, 12]


def test_restore_site_retries_a_transient_error(tmp_path):
    adv, state = _model(nt=8)
    ckpt.run_segmented(adv, state, 8, tmp_path, every=4)
    faults.install("io-error@step=8,at=restore")
    got = ckpt.restore_state(tmp_path, 8, _model(nt=8)[1])
    assert torch.equal(got[0], _straight(*_model(nt=8), n=8)[0])
    assert _events("ckpt.retry")[0]["op"] == "restore"


# ---------------------------------------------------------------------------
# Supervised runs
# ---------------------------------------------------------------------------


def _jax_straight(nt=NT, shape=(32, 32)):
    """(the JAX package's initial T as numpy, its straight perf run)."""
    cfg = JaxDiffusionConfig(global_shape=shape, lengths=(10.0, 10.0), nt=nt, warmup=0,
                             dtype="f64", dims=(1, 1))
    model = JaxHeatDiffusion(cfg, devices=jax.devices()[:1])
    T, Cp = model.init_state()
    T0 = np.asarray(T).copy()
    return T0, np.asarray(model.advance_fn("perf")(T, Cp, nt))


def test_supervised_crash_recovers_bitwise_and_matches_jax(tmp_path):
    T0, jax_out = _jax_straight()
    adv, _ = _model()
    state = (torch.from_numpy(T0),)
    ref = _straight(adv, state)
    faults.install(f"crash@step={NT // 2}")
    waits, lines = [], []
    out = run_supervised(adv, state, NT, tmp_path, EVERY, sleep=waits.append, log=lines.append)
    assert torch.equal(out[0], ref[0])
    np.testing.assert_allclose(out[0].numpy(), jax_out, **TOL64)
    assert waits == [0.5]
    names = [r["name"] for r in _events()]
    for name in ("attempt-failed", "backoff", "restored", "recovered"):
        assert name in names, names
    assert _events("restored")[0]["step"] == NT // 2
    assert f"supervisor: restored step {NT // 2} from {tmp_path}" in lines


def test_supervised_run_skips_a_truncated_latest_step(tmp_path):
    adv, state = _model()
    ref = _straight(adv, state)
    faults.install(f"truncate-latest@step={NT // 2};crash@step={NT // 2}")
    out = run_supervised(adv, state, NT, tmp_path, EVERY, sleep=lambda _: None)
    assert torch.equal(out[0], ref[0])
    assert _events("restored")[0]["step"] == NT // 2 - EVERY


def test_supervised_cold_restart_before_the_first_checkpoint(tmp_path):
    adv, state = _model()
    ref = _straight(adv, state)
    template = state[0].clone()
    flaky = {"fails": 1}

    def adv_flaky(s, n):
        out = adv(s, n)  # the perf advance overwrites its input, as JAX donates it
        if flaky["fails"]:
            flaky["fails"] -= 1
            raise RuntimeError("transient CUDA error (simulated)")
        return out

    out = run_supervised(adv_flaky, state, NT, tmp_path, EVERY, sleep=lambda _: None)
    assert torch.equal(out[0], ref[0])
    assert _events("backoff") and torch.equal(state[0], template)


def test_supervised_retries_are_bounded_with_exponential_backoff(tmp_path):
    """A sticky error (every call fails, as a sticky CUDA error does) ends
    in gave-up after max_retries + 1 attempts."""
    calls, waits = [], []

    def always_fails(state, n):
        calls.append(n)
        raise torch.cuda.OutOfMemoryError("sticky device error (simulated)")

    with pytest.raises(RuntimeError, match="sticky"):
        run_supervised(always_fails, (torch.zeros(4),), 8, tmp_path, 4, max_retries=3,
                       sleep=waits.append)
    assert len(calls) == 4 and waits == [0.5, 1.0, 2.0]
    assert [len(_events(n)) for n in ("attempt-failed", "backoff", "gave-up")] == [4, 3, 1]


def test_supervised_does_not_retry_programming_errors(tmp_path):
    def broken(state, n):
        raise ValueError("bad argument — retrying cannot help")

    with pytest.raises(ValueError):
        run_supervised(broken, (torch.zeros(4),), 8, tmp_path, 4, sleep=lambda _: None)
    assert _events("backoff") == []
    with pytest.raises(ValueError, match="max_retries"):
        run_supervised(broken, (torch.zeros(4),), 8, tmp_path, 4, max_retries=-1)


def test_supervised_retry_under_the_scan_driver_captures_no_new_graph(fake_cuda, tmp_path):  # noqa: F811
    g = torch.Generator().manual_seed(0)
    T0 = torch.rand(12, 8, generator=g, dtype=torch.float64)
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    loop = scan.ScanLoop(_toy_step, scan.graph_plan(EVERY, 2), "scan-graph", exact=True)
    graphs = []

    def advance(s, n):
        (T,) = loop((s[0],), (C,), n)
        graphs.append(len(loop.graphs))
        return (T,)

    faults.install(f"crash@step={NT // 2}")
    out = run_supervised(advance, (T0.clone(),), NT, tmp_path, EVERY, sleep=lambda _: None)
    eager = scan.ScanLoop(_toy_step, scan.graph_plan(NT, 2), "scan-eager", exact=True)
    assert torch.equal(out[0], eager((T0.clone(),), (C,), NT)[0])
    assert len(graphs) == NT // EVERY  # the retry resumed at the crash's saved step
    assert set(graphs) == {loop.plan.graphs}  # captured in the first segment, never again


# ---------------------------------------------------------------------------
# Restores onto another process grid, and the rebuilt per-grid machinery
# ---------------------------------------------------------------------------


def _assemble(blocks, dims, shape):
    out = np.empty(shape)
    for rank, block in enumerate(blocks):
        g = mesh.init_global_grid(*shape, dims=dims, nprocs=len(blocks), rank=rank)
        out[g.shard_slices()] = block
    return out


def test_a_2x2_checkpoint_restores_bitwise_onto_other_grids(tmp_path):
    """Saved by 4 gloo ranks on 2×2; restored here onto 1×2, 2×1 and one
    rank (each rank reading the shards its block overlaps), onto 4×1, and
    resharded live onto 2×1 and back."""
    shape = (32, 32)
    spec = dict(shape=shape, nt=16, every=8, dir=str(tmp_path))
    ranks = spawn_ranks(4, worker.reshard_rank, (spec,), backend="gloo", timeout=300)
    field = _assemble([r["shard"] for r in ranks], (2, 2), shape)  # what the ranks saved
    assert np.array_equal(_assemble([r["narrow"] for r in ranks[:2]], (2, 1), shape), field)
    assert all(r["narrow"] is None for r in ranks[2:])
    assert all(np.array_equal(r["back"], r["shard"]) for r in ranks)
    for dims in ((1, 2), (2, 1), (1, 1), (4, 1)):
        n = int(np.prod(dims))
        blocks = []
        for rank in range(n):
            grid = mesh.init_global_grid(*shape, dims=dims, nprocs=n, rank=rank)
            got = ckpt.restore_state(tmp_path, 16, None, grid=grid, devices="cpu")
            assert got[0].shape == grid.local_shape
            blocks.append(got[0].numpy())
        assert np.array_equal(_assemble(blocks, dims, shape), field), dims
    # With a template on the new grid, the same.
    grid = mesh.init_global_grid(*shape, dims=(2, 1), nprocs=2, rank=1)
    like = (torch.zeros(grid.local_shape, dtype=torch.float64),)
    got = ckpt.restore_state(tmp_path, 16, like, grid=grid)
    assert np.array_equal(got[0].numpy(), field[16:])
    # A block reads only the saved shards it overlaps.
    real = ckpt._read_array
    seen = []
    grid = mesh.init_global_grid(*shape, dims=(4, 1), nprocs=4, rank=0)
    reshard.read_block(tmp_path, 16, ckpt.read_manifest(tmp_path, 16), grid,
                       read=lambda p: seen.append(p.parent.name) or real(p))
    assert sorted(seen) == ["rank-0", "rank-1"]


def test_a_one_rank_checkpoint_restores_onto_2x2_and_a_flipped_byte_is_refused(tmp_path):
    adv, state = _model(nt=8)
    out = ckpt.run_segmented(adv, state, 8, tmp_path, every=8)
    blocks = [ckpt.restore_state(tmp_path, 8, None, devices="cpu", grid=mesh.init_global_grid(
        32, 32, dims=(2, 2), nprocs=4, rank=r))[0].numpy() for r in range(4)]
    assert np.array_equal(_assemble(blocks, (2, 2), (32, 32)), out[0].numpy())
    leaf = tmp_path / "8" / "rank-0" / "leaf-0.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-3] ^= 0x10
    leaf.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorruptionError, match="crc32"):
        ckpt.restore_state(tmp_path, 8, None, devices="cpu",
                           grid=mesh.init_global_grid(32, 32, dims=(2, 1), nprocs=2, rank=0))


def test_template_and_state_meta(tmp_path):
    adv, state = _model(nt=8)
    ckpt.run_segmented(adv, state, 8, tmp_path, every=8)
    manifest = ckpt.read_manifest(tmp_path, 8)
    assert reshard.state_meta(state) == {k: manifest["meta"][k] for k in ("mesh", "specs")}
    grid = mesh.init_global_grid(32, 32, dims=(4, 2), nprocs=8, rank=5)
    (t,) = reshard.template_from_meta(manifest, grid)
    assert t.device.type == "meta" and t.shape == (8, 16) and t.dtype == torch.float64
    with pytest.raises(ValueError, match="divisible"):
        reshard.template_from_meta(manifest, mesh.GlobalGrid((32, 30), (1.0, 1.0), (1, 3)))
    with pytest.raises(ValueError, match="v1"):
        reshard.template_from_meta({"leaves": []})


@pytest.mark.parametrize("shape", [(32, 32), (30, 30), (7, 7), (12288, 12288), (24, 36, 48)])
def test_plan_mesh_dims_as_in_jax(shape):
    axes = ["gx", "gy", "gz"][:len(shape)]
    for specs in ([axes], [axes, None]):
        meta = {"mesh": {"dims": [1] * len(shape), "axes": axes}, "specs": specs}
        shapes = [list(shape)] * len(specs)
        for budget in range(1, 9):
            assert reshard.plan_mesh_dims(meta, shapes, budget) == \
                jax_reshard.plan_mesh_dims(meta, shapes, budget)
            assert mesh.plan_dims(shape, budget) == jax_mesh.plan_dims(shape, budget)


@pytest.mark.parametrize("old,new", [((2, 4), (2, 2)), ((2, 2), (4, 2)), ((1, 1), (2, 1))])
def test_mesh_rebuild_equals_a_fresh_grid(old, new):
    n_old, n_new = int(np.prod(old)), int(np.prod(new))
    grid = mesh.init_global_grid(32, 32, dims=old, nprocs=n_old, rank=0)
    for rank in range(n_new):
        got = mesh.rebuild_for_mesh(grid, dims=new, nprocs=n_new, rank=rank)
        assert got == mesh.init_global_grid(32, 32, dims=new, nprocs=n_new, rank=rank)
        assert got.exchange_buffers == {} and got.lengths == grid.lengths
    planned = mesh.rebuild_for_mesh(grid, nprocs=n_new, rank=0)
    assert planned.dims == mesh.plan_dims((32, 32), n_new)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rebuild_for_mesh(grid, dims=(3, 1), nprocs=3, rank=0)
    with pytest.raises(ValueError, match="need"):
        mesh.rebuild_for_mesh(grid, dims=(4, 4), nprocs=8, rank=0)


def test_halo_rebuild_rederives_the_geometry_as_in_jax():
    grid = mesh.init_global_grid(32, 32, dims=(2, 4), nprocs=8, rank=5)
    prog = halo.build_for_mesh(grid, width=2, wire_mode="bf16")
    re = halo.rebuild_for_mesh(prog, dims=(2, 2), nprocs=4, rank=3)
    assert re.grid == mesh.init_global_grid(32, 32, dims=(2, 2), nprocs=4, rank=3)
    assert (re.width, re.wire_mode) == (2, "bf16")
    jgrid = jax_mesh.init_global_grid(32, 32, dims=(2, 4), devices=jax.devices()[:8])
    jre = jax_halo.rebuild_for_mesh(jax_halo.build_for_mesh(jgrid, 2, wire_mode="bf16"),
                                    dims=(2, 2), devices=jax.devices()[:4])
    for itemsize in (2, 4, 8):
        assert re.nbytes(itemsize) == jre.nbytes(itemsize) != prog.nbytes(itemsize)
    assert re.faces_nbytes(8) == halo.faces_nbytes((16, 16), 8, re.grid, "bf16")
    with pytest.raises(ValueError, match="width"):
        halo.rebuild_for_mesh(grid, dims=(1, 1), nprocs=1, rank=0, width=33)


@pytest.mark.parametrize("kind", ["diffusion", "wave", "swe"])
def test_deep_schedule_rebuild_equals_a_fresh_build(kind):
    from rocm_mpi_tpu_torch.config import SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, ShallowWater

    old = mesh.init_global_grid(32, 32, dims=(2, 1), nprocs=2, rank=0)
    new = mesh.rebuild_for_mesh(old, dims=(1, 1), nprocs=1, rank=0)
    sp = new.spacing
    if kind == "diffusion":
        cfg = DiffusionConfig(global_shape=(32, 32), nt=8, warmup=0, dtype="f64", dims=(1, 1))
        sched = deep_halo.make_deep_sweep(old, 4, cfg.lam, cfg.dt, sp, local_form="jnp")
        fresh = deep_halo.make_deep_sweep(new, 4, cfg.lam, cfg.dt, sp, local_form="jnp")
        T, Cp = HeatDiffusion(cfg, device="cpu").init_state()
        run = lambda s: s.sweep(T.clone(), s.prepare(Cp))  # noqa: E731
    elif kind == "wave":
        cfg = WaveConfig(global_shape=(32, 32), nt=8, warmup=0, dtype="f64", dims=(1, 1))
        sched = deep_halo.make_wave_deep_sweep(old, 4, cfg.dt, sp)
        fresh = deep_halo.make_wave_deep_sweep(new, 4, cfg.dt, sp)
        U, Up, C2 = AcousticWave(cfg, device="cpu").init_state()
        run = lambda s: s.sweep(U.clone(), Up.clone(), s.prepare(C2))  # noqa: E731
    else:
        cfg = SWEConfig(global_shape=(32, 32), nt=8, warmup=0, dtype="f64", dims=(1, 1))
        model = ShallowWater(cfg, device="cpu")
        sched = deep_halo.make_swe_deep_sweep(old, 4, cfg.dt, sp, cfg.H0, cfg.g)
        fresh = deep_halo.make_swe_deep_sweep(new, 4, cfg.dt, sp, cfg.H0, cfg.g)
        h, us = model.init_state()
        run = lambda s: s.sweep(h.clone(), tuple(u.clone() for u in us), s.prepare(h))  # noqa: E731
    rebuilt = deep_halo.rebuild_for_mesh(sched, new)
    assert rebuilt.k == fresh.k == 4
    got, want = run(rebuilt), run(fresh)
    for a, b in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(want)):
        assert torch.equal(a, b)
    assert deep_halo.rebuild_for_mesh(sched, old, dims=(1, 1), nprocs=1).k == 4
    with pytest.raises(ValueError, match="rebuild"):
        deep_halo.rebuild_for_mesh(deep_halo.DeepSchedule(lambda x: x, lambda x, c: x, 4), new)
    with pytest.raises(ValueError, match="exceeds"):
        deep_halo.rebuild_for_mesh(deep_halo.make_deep_sweep(old, 12, 1.0, 0.1, sp), old,
                                   dims=(4, 1), nprocs=4)


# ---------------------------------------------------------------------------
# The apps
# ---------------------------------------------------------------------------


def _app(app, *argv, rc=0):
    cmd = [sys.executable, "-m", f"rocm_mpi_tpu_torch.apps.{app}", "--device", "cpu", *argv]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == rc, (proc.returncode, proc.stdout, proc.stderr)
    return proc


@pytest.mark.parametrize("app", ["swe_2d", "diffusion_2d_perf"])
def test_app_supervised_crash_recovers_bitwise(tmp_path, app):
    straight, recovered = tmp_path / "s.npy", tmp_path / "r.npy"
    common = ["--nx", "24", "--ny", "24", "--nt", "12", "--warmup", "0"]
    _app(app, *common, "--save-field", str(straight))
    out = _app(app, *common, "--checkpoint", str(tmp_path / "ck"), "--ckpt-every", "4",
               "--retries", "1", "--inject-fault", "crash@step=4",
               "--save-field", str(recovered)).stdout
    assert "supervisor: restored step 4" in out and "not ported" not in out, out
    np.testing.assert_array_equal(np.load(recovered), np.load(straight))


def test_weak_scaling_reaches_the_window_site_without_the_flight_recorder(tmp_path,
                                                                         monkeypatch):
    """A windowed rung (telemetry on, no --health) passes the "window"
    site at every window, as the JAX app does: crash@step=12,at=window
    stops it at the second of its windows (4 warm-up steps, then 8, 8, 4)."""
    from rocm_mpi_tpu_torch.apps import weak_scaling
    from rocm_mpi_tpu_torch.telemetry import compiles, events, flight

    monkeypatch.setattr(events, "_ENABLED", False)
    monkeypatch.setattr(events, "_DIR", None)
    monkeypatch.setattr(events, "_RANK", None)
    monkeypatch.setattr(flight, "_ENABLED", False)
    events.clear()
    compiles.reset()
    faults.install("crash@step=12,at=window")
    try:
        with pytest.raises(InjectedCrash, match="'window'"):
            weak_scaling.main(["--device", "cpu", "--local", "16", "--nt", "24", "--warmup",
                               "4", "--counts", "1", "--telemetry-windows", "3",
                               "--telemetry", str(tmp_path / "telemetry")])
        assert not flight.enabled()
        windows = events.records("span", name="step_window")
        assert [r["attrs"]["steps"] for r in windows] == [8]
        assert [c.fires for c in faults.active_plan().clauses] == [1]
    finally:
        events.clear()
        compiles.reset()


class _Exited(BaseException):
    """os._exit, stood in for."""


def test_a_crashed_nccl_rank_exits_at_once_and_a_preemption_finalizes(monkeypatch, capsys):
    """apps/_common.finalized: a crash on a rank of several over NCCL
    prints the traceback and exits 1 without the teardown (its peers may
    wait on it); a preemption, and a crash over gloo, leave through
    distributed.finalize."""
    from rocm_mpi_tpu_torch.apps import _common
    from rocm_mpi_tpu_torch.parallel import distributed

    calls = []

    def exit_now(rc):
        raise _Exited(rc)

    monkeypatch.setattr(distributed, "finalize", lambda: calls.append("finalize"))
    monkeypatch.setattr(os, "_exit", exit_now)
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    monkeypatch.setattr(distributed, "backend", lambda: "nccl")
    with pytest.raises(_Exited) as ei:
        with _common.finalized():
            raise InjectedCrash("injected crash at fault point 'segment'")
    assert ei.value.args == (1,) and calls == []
    assert "InjectedCrash: injected crash at fault point 'segment'" in capsys.readouterr().err
    with pytest.raises(preempt.Preempted):
        with _common.finalized():
            raise preempt.Preempted(8, saved=True)
    assert calls == ["finalize"]
    monkeypatch.setattr(distributed, "backend", lambda: "gloo")
    with pytest.raises(InjectedCrash):
        with _common.finalized():
            raise InjectedCrash("x")
    assert calls == ["finalize", "finalize"]
