"""The port's argv launcher and elastic supervisor on the CPU
(parallel/launcher.spawn_app_ranks, resilience/elastic.py), held against
the JAX package: the same verdicts of `_judge` on the same launches, the
elastic policy executed against injected launchers (the JAX package's
_FakeProc drills), elastic.jsonl records and manifests accepted by the
JAX package's check_schema, the launcher naming a first failure, killing
a hung peer and flagging a vanished rank, and the gloo drills: 2 ranks of
diffusion perf lose rank 1 to kill, die or stall, shrink to one rank and
resume (from the steps of tests/test_elastic.py's drills) to a final field
bitwise equal to a one-rank continuation of the same checkpoint; then
the shrink-then-grow drill."""

import pathlib

import pytest
import torch

import test_torch_elastic_worker as worker
from rocm_mpi_tpu.parallel.launcher import LaunchReport as JaxLaunchReport
from rocm_mpi_tpu.parallel.launcher import RankResults as JaxRankResults
from rocm_mpi_tpu.resilience.elastic import _judge as jax_judge
from rocm_mpi_tpu.telemetry import regress as jax_regress
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.parallel.launcher import (
    LaunchReport,
    RankResults,
    spawn_app_ranks,
    spawn_ranks,
)
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
from rocm_mpi_tpu_torch.resilience import (
    ElasticExhausted,
    ElasticPolicy,
    faults,
    preempt,
    run_elastic,
)
from rocm_mpi_tpu_torch.resilience.elastic import _judge
from rocm_mpi_tpu_torch.resilience.faults import RC_INJECTED_KILL
from rocm_mpi_tpu_torch.telemetry import health
from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "test_torch_elastic_worker.py")
DRILL = dict(nx=16, ny=16, nt=16, every=4)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.install(None)
    preempt.reset()


class _FakeProc:
    def __init__(self, rc):
        self.returncode = rc


def _fake_results(rcs, first_failure=None, vanished=None, verdicts=(), jax=False):
    results, report = (JaxRankResults, JaxLaunchReport) if jax else (RankResults, LaunchReport)
    r = results((_FakeProc(rc), ("", "")) for rc in rcs)
    r.report = report()
    r.report.first_failure = first_failure
    r.report.vanished = vanished
    r.report.watchdog_verdicts = list(verdicts)
    return r


_STALL = {"rank": 1, "step": 8, "median_step": 10.0, "stalled_for_s": 6.0,
          "last_phase": "checkpoint"}
JUDGED = [
    ([0, 0], {}), ([75, 75], {}), ([0, 75], {}), ([75, -9], {}),
    ([75, 1], {"first_failure": (1, 1, 2.0)}), ([0, 43], {"first_failure": (1, 43, 1.0)}),
    ([0, -9], {"verdicts": [_STALL], "first_failure": (1, -9, 9.0)}),
    ([75, -9], {"verdicts": [_STALL]}), ([0, 0], {"vanished": 0, "first_failure": (0, 0, 4.0)}),
    ([75, 0], {"vanished": 1, "first_failure": (1, 0, 4.0)}), ([1, 0], {}),
    ([0, -9, -9, 0], {"verdicts": [_STALL, dict(_STALL, rank=2)],
                      "first_failure": (1, -9, 5.0)}),
]


@pytest.mark.parametrize("rcs,report", JUDGED)
def test_judge_as_in_jax(rcs, report):
    assert _judge(_fake_results(rcs, **report)) == jax_judge(_fake_results(rcs, **report,
                                                                           jax=True))


# ---------------------------------------------------------------------------
# The policy executed against injected launchers
# ---------------------------------------------------------------------------


def test_elastic_shrinks_once_then_completes(tmp_path):
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append((nprocs, inject_fault))
        if len(calls) == 1:
            return _fake_results([0, 43], first_failure=(1, 43, 1.0))
        return _fake_results([0] * nprocs)

    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         inject_fault="kill@step=8,rank=1", launch=launch)
    assert [c[0] for c in calls] == [2, 1]
    assert calls[0][1] == "kill@step=8,rank=1" and calls[1][1] is None
    assert report.shrinks == 1 and report.final_nprocs == 1
    names = [e["name"] for e in report.events]
    assert names == ["elastic.launch", "elastic.shrink", "elastic.launch", "elastic.complete"]
    shrink = report.events[1]
    assert shrink["old_mesh"] == [2, 1] and shrink["new_mesh"] == [1, 1]
    assert shrink["dead_ranks"] == [1]
    events, skipped = health.load_elastic_events(tmp_path)
    assert skipped == 0 and [e["name"] for e in events] == names


def test_elastic_judges_watchdog_and_vanish(tmp_path):
    seen = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        if not seen:
            seen.append("stall")
            return _fake_results([0, -9], verdicts=[_STALL], first_failure=(1, -9, 9.0))
        if len(seen) == 1:
            seen.append("vanish")
            return _fake_results([0, 0], vanished=0, first_failure=(0, 0, 4.0))
        return _fake_results([0] * nprocs)

    report = run_elastic(["worker.py"], 4, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch)
    assert report.shrinks == 2
    reasons = [launch["reason"] for launch in report.launches]
    assert reasons[0] == "watchdog-stall" and "vanished" in reasons[1]
    assert [launch["dead_ranks"] for launch in report.launches[:2]] == [[1], [0]]


def test_elastic_shrinks_past_every_dead_rank(tmp_path):
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append(nprocs)
        if len(calls) == 1:
            return _fake_results([0, -9, -9, 0], verdicts=[_STALL, dict(_STALL, rank=2)],
                                 first_failure=(1, -9, 5.0))
        return _fake_results([0] * nprocs)

    report = run_elastic(["worker.py"], 4, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch)
    assert calls == [4, 2] and report.launches[0]["dead_ranks"] == [1, 2]
    assert (report.events[1]["old_nprocs"], report.events[1]["new_nprocs"]) == (4, 2)


def test_elastic_gives_up_at_min_ranks(tmp_path):
    def launch(argv, nprocs, inject_fault=None, **kw):
        return _fake_results([1] * nprocs, first_failure=(0, 1, 0.5))

    with pytest.raises(ElasticExhausted, match="minimum rank count"):
        run_elastic(["worker.py"], 2, sidecar_dir=tmp_path, launch=launch)
    assert health.load_elastic_events(tmp_path)[0][-1]["name"] == "elastic.gave-up"
    with pytest.raises(ValueError):
        run_elastic(["worker.py"], 2, min_ranks=3, launch=launch)


def test_elastic_clean_run_never_shrinks(tmp_path):
    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=lambda argv, nprocs, **kw: _fake_results([0] * nprocs))
    assert report.shrinks == 0 and report.final_nprocs == 2
    assert [e["name"] for e in report.events] == ["elastic.launch", "elastic.complete"]
    st = health.elastic_status(report.events)
    assert st["shrunk"] is False and "SHRUNK" not in health.format_elastic_status(st)


def test_elastic_callable_argv_gets_the_rank_count(tmp_path):
    argvs = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        if len(argvs) == 1:
            return _fake_results([0, 1], first_failure=(1, 1, 1.0))
        return _fake_results([0] * nprocs)

    def make_argv(nprocs, attempt):
        argvs.append((nprocs, attempt))
        return ["worker.py", f"--n={nprocs}"]

    run_elastic(make_argv, 2, sidecar_dir=tmp_path, launch=launch)
    assert argvs == [(2, 0), (1, 1)]


def test_elastic_grows_after_a_preempted_launch(tmp_path):
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append((nprocs, kw.get("preempt_grace_s")))
        return _fake_results([75, 75] if len(calls) == 1 else [0] * nprocs)

    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch, device_budget=4)
    # The budget arms the ranks' grace, so a grow's SIGTERM is a preemption.
    assert calls == [(2, preempt.DEFAULT_GRACE_S), (4, preempt.DEFAULT_GRACE_S)]
    assert report.grows == 1 and report.shrinks == 0 and report.final_nprocs == 4
    assert [e["name"] for e in report.events] == ["elastic.launch", "elastic.grow",
                                                  "elastic.launch", "elastic.complete"]
    grow = report.events[1]
    assert (grow["old_mesh"], grow["new_mesh"], grow["reason"]) == ([2, 1], [2, 2],
                                                                     "device-budget")


def test_elastic_preempted_without_budget_resumes_the_same_grid(tmp_path):
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append(nprocs)
        return _fake_results([75, 75] if len(calls) == 1 else [0] * nprocs)

    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch)
    assert calls == [2, 2] and report.resumes == 1 and report.grows == 0
    assert [e["name"] for e in report.events] == ["elastic.launch", "elastic.resume",
                                                  "elastic.launch", "elastic.complete"]


def test_elastic_hysteresis_refuses_then_allows_a_grow(tmp_path, monkeypatch):
    steps = {"now": 8}
    monkeypatch.setattr(ckpt, "latest_valid_step", lambda directory, log=None: steps["now"])
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append(nprocs)
        if len(calls) == 2:
            steps["now"] = 16  # advanced 8 >= 6: allowed
        return _fake_results([75, 75] if len(calls) < 3 else [0] * nprocs)

    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         checkpoint_dir=tmp_path / "ck", launch=launch, device_budget=4,
                         policy=ElasticPolicy(min_grow_interval_steps=6))
    assert calls == [2, 2, 4] and report.resumes == 1 and report.grows == 1
    grow = next(e for e in report.events if e["name"] == "elastic.grow")
    assert grow["resume_step"] == 16


def test_elastic_shrink_takes_precedence_over_grow(tmp_path):
    calls = []

    def launch(argv, nprocs, inject_fault=None, **kw):
        calls.append(nprocs)
        if len(calls) == 1:
            return _fake_results([0, 43, 0, 0], first_failure=(1, 43, 1.0))
        return _fake_results([0] * nprocs)

    report = run_elastic(["worker.py"], 4, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch, device_budget=8)
    assert calls == [4, 2] and report.shrinks == 1 and report.grows == 0


def test_elastic_parent_notice_stops_relaunching(tmp_path):
    def launch(argv, nprocs, inject_fault=None, **kw):
        preempt.request(grace_s=30.0)  # the forwarder's stamp
        return _fake_results([75, 75])

    report = run_elastic(["worker.py"], 2, global_shape=(32, 32), sidecar_dir=tmp_path,
                         launch=launch)
    assert report.preempted is True and report.final_nprocs == 2 and report.resumes == 0
    assert report.events[-1]["name"] == "elastic.preempted" and not preempt.requested()
    st = health.elastic_status(report.events)
    assert st["preempted"] is True and "PREEMPTED" in health.format_elastic_status(st)


def test_elastic_preempt_resumes_are_bounded(tmp_path):
    with pytest.raises(ElasticExhausted, match="preempted"):
        run_elastic(["worker.py"], 2, sidecar_dir=tmp_path,
                    launch=lambda argv, nprocs, **kw: _fake_results([75, 75]),
                    policy=ElasticPolicy(max_preempt_resumes=2))
    assert health.load_elastic_events(tmp_path)[0][-1]["name"] == "elastic.gave-up"


# ---------------------------------------------------------------------------
# The argv launcher, real processes
# ---------------------------------------------------------------------------


def test_launcher_names_the_first_failure_and_kills_the_hung_peer():
    results = spawn_app_ranks([WORKER, "--dir", "-", "--fault-steps", "6", "--hang-after"],
                              nprocs=2, timeout=120, inject_fault="kill@step=3,rank=1",
                              heartbeat_s=1.0, peer_grace_s=2.0)
    (p0, (out0, _)), (p1, (out1, _)) = results
    assert p1.returncode == RC_INJECTED_KILL and "WORKER_DONE" not in out1
    report = results.report
    assert report.first_failure[:2] == (1, RC_INJECTED_KILL)
    assert report.killed_after_failure == [0] and p0.returncode != 0
    assert "WORKER_DONE rank=0" in out0


def test_launcher_clean_run_reports_nothing():
    results = spawn_app_ranks([WORKER, "--dir", "-", "--fault-steps", "3"], nprocs=2,
                              timeout=120, peer_grace_s=2.0, vanish_grace_s=2.0)
    for rank, (p, (out, err)) in enumerate(results):
        assert p.returncode == 0 and f"WORKER_DONE rank={rank}" in out, err[-500:]
    report = results.report
    assert (report.first_failure, report.vanished, report.killed_after_failure) == (None, None,
                                                                                    [])


def test_launcher_flags_a_vanished_rank_and_reaps_its_peer():
    results = spawn_app_ranks([WORKER, "--dir", "-", "--fault-steps", "6", "--hang-after"],
                              nprocs=2, timeout=60, inject_fault="die@step=3,rank=1",
                              heartbeat_s=1.0, peer_grace_s=2.0, vanish_grace_s=2.0)
    (p0, _), (p1, (out1, _)) = results
    assert p1.returncode == 0 and "WORKER_DONE" not in out1
    report = results.report
    assert report.vanished == 1 and report.first_failure[:2] == (1, 0)
    assert report.killed_after_failure == [0] and p0.returncode != 0
    assert any("vanish" in e for e in report.events), report.events


# ---------------------------------------------------------------------------
# The gloo drills
# ---------------------------------------------------------------------------


def _drill_argv(ck, nt=DRILL["nt"], delay=0.0):
    argv = [WORKER, "--nx", str(DRILL["nx"]), "--ny", str(DRILL["ny"]), "--nt", str(nt),
            "--every", str(DRILL["every"]), "--keep", "8", "--dir", str(ck)]
    return argv + (["--segment-delay-s", str(delay)] if delay else [])


def _continuation(ck, start, nt):
    """The one-rank twin: the checkpoint at `start` restored onto one rank
    and advanced to `nt` by the perf step."""
    (T,) = ckpt.restore_state(ck, start, None, devices="cpu")
    cfg = DiffusionConfig(global_shape=(DRILL["nx"], DRILL["ny"]), lengths=(10.0, 10.0), nt=nt,
                          warmup=0, dtype="f64", dims=(1, 1))
    model = HeatDiffusion(cfg, device="cpu")
    _, Cp = model.init_state()
    return model.advance_fn("perf")(T, Cp, nt - start)


def _assert_schema(*paths):
    assert jax_regress.check_schema([str(p) for p in paths]) == []


@pytest.mark.parametrize("kind,spec,resume", [
    # kill/die strike after the step-8 save: resume 8. The stall wedges rank
    # 1 before its step-8 progress and save: resume 4 (tests/test_elastic.py).
    ("kill", "kill@step=8,rank=1", 8),
    ("die", "die@step=8,rank=1", 8),
    ("stall", "stall@step=8,rank=1,at=segment-pre", 4),
])
def test_elastic_drill_shrinks_and_resumes_bitwise(tmp_path, kind, spec, resume):
    ck, hdir = tmp_path / "ck", tmp_path / "health"
    launches = []

    def launch(*args, **kw):
        launches.append(spawn_app_ranks(*args, **kw))
        return launches[-1]

    report = run_elastic(_drill_argv(ck), 2, checkpoint_dir=ck,
                         global_shape=(DRILL["nx"], DRILL["ny"]), health_dir=hdir,
                         inject_fault=spec, launch=launch, timeout=100, heartbeat_s=2.0,
                         peer_grace_s=3.0, stall_grace_s=3.0, postmortem_grace_s=0.5,
                         vanish_grace_s=5.0)
    assert report.shrinks == 1 and report.final_nprocs == 1, report.launches
    first, second = report.launches
    assert first["nprocs"] == 2 and not first["ok"] and first["dead_ranks"] == [1], first
    assert second["nprocs"] == 1 and second["ok"]
    if kind == "stall":
        assert first["reason"] == "watchdog-stall"
        verdict = launches[0].report.watchdog_verdicts[0]
        assert verdict["rank"] == 1 and verdict["step"] < verdict["median_step"]
        assert any("bundled post-mortem for rank(s) [1]" in e for e in launches[0].report.events)
    if kind == "die":
        assert "vanished" in first["reason"]
    shrink = next(e for e in report.events if e["name"] == "elastic.shrink")
    assert shrink["resume_step"] == resume
    assert shrink["old_mesh"] == [2, 1] and shrink["new_mesh"] == [1, 1]
    assert ckpt.latest_valid_step(ck) == DRILL["nt"]
    final = ckpt.restore_state(ck, DRILL["nt"], None, devices="cpu")
    assert torch.equal(final[0], _continuation(ck, resume, DRILL["nt"]))
    _assert_schema(hdir / health.ELASTIC_FILE, ck / f"manifest-{DRILL['nt']}.json",
                   ck / f"manifest-{resume}.json")
    assert ckpt.read_manifest(ck, resume)["meta"]["mesh"]["dims"] == [2, 1]


def test_elastic_drill_shrinks_then_grows_back(tmp_path):
    """Rank 1 killed at step 8: shrink to one rank; the rejoin probe sees a
    budget of 2, preempts the one-rank run at a boundary (SIGTERM, the
    emergency save, rc 75) and grows back to 2×1, bitwise equal to a
    continuation of the grow's checkpoint."""
    ck, hdir = tmp_path / "ck", tmp_path / "health"
    nt = 24
    report = run_elastic(_drill_argv(ck, nt=nt, delay=0.4), 2, checkpoint_dir=ck,
                         global_shape=(DRILL["nx"], DRILL["ny"]), health_dir=hdir,
                         inject_fault="kill@step=8,rank=1", device_budget=2,
                         policy=ElasticPolicy(grow_poll_s=0.2), timeout=150, heartbeat_s=2.0,
                         peer_grace_s=3.0, stall_grace_s=8.0, vanish_grace_s=8.0)
    assert report.shrinks == 1 and report.grows == 1, report.launches
    assert [launch["nprocs"] for launch in report.launches] == [2, 1, 2]
    assert [launch["status"] for launch in report.launches] == ["failed", "preempted", "ok"]
    assert report.launches[1]["returncodes"] == [75]
    shrink = next(e for e in report.events if e["name"] == "elastic.shrink")
    grow = next(e for e in report.events if e["name"] == "elastic.grow")
    assert shrink["resume_step"] == 8 and shrink["new_mesh"] == [1, 1]
    assert grow["new_mesh"] == [2, 1] and (grow["old_nprocs"], grow["new_nprocs"]) == (1, 2)
    assert grow["resume_step"] >= 12 and grow["resume_step"] % DRILL["every"] == 0
    assert ckpt.read_manifest(ck, grow["resume_step"])["meta"]["mesh"]["dims"] == [1, 1]
    assert ckpt.read_manifest(ck, nt)["meta"]["mesh"]["dims"] == [2, 1]
    # The twin: the grow's checkpoint continued by 2 gloo ranks on 2×1.
    spec = dict(shape=(DRILL["nx"], DRILL["ny"]), dims=(2, 1), start=grow["resume_step"],
                nt=nt, dir=str(ck))
    twin = spawn_ranks(2, worker.continue_rank, (spec,), backend="gloo", timeout=120)
    for rank in range(2):
        grid = init_global_grid(DRILL["nx"], DRILL["ny"], dims=(2, 1), nprocs=2, rank=rank)
        final = ckpt.restore_state(ck, nt, None, grid=grid, devices="cpu")
        assert torch.equal(final[0], torch.from_numpy(twin[rank])), rank
    _assert_schema(hdir / health.ELASTIC_FILE, ck / f"manifest-{nt}.json")
    st = health.elastic_status(health.load_elastic_events(hdir)[0])
    assert "SHRUNK from (2, 1)" in health.format_elastic_status(st)
    assert "GROWN to (2, 1)" in health.format_elastic_status(st)


def test_elastic_drill_clean_run_never_shrinks(tmp_path):
    ck, hdir = tmp_path / "ck", tmp_path / "health"
    report = run_elastic(_drill_argv(ck), 2, checkpoint_dir=ck,
                         global_shape=(DRILL["nx"], DRILL["ny"]), health_dir=hdir,
                         device_budget=2, timeout=100, heartbeat_s=2.0, peer_grace_s=3.0,
                         vanish_grace_s=6.0)
    assert (report.shrinks, report.grows, report.resumes, report.final_nprocs) == (0, 0, 0, 2)
    assert [e["name"] for e in report.events] == ["elastic.launch", "elastic.complete"]
    for p, (out, err) in report.results:
        assert p.returncode == 0, err[-800:]
    assert not (hdir / "postmortem").exists()
    man = ckpt.read_manifest(ck, DRILL["nt"])
    assert man["meta"]["mesh"]["dims"] == [2, 1] and len(man["shards"]) == 2
    _assert_schema(hdir / health.ELASTIC_FILE, ck / f"manifest-{DRILL['nt']}.json")
