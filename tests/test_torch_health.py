"""The port's health plane (rocm_mpi_tpu_torch/telemetry/flight.py and
health.py) against the JAX package's on the CPU:

* the read side on seeded sidecars and streams: monitor rows, the
  status badges, the OpenMetrics export and its parse and the stall
  verdicts equal the JAX package's, and the JAX parser reads the port's
  export;
* the write side: the flight recorder's sidecar, ring and counters, the
  stall verdict naming a rank that sleeps at a window boundary (two gloo
  ranks), a SIGUSR2 post-mortem, and spawn_ranks(health_dir=) clearing
  stale sidecars.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import test_torch_rank_worker as rank_worker
from rocm_mpi_tpu.telemetry import health as jax_health
from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.telemetry import compiles, events, flight, health
from rocm_mpi_tpu_torch.telemetry.__main__ import main as cli_main

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setattr(events, "_ENABLED", False)
    monkeypatch.setattr(events, "_DIR", None)
    monkeypatch.setattr(events, "_RANK", None)
    monkeypatch.setattr(flight, "_ENABLED", False)
    monkeypatch.setattr(flight, "_DIR", None)
    monkeypatch.setattr(flight, "_RANK", None)
    events.clear()
    flight.reset()
    compiles.reset()
    yield
    flight.disable()
    events.clear()
    flight.reset()
    compiles.reset()


def _seeded_run_dir(root: pathlib.Path, seed: int) -> None:
    """Heartbeats of 4 ranks (one torn) and their streams' gauges,
    counters and wire annotations, from a numpy seed."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for rk in range(4):
        counters = {"step": int(rng.randint(50, 100)), "windows": int(rng.randint(8)),
                    "halo_bytes": int(rng.randint(10_000))}
        if rk == 2:
            counters.update(ckpt_degraded=1, ckpt_skipped=2)
        if rk == 1:
            counters.update(serve_submitted=9, serve_completed=5)
        beat = {"schema": flight.HEARTBEAT_SCHEMA, "v": 1, "rank": rk,
                "t": 1.7e9 + rng.uniform(0, 5), "started_t": 1.7e9,
                "counters": counters, "last_phase": ["halo", "step"][rk % 2],
                "last_phase_name": "halo.heartbeat", "last_phase_t": 1.7e9 + 1,
                "inflight_traces": [], "ring": [{"kind": "phase", "name": "halo.heartbeat"}]}
        text = json.dumps(beat)
        (root / f"heartbeat-rank{rk}.json").write_text(text[:20] if rk == 3 else text)
        recs = [{"v": 2, "kind": "gauge", "name": "run.gpts", "t": 1.7e9, "t_mono": 1.0,
                 "rank": rk, "value": float(rng.uniform(1, 9)),
                 "attrs": {"devices": 4, "driver": "scan"}},
                {"v": 2, "kind": "counter", "name": "halo.exchange_nbytes", "t": 1.7e9,
                 "t_mono": 1.0, "rank": rk, "value": int(rng.randint(4096))},
                {"v": 2, "kind": "trace", "name": "halo.exchange", "t": 1.7e9, "t_mono": 1.0,
                 "rank": rk, "attrs": {"bytes": 64, "wire": ["f32", "bf16"][rk % 2]}}]
        (root / f"telemetry-rank{rk}.jsonl").write_text(
            "\n".join(json.dumps(r) for r in recs) + "\n")


@pytest.mark.parametrize("seed", [0, 1])
def test_read_side_equals_the_jax_packages(tmp_path, seed):
    _seeded_run_dir(tmp_path, seed)
    beats, skipped = health.load_heartbeats(tmp_path)
    assert (beats, skipped) == jax_health.load_heartbeats(tmp_path) and skipped == 1
    prev = {rk: dict(doc, t=doc["t"] - 2.0,
                     counters=dict(doc["counters"], step=doc["counters"]["step"] - 7))
            for rk, doc in beats.items()}
    rows = health.monitor_rows(beats, prev, now_wall=1.7e9 + 9)
    assert rows == jax_health.monitor_rows(beats, prev, now_wall=1.7e9 + 9)
    assert health.format_monitor(rows, skipped) == jax_health.format_monitor(rows, skipped)
    assert health.storage_status(beats) == jax_health.storage_status(beats)
    assert health.serve_status(beats) == jax_health.serve_status(beats)
    assert health.wire_status(tmp_path) == jax_health.wire_status(tmp_path) == ["bf16", "f32"]
    text = health.export_openmetrics(tmp_path)
    assert text == jax_health.export_openmetrics(tmp_path)
    parsed = health.parse_openmetrics(text)
    assert parsed == jax_health.parse_openmetrics(text)
    assert parsed["rmt_gauge"]["run.gpts@4dev:scan"] > 0


def test_stall_verdicts_equal_the_jax_packages():
    def beat(rk, step, t):
        return {"rank": rk, "t": t, "counters": {"step": step}, "last_phase": "halo",
                "last_phase_name": "halo.heartbeat"}

    mine, theirs = health.ProgressWatch(stall_grace_s=5), jax_health.ProgressWatch(5)
    for now, steps in ((0.0, (10, 10, 10)), (3.0, (20, 10, 20)), (9.0, (30, 10, 30))):
        beats = {rk: beat(rk, s, now) for rk, s in enumerate(steps)}
        mine.observe(beats, now)
        theirs.observe(beats, now)
        assert mine.verdicts(now) == theirs.verdicts(now)
        assert mine.ages(now) == theirs.ages(now)
    (v,) = mine.verdicts(9.0)
    assert v["rank"] == 1 and v["median_step"] == 30


def test_export_openmetrics_of_a_port_run_parses_with_the_jax_parser(tmp_path, capsys):
    assert cli_main(["export-openmetrics", str(tmp_path)]) == 2
    events.configure(directory=tmp_path, rank=0)
    telemetry.gauge("run.gpts", 1.25, devices=4, driver="scan")
    telemetry.gauge("run.t_eff_gbs", 3.5, variant="hide", wire="bf16")
    telemetry.counter("halo.exchange_nbytes", 2048)
    telemetry.counter("halo.exchange_nbytes", 2048)
    flight.enable(rank=0)
    flight.progress(step=12)
    assert cli_main(["export-openmetrics", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert text.rstrip().endswith("# EOF")
    parsed = jax_health.parse_openmetrics(text)
    assert parsed == health.parse_openmetrics(text)
    assert parsed["rmt_gauge"]["run.gpts@4dev:scan"] == 1.25
    assert parsed["rmt_gauge"]["run.t_eff_gbs:bf16"] == 3.5
    assert parsed["rmt_counter_total"]["halo.exchange_nbytes"] == 4096
    assert parsed["rmt_progress"][(("counter", "step"), ("rank", "0"))] == 12


def test_flight_sidecar_ring_counters_and_monitor(tmp_path, capsys):
    flight.enable(directory=tmp_path, rank=1, ring_size=4)
    assert events.enabled() and events.directory() == str(tmp_path)  # health arms telemetry
    for _ in range(3):  # 3 phase entries and 3 span records into a ring of 4
        with telemetry.span("halo.heartbeat", phase="halo", bytes=64):
            pass
    for s in (5, 3, 9):
        flight.progress(step=s, windows=1)
    flight.progress(step_inc=1)
    doc = json.loads((tmp_path / "heartbeat-rank1.json").read_text())
    assert doc["schema"] == flight.HEARTBEAT_SCHEMA and doc["rank"] == 1
    assert doc["counters"] == {"halo_exchanges": 3, "halo_bytes": 192, "step": 10, "windows": 3}
    assert doc["last_phase"] == "halo" and len(doc["ring"]) == 4
    assert cli_main(["monitor", str(tmp_path), "--iterations", "1"]) == 0
    assert "rank" in capsys.readouterr().out
    flight.reset()
    assert flight.snapshot()["counters"] == {} and telemetry.records("event") == []


def test_flight_enable_needs_a_directory(monkeypatch):
    for var in ("RMT_HEALTH_DIR", "RMT_TELEMETRY_DIR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="flight recorder needs a sidecar directory"):
        flight.enable()
    monkeypatch.setenv("RMT_HEALTH", "0")
    assert flight.enable_from_env() is False


def test_progress_watch_names_a_rank_asleep_at_a_window_boundary(tmp_path):
    spec = {"dir": str(tmp_path), "sleep": 4.0}
    done = {}
    thread = threading.Thread(target=lambda: done.setdefault(
        "out", spawn_ranks(2, rank_worker.run_progress_rank, (spec,), timeout=120)))
    thread.start()
    watch = health.ProgressWatch(stall_grace_s=1.0)
    verdicts = []
    deadline = time.monotonic() + 90
    while thread.is_alive() and not verdicts and time.monotonic() < deadline:
        beats, _ = health.load_heartbeats(tmp_path)
        now = time.monotonic()
        watch.observe(beats, now)
        verdicts = watch.verdicts(now)
        time.sleep(0.05)
    thread.join(timeout=120)
    assert verdicts and verdicts[0]["rank"] == 1, verdicts
    assert verdicts[0]["step"] == 10 and verdicts[0]["median_step"] == 15
    assert [c["step"] for c in done["out"]] == [30, 30]
    path = health.write_postmortem(tmp_path, 1, dict(verdicts[0]))
    bundle = health.bundle_postmortem(tmp_path, verdicts)
    doc = json.loads(path.read_text())
    assert doc["schema"] == flight.POSTMORTEM_SCHEMA and doc["heartbeat"]["rank"] == 1
    assert json.loads((bundle / "bundle.json").read_text())["ranks"] == [0, 1]
    from rocm_mpi_tpu.telemetry import regress as jax_regress

    assert jax_regress.check_schema([str(path), str(bundle / "bundle.json"),
                                     str(tmp_path / "heartbeat-rank0.json")]) == []


SIGUSR2_CHILD = """
import os, signal, sys, time
from rocm_mpi_tpu_torch.telemetry import flight
flight.enable(directory=sys.argv[1], rank=0)
print(flight.install_postmortem_handler(), flush=True)
os.kill(os.getpid(), signal.SIGUSR2)
time.sleep(0.2)
"""


@pytest.mark.skipif(not hasattr(__import__("signal"), "SIGUSR2"), reason="no SIGUSR2 here")
def test_sigusr2_writes_the_postmortem_traceback(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SIGUSR2_CHILD, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    tb = tmp_path / "postmortem-rank0.traceback"
    assert proc.stdout.strip() == str(tb)
    assert "Current thread" in tb.read_text() or "Thread" in tb.read_text()
    path = health.write_postmortem(tmp_path, 0, {"rank": 0, "step": 0})
    doc = json.loads(path.read_text())
    assert doc["traceback"] and doc["heartbeat"]["schema"] == flight.HEARTBEAT_SCHEMA


def test_spawn_ranks_clears_stale_sidecars_and_sets_the_health_env(tmp_path):
    (tmp_path / "heartbeat-rank7.json").write_text("{}")
    (tmp_path / "postmortem-rank7.traceback").write_text("old")
    spec = {"dir": str(tmp_path), "sleep": 0.0}
    spawn_ranks(2, rank_worker.run_progress_rank, (spec,), timeout=120, health_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.glob("heartbeat-rank*.json")) == [
        "heartbeat-rank0.json", "heartbeat-rank1.json"]
    assert not (tmp_path / "postmortem-rank7.traceback").exists()
