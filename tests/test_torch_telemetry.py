"""The port's telemetry plane (rocm_mpi_tpu_torch/telemetry/) against the
JAX package's (rocm_mpi_tpu/telemetry/) on the CPU:

* read-side parity: seeded streams of 3 ranks (spans, gauges, counters,
  trace annotations, events, request-trace records, clock anchors, torn
  lines) give the same documents through both packages' aggregate,
  trace, regress and tracing (`==`, no tolerance);
* the write side: a port app run with --telemetry --health (and one
  with --checkpoint) writes a stream, a summary, a heartbeat and a
  manifest that the JAX package's check_schema accepts, and the JAX CLI's
  summary of the directory equals the port's; the port's check_schema
  gives the JAX result on the JAX tests' files;
* end to end: a two-rank gloo weak_scaling --telemetry run through the
  port's spawn_ranks(telemetry_dir=);
* spans, annotations, compiles, checkpoint spans and events, --profile
  and the profiling app.
"""

from __future__ import annotations

import errno
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_rank_worker as rank_worker
from rocm_mpi_tpu.telemetry import aggregate as jax_aggregate
from rocm_mpi_tpu.telemetry import regress as jax_regress
from rocm_mpi_tpu.telemetry import trace as jax_trace
from rocm_mpi_tpu.telemetry import tracing as jax_tracing
from rocm_mpi_tpu.telemetry.__main__ import main as jax_cli
from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.telemetry import aggregate, compiles, events, flight, regress, spans
from rocm_mpi_tpu_torch.telemetry import trace, tracing
from rocm_mpi_tpu_torch.telemetry.__main__ import main as cli_main
from test_torch_scan import _toy_step, fake_cuda  # noqa: F401 — the stand-in capture

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Every test starts with the port's telemetry and flight recorder off
    and empty, and its compile accounting reset."""
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


# ---------------------------------------------------------------------------
# Read-side parity on seeded streams
# ---------------------------------------------------------------------------

PHASE_SPANS = ("halo.probe", "interior.probe", "checkpoint.save", "step_window",
               "halo.heartbeat", "compile.backend", "warmup")


def _seeded_streams(directory: pathlib.Path, seed: int = 0) -> None:
    """Three ranks' streams from a numpy seed: every record kind, ranks 0
    and 1 anchored, rank 2 legacy (no anchor), a torn last line on rank 1
    and a non-record line on rank 2."""
    rng = np.random.RandomState(seed)
    directory.mkdir(parents=True, exist_ok=True)
    for rk in range(3):
        t0 = 1.7e9 + rng.uniform(0, 1)
        m0 = rng.uniform(100, 200)
        recs = []
        if rk < 2:
            recs.append({"v": 2, "kind": "anchor", "name": "clock.anchor", "t": t0,
                         "t_mono": m0, "rank": rk, "pid": 100 + rk})
        for i in range(40):
            t, tm = t0 + 0.01 * i + rng.uniform(0, 1e-3), m0 + 0.01 * i
            name = PHASE_SPANS[rng.randint(len(PHASE_SPANS))]
            attrs = {}
            if name.startswith("halo"):
                attrs = {"phase": "halo", "bytes": int(rng.randint(1, 10_000)), "probe": True}
            elif name == "step_window":
                attrs = {"phase": "step", "steps": int(rng.randint(1, 50)), "window": i,
                         "driver": ["scan", "step"][rng.randint(2)]}
            elif name == "compile.backend":
                attrs = {"phase": "compile", "program": "graph:step", "steady": bool(i % 2)}
            recs.append({"v": 2, "kind": "span", "name": name, "t": t, "t_mono": tm,
                         "rank": rk, "dur_s": float(rng.uniform(1e-5, 2e-2)), "depth": 0,
                         "tid": 7, **({"attrs": attrs} if attrs else {}),
                         **({"error": "OSError"} if i == 13 else {})})
            if i % 5 == 0:
                gattrs = {"devices": int(2 ** rng.randint(3))}
                if rng.randint(2):
                    gattrs["driver"] = "scan"
                if rng.randint(3) == 0:
                    gattrs["wire"] = ["f32", "bf16"][rng.randint(2)]
                recs.append({"v": 2, "kind": "gauge", "name": "run.gpts", "t": t,
                             "t_mono": tm, "rank": rk, "value": float(rng.uniform(1, 40)),
                             "attrs": gattrs})
                recs.append({"v": 2, "kind": "gauge", "name": "compiles.steady_state",
                             "t": t, "t_mono": tm, "rank": rk, "value": int(rng.randint(2))})
                recs.append({"v": 2, "kind": "counter", "name": "halo.bytes", "t": t,
                             "t_mono": tm, "rank": rk, "value": int(rng.randint(1000))})
            if i % 7 == 0:
                recs.append({"v": 2, "kind": "trace", "name": "halo.exchange", "t": t,
                             "t_mono": tm, "rank": rk,
                             "attrs": {"bytes": int(rng.randint(1, 4096)), "width": 1,
                                       "block": [16, 16], "wire": ["f32", "bf16"][i % 2],
                                       "exchange": "faces"}})
            if i % 11 == 0:
                recs.append({"v": 2, "kind": "event", "name": "ckpt.retry", "t": t,
                             "t_mono": tm, "rank": rk, "step": i, "attempt": 0,
                             "wait_s": 0.25, "error": "OSError: disk"})
            if i % 13 == 0:
                recs.append({"v": 2, "kind": "tspan", "name": "trace.batch", "t": t,
                             "t_mono": tm, "rank": rk, "trace_id": "req-1",
                             "span_id": f"s{rk}.{i}", "parent_id": None, "hop": rk % 2,
                             "members": [{"trace_id": "req-2", "lane": 1}]})
        if rk == 1:
            recs.append({"v": 2, "kind": "event", "name": "serve.request.done", "t": t0 + 1,
                         "t_mono": m0 + 1, "rank": rk, "request_id": "req-1",
                         "latency_s": 0.5, "decomp": {"queue_wait": 0.2, "device": 0.3},
                         "hop": 1})
        lines = [json.dumps(r) for r in recs]
        if rk == 1:
            lines.append('{"v": 2, "kind": "span", "name": "halo.pro')  # torn
        if rk == 2:
            lines.append('["not", "a", "record"]')
        (directory / f"telemetry-rank{rk}.jsonl").write_text("\n".join(lines) + "\n")


def _beats(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed + 1)
    return {rk: {"schema": flight.HEARTBEAT_SCHEMA, "v": 1, "rank": rk,
                 "t": 1.7e9 + rng.uniform(0, 2),
                 "counters": {"step": int(rng.randint(100)), "windows": int(rng.randint(5)),
                              "halo_bytes": int(rng.randint(10_000))},
                 "last_phase": "halo", "last_phase_name": "halo.heartbeat",
                 "last_phase_t": 1.7e9, "ring": []}
            for rk in range(3)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_side_documents_equal_the_jax_packages(tmp_path, seed):
    _seeded_streams(tmp_path, seed)
    streams, skipped = aggregate.load_rank_streams(tmp_path)
    j_streams, j_skipped = jax_aggregate.load_rank_streams(tmp_path)
    assert (streams, skipped) == (j_streams, j_skipped) and skipped == 2
    summary = aggregate.summarize(streams, skipped)
    assert summary == jax_aggregate.summarize(j_streams, j_skipped)
    assert aggregate.format_summary(summary) == jax_aggregate.format_summary(summary)
    beats = _beats(seed)
    verdicts = [{"rank": 2, "step": 3, "median_step": 9, "stalled_for_s": 12.5,
                 "last_phase": "halo", "t": 1.7e9 + 1}]
    assert trace.to_chrome_trace(streams) == jax_trace.to_chrome_trace(j_streams)
    assert (trace.to_chrome_trace(streams, heartbeats=beats, verdicts=verdicts)
            == jax_trace.to_chrome_trace(j_streams, heartbeats=beats, verdicts=verdicts))
    assert regress.extract_metrics(summary) == jax_regress.extract_metrics(summary)
    other = aggregate.summarize({k: v[::2] for k, v in streams.items()})
    assert regress.compare(summary, other) == [
        regress.Delta(**vars(d)) for d in jax_regress.compare(summary, other)]
    for tol in (0.0, 0.5):
        mine = regress.compare(other, summary, tol)
        assert [vars(d) for d in mine] == [vars(d) for d in jax_regress.compare(other, summary,
                                                                                tol)]
    for rid in ("req-1", "req-2", "nobody"):
        timeline = tracing.request_timeline(streams, rid)
        assert timeline == jax_tracing.request_timeline(j_streams, rid)
        if timeline is not None:
            assert tracing.format_timeline(timeline) == jax_tracing.format_timeline(timeline)
            assert tracing.to_request_chrome(timeline) == jax_tracing.to_request_chrome(timeline)


def test_schema_strings_and_copied_constants_equal_the_jax_packages():
    from rocm_mpi_tpu.analysis.baseline import BASELINE_SCHEMA
    from rocm_mpi_tpu.analysis.report import FINDINGS_SCHEMA
    from rocm_mpi_tpu.serving import bins, journal, queue, slo
    from rocm_mpi_tpu.telemetry import flight as jax_flight
    from rocm_mpi_tpu.telemetry import health as jax_health
    from rocm_mpi_tpu_torch.parallel import wire
    from rocm_mpi_tpu_torch.telemetry import health

    assert events.SCHEMA_VERSION == 2
    assert aggregate.SUMMARY_SCHEMA == jax_aggregate.SUMMARY_SCHEMA
    for name in ("HEARTBEAT_SCHEMA", "POSTMORTEM_SCHEMA", "BUNDLE_SCHEMA"):
        assert getattr(flight, name) == getattr(jax_flight, name)
    assert health.ELASTIC_SCHEMA == jax_health.ELASTIC_SCHEMA
    assert tracing.TRACE_REPORT_SCHEMA == jax_tracing.TRACE_REPORT_SCHEMA
    assert tracing.DECOMP_STAGES == jax_tracing.DECOMP_STAGES
    assert (regress._FINDINGS_SCHEMA, regress._LINT_BASELINE_SCHEMA) == (FINDINGS_SCHEMA,
                                                                         BASELINE_SCHEMA)
    assert (regress._BIN_MANIFEST_SCHEMA, regress._SOAK_SCHEMA, regress._FLEET_REPORT_SCHEMA) \
        == (bins.BIN_MANIFEST_SCHEMA, slo.SOAK_SCHEMA, journal.FLEET_REPORT_SCHEMA)
    assert (regress._SERVE_REQUEST_SCHEMA, regress._QUARANTINE_SCHEMA,
            regress._FLEET_JOURNAL_SCHEMA) == (queue.REQUEST_SCHEMA, queue.QUARANTINE_SCHEMA,
                                               journal.JOURNAL_SCHEMA)
    assert regress._WIRE_MODES == tuple(wire.WIRE_MODES) == jax_regress._WIRE_MODES


def test_check_schema_classifies_every_jax_family_and_names_the_unchecked(tmp_path):
    docs = {
        "findings.json": {"schema": "rmt-lint-findings", "v": 1},
        "lint.json": {"schema": "rmt-lint-baseline", "v": 1},
        "bins.json": {"schema": "rmt-bin-manifest", "v": 1},
        "soak.json": {"schema": "rmt-soak-report", "v": 1},
        "fleet.json": {"schema": "rmt-fleet-report", "v": 1},
        "budgets.json": {"v": 1, "budgets": {"perf": 1.2},
                         "wire": {"ladder": {"f32": 1.0, "bf16": 0.5}}},
        "flat.json": {"metrics": {"x": {"value": 1, "direction": "lower"}}},
    }
    for name, doc in docs.items():
        (tmp_path / name).write_text(json.dumps(doc))
    (tmp_path / "serve.jsonl").write_text(
        json.dumps({"schema": "rmt-serve-request", "kind": "req", "v": 3}) + "\n")
    (tmp_path / "fleet-journal.jsonl").write_text(json.dumps(
        {"schema": "rmt-fleet-journal", "v": 1, "kind": "terminal", "seq": 0,
         "request_id": "r", "state": "vaporized"}) + "\n")
    paths = sorted(str(p) for p in tmp_path.iterdir())
    for path in paths:
        doc = json.loads(pathlib.Path(path).read_text().splitlines()[0])
        if path.endswith(".json"):
            assert regress._classify_json(doc) == jax_regress._classify_json(doc)
    notes: list = []
    # The serving bin manifest, the soak report, the fleet report and the
    # serve request and fleet journal records are deep-checked by the
    # port's serving validators, with the JAX package's verdicts on the
    # same (stub or doctored) documents.
    served = [str(tmp_path / n) for n in ("bins.json", "fleet-journal.jsonl", "fleet.json",
                                          "serve.jsonl", "soak.json")]
    problems = regress.check_schema(paths, notes=notes)
    assert problems == regress.check_schema(served) == jax_regress.check_schema(served)
    assert {p.split(": ")[0].split(":")[0] for p in problems} == set(served)
    assert any("fleet.json: replicas" in p or "fleet.json: missing" in p for p in problems)
    assert any("fleet-journal.jsonl:1: terminal state 'vaporized'" in p for p in problems)
    unchecked = {n.split(": ")[1] for n in notes}
    assert unchecked == {"graftlint findings artifact", "graftlint baseline"}
    assert all("not deep-checked" in n for n in notes)


def test_check_schema_gives_the_jax_result_on_the_jax_tests_files(tmp_path, capsys):
    committed = [str(REPO / "BASELINE.json"), str(REPO / "MULTICHIP_r01.json")]
    committed += sorted(str(p) for p in (REPO / "docs").glob("weak_scaling_*_r3.jsonl"))[:1]
    assert regress.check_schema(committed) == jax_regress.check_schema(committed) == []
    assert cli_main(["regress", "--check-schema", *committed]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    missing = str(tmp_path / "missing.json")
    for paths in ([str(bad)], [missing]):
        assert regress.check_schema(paths) == jax_regress.check_schema(paths) != []
        assert cli_main(["regress", "--check-schema", *paths]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The write side: a port app's artifacts, read by the JAX package
# ---------------------------------------------------------------------------

APP = ["--device", "cpu", "--nx", "32", "--ny", "32", "--nt", "20", "--warmup", "4"]


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """Two port app runs side by side: perf with --telemetry --health, and
    the same in checkpoint mode."""
    root = tmp_path_factory.mktemp("apps")
    plain, ck = root / "plain", root / "ck"
    cmds = {
        "plain": [*APP, "--telemetry", str(plain), "--health"],
        "ck": [*APP, "--telemetry", str(ck), "--health", "--checkpoint", str(ck / "store"),
               "--ckpt-every", "10"],
    }
    procs = {k: subprocess.Popen([sys.executable, "-m", "rocm_mpi_tpu_torch.apps."
                                  "diffusion_2d_perf", *argv], cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, argv in cmds.items()}
    outs = {k: p.communicate(timeout=240) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, outs[k]
    return {"plain": plain, "ck": ck, "out": outs}


def test_app_writes_stream_summary_heartbeat_the_jax_schema_accepts(app_runs):
    plain, ck = app_runs["plain"], app_runs["ck"]
    manifest = sorted((ck / "store").glob("manifest-*.json"))
    assert [m.name for m in manifest] == ["manifest-10.json", "manifest-20.json"]
    files = [plain / "telemetry-rank0.jsonl", plain / "telemetry-summary.json",
             plain / "heartbeat-rank0.json", ck / "telemetry-rank0.jsonl",
             ck / "telemetry-summary.json", ck / "heartbeat-rank0.json", *manifest]
    assert all(f.is_file() for f in files)
    assert jax_regress.check_schema([str(f) for f in files]) == []
    assert regress.check_schema([str(f) for f in files]) == []
    beat = json.loads((plain / "heartbeat-rank0.json").read_text())
    assert beat["counters"]["step"] == 20 and beat["schema"] == flight.HEARTBEAT_SCHEMA
    assert json.loads((ck / "heartbeat-rank0.json").read_text())["counters"]["step"] == 20
    summary = json.loads((plain / "telemetry-summary.json").read_text())
    assert summary["steps"]["count"] == 16 and summary["phases"]["step"]["count"] == 1
    assert summary["gauges"]["run.gpts:scan"] > 0
    assert summary["gauges"]["compiles.steady_state"] == 0
    names = {json.loads(line)["name"] for line in
             (ck / "telemetry-rank0.jsonl").read_text().splitlines()}
    assert {"checkpoint.save", "clock.anchor"} <= names
    assert json.loads((ck / "telemetry-summary.json").read_text())[
        "phases"]["checkpoint"]["count"] == 2


def test_jax_cli_summary_of_a_port_run_equals_the_ports(app_runs, tmp_path, capsys):
    for key in ("plain", "ck"):
        d = app_runs[key]
        mine, theirs = tmp_path / f"{key}-port.json", tmp_path / f"{key}-jax.json"
        assert cli_main(["summarize", str(d), "--out", str(mine), "--trace",
                         str(tmp_path / f"{key}-port-trace.json")]) == 0
        assert jax_cli(["summarize", str(d), "--out", str(theirs), "--trace",
                        str(tmp_path / f"{key}-jax-trace.json")]) == 0
        assert json.loads(mine.read_text()) == json.loads(theirs.read_text())
        assert json.loads((tmp_path / f"{key}-port-trace.json").read_text()) == json.loads(
            (tmp_path / f"{key}-jax-trace.json").read_text())
        assert cli_main(["regress", str(mine), "--baseline", str(theirs)]) == 0
    capsys.readouterr()


def test_health_without_a_sidecar_directory_exits_with_the_jax_message(monkeypatch):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    for var in ("RMT_HEALTH_DIR", "RMT_TELEMETRY_DIR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="--health / RMT_HEALTH: flight recorder needs a "
                       "sidecar directory"):
        diffusion_2d_perf.main([*APP, "--health"])


# ---------------------------------------------------------------------------
# End to end: two gloo ranks of weak_scaling --telemetry through spawn_ranks
# ---------------------------------------------------------------------------


def test_two_rank_weak_scaling_telemetry_end_to_end(tmp_path, capsys):
    tel = tmp_path / "telemetry"
    argv = ["--device", "cpu", "--local", "16", "--nt", "24", "--warmup", "4", "--counts",
            "2", "--telemetry-windows", "4", "--health"]
    assert spawn_ranks(2, rank_worker.run_weak_scaling_app, (argv,), timeout=240,
                       telemetry_dir=tel) == [0, 0]
    assert (tel / "telemetry-rank0.jsonl").is_file() and (tel / "telemetry-rank1.jsonl").is_file()
    merged = json.loads((tel / "telemetry-summary.json").read_text())
    assert merged["ranks"] == [0, 1]
    assert cli_main(["summarize", str(tel)]) == 0
    summary = json.loads((tel / "telemetry-summary.json").read_text())
    assert summary == merged
    phases = summary["phases"]
    for phase in ("halo", "interior", "checkpoint"):
        assert phases[phase]["wall_s"] > 0, (phase, phases)
        assert set(phases[phase]["by_rank"]) == {"0", "1"}
    assert phases["halo"]["bytes"] > 0
    assert summary["steps"]["windows"] >= 4 and summary["steps"]["per_step_us"]["p50"] > 0
    assert summary["traced"]["halo.exchange"]["bytes"] > 0
    assert summary["traced"]["halo.exchange"]["exchange"] == "faces"
    assert summary["gauges"]["compiles.steady_state"] == 0
    trace_doc = json.loads((tel / "telemetry-trace.json").read_text())
    assert {e["pid"] for e in trace_doc["traceEvents"]} == {0, 1}
    for rk in (0, 1):
        beat = json.loads((tel / f"heartbeat-rank{rk}.json").read_text())
        assert beat["counters"]["step"] == 24 and beat["counters"]["windows"] == 4
    s = str(tel / "telemetry-summary.json")
    assert cli_main(["regress", s, "--baseline", s]) == 0
    assert jax_cli(["regress", s, "--baseline", s]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Spans, annotations, the step_window span
# ---------------------------------------------------------------------------


def test_spans_nest_flag_errors_and_the_disabled_singleton(tmp_path):
    assert telemetry.span("x") is spans._NOOP
    assert telemetry.span("x").sync(5) == 5
    events.configure(directory=tmp_path, rank=3)
    with telemetry.span("outer", phase="halo") as outer:
        with telemetry.span("inner", bytes=8) as inner:
            inner.set(extra=1)
        with pytest.raises(ValueError), telemetry.span("boom"):
            raise ValueError("x")
        outer.sync(torch.zeros(2))
    recs = {r["name"]: r for r in telemetry.records("span")}
    assert recs["inner"]["depth"] == 1 and recs["outer"]["depth"] == 0
    assert recs["inner"]["attrs"] == {"bytes": 8, "extra": 1}
    assert recs["boom"]["error"] == "ValueError" and "error" not in recs["outer"]
    assert {r["rank"] for r in recs.values()} == {3}
    lines = (tmp_path / "telemetry-rank3.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["name"] == "clock.anchor" and len(lines) == 4


def test_labelled_timer_and_the_run_event_shim(tmp_path):
    from rocm_mpi_tpu_torch.utils import metrics

    events.configure(directory=tmp_path, rank=0)
    with metrics.Timer("checkpoint.save", step=3) as timer:
        pass
    with pytest.raises(OSError), metrics.Timer("checkpoint.save", step=4):
        raise OSError("disk")
    saves = [r for r in telemetry.records("span") if r["name"] == "checkpoint.save"]
    assert saves[0]["dur_s"] == timer.elapsed and "error" not in saves[0]
    assert saves[1]["error"] == "OSError" and saves[1]["attrs"] == {"step": 4}
    ev = metrics.record_event("restored", step=120)
    assert ev.kind == "restored" and ev.step == 120 and ev.v == events.SCHEMA_VERSION
    assert [e.kind for e in metrics.events()] == ["restored"]
    assert json.loads(ev.to_json())["step"] == 120
    with pytest.warns(DeprecationWarning):
        metrics.clear_events()
    assert metrics.events() == [] and len(telemetry.records("span")) == 2


def test_span_sync_raises_while_a_capture_is_active(monkeypatch, tmp_path):
    events.configure(directory=tmp_path, rank=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="cannot sync while a CUDA graph is being captured"):
        with telemetry.span("halo.probe") as sp:
            sp.sync(torch.zeros(2))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with telemetry.span("halo.probe") as sp:
        sp.sync(torch.zeros(2))


def test_rank_stamp_order_keeps_ranks_apart(monkeypatch, tmp_path):
    monkeypatch.delenv("RMT_PROCESS_ID", raising=False)
    monkeypatch.setenv("RANK", "3")  # torchrun's
    assert events.rank() == 3
    monkeypatch.setenv("RMT_PROCESS_ID", "1")  # the launcher's wins
    assert events.rank() == 1
    events.configure(directory=tmp_path, rank=2)  # configure(rank=) wins
    assert events.rank() == 2 and events.stream_path().endswith("telemetry-rank2.jsonl")


def test_step_driver_annotates_once_and_telemetry_changes_nothing(tmp_path):
    ranks = spawn_ranks(2, rank_worker.run_telemetry_step_rank, ({"dir": str(tmp_path)},),
                        timeout=240)
    for rk, out in enumerate(ranks):
        for variant, got in out.items():
            assert got["same"], (rk, variant)
            assert got["launches"][0] == got["launches"][1]
            faces = [a for n, a in got["traced"] if n == "halo.exchange"]
            assert len(faces) == 1 and faces[0]["exchange"] == "faces"
            assert faces[0]["bytes"] == 16 * 8 and faces[0]["block"] == (16, 16)
            dur, wtime = got["window"]
            assert dur == wtime
            assert got["window_attrs"] == {"phase": "step", "steps": 8, "workload": "diffusion",
                                           "variant": variant, "driver": "step"}
        assert [n for n, _ in out["hide"]["traced"]].count("overlap.step") == 1


def test_host_staged_stepper_spans_and_progress(tmp_path):
    from rocm_mpi_tpu_torch.parallel.halo import HostStagedStepper
    from rocm_mpi_tpu_torch.parallel.wire import OracleGrid

    events.configure(directory=tmp_path, rank=0)
    flight.enable(directory=tmp_path, rank=0)
    grid = OracleGrid(global_shape=(16, 12), dims=(2, 2), spacing=(0.5, 0.5))
    stepper = HostStagedStepper(grid, 1.0, 0.01, use_native=False, wire_mode="bf16")
    rng = np.random.default_rng(0)
    stepper.run(rng.random((16, 12)), np.ones((16, 12)), 3)
    recs = telemetry.records("span")
    halo = [r for r in recs if r["name"] == "halo.host_staged"]
    assert len(halo) == 3 and len([r for r in recs if r["name"] == "interior.host_staged"]) == 3
    # 2×2 shards of 8×6: each shard receives one 6-cell and one 8-cell ghost, bf16.
    assert halo[0]["attrs"] == {"phase": "halo", "bytes": 4 * (6 + 8) * 2}
    assert flight.snapshot()["counters"]["step"] == 3
    assert flight.snapshot()["counters"]["halo_exchanges"] == 3


def test_timed_window_span_is_the_runs_wtime(tmp_path):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion

    events.configure(directory=tmp_path, rank=0)
    cfg = DiffusionConfig(global_shape=(24, 24), nt=12, warmup=4, dims=(1, 1))
    res = HeatDiffusion(cfg, device="cpu").run("perf", driver="scan")
    (window,) = [r for r in telemetry.records("span") if r["name"] == "step_window"]
    assert window["dur_s"] == res.wtime
    assert window["attrs"] == {"phase": "step", "steps": 8, "workload": "diffusion",
                               "variant": "perf", "driver": "scan"}
    assert not compiles.steady_marked()


@pytest.mark.parametrize("timed, windows, unit, want", [
    (20, 1, 1, [20]), (20, 4, 1, [5, 5, 5, 5]), (20, 3, 1, [7, 7, 6]),
    (24, 4, 4, [8, 8, 4, 4]), (8, 8, 4, [4, 4]), (3, 8, 4, [3])])
def test_window_sizes_are_multiples_of_the_chunk(timed, windows, unit, want):
    from rocm_mpi_tpu_torch.utils.metrics import window_sizes

    assert window_sizes(timed, windows, unit) == want


def test_timed_window_splits_into_windows_with_a_boundary_hook(tmp_path):
    from rocm_mpi_tpu_torch.utils import metrics

    flight.enable(directory=tmp_path, rank=0)
    calls = []

    def advance(x, n):
        return x + n

    def boundary(x, step):
        calls.append((int(x), step))
        return x

    x, wtime = metrics.timed_window(advance, torch.zeros(()), 24, 4, windows=3, unit=4,
                                    on_boundary=boundary, variant="perf", driver="scan")
    # After the warmup, then at each window with the steps run so far.
    assert int(x) == 24 and calls == [(4, None), (4, 4), (12, 12), (20, 20)]
    recs = telemetry.records("span")
    (warm,) = [r for r in recs if r["name"] == "warmup"]
    assert warm["attrs"] == {"steps": 4, "variant": "perf", "driver": "scan"}
    windows = [r for r in recs if r["name"] == "step_window"]
    assert [(r["attrs"]["window"], r["attrs"]["steps"]) for r in windows] == [
        (0, 8), (1, 8), (2, 4)]
    assert sum(r["dur_s"] for r in windows) == pytest.approx(wtime, rel=1e-12)
    assert flight.snapshot()["counters"] == {"step": 24, "windows": 3}
    assert not compiles.steady_marked()


def test_windowed_weak_scaling_rows_say_their_windows(tmp_path, capsys):
    from rocm_mpi_tpu_torch.apps import weak_scaling

    tel = tmp_path / "telemetry"
    assert weak_scaling.main(["--device", "cpu", "--json", "--local", "16", "--nt", "24",
                              "--warmup", "4", "--counts", "1", "--telemetry-windows", "3",
                              "--telemetry", str(tel), "--health"]) == 0
    out = capsys.readouterr().out
    (row,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert row["windows"] == 3
    assert "3 telemetry windows, a sync and barrier each: compare with windowed rows only" in out
    recs = [json.loads(ln) for ln in (tel / "telemetry-rank0.jsonl").read_text().splitlines()]
    windows = [r for r in recs if r.get("name") == "step_window"]
    assert [r["attrs"]["steps"] for r in windows] == [8, 8, 4]  # multiples of q = 4
    assert len([r for r in recs if r.get("name") == "halo.heartbeat"]) == 4
    beat = json.loads((tel / "heartbeat-rank0.json").read_text())
    assert beat["counters"]["step"] == 24 and beat["counters"]["windows"] == 3
    # One CPU rank's scan route runs its steps eagerly: so do the probes.
    (probe,) = [r for r in recs if r.get("name") == "halo.probe"]
    assert probe["attrs"]["route"] == "eager" and probe["attrs"]["driver"] == "scan"


def test_a_captured_probe_replays_its_launches(tmp_path, fake_cuda):  # noqa: F811
    from test_torch_scan import _FakeGraph

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.telemetry import probes

    events.configure(directory=tmp_path, rank=0)
    compiles.install()
    x = torch.zeros(3)

    def launch():
        kernels.LAUNCHES["fused_step_cm"] += 1
        _FakeGraph.capturing.ops.append(lambda: x.add_(1))

    replay = probes._captured(launch, torch.device("cpu"))
    assert x.tolist() == [0, 0, 0] and kernels.LAUNCHES["fused_step_cm"] == 0
    assert compiles.snapshot()["programs"]["graph:probe"]["count"] == 1
    replay()
    replay()
    assert x.tolist() == [2, 2, 2] and kernels.LAUNCHES["fused_step_cm"] == 2


# ---------------------------------------------------------------------------
# Compiles: builds, loads and captures under the JAX gauge names
# ---------------------------------------------------------------------------


def test_compiles_silent_until_something_is_counted(tmp_path):
    events.configure(directory=tmp_path, rank=0)
    compiles.emit_gauges()
    assert telemetry.records("gauge") == []
    compiles.install()
    compiles.emit_gauges()
    gauges = {r["name"]: r["value"] for r in telemetry.records("gauge")}
    assert gauges == {"compiles.total": 0, "compiles.cache_misses": 0}


def test_a_capture_after_mark_steady_is_a_steady_state_recompile(tmp_path, fake_cuda):  # noqa: F811
    from rocm_mpi_tpu_torch.models import scan

    events.configure(directory=tmp_path, rank=0)
    compiles.install()
    compiles.record_build("stencil", 1.5)
    compiles.record_load_hit()
    loop = scan.ScanLoop(_toy_step, scan.graph_plan(4, 2), "scan-graph")
    state = (torch.rand(6, 5, dtype=torch.float64),)
    C = torch.full((6, 5), 0.1, dtype=torch.float64)
    state = loop(state, (C,), 4)  # the first call captures (warmup)
    compiles.mark_steady()
    assert compiles.steady_state() == 0
    loop.exact = True
    state = loop(state, (C,), 5)  # a one-step remainder graph: captured in the window
    compiles.unmark_steady()
    snap = compiles.snapshot()
    assert snap["programs"]["graph:step"]["count"] == len(loop.graphs) == 2
    assert snap["programs"]["graph:step"]["steady"] == 1 and compiles.steady_state() == 1
    assert snap["totals"] == {"backend_compiles": 3, "cache_hits": 1, "cache_misses": 1}
    compiles.emit_gauges()
    gauges = {r["name"]: r["value"] for r in telemetry.records("gauge")}
    assert gauges == {"compiles.total": 3, "compiles.cache_misses": 1,
                      "compiles.steady_state": 1}
    spans_ = [r for r in telemetry.records("span") if r["name"] == "compile.backend"]
    assert [r["attrs"]["steady"] for r in spans_] == [False, False, True]
    summary = aggregate.summarize({0: telemetry.records()})
    assert regress.regressions(regress.compare(summary, {"metrics": {
        "gauges.compiles.steady_state": {"value": 0, "direction": "lower"}}}))


# ---------------------------------------------------------------------------
# Checkpoint spans and storage-policy events
# ---------------------------------------------------------------------------


def test_checkpoint_spans_and_events_carry_the_jax_names(tmp_path, monkeypatch):
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    tel = tmp_path / "tel"
    events.configure(directory=tel, rank=0)
    flight.enable(directory=tel, rank=0)
    state = (torch.arange(12.0).reshape(3, 4),)
    store = tmp_path / "store"
    ckpt.save_state(store, 4, state)
    ckpt.restore_state(store, 4, state)
    real_write = ckpt._write_array
    fails = {"n": 0, "errno": None}

    def flaky(path, a):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError(fails["errno"] or errno.EIO, "injected")
        real_write(path, a)

    monkeypatch.setattr(ckpt, "_write_array", flaky)
    policy = ckpt.StoragePolicy(retries=1, backoff_s=0.0, sleep=lambda s: None)
    fails.update(n=1, errno=errno.EIO)
    ckpt.save_state(store, 8, state, storage=policy)  # one retry
    fails.update(n=1, errno=errno.ENOSPC)
    ckpt.save_state(store, 12, state, storage=policy)  # ENOSPC prunes, then saves
    fails.update(n=2, errno=errno.EIO)
    ckpt.run_segmented(lambda s, n: s, state, 8, store / "seg", 4, storage=policy)
    names = {r["name"] for r in telemetry.records("span")}
    assert {"checkpoint.save", "checkpoint.restore", "checkpoint.validate"} <= names
    evs = [r["name"] for r in telemetry.records("event")]
    assert {"ckpt.retry", "ckpt.enospc-prune", "ckpt.degraded", "ckpt.recovered"} <= set(evs)
    counters = flight.snapshot()["counters"]
    assert counters["ckpt_degraded"] == 1 and counters["ckpt_recovered"] == 1
    assert counters["step"] == 8
    stream = tel / "telemetry-rank0.jsonl"
    assert jax_regress.check_schema([str(stream)]) == regress.check_schema([str(stream)]) == []
    summary = aggregate.summarize_dir(tel)
    assert summary["phases"]["checkpoint"]["count"] >= 5
    assert summary["events"]["ckpt.degraded"] == 1


# ---------------------------------------------------------------------------
# --profile and the profiling app
# ---------------------------------------------------------------------------


def test_profile_writes_a_chrome_trace_with_the_jax_required_keys(tmp_path):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    assert diffusion_2d_perf.main([*APP, "--profile", str(tmp_path / "prof")]) == 0
    doc = json.loads((tmp_path / "prof" / "trace-rank0.json").read_text())
    assert doc["traceEvents"]
    for e in doc["traceEvents"]:
        assert all(k in e for k in jax_trace.TRACE_REQUIRED_KEYS), e


def test_profiling_app_writes_prof_txt_and_refuses_checkpoints(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof",
           "--device", "cpu", "--nx", "64", "--ny", "64", "--nt", "20", "--warmup", "4"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = (tmp_path / "prof.txt").read_text()
    assert "timed walltime" in report and "(16 steps, under the profiler)" in report
    assert (tmp_path / "prof_trace" / "trace-rank0.json").is_file()
    refused = subprocess.run([*cmd, "--checkpoint", "ck"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
    assert refused.returncode == 2 and "not supported by the profiling app" in refused.stdout


@pytest.mark.parametrize("requested, ranks, device, want", [
    (None, 1, "cuda", "scan"), (None, 4, "cuda", "scan"), (None, 2, "cpu", "scan"),
    ("scan", 2, "cpu", "scan"), ("step", 1, "cuda", "step"), ("scan", 4, "cuda", "scan")])
def test_profiling_app_profiles_the_step_driver_on_cuda_ranks(requested, ranks, device, want):
    # The scan driver is the default on any number of CUDA ranks again:
    # the twin's graphs now end before the process group is destroyed
    # (its profiled_run), which is what hung; --driver step takes the loop.
    from rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof import pick_driver

    assert pick_driver(requested, ranks, device) == want


APPS = ("diffusion_2d_perf", "diffusion_2d_perf_hide", "diffusion_2d_kp", "diffusion_2d_ap",
        "diffusion_3d_perf_hide", "diffusion_2d_perf_hide_prof", "wave_2d", "swe_2d",
        "weak_scaling", "ici_ring_test")


@pytest.mark.parametrize("app", APPS)
def test_every_app_takes_telemetry_health_and_profile(app, capsys):
    import importlib

    module = importlib.import_module(f"rocm_mpi_tpu_torch.apps.{app}")
    with pytest.raises(SystemExit) as done:
        module.main(["--help"])
    assert done.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--telemetry DIR", "--health", "--profile DIR"):
        assert flag in text, (app, flag)
