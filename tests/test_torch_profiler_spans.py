"""The port's spans on torch.profiler's clock (telemetry/spans.py), on
the CPU:

* with telemetry off and no profiler, `span()` is the no-op singleton;
* under a profiler with telemetry off, one scan advance writes its four
  per-call spans into the exported Chrome trace as `user_annotation`
  ranges, prepare, bind and replay nested in the advance, once a call
  whatever the replays, and nothing into the telemetry stream;
* with both on, the stream and the trace hold the same four names;
* an app's `--telemetry` summary keeps its step phase total with the
  nested spans in the stream, and its `--profile` trace holds them.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion, scan
from rocm_mpi_tpu_torch.telemetry import aggregate, compiles, events, flight, spans
from test_torch_scan import _toy_step, fake_cuda  # noqa: F401 — the stand-in capture

FOUR = ("diffusion.advance", "diffusion.prepare", "scan.bind", "scan.replay")
APP = ["--device", "cpu", "--nx", "32", "--ny", "32", "--nt", "20", "--warmup", "4"]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Telemetry and the flight recorder off and empty, compile
    accounting reset."""
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
    events.clear()
    flight.reset()
    compiles.reset()


def _annotations(prof, path) -> list[dict]:
    """The user_annotation events of `prof`'s exported Chrome trace."""
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _advance(nt=40):
    cfg = DiffusionConfig(global_shape=(24, 24), nt=nt, warmup=0, dims=(1, 1), dtype="f64")
    model = HeatDiffusion(cfg, device="cpu")
    advance, q = model.scan_advance_fn("perf", nt=nt, warmup=0, chunk=10)
    T, Cp = model.init_state()
    return advance, T, Cp, q


def test_off_without_a_profiler_is_the_noop_singleton():
    assert not torch.autograd._profiler_enabled()
    sp = telemetry.span("diffusion.advance", phase="advance")
    assert sp is spans._NOOP and sp.sync(3) == 3


def test_profiler_alone_gets_the_four_spans_nested_and_no_record(tmp_path):
    events.configure(enabled=False, directory=tmp_path / "tel", rank=0)
    advance, T, Cp, q = _advance()
    T = advance(T, Cp, 40)  # the first call outside the profiler
    assert advance.loop.route == "scan-eager" and q == 10
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = telemetry.span("x")
        assert isinstance(sp, spans.Span) and sp.sync(5) == 5
        T = advance(T, Cp, 40)
    marks = _annotations(prof, tmp_path / "trace.json")
    by_name = {name: [e for e in marks if e["name"] == name] for name in FOUR}
    # Once a call: four replays of 10 steps open one replay span.
    assert all(len(v) == 1 for v in by_name.values()), by_name
    (outer,) = by_name["diffusion.advance"]
    inner = [by_name[name][0] for name in FOUR[1:]]
    for e in inner:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    # prepare, then bind, then replay, one after the other.
    for a, b in zip(inner, inner[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert events.records() == [] and not (tmp_path / "tel" / "telemetry-rank0.jsonl").exists()


def test_telemetry_and_profiler_hold_the_same_four_names(tmp_path):
    advance, T, Cp, _ = _advance()
    T = advance(T, Cp, 40)
    events.configure(directory=tmp_path, rank=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T = advance(T, Cp, 40)
    recs = telemetry.records("span")
    assert sorted(r["name"] for r in recs) == sorted(FOUR)
    assert sorted(e["name"] for e in _annotations(prof, tmp_path / "trace.json")) == \
        sorted(FOUR)
    phases = {r["name"]: r["attrs"]["phase"] for r in recs}
    assert phases == {"diffusion.advance": "advance", "diffusion.prepare": "prepare",
                      "scan.bind": "bind", "scan.replay": "replay"}
    depth = {r["name"]: r["depth"] for r in recs}
    assert depth["diffusion.advance"] == 0 and depth["scan.replay"] == 1
    assert [r for r in recs if r["name"] == "scan.replay"][0]["attrs"]["replays"] == 4


def test_telemetry_alone_writes_the_spans_as_before(tmp_path):
    advance, T, Cp, _ = _advance()
    events.configure(directory=tmp_path, rank=0)
    T = advance(T, Cp, 40)
    assert sorted(r["name"] for r in telemetry.records("span")) == sorted(FOUR)
    lines = (tmp_path / "telemetry-rank0.jsonl").read_text().splitlines()
    assert sorted(json.loads(x)["name"] for x in lines[1:]) == sorted(FOUR)


def test_graph_route_opens_one_replay_span_a_call(fake_cuda, tmp_path):
    state = (torch.rand(12, 8, dtype=torch.float64),)
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    loop = scan.ScanLoop(_toy_step, scan.graph_plan(10, 2, 4), "scan-graph")
    state = loop(state, (C,), 40)  # captures
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            state = loop(state, (C,), 40)
    names = [e["name"] for e in _annotations(prof, tmp_path / "trace.json")]
    assert sorted(names) == ["scan.bind"] * 3 + ["scan.replay"] * 3


def test_summary_keeps_the_step_phase_with_nested_spans(tmp_path, capsys):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    tel = tmp_path / "tel"
    assert diffusion_2d_perf.main([*APP, "--telemetry", str(tel)]) == 0
    capsys.readouterr()
    recs = [json.loads(x) for x in (tel / "telemetry-rank0.jsonl").read_text().splitlines()]
    spans_ = [r for r in recs if r["kind"] == "span"]
    window = [r for r in spans_ if r["name"] == "step_window"]
    assert len(window) == 1
    # The warmup's call and the window's: each opens the four spans once.
    assert sorted(r["name"] for r in spans_ if r["name"] in FOUR) == sorted(FOUR * 2)
    summary = aggregate.summarize_dir(tel)
    phases = summary["phases"]
    assert phases["step"]["count"] == 1
    assert phases["step"]["wall_s"] == round(window[0]["dur_s"], 9)
    assert summary["steps"]["count"] == 16 and summary["steps"]["wall_s"] == \
        phases["step"]["wall_s"]
    for phase in ("advance", "prepare", "bind", "replay"):
        assert phases[phase]["count"] == 2
    inner = sum(phases[p]["wall_s"] for p in ("prepare", "bind", "replay"))
    assert inner <= phases["advance"]["wall_s"]


def test_app_profile_trace_holds_the_spans(tmp_path, capsys):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    assert diffusion_2d_perf.main([*APP, "--profile", str(tmp_path / "prof")]) == 0
    capsys.readouterr()
    doc = json.loads((tmp_path / "prof" / "trace-rank0.json").read_text())
    names = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"]
    assert all(names.count(name) >= 1 for name in FOUR), names
