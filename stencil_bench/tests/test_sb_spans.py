"""The readers of the program's spans (driver.replay_host_us,
entry.advance_host_ms) on hand-made slices, which cells carry them, and
a traced CPU run of the 252² cell in which the program's spans reach the
slice."""

from __future__ import annotations

import time

import pytest

from stencil_bench import registry, run, trace
from stencil_bench.report import Context
from stencil_bench.tests import helpers

SMALL = "diff2d-perf-f64-252"
SPAN_METRICS = {"driver.replay_host_us", "entry.advance_host_ms"}


def _span(name, start, end):
    return trace.Event(name, "user_annotation", start, end)


def _launch(start):
    return trace.Event("cudaGraphLaunch", "cuda_runtime", start, start + 2e-6)


def _rank(host, t0=0.0, t1=1.0):
    data = trace.TraceData(t0=t0, t1=t1, steps=2000, device=[], host=host)
    return {"trace": data, "steps_per_run": 1000, "capture_s": 0.02, "run_device_s": 2e-3}


def _read(metric, *ranks):
    cell = registry.cell(SMALL)
    return cell.reader(metric)(Context(cell=cell, ranks=list(ranks), on_device=True))


def _calls(advance_ms, replay_us, launches, at=0.1):
    """Two advance calls, each holding a replay span of `launches` graph
    launches `replay_us` apart (the span `launches * replay_us` long)."""
    host = []
    for k in range(2):
        start = at + k * 0.01
        host.append(_span("diffusion.advance", start, start + advance_ms[k] * 1e-3))
        host.append(_span("diffusion.prepare", start + 1e-5, start + 2e-5))
        host.append(_span("scan.bind", start + 2e-5, start + 3e-5))
        r0 = start + 4e-5
        host.append(_span("scan.replay", r0, r0 + launches * replay_us * 1e-6))
        host += [_launch(r0 + i * replay_us * 1e-6) for i in range(launches)]
    return host


def test_readers_by_hand():
    host = _calls([1.5, 2.5], 12.0, 100)
    # A launch outside every replay span (the harness's, or a capture's) is not counted.
    host.append(_launch(0.5))
    rank = _rank(host)
    assert _read("driver.replay_host_us", rank) == pytest.approx(12.0)
    assert _read("entry.advance_host_ms", rank) == pytest.approx(2.0)


def test_only_spans_wholly_in_the_slice_count_as_calls():
    # The harness's slice annotation bounds the slice where the trace has it.
    host = _calls([1.0, 3.0], 10.0, 10, at=0.1)
    rank = _rank(host + [_span(trace.SLICE_NAME, 0.105, 0.2)], t0=0.106, t1=0.15)
    assert _read("entry.advance_host_ms", rank) == pytest.approx(3.0)
    # Without it, the device-clipped bounds.
    rank = _rank(host, t0=0.105, t1=0.2)
    assert _read("entry.advance_host_ms", rank) == pytest.approx(3.0)
    # A replay span cut by the slice counts its part inside and the launches
    # there: 50 + 100 us over 5 + 10 launches.
    cut = _rank(host, t0=0.1 + 4e-5 + 50e-6, t1=0.2)
    assert _read("driver.replay_host_us", cut) == pytest.approx(10.0)


def test_nothing_to_read_without_spans_or_launches():
    no_spans = _rank([_launch(0.1 + i * 1e-5) for i in range(10)])
    assert _read("driver.replay_host_us", no_spans) is None
    assert _read("entry.advance_host_ms", no_spans) is None
    host = [e for e in _calls([1.0, 1.0], 10.0, 5) if e.cat != "cuda_runtime"]
    assert _read("driver.replay_host_us", _rank(host)) is None
    assert _read("entry.advance_host_ms", _rank(host)) == pytest.approx(1.0)
    assert _read("driver.replay_host_us", _rank([])) is None


def test_mean_over_ranks_and_the_largest_rank():
    a = _rank(_calls([1.0, 1.0], 10.0, 20))
    b = _rank(_calls([3.0, 5.0], 20.0, 20))
    assert _read("driver.replay_host_us", a, b) == pytest.approx(15.0)
    assert _read("entry.advance_host_ms", a, b) == pytest.approx(4.0)
    # A rank without spans: the program has none, so nothing is read.
    assert _read("driver.replay_host_us", a, _rank([])) is None
    assert _read("entry.advance_host_ms", a, _rank([])) is None


def test_only_the_252_cell_carries_the_span_metrics():
    traced = {m["name"] for m in registry.cell(SMALL).metrics(True)}
    assert SPAN_METRICS <= traced
    assert not SPAN_METRICS & {m["name"] for m in registry.cell(SMALL).metrics(False)}
    for name in (helpers.PERF, helpers.HIDE):
        assert not SPAN_METRICS & {m["name"] for m in registry.cell(name).metrics(True)}
    for m in registry.benchmark()["per_layer"]:
        if m["name"] in SPAN_METRICS:
            assert m["source"] == "program_span" and m["workloads"] == [SMALL]


def test_a_traced_cpu_run_of_the_252_cell_reads_the_advance():
    cell = helpers.small_cell(SMALL)
    ranks, line = run.execute(cell, 2 ** 31 + 23, 0.3, True, device="cpu",
                              t_start=time.time())
    assert line["correct"] is True
    host = ranks[0]["trace"].host
    for name in ("diffusion.advance", "diffusion.prepare", "scan.bind", "scan.replay"):
        # Two traced runs, one call each.
        assert sum(e.name == name and e.cat == "user_annotation" for e in host) == 2, name
    assert line["metrics"]["entry.advance_host_ms"]["value"] > 0
    assert "driver.replay_host_us" not in line["metrics"]  # the CPU replays no graph
