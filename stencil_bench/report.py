"""The result line of a run, from the ranks' facts.

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

`attempted` counts the runs (simulations of nt steps) the window
completed; `failed` the runs the check judged wrong (the last run is the
one checked; every run of a window starts from the same inputs). Each
metric is its reader's (stencil_bench/metrics/<name>.py), left out where
the reader finds nothing to read. `checks`, the last key, holds each
number compared with its limit (the program adapter's `checks`).
"""

from __future__ import annotations

import dataclasses

from stencil_bench import compare, trace


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the cell, every rank's facts (dicts;
    stencil_bench/cell.py run_rank) and, in a traced run, their slices."""

    cell: object
    ranks: list[dict]
    on_device: bool

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.ranks if r.get("trace") is not None]


def build(cell, ranks: list[dict], traced: bool, kind: str, on_device: bool) -> dict:
    ctx = Context(cell=cell, ranks=ranks, on_device=on_device)
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = cell.program().checks(cell.config, [r["readings"] for r in ranks])
    correct = all(compare.judge(c["value"], c["limit"]) for c in found.values())
    peaks = [r["peak_bytes"] for r in ranks if r["peak_bytes"] is not None]
    device = {"platform": "gpu" if on_device else "cpu", "kind": kind, "count": len(ranks),
              "memory_peak_bytes": max(peaks) if peaks else 0}
    line = {"correct": correct, "attempted": ranks[0]["runs"], "failed": 0 if correct else 1,
            "metrics": metrics, "device": device}
    if traced:
        slices = ctx.traces
        device["busy_s"] = sum(t.busy_s() for t in slices) / len(slices)
        device["window_s"] = sum(t.window_s for t in slices) / len(slices)
        line["breakdown"] = trace.breakdown(slices)
    line["checks"] = found
    return line


def check_lines(line: dict) -> list[str]:
    """The numbers compared, one a line, for the end of standard error."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in line["checks"].items()]
