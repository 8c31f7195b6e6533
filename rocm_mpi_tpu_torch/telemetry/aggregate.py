"""Merge per-rank telemetry streams into one run summary — counterpart of
rocm_mpi_tpu/telemetry/aggregate.py: on the same streams the two give
the same document (tests/test_torch_telemetry.py holds them equal).

Input: a directory of `telemetry-rank{k}.jsonl` files (events.py's
writers — each rank wrote its own, so merging is a read-side concern).
Output: one summary dict (schema below) answering the questions the
ROADMAP's scale work keeps asking:

* where did the wall time go, per phase (halo / interior / checkpoint /
  step) and per rank — the attribution without which stencil perf work
  "devolves into guesswork" (arxiv 2406.08923 §1, 2404.04441 §2);
* how fast were the steps (percentiles across step windows, not just the
  mean the reference prints — a straggling window is invisible in wtime/nt);
* how much halo traffic moved, and at what bytes/s;
* did any rank straggle (its phase wall vs the cross-rank median — the
  multi-chip failure mode weak scaling hides inside an aggregate number);
* what did the resilience layer do (event counts by kind).

Summary schema (``SUMMARY_SCHEMA``/``SUMMARY_VERSION``):

    {"schema": "rocm_mpi_tpu.telemetry.summary", "v": 1,
     "ranks": [int], "records": int, "skipped_lines": int,
     "phases": {phase: {"wall_s", "count", "bytes", "bytes_per_s",
                        "by_rank": {str(rank): wall_s}}},
     "steps": {"count", "windows", "wall_s",
               "per_step_us": {"mean","p50","p90","p99"}},
     "gauges": {key: value}, "counters": {name: sum},
     "gauge_series": [{"name","value","rank","attrs"}],
     "events": {name: count}, "traced": {name: attrs},
     "stragglers": [{"rank","phase","wall_s","median_s","ratio"}]}

Gauge keys carry the `devices` attr when present (`run.gpts@4dev`), so
a weak-scaling sweep's per-rung rates stay distinct — flat last-wins
would let a mid-ladder regression hide behind the final rung — and the
regress gate compares rung against like rung. Numeric samples that share
a key (every rank emits its own jittering copy of a rung's rate) reduce
to the cross-rank MEDIAN — an arbitrary single rank's sample would make
the regress gate fire on one straggler and miss a slowdown confined to
the others. `gauge_series` keeps every emission (rank, full attrs) for
anything the keyed view collapses.

The canonical phases (halo, interior, checkpoint, step) are always
present — a zero row says "observed nothing", which is itself
attribution; absence would just be ambiguity. stdlib-only: summarize
runs where torch never will (CI boxes, laptops reading a run's stream).
"""

from __future__ import annotations

import json
import pathlib
import re
import statistics

SUMMARY_SCHEMA = "rocm_mpi_tpu.telemetry.summary"
SUMMARY_VERSION = 1

CANONICAL_PHASES = ("halo", "interior", "checkpoint", "step")

# A rank is a straggler when its phase wall exceeds the cross-rank median
# by this factor (and the phase saw real time — see _MIN_STRAGGLER_WALL_S).
DEFAULT_STRAGGLER_FACTOR = 1.5
_MIN_STRAGGLER_WALL_S = 1e-4

_RANK_FILE_RE = re.compile(r"telemetry-rank(\d+)\.jsonl$")


def rank_stream_paths(directory) -> dict[int, pathlib.Path]:
    """{rank: path} of the per-rank streams under `directory`."""
    out: dict[int, pathlib.Path] = {}
    root = pathlib.Path(directory)
    if not root.is_dir():
        return out
    for path in sorted(root.glob("telemetry-rank*.jsonl")):
        m = _RANK_FILE_RE.search(path.name)
        if m:
            out[int(m.group(1))] = path
    return out


def load_rank_streams(directory) -> tuple[dict[int, list[dict]], int]:
    """Parse every rank stream. Returns ({rank: [records]}, skipped_lines).
    Unparseable lines are counted and skipped — a rank killed mid-write
    leaves a torn last line, and the surviving records are the point."""
    streams: dict[int, list[dict]] = {}
    skipped = 0
    for rk, path in rank_stream_paths(directory).items():
        recs: list[dict] = []
        try:
            text = path.read_text()
        except OSError:
            skipped += 1
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict) and "kind" in rec:
                rec.setdefault("rank", rk)
                recs.append(rec)
            else:
                skipped += 1
        streams[rk] = recs
    return streams, skipped


def record_wire_mode(rec: dict) -> str | None:
    """The wire-precision mode a telemetry record annotates, or None.
    THE one definition of "this record stamps a wire mode" — the
    summary's `wire_modes` list and the monitor's WIRE badge
    (telemetry.health.wire_status) both consume it, so the annotation
    shape can never drift between the two read sides."""
    if rec.get("kind") != "trace":
        return None
    w = (rec.get("attrs") or {}).get("wire")
    return str(w) if w else None


def phase_of(rec: dict) -> str:
    """A record's phase: the explicit `phase` attr wins, else the dotted
    name's first component, with the step-window spelling folded in."""
    attrs = rec.get("attrs") or {}
    if "phase" in attrs:
        return str(attrs["phase"])
    head = str(rec.get("name", "")).split(".", 1)[0]
    return "step" if head == "step_window" else head


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(streams: dict[int, list[dict]], skipped_lines: int = 0,
              straggler_factor: float = DEFAULT_STRAGGLER_FACTOR) -> dict:
    """Merge per-rank record streams into the summary dict (module
    docstring has the schema)."""
    phases: dict[str, dict] = {
        p: {"wall_s": 0.0, "count": 0, "bytes": 0, "by_rank": {}}
        for p in CANONICAL_PHASES
    }
    per_step_us: list[float] = []
    step_count = 0
    step_windows = 0
    gauge_samples: dict[str, list] = {}
    gauge_series: list[dict] = []
    counters: dict[str, float] = {}
    event_counts: dict[str, int] = {}
    traced: dict[str, dict] = {}
    wire_modes: set[str] = set()
    tspan_counts: dict[str, int] = {}
    trace_ids: set[str] = set()
    n_records = 0

    for rk, recs in sorted(streams.items()):
        for rec in recs:
            n_records += 1
            kind = rec.get("kind")
            attrs = rec.get("attrs") or {}
            if kind == "span":
                ph = phase_of(rec)
                row = phases.setdefault(
                    ph, {"wall_s": 0.0, "count": 0, "bytes": 0, "by_rank": {}}
                )
                dur = float(rec.get("dur_s", 0.0))
                row["wall_s"] += dur
                row["count"] += 1
                row["bytes"] += int(attrs.get("bytes", 0) or 0)
                row["by_rank"][str(rk)] = (
                    row["by_rank"].get(str(rk), 0.0) + dur
                )
                steps = attrs.get("steps")
                if ph == "step" and steps:
                    step_windows += 1
                    step_count += int(steps)
                    per_step_us.append(dur / int(steps) * 1e6)
            elif kind == "gauge":
                key = rec["name"]
                if "devices" in attrs:
                    key = f"{key}@{attrs['devices']}dev"
                if "driver" in attrs:
                    # The loop form is part of the measurement's identity:
                    # a scan-driver rate and a step-driver rate must land
                    # under distinct keys so the regress gate can never
                    # compare them silently (apps/_common.py --driver).
                    key = f"{key}:{attrs['driver']}"
                if attrs.get("wire") and attrs["wire"] != "f32":
                    # Same identity rule for the wire-precision plane:
                    # an f32 rate and a bf16-wire rate are different
                    # measurements (the default spelling is unchanged
                    # so committed baselines keep gating f32 runs).
                    key = f"{key}:{attrs['wire']}"
                gauge_samples.setdefault(key, []).append(rec.get("value"))
                gauge_series.append({
                    "name": rec["name"], "value": rec.get("value"),
                    "rank": rk, "attrs": attrs,
                })
            elif kind == "counter":
                try:
                    counters[rec["name"]] = (
                        counters.get(rec["name"], 0) + rec.get("value", 0)
                    )
                except TypeError:
                    pass  # non-numeric counter: drop, never crash the merge
            elif kind == "event":
                event_counts[rec["name"]] = (
                    event_counts.get(rec["name"], 0) + 1
                )
            elif kind == "tspan":
                # Request-trace transitions (telemetry/tracing.py):
                # the summary counts them per name and the distinct
                # traces observed — the cheap "is tracing on, and how
                # much is it writing" view; the per-request read side
                # is the `telemetry trace` verb, not the summary.
                tspan_counts[rec.get("name", "?")] = (
                    tspan_counts.get(rec.get("name", "?"), 0) + 1
                )
                tid = rec.get("trace_id")
                if isinstance(tid, str):
                    trace_ids.add(tid)
            elif kind == "trace":
                traced[rec["name"]] = attrs
                # The active wire-precision mode(s), annotation-sourced
                # (halo.exchange / deep.sweep / overlap.step stamp it at
                # trace time): collected ACROSS records, because `traced`
                # keeps only the last attrs per name and a mixed-mode
                # run would otherwise report just one mode.
                w = record_wire_mode(rec)
                if w:
                    wire_modes.add(w)

    gauges: dict[str, object] = {}
    for key, samples in gauge_samples.items():
        numeric = [v for v in samples if isinstance(v, (int, float))]
        if numeric and len(numeric) == len(samples):
            gauges[key] = statistics.median(numeric)
        else:
            gauges[key] = samples[-1]

    for row in phases.values():
        row["wall_s"] = round(row["wall_s"], 9)
        row["bytes_per_s"] = (
            round(row["bytes"] / row["wall_s"], 3)
            if row["bytes"] and row["wall_s"] > 0 else 0.0
        )

    per_step_us.sort()
    steps = {
        "count": step_count,
        "windows": step_windows,
        "wall_s": round(phases["step"]["wall_s"], 9),
        "per_step_us": {
            "mean": round(sum(per_step_us) / len(per_step_us), 3)
            if per_step_us else 0.0,
            "p50": round(_percentile(per_step_us, 0.50), 3),
            "p90": round(_percentile(per_step_us, 0.90), 3),
            "p99": round(_percentile(per_step_us, 0.99), 3),
        },
    }

    stragglers = []
    if len(streams) >= 2:
        for ph, row in phases.items():
            walls = sorted(row["by_rank"].items(), key=lambda kv: kv[1])
            if len(walls) < 2:
                continue
            vals = [w for _, w in walls]
            # True median (interpolating for even counts): nearest-rank
            # would return the FASTEST rank's wall in the 2-rank case and
            # over-flag the other one.
            median = statistics.median(vals)
            if median < _MIN_STRAGGLER_WALL_S:
                continue
            for rk_s, wall in walls:
                if wall > straggler_factor * median:
                    stragglers.append({
                        "rank": int(rk_s),
                        "phase": ph,
                        "wall_s": round(wall, 6),
                        "median_s": round(median, 6),
                        "ratio": round(wall / median, 3),
                    })

    return {
        "schema": SUMMARY_SCHEMA,
        "v": SUMMARY_VERSION,
        "ranks": sorted(streams),
        "records": n_records,
        "skipped_lines": skipped_lines,
        "phases": phases,
        "steps": steps,
        "gauges": gauges,
        "gauge_series": gauge_series,
        "counters": counters,
        "events": event_counts,
        "traced": traced,
        "tspans": tspan_counts,
        "trace_requests": len(trace_ids),
        "wire_modes": sorted(wire_modes),
        "stragglers": stragglers,
    }


def summarize_dir(directory,
                  straggler_factor: float = DEFAULT_STRAGGLER_FACTOR) -> dict:
    streams, skipped = load_rank_streams(directory)
    return summarize(streams, skipped, straggler_factor)


def write_json_atomic(path, doc: dict, indent: int | None = 1) -> None:
    """Publish a JSON artifact via tmp + rename: a process killed
    mid-write must never leave a half-written summary/trace for the
    regress gate or an archive to trust."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(doc, indent=indent))
    tmp.replace(path)


def write_summary(directory, out_path=None,
                  straggler_factor: float = DEFAULT_STRAGGLER_FACTOR) -> dict:
    """Summarize `directory`'s rank streams and write the summary next to
    them (default: <directory>/telemetry-summary.json). Returns the dict."""
    summary = summarize_dir(directory, straggler_factor)
    path = (pathlib.Path(out_path) if out_path
            else pathlib.Path(directory) / "telemetry-summary.json")
    write_json_atomic(path, summary)
    return summary


def format_summary(summary: dict) -> str:
    """Human-readable report of a summary (the CLI's default output)."""
    lines = [
        f"telemetry summary: ranks={summary['ranks']} "
        f"records={summary['records']} "
        f"(skipped_lines={summary['skipped_lines']})",
        "phase        wall_s      count   bytes        bytes/s",
    ]
    for ph in sorted(summary["phases"],
                     key=lambda p: (p not in CANONICAL_PHASES, p)):
        row = summary["phases"][ph]
        lines.append(
            f"{ph:12s} {row['wall_s']:<11.6f} {row['count']:<7d} "
            f"{row['bytes']:<12d} {row['bytes_per_s']:.3g}"
        )
    st = summary["steps"]
    if st["windows"]:
        p = st["per_step_us"]
        lines.append(
            f"steps: {st['count']} over {st['windows']} window(s), "
            f"per-step us mean={p['mean']} p50={p['p50']} "
            f"p90={p['p90']} p99={p['p99']}"
        )
    wire_modes = summary.get("wire_modes") or []
    if wire_modes and wire_modes != ["f32"]:
        # The badge: a reduced-precision (or mixed) wire must be
        # impossible to miss next to an f32 summary — the f32-only case
        # stays silent so existing reports are byte-identical.
        lines.append("WIRE MODE: " + ", ".join(wire_modes))
    for name, value in sorted(summary["gauges"].items()):
        lines.append(f"gauge {name} = {value}")
    for name, n in sorted(summary["events"].items()):
        lines.append(f"event {name} × {n}")
    if summary["stragglers"]:
        for s in summary["stragglers"]:
            lines.append(
                f"STRAGGLER rank {s['rank']} in phase {s['phase']}: "
                f"{s['wall_s']}s vs median {s['median_s']}s "
                f"({s['ratio']}x)"
            )
    else:
        lines.append("no stragglers detected")
    return "\n".join(lines)
