"""Chrome trace-event export: one track per rank, openable in Perfetto —
counterpart of rocm_mpi_tpu/telemetry/trace.py (the same document on the
same streams).

The standard trace-event JSON every Chrome/Perfetto build renders
(https://ui.perfetto.dev, chrome://tracing). Mapping:

* span   -> complete slice  (ph "X"): pid = rank, tid = recording thread,
            ts/dur in microseconds; Perfetto nests slices on a track by
            containment, which the per-thread span stack guarantees.
* counter-> counter sample  (ph "C") on the rank's track.
* gauge  -> counter sample  (ph "C") — a gauge is a one-point counter.
* event  -> instant         (ph "i", scope "p"): retries/restores show as
            pins on the rank that emitted them.
* trace  -> process metadata: static per-program facts (bytes per halo
            exchange) land in the rank's metadata args, not on the
            timeline (they have no duration).

Health-plane inputs (optional — the post-mortem bundle's merged
timeline, telemetry/health.py):

* heartbeat sidecars -> one counter track per rank: each heartbeat's
  progress counters become a "progress" counter sample (ph "C") at the
  heartbeat's wall stamp, so the stalled rank's flat-lining step counter
  is visible right on its track.
* watchdog verdicts  -> one global instant (ph "i", scope "g") each,
  pinned to the flagged rank's track and carrying the verdict args —
  the first thing an operator should see when the trace opens.

Events are emitted sorted by ts (metadata first): Perfetto tolerates
unsorted input, but the post-mortem reader (and the tests) treat the
file as a timeline and must not have to re-sort it.

Cross-rank alignment: a stream that carries a
`clock.anchor` record (telemetry/tracing.py — every `configure()`d rank
does) is positioned on the anchor-mapped clock, `anchor_t + (t_mono -
anchor_t_mono)`: tear-free WITHIN the rank (monotonic) and comparable
ACROSS fleet replicas (one wall read per process, not one per record).
Anchor-less legacy streams fall back to per-record wall stamps — their
records may misalign against anchored ranks, so the export WARNS about
them (`otherData.warnings`) instead of silently interleaving two clock
disciplines. The trace origin is the earliest aligned stamp across all
ranks. Durations come from `dur_s` (monotonic-derived), so slice widths
never inherit wall-clock jumps. stdlib-only, like the whole read side.
"""

from __future__ import annotations

import pathlib

from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

TRACE_REQUIRED_KEYS = ("name", "ph", "ts", "pid")


def to_chrome_trace(streams: dict[int, list[dict]],
                    heartbeats: dict[int, dict] | None = None,
                    verdicts: list[dict] | None = None) -> dict:
    """Build the trace-event document from per-rank record streams
    (aggregate.load_rank_streams shape), optionally merged with health
    sidecars and watchdog verdicts (module docstring)."""
    anchors = {rk: _tracing.anchor_of(recs)
               for rk, recs in streams.items()}
    warnings: list[str] = []
    if any(a is not None for a in anchors.values()):
        for rk in sorted(streams):
            if anchors[rk] is None and streams[rk]:
                warnings.append(
                    f"rank {rk} stream has no clock.anchor record "
                    "(legacy): its events are placed by per-record "
                    "wall stamps and may misalign against anchored "
                    "ranks"
                )
    elif len(streams) > 1:
        warnings.append(
            "no stream carries a clock.anchor record: cross-rank "
            "alignment falls back to per-record wall stamps"
        )
    wall_stamps = [
        w
        for rk, recs in streams.items()
        for w in (_tracing.aligned_wall(r, anchors[rk]) for r in recs)
        if w is not None
    ]
    for doc in (heartbeats or {}).values():
        if isinstance(doc.get("t"), (int, float)):
            wall_stamps.append(doc["t"])
    origin = min(wall_stamps) if wall_stamps else 0.0

    events: list[dict] = []
    ranks = sorted(set(streams) | set(heartbeats or {}))
    for rk in ranks:
        if rk in streams:
            continue
        events.append({
            "name": "process_name", "ph": "M", "pid": rk, "ts": 0,
            "args": {"name": f"rank {rk}"},
        })
    for rk in sorted(streams):
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": rk,
            "ts": 0,
            "args": {"name": f"rank {rk}"},
        })
        for rec in streams[rk]:
            kind = rec.get("kind")
            if kind == _tracing.ANCHOR_KIND:
                continue  # alignment machinery, not a timeline event
            t = _tracing.aligned_wall(rec, anchors.get(rk))
            if t is None:
                continue
            ts = (t - origin) * 1e6
            attrs = rec.get("attrs") or {}
            if kind == "span":
                events.append({
                    "name": rec.get("name", "?"),
                    "ph": "X",
                    "ts": ts,
                    "dur": max(float(rec.get("dur_s", 0.0)) * 1e6, 0.0),
                    "pid": rk,
                    "tid": rec.get("tid", 0),
                    "args": attrs,
                })
            elif kind in ("counter", "gauge"):
                events.append({
                    "name": rec.get("name", "?"),
                    "ph": "C",
                    "ts": ts,
                    "pid": rk,
                    "args": {rec.get("name", "?"): rec.get("value", 0)},
                })
            elif kind == "event":
                events.append({
                    "name": rec.get("name", "?"),
                    "ph": "i",
                    "s": "p",
                    "ts": ts,
                    "pid": rk,
                    "tid": rec.get("tid", 0),
                    "args": {
                        k: v for k, v in rec.items()
                        if k in ("attempt", "step", "wait_s", "error")
                    },
                })
            elif kind == _tracing.TRACE_KIND:
                # Request-trace transitions (telemetry/tracing.py):
                # instants carrying the trace context, so a request's
                # path is searchable by trace_id in the merged view.
                events.append({
                    "name": rec.get("name", "?"),
                    "ph": "i",
                    "s": "p",
                    "ts": ts,
                    "pid": rk,
                    "tid": rec.get("tid", 0),
                    "args": {
                        k: v for k, v in rec.items()
                        if k in ("trace_id", "span_id", "parent_id",
                                 "hop", "seq", "seg", "bin", "width",
                                 "replica", "reroute", "members")
                        and v is not None
                    },
                })
            elif kind == "trace":
                events.append({
                    "name": f"traced:{rec.get('name', '?')}",
                    "ph": "M",
                    "pid": rk,
                    "ts": 0,
                    "args": attrs,
                })
    for rk in sorted(heartbeats or {}):
        doc = heartbeats[rk]
        t = doc.get("t")
        counters = doc.get("counters") or {}
        if not isinstance(t, (int, float)) or not counters:
            continue
        events.append({
            "name": "progress",
            "ph": "C",
            "ts": (t - origin) * 1e6,
            "pid": rk,
            "args": {
                k: v for k, v in sorted(counters.items())
                if isinstance(v, (int, float))
            },
        })
    for v in verdicts or []:
        rk = v.get("rank", 0)
        t = v.get("t")
        ts = (t - origin) * 1e6 if isinstance(t, (int, float)) else 0.0
        events.append({
            "name": "watchdog.verdict",
            "ph": "i",
            "s": "g",  # global scope: a verdict indicts the whole run
            "ts": max(ts, 0.0),
            "pid": rk,
            "args": {
                k: val for k, val in v.items()
                if k in ("rank", "step", "median_step", "stalled_for_s",
                         "last_phase", "last_phase_name")
            },
        })
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    other: dict = {"source": "rocm_mpi_tpu.telemetry"}
    if warnings:
        other["warnings"] = warnings
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_chrome_trace(streams: dict[int, list[dict]], path,
                       heartbeats: dict[int, dict] | None = None,
                       verdicts: list[dict] | None = None) -> dict:
    """Export `streams` as trace-event JSON at `path`; returns the doc."""
    from rocm_mpi_tpu_torch.telemetry.aggregate import write_json_atomic

    doc = to_chrome_trace(streams, heartbeats=heartbeats, verdicts=verdicts)
    write_json_atomic(pathlib.Path(path), doc, indent=None)
    return doc
