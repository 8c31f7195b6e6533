"""Request-scoped distributed tracing — counterpart of
rocm_mpi_tpu/telemetry/tracing.py (docs/TELEMETRY.md "Request tracing"):
causal timelines for a request's whole life across the fleet. The
read side and the validators read both packages' streams; the write
side (`TraceContext`, `mint`, `child`, `next_hop`, `to_wire`,
`from_wire`, `emit_tspan`) serves the port's serving layer and writes
the JAX package's records.

A request's path in the fleet era is router -> replica queue -> bin ->
batched drain -> (segment swaps) -> terminal, and may re-route to a
second replica when its first one dies mid-batch. Spans see
phases and the health plane sees ranks, but neither connects one
request's transitions causally. This module does, with three pieces:

* A `TraceContext` — trace_id (ALWAYS the request_id: one request is
  one trace, no id mapping layer), a per-process minted span_id, the
  parent span_id, and a hop counter (0 = first route; +1 per re-route
  after a replica kill). Contexts ride `serving.queue.Request.trace` as
  a plain dict (the v3 request schema's optional field) so they survive
  the wire and the journal untouched.

* A new `tspan`-kind record on the existing v2 JSONL streams
  (`emit_tspan`): trace.submit / trace.route / trace.batch /
  trace.segment, each stamped with the context. Batch records carry a
  `members` roster ({trace_id, lane}), so per-request device spans are
  DERIVED from batch spans plus lane occupancy — the stream stays
  O(batches), not O(requests x stages). Swapped-in lanes appear
  in the `trace.segment` record of the boundary they joined at.

* A per-process wall<->monotonic clock anchor (`anchor`-kind record,
  emitted once per sink by `events.configure()`): the record's own
  header stamps `t` (wall) and `t_mono` (monotonic) back to back, and
  that pair IS the anchor — the fleet merger maps any record's t_mono
  into comparable wall time via `anchor_t + (t_mono - anchor_t_mono)`.
  Streams without an anchor (legacy, or env-configured ranks that never
  called configure()) fall back to per-record wall stamps and are
  WARNED about, never silently misaligned (telemetry/trace.py).

Latency decomposition: the serving layer attributes every terminal
ticket's life to the stages in `DECOMP_STAGES` by telescoping marks
(`serving.queue.Ticket.trace_mark`) — each transition charges the time
since the previous mark to one stage, so the stages sum EXACTLY to the
done-event latency by construction. The per-request block rides the
`serve.request.done` event (`decomp`, `hop`) and aggregates into the
SLO reports (serving/slo.py).

stdlib-only end to end, like the whole telemetry read side: the `trace`
CLI verb must run on a box with no torch at all.
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import time

# Record kinds this module owns on the v2 streams.
TRACE_KIND = "tspan"
ANCHOR_KIND = "anchor"
ANCHOR_NAME = "clock.anchor"

TRACE_REPORT_SCHEMA = "rmt-trace-report"
TRACE_REPORT_VERSION = 1

# The latency-decomposition stages, in causal order (docs/TELEMETRY.md
# "Request tracing" documents each boundary). Pinned by tests — the SLO
# aggregation, the report validator, and the serving marks must agree.
DECOMP_STAGES = (
    "queue_wait",  # submit -> popped into a drain (minus backoff)
    "backoff",     # retry-parked and ineligible (not_before in force)
    "compile",     # program-class acquisition for the request's batch
    "device",      # dispatched: assembly/upload through device compute
    "swap_wait",   # continuous drain: waiting for a free lane/seat
    "fetch",       # the blocking device->host fetch of its batch
    "resolve",     # per-lane resolution (finiteness, saving the lane state)
)

_SPAN_COUNTER = itertools.count(1)


class TraceContext:
    """One request's position in its trace (module docstring). Treated
    as immutable — transitions mint new contexts (`child`, `next_hop`)
    so a journaled wire dict never mutates under its reader."""

    __slots__ = ("trace_id", "span_id", "parent_id", "hop")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str | None = None, hop: int = 0):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = parent_id if parent_id is None else str(parent_id)
        self.hop = int(hop)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent={self.parent_id!r}, hop={self.hop})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and to_wire(self) == to_wire(other))


def _next_span_id() -> str:
    """Process-unique span id: rank-prefixed so two replicas' spans of
    one trace never collide even when minted at the same count."""
    from rocm_mpi_tpu_torch.telemetry import events

    return f"s{events.rank()}.{next(_SPAN_COUNTER)}"


def mint(trace_id: str) -> TraceContext:
    """Root context for a request entering the system (hop 0)."""
    return TraceContext(trace_id, _next_span_id())


def child(ctx: TraceContext) -> TraceContext:
    """A new span under `ctx`, same hop (a stage within one replica)."""
    return TraceContext(ctx.trace_id, _next_span_id(),
                        parent_id=ctx.span_id, hop=ctx.hop)


def next_hop(ctx: TraceContext) -> TraceContext:
    """The failover transition: a re-route after a replica kill is a
    new hop — new span, parent = the dead hop's span, hop + 1."""
    return TraceContext(ctx.trace_id, _next_span_id(),
                        parent_id=ctx.span_id, hop=ctx.hop + 1)


def to_wire(ctx: TraceContext | None) -> dict | None:
    """The context as the plain dict that rides Request.trace (v3)."""
    if ctx is None:
        return None
    doc = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
           "hop": ctx.hop}
    if ctx.parent_id is not None:
        doc["parent_id"] = ctx.parent_id
    return doc


def from_wire(doc) -> TraceContext | None:
    """Parse a wire dict back into a context; None on anything that is
    not one (tolerant: a legacy v2 request simply has no trace)."""
    if not isinstance(doc, dict):
        return None
    tid = doc.get("trace_id")
    sid = doc.get("span_id")
    if not isinstance(tid, str) or not isinstance(sid, str):
        return None
    pid = doc.get("parent_id")
    hop = doc.get("hop", 0)
    return TraceContext(
        tid, sid,
        parent_id=pid if isinstance(pid, str) else None,
        hop=hop if isinstance(hop, int) and not isinstance(hop, bool)
        else 0,
    )


def validate_wire(doc) -> list[str]:
    """Problem strings for a Request.trace wire dict (the v3 request
    record validator defers here)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"trace {doc!r} is not an object"]
    for key in ("trace_id", "span_id"):
        if not isinstance(doc.get(key), str) or not doc.get(key):
            problems.append(f"trace.{key} {doc.get(key)!r} not a string")
    hop = doc.get("hop")
    if not isinstance(hop, int) or isinstance(hop, bool) or hop < 0:
        problems.append(f"trace.hop {hop!r} not a non-negative int")
    pid = doc.get("parent_id")
    if pid is not None and not isinstance(pid, str):
        problems.append(f"trace.parent_id {pid!r} not a string")
    return problems


# ---------------------------------------------------------------------------
# read side: anchors, timelines, the trace report
# ---------------------------------------------------------------------------


def emit_tspan(name: str, ctx: TraceContext | None, **fields):
    """One tspan record under `ctx` on this rank's stream. The hot-path
    guard is the same one every span pays (`events.enabled()`); with no
    context (tracing disabled at the serving layer) it is a no-op."""
    from rocm_mpi_tpu_torch.telemetry import events

    if ctx is None or not events.enabled():
        return None
    return events.emit(
        TRACE_KIND, name,
        trace_id=ctx.trace_id, span_id=ctx.span_id,
        parent_id=ctx.parent_id, hop=ctx.hop, **fields,
    )


def anchor_of(records) -> tuple[float, float] | None:
    """The stream's (t_wall, t_mono) clock anchor, or None (legacy)."""
    for rec in records:
        if rec.get("kind") != ANCHOR_KIND:
            continue
        t, tm = rec.get("t"), rec.get("t_mono")
        if isinstance(t, (int, float)) and isinstance(tm, (int, float)):
            return (float(t), float(tm))
    return None


def aligned_wall(rec: dict, anchor: tuple[float, float] | None):
    """A record's wall time on the fleet-comparable clock: anchored
    streams map the record's monotonic stamp through the anchor (tear-
    free within the rank, comparable across replicas); anchor-less
    streams fall back to the record's own wall stamp."""
    tm = rec.get("t_mono")
    if anchor is not None and isinstance(tm, (int, float)):
        return anchor[0] + (float(tm) - anchor[1])
    t = rec.get("t")
    return float(t) if isinstance(t, (int, float)) else None


def _mentions(rec: dict, request_id: str) -> bool:
    """Does this record belong to `request_id`'s trace? Direct stamps
    (trace_id on tspans, request_id on serve events) or roster
    membership (batch/segment records carry {trace_id, lane} rows)."""
    if rec.get("trace_id") == request_id \
            or rec.get("request_id") == request_id:
        return True
    for row in rec.get("members") or ():
        if isinstance(row, dict) and row.get("trace_id") == request_id:
            return True
    return False


# Terminal serve events, keyed by the event name's outcome suffix.
_TERMINAL_EVENTS = {
    "serve.request.done": "done",
    "serve.request.quarantined": "quarantined",
    "serve.request.rejected": "rejected",
    "serve.request.expired": "expired",
}


def request_timeline(streams: dict[int, list[dict]],
                     request_id: str) -> dict | None:
    """The causal timeline of one request across every rank stream:
    its tspan records, its serve.* events, and the batch/segment
    records whose roster names it — sorted on the anchor-aligned wall
    clock. Returns None when no stream mentions the request."""
    rows: list[dict] = []
    warnings: list[str] = []
    terminal = None
    decomp = None
    latency = None
    hops: set[int] = set()
    for rk in sorted(streams):
        recs = streams[rk]
        anchor = anchor_of(recs)
        if anchor is None and recs:
            warnings.append(
                f"rank {rk}: no clock anchor (legacy stream) — its "
                "events use per-record wall stamps and may misalign "
                "against anchored ranks"
            )
        for rec in recs:
            if rec.get("kind") not in (TRACE_KIND, "event"):
                continue
            if not _mentions(rec, request_id):
                continue
            wall = aligned_wall(rec, anchor)
            if wall is None:
                continue
            name = rec.get("name", "?")
            hop = rec.get("hop")
            if isinstance(hop, int) and not isinstance(hop, bool):
                hops.add(hop)
            row = {"t": wall, "rank": rk, "kind": rec.get("kind"),
                   "name": name}
            for key in ("span_id", "parent_id", "hop", "seq", "seg",
                        "bin", "width", "lane", "replica", "reroute",
                        "error", "state", "latency_s", "retries"):
                if rec.get(key) is not None:
                    row[key] = rec[key]
            rows.append(row)
            if name in _TERMINAL_EVENTS:
                terminal = _TERMINAL_EVENTS[name]
            if name == "serve.request.done":
                if isinstance(rec.get("latency_s"), (int, float)):
                    latency = float(rec["latency_s"])
                if isinstance(rec.get("decomp"), dict):
                    decomp = dict(rec["decomp"])
    if not rows:
        return None
    rows.sort(key=lambda r: r["t"])
    return {
        "request_id": request_id,
        "hops": sorted(hops),
        "terminal": terminal,
        "latency_s": latency,
        "decomposition": decomp,
        "events": rows,
        "warnings": warnings,
    }


def trace_report_doc(timeline: dict) -> dict:
    """The schema-versioned trace report (`rmt-trace-report` v1) for
    one request — the artifact `telemetry trace --out` banks and
    `regress --check-schema` gates."""
    return {
        "schema": TRACE_REPORT_SCHEMA,
        "v": TRACE_REPORT_VERSION,
        # Record wall STAMP (the header convention) — not an interval.
        "t": time.time(),
        **{k: timeline.get(k) for k in (
            "request_id", "hops", "terminal", "latency_s",
            "decomposition", "events", "warnings",
        )},
    }


def validate_trace_report(doc: dict) -> list[str]:
    """Problem strings for a trace-report document (stdlib; shared with
    `telemetry regress --check-schema`)."""
    problems: list[str] = []
    if doc.get("schema") != TRACE_REPORT_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {TRACE_REPORT_SCHEMA}"
        )
    if not isinstance(doc.get("v"), int):
        problems.append("missing int v")
    if not isinstance(doc.get("request_id"), str) \
            or not doc.get("request_id"):
        problems.append("missing request_id")
    hops = doc.get("hops")
    if not isinstance(hops, list) or not all(
        isinstance(h, int) and not isinstance(h, bool) for h in hops
    ):
        problems.append("hops is not a list of ints")
    evs = doc.get("events")
    if not isinstance(evs, list) or not evs:
        problems.append("missing non-empty events list")
    else:
        for i, ev in enumerate(evs):
            if not isinstance(ev, dict) \
                    or not isinstance(ev.get("name"), str) \
                    or not isinstance(ev.get("t"), (int, float)):
                problems.append(f"events[{i}] missing name/t")
    problems += validate_decomposition(doc.get("decomposition"))
    return problems


def validate_decomposition(decomp) -> list[str]:
    """Problem strings for a per-request decomposition dict (None is
    fine: a non-terminal or tracing-off request has none). Stage keys
    must come from DECOMP_STAGES and values must be non-negative
    seconds — the telescoping-marks contract."""
    if decomp is None:
        return []
    if not isinstance(decomp, dict):
        return [f"decomposition {decomp!r} is not an object"]
    problems = []
    for stage, v in decomp.items():
        if stage not in DECOMP_STAGES:
            problems.append(
                f"decomposition stage {stage!r} unknown "
                f"(known: {list(DECOMP_STAGES)})"
            )
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or v < 0:
            problems.append(
                f"decomposition.{stage} {v!r} not a non-negative time"
            )
    return problems


def write_trace_report(path, doc: dict) -> None:
    """Atomic tmp+rename write, validated first."""
    problems = validate_trace_report(doc)
    if problems:
        raise ValueError("bad trace report: " + "; ".join(problems))
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def format_timeline(timeline: dict) -> str:
    """The human causal timeline: one line per event, indented by hop,
    timed relative to the request's first observation."""
    rows = timeline["events"]
    t0 = rows[0]["t"] if rows else 0.0
    lines = [
        f"trace {timeline['request_id']}: "
        f"{len(rows)} event(s), hops {timeline['hops'] or [0]}, "
        f"terminal={timeline['terminal'] or '(none)'}"
    ]
    for w in timeline.get("warnings") or ():
        lines.append(f"  warning: {w}")
    for row in rows:
        hop = row.get("hop")
        indent = "  " * (1 + (hop if isinstance(hop, int) else 0))
        extra = []
        for key in ("replica", "seq", "seg", "bin", "width", "lane",
                    "state", "retries", "error"):
            if row.get(key) is not None:
                extra.append(f"{key}={row[key]}")
        if row.get("reroute"):
            extra.append("REROUTE")
        lines.append(
            f"{indent}+{row['t'] - t0:9.4f}s r{row['rank']} "
            f"{row['name']}" + (f"  [{', '.join(extra)}]" if extra else "")
        )
    decomp = timeline.get("decomposition")
    if decomp:
        total = sum(decomp.values())
        lines.append(f"  decomposition (sum {total:.4f}s"
                     + (f", done latency {timeline['latency_s']:.4f}s"
                        if timeline.get("latency_s") is not None else "")
                     + "):")
        for stage in DECOMP_STAGES:
            if stage in decomp:
                lines.append(f"    {stage:<10} {decomp[stage]:9.4f}s")
    return "\n".join(lines)


def to_request_chrome(timeline: dict) -> dict:
    """A Chrome-trace document for ONE request: a track (pid) per hop,
    instants for every causal event, and — when the request terminated
    with a decomposition — the stage ladder as slices on its terminal
    hop, chained back from the done stamp (the stages telescope, so
    end-to-end they tile the measured latency exactly)."""
    rows = timeline["events"]
    t0 = rows[0]["t"] if rows else 0.0
    events_out: list[dict] = []
    hops = timeline["hops"] or [0]
    for hop in hops:
        events_out.append({
            "name": "process_name", "ph": "M", "pid": hop, "ts": 0,
            "args": {"name": f"hop {hop}"},
        })
    for row in rows:
        hop = row.get("hop") if isinstance(row.get("hop"), int) else 0
        events_out.append({
            "name": row["name"], "ph": "i", "s": "p",
            "ts": (row["t"] - t0) * 1e6, "pid": hop, "tid": 0,
            "args": {k: v for k, v in row.items()
                     if k not in ("t", "name", "kind")},
        })
    decomp = timeline.get("decomposition")
    done_t = None
    for row in rows:
        if row["name"] == "serve.request.done":
            done_t = row["t"]
    if decomp and done_t is not None:
        hop = max(hops)
        end = done_t
        for stage in reversed(DECOMP_STAGES):
            dur = float(decomp.get(stage, 0.0))
            if dur <= 0:
                continue
            events_out.append({
                "name": stage, "ph": "X",
                "ts": (end - dur - t0) * 1e6, "dur": dur * 1e6,
                "pid": hop, "tid": 1, "args": {"stage": stage},
            })
            end -= dur
    events_out.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return {
        "traceEvents": events_out,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "rocm_mpi_tpu.telemetry.tracing",
            "request_id": timeline["request_id"],
        },
    }


def write_request_chrome(timeline: dict, path) -> dict:
    """Export the per-request per-hop Chrome trace at `path`."""
    from rocm_mpi_tpu_torch.telemetry.aggregate import write_json_atomic

    doc = to_request_chrome(timeline)
    write_json_atomic(pathlib.Path(path), doc, indent=None)
    return doc
