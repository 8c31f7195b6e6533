"""SLO accounting and the soak report (docs/RESILIENCE.md §8 "The
(The port's copy of rocm_mpi_tpu/serving/slo.py: the same records, byte
for byte, and no import of the JAX package.)
soak"; docs/SERVING.md "SLOs and admission").

Stdlib-at-import like the rest of the serving read side: `telemetry
regress --check-schema` validates archived `soak-report.json` artifacts
through `validate_soak_report` without importing torch, and the SLO
aggregation reads the per-rank telemetry JSONL streams directly (the
`serve.request.done` events carry `latency_s`/`deadline_miss` per
request — the report's latency percentiles come from REAL telemetry,
never from numbers the soak app made up).

The report is written tmp+rename (`write_soak_report`) — it is the one
artifact a multi-hour soak leaves behind, and a torn report after a
mid-soak flap would be worse than none (GL09's whole argument).
"""

from __future__ import annotations

import json
import os
import pathlib
import time

SOAK_SCHEMA = "rmt-soak-report"
SOAK_VERSION = 1

# The terminal outcomes the SLO block accounts (serving/queue.py
# TERMINAL_STATES, spelled flat for the stdlib read side; pinned
# against the queue module by tests/test_soak.py).
SLO_COUNT_FIELDS = (
    "submitted", "done", "failed", "rejected", "expired", "quarantined",
    "retries",
)


def percentile(values, q: float) -> float | None:
    """Interpolating percentile (the telemetry.aggregate convention);
    None on no data. `q` in [0, 100]."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1 - frac) + vals[hi] * frac


def latencies_from_streams(paths) -> dict:
    """Harvest per-request latency/deadline facts from telemetry rank
    streams: every `serve.request.done` event's `latency_s` and
    `deadline_miss`, deduped by request id (in a multi-controller
    service every rank emits the same event — one request is one
    observation, not one per rank). Done events that carry a
    per-request latency decomposition (`decomp`, `hop` — the PR-20
    request-tracing fields) are harvested alongside, same dedup. Torn
    lines are skipped (live JSONL streams)."""
    lat: dict[str, float] = {}
    misses: set[str] = set()
    decomps: dict[str, dict] = {}
    hops: dict[str, int] = {}
    for raw in paths:
        path = pathlib.Path(raw)
        if not path.is_file():
            continue
        try:
            text = path.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue  # torn tail
            if doc.get("kind") != "event" \
                    or doc.get("name") != "serve.request.done":
                continue
            rid = doc.get("request_id")
            v = doc.get("latency_s")
            if not isinstance(rid, str) \
                    or not isinstance(v, (int, float)):
                continue
            lat.setdefault(rid, float(v))
            if doc.get("deadline_miss"):
                misses.add(rid)
            if isinstance(doc.get("decomp"), dict):
                decomps.setdefault(rid, dict(doc["decomp"]))
            hop = doc.get("hop")
            if isinstance(hop, int) and not isinstance(hop, bool):
                hops.setdefault(rid, hop)
    return {
        "latencies": lat,
        "deadline_missed_done": sorted(misses),
        "decomps": decomps,
        "hops": hops,
    }


def slo_block(counters: dict, stream_paths) -> dict:
    """The report's SLO block: terminal accounting totals (summed
    serve-queue counters) + latency percentiles and the deadline-miss
    rate from the telemetry streams. A deadline miss is a request that
    either EXPIRED pending or completed past its deadline (in-flight
    lanes always finish their batch — finishing late still missed)."""
    facts = latencies_from_streams(stream_paths)
    lats = list(facts["latencies"].values())
    late_done = len(facts["deadline_missed_done"])
    submitted = int(counters.get("submitted", 0))
    expired = int(counters.get("expired", 0))
    misses = expired + late_done
    decomp_block = decomposition_block(
        facts.get("decomps") or {}, facts.get("hops") or {}
    )
    out = {
        "submitted": submitted,
        "done": int(counters.get("completed", 0)),
        "failed": int(counters.get("failed", 0)),
        "rejected": int(counters.get("rejected", 0)),
        "expired": expired,
        "quarantined": int(counters.get("quarantined", 0)),
        "retries": int(counters.get("retries", 0)),
        "latency_s": {
            "n": len(lats),
            "p50": percentile(lats, 50),
            "p99": percentile(lats, 99),
        },
        "deadline_misses": misses,
        "deadline_miss_rate": (
            round(misses / submitted, 6) if submitted else 0.0
        ),
    }
    if decomp_block is not None:
        out["decomposition"] = decomp_block
    return out


def decomposition_block(decomps: dict, hops: dict) -> dict | None:
    """The tail-latency decomposition aggregate: per-stage mean/p50/p99
    across every done request that banked a decomposition, plus the
    hop summary (how many requests re-routed across replicas). None
    when no request carried one (tracing off, or a legacy stream) —
    the soak-report schema treats the block as optional for exactly
    that reason."""
    from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

    if not decomps:
        return None
    stages: dict[str, dict] = {}
    for stage in _tracing.DECOMP_STAGES:
        vals = [
            float(d[stage]) for d in decomps.values()
            if isinstance(d.get(stage), (int, float))
        ]
        if not vals:
            continue
        stages[stage] = {
            "n": len(vals),
            "mean": round(sum(vals) / len(vals), 6),
            "p50": round(percentile(vals, 50), 6),
            "p99": round(percentile(vals, 99), 6),
        }
    hop_vals = list(hops.values())
    return {
        "n": len(decomps),
        "stages": stages,
        "hops": {
            "max": max(hop_vals) if hop_vals else 0,
            "rerouted": sum(1 for h in hop_vals if h > 0),
        },
    }


def soak_report_doc(episodes, slo: dict, *, bounded: bool,
                    accounting_ok: bool, fault_kinds=()) -> dict:
    """The schema-versioned soak report (docs/RESILIENCE.md §8):
    one row per episode of the rolling fault schedule, the aggregated
    SLO block, and the accounting verdict."""
    return {
        "schema": SOAK_SCHEMA,
        "v": SOAK_VERSION,
        # Record wall STAMP (the `t` field every telemetry record
        # carries), not an interval measurement — nothing to sync.
        # graftlint: disable-next=GL06
        "t": time.time(),
        "bounded": bool(bounded),
        "fault_kinds": sorted(set(fault_kinds)),
        "episodes": list(episodes),
        "slo": dict(slo),
        "accounting_ok": bool(accounting_ok),
    }


def validate_soak_report(doc: dict) -> list[str]:
    """Problem strings for a soak-report.json document (stdlib; shared
    with telemetry.regress --check-schema). The SLO block must be
    POPULATED — a soak that banked no latency observations proves
    nothing (the acceptance bar: real telemetry, not a shell)."""
    problems: list[str] = []
    if doc.get("schema") != SOAK_SCHEMA:
        problems.append(f"schema {doc.get('schema')!r} != {SOAK_SCHEMA}")
    if not isinstance(doc.get("v"), int):
        problems.append("missing int v")
    if not isinstance(doc.get("bounded"), bool):
        problems.append("missing bool bounded")
    if not isinstance(doc.get("accounting_ok"), bool):
        problems.append("missing bool accounting_ok")
    eps = doc.get("episodes")
    if not isinstance(eps, list) or not eps:
        problems.append("missing non-empty episodes list")
    else:
        for i, ep in enumerate(eps):
            if not isinstance(ep, dict):
                problems.append(f"episodes[{i}] not an object")
                continue
            if not isinstance(ep.get("name"), str) or not ep.get("name"):
                problems.append(f"episodes[{i}] missing name")
            if not isinstance(ep.get("ok"), bool):
                problems.append(f"episodes[{i}] missing bool ok")
    slo = doc.get("slo")
    if not isinstance(slo, dict):
        return problems + ["missing slo block"]
    for field in SLO_COUNT_FIELDS:
        v = slo.get(field)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            problems.append(f"slo.{field} {v!r} is not a count")
    lat = slo.get("latency_s")
    if not isinstance(lat, dict) or not isinstance(lat.get("n"), int):
        problems.append("slo.latency_s missing its n")
    else:
        if lat["n"] < 1:
            problems.append(
                "slo.latency_s.n == 0: the SLO block must be populated "
                "from real telemetry (no latency observations banked)"
            )
        for q in ("p50", "p99"):
            v = lat.get(q)
            if lat["n"] >= 1 and (
                not isinstance(v, (int, float)) or isinstance(v, bool)
                or v < 0
            ):
                problems.append(f"slo.latency_s.{q} {v!r} not a latency")
    rate = slo.get("deadline_miss_rate")
    if not isinstance(rate, (int, float)) or isinstance(rate, bool) \
            or not 0.0 <= rate <= 1.0:
        problems.append(
            f"slo.deadline_miss_rate {rate!r} outside [0, 1]"
        )
    problems += validate_decomposition_block(slo.get("decomposition"))
    return problems


def validate_decomposition_block(block) -> list[str]:
    """Problem strings for an slo.decomposition aggregate (None is
    fine — the block is optional: tracing off or legacy streams)."""
    from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

    if block is None:
        return []
    if not isinstance(block, dict):
        return [f"slo.decomposition {block!r} is not an object"]
    problems: list[str] = []
    n = block.get("n")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        problems.append(
            "slo.decomposition.n must be a positive count (an empty "
            "block should be absent, not empty)"
        )
    stages = block.get("stages")
    if not isinstance(stages, dict):
        problems.append("slo.decomposition.stages missing")
    else:
        for stage, row in stages.items():
            if stage not in _tracing.DECOMP_STAGES:
                problems.append(
                    f"slo.decomposition stage {stage!r} unknown "
                    f"(known: {list(_tracing.DECOMP_STAGES)})"
                )
            if not isinstance(row, dict):
                problems.append(
                    f"slo.decomposition.stages.{stage} not an object"
                )
                continue
            for q in ("mean", "p50", "p99"):
                v = row.get(q)
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool) or v < 0:
                    problems.append(
                        f"slo.decomposition.{stage}.{q} {v!r} not a "
                        "non-negative time"
                    )
    hops = block.get("hops")
    if not isinstance(hops, dict) or not isinstance(
        hops.get("max"), int
    ) or not isinstance(hops.get("rerouted"), int):
        problems.append("slo.decomposition.hops missing max/rerouted")
    return problems


def write_soak_report(path, doc: dict) -> None:
    """Atomic tmp+rename write (GL09 discipline: the soak report is a
    schema-versioned artifact an out-of-process reader — chip_watcher's
    archive step, the next triage — may pick up while the soak is still
    finishing)."""
    problems = validate_soak_report(doc)
    if problems:
        raise ValueError("bad soak report: " + "; ".join(problems))
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
