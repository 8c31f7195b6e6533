"""Perf-regression gate: compare a run summary against a committed baseline
— counterpart of rocm_mpi_tpu/telemetry/regress.py (`compare`,
`extract_metrics` and `check_schema` give its results on the same
documents).

Committed measurement files (BASELINE.json, MULTICHIP_r0*.json,
docs/*_mechanics_*.jsonl) need a machine that re-reads them, or a
regression is whatever a human happens to notice. This module closes the
loop:

    python -m rocm_mpi_tpu_torch.telemetry regress SUMMARY --baseline BASE
        exit 0  within tolerance (or better)
        exit 1  regression: a metric moved the WRONG way by > tolerance
        exit 2  missing/unreadable baseline or summary (never silently
                passes — an absent baseline is a broken gate, not a green
                one)

Comparable metrics are extracted from the summary schema
(aggregate.SUMMARY_SCHEMA) with an explicit direction each:

    lower is better    steps.per_step_us.{mean,p50,p90,p99},
                       phases.{halo,interior,checkpoint}.wall_s,
                       gauges.compiles.* (compile/recompile counts —
                       included even at 0: "zero recompiles after
                       warmup" is a real measurement, and a zero
                       baseline makes ANY steady-state recompile a
                       gated regression)
    higher is better   phases.halo.bytes_per_s, every other numeric
                       gauge (gauges are rates: gpts, t_eff — the
                       driver metric)

A baseline may be (a) a summary from a previous run — the normal flow:
bank today's summary, gate tomorrow's run against it — or (b) a hand-flat
``{"metrics": {name: {"value": v, "direction": "lower"|"higher"}}}``
file for curated budgets. Improvements never fail the gate; only
directional regressions beyond `tolerance` (default 20% — CPU-mechanics
runs jitter; chip baselines can gate tighter) do.

``--check-schema`` mode validates that committed measurement artifacts
still parse and look like a format this repo knows (summary, BASELINE,
MULTICHIP probe, mechanics/telemetry JSONL) — the cheap CI guard
against a hand-edit quietly bricking the gate's inputs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

DEFAULT_TOLERANCE = 0.20

LOWER, HIGHER = "lower", "higher"


@dataclasses.dataclass(frozen=True)
class Delta:
    """One compared metric; `regressed` when it moved the wrong way by
    more than the tolerance."""

    name: str
    direction: str
    baseline: float
    current: float
    change: float  # signed relative change, + = current larger
    regressed: bool

    def describe(self) -> str:
        verdict = "REGRESSED" if self.regressed else "ok"
        return (
            f"{self.name} [{self.direction} is better]: "
            f"{self.baseline:g} -> {self.current:g} "
            f"({self.change:+.1%}) {verdict}"
        )


def extract_metrics(doc: dict) -> dict[str, tuple[float, str]]:
    """{metric name: (value, direction)} from a summary or a flat
    metrics file. Zero-valued summary entries are skipped: an unobserved
    phase is absence of evidence, not a 0-second budget."""
    out: dict[str, tuple[float, str]] = {}
    if "metrics" in doc and isinstance(doc["metrics"], dict):
        for name, spec in doc["metrics"].items():
            if isinstance(spec, dict) and "value" in spec:
                direction = spec.get("direction", LOWER)
                if direction in (LOWER, HIGHER):
                    try:
                        out[name] = (float(spec["value"]), direction)
                    except (TypeError, ValueError):
                        pass
        return out

    steps = doc.get("steps", {})
    for q, v in (steps.get("per_step_us") or {}).items():
        if isinstance(v, (int, float)) and v > 0:
            out[f"steps.per_step_us.{q}"] = (float(v), LOWER)
    for ph, row in (doc.get("phases") or {}).items():
        wall = row.get("wall_s")
        if isinstance(wall, (int, float)) and wall > 0:
            out[f"phases.{ph}.wall_s"] = (float(wall), LOWER)
        bps = row.get("bytes_per_s")
        if ph == "halo" and isinstance(bps, (int, float)) and bps > 0:
            out["phases.halo.bytes_per_s"] = (float(bps), HIGHER)
    for name, v in (doc.get("gauges") or {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if name.startswith("compiles.") or name == "serve.device_bubble":
            # Compile counts AND the serving pipeline's device-bubble
            # fraction: fewer/less is better and ZERO is evidence (the
            # steady-state / fully-overlapped contracts), unlike the
            # rate gauges where an absent/zero value means "not
            # measured".
            out[f"gauges.{name}"] = (float(v), LOWER)
        elif name.startswith("serve.pipeline_"):
            # Config echoes (serve.pipeline_depth): recorded for the
            # summary reader, but a depth change is a deliberate knob,
            # not a directional health metric — never regress-gated.
            continue
        elif v > 0:
            out[f"gauges.{name}"] = (float(v), HIGHER)
    return out


def compare(summary: dict, baseline: dict,
            tolerance: float = DEFAULT_TOLERANCE) -> list[Delta]:
    """Compare every metric present in BOTH documents. The baseline's
    direction wins on disagreement (the committed gate is authoritative)."""
    if tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    cur = extract_metrics(summary)
    base = extract_metrics(baseline)
    deltas: list[Delta] = []
    for name in sorted(set(cur) & set(base)):
        b_val, direction = base[name]
        c_val, _ = cur[name]
        if b_val == 0:
            if direction == HIGHER:
                continue  # no meaningful relative change off a 0 rate
            # A lower-is-better zero baseline is a hard pin (the
            # compiles.steady_state == 0 contract): any rise regresses.
            change = float("inf") if c_val > 0 else 0.0
            worse = c_val > 0
            deltas.append(Delta(
                name=name, direction=direction, baseline=b_val,
                current=c_val, change=change, regressed=worse,
            ))
            continue
        change = (c_val - b_val) / abs(b_val)
        worse = change > tolerance if direction == LOWER \
            else change < -tolerance
        deltas.append(Delta(
            name=name, direction=direction, baseline=b_val,
            current=c_val, change=change, regressed=worse,
        ))
    return deltas


def regressions(deltas: list[Delta]) -> list[Delta]:
    return [d for d in deltas if d.regressed]


def load_json(path) -> dict | None:
    """Parse a JSON file; None on any failure (callers turn that into
    exit 2 — a gate input that cannot be read must fail loudly)."""
    try:
        doc = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# ---------------------------------------------------------------------------
# --check-schema: recognize the repo's committed measurement formats
# ---------------------------------------------------------------------------


# Schema markers of the families the JAX package's analysis and serving
# planes write, spelled here so the port classifies every family the JAX
# read side classifies (tests/test_torch_telemetry.py pins them equal to
# the JAX package's constants). The serving bin manifest, the soak report
# and the fleet report are deep-checked by the port's serving validators
# (serving/bins.py, serving/slo.py, serving/journal.py); graftlint is not
# ported: its families are recognized but not deep-checked
# (DEEP_CHECKED_ELSEWHERE).
_FINDINGS_SCHEMA = "rmt-lint-findings"
_LINT_BASELINE_SCHEMA = "rmt-lint-baseline"
_BIN_MANIFEST_SCHEMA = "rmt-bin-manifest"
_SOAK_SCHEMA = "rmt-soak-report"
_FLEET_REPORT_SCHEMA = "rmt-fleet-report"

# Families whose deep validators live in a plane the port has not ported
# (graftlint): check_schema names them in its notes instead of passing
# them in silence.
DEEP_CHECKED_ELSEWHERE = ("graftlint findings artifact", "graftlint baseline")


def _classify_json(doc: dict) -> str | None:
    from rocm_mpi_tpu_torch.telemetry.aggregate import SUMMARY_SCHEMA
    from rocm_mpi_tpu_torch.telemetry.flight import (
        BUNDLE_SCHEMA,
        HEARTBEAT_SCHEMA,
        POSTMORTEM_SCHEMA,
    )
    from rocm_mpi_tpu_torch.telemetry.tracing import TRACE_REPORT_SCHEMA

    named = {
        SUMMARY_SCHEMA: "telemetry summary",
        HEARTBEAT_SCHEMA: "health heartbeat sidecar",
        POSTMORTEM_SCHEMA: "health post-mortem",
        BUNDLE_SCHEMA: "health post-mortem bundle",
        _FINDINGS_SCHEMA: "graftlint findings artifact",
        _LINT_BASELINE_SCHEMA: "graftlint baseline",
        _BIN_MANIFEST_SCHEMA: "serving bin manifest",
        _SOAK_SCHEMA: "soak report",
        _FLEET_REPORT_SCHEMA: "fleet report",
        TRACE_REPORT_SCHEMA: "trace report",
    }
    if doc.get("schema") in named:
        return named[doc["schema"]]
    if "step" in doc and "leaves" in doc and "files" in doc:
        return "checkpoint manifest"
    if "budgets" in doc and isinstance(doc.get("budgets"), dict) \
            and "v" in doc:
        return "perf budgets"
    if "metrics" in doc and isinstance(doc["metrics"], dict):
        return "flat metrics baseline"
    if "metric" in doc and "north_star" in doc:
        return "BASELINE.json north-star record"
    if "n_devices" in doc and "rc" in doc:
        return "multichip probe record"
    if "metric" in doc:
        return "bench/mechanics row"
    return None


def _validate_classified(doc: dict, kind: str) -> list[str]:
    """Deep checks for families with committed inner structure. The
    checkpoint-manifest topology metadata is the load-bearing one: a
    drifted or hand-edited meta block would brick every resume that reads
    it (utils.checkpoint.validate_manifest_meta, shared here). The
    DEEP_CHECKED_ELSEWHERE families get none here (see check_schema's
    notes)."""
    if kind == "checkpoint manifest":
        from rocm_mpi_tpu_torch.utils.checkpoint import validate_manifest_meta

        return [f"manifest {p}" for p in validate_manifest_meta(doc)]
    if kind == "perf budgets":
        return _validate_perf_budgets(doc)
    if kind == "serving bin manifest":
        from rocm_mpi_tpu_torch.serving.bins import validate_manifest_doc

        return validate_manifest_doc(doc)
    if kind == "soak report":
        from rocm_mpi_tpu_torch.serving.slo import validate_soak_report

        return validate_soak_report(doc)
    if kind == "fleet report":
        from rocm_mpi_tpu_torch.serving.journal import validate_fleet_report

        return validate_fleet_report(doc)
    if kind == "trace report":
        from rocm_mpi_tpu_torch.telemetry.tracing import validate_trace_report

        return validate_trace_report(doc)
    return []


# The wire-mode registry, spelled here so the telemetry read side stays
# importable without torch (parallel.wire imports it).
# tests/test_torch_telemetry.py pins this tuple equal to
# parallel.wire.WIRE_MODES — drift fails loudly.
_WIRE_MODES = ("f32", "bf16", "int8", "int8_delta")

# Serving sidecar record markers: the request and quarantine records are
# deep-checked by serving/queue.py's validators, the fleet journal's by
# serving/journal.py's (tests/test_torch_fleet.py pins this spelling).
_SERVE_REQUEST_SCHEMA = "rmt-serve-request"
_QUARANTINE_SCHEMA = "rmt-serve-quarantine"
_FLEET_JOURNAL_SCHEMA = "rmt-fleet-journal"


def _validate_perf_budgets(doc: dict) -> list[str]:
    """perf/budgets.json (docs/PERF.md): per-variant A_eff ratio budgets
    plus the wire-bytes ladder block. A hand-edited row (negative
    budget, unknown wire mode, fraction over 1.02) must fail HERE, not
    silently loosen — or brick — the traffic gate that reads it."""
    problems = []
    for name, v in doc["budgets"].items():
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            problems.append(f"budget {name!r} is not a positive number")
    serving = doc.get("serving")
    if serving is not None:
        if not isinstance(serving, dict):
            problems.append("'serving' block is not an object")
        else:
            tol = serving.get("batch_tolerance")
            if not isinstance(tol, (int, float)) or isinstance(tol, bool) \
                    or tol < 1.0:
                problems.append(
                    f"serving batch_tolerance {tol!r} must be >= 1.0 "
                    "(a B-lane program can never move fewer bytes than "
                    "B x one lane)"
                )
            hide = serving.get("hide_tolerance")
            if hide is not None and (
                not isinstance(hide, (int, float))
                or isinstance(hide, bool) or hide < 1.0
            ):
                problems.append(
                    f"serving hide_tolerance {hide!r} must be >= 1.0 "
                    "(the batched-hide program is gated per lane "
                    "against the single-lane exchanged-step ideal)"
                )
            floor = serving.get("occupancy_floor")
            if not isinstance(floor, (int, float)) \
                    or isinstance(floor, bool) or not 0.0 < floor <= 1.0:
                problems.append(
                    f"serving occupancy_floor {floor!r} outside (0, 1]"
                )
            ptol = serving.get("padded_flops_tolerance")
            if ptol is not None and (
                not isinstance(ptol, (int, float))
                or isinstance(ptol, bool) or ptol < 0.0
            ):
                problems.append(
                    f"serving padded_flops_tolerance {ptol!r} must be "
                    ">= 0 (the ladder's padded-FLOPs inflation cap; 0 "
                    "admits only exact-rung shapes)"
                )
            occ = serving.get("occupancy")
            if occ is not None and (
                not isinstance(occ, (int, float))
                or isinstance(occ, bool) or not 0.0 < occ <= 1.0
            ):
                problems.append(
                    f"serving occupancy {occ!r} outside (0, 1] (the "
                    "continuous drain's step-weighted occupancy floor)"
                )
    wire = doc.get("wire")
    if wire is None:
        return problems
    if not isinstance(wire, dict):
        return problems + ["'wire' block is not an object"]
    ladder = wire.get("ladder")
    if not isinstance(ladder, dict) or not ladder:
        problems.append("wire block missing its 'ladder' rows")
        return problems
    for mode, frac in ladder.items():
        if mode not in _WIRE_MODES:
            problems.append(
                f"wire ladder names unknown mode {mode!r} "
                f"(known: {list(_WIRE_MODES)})"
            )
        if not isinstance(frac, (int, float)) or isinstance(frac, bool) \
                or not 0 < frac <= 1.02:
            problems.append(
                f"wire ladder row {mode!r}={frac!r} outside (0, 1.02]"
            )
    return problems


def _validate_elastic_record(doc: dict) -> list[str]:
    """elastic.jsonl record validation (telemetry.health owns the
    format; resilience.elastic writes it): every record names its event
    and is wall-stamped; a shrink or grow must carry the old→new rank
    counts the monitor's SHRUNK / GROWN badges are computed from."""
    problems = []
    name = doc.get("name")
    if not isinstance(name, str) or not name.startswith("elastic."):
        problems.append(f"elastic record name {name!r} (want elastic.*)")
    if not isinstance(doc.get("t"), (int, float)):
        problems.append("elastic record missing wall stamp t")
    if name in ("elastic.shrink", "elastic.grow"):
        for key in ("old_nprocs", "new_nprocs"):
            if not isinstance(doc.get(key), int):
                problems.append(f"{name} missing {key}")
    return problems


# Event families whose archived records carry committed inner structure
# (docs/RESILIENCE.md §7): the preemption decision trail and the
# storage-fault plane. Validated wherever a telemetry JSONL stream gets
# banked — a drifted writer must fail here, not as an unreadable loss-window audit after
# the next real eviction/outage.
_GUARDED_EVENT_PREFIXES = ("preempt.", "ckpt.")


def _validate_event_record(doc: dict) -> list[str]:
    """Telemetry "event"-kind records for the preempt.* / ckpt.*
    families: every one is anchored to the segment boundary that decided
    it (an int `step`); a `ckpt.degraded` additionally names its reason
    — the field the loss-window audit groups on."""
    name = doc.get("name")
    if not isinstance(name, str):
        return []
    if name == "serve.request.done" and doc.get("decomp") is not None:
        # The per-request latency decomposition (request
        # tracing): stage keys and non-negative times, validated by
        # the tracing module's shared stdlib checker.
        from rocm_mpi_tpu_torch.telemetry.tracing import validate_decomposition

        return validate_decomposition(doc["decomp"])
    if not name.startswith(_GUARDED_EVENT_PREFIXES):
        return []
    problems = []
    if not isinstance(doc.get("step"), int):
        problems.append(f"{name} event missing int step")
    if name == "ckpt.degraded" and not isinstance(doc.get("reason"), str):
        problems.append("ckpt.degraded event missing reason")
    return problems


def check_schema(paths, notes: list | None = None) -> list[str]:
    """Validate committed measurement artifacts. Returns problem strings
    (empty = all recognized). `.jsonl` files are checked line-by-line;
    `.json` files as one document. The families whose deep validators
    live in a plane the port lacks (graftlint) pass on their
    schema marker alone; each such file is named once in `notes` (a list
    the caller passes, which the CLI prints), never passed in silence."""
    from rocm_mpi_tpu_torch.telemetry.health import ELASTIC_SCHEMA

    problems: list[str] = []
    shallow: set[str] = set()
    for raw in paths:
        path = pathlib.Path(raw)
        if not path.is_file():
            problems.append(f"{raw}: missing")
            continue
        try:
            text = path.read_text()
        except OSError as e:
            problems.append(f"{raw}: unreadable ({e})")
            continue
        if path.suffix == ".jsonl":
            for i, line in enumerate(text.splitlines(), 1):
                if not line.strip():
                    continue
                try:
                    doc = json.loads(line)
                except ValueError as e:
                    problems.append(f"{raw}:{i}: bad JSON line ({e})")
                    continue
                if not isinstance(doc, dict) or not (
                    "metric" in doc or ("kind" in doc and "v" in doc)
                ):
                    problems.append(
                        f"{raw}:{i}: unrecognized JSONL record "
                        "(want a mechanics row or a telemetry event)"
                    )
                    continue
                if doc.get("schema") == ELASTIC_SCHEMA:
                    for p in _validate_elastic_record(doc):
                        problems.append(f"{raw}:{i}: {p}")
                elif doc.get("schema") == _SERVE_REQUEST_SCHEMA:
                    from rocm_mpi_tpu_torch.serving.queue import validate_request_record

                    for p in validate_request_record(doc):
                        problems.append(f"{raw}:{i}: {p}")
                elif doc.get("schema") == _QUARANTINE_SCHEMA:
                    from rocm_mpi_tpu_torch.serving.queue import validate_quarantine_record

                    for p in validate_quarantine_record(doc):
                        problems.append(f"{raw}:{i}: {p}")
                elif doc.get("schema") == _FLEET_JOURNAL_SCHEMA:
                    from rocm_mpi_tpu_torch.serving.journal import validate_journal_record

                    for p in validate_journal_record(doc):
                        problems.append(f"{raw}:{i}: {p}")
                elif doc.get("kind") == "event":
                    for p in _validate_event_record(doc):
                        problems.append(f"{raw}:{i}: {p}")
        else:
            try:
                doc = json.loads(text)
            except ValueError as e:
                problems.append(f"{raw}: bad JSON ({e})")
                continue
            kind = _classify_json(doc) if isinstance(doc, dict) else None
            if kind is None:
                problems.append(
                    f"{raw}: unrecognized schema (known: telemetry "
                    "summary, flat metrics, BASELINE, multichip probe, "
                    "bench row, checkpoint manifest)"
                )
            else:
                for p in _validate_classified(doc, kind):
                    problems.append(f"{raw}: {p}")
                if kind in DEEP_CHECKED_ELSEWHERE:
                    shallow.add(f"{raw}: {kind}")
    if notes is not None:
        notes.extend(f"{s}: recognized, not deep-checked (its plane is not ported)"
                     for s in sorted(shallow))
    return problems
