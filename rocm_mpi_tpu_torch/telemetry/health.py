"""Runtime health plane, read side: sidecar tailing, the progress-aware
stall verdict, post-mortem composition, the live monitor, and the
OpenMetrics export — counterpart of rocm_mpi_tpu/telemetry/health.py
(the same documents on the same sidecars and streams; the elastic,
storage, serve and fleet status readers are copies, ready for the
planes the port has not brought over yet).

The write side (telemetry/flight.py) publishes one `heartbeat-rank{k}.json`
per rank — counters, last phase entered, the flight ring — via atomic
rename. Everything here only READS those sidecars (plus the rank JSONL
streams for the merged timeline), so it runs out-of-process: in the
launcher's watchdog thread, or on a box with no torch at all (the monitor
and export CLI verbs). stdlib-only, like the rest of the read side.

The stalled-collective signature
--------------------------------
Wall clock alone cannot name a wedged rank: when one rank dies or spins
mid-collective, EVERY peer eventually blocks and all of them look
equally idle. Progress counters can: the victim's step counter stopped
first, so the cross-rank median of step counters (the same interpolating
median aggregate.py's straggler detector uses) advances PAST it — peers
bump their counter on entering the window the victim never reached, then
block. `ProgressWatch` flags a rank when

* its sidecar's progress content (counters + last phase) has not changed
  for `stall_grace_s`, AND
* the cross-rank median step counter is strictly ahead of its own.

Only ranks that have PUBLISHED a step counter participate in the median
and in verdicts (and at least two must have): a rank with no `step` yet
has not entered an instrumented loop — it may be sitting out a
weak-scaling rung it owns no devices in, or still compiling — and
comparing its absence-of-progress against working ranks would get a
healthy rank killed. The step counters of participating ranks are
comparable by the writers' contract: apps bump one GLOBAL step count
per process (weak_scaling banks skipped/completed rungs into the
offset), never a per-phase restart that the recorder's monotonic guard
would mask.

A coordinated slow phase (everyone compiling, everyone in one long
window) leaves every participating rank at the same counter — nobody is
strictly behind the median, no verdict. That is the "by progress, not
wall clock" contract the watchdog drill pins.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import statistics
import time

from rocm_mpi_tpu_torch.telemetry import aggregate
from rocm_mpi_tpu_torch.telemetry.flight import (
    BUNDLE_SCHEMA,
    BUNDLE_VERSION,
    HEARTBEAT_SCHEMA,
    POSTMORTEM_SCHEMA,
    POSTMORTEM_VERSION,
)

DEFAULT_STALL_GRACE_S = 5.0

_HEARTBEAT_RE = re.compile(r"heartbeat-rank(\d+)\.json$")
_POSTMORTEM_RE = re.compile(r"postmortem-rank(\d+)\.json$")


def heartbeat_paths(directory) -> dict[int, pathlib.Path]:
    """{rank: sidecar path} under `directory`."""
    out: dict[int, pathlib.Path] = {}
    root = pathlib.Path(directory)
    if not root.is_dir():
        return out
    for path in sorted(root.glob("heartbeat-rank*.json")):
        m = _HEARTBEAT_RE.search(path.name)
        if m:
            out[int(m.group(1))] = path
    return out


def load_heartbeats(directory) -> tuple[dict[int, dict], int]:
    """Parse every heartbeat sidecar. Returns ({rank: doc}, skipped).
    A rank killed mid-write (or a reader racing the writer's rename on a
    filesystem without atomic replace) leaves a torn file: counted and
    skipped, never fatal — the surviving sidecars are the point."""
    beats: dict[int, dict] = {}
    skipped = 0
    for rk, path in heartbeat_paths(directory).items():
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            skipped += 1
            continue
        if isinstance(doc, dict) and doc.get("schema") == HEARTBEAT_SCHEMA:
            doc.setdefault("rank", rk)
            beats[rk] = doc
        else:
            skipped += 1
    return beats, skipped


def _progress_key(doc: dict):
    """What counts as progress: the counters and the phase — NOT the
    wall stamp (a stalled rank's flusher may rewrite identical content
    forever; that is liveness, not progress)."""
    counters = doc.get("counters") or {}
    return (tuple(sorted(counters.items())), doc.get("last_phase"),
            doc.get("last_phase_name"))


class ProgressWatch:
    """Tracks per-rank progress across repeated sidecar observations and
    issues stall verdicts (module docstring has the signature). Feed it
    `observe(beats, now)` each poll; `now` is any monotonic clock."""

    def __init__(self, stall_grace_s: float = DEFAULT_STALL_GRACE_S):
        self.stall_grace_s = float(stall_grace_s)
        self._state: dict[int, dict] = {}

    def observe(self, beats: dict[int, dict], now: float) -> None:
        for rk, doc in beats.items():
            key = _progress_key(doc)
            st = self._state.get(rk)
            if st is None or st["key"] != key:
                self._state[rk] = {"key": key, "changed_at": now, "doc": doc}
            else:
                st["doc"] = doc

    def ages(self, now: float) -> dict[int, float]:
        """Seconds since each rank's progress content last changed — the
        per-rank ages the launcher's health heartbeat line reports."""
        return {
            rk: max(now - st["changed_at"], 0.0)
            for rk, st in sorted(self._state.items())
        }

    def steps(self) -> dict[int, int]:
        """Step counters of the PARTICIPATING ranks only (those that
        have published a `step` at all — module docstring)."""
        out = {}
        for rk, st in self._state.items():
            step = (st["doc"].get("counters") or {}).get("step")
            if isinstance(step, (int, float)):
                out[rk] = int(step)
        return out

    def verdicts(self, now: float) -> list[dict]:
        """Ranks currently matching the stalled-collective signature,
        worst (most-behind) first. Needs >= 2 ranks with published step
        counters — there is no cross-rank median of one, and a rank
        that never published progress cannot have stalled it."""
        steps = self.steps()
        if len(steps) < 2:
            return []
        median = statistics.median(steps.values())
        out = []
        for rk, st in sorted(self._state.items()):
            if rk not in steps:
                continue
            stalled_for = now - st["changed_at"]
            if stalled_for < self.stall_grace_s:
                continue
            if not steps[rk] < median:
                continue
            out.append({
                "rank": rk,
                "step": steps[rk],
                "median_step": median,
                "stalled_for_s": round(stalled_for, 3),
                "last_phase": st["doc"].get("last_phase"),
                "last_phase_name": st["doc"].get("last_phase_name"),
            })
        out.sort(key=lambda v: v["step"])
        return out


# ---------------------------------------------------------------------------
# Elastic supervisor events (docs/RESILIENCE.md "Elastic recovery")
# ---------------------------------------------------------------------------
#
# The elastic supervisor (resilience.elastic.run_elastic) outlives every
# rank — its decisions (launch on this mesh, shrink to that one, give up)
# cannot ride a rank's telemetry stream. They land in one append-only
# `elastic.jsonl` sidecar next to the heartbeat sidecars, written here
# (telemetry owns the clock reads) and read back by the monitor
# verb, which shows the current mesh shape plus SHRUNK / GROWN badges
# for runs that changed topology (and a PREEMPTED marker for a whole-job
# eviction). scripts/lint.sh schema-checks the records
# (regress.check_schema) wherever they get archived.

ELASTIC_SCHEMA = "rocm_mpi_tpu.resilience.elastic"
ELASTIC_VERSION = 1
ELASTIC_FILE = "elastic.jsonl"


def append_elastic_event(directory, name: str, **attrs) -> dict:
    """Append one supervisor event (`elastic.launch` / `elastic.shrink` /
    `elastic.complete` / `elastic.gave-up`) to `<directory>/elastic.jsonl`,
    wall-stamped here. Returns the record."""
    rec = {
        "schema": ELASTIC_SCHEMA,
        "v": ELASTIC_VERSION,
        "kind": "event",
        "name": name,
        "t": time.time(),
        **attrs,
    }
    root = pathlib.Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / ELASTIC_FILE, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return rec


def load_elastic_events(directory) -> tuple[list[dict], int]:
    """Parse `<directory>/elastic.jsonl`. Returns (records, skipped) —
    torn/foreign lines are counted and skipped, never fatal (the same
    tolerance every sidecar reader here has)."""
    path = pathlib.Path(directory) / ELASTIC_FILE
    records: list[dict] = []
    skipped = 0
    try:
        text = path.read_text()
    except OSError:
        return records, skipped
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(doc, dict) and doc.get("schema") == ELASTIC_SCHEMA:
            records.append(doc)
        else:
            skipped += 1
    return records, skipped


def elastic_status(events: list[dict]) -> dict | None:
    """The monitor's one-line view of the elastic record: current mesh
    dims, rank count, whether the run ever SHRANK (and from what) or
    GREW (and onto what), and whether the whole job was preempted. None
    when there are no elastic events (non-elastic run: no badge)."""
    mesh = None
    nprocs = None
    first_mesh = None
    grow_mesh = None
    shrinks = 0
    grows = 0
    preempted = False
    for e in events:
        name = e.get("name")
        if name == "elastic.launch":
            mesh = e.get("mesh") or mesh
            nprocs = e.get("nprocs", nprocs)
            if first_mesh is None:
                first_mesh = e.get("mesh")
        elif name == "elastic.shrink":
            shrinks += 1
            mesh = e.get("new_mesh") or mesh
            nprocs = e.get("new_nprocs", nprocs)
            if first_mesh is None:
                first_mesh = e.get("old_mesh")
        elif name == "elastic.grow":
            grows += 1
            mesh = e.get("new_mesh") or mesh
            grow_mesh = e.get("new_mesh") or grow_mesh
            nprocs = e.get("new_nprocs", nprocs)
            if first_mesh is None:
                first_mesh = e.get("old_mesh")
        elif name == "elastic.preempted":
            preempted = True
    if mesh is None and nprocs is None:
        return None
    return {
        "mesh": mesh,
        "nprocs": nprocs,
        "shrunk": shrinks > 0,
        "shrinks": shrinks,
        "grown": grows > 0,
        "grows": grows,
        "grow_mesh": grow_mesh,
        "preempted": preempted,
        "first_mesh": first_mesh,
    }


def _mesh_str(mesh) -> str | None:
    """Render mesh dims for the monitor header; None when the elastic
    run never recorded dims (run_elastic without a global shape plans
    plain rank counts — the header then shows ranks only, never the
    literal string 'None')."""
    if isinstance(mesh, list):
        return "(" + ", ".join(str(d) for d in mesh) + ")"
    return None


def format_elastic_status(status: dict | None) -> str | None:
    """`mesh (2, 1)  2 rank(s)` — plus the SHRUNK badge once a shrink
    happened: `mesh (1, 1)  1 rank(s)  [SHRUNK from (2, 1), 1
    shrink(s)]`, the mirror GROWN badge once a grow happened
    (`[GROWN to (2, 1), 1 grow(s)]` — both can show: a run that shrank
    and grew back carries its whole topology history), and
    `[PREEMPTED — resumable]` when the supervisor recorded a whole-job
    eviction. Mesh fragments are omitted when the events carry no
    dims."""
    if not status:
        return None
    parts = []
    mesh_s = _mesh_str(status.get("mesh"))
    if mesh_s is not None:
        parts.append(f"mesh {mesh_s}")
    if status.get("nprocs") is not None:
        parts.append(f"{status['nprocs']} rank(s)")
    if status.get("shrunk"):
        first_s = _mesh_str(status.get("first_mesh"))
        origin = (
            f"from {first_s}" if first_s is not None
            else "from more ranks"
        )
        parts.append(
            f"[SHRUNK {origin}, {status['shrinks']} shrink(s)]"
        )
    if status.get("grown"):
        grow_s = _mesh_str(status.get("grow_mesh"))
        target = (
            f"to {grow_s}" if grow_s is not None
            else "to more ranks"
        )
        parts.append(
            f"[GROWN {target}, {status['grows']} grow(s)]"
        )
    if status.get("preempted"):
        parts.append("[PREEMPTED — resumable]")
    return "  ".join(parts) if parts else None


def storage_status(beats: dict[int, dict]) -> dict | None:
    """The degraded-storage view the monitor renders next to the elastic
    badges, computed from the heartbeat progress counters the segmented
    loop bumps alongside its `ckpt.degraded`/`ckpt.recovered` telemetry
    events (utils.checkpoint._guarded_save): a rank is degraded NOW when
    it entered degraded mode more times than it recovered. None when no
    rank ever degraded (the common case: no indicator at all)."""
    degraded_ranks = []
    skipped = 0
    for rank, doc in sorted(beats.items()):
        counters = doc.get("counters") or {}
        skipped += int(counters.get("ckpt_skipped", 0) or 0)
        entered = int(counters.get("ckpt_degraded", 0) or 0)
        recovered = int(counters.get("ckpt_recovered", 0) or 0)
        if entered > recovered:
            degraded_ranks.append(rank)
    if not degraded_ranks and not skipped:
        return None
    return {
        "degraded": bool(degraded_ranks),
        "degraded_ranks": degraded_ranks,
        "skipped": skipped,
    }


def format_storage_status(status: dict | None) -> str | None:
    """`[STORAGE DEGRADED rank(s) 0,1 — 3 skipped save(s)]` while an
    outage is live; once every rank recovered, the quieter
    `storage recovered (3 skipped save(s))` keeps the loss window
    visible. None when checkpointing never degraded."""
    if not status:
        return None
    if status["degraded"]:
        ranks = ",".join(str(r) for r in status["degraded_ranks"])
        return (
            f"[STORAGE DEGRADED rank(s) {ranks} — "
            f"{status['skipped']} skipped save(s)]"
        )
    return f"storage recovered ({status['skipped']} skipped save(s))"


def serve_status(beats: dict[int, dict]) -> dict | None:
    """The serving-plane view next to the elastic/storage badges
    (docs/SERVING.md; docs/TELEMETRY.md "Serving"), computed from the
    heartbeat progress counters the service's drain loop bumps
    (serve_submitted / serve_completed / serve_requeued /
    serve_resizes / serve_rejected / serve_expired / serve_quarantined
    are ADDITIVE counters — depth is their difference; serve_retries
    rides for visibility but is an event count, not an outcome).
    None when no rank ever served (the common case: no badge)."""
    submitted = completed = requeued = resizes = failed = 0
    rejected = expired = quarantined = retries = 0
    seen = False
    for _rank, doc in sorted(beats.items()):
        counters = doc.get("counters") or {}
        if not any(k.startswith("serve_") for k in counters):
            continue
        seen = True
        submitted += int(counters.get("serve_submitted", 0) or 0)
        completed += int(counters.get("serve_completed", 0) or 0)
        requeued += int(counters.get("serve_requeued", 0) or 0)
        resizes += int(counters.get("serve_resizes", 0) or 0)
        failed += int(counters.get("serve_failed", 0) or 0)
        rejected += int(counters.get("serve_rejected", 0) or 0)
        expired += int(counters.get("serve_expired", 0) or 0)
        quarantined += int(counters.get("serve_quarantined", 0) or 0)
        retries += int(counters.get("serve_retries", 0) or 0)
    if not seen:
        return None
    return {
        # Every outcome leaves the backlog — a failed/rejected/expired/
        # quarantined request must not read as depth forever, and a
        # retry-requeue hands the ticket back to the queue (it will be
        # re-counted when re-popped), so retries subtract too.
        "depth": max(
            submitted - completed - requeued - failed - rejected
            - expired - quarantined - retries, 0
        ),
        "submitted": submitted,
        "completed": completed,
        "requeued": requeued,
        "resizes": resizes,
        "failed": failed,
        "rejected": rejected,
        "expired": expired,
        "quarantined": quarantined,
        "retries": retries,
    }


def format_serve_status(status: dict | None) -> str | None:
    """`[SERVE depth=3 — 17 done]` while requests are in flight; the
    quieter `serve idle (17 done)` once drained; requeued work
    (preemption), elastic resizes, and the SLO outcomes — deadline
    misses (expired), quarantined poison, admission rejections — ride
    along, so a poisoned or overloaded service is visible from the
    sidecar alone (docs/SERVING.md "SLOs and admission"). None when
    the run never served."""
    if not status:
        return None
    tail = f"{status['completed']} done"
    if status.get("failed"):
        tail += f", {status['failed']} failed"
    if status.get("expired"):
        tail += f", {status['expired']} deadline-missed"
    if status.get("quarantined"):
        tail += f", {status['quarantined']} quarantined"
    if status.get("rejected"):
        tail += f", {status['rejected']} rejected"
    if status.get("retries"):
        tail += f", {status['retries']} retried"
    if status["requeued"]:
        tail += f", {status['requeued']} requeued"
    if status["resizes"]:
        tail += f", {status['resizes']} resize(s)"
    if status["depth"]:
        return f"[SERVE depth={status['depth']} — {tail}]"
    return f"serve idle ({tail})"


def fleet_status(report: dict | None) -> dict | None:
    """The fleet-plane view next to the SERVE badge (docs/SERVING.md
    "The fleet"), computed from a merged fleet report
    (serving/journal.py `rmt-fleet-report`): live/total replicas, the
    journal-derived merged SLO counts, the re-route count, and the
    accounting verdict. None when the doc isn't a fleet report."""
    if not report or report.get("schema") != "rmt-fleet-report":
        return None
    replicas = report.get("replicas") or []
    slo = report.get("slo") or {}
    journal = report.get("journal") or {}
    live = sum(
        1 for r in replicas
        if r.get("alive") and not r.get("demoted")
    )
    return {
        "live": live,
        "total": len(replicas),
        "demoted": sum(
            1 for r in replicas
            if r.get("alive") and r.get("demoted")
        ),
        "depth": int(journal.get("open", 0) or 0),
        "done": int(slo.get("done", 0) or 0),
        "failed": int(slo.get("failed", 0) or 0),
        "rejected": int(slo.get("rejected", 0) or 0),
        "expired": int(slo.get("expired", 0) or 0),
        "quarantined": int(slo.get("quarantined", 0) or 0),
        "rerouted": int(journal.get("rerouted", 0) or 0),
        "accounting_ok": bool(report.get("accounting_ok")),
    }


def format_fleet_status(status: dict | None) -> str | None:
    """`[FLEET 2/3 up — depth=4, 17 done, 3 rerouted]` while the fleet
    owes work; the quieter `fleet idle (3/3 up — 17 done)` once the
    journal shows every ticket terminal. A broken accounting invariant
    is the loudest thing on the line — a lost or double-terminal
    ticket must not hide behind healthy-looking counts. None when
    there is no fleet report."""
    if not status:
        return None
    up = f"{status['live']}/{status['total']} up"
    tail = f"{status['done']} done"
    if status.get("failed"):
        tail += f", {status['failed']} failed"
    if status.get("expired"):
        tail += f", {status['expired']} deadline-missed"
    if status.get("quarantined"):
        tail += f", {status['quarantined']} quarantined"
    if status.get("rejected"):
        tail += f", {status['rejected']} rejected"
    if status.get("rerouted"):
        tail += f", {status['rerouted']} rerouted"
    if status.get("demoted"):
        tail += f", {status['demoted']} demoted"
    if not status.get("accounting_ok"):
        tail += ", ACCOUNTING BROKEN"
    if status["depth"]:
        return f"[FLEET {up} — depth={status['depth']}, {tail}]"
    return f"fleet idle ({up} — {tail})"


def wire_status(directory) -> list[str]:
    """The run's active wire-precision mode(s) (docs/PERF.md "Wire
    precision"), annotation-sourced from the telemetry rank streams in
    `directory` (the halo.exchange / deep.sweep / overlap.step trace
    records stamp `wire` per compiled program). Sorted, [] when the
    streams carry no wire-stamped annotations (pre-wire-plane runs)."""
    from rocm_mpi_tpu_torch.telemetry import aggregate

    modes: set[str] = set()
    streams, _skipped = aggregate.load_rank_streams(directory)
    for recs in streams.values():
        for rec in recs:
            w = aggregate.record_wire_mode(rec)
            if w:
                modes.add(w)
    return sorted(modes)


def format_wire_status(modes: list[str]) -> str | None:
    """`[WIRE bf16]` for a reduced-precision (or mixed-mode) run — like
    the GROWN/DEGRADED badges, the operator must see at a glance that
    this run's halo bytes are not comparable to an f32 run's. None for
    f32-only or unstamped streams (no badge — the common case)."""
    if not modes or modes == ["f32"]:
        return None
    return "[WIRE " + ", ".join(m for m in modes) + "]"


# ---------------------------------------------------------------------------
# Post-mortem composition and bundling (the watchdog's out-of-process half)
# ---------------------------------------------------------------------------


def write_postmortem(directory, rank: int, verdict: dict,
                     traceback_text: str | None = None) -> pathlib.Path:
    """Compose `postmortem-rank{k}.json` from the rank's last heartbeat,
    the watchdog verdict, and the faulthandler dump (read from the
    `.traceback` sidecar when not passed). Runs OUT of process — the
    wedged rank only had to have flushed a heartbeat once and own a
    registered faulthandler; everything else is the reader's job."""
    root = pathlib.Path(directory)
    # Wall-stamp the verdict IN PLACE (telemetry owns the clock reads):
    # the caller's verdict list and the bundle's trace instants
    # see the same stamp.
    verdict.setdefault("t", time.time())
    beats, _ = load_heartbeats(root)
    if traceback_text is None:
        tb_path = root / f"postmortem-rank{rank}.traceback"
        try:
            traceback_text = tb_path.read_text()
        except OSError:
            traceback_text = None
    doc = {
        "schema": POSTMORTEM_SCHEMA,
        "v": POSTMORTEM_VERSION,
        "rank": int(rank),
        "t": time.time(),
        "verdict": verdict,
        "heartbeat": beats.get(rank),
        "traceback": traceback_text,
    }
    path = root / f"postmortem-rank{rank}.json"
    aggregate.write_json_atomic(path, doc)
    return path


def bundle_postmortem(directory, verdicts: list[dict]) -> pathlib.Path:
    """Collect a run's wreckage into `<directory>/postmortem/`: the
    per-rank post-mortems and heartbeats, a `bundle.json` naming the
    verdicts, and a merged `timeline-trace.json` (the rank streams plus
    progress counter tracks and one instant per verdict — the Chrome
    trace an operator opens FIRST). Returns the bundle directory."""
    from rocm_mpi_tpu_torch.telemetry import trace

    root = pathlib.Path(directory)
    out = root / "postmortem"
    if out.is_dir():
        # The bundle describes THIS run's incident: a leftover bundle in
        # a reused directory would mix last incident's per-rank files
        # with the new verdicts and misattribute the wreckage.
        shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    copied = []
    for pattern in ("postmortem-rank*.json", "postmortem-rank*.traceback",
                    "heartbeat-rank*.json"):
        for path in sorted(root.glob(pattern)):
            try:
                shutil.copy2(path, out / path.name)
                copied.append(path.name)
            except OSError:
                continue
    beats, _ = load_heartbeats(root)
    streams, _ = aggregate.load_rank_streams(root)
    try:
        trace.write_chrome_trace(
            streams, out / "timeline-trace.json",
            heartbeats=beats, verdicts=verdicts,
        )
        copied.append("timeline-trace.json")
    except Exception:  # noqa: BLE001 — the bundle must survive a bad stream
        pass
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "v": BUNDLE_VERSION,
        "t": time.time(),
        "verdicts": verdicts,
        "ranks": sorted(beats),
        "files": sorted(set(copied)),
    }
    aggregate.write_json_atomic(out / "bundle.json", bundle)
    return out


# ---------------------------------------------------------------------------
# Live monitor (the `monitor` CLI verb)
# ---------------------------------------------------------------------------


def monitor_rows(beats: dict[int, dict],
                 prev: dict[int, dict] | None = None,
                 now_wall: float | None = None) -> list[dict]:
    """Per-rank monitor rows from one sidecar snapshot (plus the previous
    snapshot for step rates). Stateless — the CLI loop owns the cadence."""
    now_wall = time.time() if now_wall is None else now_wall
    steps = {
        rk: int((doc.get("counters") or {}).get("step", 0))
        for rk, doc in beats.items()
    }
    median = statistics.median(steps.values()) if steps else 0.0
    rows = []
    for rk in sorted(beats):
        doc = beats[rk]
        rate = None
        if prev and rk in prev:
            d_step = steps[rk] - int(
                (prev[rk].get("counters") or {}).get("step", 0)
            )
            d_t = (doc.get("t") or 0.0) - (prev[rk].get("t") or 0.0)
            if d_t > 0:
                rate = d_step / d_t
        phase_t = doc.get("last_phase_t") or doc.get("t") or now_wall
        rows.append({
            "rank": rk,
            "step": steps[rk],
            "phase": doc.get("last_phase") or "-",
            "age_s": max(now_wall - (doc.get("t") or now_wall), 0.0),
            "phase_age_s": max(now_wall - phase_t, 0.0),
            "rate": rate,
            "delta_vs_median": steps[rk] - median,
        })
    return rows


def format_monitor(rows: list[dict], skipped: int = 0) -> str:
    lines = [
        "rank  step      rate/s   phase         phase-age  Δmedian",
    ]
    for r in rows:
        rate = f"{r['rate']:8.2f}" if r["rate"] is not None else "       ?"
        lines.append(
            f"{r['rank']:<5d} {r['step']:<9d} {rate} "
            f"{r['phase']:<13s} {r['phase_age_s']:8.1f}s  "
            f"{r['delta_vs_median']:+g}"
        )
    if skipped:
        lines.append(f"({skipped} torn sidecar(s) skipped)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# OpenMetrics export (the `export-openmetrics` CLI verb)
# ---------------------------------------------------------------------------


def _om_escape(value: str) -> str:
    return (
        str(value).replace("\\", r"\\").replace('"', r'\"')
        .replace("\n", r"\n")
    )


def _om_number(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def export_openmetrics(directory) -> str | None:
    """A Prometheus/OpenMetrics text snapshot of the run's gauges,
    counters, and per-rank progress. The run's own metric keys (e.g.
    `run.gpts@4dev:scan`) contain characters OpenMetrics metric names
    forbid, so every key rides VERBATIM in a `key` label under three
    fixed metric families — the snapshot round-trips exactly, no lossy
    renaming. Returns None when `directory` holds neither rank streams
    nor heartbeat sidecars (the caller's exit-2 case)."""
    streams, _ = aggregate.load_rank_streams(directory)
    beats, _ = load_heartbeats(directory)
    if not streams and not beats:
        return None
    summary = aggregate.summarize(streams) if streams else None
    lines = []
    if summary:
        lines.append("# TYPE rmt_gauge gauge")
        lines.append("# HELP rmt_gauge telemetry gauges, key verbatim "
                     "(rank-median where multiple ranks emitted)")
        for key in sorted(summary["gauges"]):
            value = summary["gauges"][key]
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                lines.append(
                    f'rmt_gauge{{key="{_om_escape(key)}"}} '
                    f"{_om_number(value)}"
                )
        lines.append("# TYPE rmt_counter counter")
        lines.append("# HELP rmt_counter telemetry counters, key verbatim")
        for key in sorted(summary["counters"]):
            lines.append(
                f'rmt_counter_total{{key="{_om_escape(key)}"}} '
                f"{_om_number(summary['counters'][key])}"
            )
    if beats:
        lines.append("# TYPE rmt_progress gauge")
        lines.append("# HELP rmt_progress flight-recorder progress "
                     "counters per rank (heartbeat sidecars)")
        for rk in sorted(beats):
            counters = beats[rk].get("counters") or {}
            for name in sorted(counters):
                value = counters[name]
                if isinstance(value, (int, float)):
                    lines.append(
                        f'rmt_progress{{rank="{rk}",'
                        f'counter="{_om_escape(name)}"}} '
                        f"{_om_number(value)}"
                    )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> dict[str, dict]:
    """Parse an export back into {family: {label-tuple or key: value}} —
    the round-trip half the export test pins; also handy for scrapers
    that want the values without a Prometheus client."""
    out: dict[str, dict] = {}
    sample_re = re.compile(
        r'^(\w+)\{(.*)\}\s+(\S+)$'
    )
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            continue
        family, labelstr, value = m.groups()
        # Single-pass unescape (\\ \" \n): ordered str.replace would
        # consume the second character of an escaped backslash as a
        # fresh escape and corrupt values like 'a\\nb'.
        unescape = {"n": "\n", '"': '"', "\\": "\\"}
        labels = {
            k: re.sub(
                r"\\(.)", lambda m: unescape.get(m.group(1), m.group(1)), v
            )
            for k, v in label_re.findall(labelstr)
        }
        key = labels.get("key") or tuple(sorted(labels.items()))
        out.setdefault(family, {})[key] = float(value)
    return out
