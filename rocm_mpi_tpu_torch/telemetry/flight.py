"""Per-rank flight recorder: the write side of the runtime health plane —
counterpart of rocm_mpi_tpu/telemetry/flight.py (same sidecar schema and
file names).

The telemetry stream is append-only JSONL — great for post-run
attribution, useless for diagnosing a run that is WEDGED: a rank blocked
inside a collective stops appending, and nothing on disk says which rank
stopped making progress or why (the launcher's old heartbeat only knew
"ranks alive" by wall clock). This module is the black box that survives
the crash:

* a bounded **ring** of the last N span/event records (fed by a tap on
  `telemetry.events.emit` plus span-ENTRY notes from `telemetry.spans` —
  exits alone would miss the phase a rank is currently stuck in);
* monotonically increasing **progress counters** — step index, halo
  exchanges completed, halo bytes moved — plus the last phase entered;
* a **heartbeat sidecar** `heartbeat-rank{k}.json`, flushed via atomic
  tmp+rename at low frequency, so an *out-of-process* reader (the
  launcher's watchdog, the `monitor` CLI) sees this rank's last recorded
  progress even while the rank itself is blocked inside a collective and
  cannot run another line of Python;
* a **post-mortem hook**: `install_postmortem_handler()` registers
  SIGUSR2 with `faulthandler` — the C-level dumper, chosen precisely
  because a Python-level `signal.signal` handler never runs while the
  interpreter is wedged inside a C collective — appending an all-thread
  traceback to `postmortem-rank{k}.traceback`. The watchdog composes
  that text with the last heartbeat into `postmortem-rank{k}.json`
  (telemetry.health.write_postmortem): out-of-process composition is the
  only kind a wedged rank can be relied on to cooperate with. Neither
  torch nor NCCL installs a SIGUSR2 handler (chip_smoke.py checks it on
  the card before and after NCCL's init).

The recorder runs no thread of its own: it flushes inline, from the
thread that emits, and touches no CUDA state, so a flush inside a
CUDA-graph capture (annotations run there) is harmless.

Flush ordering contract: `progress()` flushes BEFORE the caller enters
the next potentially-blocking region whenever the step counter changed.
The watchdog's stalled-collective signature (a rank's step counter
behind the advancing cross-rank median) only works if a rank that is
about to block has already published the bump it reached — see
parallel/launcher.py.

Config mirrors telemetry.events: env first (`RMT_HEALTH=1`, sidecar dir
from `RMT_HEALTH_DIR` falling back to `RMT_TELEMETRY_DIR` — the
sidecars live next to the rank streams), or `enable()` from an app's
`--health` flag. stdlib-only; `enabled()` is one module-global read.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import signal
import threading
import time

from rocm_mpi_tpu_torch.telemetry import events

HEARTBEAT_SCHEMA = "rocm_mpi_tpu.telemetry.heartbeat"
HEARTBEAT_VERSION = 1
POSTMORTEM_SCHEMA = "rocm_mpi_tpu.telemetry.postmortem"
POSTMORTEM_VERSION = 1
BUNDLE_SCHEMA = "rocm_mpi_tpu.telemetry.postmortem_bundle"
BUNDLE_VERSION = 1

DEFAULT_RING_SIZE = 64
DEFAULT_FLUSH_INTERVAL_S = 0.25

_FALSY = ("0", "off", "false", "no", "")

_LOCK = threading.Lock()
_ENABLED = False
_DIR: str | None = None
_RANK: int | None = None
_RING: collections.deque = collections.deque(maxlen=DEFAULT_RING_SIZE)
_COUNTERS: dict[str, int] = {}
_LAST_PHASE: str | None = None
_LAST_PHASE_NAME: str | None = None
_LAST_PHASE_T: float | None = None
_FLUSH_INTERVAL_S = DEFAULT_FLUSH_INTERVAL_S
_LAST_FLUSH_MONO = 0.0
_STARTED_T = None
_TRACEBACK_FH = None  # keeps the faulthandler sink open for the process
# Trace ids of the requests currently riding a dispatched batch on this
# rank (serving/service.py marks them at dispatch, clears at resolve):
# a wedged rank's heartbeat then names WHICH requests are stuck in
# flight, not just that a batch is — the post-mortem's causal handle
# into the request-trace plane (telemetry/tracing.py).
_INFLIGHT_TRACES: set = set()


def enabled() -> bool:
    """The hot-path guard: one module-global read."""
    return _ENABLED


def _rank() -> int:
    if _RANK is not None:
        return _RANK
    return events.rank()


def _phase_of(name: str, attrs: dict | None) -> str:
    """A span's phase, by the same rule aggregate.phase_of applies on the
    read side (explicit attr wins, else the dotted name's head)."""
    if attrs and "phase" in attrs:
        return str(attrs["phase"])
    head = str(name).split(".", 1)[0]
    return "step" if head == "step_window" else head


def enable(directory=None, rank: int | None = None,
           ring_size: int | None = None,
           flush_interval_s: float | None = None) -> None:
    """Turn the flight recorder on. `directory` (default: the telemetry
    sink, then RMT_HEALTH_DIR/RMT_TELEMETRY_DIR) is where the heartbeat
    sidecar lands; created on the spot so a misconfigured sink fails
    here, not silently at every flush."""
    global _ENABLED, _DIR, _RANK, _RING, _FLUSH_INTERVAL_S, _STARTED_T
    with _LOCK:
        directory = (
            directory
            or os.environ.get("RMT_HEALTH_DIR")
            or events.directory()
            or os.environ.get("RMT_TELEMETRY_DIR")
        )
        if directory is None:
            raise ValueError(
                "flight recorder needs a sidecar directory: pass one, or "
                "configure telemetry (--telemetry DIR / RMT_TELEMETRY_DIR)"
            )
        _DIR = str(directory)
        os.makedirs(_DIR, exist_ok=True)
        if rank is not None:
            _RANK = int(rank)
        if ring_size is not None:
            _RING = collections.deque(_RING, maxlen=int(ring_size))
        if flush_interval_s is not None:
            _FLUSH_INTERVAL_S = float(flush_interval_s)
        if _STARTED_T is None:
            _STARTED_T = time.time()
        _ENABLED = True
    if not events.enabled():
        # The recorder rides the span/event stream: ring entries and the
        # "last phase entered" come from spans, which short-circuit to
        # no-ops while collection is off. Health WITHOUT telemetry would
        # flush structurally-valid but empty sidecars — last_phase null,
        # ring [] — and the watchdog's post-mortem would say nothing. So
        # arming the recorder arms collection too, into the same dir.
        events.configure(enabled=True, directory=_DIR, rank=rank)
    events.set_tap(_on_record)
    flush()


def enable_from_env() -> bool:
    """Enable when the launcher contract says so (RMT_HEALTH truthy);
    returns whether the recorder is on afterwards. Cheap when unset."""
    flag = os.environ.get("RMT_HEALTH")
    if flag is None or flag.lower() in _FALSY:
        return _ENABLED
    if not _ENABLED:
        enable()
    return True


def disable() -> None:
    """Stop recording and detach the events tap (tests)."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
    events.set_tap(None)


def reset() -> None:
    """The one reset behavior (the satellite-6 contract): the flight ring
    and counters are cleared AND the buffered event trail is dropped via
    `events.clear_events()` — which preserves buffered spans/gauges and
    the trace-annotation dedup set. Exactly one semantics, shared with
    every other caller of clear_events."""
    global _LAST_PHASE, _LAST_PHASE_NAME, _LAST_PHASE_T, _STARTED_T
    with _LOCK:
        _RING.clear()
        _COUNTERS.clear()
        _INFLIGHT_TRACES.clear()
        _LAST_PHASE = _LAST_PHASE_NAME = _LAST_PHASE_T = None
        _STARTED_T = None
    events.clear_events()


def sidecar_path() -> str | None:
    """This rank's heartbeat sidecar path (None while disabled)."""
    if _DIR is None:
        return None
    return os.path.join(_DIR, f"heartbeat-rank{_rank()}.json")


def traceback_path() -> str | None:
    """Where the SIGUSR2 faulthandler dump lands (None while disabled)."""
    if _DIR is None:
        return None
    return os.path.join(_DIR, f"postmortem-rank{_rank()}.traceback")


def _compact(rec: dict) -> dict:
    """Ring entries keep the fields the post-mortem reader needs and drop
    the rest — the ring rides inside every heartbeat flush."""
    out = {k: rec[k] for k in ("kind", "name", "t", "t_mono") if k in rec}
    for k in ("dur_s", "error", "step", "phase"):
        if k in rec:
            out[k] = rec[k]
    attrs = rec.get("attrs")
    if isinstance(attrs, dict):
        kept = {
            k: attrs[k]
            for k in ("phase", "steps", "bytes", "probe", "variant")
            if k in attrs
        }
        if kept:
            out["attrs"] = kept
    return out


def _on_record(rec: dict) -> None:
    """events.emit tap: every emitted record lands in the ring; halo
    spans also advance the exchange/byte counters (the fused paths
    annotate bytes at trace time, but the spans that DO run at runtime —
    host-staged oracle, probes, heartbeat probes — are counted here)."""
    if not _ENABLED:
        return
    with _LOCK:
        _RING.append(_compact(rec))
        if rec.get("kind") == "span" and \
                _phase_of(rec.get("name", ""), rec.get("attrs")) == "halo":
            _COUNTERS["halo_exchanges"] = _COUNTERS.get("halo_exchanges", 0) + 1
            attrs = rec.get("attrs") or {}
            nbytes = attrs.get("bytes", 0)
            if isinstance(nbytes, int):
                _COUNTERS["halo_bytes"] = (
                    _COUNTERS.get("halo_bytes", 0) + nbytes
                )
    _maybe_flush()


def enter_phase(name: str, attrs: dict | None = None) -> None:
    """Span-ENTRY note (telemetry.spans calls this): records the phase
    the rank is in RIGHT NOW — a rank wedged inside a halo collective
    never reaches the span's exit record, and "last phase entered" is
    exactly what its post-mortem must say. A phase CHANGE bypasses the
    flush rate limit: the sidecar must say "halo" before the rank blocks
    there, not after."""
    global _LAST_PHASE, _LAST_PHASE_NAME, _LAST_PHASE_T
    if not _ENABLED:
        return
    phase = _phase_of(name, attrs)
    with _LOCK:
        changed = phase != _LAST_PHASE
        _LAST_PHASE = phase
        _LAST_PHASE_NAME = name
        _LAST_PHASE_T = time.time()
        _RING.append({
            "kind": "phase", "name": name, "phase": phase,
            "t": _LAST_PHASE_T, "t_mono": time.perf_counter(),
        })
    _maybe_flush(force=changed)


def progress(step: int | None = None, step_inc: int | None = None,
             **counts) -> None:
    """Advance the progress counters. `step` sets the absolute step
    index (monotonic — a lower value is ignored; use a process-GLOBAL
    count, the cross-rank comparability contract in telemetry.health);
    `step_inc` adds to it (per-step loops that don't track a global
    index); keyword counts are ADDED (`progress(halo_exchanges=1,
    halo_bytes=n)`). A step advance flushes immediately: the bump must
    be on disk before the caller enters the next potentially-blocking
    collective (module docstring)."""
    if not _ENABLED:
        return
    stepped = False
    with _LOCK:
        if step is not None:
            step = int(step)
            if step > _COUNTERS.get("step", -1):
                _COUNTERS["step"] = step
                stepped = True
        if step_inc:
            _COUNTERS["step"] = _COUNTERS.get("step", 0) + int(step_inc)
            stepped = True
        for key, delta in counts.items():
            try:
                _COUNTERS[key] = _COUNTERS.get(key, 0) + int(delta)
            except (TypeError, ValueError):
                continue
    _maybe_flush(force=stepped)


def trace_inflight_add(trace_ids) -> None:
    """Mark request trace ids as riding a dispatched batch. No-op while
    disabled; no flush of its own (the dispatch path's progress() bump
    already forces one, and the ids must be in THAT flush)."""
    if not _ENABLED:
        return
    with _LOCK:
        _INFLIGHT_TRACES.update(str(t) for t in trace_ids)


def trace_inflight_drop(trace_ids) -> None:
    """Clear request trace ids whose batch resolved (or failed)."""
    if not _ENABLED:
        return
    with _LOCK:
        _INFLIGHT_TRACES.difference_update(str(t) for t in trace_ids)


def inflight_traces() -> list[str]:
    """The currently in-flight request trace ids (sorted; tests)."""
    with _LOCK:
        return sorted(_INFLIGHT_TRACES)


def snapshot() -> dict:
    """The heartbeat document (also what flush writes)."""
    with _LOCK:
        return {
            "schema": HEARTBEAT_SCHEMA,
            "v": HEARTBEAT_VERSION,
            "rank": _rank(),
            "t": time.time(),
            "t_mono": time.perf_counter(),
            "started_t": _STARTED_T,
            "counters": dict(_COUNTERS),
            "last_phase": _LAST_PHASE,
            "last_phase_name": _LAST_PHASE_NAME,
            "last_phase_t": _LAST_PHASE_T,
            "inflight_traces": sorted(_INFLIGHT_TRACES),
            "ring": list(_RING),
        }


def flush() -> str | None:
    """Write the sidecar NOW (atomic tmp+rename — a reader must never
    see a half-written heartbeat; a rank killed mid-write leaves at worst
    a stale-but-complete sidecar plus tmp litter). Returns the path."""
    global _LAST_FLUSH_MONO
    path = sidecar_path()
    if path is None or not _ENABLED:
        return None
    doc = snapshot()
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
    except OSError:
        return None  # observability must never be what kills a run
    _LAST_FLUSH_MONO = time.monotonic()
    return path


def _maybe_flush(force: bool = False) -> None:
    if not _ENABLED or _DIR is None:
        return
    if force or time.monotonic() - _LAST_FLUSH_MONO >= _FLUSH_INTERVAL_S:
        flush()


def install_postmortem_handler() -> str | None:
    """Register SIGUSR2 → faulthandler all-thread traceback appended to
    `postmortem-rank{k}.traceback`. faulthandler (not `signal.signal`)
    on purpose: its dumper runs at the C level, so it fires even while
    the main thread is wedged inside a collective that never returns to
    the interpreter — the exact state the watchdog probes. Returns the
    traceback path (None when the platform has no SIGUSR2 or the
    recorder is disabled).
    """
    global _TRACEBACK_FH
    path = traceback_path()
    if path is None or not hasattr(signal, "SIGUSR2"):
        return None
    try:
        # Append mode: repeated SIGUSR2s accumulate dumps; the fh stays
        # open for the process lifetime (faulthandler writes to the fd).
        fh = open(path, "a")
        faulthandler.register(signal.SIGUSR2, file=fh, all_threads=True,
                              chain=False)
    except (OSError, ValueError, AttributeError):
        return None
    if _TRACEBACK_FH is not None:
        try:
            _TRACEBACK_FH.close()
        except OSError:
            pass
    _TRACEBACK_FH = fh
    flush()
    return path
