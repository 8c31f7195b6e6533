"""Telemetry event stream: versioned records, one JSONL writer per rank —
counterpart of rocm_mpi_tpu/telemetry/events.py, with the same record
schema, file names and environment contract, so either package's read
side reads the other's streams.

Every observation — span, counter, gauge, run event, trace annotation —
is one dict record with a common stamped header, collected in-process
and (when a sink directory is configured) appended to
`telemetry-rank{k}.jsonl`, one writer per rank so concurrent ranks never
interleave within a line.

Record header (every kind):

    {"v": SCHEMA_VERSION,      # event-schema version (v1 = the
                               #   unversioned RunEvent lines)
     "kind": "span" | "counter" | "gauge" | "event" | "trace"
             | "tspan" | "anchor",
     "name": str,              # dotted, phase-prefixed ("halo.exchange")
     "t": float,               # time.time() — comparable ACROSS ranks
     "t_mono": float,          # time.perf_counter() — orders WITHIN a rank
     "rank": int}

Kind-specific fields: spans add `dur_s`/`depth`/`tid`, counters and
gauges add `value`, events carry the run-event payload
(attempt/step/wait_s/error), trace annotations carry static metadata
recorded once per program (bytes per halo exchange etc. — see
`annotate`), tspans carry a request's trace context
(telemetry/tracing.py). Everything else rides in `attrs` so the header
schema stays closed.

Two timestamps by design: wall time aligns ranks in the merged Chrome
trace (each process's monotonic origin is arbitrary), while `t_mono`
gives the tear-free ordering within a rank. The "anchor"-kind
`clock.anchor` record (one per sink, emitted by configure()) binds the
two clocks: its header stamps t and t_mono back to back, so the merger
can map any record's t_mono into comparable wall time
(telemetry/tracing.py `aligned_wall`).

Configuration (env first, so launcher-spawned ranks need no code):

    RMT_TELEMETRY=1          enable collection (0/off/false disables)
    RMT_TELEMETRY_DIR=DIR    sink directory (implies enabled)
    RMT_PROCESS_ID           rank stamp (parallel/launcher.spawn_ranks)
    RANK                     rank stamp under torchrun

or `configure(enabled=…, directory=…, rank=…)` from an app (--telemetry).

Cost discipline: `enabled()` is one module-global bool read — the hot
guard every span/annotation checks first. "event"-kind records are the
exception: they buffer in-process even when disabled, because
`utils.metrics.events()` callers must see events without opting into
collection. stdlib-only on purpose: the aggregate/trace/regress CLI must
run on a box with no torch at all.
"""

from __future__ import annotations

import json
import os
import threading
import time

SCHEMA_VERSION = 2

_FALSY = ("0", "off", "false", "no", "")


def _env_enabled() -> bool:
    flag = os.environ.get("RMT_TELEMETRY")
    if flag is not None:
        return flag.lower() not in _FALSY
    return bool(os.environ.get("RMT_TELEMETRY_DIR"))


_LOCK = threading.Lock()
_ENABLED: bool = _env_enabled()
_DIR: str | None = os.environ.get("RMT_TELEMETRY_DIR") or None
_RANK: int | None = None
_RECORDS: list[dict] = []
_ANNOTATED: set = set()  # (name, sorted attrs) — trace-annotation dedup
_ANCHORED: set = set()   # (dir, rank) — one clock anchor per sink

# In-process buffer cap for hot kinds (spans/counters/gauges/trace): the
# JSONL file is the real sink; the buffer exists for tests and
# single-process introspection and must not grow without bound over a
# production-length run (a per-step host-staged oracle emits 2 spans per
# step). Beyond the cap, hot records still hit the file but skip the
# buffer (counted in dropped_records()). "event"-kind records are exempt:
# they are rare and the metrics.events() contract depends on them.
_MAX_HOT_RECORDS = 100_000
_DROPPED = 0

# Optional observer of every emitted record (the flight recorder's ring,
# telemetry/flight.py). One slot, set/cleared whole — not a listener
# list: the hot path pays one global read when no tap is installed.
_TAP = None


def set_tap(fn) -> None:
    """Install (or with None clear) the single record tap. The tap runs
    outside the emit lock and must never raise into the caller."""
    global _TAP
    _TAP = fn


def enabled() -> bool:
    """The one hot-path guard: a plain module-global read."""
    return _ENABLED


def configure(enabled: bool | None = None, directory=None,
              rank: int | None = None) -> None:
    """Override the env-derived telemetry config (an app's --telemetry
    flag). `directory` is created on the spot — a misconfigured sink must
    fail at configure time, not silently drop every record later."""
    global _ENABLED, _DIR, _RANK
    with _LOCK:
        if directory is not None:
            _DIR = str(directory)
            os.makedirs(_DIR, exist_ok=True)
            if enabled is None:
                enabled = True
        if enabled is not None:
            _ENABLED = bool(enabled)
        if rank is not None:
            _RANK = int(rank)
    if _ENABLED and _DIR is not None:
        _emit_clock_anchor()


def _emit_clock_anchor() -> None:
    """One wall<->monotonic clock anchor per (sink, rank): the record's
    own header stamps `t` and `t_mono` back to back, and that pair is
    what the fleet trace merger aligns replica streams with
    (telemetry/tracing.py). Emitted outside configure()'s lock — emit()
    takes it. Streams that never pass through configure() (legacy
    env-only ranks) simply have no anchor; the merger warns on them."""
    key = (_DIR, rank())
    with _LOCK:
        if key in _ANCHORED:
            return
        _ANCHORED.add(key)
    emit("anchor", "clock.anchor", pid=os.getpid())


def rank() -> int:
    """The stamped rank: configure(rank=…) wins, else the launcher's
    RMT_PROCESS_ID contract, else torchrun's RANK, else 0 (one process).
    Two ranks must never share a stream file."""
    if _RANK is not None:
        return _RANK
    for var in ("RMT_PROCESS_ID", "RANK"):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                continue
    return 0


def directory() -> str | None:
    """The configured sink directory (None = in-process buffering only)."""
    return _DIR


def stream_path() -> str | None:
    """This rank's JSONL sink path, or None when no directory is set."""
    if _DIR is None:
        return None
    return os.path.join(_DIR, f"telemetry-rank{rank()}.jsonl")


def _write_line(line: str) -> None:
    path = stream_path()
    if path is None:
        return
    try:
        # Env-configured ranks (RMT_TELEMETRY_DIR, the launcher contract)
        # never call configure(), so the sink directory may not exist on
        # the first write — create it here, not just in configure().
        os.makedirs(_DIR, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")
    except OSError:
        pass  # telemetry must never be what kills a run


def emit(kind: str, name: str, *, buffer_always: bool = False,
         **fields) -> dict:
    """Stamp and record one event. Caller checks `enabled()` first for
    hot kinds; `buffer_always` is the "event"-kind back-compat carve-out
    (see module docstring)."""
    rec = {
        "v": SCHEMA_VERSION,
        "kind": kind,
        "name": name,
        "t": time.time(),
        "t_mono": time.perf_counter(),
        "rank": rank(),
    }
    rec.update(fields)
    global _DROPPED
    with _LOCK:
        if buffer_always:
            _RECORDS.append(rec)
        elif _ENABLED:
            if len(_RECORDS) < _MAX_HOT_RECORDS:
                _RECORDS.append(rec)
            else:
                _DROPPED += 1
        write = _ENABLED
    if write:
        # Outside the lock: each record is ONE write() of one line to an
        # O_APPEND stream, which the kernel appends atomically — holding
        # the lock over disk I/O would serialize every emitting thread
        # (launcher drains, supervisor events) behind each append and
        # skew the very intervals being recorded on a slow sink.
        _write_line(json.dumps(rec))
    tap = _TAP
    if tap is not None:
        try:
            tap(rec)
        except Exception:  # noqa: BLE001 — observability never kills a run
            pass
    return rec


def dropped_records() -> int:
    """Hot records that skipped the bounded in-process buffer (they were
    still written to the rank stream when a sink is configured)."""
    return _DROPPED


def counter(name: str, value, **attrs) -> dict | None:
    """Record a cumulative count (e.g. bytes moved, retries)."""
    if not _ENABLED:
        return None
    return emit("counter", name, value=value,
                **({"attrs": attrs} if attrs else {}))


def gauge(name: str, value, **attrs) -> dict | None:
    """Record a point-in-time measurement (e.g. Gpts/s of a finished run)."""
    if not _ENABLED:
        return None
    return emit("gauge", name, value=value,
                **({"attrs": attrs} if attrs else {}))


def record_event(name: str, *, attempt=None, step=None, wait_s=None,
                 error=None, **attrs) -> dict:
    """One structured run event (retry, restore, give-up…): the
    run-event schema, versioned and monotonic-stamped.

    Always buffered in-process (the `metrics.events()` contract); written
    to the rank stream when telemetry is enabled; best-effort teed to
    RMT_EVENT_LOG in the legacy line shape for existing tooling. Extra
    keyword attrs (the storage-fault records carry reasons and
    pruned-step lists) ride flat in the record, None-valued ones dropped
    like the named fields.
    """
    payload = {
        k: v
        for k, v in (("attempt", attempt), ("step", step),
                     ("wait_s", wait_s), ("error", error))
        if v is not None
    }
    payload.update({k: v for k, v in attrs.items() if v is not None})
    rec = emit("event", name, buffer_always=True, **payload)
    legacy_path = os.environ.get("RMT_EVENT_LOG")
    if legacy_path:
        legacy = {"kind": name, "t": rec["t"], "t_mono": rec["t_mono"],
                  "v": SCHEMA_VERSION, **payload}
        try:
            with open(legacy_path, "a") as fh:
                fh.write(json.dumps(legacy) + "\n")
        except OSError:
            pass
    return rec


def annotate(name: str, **attrs) -> dict | None:
    """Static metadata of a program: e.g. the bytes one halo exchange
    moves. The port's exchanges call it on every eager step and once per
    CUDA-graph capture (never at replay).

    Deduplicated per (name, attrs): "this exchange moves N bytes per
    invocation" is one fact, not one per step. Values must be hashable
    scalars for the same reason.
    """
    if not _ENABLED:
        return None
    key = (name, tuple(sorted(attrs.items())))
    with _LOCK:
        if key in _ANNOTATED:
            return None
        _ANNOTATED.add(key)
    return emit("trace", name, **({"attrs": attrs} if attrs else {}))


def annotate_once(token, name: str, make_attrs) -> dict | None:
    """`annotate(name, **make_attrs())` the first time `token` (any
    hashable the caller derives from its own cache key) is seen since the
    last full clear(): a hot path that annotates every call pays one set
    lookup, not the attrs' computation."""
    if not _ENABLED or token in _ANNOTATED:
        return None
    with _LOCK:
        _ANNOTATED.add(token)
    return annotate(name, **make_attrs())


def configure_from_env() -> None:
    """Re-read RMT_TELEMETRY / RMT_TELEMETRY_DIR: a process whose
    environment was set after this module was imported (a spawned rank
    of parallel/launcher.spawn_ranks) calls it once."""
    global _ENABLED, _DIR
    with _LOCK:
        _ENABLED = _env_enabled()
        _DIR = os.environ.get("RMT_TELEMETRY_DIR") or None
    if _ENABLED and _DIR is not None:
        _emit_clock_anchor()


def records(kind: str | None = None, name: str | None = None) -> list[dict]:
    """The in-process record buffer (optionally filtered)."""
    with _LOCK:
        out = list(_RECORDS)
    if kind is not None:
        out = [r for r in out if r["kind"] == kind]
    if name is not None:
        out = [r for r in out if r["name"] == name]
    return out


def clear(kind: str | None = None) -> None:
    """Drop the in-process buffer (tests; already-written JSONL files
    are untouched). With `kind`, only that kind's records are dropped —
    `metrics.clear_events()` clears kind="event" without losing buffered
    spans/gauges or the annotation dedup set (a cleared dedup set would
    re-emit once-per-program annotations). A full clear() also resets the dedup set and drop count."""
    global _DROPPED
    with _LOCK:
        if kind is None:
            _RECORDS.clear()
            _ANNOTATED.clear()
            _ANCHORED.clear()
            _DROPPED = 0
        else:
            _RECORDS[:] = [r for r in _RECORDS if r["kind"] != kind]


def clear_events() -> None:
    """THE public reset for the structured event trail: drops buffered
    "event"-kind records only — buffered spans/gauges and the
    trace-annotation dedup set survive (a cleared dedup set would
    re-emit once-per-program annotations). This is the one behavior
    behind `utils.metrics.clear_events()` (a deprecated alias) and the
    flight recorder's reset path (flight.reset)."""
    clear(kind="event")
