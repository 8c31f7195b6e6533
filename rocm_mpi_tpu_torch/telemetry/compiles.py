"""Compile observability — counterpart of rocm_mpi_tpu/telemetry/compiles.py:
count what the port compiles, per program, and pin "zero recompiles
after warmup", under the JAX package's gauge names.

The JAX package counts XLA backend compiles. The port has three things
that cost compile-like wall time, each recorded at its one choke point:

* an nvcc build of a kernel library (ops/_build.py `build`): a compile
  and a cache miss, program "nvcc:<library>";
* a load of a library already built on disk (ops/_build.py `load`
  finding the `.so`): a cache hit, no compile;
* a CUDA-graph capture (models/scan.py `ScanLoop._capture`, one record
  per graph): a compile, program "graph:<loop label>";
* the build of a serving program class (serving/service.py
  `_program_for`: the batched advance of one (bin key, width)): a
  compile, program "serve:<program key>".

Every compile lands in the per-program table and, when telemetry is on,
as a `compile.backend` span (phase "compile"), as in the JAX package;
the totals keep the JAX package's keys (`backend_compiles`,
`cache_hits`, `cache_misses`).

Steady state: `mark_steady()` draws the line after a run's warmup (the
timed window of utils/metrics.timed_window opens one; the weak-scaling
app one per rung). Every compile after the mark is a RECOMPILE —
`steady_state()` returns the count and `emit_gauges()` banks it as
`compiles.steady_state`, which the regress gate treats as
lower-is-better with a meaningful zero. A run whose warmup is 0 captures
its graphs inside its timed window: those captures are what this gauge
shows.

No fabricated zeros: `emit_gauges` stays silent until `install()` ran or
something was recorded, and `compiles.steady_state` is emitted only once
a steady window was ever opened. stdlib-only; recording is a counter
bump whether or not telemetry is on.
"""

from __future__ import annotations

import threading
import time

from rocm_mpi_tpu_torch.telemetry import events
from rocm_mpi_tpu_torch.telemetry.spans import span_record

_LOCK = threading.Lock()
_MODE: str | None = None
_PROGRAMS: dict[str, dict] = {}   # name -> {"count", "wall_s", "steady"}
_TOTALS = {"backend_compiles": 0, "cache_hits": 0, "cache_misses": 0}
_STEADY_MARKED = False
_STEADY_EVER = False
_STEADY_RECOMPILES = 0


def install() -> str:
    """Arm the accounting (idempotent; returns the mode, "named": every
    record names its program). The port's build and capture sites record
    themselves, so there is no listener to install; this marks that the
    run measures compiles, so that its zeros are measurements."""
    global _MODE
    _MODE = "named"
    return _MODE


def _record_compile(prog: str, dur_s: float) -> None:
    global _STEADY_RECOMPILES
    with _LOCK:
        row = _PROGRAMS.setdefault(prog, {"count": 0, "wall_s": 0.0, "steady": 0})
        row["count"] += 1
        row["wall_s"] += float(dur_s)
        _TOTALS["backend_compiles"] += 1
        steady = _STEADY_MARKED
        if steady:
            row["steady"] += 1
            _STEADY_RECOMPILES += 1
    if events.enabled():
        span_record("compile.backend", time.time() - dur_s, dur_s,
                    phase="compile", program=prog, steady=steady)


def record_build(library: str, seconds: float) -> None:
    """An nvcc build of `library`: a cache miss and a compile."""
    with _LOCK:
        _TOTALS["cache_misses"] += 1
    _record_compile(f"nvcc:{library}", seconds)


def record_load_hit() -> None:
    """A load of a library from a `.so` already on disk: a cache hit."""
    with _LOCK:
        _TOTALS["cache_hits"] += 1


def record_capture(label: str, seconds: float) -> None:
    """One CUDA graph captured by a loop labelled `label`: a compile."""
    _record_compile(f"graph:{label}", seconds)


def record_program(label: str, seconds: float) -> None:
    """The build of a serving program class `label`: a compile."""
    _record_compile(label, seconds)


def mark_steady() -> None:
    """Open a steady-state window: every compile until `unmark_steady()`
    is a recompile the steady-state gauge counts. Windows accumulate: a
    weak-scaling ladder opens one per rung's timed loop."""
    global _STEADY_MARKED, _STEADY_EVER
    with _LOCK:
        _STEADY_MARKED = True
        _STEADY_EVER = True


def unmark_steady() -> None:
    """Close the current steady-state window."""
    global _STEADY_MARKED
    with _LOCK:
        _STEADY_MARKED = False


def steady_marked() -> bool:
    return _STEADY_MARKED


def steady_state() -> int:
    """Compiles since mark_steady(): the recompiles after warmup, 0 in a
    healthy steady state."""
    return _STEADY_RECOMPILES


def snapshot() -> dict:
    """The full compile accounting (the JAX package's keys)."""
    with _LOCK:
        return {
            "mode": _MODE,
            "programs": {k: dict(v) for k, v in _PROGRAMS.items()},
            "totals": dict(_TOTALS),
            "steady_marked": _STEADY_MARKED,
            "steady_ever_marked": _STEADY_EVER,
            "steady_recompiles": _STEADY_RECOMPILES,
        }


def emit_gauges() -> None:
    """Bank the compile accounting into the telemetry stream:
    `compiles.total`, `compiles.cache_misses`, `compiles.steady_state`
    (once a window was ever opened) and one `compiles.program`
    annotation per program. Call at the end of the measured window,
    before deliberately-compiled tooling (the phase probes)."""
    if not events.enabled():
        return
    with _LOCK:
        total = _TOTALS["backend_compiles"]
        misses = _TOTALS["cache_misses"]
        ever_marked = _STEADY_EVER
        steady = _STEADY_RECOMPILES
        per_program = {k: v["count"] for k, v in _PROGRAMS.items()}
    if _MODE is None and not total and not misses:
        # Nothing armed and nothing recorded: zeros here would be
        # fabrication, not measurement.
        return
    events.gauge("compiles.total", total)
    events.gauge("compiles.cache_misses", misses)
    if ever_marked:
        events.gauge("compiles.steady_state", steady)
    for prog, count in sorted(per_program.items()):
        events.annotate("compiles.program", program=prog, count=count)


def reset() -> None:
    """Test isolation: drop the accounting and the armed mode."""
    global _MODE, _STEADY_MARKED, _STEADY_EVER, _STEADY_RECOMPILES
    with _LOCK:
        _MODE = None
        _PROGRAMS.clear()
        _TOTALS.update(backend_compiles=0, cache_hits=0, cache_misses=0)
        _STEADY_MARKED = False
        _STEADY_EVER = False
        _STEADY_RECOMPILES = 0
