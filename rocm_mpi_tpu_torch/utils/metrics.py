"""Wall-time timer and the performance metrics — counterpart of
rocm_mpi_tpu/utils/metrics.py.

The reference's one metric is the effective memory throughput
    T_eff = A_eff / wtime_it,  A_eff = 3 · n_cells · itemsize / 1e9 GB
(read T, read Cp, write T2), with wtime_it = wtime / (nt - warmup); the
headline Gpts/s = n_cells / wtime_it / 1e9 is the same measurement per
grid point. CUDA work is asynchronous, so the timer synchronises the
device before reading the host clock.

This module is also the telemetry's compatibility surface, as in the
JAX package: a labelled Timer feeds its interval into the telemetry
stream as a span, `timed_window` (the one window every model's run goes
through) emits the `step_window` span from the very clock reads that
give the run's wtime, and `record_event`/`events`/`clear_events` are a
thin shim over telemetry.events.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import torch

from rocm_mpi_tpu_torch.parallel import distributed
from rocm_mpi_tpu_torch.telemetry import events as _tel


def force(x):
    """Wait until the device work producing `x` is done (a no-op for CPU
    tensors, whose ops complete before returning)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


class Timer:
    """tic/toc wall-time timer (ImplicitGlobalGrid tic()/toc() analog),
    also a context manager:

        timer.tic(T)              # synchronise on T, then start
        T = advance(T, Cp, n)
        wtime = timer.toc(T)      # synchronise on T, then stop

    A `label` routes the measured interval into the telemetry stream as
    a span record (with `attrs`) when telemetry is on; as a context
    manager, a body that raises still records its interval, flagged with
    the exception's name. Unlabelled timers stay telemetry-silent.
    """

    def __init__(self, label: str | None = None, **attrs):
        self._t0 = None
        self._t0_wall = None
        self.elapsed = None
        self.label = label
        self.attrs = attrs

    def tic(self, *sync):
        """Start timing, after the device work behind `sync` is done."""
        for x in sync:
            force(x)
        self.elapsed = None
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()

    def toc(self, *sync) -> float:
        """Stop timing after the device work behind `sync`; returns seconds."""
        for x in sync:
            force(x)
        if self._t0 is None:
            raise RuntimeError("toc() before tic()")
        self.elapsed = time.perf_counter() - self._t0
        self._record()
        return self.elapsed

    def _record(self, error: str | None = None) -> None:
        if self.label is not None and _tel.enabled():
            from rocm_mpi_tpu_torch.telemetry.spans import span_record

            span_record(self.label, self._t0_wall, self.elapsed, error=error, **self.attrs)

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.elapsed is None and self._t0 is not None:
            if exc_type is None:
                self.toc()
            else:
                # No sync: there may be nothing coherent to sync on.
                self.elapsed = time.perf_counter() - self._t0
                self._record(error=exc_type.__name__)
        return False


def resolve_windows(config, nt: int | None = None,
                    warmup: int | None = None) -> tuple[int, int]:
    """(nt, warmup), each defaulting to the config's; a run needs
    0 <= warmup < nt."""
    nt = config.nt if nt is None else int(nt)
    warmup = config.warmup if warmup is None else int(warmup)
    if not 0 <= warmup < nt:
        raise ValueError(f"need 0 <= warmup < nt, got {warmup}, {nt}")
    return nt, warmup


def settle(x, sharded: bool = False, group=None) -> None:
    """Wait for the device work behind `x`, then, on a sharded grid, for
    every rank of `group` (None: the default group) at one barrier: the
    edge of a timed window."""
    force(x)
    if sharded:
        distributed.barrier(group)


def window_sizes(timed: int, windows: int, unit: int = 1) -> list[int]:
    """The steps of each window splitting `timed` steps: all of them in
    one for `windows` <= 1, else at most `windows` windows, each a
    multiple of `unit` (the scan driver's chunk q), the first ones a unit
    longer where they do not divide evenly."""
    if windows <= 1 or timed < 2 * unit:
        return [timed]
    n = min(int(windows), timed // unit)
    base, extra = divmod(timed // unit, n)
    return [(base + (1 if i < extra else 0)) * unit for i in range(n)]


def timed_window(advance, state, nt: int, warmup: int, sharded: bool = False,
                 group=None, windows: int = 1, unit: int = 1, on_boundary=None,
                 **span_attrs):
    """Run `advance(state, n) -> state` over the first `warmup` steps, then
    time it over the other nt - warmup: the device synchronised, and on a
    sharded grid every rank of `group` (None: the default group)
    barriered, on each side of the timed window. `state` is a tensor or a
    tuple led by one. Returns (state, seconds).

    `windows` > 1 splits the timed steps into that many windows
    (`window_sizes`: multiples of `unit`), each between its own sync and
    barrier; the seconds returned are their sum, so they carry a sync
    and a barrier a window and read slower than one window's.
    `on_boundary(state, step) -> state`, when given, runs once after the
    warmup with step None, before the steady-state window opens (its
    first call may build or load), then before every window with the
    steps run so far, outside the clock.

    With telemetry on, the warmup is a `warmup` span and every timed
    window a `step_window` span (phase "step", `steps`, `window` when
    there are several, and `span_attrs`: the JAX package's variant,
    driver and workload stamps), recorded from the same clock reads as
    the returned seconds, and the windows lie in one steady-state window
    of telemetry.compiles (unless one is open already): a build or
    capture inside it is a recompile. The flight recorder's step counter
    advances by the steps run so far at the start of each window, after
    `on_boundary` (the JAX weak-scaling app's order: a rank held at a
    boundary has not published the steps its peers publish there), and
    by the last window's at the end; its window counter by one at the
    start of each of several windows."""
    from rocm_mpi_tpu_torch.telemetry import compiles, flight
    from rocm_mpi_tpu_torch.telemetry.spans import span

    def lead(state):
        return state[0] if isinstance(state, tuple) else state

    with span("warmup", steps=warmup, **span_attrs) as sp:
        if warmup:
            state = advance(state, warmup)
        sp.sync(lead(state))
    if on_boundary is not None:
        state = on_boundary(state, None)
    label = "step_window" if _tel.enabled() else None
    sizes = window_sizes(nt - warmup, windows, unit)
    several = len(sizes) > 1
    steady = label is not None and not compiles.steady_marked()
    if steady:
        compiles.mark_steady()
    wtime = 0.0
    done = unpublished = warmup
    try:
        for i, steps in enumerate(sizes):
            if on_boundary is not None:
                state = on_boundary(state, done)
            flight.progress(step_inc=unpublished, **({"windows": 1} if several else {}))
            timer = Timer(label, phase="step", steps=steps,
                          **({"window": i} if several else {}), **span_attrs)
            settle(lead(state), sharded, group)
            timer.tic()
            state = advance(state, steps)
            settle(lead(state), sharded, group)
            wtime += timer.toc()
            done += steps
            unpublished = steps
    finally:
        if steady:
            compiles.unmark_steady()
    flight.progress(step_inc=unpublished)
    return state, wtime


def wtime_per_it(wtime: float, nt: int, warmup: int = 10) -> float:
    """wtime_it = wtime / (nt - warmup)."""
    if nt <= warmup:
        raise ValueError(f"nt={nt} must exceed warmup={warmup}")
    return wtime / (nt - warmup)


def a_eff_gb(shape, itemsize: int, n_passes: int = 3) -> float:
    """A_eff in GB: n_passes whole-array memory passes per step."""
    return n_passes / 1e9 * math.prod(shape) * itemsize


def t_eff_gbs(shape, itemsize: int, wtime_it: float, n_passes: int = 3) -> float:
    """Effective memory throughput T_eff [GB/s]."""
    return a_eff_gb(shape, itemsize, n_passes) / wtime_it


def gpts_per_s(shape, wtime_it: float) -> float:
    """Grid points processed per second [Gpts/s]."""
    return math.prod(shape) / wtime_it / 1e9


# ---------------------------------------------------------------------------
# Structured run events — the JAX package's compatibility shim over
# telemetry.events (the same RunEvent view and the same records).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunEvent:
    """One structured run event (retry, restore, give-up...)."""

    kind: str            # e.g. "attempt-failed", "backoff", "restored"
    t: float             # wall time at emission (comparable across ranks)
    attempt: int | None = None
    step: int | None = None
    wait_s: float | None = None
    error: str | None = None
    t_mono: float | None = None  # monotonic stamp (ordering within a rank)
    v: int = _tel.SCHEMA_VERSION

    def to_json(self) -> str:
        return json.dumps({k: v for k, v in dataclasses.asdict(self).items()
                           if v is not None})


def _as_run_event(rec: dict) -> RunEvent:
    return RunEvent(kind=rec["name"], t=rec["t"], attempt=rec.get("attempt"),
                    step=rec.get("step"), wait_s=rec.get("wait_s"), error=rec.get("error"),
                    t_mono=rec.get("t_mono"), v=rec.get("v", _tel.SCHEMA_VERSION))


def record_event(kind: str, *, attempt=None, step=None, wait_s=None,
                 error=None) -> RunEvent:
    """Append a structured event (telemetry stream + RMT_EVENT_LOG tee)."""
    rec = _tel.record_event(kind, attempt=attempt, step=step, wait_s=wait_s, error=error)
    return _as_run_event(rec)


def events(kind: str | None = None) -> list[RunEvent]:
    """The in-process event trail (optionally filtered by kind)."""
    return [_as_run_event(r) for r in _tel.records(kind="event", name=kind)]


def clear_events() -> None:
    """Deprecated alias for `telemetry.clear_events()` (events dropped;
    buffered spans/gauges and the annotation dedup state kept)."""
    import warnings

    warnings.warn("utils.metrics.clear_events() is deprecated; call "
                  "telemetry.clear_events()", DeprecationWarning, stacklevel=2)
    _tel.clear_events()
