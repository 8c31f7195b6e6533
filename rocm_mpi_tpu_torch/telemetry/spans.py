"""Nestable walltime spans with device-correct sync — counterpart of
rocm_mpi_tpu/telemetry/spans.py.

    with span("halo.probe", phase="halo", bytes=n) as sp:
        out = probe(state)
        sp.sync(out)        # truly wait before the span closes

Sync discipline: `sp.sync(x)` routes through `utils.metrics.force`
(`torch.cuda.synchronize` for a CUDA tensor): CUDA launches are
asynchronous, so a span that closes without syncing times only the
launches. While the current stream is capturing a CUDA graph, `sync`
raises: a synchronize inside a capture would break it, and skipping the
sync would silently mistime the span.

Overhead discipline: when telemetry is disabled and no profiler
records, `span()` returns one module-level no-op singleton — no
allocation, no clock read, no lock; `sp.sync(x)` then returns `x`
without forcing (the run's correctness never depends on the sync, only
timing fidelity does). The disabled cost is a function call, one global
read and the profiler check below, safe inside per-call paths.

Two sinks: with telemetry on, the JSONL record above; while a
torch.profiler session records (an app's --profile, a benchmark's traced
slice), a `torch.profiler.record_function` range over the span's
lifetime, whether telemetry is on or not, so the span lands in the
profiler's Chrome trace as a `user_annotation` on the clock of the
kernels it launches. With only the profiler on, nothing is written to
the stream and `sync` does not force. The profiler check reads torch
from sys.modules (the module stays importable without torch) and makes
one C call; `record_function` itself is opened only under a profiler,
where it is the profiler's cost.

Nesting is tracked per thread (a depth counter in threading.local), so
spans opened on other threads don't corrupt each other's stacks; the
emitted record carries `depth` and `tid`, which is all the Chrome-trace
exporter needs to nest slices on a rank's track.
"""

from __future__ import annotations

import sys
import threading
import time

from rocm_mpi_tpu_torch.telemetry import events, flight

_stack = threading.local()


def _depth() -> int:
    return getattr(_stack, "depth", 0)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    torch or CUDA is absent: the read side runs without either)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return False
    return bool(torch.cuda.is_current_stream_capturing())


# torch.autograd._profiler_enabled, bound by the first _profiling() after
# torch's import: whether a torch.profiler session records, one C call.
_profiler_enabled = None


def _profiling() -> bool:
    """Whether a torch.profiler session records on this process (False
    while torch is not imported: no profiler records without it)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


class Span:
    """One open span: a single JSONL record at __exit__ when telemetry is
    on, and a torch.profiler range for its lifetime while a profiler
    session records."""

    __slots__ = ("name", "attrs", "_emit", "_range", "_t_wall", "_t_mono", "_depth", "_tid")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._emit = events.enabled()
        self._range = (sys.modules["torch"].autograd.profiler.record_function(name)
                       if _profiling() else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if not self._emit:
            return self
        self._depth = _depth()
        _stack.depth = self._depth + 1
        self._tid = threading.get_ident()
        if flight.enabled():
            # Entry note BEFORE the clock reads: a rank that wedges
            # inside this span never reaches __exit__'s record, and the
            # flight recorder's "last phase entered" must already say so
            # (heartbeat sidecar, telemetry/flight.py).
            flight.enter_phase(self.name, self.attrs)
        self._t_wall = time.time()
        self._t_mono = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span (byte counts, step ids)."""
        self.attrs.update(attrs)
        return self

    def sync(self, x):
        """Truly wait for `x` (the device work behind it) and return it.
        Raises while the current CUDA stream is capturing. Returns `x`
        without forcing where no record is written (the profiler's range
        alone)."""
        if not self._emit:
            return x
        from rocm_mpi_tpu_torch.utils.metrics import force  # lazy: needs torch

        if _capturing():
            raise RuntimeError(
                f"span {self.name!r}: cannot sync while a CUDA graph is being "
                "captured; close the span outside the capture")
        return force(x)

    def __exit__(self, exc_type, exc, tb):
        if self._emit:
            self._record(exc_type)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False

    def _record(self, exc_type) -> None:
        dur = time.perf_counter() - self._t_mono
        _stack.depth = self._depth
        fields = {
            "t": self._t_wall,
            "dur_s": dur,
            "depth": self._depth,
            "tid": self._tid,
        }
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        if self.attrs:
            fields["attrs"] = self.attrs
        events.emit("span", self.name, **fields)


class _NoopSpan:
    """The disabled-mode singleton: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self

    def sync(self, x):
        return x


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span named `name` (dotted, phase-prefixed: "halo.probe",
    "checkpoint.save", "step_window"). Returns a context manager; the
    record is emitted when the span closes. A `phase=` attr overrides the
    name-prefix phase mapping (telemetry.aggregate.phase_of). While a
    torch.profiler session records, the span is also a record_function
    range of the same name; with neither telemetry nor a profiler on,
    the no-op singleton."""
    # events.enabled() read as its global, and the bound profiler check
    # called directly once bound: with both off, this line is the whole
    # cost of a span.
    if events._ENABLED or (_profiler_enabled or _profiling)():
        return Span(name, attrs)
    return _NOOP


def span_record(name: str, t_wall: float, dur_s: float,
                error: str | None = None, **attrs) -> None:
    """Emit a span record for an interval timed by OTHER machinery
    (utils.metrics.Timer's labeled mode): the interval is already over,
    so it never passes through the nesting stack. `error` lands at the
    record's top level, matching Span.__exit__'s failed-body shape.
    JSONL only: an interval timed after the fact opens no profiler
    range."""
    if not events.enabled():
        return
    fields = {"t": t_wall, "dur_s": dur_s, "depth": _depth(),
              "tid": threading.get_ident()}
    if error is not None:
        fields["error"] = error
    if attrs:
        fields["attrs"] = attrs
    events.emit("span", name, **fields)
