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

Overhead discipline: when telemetry is disabled, `span()` returns one
module-level no-op singleton — no allocation, no clock read, no lock;
`sp.sync(x)` then returns `x` without forcing (the run's correctness
never depends on the sync, only timing fidelity does). The disabled
cost is a function call and one global read, safe inside per-step loops.

Nesting is tracked per thread (a depth counter in threading.local), so
spans opened on other threads don't corrupt each other's stacks; the
emitted record carries `depth` and `tid`, which is all the Chrome-trace
exporter needs to nest slices on a rank's track.
"""

from __future__ import annotations

import threading
import time

from rocm_mpi_tpu_torch.telemetry import events, flight

_stack = threading.local()


def _depth() -> int:
    return getattr(_stack, "depth", 0)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    torch or CUDA is absent: the read side runs without either)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return False
    return bool(torch.cuda.is_current_stream_capturing())


class Span:
    """One open span; emitted as a single record at __exit__."""

    __slots__ = ("name", "attrs", "_t_wall", "_t_mono", "_depth", "_tid")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
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
        Raises while the current CUDA stream is capturing."""
        from rocm_mpi_tpu_torch.utils.metrics import force  # lazy: needs torch

        if _capturing():
            raise RuntimeError(
                f"span {self.name!r}: cannot sync while a CUDA graph is being "
                "captured; close the span outside the capture")
        return force(x)

    def __exit__(self, exc_type, exc, tb):
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
        return False


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
    name-prefix phase mapping (telemetry.aggregate.phase_of)."""
    if not events.enabled():
        return _NOOP
    return Span(name, attrs)


def span_record(name: str, t_wall: float, dur_s: float,
                error: str | None = None, **attrs) -> None:
    """Emit a span record for an interval timed by OTHER machinery
    (utils.metrics.Timer's labeled mode): the interval is already over,
    so it never passes through the nesting stack. `error` lands at the
    record's top level, matching Span.__exit__'s failed-body shape."""
    if not events.enabled():
        return
    fields = {"t": t_wall, "dur_s": dur_s, "depth": _depth(),
              "tid": threading.get_ident()}
    if error is not None:
        fields["error"] = error
    if attrs:
        fields["attrs"] = attrs
    events.emit("span", name, **fields)
