"""Preemption-aware shutdown: SIGTERM with a grace deadline — counterpart
of rocm_mpi_tpu/resilience/preempt.py (the same exit code, environment
variable and budget rule).

Production schedulers do not kill a pod outright — they send SIGTERM
and give it a grace window (Kubernetes `terminationGracePeriodSeconds`,
Slurm `--signal=TERM@grace`, Borg eviction notices), then SIGKILL. A
rank that ignores the notice loses everything since its last completed
save; a rank that panics and STARTS a save it cannot finish leaves a
torn step dir for the next resume to trip over. This module is the
deadline-aware middle path:

 1. `install()` registers a SIGTERM handler (signal handlers are
    installed here and nowhere else in the port; neither torch nor NCCL
    owns SIGTERM, so the handler sees every notice). The handler is
    async-signal-minimal: it stamps the request time and the grace
    deadline into module state and returns. It deliberately does NOT
    touch telemetry — the events layer takes a lock, and a signal
    arriving while the main thread holds that very lock would deadlock
    the interpreter. The first boundary that *notices* the request
    emits the `preempt.noticed` event instead.
 2. The segmented checkpoint loop (utils.checkpoint.run_segmented)
    polls `requested()` at every segment boundary — the only place the
    state is whole and quiescent — and makes the deadline call:
    save if the telemetry-measured p90 save wall (times a safety
    factor) fits the remaining grace, else SKIP the save entirely and
    rely on the last valid step. A save that would be SIGKILLed
    mid-write is worse than no save: it burns the grace AND leaves a
    torn artifact.
 3. Either way the rank exits `RC_PREEMPTED` (75, EX_TEMPFAIL: "try
    again later") via the `Preempted` SystemExit subclass — a rc the
    supervisors upstack classify as RESUMABLE: `run_supervised` never
    retries a SystemExit, and `resilience.elastic._judge` reports a
    launch whose only nonzero rcs are RC_PREEMPTED as "preempted", to
    be relaunched/resumed (or grown — the elastic rejoin probe delivers
    SIGTERM on purpose), never shrunk or given up on.

Multi-rank note: the port's segmented loop agrees the decision over the
grid at every boundary (one gather of each rank's request, remaining
grace and p90 save wall): the grid stops when any rank holds a notice,
and saves only when the tightest rank's grace fits the slowest rank's
p90. A notice that reached the ranks a boundary apart therefore never
strands a saver in the collective save that its peers skipped. Ranks
that armed no handler (RMT_PREEMPT_GRACE_S unset, which the launcher
gives every rank alike) skip that gather: no notice can reach them.

stdlib-only; `requested()` is one module-global read on the hot path.
"""

from __future__ import annotations

import os
import signal
import time

RC_PREEMPTED = 75  # EX_TEMPFAIL: resumable interruption, not a failure
ENV_GRACE = "RMT_PREEMPT_GRACE_S"
DEFAULT_GRACE_S = 30.0

# The emergency-save budget call: the p90 save wall must fit the
# remaining grace with this much headroom (saves have tails), and with
# no history at all only a comfortably long grace may gamble on a save.
SAFETY_FACTOR = 1.5
NO_HISTORY_FLOOR_S = 10.0

_ARMED = False
_GRACE_S: float | None = None
_REQUESTED_MONO: float | None = None
_DEADLINE_MONO: float | None = None
_NOTICED = False
_PREV_HANDLER = None


class Preempted(SystemExit):
    """The preemption exit: code RC_PREEMPTED so every supervisor
    upstack can tell 'resumable, scheduler took the machine' from a
    failure. `step` is the last DURABLE step (the one a resume will
    restore); `saved` says whether the emergency save landed."""

    def __init__(self, step=None, saved: bool = False):
        super().__init__(RC_PREEMPTED)
        self.step = step
        self.saved = saved


def _handler(signum, frame) -> None:
    # Async-signal-minimal on purpose: stamp state, return. No locks, no
    # telemetry, no I/O — the interrupted main thread may hold any of
    # those locks (module docstring).
    global _REQUESTED_MONO, _DEADLINE_MONO
    if _REQUESTED_MONO is None:
        _REQUESTED_MONO = time.monotonic()
        _DEADLINE_MONO = _REQUESTED_MONO + (_GRACE_S or 0.0)


def install(grace_s: float | None = None) -> bool:
    """Register the SIGTERM grace-deadline handler. `grace_s` is the
    scheduler's promised window between SIGTERM and SIGKILL (default:
    RMT_PREEMPT_GRACE_S, else 30 s). Returns whether the handler is
    armed (False on platforms without SIGTERM or off the main thread —
    preemption awareness degrades to the legacy die-on-TERM, never to
    an error)."""
    global _ARMED, _GRACE_S, _PREV_HANDLER
    if not hasattr(signal, "SIGTERM"):
        return False
    if grace_s is None:
        raw = os.environ.get(ENV_GRACE, "").strip()
        try:
            grace_s = float(raw) if raw else DEFAULT_GRACE_S
        except ValueError:
            grace_s = DEFAULT_GRACE_S
    _GRACE_S = max(float(grace_s), 0.0)
    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):  # not the main thread / exotic platform
        return False
    if not _ARMED:
        _PREV_HANDLER = prev
    _ARMED = True
    return True


def install_from_env() -> bool:
    """Arm the handler when the launcher contract says so
    (RMT_PREEMPT_GRACE_S set — spawn_app_ranks forwards it); cheap no-op
    otherwise. Workers call this once at startup."""
    raw = os.environ.get(ENV_GRACE, "").strip()
    if not raw:
        return False
    try:
        grace = float(raw)
    except ValueError:
        return False
    return install(grace)


def uninstall() -> None:
    """Restore the pre-install SIGTERM disposition and clear the
    request state (tests; also the forwarder's restore path)."""
    global _ARMED, _PREV_HANDLER
    if _ARMED and hasattr(signal, "SIGTERM"):
        try:
            signal.signal(signal.SIGTERM, _PREV_HANDLER or signal.SIG_DFL)
        except (ValueError, OSError):
            pass
    _ARMED = False
    _PREV_HANDLER = None
    reset()


def reset() -> None:
    """Clear a pending request (tests, and a supervisor that consumed
    the preemption and is deliberately carrying on)."""
    global _REQUESTED_MONO, _DEADLINE_MONO, _NOTICED
    _REQUESTED_MONO = None
    _DEADLINE_MONO = None
    _NOTICED = False


def request(grace_s: float | None = None) -> None:
    """Raise the preemption flag WITHOUT a signal — the drill hook (and
    the only path on platforms with no SIGTERM). Same semantics as the
    handler: first request wins, deadline = now + grace."""
    global _GRACE_S
    if grace_s is not None:
        _GRACE_S = max(float(grace_s), 0.0)
    elif _GRACE_S is None:
        _GRACE_S = DEFAULT_GRACE_S
    _handler(None, None)


def requested() -> bool:
    """Has a preemption notice arrived? One module-global read."""
    return _REQUESTED_MONO is not None


def armed() -> bool:
    """Is this process's SIGTERM handler installed? One module-global
    read."""
    return _ARMED


def remaining_grace_s() -> float | None:
    """Seconds left before the scheduler's SIGKILL (negative once the
    deadline passed); None while no preemption is pending."""
    if _DEADLINE_MONO is None:
        return None
    return _DEADLINE_MONO - time.monotonic()


def budget_allows_save(save_wall_p90_s: float | None,
                       remaining_s: float | None = None) -> bool:
    """The emergency-save decision: does the measured p90 save wall
    (with SAFETY_FACTOR headroom) fit the remaining grace? With no
    save history only a grace above NO_HISTORY_FLOOR_S gambles on a
    save. True when no preemption is pending (a normal save).
    `remaining_s` replaces this process's grace left (the segmented loop
    passes its grid's least)."""
    rem = remaining_grace_s() if remaining_s is None else remaining_s
    if rem is None:
        return True
    if save_wall_p90_s is None:
        return rem >= NO_HISTORY_FLOOR_S
    return rem >= save_wall_p90_s * SAFETY_FACTOR


def note_noticed() -> bool:
    """First-notice latch: True exactly once per request, so the
    boundary that first observes the preemption can emit the
    `preempt.noticed` telemetry event the handler itself must not."""
    global _NOTICED
    if not requested() or _NOTICED:
        return False
    _NOTICED = True
    return True


def install_forwarder(procs) -> object:
    """Parent-side preemption forwarding (the launcher seam): when the
    LAUNCHER gets the scheduler's SIGTERM, every live rank must see it
    too — they hold the state. Registers a SIGTERM handler that stamps
    the parent's own request state (so run_elastic knows the whole job
    is being evicted, not one rank) and relays SIGTERM to every live
    proc in `procs`. Returns a zero-arg restore callable; the argv
    launcher (parallel/launcher.spawn_app_ranks) calls it on every exit
    path. Signal-handler installation lives here; the launcher only
    sends signals."""
    if not hasattr(signal, "SIGTERM"):
        return lambda: None

    def _forward(signum, frame):
        _handler(signum, frame)
        for p in procs:
            try:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            except OSError:
                pass

    try:
        prev = signal.signal(signal.SIGTERM, _forward)
    except (ValueError, OSError):
        return lambda: None

    def restore():
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, OSError):
            pass

    return restore
