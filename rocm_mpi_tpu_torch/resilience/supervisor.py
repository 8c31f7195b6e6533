"""Supervised segmented runs: retry/backoff around checkpointed advance —
counterpart of rocm_mpi_tpu/resilience/supervisor.py (the same signature
plus the process grid, the same backoff schedule and events).

    state = run_supervised(advance, init_state, nt, directory, every)

is `utils/checkpoint.run_segmented` wrapped in a supervision loop:

  * a crash (any exception the policy classifies as retryable — CUDA and
    other runtime errors, storage errors, injected faults) re-resolves
    `latest_valid_step`, not merely the latest step: a crash mid-save
    leaves a torn checkpoint, which validation skips, falling back to the
    previous kept step;
  * the restart waits exponential-backoff long (base · factor**attempt,
    capped);
  * attempts are bounded; exhaustion re-raises the last failure after a
    "gave-up" event — a persistent failure never turns into silence;
  * every decision is a telemetry event ("attempt-failed", "backoff",
    "restored", "recovered", "gave-up").

Device state. `init_state` is both the cold-start state and the restore
template. A cold start hands the advance a fresh copy of it, so the
template stays valid whatever the advance does with its input; a restore
returns fresh tensors, which the scan driver copies into its slots
(utils/checkpoint.py). The advance is the same object on every attempt,
so a retry under the scan driver replays the graphs the first attempt
captured and captures none.

A sticky CUDA error (an illegal address, say) raises a RuntimeError on
every later call as well: it is retried like any RuntimeError, fails
every attempt, and the bound ends it with "gave-up" — the JAX package's
classification of XlaRuntimeError, kept.

Scope: this supervisor retries on the SAME process grid, right when the
failure was transient. When the topology itself died (a killed, stalled
or vanished rank) the launcher-level supervisor, resilience.elastic,
shrinks to the largest valid sub-grid and resumes there.
"""

from __future__ import annotations

import time

from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.utils import checkpoint as ckpt


def default_retryable(exc: BaseException) -> bool:
    """Crash classification: retry runtime, storage and injected
    failures; never retry programming errors (TypeError, ValueError, …),
    which reproduce identically, nor a SystemExit (a preemption exits
    resumable, it is not retried in place)."""
    from rocm_mpi_tpu_torch.resilience.faults import InjectedCrash

    if isinstance(exc, InjectedCrash):
        return True
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return False
    # torch raises its CUDA errors (torch.cuda.OutOfMemoryError,
    # torch.AcceleratorError) as RuntimeError subclasses; OSError covers
    # checkpoint I/O flaps.
    return isinstance(exc, (RuntimeError, OSError))


def _fresh(state):
    """A copy of `state` (a tensor or nested tuples/lists of tensors)."""
    if isinstance(state, (tuple, list)):
        return type(state)(_fresh(x) for x in state)
    return state.clone()


def run_supervised(
    advance,
    init_state,
    nt: int,
    directory,
    every: int,
    *,
    max_retries: int = 3,
    backoff_s: float = 0.5,
    backoff_factor: float = 2.0,
    backoff_max_s: float = 60.0,
    resume: bool = True,
    retryable=default_retryable,
    sleep=time.sleep,
    log=None,
    grid=None,
):
    """Run `nt` steps of `advance` with checkpointing every `every` steps
    under crash supervision; returns the final state.

    `init_state` is both the cold-start state and the restore template.
    With resume=True an existing valid checkpoint in `directory` is
    continued even on the first attempt, so a re-invoked process (a
    preempted rank relaunched) supervises seamlessly into the same run.

    `max_retries` bounds restarts (attempts = max_retries + 1);
    exhaustion re-raises the last exception after a "gave-up" event.
    `sleep` is injectable so tests assert the exponential schedule
    without waiting it out. `grid` is the run's process grid (every rank
    of it calls this; utils/checkpoint.py).
    """
    if max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {max_retries}")
    log = log or (lambda *_: None)

    def resolve_start():
        """(start_step, state) from the latest VALID checkpoint."""
        start = ckpt.latest_valid_step(directory, log=log, grid=grid)
        if start is None:
            return 0, _fresh(init_state)
        state = ckpt.restore_state(directory, start, init_state, grid=grid, log=log)
        telemetry.record_event("restored", step=start)
        log(f"supervisor: restored step {start} from {directory}")
        return start, state

    attempt = 0
    recovered = False
    while True:
        try:
            if resume or attempt > 0:
                start, state = resolve_start()
            else:
                start, state = 0, _fresh(init_state)
            if start >= nt:
                log(f"supervisor: checkpoint already at step {start} >= nt={nt}; nothing "
                    "to run")
                final = state
            else:
                final = ckpt.run_segmented(advance, state, nt, directory, every,
                                           start_step=start, grid=grid, log=log)
            if recovered:
                telemetry.record_event("recovered", attempt=attempt, step=nt)
            return final
        except BaseException as exc:  # noqa: BLE001 — classified below
            if not retryable(exc):
                raise
            err = f"{type(exc).__name__}: {exc}"
            telemetry.record_event("attempt-failed", attempt=attempt, error=err)
            log(f"supervisor: attempt {attempt} failed — {err}")
            if attempt >= max_retries:
                telemetry.record_event("gave-up", attempt=attempt, error=err)
                log(f"supervisor: giving up after {attempt + 1} attempts")
                raise
            wait = min(backoff_s * backoff_factor**attempt, backoff_max_s)
            telemetry.record_event("backoff", attempt=attempt, wait_s=wait)
            log(f"supervisor: retrying in {wait:.2f}s")
            sleep(wait)
            attempt += 1
            recovered = True
