"""Elastic topology policy: the shrink/grow/give-up decisions, pluggable —
counterpart of rocm_mpi_tpu/resilience/policy.py, pure arithmetic.

When recovered devices rejoin the budget mid-run, should the run pay a
checkpoint-and-relaunch to use them? That is a policy question (a run 2
segments from completion should not; a serving layer may want the
devices for another tenant), so the decisions live in this object and
`run_elastic` only executes them. The default encodes the single-tenant
answer: always shrink to survive, grow whenever the budget allows and
hysteresis agrees, give up below `min_ranks`.

Hysteresis: topology changes are expensive (a checkpoint, a relaunch, a
recompile), so `min_grow_interval_steps` refuses a grow until the run
has advanced that many steps past the LAST topology change — a flapping
device that joins and dies every few seconds must not convert the run
into a relaunch loop. Growth happens only at segment boundaries by
construction: the grow path preempts the running ranks (SIGTERM,
resilience.preempt), and the preemption check lives at the segmented
loop's boundaries — there is no other place a rank can exit with a
durable, resumable step.

Shrink takes precedence over grow: a launch that FAILED (dead rank,
watchdog verdict, vanish) re-plans for the survivors even when the
nominal budget says more devices exist — the budget's claim is exactly
what the dead rank just disproved. Growth is only considered from a
healthy state: a completed-preempted launch, or the live rejoin probe.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ElasticPolicy:
    """Decision table for `resilience.elastic.run_elastic`.

    `min_ranks` — below this, a failure raises ElasticExhausted.
    `grow` — master switch for elastic growth (the rejoin probe and the
        post-preemption re-plan both consult it).
    `min_grow_interval_steps` — hysteresis: steps that must pass after a
        topology change before a grow is considered. 0 = any new
        segment boundary. When the current step is unknowable (no
        checkpoint_dir), a nonzero interval refuses the grow —
        hysteresis that cannot be evaluated must fail closed.
    `grow_poll_s` — rejoin-probe cadence while a launch is live.
    `max_preempt_resumes` — bound on preempted-relaunch cycles (an
        external SIGTERM storm must not loop forever).
    """

    min_ranks: int = 1
    grow: bool = True
    min_grow_interval_steps: int = 0
    grow_poll_s: float = 1.0
    max_preempt_resumes: int = 8

    def give_up(self, nprocs: int) -> bool:
        """A launch failed at `nprocs`: is there anywhere left to go?"""
        return nprocs <= self.min_ranks

    def shrink_target(self, nprocs: int, dead_count: int,
                      plan_ranks) -> int:
        """Rank count after a failure that killed `dead_count` ranks:
        the largest valid mesh over the SURVIVORS (never n-1 — a launch
        that lost two pods must not re-plan for a budget including one
        of them), floored at min_ranks. `plan_ranks(budget) -> int`
        maps a device budget to the largest valid mesh's rank count
        (identity when no global shape constrains it)."""
        budget = nprocs - max(dead_count, 1)
        return max(plan_ranks(max(budget, 1)), self.min_ranks)

    def wants_grow(self, nprocs: int, budget: int, *,
                   step: int | None = None,
                   last_change_step: int | None = None) -> bool:
        """Should the run grow onto `budget` devices? True only when
        growth is on, the budget actually exceeds the running rank
        count, and the hysteresis interval has provably passed."""
        if not self.grow or budget <= nprocs:
            return False
        if self.min_grow_interval_steps <= 0:
            return True
        if step is None:
            return False  # interval unknowable: fail closed
        since = last_change_step if last_change_step is not None else 0
        return step - since >= self.min_grow_interval_steps

    def grow_target(self, nprocs: int, budget: int, plan_ranks) -> int:
        """Rank count a grow relaunches on: the largest valid mesh
        within `budget`. May equal `nprocs` (budget grew but no bigger
        mesh tiles the grid) — the caller treats that as no grow."""
        return max(plan_ranks(max(budget, 1)), nprocs)


@dataclasses.dataclass
class RequestRetryPolicy:
    """The request plane's retry decision table (consumed by the
    serving layer).

    A transient batch-level failure (compile hiccup, storage flap on a
    session save, an injected `batch-error`) or a numerical failure
    (NaN/Inf lane) requeues the request a BOUNDED number of times with
    exponential backoff, instead of either dying on first fault or
    looping forever; a request that exhausts `budget` is quarantined —
    never requeued again — with its full record banked for offline
    repro. Per-request validation errors (unknown physics, a session
    past the requested nt) never retry: the request itself is wrong.

    `budget` — retries per request (0 = quarantine on first fault).
    `backoff_base_s` — first-retry delay; doubles per retry.
    `backoff_cap_s` — backoff ceiling (an eviction storm must not push
        a request's next try into next week).
    """

    budget: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0

    def __post_init__(self):
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff must be >= 0 seconds")

    def backoff_s(self, retries: int) -> float:
        """Delay before retry number `retries` (1-based)."""
        if retries < 1:
            return 0.0
        return min(
            self.backoff_base_s * 2.0 ** (retries - 1),
            self.backoff_cap_s,
        )


@dataclasses.dataclass
class CircuitPolicy:
    """Per-program-class (BinKey) circuit breaker thresholds
    (consumed by the serving layer).

    `k` consecutive batch failures in ONE program class open the
    breaker: requests in that class reject fast with `circuit-open`
    instead of burning lanes, batch retries, and the retry budgets of
    every co-batched tenant — one failing shape class can no longer
    starve every other tenant's throughput. After `cooldown_drains`
    drain passes the breaker goes half-open: exactly one probe request
    is re-admitted; success closes the breaker, failure re-opens it.
    `k <= 0` disables the breaker entirely.
    """

    k: int = 3
    cooldown_drains: int = 2

    def __post_init__(self):
        if self.cooldown_drains < 1:
            raise ValueError(
                f"cooldown_drains must be >= 1, got {self.cooldown_drains}"
            )

    @property
    def enabled(self) -> bool:
        return self.k > 0
