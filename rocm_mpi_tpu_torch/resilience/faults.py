"""Deterministic fault injection — counterpart of
rocm_mpi_tpu/resilience/faults.py, with the same grammar, kinds, sites,
exit codes and environment variable.

Failure must be injectable, deterministically, at the exact points the
resilience plane defends, or its recovery paths stay untested until a
real outage tests them.

A fault plan is a comma-separated spec, from the `--inject-fault` app
flag or the RMT_INJECT_FAULT env var (the launcher forwards it to every
rank):

    crash@step=K            raise InjectedCrash at the step-K fault point
    crash@segment=N         raise at the Nth completed segment (1-based)
    kill@step=K             os._exit(RC_INJECTED_KILL) at step K — the
                            no-cleanup SIGKILL analog (mid-collective
                            peers are left hanging; the launcher's
                            first-failure reporting is the defense)
    die@step=K              os._exit(0) at step K — the rank VANISHES
                            with a clean exit code: no crash, no
                            post-mortem, no nonzero rc for the
                            launcher's first-failure scan to see. The
                            preempted-pod / evicted-container analog,
                            distinct from `kill` (nonzero rc) and
                            `stall` (still alive). Only the launcher's
                            vanish detection (spawn_app_ranks
                            vanish_grace_s) and the elastic supervisor
                            (resilience/elastic.py)
                            handle it
    truncate-latest         after the next completed save, truncate the
                            largest file of the newest checkpoint step
    delay=S@step=K          sleep S seconds at step K (flapping-tunnel
                            stall analog; exercises heartbeat reporting)
    stall@step=K            block FOREVER in a time.monotonic busy-wait
                            at step K — the wedged-in-a-collective
                            analog. Unlike `delay` it never resumes, so
                            it is the only kind that exercises the
                            health-plane watchdog's full detect → dump →
                            kill path (parallel/launcher.py): the
                            stalled rank stops bumping its flight
                            recorder while its peers advance and then
                            wedge behind it
    io-error@step=K         raise OSError(EIO) at the step-K save
                            attempt — the flaky-storage analog the
                            checkpoint retry/backoff and degraded mode
                            defend (utils/checkpoint.py). Fires at the
                            "save" site by default (see below)
    io-slow=S@step=K        sleep S seconds inside the step-K save
                            attempt (default 2.0 s when the duration is
                            omitted) — trips the slow-write watchdog
                            (StoragePolicy.slow_save_timeout_s) without
                            failing the save
    enospc@step=K           raise OSError(ENOSPC) at the step-K save
                            attempt — exercises the keep-list pruning
                            path before the save gives up

Serving-plane kinds (the JAX package's serving layer consumes them through
`serving_fault`; the port parses and matches them the same way), never by
the raising `fault_point` below — the caller interprets the clause):

    lane-nan@request=N      poison the lane carrying the Nth SUBMITTED
                            request (1-based ticket ordinal) with NaN
                            initial state — the numerical-poison drill:
                            the per-lane finiteness reduction must fail
                            ONLY that ticket, and `times=` large enough
                            to outlast the retry budget drives it into
                            quarantine
    batch-error@step=N      the Nth EXECUTED batch raises a transient
                            batch-level error before dispatch — the
                            retry-budget/backoff drill (times=1 makes
                            the first retry succeed; consecutive clauses
                            open the circuit breaker)
    slow-batch=S@step=N     sleep S seconds inside the Nth executed
                            batch (default 0.5 s) — the straggler-batch
                            analog that makes co-batched tenants miss
                            deadlines they'd otherwise clear
    queue-flood=M@step=N    at the Nth DRAIN boundary the driver
                            (apps/soak.py) submits M synthetic requests
                            at once (default 16) — the admission-
                            control drill: a bounded queue must reject
                            the overflow fast with a retry-after hint

Fleet-plane kinds (the fleet router's drive loop consumes them through
`replica_fault`, never by the raising
`fault_point` — `rank=` names the REPLICA id, not a process rank):

    replica-kill@step=K,rank=R   at the Kth fleet drive tick, replica
                            R dies without cleanup (the SIGKILL /
                            rc-75 / watchdog-verdict analog): its
                            queue counters are gone, and only the
                            router's ticket journal can prove what it
                            owed — the replay-reconciliation drill
    replica-stall@step=K,rank=R  at the Kth drive tick replica R stops
                            making progress but stays up — the
                            wedged-replica analog: the router's health
                            view must DEMOTE it (no new routes) and
                            re-route its pending tickets exactly as
                            for a kill, while its frozen state stays
                            readable

The infrastructure kinds compose with serving through the opt-in
`serve-batch` site: `kill@step=2,rank=1,at=serve-batch` kills rank 1
before the 2nd batch's collectives (step = the service's global batch
ordinal; the flight-recorder step bump happens AFTER this fault point,
so a stalled rank is named BY PROGRESS exactly as in the segment-pre
drill).

Storage kinds re-fire per ATTEMPT: the save retry loop re-runs the
"save" fault point, so a clause with `times=N` (see below) can defeat N
attempts — `io-error@step=8,times=3` exhausts a 2-retry save and drives
the run into degraded mode, while the default times=1 makes the FIRST
retry succeed (the transient-flap drill). An outage spanning several
saves is several clauses: `io-error@step=8,times=3;io-error@step=12,
times=3`. NOTE the SPMD hazard: a save is collective — storage clauses
in multi-rank drills should stay UNSCOPED (every rank injects the same
decision at the same step) so no rank enters a save barrier its peers
skipped; rank= scoping of storage kinds is for single-rank drills.

Any clause may be re-armed with `times=N` (fire up to N times instead
of the default once) and rank-scoped with `rank=R`:

    kill@step=4,rank=1      only process R injects (other ranks run clean)

and site-scoped with `at=SITE` (SITE = an instrumented fault-point name
below). An unscoped clause fires at the FIRST site that matches its
step — the legacy semantics; `at=` pins it to one site when the same
step count passes several. The elastic stall drill needs this:

    stall@step=8,rank=1,at=segment-pre

wedges rank 1 after the segment's collectives but BEFORE its progress
bump and the save barrier, so its peers bump PAST it and the watchdog's
stalled-vs-median signature names the right victim (an unscoped stall
at the post-save "segment" site freezes every peer inside the next
segment's collective at the same counter — the coordinated-slowness
shape the watchdog deliberately never flags).

Every trigger is exact-match ("crash at step K", not "at or after"):
a supervisor retry that re-runs past the same step must NOT re-fire the
fault, so `fault_point` arms each clause at most MAX_FIRES times per
process (default once). Determinism is the whole point: no randomness,
no wall-clock dependence (delays excepted, by definition).

Instrumented fault points:
    "segment"  — utils/checkpoint.run_segmented, after each completed
                 save (step = absolute step count, directory = ckpt dir)
    "segment-pre" — utils/checkpoint.run_segmented, after a segment's
                 advance but BEFORE the flight-recorder step bump and
                 the save (same step count the following save will
                 carry). OPT-IN: only `at=segment-pre` clauses fire
                 here — unscoped step clauses keep firing at the
                 post-save "segment" site exactly as before this site
                 existed, so legacy specs are unchanged
    "init"     — parallel/distributed.maybe_initialize_distributed,
                 before the process group forms (step = None)
    "window"   — utils/metrics.timed_window (the weak-scaling app's
                 windowed rungs, which pass a heartbeat), at each
                 window boundary AFTER the halo heartbeat probe and
                 BEFORE the flight-recorder step bump (step = steps
                 completed so far) — the ordering the health-plane
                 watchdog drill relies on (telemetry/health.py)
    "step"     — parallel/halo.HostStagedStepper.run, before each
                 host-staged step (step = 1-based step index)
    "save"     — utils/checkpoint, inside every save ATTEMPT (retries
                 re-fire it) before any shard is written, so an
                 injected failure never leaves a partial step dir
                 (step = the step being saved). OPT-IN like
                 segment-pre — it shares step numbering with the
                 adjacent segment sites, and an unscoped legacy clause
                 must keep firing where it always fired; the storage
                 kinds (io-error / io-slow / enospc) default to
                 `at=save` when no site is given
    "restore"  — utils/checkpoint.restore_state, before each restore
                 attempt (step = the step being restored). OPT-IN for
                 the same reason
    "serve-batch" — serving/service.SimulationService._prepare_batch,
                 before each batch's lane assembly, flight step bump,
                 and collectives (step = the service's global batch
                 ordinal). OPT-IN: its step numbering is batches, not
                 simulation steps — an unscoped legacy clause must
                 never fire here
"""

from __future__ import annotations

import errno
import os
import time

RC_INJECTED_KILL = 43  # distinctive rc: a killed rank is diagnosable
RC_INJECTED_DIE = 0  # the point of `die`: the exit code says nothing
ENV_VAR = "RMT_INJECT_FAULT"

# Sites that only fire for clauses explicitly scoped there (at=SITE):
# they share step numbering with an adjacent legacy site, and an
# unscoped clause must keep firing at the legacy one.
OPTIN_SITES = frozenset({"segment-pre", "save", "restore", "serve-batch"})

# Storage-fault kinds: they only make sense at an IO attempt, so a
# clause with no at= clause is pinned to the "save" site at parse time.
IO_KINDS = frozenset({"io-error", "io-slow", "enospc"})
IO_SLOW_DEFAULT_S = 2.0

# Serving-plane kinds (module docstring): matched ONLY by
# `serving_fault` — the raising `fault_point` below skips them, so a
# `batch-error@step=2` can never collide with the halo "step" site's
# step numbering. The caller interprets the returned clause (`delay_s`
# carries the slow-batch seconds / queue-flood size).
SERVING_KINDS = frozenset(
    {"lane-nan", "batch-error", "queue-flood", "slow-batch"}
)
SLOW_BATCH_DEFAULT_S = 0.5
QUEUE_FLOOD_DEFAULT_N = 16

# Fleet-plane kinds (module docstring): matched ONLY by
# `replica_fault` — their `rank=` modifier names a REPLICA id, not a
# process rank, so neither `fault_point` nor `serving_fault` may ever
# interpret them.
REPLICA_KINDS = frozenset({"replica-kill", "replica-stall"})


class InjectedCrash(RuntimeError):
    """The injected failure run_supervised retries around."""


class FaultClause:
    __slots__ = ("kind", "step", "segment", "rank", "delay_s", "site",
                 "times", "fires", "request")

    def __init__(self, kind, step=None, segment=None, rank=None,
                 delay_s=0.0, site=None, times=None, request=None):
        self.kind = kind
        self.step = step
        self.segment = segment
        self.rank = rank
        self.delay_s = delay_s
        self.site = site
        self.times = times  # None = the plan's MAX_FIRES default
        self.request = request  # lane-nan's ticket-ordinal trigger
        self.fires = 0

    def __repr__(self):
        parts = [self.kind]
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.segment is not None:
            parts.append(f"segment={self.segment}")
        if self.request is not None:
            parts.append(f"request={self.request}")
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        if self.site is not None:
            parts.append(f"at={self.site}")
        if self.times is not None:
            parts.append(f"times={self.times}")
        if self.delay_s:
            parts.append(f"delay={self.delay_s}")
        return f"FaultClause({', '.join(parts)})"


def _parse_clause(raw: str) -> FaultClause:
    head, *mods = [p.strip() for p in raw.split(",")]
    kind, _, trigger = head.partition("@")
    kind = kind.strip()
    delay_s = 0.0
    if kind.startswith("delay="):
        delay_s = float(kind[len("delay="):])
        kind = "delay"
    elif kind.startswith("io-slow="):
        delay_s = float(kind[len("io-slow="):])
        kind = "io-slow"
    elif kind == "io-slow":
        delay_s = IO_SLOW_DEFAULT_S
    elif kind.startswith("slow-batch="):
        delay_s = float(kind[len("slow-batch="):])
        kind = "slow-batch"
    elif kind == "slow-batch":
        delay_s = SLOW_BATCH_DEFAULT_S
    elif kind.startswith("queue-flood="):
        # delay_s doubles as the flood SIZE for queue-flood (the one
        # value-bearing serving kind; apps/soak.py casts it back).
        delay_s = float(kind[len("queue-flood="):])
        kind = "queue-flood"
    elif kind == "queue-flood":
        delay_s = float(QUEUE_FLOOD_DEFAULT_N)
    if kind not in ("crash", "kill", "die", "truncate-latest", "delay",
                    "stall") and kind not in IO_KINDS \
            and kind not in SERVING_KINDS \
            and kind not in REPLICA_KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {raw!r}")
    clause = FaultClause(kind, delay_s=delay_s)
    triggers = [t for t in [trigger.strip()] + mods if t]
    for t in triggers:
        key, _, val = t.partition("=")
        key = key.strip()
        if key == "step":
            clause.step = int(val)
        elif key == "segment":
            clause.segment = int(val)
        elif key == "rank":
            clause.rank = int(val)
        elif key == "request":
            clause.request = int(val)
        elif key == "at":
            clause.site = val.strip()
        elif key == "times":
            clause.times = int(val)
            if clause.times < 1:
                raise ValueError(f"times must be >= 1 in {raw!r}")
        else:
            raise ValueError(f"unknown fault trigger {t!r} in {raw!r}")
    if clause.request is not None and kind != "lane-nan":
        raise ValueError(
            f"request=N only triggers lane-nan clauses: {raw!r}"
        )
    if kind in IO_KINDS and clause.site is None:
        # Storage faults strike IO attempts; without an explicit at=
        # they pin to the save site (the one every drill wants).
        clause.site = "save"
    if (kind in ("crash", "kill", "die", "delay", "stall")
            or kind in IO_KINDS) \
            and clause.step is None and clause.segment is None:
        raise ValueError(
            f"{kind} fault needs a step=K or segment=N trigger: {raw!r}"
        )
    if kind == "lane-nan" and clause.request is None:
        raise ValueError(
            f"lane-nan needs a request=N trigger (the 1-based ticket "
            f"ordinal): {raw!r}"
        )
    if kind in ("batch-error", "slow-batch", "queue-flood") \
            and clause.step is None:
        raise ValueError(
            f"{kind} needs a step=N trigger (batch/drain ordinal): "
            f"{raw!r}"
        )
    if kind in REPLICA_KINDS and clause.step is None:
        raise ValueError(
            f"{kind} needs a step=K trigger (the fleet drive tick): "
            f"{raw!r}"
        )
    return clause


class FaultPlan:
    """Parsed, armed fault clauses; fault_point() consults the installed
    plan. MAX_FIRES guards the retry path: a recovered-and-re-run step
    must not re-fire its fault."""

    MAX_FIRES = 1

    def __init__(self, clauses):
        self.clauses = list(clauses)
        self._segments_seen = 0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        # Clause separator is ';' so ',' stays free for modifiers.
        clauses = [
            _parse_clause(part)
            for part in spec.split(";")
            if part.strip()
        ]
        return cls(clauses)

    def __bool__(self):
        return bool(self.clauses)


_PLAN: FaultPlan | None = None
_ENV_CONSUMED = False  # the env spec installs at most once per process


def _rank() -> int:
    """This process's rank, read without forming a process group (the
    "init" site fires before one exists): the launcher's RMT_PROCESS_ID,
    then torchrun's RANK, then the default group's rank when one is up,
    else 0."""
    for var in ("RMT_PROCESS_ID", "RANK"):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                continue
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def install(spec: str | None) -> FaultPlan | None:
    """Install (or with None/'' clear) the process-wide fault plan. An
    explicit install wins over — and permanently supersedes — the env
    spec (a cleared plan stays cleared)."""
    global _PLAN, _ENV_CONSUMED
    _ENV_CONSUMED = True
    _PLAN = FaultPlan.parse(spec) if spec else None
    return _PLAN


def install_from_env() -> FaultPlan | None:
    """Install the plan from RMT_INJECT_FAULT, at most once per process;
    cheap when the var is unset (the common case pays one getenv)."""
    global _ENV_CONSUMED
    if _ENV_CONSUMED:
        return _PLAN
    spec = os.environ.get(ENV_VAR, "").strip()
    if spec:
        install(spec)
    else:
        _ENV_CONSUMED = True
    return _PLAN


def active_plan() -> FaultPlan | None:
    return _PLAN


def _truncate_latest(directory) -> None:
    """Truncate the largest file of the NEWEST checkpoint step dir —
    the torn-write the integrity manifest must catch. Pure pathlib (no
    checkpoint-module import: checkpoint imports us)."""
    import pathlib

    root = pathlib.Path(directory)
    step_dirs = sorted(
        (d for d in root.iterdir() if d.is_dir() and d.name.isdigit()),
        key=lambda d: int(d.name),
    )
    if not step_dirs:
        return
    files = sorted(
        (f for f in step_dirs[-1].rglob("*") if f.is_file()),
        key=lambda f: f.stat().st_size,
    )
    if not files:
        return
    target = files[-1]
    size = target.stat().st_size
    with target.open("r+b") as fh:
        fh.truncate(max(size // 2, 0))


def serving_fault(kind: str, step=None, request=None):
    """Match-and-consume for the serving-plane kinds (module
    docstring): returns the firing `FaultClause` or None. The CALLER
    interprets the clause — the service raises for batch-error, sleeps
    `clause.delay_s` for slow-batch, poisons the lane for lane-nan;
    apps/soak.py submits `int(clause.delay_s)` requests for
    queue-flood. `step` is the batch/drain ordinal; `request` the
    1-based ticket ordinal (lane-nan only). times=/rank= re-arm and
    scope exactly like every other clause."""
    if kind not in SERVING_KINDS:
        raise ValueError(f"not a serving fault kind: {kind!r}")
    plan = install_from_env()
    if not plan:
        return None
    rank = _rank()
    for clause in plan.clauses:
        if clause.kind != kind:
            continue
        if clause.fires >= (clause.times or plan.MAX_FIRES):
            continue
        if clause.rank is not None and clause.rank != rank:
            continue
        if clause.request is not None:
            hit = request is not None and int(request) == clause.request
        else:
            hit = step is not None and clause.step is not None \
                and int(step) == clause.step
        if not hit:
            continue
        clause.fires += 1
        return clause
    return None


def replica_fault(kind: str, step=None, replica=None):
    """Match-and-consume for the fleet-plane kinds (module docstring):
    returns the firing `FaultClause` or None. `step` is the router's
    drive-tick ordinal; `replica` the replica id a clause's `rank=`
    modifier scopes to (an unscoped clause matches any replica — the
    first drive tick to ask, wins). The CALLER interprets the clause:
    the router marks the replica dead for replica-kill, demotes it for
    replica-stall, and runs journal-replay reconciliation for both.
    Deliberately NOT `serving_fault`: there `rank=` means the calling
    process's rank, and a fleet drill scoping `rank=1` must kill
    replica 1, not depend on which process hosts the router."""
    if kind not in REPLICA_KINDS:
        raise ValueError(f"not a replica fault kind: {kind!r}")
    plan = install_from_env()
    if not plan:
        return None
    for clause in plan.clauses:
        if clause.kind != kind:
            continue
        if clause.fires >= (clause.times or plan.MAX_FIRES):
            continue
        if clause.rank is not None and (
            replica is None or clause.rank != int(replica)
        ):
            continue
        if step is None or clause.step is None \
                or int(step) != clause.step:
            continue
        clause.fires += 1
        return clause
    return None


def fault_point(name: str, step=None, directory=None) -> None:
    """Instrumentation hook: a no-op without an installed/env plan.

    `name` identifies the instrumented site; `step` the absolute step
    count where meaningful; `directory` the checkpoint dir (needed by
    truncate-latest).
    """
    plan = install_from_env()
    if not plan:
        return
    if name == "segment":
        plan._segments_seen += 1
    rank = _rank()
    for clause in plan.clauses:
        if clause.kind in SERVING_KINDS or clause.kind in REPLICA_KINDS:
            # Serving kinds are matched only by serving_fault() and
            # replica kinds only by replica_fault(): their step
            # numbering is batches/drains/drive-ticks, not simulation
            # steps — and a replica clause's rank= is a replica id.
            continue
        if clause.fires >= (clause.times or plan.MAX_FIRES):
            continue
        if clause.rank is not None and clause.rank != rank:
            continue
        if clause.site is not None:
            if clause.site != name:
                continue
        elif name in OPTIN_SITES:
            # Opt-in sites never match unscoped clauses: a legacy spec's
            # step trigger must keep firing where it always fired.
            continue
        hit = False
        if clause.step is not None:
            hit = step is not None and int(step) == clause.step
        elif clause.segment is not None:
            hit = name == "segment" and plan._segments_seen == clause.segment
        elif clause.kind == "truncate-latest":
            hit = name == "segment" and directory is not None
        if not hit:
            continue
        clause.fires += 1
        if clause.kind == "delay":
            time.sleep(clause.delay_s)
        elif clause.kind == "io-error":
            raise OSError(
                errno.EIO,
                f"injected io-error at fault point {name!r} "
                f"(step={step}, rank={rank})",
            )
        elif clause.kind == "io-slow":
            # Inside the save attempt's measured wall: the slow-write
            # watchdog (StoragePolicy.slow_save_timeout_s) sees it.
            time.sleep(clause.delay_s)
        elif clause.kind == "enospc":
            raise OSError(
                errno.ENOSPC,
                f"injected enospc at fault point {name!r} "
                f"(step={step}, rank={rank})",
            )
        elif clause.kind == "stall":
            # The wedged rank: a pure-Python monotonic busy-wait that
            # never exits. Deliberately NOT a sleep — the interpreter
            # keeps executing bytecode, so daemon threads (telemetry
            # drains) stay live and the process looks exactly like a
            # rank spinning inside a stuck collective: alive by wall
            # clock, dead by progress. Only the watchdog's kill (or the
            # launcher timeout) ends it.
            while True:  # pragma: no branch — exit is the kill signal
                time.monotonic()
        elif clause.kind == "truncate-latest":
            if directory is not None:
                _truncate_latest(directory)
        elif clause.kind == "kill":
            os._exit(RC_INJECTED_KILL)  # noqa: SLF001 — the point: no cleanup
        elif clause.kind == "die":
            # The vanished rank: a CLEAN exit mid-run. No exception, no
            # post-mortem, rc 0 — everything downstream must infer death
            # from the peers it orphaned, which is exactly the path the
            # elastic drills need to exercise deterministically.
            os._exit(RC_INJECTED_DIE)  # noqa: SLF001 — no cleanup either
        elif clause.kind == "crash":
            raise InjectedCrash(
                f"injected crash at fault point {name!r} "
                f"(step={step}, rank={rank})"
            )
