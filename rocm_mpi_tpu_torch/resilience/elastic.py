"""Elastic launch supervision: shrink the process grid on rank death,
grow it back when devices rejoin, and treat scheduler preemption as a
resumable state — counterpart of rocm_mpi_tpu/resilience/elastic.py (the
same policy, events and `elastic.jsonl` sidecar).

`run_supervised` (supervisor.py) retries a run on the SAME process grid —
right when the failure was transient. When a rank is gone (killed,
wedged and put down by the progress watchdog, or vanished with a clean
exit code) that grid no longer exists. `run_elastic` treats the grid as a
run-time variable:

    report = run_elastic(argv, nprocs=4, checkpoint_dir=d,
                         global_shape=(12288, 12288), health_dir=h)

launches `nprocs` ranks of `argv` through the argv launcher
(parallel/launcher.spawn_app_ranks) and, when a launch fails, it:

 1. plans the largest valid sub-grid for the survivors (mesh.plan_dims:
    the biggest p ≤ survivors whose near-square factorisation divides
    every axis of the global shape);
 2. records an `elastic.shrink` event — old and new grid dims, dead
    ranks, reason, the resume step — in the run's `elastic.jsonl`
    sidecar (telemetry/health.append_elastic_event; the monitor shows the
    grid and a SHRUNK badge from it) and, when this process collects
    telemetry, as telemetry events and gauges;
 3. relaunches on the smaller rank count. The ranks resume from the
    latest VALID checkpoint step as any --resume run does: each rank
    reads the saved shards that overlap its block of the new grid
    (utils/checkpoint.restore_state), bit for bit.

Growth: pass `device_budget` (a callable returning the ranks available
now, or an int) and a rejoin probe runs while a launch is live. When
more ranks are available than the running grid uses and the
`ElasticPolicy` agrees, it preempts the ranks (SIGTERM: each lands a
final save at its next segment boundary and exits RC_PREEMPTED), records
`elastic.grow`, and relaunches on the largest valid larger grid through
the same restore. Growth therefore happens only at segment boundaries,
from a durable step. A launch that failed re-plans for its survivors
whatever the budget claims.

Preemption of the whole job: a launch whose only nonzero exits are
RC_PREEMPTED is judged "preempted", never a failure. If this process
itself holds a SIGTERM notice (the launcher's forwarder stamped it),
run_elastic stops relaunching, records `elastic.preempted` and returns
the report (`report.preempted`): the next invocation resumes. Otherwise
a preempted launch is relaunched (grown when the budget says so), at
most `policy.max_preempt_resumes` times.

The injected fault spec (drills) goes to the first launch only: the fault
already happened. Shrinking stops at `policy.min_ranks`; a failure there
raises ElasticExhausted after an `elastic.gave-up` event. A clean launch
never changes the grid.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import signal as _signal
import threading

from rocm_mpi_tpu_torch.resilience import preempt as _preempt
from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy


class ElasticExhausted(RuntimeError):
    """The run kept failing all the way down to `min_ranks`."""


@dataclasses.dataclass
class ElasticReport:
    """What the elastic supervisor did: one entry per launch, the
    elastic.* event records (also in the sidecar), and the last launch's
    RankResults (`.results`)."""

    launches: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    shrinks: int = 0
    grows: int = 0
    resumes: int = 0  # preempted relaunches that changed nothing
    preempted: bool = False  # the whole job was evicted; resumable
    final_nprocs: int | None = None
    results: object = None

    def note_event(self, rec: dict) -> None:
        self.events.append(rec)


def _judge(results) -> tuple[str, list[int], str]:
    """(status, dead_ranks, reason) for one finished launch; status is
    "ok" | "failed" | "preempted". Dead ranks are the CAUSE
    (watchdog-flagged / vanished / first nonzero rc), not the peers the
    launcher reaped after them. A launch where every deliberate nonzero
    exit is RC_PREEMPTED is a scheduler eviction, not a failure — those
    ranks exited on purpose from a durable step (resilience.preempt).
    Peers with negative rcs alongside an RC_PREEMPTED exit are the
    documented boundary-skew casualties: a rank that noticed the notice
    one segment later than its preempted peer strands in a collective
    the peer already left, and the launcher's peer-grace/watchdog kill
    reaps it (SIGKILL → negative rc). That reap — watchdog verdict and
    all — is part of the preemption contract's bounded fallback (the
    resume falls back to the last durable step), so it must not
    downgrade the eviction into a failure and trigger a shrink: the
    devices are not dead, the scheduler took them.

    A rc-0 vanish verdict alongside RC_PREEMPTED exits ALSO yields to
    "preempted" — deliberately. The ambiguous rc-0 exit is either a
    rank that legitimately finished while a slower peer got preempted
    past the vanish grace (eviction near completion: a shrink would
    wrongly discard healthy topology) or a genuine die-class death that
    happened to coincide with an eviction; the preempted relaunch
    self-corrects the latter in one launch (the dead device fails it,
    and THAT launch judges "failed" and shrinks), while the flipped
    precedence would mis-shrink the former with nothing to correct
    it."""
    report = results.report
    rcs = [p.returncode for p, _ in results]
    nonzero = [(i, rc) for i, rc in enumerate(rcs) if rc != 0]
    preempted = [i for i, rc in nonzero if rc == _preempt.RC_PREEMPTED]
    casualties = [(i, rc) for i, rc in nonzero
                  if rc != _preempt.RC_PREEMPTED]
    if preempted and all(rc < 0 for _, rc in casualties):
        extra = (f", {len(casualties)} peer(s) reaped at the boundary "
                 "skew" if casualties else "")
        return "preempted", [], (
            f"{len(preempted)} rank(s) exited preempted "
            f"(rc={_preempt.RC_PREEMPTED}){extra}"
        )
    if report.watchdog_verdicts:
        ranks = sorted({v["rank"] for v in report.watchdog_verdicts})
        return "failed", ranks, "watchdog-stall"
    if report.vanished is not None:
        return "failed", [report.vanished], "vanished (clean rc mid-run)"
    if report.first_failure is not None:
        rank, rc, _ = report.first_failure
        return "failed", [rank], f"rank {rank} rc={rc}"
    if nonzero:
        i, rc = nonzero[0]
        return "failed", [i], f"rank {i} rc={rc}"
    return "ok", [], "ok"


class _GrowWatcher:
    """The live rejoin probe: while a launch runs, poll the device
    budget; when the policy wants a grow, preempt the ranks (SIGTERM —
    they land one final save at the next segment boundary and exit
    RC_PREEMPTED) and remember the target for the post-launch decision.

    Before preempting it additionally requires a step durably saved
    PAST the launch's resume point: a rank that has not completed a new
    segment has nothing fresher to grow from (and may not have armed
    its preemption handler yet) — growth waits for the next boundary by
    construction."""

    def __init__(self, policy, budget_fn, plan_ranks, resume_step_fn, log):
        self.policy = policy
        self.budget_fn = budget_fn
        self.plan_ranks = plan_ranks
        self.resume_step_fn = resume_step_fn
        self.log = log
        self.target: int | None = None
        self._stop = threading.Event()
        self._thread = None

    def on_spawn(self, nprocs: int, last_change_step):
        def _cb(procs):
            self._thread = threading.Thread(
                target=self._watch, args=(procs, nprocs, last_change_step),
                daemon=True,
            )
            self._thread.start()

        return _cb

    def arm(self):
        self.target = None
        self._stop = threading.Event()

    def disarm(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _watch(self, procs, nprocs, last_change_step):
        while not self._stop.wait(self.policy.grow_poll_s):
            try:
                budget = int(self.budget_fn())
            except Exception:  # noqa: BLE001 — a flaky probe is no budget
                continue
            if budget <= nprocs:
                # The common steady state (budget == running ranks).
                # Checked BEFORE resume_step_fn: that call validates the
                # newest checkpoint (manifest and inventory) and must not run
                # every poll of a run that can never grow.
                continue
            try:
                step = self.resume_step_fn()
            except Exception:  # noqa: BLE001
                step = None
            since = last_change_step if last_change_step is not None else 0
            if step is None or step <= since:
                continue  # nothing durably newer to grow from yet
            if not self.policy.wants_grow(nprocs, budget, step=step,
                                          last_change_step=since):
                continue
            target = self.policy.grow_target(nprocs, budget,
                                             self.plan_ranks)
            if target <= nprocs:
                continue
            self.target = target
            self.log(
                f"elastic: rejoin probe sees budget {budget} > {nprocs} "
                f"rank(s) at step {step} — preempting for growth to "
                f"{target} rank(s) at the next segment boundary"
            )
            for p in procs:
                try:
                    if p.poll() is None:
                        p.send_signal(_signal.SIGTERM)
                except (OSError, AttributeError):
                    pass
            return


def run_elastic(
    argv,
    nprocs: int,
    *,
    checkpoint_dir=None,
    global_shape=None,
    min_ranks: int = 1,
    inject_fault: str | None = None,
    sidecar_dir=None,
    launch=None,
    log=None,
    policy: ElasticPolicy | None = None,
    device_budget=None,
    **spawn_kwargs,
) -> ElasticReport:
    """Launch `argv` on `nprocs` ranks, shrinking/growing the mesh and
    resuming per the policy; returns the ElasticReport (`.results` is
    the last launch). `argv` may be a callable `(nprocs, attempt) ->
    argv` when ranks need per-launch arguments.

    `global_shape` drives the sub-mesh planning (plan_dims); without it
    the shrink is a plain n-1 (and a grow a plain budget). `checkpoint_dir`
    is read here to stamp resume steps on events and to feed the grow
    hysteresis — the ranks own the actual restore. `sidecar_dir`
    (default: health_dir, then telemetry_dir, then checkpoint_dir)
    receives `elastic.jsonl`. `policy` defaults to
    ElasticPolicy(min_ranks=min_ranks).
    `device_budget` (callable -> int, or a constant int) arms the
    rejoin probe and elastic growth; None (default) disables growth.
    `launch` is injectable for tests (default
    parallel.launcher.spawn_app_ranks); remaining kwargs pass through to
    it — `vanish_grace_s` defaults ON here (10 s) because vanish
    detection is the only way a `die`-class death is seen at all, and
    when growth is armed `preempt_grace_s` defaults ON too (the grow
    path preempts ranks, so they must know their grace).
    """
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.telemetry import health as _health

    if nprocs < 1 or min_ranks < 1 or min_ranks > nprocs:
        raise ValueError(
            f"need 1 <= min_ranks <= nprocs, got {min_ranks}, {nprocs}"
        )
    if policy is None:
        policy = ElasticPolicy(min_ranks=min_ranks)
    if launch is None:
        from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks

        launch = spawn_app_ranks
    spawn_kwargs.setdefault("vanish_grace_s", 10.0)
    log = log or (lambda *_: None)
    sidecar = (
        sidecar_dir
        or spawn_kwargs.get("health_dir")
        or spawn_kwargs.get("telemetry_dir")
        or checkpoint_dir
    )
    budget_fn = None
    if device_budget is not None:
        budget_fn = (
            device_budget if callable(device_budget)
            else (lambda b=int(device_budget): b)
        )
        # Ranks about to be preempted for growth must have the handler
        # armed, or the SIGTERM just kills them (judged a failure).
        spawn_kwargs.setdefault("preempt_grace_s",
                                _preempt.DEFAULT_GRACE_S)
    report = ElasticReport()

    def event(name: str, **attrs) -> None:
        if sidecar is not None:
            rec = _health.append_elastic_event(sidecar, name, **attrs)
        else:
            rec = {"name": name, **attrs}
        report.note_event(rec)
        # The supervising process may itself collect telemetry (tests,
        # a driving notebook): mirror the decision there too. No-ops
        # when collection is off.
        telemetry.record_event(name)
        if name in ("elastic.launch", "elastic.shrink", "elastic.grow"):
            telemetry.gauge("elastic.ranks", attrs.get("new_nprocs",
                                                       attrs.get("nprocs")))

    def resume_step():
        if checkpoint_dir is None:
            return None
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        return ckpt.latest_valid_step(checkpoint_dir, log=log)

    def mesh_for(n: int):
        if global_shape is None:
            return None
        from rocm_mpi_tpu_torch.parallel.mesh import plan_dims

        return list(plan_dims(global_shape, n))

    def plan_ranks(budget: int) -> int:
        mesh = mesh_for(budget)
        if mesh is None:
            return budget
        return int(math.prod(mesh))

    watcher = None
    if budget_fn is not None and policy.grow:
        watcher = _GrowWatcher(policy, budget_fn, plan_ranks,
                               resume_step, log)

    if sidecar is not None:
        # elastic.jsonl is THIS run's record: a reused directory must not
        # show last run's shrinks as this run's (same hygiene the
        # launcher applies to stale heartbeat sidecars).
        stale = pathlib.Path(sidecar) / _health.ELASTIC_FILE
        stale.unlink(missing_ok=True)

    n = nprocs
    attempt = 0
    start = resume_step()
    # Hysteresis anchor: the step at the last topology change (the
    # launch's own resume point until one happens).
    last_change_step = start
    while True:
        mesh = mesh_for(n)
        event("elastic.launch", attempt=attempt, nprocs=n, mesh=mesh,
              resume_step=start)
        log(f"elastic: launch {attempt} on {n} rank(s)"
            + (f", mesh {tuple(mesh)}" if mesh else "")
            + (f", resuming step {start}" if start else ""))
        this_argv = argv(n, attempt) if callable(argv) else argv
        launch_kwargs = dict(spawn_kwargs)
        if watcher is not None:
            watcher.arm()
            watcher_cb = watcher.on_spawn(n, last_change_step)
            caller_cb = launch_kwargs.get("on_spawn")
            if caller_cb is None:
                launch_kwargs["on_spawn"] = watcher_cb
            else:
                # A caller-supplied on_spawn rides along with the grow
                # watcher's — the launcher documents the hook, so arming
                # growth must not silently eat it.
                def _chained(procs, _u=caller_cb, _w=watcher_cb):
                    _u(procs)
                    _w(procs)

                launch_kwargs["on_spawn"] = _chained
        try:
            results = launch(
                this_argv,
                nprocs=n,
                inject_fault=inject_fault if attempt == 0 else None,
                **launch_kwargs,
            )
        finally:
            if watcher is not None:
                watcher.disarm()
        status, dead, reason = _judge(results)
        report.launches.append({
            "attempt": attempt,
            "nprocs": n,
            "mesh": mesh,
            "resume_step": start,
            "status": status,
            "ok": status == "ok",
            "dead_ranks": dead,
            "reason": reason,
            "returncodes": [p.returncode for p, _ in results],
        })
        report.results = results
        if status == "ok":
            report.final_nprocs = n
            event("elastic.complete", nprocs=n, mesh=mesh,
                  shrinks=report.shrinks, grows=report.grows)
            log(f"elastic: run complete on {n} rank(s) after "
                f"{report.shrinks} shrink(s) and {report.grows} grow(s)")
            return report

        if status == "preempted":
            # Re-resolve AFTER the launch: the ranks exited from a
            # durable boundary (or skipped to the previous one).
            start = resume_step()
            if _preempt.requested():
                # The PARENT holds the eviction notice (the launcher's
                # forwarder stamped it): the whole job is being taken.
                # Stop relaunching; the next invocation resumes.
                report.preempted = True
                report.final_nprocs = n
                event("elastic.preempted", nprocs=n, mesh=mesh,
                      resume_step=start, reason=reason)
                log(f"elastic: job preempted on {n} rank(s); resumable "
                    f"from step {start}")
                # The notice is CONSUMED by returning it in the report:
                # preempt's request state is module-global, and a
                # long-lived driver (a serving layer) that calls
                # run_elastic again in this process must not have its
                # next grow-preemption misread as a second whole-job
                # eviction.
                _preempt.reset()
                return report
            grow_to = None
            if watcher is not None and watcher.target is not None:
                grow_to = watcher.target
            elif budget_fn is not None:
                try:
                    budget = int(budget_fn())
                except Exception:  # noqa: BLE001
                    budget = n
                if policy.wants_grow(n, budget, step=start,
                                     last_change_step=last_change_step):
                    candidate = policy.grow_target(n, budget, plan_ranks)
                    if candidate > n:
                        grow_to = candidate
            if grow_to is not None and grow_to > n:
                new_mesh = mesh_for(grow_to)
                event("elastic.grow", old_nprocs=n, new_nprocs=grow_to,
                      old_mesh=mesh, new_mesh=new_mesh,
                      resume_step=start, reason="device-budget")
                log(f"elastic: growing {n} → {grow_to} rank(s) "
                    f"(device budget), resuming from step {start}")
                report.grows += 1
                last_change_step = start
                n = grow_to
            else:
                report.resumes += 1
                if report.resumes > policy.max_preempt_resumes:
                    event("elastic.gave-up", nprocs=n, reason=(
                        f"{report.resumes} preempted relaunches "
                        f"(max {policy.max_preempt_resumes})"))
                    raise ElasticExhausted(
                        f"preempted {report.resumes} times without "
                        "completing — giving up"
                    )
                event("elastic.resume", nprocs=n, mesh=mesh,
                      resume_step=start, reason=reason)
                log(f"elastic: ranks preempted; relaunching on {n} "
                    f"rank(s) from step {start}")
            attempt += 1
            continue

        # status == "failed": shrink (precedence over any grow signal —
        # the budget's optimism is exactly what the dead rank disproved).
        if policy.give_up(n):
            event("elastic.gave-up", nprocs=n, reason=reason,
                  dead_ranks=dead)
            log(f"elastic: giving up — failed at min_ranks="
                f"{policy.min_ranks} ({reason})")
            raise ElasticExhausted(
                f"run failed at the minimum rank count {policy.min_ranks}: "
                f"{reason}"
            )
        new_n = policy.shrink_target(n, len(dead), plan_ranks)
        new_mesh = mesh_for(new_n)
        # Re-resolve AFTER the failed launch (its ranks saved steps) —
        # then carry the value: nothing runs between this shrink and
        # the next launch, so re-walking every manifest again at the
        # loop top would be pure repeated validation I/O.
        start = resume_step()
        event("elastic.shrink", old_nprocs=n, new_nprocs=new_n,
              old_mesh=mesh, new_mesh=new_mesh, dead_ranks=dead,
              reason=reason, resume_step=start)
        log(f"elastic: shrinking {n} → {new_n} rank(s) "
            f"({reason}; dead {dead}), resuming from step {start}")
        report.shrinks += 1
        last_change_step = start
        n = new_n
        attempt += 1
