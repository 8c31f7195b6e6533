"""The fleet router: N independent `SimulationService` replicas behind one
front end — counterpart of rocm_mpi_tpu/serving/router.py
(docs/SERVING.md "The fleet").

Routing policy — program state is the scarce resource, so affinity IS
the load-balancing policy:

  1. SESSION affinity: a sessioned request sticks to the replica that
     owns its session directory (resume reads replica-local state; a
     resume that landed elsewhere would silently recompute from
     scratch). Stickiness outranks the saturation bound.
  2. PROGRAM-CLASS affinity: a bin's traffic sticks to the replica that
     already built its program classes (`BinKey` → replica). First route
     wins and is journaled; every later request of the same bin follows
     it, so `compiles.steady_state == 0` holds PER REPLICA.
  3. SPILLOVER: when the affine replica is saturated (its depth at the
     per-replica bound), non-sessioned traffic spills to the
     least-loaded healthy replica with room — deterministically, in
     (depth, id) order. When NO replica has room, the router rejects
     fast with the MERGED retry-after hint (the minimum over healthy
     replicas' throughput-derived hints).

The router never hands a wall clock to a replica: replica queues run
`wall_slo = False`, and deadline expiry is decided by the router's single
clock (`RequestQueue.expire_overdue`) before each drain. Every transition
is journaled (serving/journal.py): submit at the front door, route (and
re-route) decisions, and each ticket's ONE terminal state, harvested from
replica queues at drain boundaries by the router — the single journal
writer. A replica killed mid-traffic (the `replica-kill@step=K,rank=R`
fault, a real kill, rc-75 preemption, or a heartbeat verdict) triggers
replay-based reconciliation: the journal names every ticket whose LAST
route hit the dead replica with no terminal, and the router re-routes
exactly those. `ElasticPolicy` is promoted to the fleet autoscaler:
aggregate queue depth grows the fleet by whole replicas, sustained
idleness retires the highest-id one.

Where the port differs from the JAX package, and why:

* A dead replica lets its device state go. A killed or retired
  replica's service drops its programs and models (`SimulationService.
  release`): their lane blocks, spares, slab buffers and initial states
  return to the caching allocator once the router holds nothing else of
  them, and nothing waits on the dead replica's pipeline (a drain leaves
  nothing in flight). Its report row keeps the program count it had.
* Several ranks. Every rank runs the same router over the same trace,
  and each replica's service spans the world group, so every decision
  must be the same on every rank or the replicas' collectives interleave
  differently and hang. Routing, reconciliation, the autoscaler and the
  drain order are pure folds of the trace; the router's wall-clock
  decisions are not, so on several ranks rank 0's clock makes them for
  every rank: the overdue tickets each tick (broadcast when any queued
  ticket carries a deadline), the heartbeat demotions, and the
  preemption stop between ticks.
"""

from __future__ import annotations

import dataclasses
import time

from rocm_mpi_tpu_torch.serving import bins as _bins
from rocm_mpi_tpu_torch.serving import journal as _journal
from rocm_mpi_tpu_torch.serving import slo as _slo
from rocm_mpi_tpu_torch.serving.queue import (
    DEFAULT_RETRY_AFTER_S,
    MAX_RETRY_AFTER_S,
    TERMINAL_STATES,
    Ticket,
)
from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

DEFAULT_STALL_GRACE_S = 20.0


def _rank0(obj):
    """Rank 0's `obj` on every rank (one broadcast over the world group;
    every rank must call it at the same point of the fold)."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed

    box = [obj]
    device = (torch.device("cuda", torch.cuda.current_device())
              if distributed.backend() == "nccl" else None)
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


class Replica:
    """One fleet member: a `SimulationService` plus the router's view of
    its health. `alive=False` — killed/retired (its queue state is
    presumed lost; the journal is the record). `demoted=True` — up but
    untrusted (progress-stalled): no new routes, pending re-routed."""

    def __init__(self, rid: int, svc):
        self.id = int(rid)
        self.svc = svc
        self.alive = True
        self.demoted = False
        self.retiring = False
        self.verdict: str | None = None
        self._programs: int | None = None  # the count at release
        # The replica queue never owns a wall clock (module docstring).
        svc.queue.wall_slo = False

    @property
    def healthy(self) -> bool:
        return self.alive and not self.demoted and not self.retiring

    def depth(self) -> int:
        return self.svc.queue.depth() if self.alive else 0

    def release(self) -> None:
        """The replica is gone: its service lets its device state go
        (module docstring); the row keeps the program count."""
        if self._programs is None:
            self._programs = len(self.svc._programs)
            self.svc.release()

    def row(self, steady_state: int) -> dict:
        """The replica's fleet-report row. For an in-process fleet a dead
        replica's counters are still readable (frozen at the kill); a
        real kill loses them — which is why the MERGED accounting comes
        from the journal, never from these rows."""
        return {
            "id": self.id,
            "alive": self.alive,
            "demoted": self.demoted,
            "verdict": self.verdict,
            "counters": self.svc.queue.counters(),
            "retries": int(self.svc.retries_total),
            "programs": (len(self.svc._programs) if self._programs is None
                         else self._programs),
            "bins": len(self.svc._stats),
            "steady_state": int(steady_state),
        }


class _TicketRec:
    __slots__ = ("request", "ticket", "replica", "journaled")

    def __init__(self, request, ticket, replica):
        self.request = request
        self.ticket = ticket
        self.replica = replica
        self.journaled = False


class FleetTicket:
    """The caller's handle on a fleet submission. A re-route after a
    replica kill REPLACES the underlying queue ticket (the dead replica's
    ticket object died with its queue); this proxy always follows the
    record's CURRENT ticket, so `state`/`result()` survive reconciliation
    — the caller never learns their request moved."""

    __slots__ = ("_rec",)

    def __init__(self, rec: _TicketRec):
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._rec.ticket, name)

    def __repr__(self):
        t = self._rec.ticket
        return (f"FleetTicket({t.request.request_id!r}, "
                f"state={t.state!r}, replica={self._rec.replica})")


class FleetRouter:
    """The front end (module docstring). `replica_factory(rid)` builds one
    `SimulationService`; the router owns N of them, the ticket journal,
    and every wall-clock decision."""

    def __init__(self, replica_factory, n_replicas: int, *,
                 journal: _journal.TicketJournal,
                 max_depth_per_replica: int | None = None,
                 policy=None, max_replicas: int | None = None,
                 grow_queue_depth: int = 8, idle_retire_ticks: int = 3,
                 heartbeat_dirs: dict | None = None,
                 stall_grace_s: float = DEFAULT_STALL_GRACE_S):
        if int(n_replicas) < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._factory = replica_factory
        self.journal = journal
        self.max_depth_per_replica = (
            int(max_depth_per_replica) if max_depth_per_replica is not None else None
        )
        self.policy = policy
        self.max_replicas = int(max_replicas) if max_replicas is not None else int(n_replicas)
        self.grow_queue_depth = int(grow_queue_depth)
        self.idle_retire_ticks = int(idle_retire_ticks)
        self.heartbeat_dirs = dict(heartbeat_dirs or {})
        self.stall_grace_s = float(stall_grace_s)
        self.replicas: list[Replica] = []
        self._affinity: dict[str, int] = {}   # bin key_str -> replica
        self._sessions: dict[str, int] = {}   # session id -> replica
        self._tickets: dict[str, _TicketRec] = {}
        self._tick = 0
        self._idle_ticks = 0
        self._last_scale_tick: int | None = None
        self._hb_progress: dict[int, tuple] = {}  # rid -> (key, mono)
        from rocm_mpi_tpu_torch.parallel import distributed

        self._multi = distributed.world_size() > 1
        self.router_rejected = 0
        self.preempted = False
        self.autoscale_events: list[dict] = []
        for rid in range(int(n_replicas)):
            self._spawn(rid)

    # ---- fleet membership ----------------------------------------------

    def _spawn(self, rid: int) -> Replica:
        rep = Replica(rid, self._factory(rid))
        self.replicas.append(rep)
        return rep

    def replica(self, rid: int) -> Replica:
        for rep in self.replicas:
            if rep.id == int(rid):
                return rep
        raise KeyError(f"no replica {rid}")

    def healthy_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if r.healthy]

    def fleet_depth(self) -> int:
        return sum(r.depth() for r in self.healthy_replicas())

    # ---- routing --------------------------------------------------------

    def _bin_of(self, request) -> str | None:
        try:
            return _bins.bin_key(request).key_str()
        except ValueError:
            # The replica will fail the ticket at drain with the real
            # diagnostic; routing just needs SOME deterministic target.
            return None

    def _least_loaded(self, exclude=()) -> Replica | None:
        """Deterministic spill order: (depth, id) over the healthy set —
        same trace, same health history => same choice."""
        candidates = [r for r in self.healthy_replicas() if r.id not in exclude]
        if not candidates:
            return None
        return min(candidates, key=lambda r: (r.depth(), r.id))

    def retry_after_hint(self) -> float:
        """The MERGED hint: the earliest any healthy replica expects a
        slot to free — min over their throughput-derived hints, bounded
        exactly like the single-queue hint."""
        hints = [r.svc.queue.retry_after_hint() for r in self.healthy_replicas()]
        if not hints:
            return DEFAULT_RETRY_AFTER_S
        return min(max(min(hints), 0.01), MAX_RETRY_AFTER_S)

    def submit(self, request) -> FleetTicket:
        """Route one request (module docstring policy). Always returns a
        ticket; a fleet-wide saturation reject is a terminally `rejected`
        ticket carrying the merged retry-after hint."""
        rid_req = request.request_id
        # The fleet front door mints the ROOT trace context (hop 0): every
        # replica-side span of this request descends from it, and it rides
        # Request.trace through the journal so a failover re-route can
        # continue the trace at hop 1.
        if request.trace is None:
            request = dataclasses.replace(
                request, trace=_tracing.to_wire(_tracing.mint(request.request_id)))
        ctx = _tracing.from_wire(request.trace)
        bkey = self._bin_of(request)
        self.journal.record_submit(rid_req, session=request.session, bin_key=bkey)
        target = None
        sticky = False
        if request.session and request.session in self._sessions:
            pin = self._sessions[request.session]
            try:
                rep = self.replica(pin)
            except KeyError:
                rep = None
            if rep is not None and rep.healthy:
                target, sticky = rep, True
            else:
                # The pinned replica is gone; the session's durable state
                # (step manifests) is what makes the re-route at-most-once,
                # not the pin.
                del self._sessions[request.session]
        if target is None and bkey is not None and bkey in self._affinity:
            try:
                rep = self.replica(self._affinity[bkey])
            except KeyError:
                rep = None
            if rep is not None and rep.healthy:
                target = rep
            else:
                del self._affinity[bkey]
        if target is None:
            target = self._least_loaded()
        if target is None:
            raise RuntimeError("no healthy replica in the fleet")
        bound = self.max_depth_per_replica
        spilled = False
        if bound is not None and not sticky and target.depth() >= bound:
            spill = next((rep for rep in sorted(self.healthy_replicas(),
                                                key=lambda r: (r.depth(), r.id))
                          if rep.depth() < bound), None)
            if spill is None:
                hint = self.retry_after_hint()
                self.router_rejected += 1
                t = Ticket(request)
                t._terminal_fail(
                    "rejected",
                    f"fleet-full (every replica at max_depth {bound}); "
                    f"retry-after ~{hint:.2f}s",
                )
                self.journal.record_terminal(rid_req, "rejected", replica=None)
                _tracing.emit_tspan("trace.route", ctx, replica=None, state="rejected")
                rec = _TicketRec(request, t, -1)
                rec.journaled = True
                self._tickets[rid_req] = rec
                return FleetTicket(rec)
            # Spillover deliberately does NOT move the bin affinity: the
            # bin still prefers the replica holding its programs.
            target = spill
            spilled = True
        ticket = target.svc.queue.submit(request)
        self.journal.record_route(rid_req, target.id)
        _tracing.emit_tspan(
            "trace.route", ctx, replica=target.id,
            **({"sticky": True} if sticky else {}),
            **({"spill": True} if spilled else {}),
        )
        rec = _TicketRec(request, ticket, target.id)
        self._tickets[rid_req] = rec
        if bkey is not None and bkey not in self._affinity:
            self._affinity[bkey] = target.id
        if request.session:
            self._sessions.setdefault(request.session, target.id)
        return FleetTicket(rec)

    def replica_map(self) -> dict[str, int]:
        """The bin -> replica affinity table (same trace => same map)."""
        return dict(self._affinity)

    # ---- failure, health, reconciliation --------------------------------

    def kill_replica(self, rid: int, verdict: str = "killed") -> None:
        """A replica died (kill / rc-75 / watchdog): mark it dead,
        reconcile from the journal, and let its device state go."""
        rep = self.replica(rid)
        rep.alive = False
        rep.verdict = verdict
        self._reconcile(rid)
        rep.release()

    def demote_replica(self, rid: int, verdict: str = "stalled") -> None:
        """A replica is up but not progressing: no new routes, pending
        re-routed. In-process the router simply stops draining it, so a
        demoted replica can never race its re-routed tickets (the router
        IS its drain loop)."""
        rep = self.replica(rid)
        rep.demoted = True
        rep.verdict = verdict
        self._reconcile(rid)

    def _reconcile(self, rid: int) -> None:
        """Replay the journal; every ticket whose LAST route hit `rid` with
        no terminal is re-routed to a healthy replica. Pure journal fold —
        running it again after the re-routes finds nothing open on `rid`."""
        for bkey in [k for k, v in self._affinity.items() if v == int(rid)]:
            del self._affinity[bkey]
        for sess in [k for k, v in self._sessions.items() if v == int(rid)]:
            del self._sessions[sess]
        state = _journal.replay(self.journal.segments())
        for rid_req in state.open_on(rid):
            rec = self._tickets.get(rid_req)
            if rec is None:
                continue
            # A session's tickets move TOGETHER: the first re-route re-pins
            # the session and the rest follow it.
            target = None
            sess = rec.request.session
            if sess and sess in self._sessions:
                try:
                    rep = self.replica(self._sessions[sess])
                except KeyError:
                    rep = None
                if rep is not None and rep.healthy:
                    target = rep
            if target is None:
                target = self._least_loaded(exclude=(int(rid),))
            if target is None:
                raise RuntimeError(
                    f"fleet exhausted: no healthy replica to re-route {rid_req!r} to")
            # A re-route is a new HOP: continue the dead hop's trace with
            # hop+1 so the merged timeline shows the failover as one chain.
            ctx = _tracing.from_wire(rec.request.trace)
            if ctx is None:
                ctx = _tracing.mint(rid_req)
            nctx = _tracing.next_hop(ctx)
            rec.request = dataclasses.replace(rec.request, trace=_tracing.to_wire(nctx))
            rec.ticket = target.svc.queue.submit(rec.request)
            rec.replica = target.id
            rec.journaled = False
            self.journal.record_route(rid_req, target.id, reroute=True)
            _tracing.emit_tspan("trace.route", nctx, replica=target.id, reroute=True,
                                from_replica=int(rid))
            if rec.request.session:
                self._sessions[rec.request.session] = target.id
            bkey = self._bin_of(rec.request)
            if bkey is not None and bkey not in self._affinity:
                self._affinity[bkey] = target.id

    def poll_health(self, now: float | None = None) -> None:
        """Read the heartbeat sidecars of replicas that have them
        (`heartbeat_dirs[rid]`): a replica whose progress key has not
        advanced within `stall_grace_s` while it still owes work is
        demoted — the launcher watchdog's stalled-vs-advancing signature,
        read by the router's single clock (rank 0's on several ranks)."""
        if not self.heartbeat_dirs:
            return
        now = time.monotonic() if now is None else now
        for rep in list(self.replicas):
            directory = self.heartbeat_dirs.get(rep.id)
            if not rep.healthy or directory is None:
                continue
            stalled = self._stalled(rep, directory, now)
            if self._multi:
                stalled = _rank0(stalled)
            if stalled:
                self.demote_replica(rep.id, verdict="progress-stalled")

    def _stalled(self, rep: Replica, directory, now: float) -> bool:
        """This clock's verdict on `rep` from its heartbeat sidecars."""
        from rocm_mpi_tpu_torch.telemetry import health as _health

        beats, _skipped = _health.load_heartbeats(directory)
        if not beats:
            return False
        key = tuple(_health._progress_key(doc) for _rank, doc in sorted(beats.items()))
        prev = self._hb_progress.get(rep.id)
        if prev is None or prev[0] != key:
            self._hb_progress[rep.id] = (key, now)
            return False
        return rep.depth() > 0 and now - prev[1] > self.stall_grace_s

    # ---- the autoscaler (ElasticPolicy, promoted) -----------------------

    def maybe_scale(self) -> bool:
        """Whole-replica elasticity on AGGREGATE queue depth: grow when the
        fleet backlog exceeds grow_queue_depth per live replica (and the
        policy + replica budget agree), retire the highest-id replica
        after sustained fleet idleness (rc-75 is the clean drain signal a
        real retired replica exits with)."""
        policy = self.policy
        if policy is None:
            return False
        live = self.healthy_replicas()
        n_live = len(live)
        depth = self.fleet_depth()
        if depth >= self.grow_queue_depth * max(n_live, 1) and policy.wants_grow(
                n_live, self.max_replicas, step=self._tick,
                last_change_step=self._last_scale_tick):
            rid = max(r.id for r in self.replicas) + 1
            self._spawn(rid)
            self._last_scale_tick = self._tick
            self.autoscale_events.append({
                "event": "fleet.grow", "replica": rid, "replicas": n_live + 1,
                "depth": depth, "tick": self._tick,
            })
            return True
        min_live = max(1, int(getattr(policy, "min_ranks", 1)))
        if depth == 0 and self._idle_ticks >= self.idle_retire_ticks and n_live > min_live:
            victim = max(live, key=lambda r: r.id)
            victim.retiring = True
            # Idle => its queue is empty; the journal proves it owes
            # nothing (reconcile finds no open tickets).
            self._reconcile(victim.id)
            victim.alive = False
            victim.verdict = "retired"
            victim.release()
            self._last_scale_tick = self._tick
            self.autoscale_events.append({
                "event": "fleet.retire", "replica": victim.id, "replicas": n_live - 1,
                "signal": "rc-75", "tick": self._tick,
            })
            return True
        return False

    # ---- the drive loop -------------------------------------------------

    def _harvest(self, rep: Replica) -> None:
        """Journal each ticket that reached a terminal state on `rep` since
        the last harvest — the router is the single journal writer, and a
        drain boundary is the only place terminals appear (a drain leaves
        nothing in flight)."""
        for rid_req, rec in self._tickets.items():
            if rec.journaled or rec.replica != rep.id:
                continue
            state = rec.ticket.state
            if state in TERMINAL_STATES:
                self.journal.record_terminal(rid_req, state, replica=rep.id)
                rec.journaled = True

    def _overdue(self, now: float) -> dict[int, list[str]] | None:
        """The tickets each healthy replica must expire at `now`: None on
        one rank (each queue applies the clock itself); on several, rank
        0's verdict, broadcast only when some queued ticket carries a
        deadline (the condition is the same on every rank)."""
        if not self._multi:
            return None
        live = self.healthy_replicas()
        if not any(rep.svc.queue.has_deadlines() for rep in live):
            return {}
        return _rank0({rep.id: rep.svc.queue.overdue_ids(now) for rep in live})

    def drive_once(self) -> int:
        """One fleet tick: consume due replica faults, poll health,
        autoscale, then expire-and-drain each healthy replica with the
        router's clock and harvest its terminals. Returns requests served
        this tick."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.resilience import faults

        self._tick += 1
        for rep in list(self.replicas):
            if not rep.alive:
                continue
            if faults.replica_fault("replica-kill", step=self._tick, replica=rep.id):
                self.kill_replica(rep.id, verdict="injected-kill")
                continue
            if faults.replica_fault("replica-stall", step=self._tick, replica=rep.id):
                self.demote_replica(rep.id, verdict="injected-stall")
        self.poll_health()
        self.maybe_scale()
        served = 0
        now = time.monotonic()
        overdue = self._overdue(now)
        for rep in self.healthy_replicas():
            # The single-writer clock: the ROUTER expires overdue tickets;
            # the replica's pop never consults wall time.
            rep.svc.queue.expire_overdue(now, None if overdue is None
                                         else overdue.get(rep.id, ()))
            n, _preempted = rep.svc.drain_once()
            served += n
            self._harvest(rep)
        depth = self.fleet_depth()
        self._idle_ticks = self._idle_ticks + 1 if depth == 0 else 0
        telemetry.gauge("fleet.replicas_live", float(len(self.healthy_replicas())))
        telemetry.gauge("fleet.depth", float(depth))
        telemetry.gauge("fleet.demoted",
                        float(sum(1 for r in self.replicas if r.alive and r.demoted)))
        return served

    def drive(self, max_ticks: int = 1000) -> int:
        """Drain the fleet: tick until every healthy replica is empty (or a
        preemption notice stops the loop at a tick boundary — queued work
        stays queued and journaled, nothing is lost). Returns total
        served."""
        from rocm_mpi_tpu_torch.resilience import preempt

        served = 0
        for _ in range(int(max_ticks)):
            stop = preempt.requested()
            if self._multi:
                stop = _rank0(stop)
            if stop:
                self.preempted = True
                break
            served += self.drive_once()
            if self.fleet_depth() == 0:
                break
            delays = [d for d in (r.svc.queue.next_ready_delay()
                                  for r in self.healthy_replicas()) if d]
            if delays:
                time.sleep(min(min(delays), 0.25))
        return served

    # ---- accounting and the merged report -------------------------------

    def journal_state(self) -> _journal.JournalState:
        return _journal.replay(self.journal.segments())

    def check_accounting(self) -> list[str]:
        """The fleet invariant at drain: every journaled ticket has exactly
        one terminal state fleet-wide, and every LIVE replica's own books
        balance. Dead replicas are exactly why the journal — not their
        counters — is the source of truth."""
        problems = _journal.exactly_one_terminal(self.journal_state())
        for rep in self.healthy_replicas():
            problems += [f"replica {rep.id}: {p}"
                         for p in rep.svc.queue.check_accounting(in_flight=0)]
        return problems

    def merged_counters(self) -> dict:
        """Fleet-wide terminal counters, JOURNAL-derived (a killed
        replica's queue counters died with it); retries are summed from
        the replicas that are still readable."""
        state = self.journal_state()
        term = state.terminal_counts()
        return {
            "submitted": len(state.tickets),
            "completed": term["done"],
            "failed": term["failed"],
            "rejected": term["rejected"],
            "expired": term["expired"],
            "quarantined": term["quarantined"],
            "retries": sum(int(r.svc.retries_total) for r in self.replicas),
        }

    def report_doc(self, stream_paths=()) -> dict:
        """The merged fleet report (`rmt-fleet-report` v1): replica rows,
        the journal-derived merged SLO block (latencies from the telemetry
        streams when the run banked any), the journal accounting block,
        and the autoscale trail."""
        from rocm_mpi_tpu_torch.telemetry import compiles

        state = self.journal_state()
        accounting_ok = not self.check_accounting()
        # In-process replicas share one compile tap; each row carries the
        # shared window's count (0 stays 0 for every replica).
        steady = compiles.snapshot()["steady_recompiles"]
        rows = [rep.row(steady) for rep in self.replicas]
        slo = _slo.slo_block(self.merged_counters(), stream_paths)
        return _journal.fleet_report_doc(rows, slo, state.counts(),
                                         accounting_ok=accounting_ok,
                                         autoscale=self.autoscale_events)
