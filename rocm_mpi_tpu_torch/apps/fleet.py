"""The fleet driver: N simulation-service replicas behind one router —
counterpart of apps/fleet.py (docs/SERVING.md "The fleet";
serving/router.py has the policy).

Builds an in-process fleet — N independent `SimulationService` replicas,
one `FleetRouter` front end, one durable ticket journal — serves a
deterministic synthetic trace through it, and banks the fleet sidecars
under --out:

    fleet-journal.jsonl    the append-only ticket journal
                           (rmt-fleet-journal v1, schema-checked)
    fleet-report.json      the merged fleet report (rmt-fleet-report
                           v1: replica rows, journal-derived SLO
                           block, accounting verdict, autoscale trail)

Fault drills ride the standard grammar (--inject-fault
"replica-kill@step=2,rank=1" kills replica 1 at fleet tick 2; the router
reconciles from the journal and the run still has to balance). On
several ranks (torchrun) every rank runs the same router and each
replica's service spans the ranks; rank 0 banks the sidecars.

Exit codes: 0 fleet drained clean and every journaled ticket reached
exactly one terminal state; 1 accounting broke or a request failed/was
quarantined; 75 preempted (queued work journaled, rc 75 is the
scheduler's requeue signal); 2 usage.

  python -m rocm_mpi_tpu_torch.apps.fleet --device cpu --synthetic 12 --out /tmp/f
  python -m rocm_mpi_tpu_torch.apps.fleet --device cpu --inject-fault replica-kill@step=2,rank=1
  torchrun --nproc-per-node 2 -m rocm_mpi_tpu_torch.apps.fleet --device cpu --synthetic 6
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import shutil
import sys
import tempfile

from rocm_mpi_tpu_torch.apps._common import (
    add_health_flag,
    add_telemetry_flag,
    finalized,
    finish_observability,
    positive_int,
    setup_observability,
)


def make_parser():
    p = argparse.ArgumentParser(
        description="multi-replica serving fleet: router + journal + "
        "N SimulationService replicas (docs/SERVING.md 'The fleet')"
    )
    p.add_argument("--replicas", type=positive_int, default=3,
                   help="fleet size at launch (default 3)")
    p.add_argument("--synthetic", type=positive_int, default=None, metavar="N",
                   help="serve N deterministic synthetic requests (default 12)")
    p.add_argument("--seed", type=int, default=1,
                   help="synthetic-trace seed (determinism contract)")
    p.add_argument("--nt-max", type=positive_int, default=64,
                   help="synthetic per-request step-count cap")
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                   help="synthetic-trace dtype")
    p.add_argument("--max-width", type=positive_int, default=8,
                   help="widest batch lane count per replica")
    p.add_argument("--max-depth", type=positive_int, default=None,
                   help="per-replica admission bound: the router spills over it and "
                   "fleet-full rejects carry the MERGED retry-after hint (default: "
                   "unbounded)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs every replica's programs on the GPU (one a rank); cpu "
                   "their plain versions")
    p.add_argument("--sessions", default=None, metavar="DIR",
                   help="session root: each replica checkpoints its sessions under "
                   "DIR/replica-<id>/")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="stamp every synthetic request with this TTL (expired by the "
                   "ROUTER's clock — replicas never own wall time)")
    p.add_argument("--elastic", action="store_true",
                   help="promote ElasticPolicy to the fleet autoscaler: grow/retire "
                   "whole replicas on aggregate queue depth")
    p.add_argument("--max-replicas", type=positive_int, default=None,
                   help="autoscale ceiling (default: --replicas)")
    p.add_argument("--grow-depth", type=positive_int, default=8,
                   help="aggregate backlog per live replica that makes the autoscaler "
                   "consider a grow (--elastic)")
    p.add_argument("--ticks", type=positive_int, default=1000,
                   help="fleet drive-tick budget (bounded drills)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="bank fleet-journal.jsonl + fleet-report.json under DIR")
    p.add_argument("--inject-fault", default=None, metavar="SPEC",
                   help="deterministic fault plan, e.g. 'replica-kill@step=2,rank=1' "
                   "(rank = REPLICA id; resilience/faults.py has the grammar)")
    add_telemetry_flag(p)
    add_health_flag(p)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    from rocm_mpi_tpu_torch.resilience import faults, preempt

    if args.inject_fault:
        faults.install(args.inject_fault)
    preempt.install_from_env()
    with finalized():
        return _main(args)


def _main(args) -> int:
    from rocm_mpi_tpu_torch.apps.serve import synthetic_trace
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.serving import journal as fleet_journal
    from rocm_mpi_tpu_torch.serving.router import FleetRouter
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
    from rocm_mpi_tpu_torch.telemetry import compiles, health

    distributed.maybe_initialize_distributed(args.device)
    me = distributed.rank()
    setup_observability(args, me)
    compiles.install()

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    requests = synthetic_trace(args.synthetic or 12, args.seed, nt_max=args.nt_max,
                               dtype=args.dtype, deadline_s=args.deadline_s)

    # Every rank keeps its own journal (rank 0's is the one banked under
    # --out): the router is a pure fold, so the records agree.
    out = pathlib.Path(args.out) if args.out else None
    scratch = None
    if out is not None and me == 0:
        out.mkdir(parents=True, exist_ok=True)
        journal_path = out / "fleet-journal.jsonl"
    else:
        scratch = pathlib.Path(tempfile.mkdtemp(prefix="rmt-fleet-"))
        journal_path = scratch / "fleet-journal.jsonl"
    journal = fleet_journal.TicketJournal(journal_path)

    policy = None
    if args.elastic:
        from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy

        policy = ElasticPolicy()

    def factory(rid: int) -> SimulationService:
        sessions_dir = None
        if args.sessions:
            sessions_dir = str(pathlib.Path(args.sessions) / f"replica-{rid}")
        return SimulationService(config=ServeConfig(
            max_width=args.max_width, sessions_dir=sessions_dir, device=args.device))

    router = FleetRouter(factory, args.replicas, journal=journal,
                         max_depth_per_replica=args.max_depth, policy=policy,
                         max_replicas=args.max_replicas, grow_queue_depth=args.grow_depth)
    log0(f"fleet up: {args.replicas} replica(s), journal {journal_path} "
         f"(max_width={args.max_width}, max_depth={args.max_depth}, "
         f"ranks={distributed.world_size()}, device={router.replicas[0].svc.device})")

    # This driver is its own submitter: the trace is paced into the fleet
    # in waves with one drive tick between them — a drain pass empties a
    # replica's whole backlog, so up-front submission would finish in one
    # tick and a fault plan keyed to fleet ticks (replica-kill@step=K)
    # could never fire MID-traffic. With --max-depth it also paces
    # against the fleet backlog (drive, then submit) so the fixed trace is
    # never fast-rejected into the void — the fleet-full reject path is
    # for external submitters who can honour the merged retry-after hint.
    served = 0
    wave = max(1, len(requests) // 4)
    for i in range(0, len(requests), wave):
        for r in requests[i:i + wave]:
            if args.max_depth is not None:
                while router.healthy_replicas() and all(
                        rep.depth() >= args.max_depth for rep in router.healthy_replicas()):
                    served += router.drive_once()
            router.submit(r)
        if i + wave < len(requests):
            served += router.drive_once()
    served += router.drive(max_ticks=args.ticks)

    problems = router.check_accounting()
    merged = router.merged_counters()
    stream_paths = ()
    if args.telemetry:
        stream_paths = tuple(sorted(pathlib.Path(args.telemetry).glob("telemetry-rank*.jsonl")))
    doc = router.report_doc(stream_paths=stream_paths)

    log0(f"fleet served {served} batch-request(s): {merged['completed']}/"
         f"{merged['submitted']} done, {merged['failed']} failed, {merged['rejected']} "
         f"rejected, {merged['expired']} expired, {merged['quarantined']} quarantined, "
         f"{merged['retries']} retries")
    for rep in router.replicas:
        state = "up" if rep.healthy else (rep.verdict or "down")
        log0(f"  replica {rep.id}: {state} counters={rep.svc.queue.counters()}")
    for ev in router.autoscale_events:
        log0(f"  autoscale: {ev}")
    jc = doc["journal"]
    log0(f"  journal: {jc['tickets']} ticket(s), {jc['open']} open, {jc['rerouted']} "
         f"rerouted, {jc['torn_lines']} torn")
    # Every rank's map and journal digest: several ranks must agree.
    fmap = ",".join(f"{k}->{v}" for k, v in sorted(router.replica_map().items()))
    digest = hashlib.sha256(journal_path.read_bytes()).hexdigest()[:16]
    print(f"  rank {me}: replica map {fmap}; journal sha256 {digest}", flush=True)
    for p in problems:
        log0(f"  ACCOUNTING: {p}")
    log0(health.format_fleet_status(health.fleet_status(doc)))

    if out is not None and me == 0:
        report_path = out / "fleet-report.json"
        fleet_journal.write_fleet_report(report_path, doc)
        log0(f"banked {journal_path.name} and {report_path.name} "
             f"({len(doc['replicas'])} replica row(s))")
    journal.close()
    if scratch is not None:
        shutil.rmtree(scratch, ignore_errors=True)
    finish_observability(log0)

    if router.preempted:
        log0("preempted: queued work journaled; rc 75 (EX_TEMPFAIL)")
        return 75
    if problems or merged["failed"] or merged["quarantined"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
