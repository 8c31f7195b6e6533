"""Multi-tenant batched simulation service — the serving-layer driver,
counterpart of apps/serve.py (docs/SERVING.md).

One-shot trace mode (default): load a request trace (--trace FILE.jsonl,
rmt-serve-request records) or generate a deterministic synthetic mix
(--synthetic N --seed S, the JAX app's records for the same seed), serve
it through serving.SimulationService, print the bin report, and bank the
sidecars under --out:

    serve-requests.jsonl   the served trace
    serve-manifest.json    bins/programs/occupancy/waste accounting

Daemon mode (--serve): drain the queue until idle for --idle-exit-s (a
SIGTERM preemption notice requeues pending work and exits rc 75).

Exit codes: 0 served clean (rejected/expired are the SLO machinery
working, not app failures); 1 any request failed or was quarantined; 75
preempted (pending work requeued in the manifest); 2 usage.

  python -m rocm_mpi_tpu_torch.apps.serve --device cpu --synthetic 12 --out /tmp/s
  torchrun --nproc-per-node 2 -m rocm_mpi_tpu_torch.apps.serve --device cpu --synthetic 12
  python -m rocm_mpi_tpu_torch.apps.serve --trace trace.jsonl --out out/   # one GPU
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys

from rocm_mpi_tpu_torch.apps._common import (
    add_health_flag,
    add_telemetry_flag,
    finalized,
    finish_observability,
    positive_int,
    setup_observability,
)

SYNTH_SHAPES = ((16, 16), (24, 24), (32, 32))
SYNTH_WORKLOADS = ("diffusion", "wave", "swe")

# The heavy-tailed mix rides shapes a rung apart on purpose: with
# --ladder, (30, 30) embeds into the (32, 32) rung and the two classes
# consolidate into one compiled program; (16, 16) stays its own rung.
HEAVY_SHAPES = ((30, 30), (32, 32), (16, 16))


def synthetic_trace(n: int, seed: int, nt_max: int = 64,
                    dtype: str = "f32", sessions: bool = False,
                    deadline_s: float | None = None):
    """Deterministic heterogeneous request mix: >=3 shape classes,
    mixed workloads/physics/step counts — the acceptance-trace shape
    (50 requests through the serve app compile exactly len(bins)
    programs). `deadline_s` stamps every request with a TTL
    (docs/SERVING.md "SLOs and admission")."""
    from rocm_mpi_tpu_torch.serving.queue import Request

    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        wl = SYNTH_WORKLOADS[i % len(SYNTH_WORKLOADS)]
        shape = SYNTH_SHAPES[rng.randrange(len(SYNTH_SHAPES))]
        nt = rng.randrange(max(nt_max // 2, 1), nt_max + 1)
        physics = ()
        if wl == "diffusion" and rng.random() < 0.3:
            physics = (("lam", rng.choice([0.5, 1.0])),)
        reqs.append(Request(
            request_id=f"synth-{seed}-{i:04d}",
            workload=wl,
            global_shape=shape,
            dtype=dtype,
            nt=nt,
            physics=physics,
            ic_scale=1.0 + 0.01 * (i % 17),
            session=f"sess-{i:04d}" if sessions else None,
            deadline_s=deadline_s,
        ))
    return reqs


def heavy_tailed_trace(n: int, seed: int, nt_max: int = 64,
                       dtype: str = "f32",
                       deadline_s: float | None = None):
    """Heavy-tailed mixed-shape synthetic mix — the continuous-batching
    acceptance trace (docs/SERVING.md "Continuous batching"): most
    requests finish in a handful of steps while a Pareto tail runs to
    `nt_max`, so a batch-synchronous drain strands resolved lanes
    behind the longest tenant where the segmented drain swaps queued
    work into their slots at segment boundaries. Shapes mix off-rung
    domains with their rung (HEAVY_SHAPES) so `--ladder` can
    consolidate program classes on the same trace; the occasional SWE
    request exercises the ladder's eligibility exclusion."""
    from rocm_mpi_tpu_torch.serving.queue import Request

    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        # Diffusion-heavy (the ladder-eligible class), wave for the
        # second eligible physics, SWE rarely (never laddered).
        r = rng.random()
        wl = "swe" if r < 0.1 else ("wave" if r < 0.35 else "diffusion")
        shape = HEAVY_SHAPES[rng.randrange(len(HEAVY_SHAPES))]
        nt = min(nt_max, 2 + int(2.0 * rng.paretovariate(1.2)))
        reqs.append(Request(
            request_id=f"heavy-{seed}-{i:04d}",
            workload=wl,
            global_shape=shape,
            dtype=dtype,
            nt=nt,
            physics=(),
            ic_scale=1.0 + 0.01 * (i % 17),
            session=None,
            deadline_s=deadline_s,
        ))
    return reqs


def make_parser():
    p = argparse.ArgumentParser(
        description="multi-tenant batched simulation service "
        "(docs/SERVING.md)"
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None, metavar="FILE.jsonl",
                     help="serve this request trace "
                     "(rmt-serve-request records, one per line)")
    src.add_argument("--synthetic", type=positive_int, default=None,
                     metavar="N", help="serve N deterministic synthetic "
                     "requests (default 12)")
    p.add_argument("--seed", type=int, default=1,
                   help="synthetic-trace seed (determinism contract)")
    p.add_argument("--nt-max", type=positive_int, default=64,
                   help="synthetic per-request step-count cap")
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"],
                   help="synthetic-trace dtype")
    p.add_argument("--max-width", type=positive_int, default=8,
                   help="widest batch lane count (pow2-capped)")
    p.add_argument("--occupancy-floor", type=float, default=None,
                   help="min live/width per batch (default: the "
                   "serving budgets row, serving/service.SERVING_BUDGETS)")
    p.add_argument("--batch-dims", type=positive_int, default=1,
                   help="batch rows along the lane axis (rows beyond the ranks a "
                   "row's space grid leaves fold onto a rank as lane slices)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the programs on the GPU (one a rank); cpu their "
                   "plain versions")
    p.add_argument("--sessions", default=None, metavar="DIR",
                   help="checkpoint-multiplex root: requests with a "
                   "session id save their final state under DIR/<id>/")
    p.add_argument("--synthetic-sessions", action="store_true",
                   help="give every synthetic request a session id "
                   "(needs --sessions)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="bank serve-requests.jsonl + serve-manifest.json "
                   "under DIR")
    p.add_argument("--elastic", action="store_true",
                   help="consume the ElasticPolicy: grow batch rows when "
                   "the queue is deep, shrink when idle")
    p.add_argument("--grow-depth", type=positive_int, default=8,
                   help="queue depth that makes the policy consider a "
                   "grow (--elastic)")
    p.add_argument("--serve", action="store_true",
                   help="daemon mode: keep draining until idle for "
                   "--idle-exit-s")
    p.add_argument("--idle-exit-s", type=float, default=2.0,
                   help="daemon idle exit (seconds; --serve)")
    p.add_argument("--max-depth", type=positive_int, default=None,
                   help="admission bound: over-depth submits are "
                   "rejected fast with a retry-after hint "
                   "(default: unbounded)")
    p.add_argument("--retry-budget", type=int, default=None,
                   help="retries per request before quarantine "
                   "(default: the RequestRetryPolicy default)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="stamp every synthetic request with this TTL "
                   "(pending past it fails deadline-exceeded at pop)")
    p.add_argument("--quarantine", default=None, metavar="FILE.jsonl",
                   help="append-only poison-request ledger (default: "
                   "<--out>/quarantine.jsonl when --out is given)")
    p.add_argument("--heavy-tailed", action="store_true",
                   help="heavy-tailed mixed-shape synthetic mix: Pareto "
                   "step counts + rung-apart shapes (the continuous-"
                   "batching acceptance trace; needs --synthetic)")
    p.add_argument("--segments", type=positive_int, default=None,
                   help="continuous batching (docs/SERVING.md): run "
                   "each batch as this many fixed-size step segments "
                   "of ONE compiled program, swapping resolved lanes "
                   "for queued same-class requests at the boundaries "
                   "(default 1 = batch-synchronous)")
    p.add_argument("--no-request-trace", action="store_true",
                   help="disable request-scoped tracing (trace contexts, "
                   "tspan records, per-request latency decomposition — "
                   "docs/TELEMETRY.md 'Request tracing'); the bench "
                   "overhead rung's tracing-off arm")
    p.add_argument("--ladder", action="store_true",
                   help="shape-padding ladder: pad eligible lanes up "
                   "to their rung so rung-sharing shapes consolidate "
                   "into one compiled program class")
    p.add_argument("--pipeline-depth", type=positive_int, default=None,
                   help="drain pipeline depth (docs/SERVING.md 'The "
                   "pipeline'): 1 = serial drain, 2 (default) = "
                   "double-buffered — batch N+1 assembles/dispatches "
                   "while batch N computes; results bitwise-equal at "
                   "any depth")
    add_telemetry_flag(p)
    add_health_flag(p)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    from rocm_mpi_tpu_torch.resilience import preempt

    # Preemption awareness: SIGTERM → grace-deadline notice → the drain
    # loop requeues pending work and exits 75 (resilience/preempt.py).
    preempt.install_from_env()
    with finalized():
        return _main(args)


def _main(args) -> int:
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.serving.queue import load_trace, request_to_record
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
    from rocm_mpi_tpu_torch.telemetry import compiles

    distributed.maybe_initialize_distributed(args.device)
    me = distributed.rank()
    setup_observability(args, me)
    # Compile accounting is the steady-state contract's instrument: armed
    # even without telemetry, so the report's steady_state is measured.
    compiles.install()

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    if args.trace:
        requests = load_trace(args.trace)
    else:
        n = args.synthetic or 12
        if args.synthetic_sessions and not args.sessions:
            print("--synthetic-sessions needs --sessions DIR", file=sys.stderr)
            return 2
        if args.heavy_tailed:
            if args.synthetic_sessions:
                print("--heavy-tailed is sessionless (drop --synthetic-sessions)",
                      file=sys.stderr)
                return 2
            requests = heavy_tailed_trace(n, args.seed, nt_max=args.nt_max, dtype=args.dtype,
                                          deadline_s=args.deadline_s)
        else:
            requests = synthetic_trace(n, args.seed, nt_max=args.nt_max, dtype=args.dtype,
                                       sessions=args.synthetic_sessions,
                                       deadline_s=args.deadline_s)

    policy = None
    if args.elastic:
        from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy

        policy = ElasticPolicy()
    retry = None
    if args.retry_budget is not None:
        from rocm_mpi_tpu_torch.resilience.policy import RequestRetryPolicy

        retry = RequestRetryPolicy(budget=max(args.retry_budget, 0))
    quarantine = args.quarantine
    if quarantine is None and args.out and me == 0:
        out_dir = pathlib.Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        quarantine = str(out_dir / "quarantine.jsonl")

    cfg_kw = {}
    if args.pipeline_depth is not None:
        cfg_kw["pipeline_depth"] = args.pipeline_depth
    if args.segments is not None:
        cfg_kw["segments"] = args.segments
    if args.ladder:
        cfg_kw["ladder"] = True
    if args.no_request_trace:
        cfg_kw["trace_requests"] = False
    svc = SimulationService(config=ServeConfig(
        max_width=args.max_width, occupancy_floor=args.occupancy_floor,
        batch_dims=args.batch_dims, sessions_dir=args.sessions, policy=policy,
        grow_queue_depth=args.grow_depth, max_depth=args.max_depth, retry=retry,
        quarantine_path=quarantine, device=args.device, **cfg_kw))

    log0(f"serving {len(requests)} request(s) (max_width={args.max_width}, "
         f"batch_dims={args.batch_dims}, pipeline_depth={svc.config.pipeline_depth}, "
         f"ranks={distributed.world_size()}, device={svc.device})")

    def submit_paced(reqs):
        # With --max-depth this driver paces its own submission against
        # the backlog (drain, then submit) instead of rejecting a fixed
        # trace it cannot re-submit; the fast reject is for external
        # submitters that honour the retry-after hint.
        served = 0
        for r in reqs:
            while svc.config.max_depth is not None \
                    and svc.queue.depth() >= svc.config.max_depth:
                served += svc.drain_once()[0]
            svc.queue.submit(r)
        return served

    pre_served = submit_paced(requests)
    if args.serve:
        report = svc.serve_forever(idle_exit_s=args.idle_exit_s)
    else:
        report = svc._drain_all()
    report.served += pre_served

    log0(f"served {report.served}/{len(requests)} ({report.failed} failed, "
         f"{report.requeued} requeued, {report.rejected} rejected, {report.expired} expired, "
         f"{report.quarantined} quarantined) — {report.n_bins} bin(s), "
         f"{report.n_programs} program(s), "
         f"compiles.steady_state={report.compiles.get('steady_state')}")
    pipe = report.pipeline
    if pipe.get("batches"):
        log0(f"  pipeline depth={pipe['depth']} batches={pipe['batches']} "
             f"bubble={pipe['bubble']:.2f} (assemble {pipe['assemble_s']:.3f}s / dispatch "
             f"{pipe['dispatch_s']:.3f}s / fetch {pipe['fetch_s']:.3f}s / resolve "
             f"{pipe['resolve_s']:.3f}s)")
    cont = report.continuous
    if cont:
        log0(f"  continuous segments={cont['segments']} batches={cont['batches']} "
             f"segments_run={cont['segments_run']} swaps_in={cont['swaps_in']} "
             f"swaps_out={cont['swaps_out']} occupancy={cont['occupancy']:.3f}")
    for key, st in sorted(report.bins.items()):
        log0(f"  bin {key.key_str():48s} req={st.requests:3d} batches={st.batches} "
             f"widths={list(st.widths)} occ={st.occupancy:.2f} "
             f"waste={st.padding_waste:.2f}" + (f" splits={st.splits}" if st.splits else ""))
    for ev in report.elastic:
        log0(f"  elastic: {ev}")

    if args.out and me == 0:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        trace_path = out / "serve-requests.jsonl"
        with open(trace_path, "w", encoding="utf-8") as fh:
            for r in requests:
                fh.write(json.dumps(request_to_record(r)) + "\n")
        doc = svc.write_manifest(out / "serve-manifest.json")
        log0(f"banked {trace_path} and serve-manifest.json ({len(doc['bins'])} bin row(s))")
    finish_observability(log0)

    if report.preempted:
        log0("preempted: pending work requeued; rc 75 (EX_TEMPFAIL)")
        return 75
    return 1 if (report.failed or report.quarantined) else 0


if __name__ == "__main__":
    sys.exit(main())
