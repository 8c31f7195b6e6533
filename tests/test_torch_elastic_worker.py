"""Rank program of the port's elastic drills (tests/test_torch_elastic.py
and tests/test_torch_resilience.py run it through
resilience.run_elastic and parallel/launcher.spawn_app_ranks); the
counterpart of tests/elastic_worker.py. No test lives here.

Each rank joins the gloo group the launcher's torchrun variables
describe, builds the diffusion model on whatever process grid the current
rank count gives, resumes from the latest valid checkpoint step — saved
on any grid: each rank reads the shards that overlap its block — and runs
the segmented checkpointed loop to nt. The fault plan comes from
RMT_INJECT_FAULT; the flight recorder (RMT_HEALTH) gives the watchdog its
progress, RMT_PREEMPT_GRACE_S arms the SIGTERM handler.

    python tests/test_torch_elastic_worker.py --dir CK [--nx 16 --ny 16 --nt 16 --every 4]

`--fault-steps N` runs the launcher drills' rank instead (the counterpart
of tests/resilience_worker.py): N "segment" fault points and no process
group, so an injected kill/die strikes exactly the rank and step named;
`--hang-after` then blocks, the stand-in for a collective that never
completes once a peer is gone. `reshard_rank` (the 2×2 save-and-reshard
rank of tests/test_torch_resilience.py) and `continue_rank` (a drill's
continuation twin) run under parallel/launcher.spawn_ranks.
"""

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nt", type=int, default=16)
    p.add_argument("--every", type=int, default=4)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--dir", required=True)
    # Grow and preemption drills: stretch each segment, so that the rejoin
    # probe's SIGTERM lands while the run is still mid-flight.
    p.add_argument("--segment-delay-s", type=float, default=0.0)
    p.add_argument("--fault-steps", type=int, default=0)
    p.add_argument("--hang-after", action="store_true")
    args = p.parse_args(argv)
    if args.fault_steps:
        return fault_steps(args.fault_steps, args.hang_after)

    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.resilience import preempt
    from rocm_mpi_tpu_torch.telemetry import flight
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    preempt.install_from_env()
    distributed.maybe_initialize_distributed("cpu")
    if flight.enable_from_env():
        flight.install_postmortem_handler()
    try:
        cfg = DiffusionConfig(global_shape=(args.nx, args.ny), lengths=(10.0, 10.0),
                              nt=args.nt, warmup=0, dtype="f64")
        model = HeatDiffusion(cfg, device="cpu")
        grid = model.grid
        T, Cp = model.init_state()
        advance = model.advance_fn("perf")

        def adv(s, n):
            if args.segment_delay_s > 0:
                time.sleep(args.segment_delay_s)
            return (advance(s[0], Cp, n),)

        start = ckpt.latest_valid_step(args.dir, grid=grid) or 0
        state = ckpt.restore_state(args.dir, start, (T,), grid=grid) if start else (T,)
        if start < args.nt:
            ckpt.run_segmented(adv, state, args.nt, args.dir, args.every, start_step=start,
                               keep=args.keep, grid=grid)
        print(f"ELASTIC_WORKER_DONE rank={distributed.rank()} dims={grid.dims} "
              f"start={start}", flush=True)
    finally:
        distributed.finalize()
    return 0


def fault_steps(steps: int, hang_after: bool) -> int:
    """The launcher drills' rank: `steps` fault points 50 ms apart, then
    (hang_after) a block the launcher must put down."""
    import os

    from rocm_mpi_tpu_torch.resilience import faults

    for step in range(1, steps + 1):
        faults.fault_point("segment", step=step)
        time.sleep(0.05)
    print(f"WORKER_DONE rank={os.environ.get('RMT_PROCESS_ID')}", flush=True)
    if hang_after:
        time.sleep(3600)
    return 0


def reshard_rank(rank, spec):
    """One rank of a 2×2 gloo grid: the diffusion perf run checkpointed to
    spec["nt"] in spec["dir"], then its live state resharded onto a 2×1
    grid (ranks 2 and 3 outside it) and back onto 2×2. Returns this rank's
    final shard, its 2×1 block (None outside) and the 2×2 round trip."""
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
    from rocm_mpi_tpu_torch.resilience import reshard
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    cfg = DiffusionConfig(global_shape=spec["shape"], nt=spec["nt"], warmup=0, dtype="f64",
                          dims=(2, 2))
    model = HeatDiffusion(cfg, device="cpu")
    T, Cp = model.init_state()
    advance = model.advance_fn("perf")
    out = ckpt.run_segmented(lambda s, n: (advance(s[0], Cp, n),), (T,), spec["nt"],
                             spec["dir"], spec["every"], grid=model.grid)
    narrow = init_global_grid(*spec["shape"], dims=(2, 1), nprocs=2, rank=rank) \
        if rank < 2 else None
    moved = reshard.reshard_state(out, model.grid, narrow, like=out)
    back = reshard.reshard_state(moved, narrow, model.grid, like=out)
    return dict(shard=out[0].numpy(), narrow=None if moved is None else moved[0].numpy(),
                back=back[0].numpy())


def continue_rank(rank, spec):
    """One rank of a continuation twin: the checkpoint at spec["start"] in
    spec["dir"] restored onto spec["dims"] and advanced by the perf step
    to spec["nt"]; returns this rank's shard."""
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    cfg = DiffusionConfig(global_shape=spec["shape"], lengths=(10.0, 10.0), nt=spec["nt"],
                          warmup=0, dtype="f64", dims=spec["dims"])
    model = HeatDiffusion(cfg, device="cpu")
    T, Cp = model.init_state()
    (T,) = ckpt.restore_state(spec["dir"], spec["start"], (T,), grid=model.grid)
    return model.advance_fn("perf")(T, Cp, spec["nt"] - spec["start"]).numpy()


if __name__ == "__main__":
    sys.exit(main())
