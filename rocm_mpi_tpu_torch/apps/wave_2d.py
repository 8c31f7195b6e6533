"""2D/3D acoustic wave — the leapfrog workload on the GPU; counterpart of
apps/wave_2d.py.

Runs AcousticWave with `--variant ap|shard|perf|hide` (per step), or one of
its schedules: `--deep K` (deep-halo sweeps, one width-K exchange of the
state pair per K steps; K must divide both --warmup and nt − warmup, or it
degrades to their gcd) or `--vmem` (one GPU: chunks of 256 steps per
launch of the wave_multi_step kernel). T_eff counts 4 passes of the field
per step (read U, U⁻ and C2; write U⁺).

  python -m rocm_mpi_tpu_torch.apps.wave_2d --dtype f32 --nx 12288 --ny 12288
  python -m rocm_mpi_tpu_torch.apps.wave_2d --vmem --nt 4352 --warmup 256
  python -m rocm_mpi_tpu_torch.apps.wave_2d --deep 8 --nt 1032 --warmup 8
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.wave_2d --variant hide
  python -m rocm_mpi_tpu_torch.apps.wave_2d --device cpu --nx 48 --ny 40 --nt 24 --warmup 8
  python -m rocm_mpi_tpu_torch.apps.wave_2d --device cpu --nx 48 --ny 40 --nt 24 --checkpoint ck
  python -m rocm_mpi_tpu_torch.apps.wave_2d --device cpu --nx 48 --ny 40 --nt 48 --checkpoint ck --resume

`--checkpoint DIR` saves the state (U, U⁻) every `--ckpt-every` steps
(utils/checkpoint.py; with --deep rounded up to a multiple of k) and
`--resume` continues from the latest valid step; `--save-field` writes
the final U.
"""

import sys

from rocm_mpi_tpu_torch.apps._common import (
    add_checkpoint_flags,
    add_save_field_flag,
    base_parser,
    check_vis,
    checkpoint_schedule,
    driver_note,
    emit_run_gauges,
    finalized,
    finish_field,
    finish_observability,
    global_max,
    grid_shape,
    make_checkpoint_runner,
    parse_ints,
    per_step_checkpoint_advance,
    profile_context,
    report_checkpointed_line,
    schedule_note,
    setup_observability,
    setup_resilience,
    where_line,
)


def make_parser():
    p = base_parser("2D/3D acoustic wave — leapfrog", nx=252, ny=252, nt=1000, dtype="f64")
    p.add_argument("--nz", type=int, default=0,
                   help="z grid points (0 or 1: a 2D run)")
    p.add_argument("--variant", default="perf", choices=["ap", "shard", "perf", "hide"])
    sched = p.add_mutually_exclusive_group()
    sched.add_argument("--deep", type=int, default=0, metavar="K",
                       help="deep-halo sweeps: exchange the width-K ghosts of the state "
                       "pair once per K steps instead of width 1 every step")
    sched.add_argument("--vmem", action="store_true",
                       help="chunked multi-step loop (one GPU only)")
    add_save_field_flag(p)
    add_checkpoint_flags(p)
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    check_vis(args)
    setup_resilience(args)
    with finalized():
        return _main(args)


def _main(args) -> int:
    from rocm_mpi_tpu_torch.config import WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave
    from rocm_mpi_tpu_torch.parallel import distributed

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me = distributed.rank()
    setup_observability(args, me)

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    shape = grid_shape(args, 3 if args.nz > 1 else 2)
    cfg = WaveConfig(global_shape=shape, lengths=(10.0,) * len(shape), nt=args.nt,
                     warmup=args.warmup, dtype=args.dtype, dims=parse_ints(args.dims),
                     wire_mode=args.wire_mode)
    model = AcousticWave(cfg, device=device)
    grid = model.grid
    where = where_line(device)
    log0(f"wave grid {grid.global_shape} {cfg.dtype} over process grid {grid.dims} "
         f"({grid.nprocs} rank(s)) on {where}")
    note = ""
    label = args.variant
    if args.checkpoint:
        if args.vmem:
            log0("--checkpoint supports the per-step and deep schedules; drop --vmem")
            distributed.finalize()
            return 2
        from rocm_mpi_tpu_torch.models.wave import WaveRunResult

        make_advance, quantum = checkpoint_schedule(
            args, model, lambda: per_step_checkpoint_advance(args, model, args.variant))

        def advance_state():
            advance = make_advance()
            U, Uprev, C2 = model.init_state()

            def seg(s, n):
                return tuple(advance(s[0], s[1], C2, n))

            seg.loop = getattr(advance, "loop", None)
            return seg, (U, Uprev)

        runner = make_checkpoint_runner(
            args, log0, advance_state,
            lambda s, ran, wtime: WaveRunResult(U=s[0], wtime=wtime, nt=ran, warmup=0,
                                                config=cfg),
            quantum=quantum, grid=grid)
        with profile_context(args, device, me):
            result = runner()
        report_checkpointed_line(result, args, log0, where)
        emit_run_gauges(result, args.variant, wire=args.wire_mode)
    else:
        if args.deep:
            k = model.effective_deep_depth(block_steps=args.deep, warn=False)
            label = f"deep{k}"
            log0(f"--deep: running deep-halo sweeps (k={k}"
                 + (f", degraded from {args.deep}" if k != args.deep else "")
                 + ") instead of the per-step variant")
            with profile_context(args, device, me):
                result = model.run_deep(block_steps=k)
            driver = "deep"
        elif args.vmem:
            if grid.nprocs != 1:
                log0(f"--vmem requires a one-rank grid (the loop is unsharded); the process "
                     f"grid is {grid.dims}")
                distributed.finalize()
                return 2
            label = "vmem"
            with profile_context(args, device, me):
                result = model.run_vmem_resident()
            driver = "vmem"
        else:
            label = args.variant
            with profile_context(args, device, me):
                result = model.run(args.variant, driver=args.driver)
            driver = args.driver
            note = f"; {driver_note(args, result)}"
        emit_run_gauges(result, label, driver=driver, wire=args.wire_mode)
        if result.route is not None and not note:
            log0(f"{label}: {schedule_note(result)}, {result.k} steps per launch or sweep; "
                 "T_eff counts 4 passes per step, so it is an effective rate")
        log0(f"{label}: executed {result.nt} steps ({result.warmup} warmup) in = "
             f"{result.wtime:.3e} sec (@ T_eff = {result.t_eff:.2f} GB/s aggregate, "
             f"{result.gpts:.4f} Gpts/s) on {where}{note}")
    log0(f"maximum(|U|) = {global_max(result.U.abs())}")
    if args.do_vis and len(grid.global_shape) != 2:
        log0("--vis is 2D-only (heatmap); skipping the artifact")
        args.do_vis = False
    finish_field(args, result.U, grid, f"wave_{label}", log0)
    finish_observability(log0)
    distributed.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
