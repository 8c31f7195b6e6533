"""2D heat diffusion — the profiling variant of the overlap app; counterpart
of apps/diffusion_2d_perf_hide_prof.py (the reference's
diffusion_2D_perf_hide_prof.jl).

The reference forks its overlap app into a profiling file: a 12-step
warmup, then a 300-step profiled run, and a text report in ./prof.txt.
Here the profiler is torch.profiler (CPU and, on the card, CUDA
activity through CUPTI): the warmup runs outside the profiler window,
the timed run inside it, each rank writes its Chrome trace to
`--profile` (default prof_trace/trace-rank<r>.json), and rank 0 writes
`--report` (default prof.txt): the wall-time phases, then every
device-side event of the window (the stencil kernels, NCCL's kernels,
copies) with its device ms a step from key_averages(), the stencil
kernels beside their bytes bound a step (T and Cm read once, the new
field written once, over the card's memory rate: PERF.md §6's formula).
On the card, a window without CUDA activity fails. Reference defaults:
8192², nt = 300, 12 warmup steps, b_width (32, 8), f32.

The loop is the scan driver's by default, on one rank and on several:
the profiled window replays the CUDA graphs the run captured in its
warmup (over NCCL with the halo exchange inside), as the JAX twin
profiles the compiled program its run executes; `--driver step` profiles
the eager loop. The graphs end (profiled_run returns) before the process
group is destroyed: destroy_process_group waits for ever while graphs
holding NCCL work on its communicator are alive (four H100 ranks,
scripts/torch_twin_scan.py's `-keepalive` cases, with or without the
profiler), which is also why parallel/distributed.finalize releases
every loop's graphs first.

  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof                    # one GPU
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof   # 2×2, scan driver
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof --device cpu --nx 64 --ny 64
"""

import math
import pathlib
import sys

from rocm_mpi_tpu_torch.apps._common import (
    card_line,
    check_vis,
    device_events,
    finish_field,
    make_parser,
    parse_ints,
    setup_observability,
    where_line,
)

# Memory bytes/s of the card by name (NVIDIA data sheets, the full power
# limit), first hit wins; chip_smoke.py's PEAKS table.
MEMORY_RATES = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                ("H100", 3.35e12))
# Fragments of the kernels whose bytes bound a step is the stencil's
# three passes (T and Cm read, the new field written).
STENCIL_KERNELS = ("fused_step_cm", "masked_step")


def memory_rate(name: str) -> float:
    return next((rate for frag, rate in MEMORY_RATES if frag in name), MEMORY_RATES[-1][1])


def pick_driver(requested: str | None, ranks: int, device_type: str) -> str:
    """The loop form: `requested`, by default scan, whatever the ranks and
    the device (the module docstring)."""
    return "scan" if requested is None else requested


def main(argv=None) -> int:
    parser = make_parser("hide", nx=8192, ny=8192, nt=300, dtype="f32")
    parser.set_defaults(warmup=12, profile="prof_trace", b_width="32,8", driver=None)
    parser.add_argument("--report", default="prof.txt",
                        help="text report path (the reference's ./prof.txt)")
    args = parser.parse_args(argv)
    if args.checkpoint or args.resume:
        # The profiling app times a profiler window, not a durable run.
        print("--checkpoint/--resume are not supported by the profiling app; use the "
              "perf/hide apps for durable runs")
        return 2
    check_vis(args)
    if not 0 <= args.warmup < args.nt:
        parser.error(f"need 0 <= warmup < nt, got warmup={args.warmup} nt={args.nt} "
                     "(the default warmup is 12 — raise --nt or lower --warmup)")

    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.utils import metrics

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me = distributed.rank()
    args.driver = pick_driver(args.driver, distributed.world_size(), device.type)
    setup_observability(args, me)
    shape = (args.fact * 1024,) * 2 if args.fact else (args.nx, args.ny)
    cfg = DiffusionConfig(global_shape=shape, lengths=(10.0, 10.0), nt=args.nt,
                          warmup=args.warmup, dtype=args.dtype, dims=parse_ints(args.dims),
                          b_width=parse_ints(args.b_width), wire_mode=args.wire_mode)
    model = HeatDiffusion(cfg, device=device)
    grid = model.grid
    timed = cfg.nt - cfg.warmup
    T, warm_s, wtime, window = profiled_run(args, model, device, me)
    wtime_it = metrics.wtime_per_it(wtime, cfg.nt, cfg.warmup)
    t_eff = metrics.t_eff_gbs(cfg.global_shape, T.element_size(), wtime_it)
    gpts = metrics.gpts_per_s(cfg.global_shape, wtime_it)
    if me == 0:
        lines = report_lines(args, cfg, grid, device, T, warm_s, wtime, wtime_it, t_eff, gpts,
                             window, timed)
        report = pathlib.Path(args.report)
        report.parent.mkdir(parents=True, exist_ok=True)
        report.write_text("\n".join(lines) + "\n")
        print(f"Executed {timed} steps ({cfg.warmup} warmup, outside the profiler) in = "
              f"{wtime:.3e} sec (@ T_eff = {t_eff:.2f} GB/s aggregate, {gpts:.4f} Gpts/s) "
              f"on {where_line(device)}", flush=True)
        print(f"wrote {report} and {window.path.parent}/", flush=True)
    finish_field(args, T, grid, "hide", lambda msg: print(msg, flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize()
    distributed.finalize()
    return 0


def profiled_run(args, model, device, rank: int):
    """The warmup outside the profiler window, then the timed steps inside
    it: (T, warmup s, timed s, the window). The advance, and with it the
    scan driver's CUDA graphs, ends with this call, before the caller
    destroys the process group: the graphs replay NCCL work on its
    communicator."""
    from rocm_mpi_tpu_torch.apps._common import _Profile
    from rocm_mpi_tpu_torch.utils import metrics

    cfg, grid = model.config, model.grid
    T, Cp = model.init_state()
    if args.driver == "scan":
        advance, _ = model.scan_advance_fn("hide", nt=cfg.nt, warmup=cfg.warmup)
    else:
        advance = model.advance_fn("hide")
    sharded = grid.nprocs > 1
    warm = metrics.Timer()
    warm.tic(T)
    if cfg.warmup:
        T = advance(T, Cp, cfg.warmup)  # outside the profiler window
    metrics.settle(T, sharded, grid.group)
    warm_s = warm.toc()
    window = _Profile(args.profile, device, rank)
    timer = metrics.Timer()
    with window:
        timer.tic()
        T = advance(T, Cp, cfg.nt - cfg.warmup)
        metrics.settle(T, sharded, grid.group)
        wtime = timer.toc()
    return T, warm_s, wtime, window


def report_lines(args, cfg, grid, device, T, warm_s, wtime, wtime_it, t_eff, gpts, window,
                 timed) -> list[str]:
    """prof.txt: the wall-time phases, then the window's device events a
    step (rank 0's), the stencil kernels beside their bytes bound."""
    import torch

    on = (f"{torch.cuda.get_device_name(device)} ({card_line()})" if device.type == "cuda"
          else "the host CPU (plain PyTorch versions, not a GPU measurement)")
    lines = [
        f"profile report — diffusion_2d_perf_hide_prof (grid {cfg.global_shape}, "
        f"nt={cfg.nt}, warmup={cfg.warmup}, b_width={cfg.b_width}, dtype={cfg.dtype}, "
        f"process grid {grid.dims}, {grid.nprocs} rank(s), driver {args.driver}) on {on}",
        "",
        f"warmup walltime       : {warm_s:.6e} s ({cfg.warmup} steps, outside the profiler)",
        f"timed walltime        : {wtime:.6e} s ({timed} steps, under the profiler)",
        f"per-step walltime     : {wtime_it:.6e} s",
        f"T_eff                 : {t_eff:.3f} GB/s",
        f"throughput            : {gpts:.4f} Gpts/s",
        f"trace (Chrome)        : {window.path}",
        "",
    ]
    events = sorted(device_events(window.prof), key=lambda e: -e.self_device_time_total)
    if not events:
        lines.append("no device events (a CPU run: the plain versions have no kernels)")
        return lines
    cells = math.prod(grid.local_shape)
    bound = 3 * cells * T.element_size() / memory_rate(torch.cuda.get_device_name(device)) * 1e3
    lines.append(f"rank 0's device events, ms a step over {timed} steps (stencil bound a "
                 f"step {bound:.4f} ms: 3 passes of the {grid.local_shape} shard over the "
                 "card's memory rate):")
    lines.append(f"  {'ms/step':>10} {'calls/step':>10}  kernel")
    stencil_ms = 0.0
    for e in events:
        ms = e.self_device_time_total / timed / 1e3
        if any(k in e.key for k in STENCIL_KERNELS):
            stencil_ms += ms
        lines.append(f"  {ms:10.4f} {e.count / timed:10.2f}  {e.key[:100]}")
    if stencil_ms:
        lines.append(f"stencil kernels together: {stencil_ms:.4f} ms a step, "
                     f"{bound / stencil_ms:.2f} of their bytes bound")
    return lines


if __name__ == "__main__":
    sys.exit(main())
