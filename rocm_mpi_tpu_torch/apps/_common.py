"""Shared CLI driver of the port's apps — counterpart of apps/_common.py:
init grid, IC, timed loop, T_eff/Gpts printout.

Several GPUs run under torchrun, one rank per GPU:

    torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf

Every rate printed on a GPU carries the card's name and power limit;
a CPU run says that it measured the plain versions on the host.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess

from rocm_mpi_tpu_torch.parallel.wire import WIRE_MODES


def base_parser(description: str, *, nx: int, ny: int, nt: int, dtype: str):
    """The options every app of the port shares: grid, steps, dtype,
    process grid, device and the per-step variants' driver."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--nx", type=int, default=nx, help="global grid points, x")
    p.add_argument("--ny", type=int, default=ny, help="global grid points, y")
    p.add_argument("--fact", type=int, default=0,
                   help="if set, every grid axis becomes fact*1024 (the reference perf "
                   "app's 'fact' knob; in 3D this includes nz)")
    p.add_argument("--nt", type=int, default=nt, help="time steps")
    p.add_argument("--warmup", type=int, default=10, help="untimed steps")
    p.add_argument("--dtype", default=dtype, choices=["f32", "f64", "bf16"])
    p.add_argument("--dims", default=None,
                   help="process grid, e.g. 2,2 (default: auto near-square)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand kernels; cpu their plain versions")
    p.add_argument("--driver", default="scan", choices=["step", "scan"],
                   help="loop form of the per-step variants (default: scan, the q-step "
                   "chunks replayed as CUDA graphs on one GPU; step: one Python step "
                   "call after another). Bitwise the same result. The schedules "
                   "(--deep, --vmem) do not take it: on a CUDA rank they always run as "
                   "one captured program, CUDA graphs of their sweeps")
    p.add_argument("--wire-mode", default="f32", choices=list(WIRE_MODES),
                   help="on-wire halo slab precision (parallel/wire.py; default f32, the "
                   "exchange as it is; bf16 halves the wire; int8/int8_delta quantize "
                   "with error feedback and need --deep)")
    return p


def grid_shape(args, ndim: int = 2) -> tuple[int, ...]:
    """The global shape the options ask for: (nx, ny[, nz]), or fact·1024
    on every axis when --fact is set."""
    shape = (args.nx, args.ny, getattr(args, "nz", 0))[:ndim]
    return tuple(args.fact * 1024 for _ in shape) if args.fact else shape


def schedule_note(result) -> str:
    """A schedule's routes for its result line: the local route, and the
    loop that ran its sweeps with its captures' host ms."""
    return (f"route {result.route}, loop route {result.loop_route} (capture "
            f"{result.capture_ms:.1f} ms)")


def driver_note(args, result) -> str:
    """The driver a per-step run took, for its result line: the step
    driver, or the scan driver with its route and q."""
    if args.driver == "step":
        return "driver step"
    return f"driver scan (route {result.route}, q {result.k})"


def make_parser(variant: str, *, nx: int, ny: int, nt: int, dtype: str):
    p = base_parser(f"2D heat diffusion — {variant} variant", nx=nx, ny=ny, nt=nt,
                    dtype=dtype)
    p.add_argument("--deep", type=int, default=0, metavar="K",
                   help="use deep-halo sweeps: exchange width-K ghosts every K steps "
                   "instead of width-1 every step (parallel.deep_halo); K must divide "
                   "both --warmup and nt - warmup, or it degrades to their gcd")
    p.add_argument("--transport", default=None, choices=["ici", "host"],
                   help="halo transport: the device exchange, or host staging (the "
                   "reference's IGG_ROCMAWARE_MPI=1/0; only variant 'shard' runs the "
                   "host-staged oracle, the others warn). Default: $RMT_HALO_TRANSPORT "
                   "or ici")
    if variant == "hide":
        p.add_argument("--b-width", default="32,4",
                       help="boundary frame width, e.g. 32,4 (hide.jl:42; clamped to "
                       "half the shard)")
    p.add_argument("--save-field", default=None, metavar="PATH.npy",
                   help="gather the final field to rank 0 and save it as .npy (bf16 as "
                   "float32), to compare the fields of two apps or runs")
    return p


def parse_ints(text: str | None) -> tuple[int, ...] | None:
    """"2,2" -> (2, 2); None stays None."""
    return tuple(int(d) for d in text.split(",")) if text else None


def where_line(device) -> str:
    """The device a run measured: the card with nvidia-smi's name and power
    limit, or the host CPU (plain versions, never a GPU measurement)."""
    import torch

    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {card_line()})"
    return "the host CPU (plain PyTorch versions, not a GPU measurement)"


def global_max(x) -> float:
    """max over every rank's shard of `x`, on every rank."""
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed

    peak = x.float().max().reshape(1)
    if distributed.is_distributed():
        if distributed.staged(peak):
            peak = peak.cpu()  # gloo carries CPU tensors only
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return float(peak)


def global_sum(x) -> float:
    """Σ over every rank's shard of `x`, taken in f64, on every rank."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed

    total = x.sum(dtype=torch.float64).reshape(1)
    if distributed.is_distributed():
        if distributed.staged(total):
            total = total.cpu()  # gloo carries CPU tensors only
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return float(total)


def card_line() -> str | None:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_app(variant: str, args) -> int:
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me = distributed.rank()

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    kwargs = {"b_width": parse_ints(args.b_width)} if variant == "hide" else {}
    if args.transport:
        kwargs["halo_transport"] = args.transport
    cfg = DiffusionConfig(
        global_shape=grid_shape(args), lengths=(10.0, 10.0), nt=args.nt,
        warmup=args.warmup, dtype=args.dtype, dims=parse_ints(args.dims),
        wire_mode=args.wire_mode, **kwargs,
    )
    model = HeatDiffusion(cfg, device=device)
    grid = model.grid
    where = where_line(device)
    log0(f"grid {grid.global_shape} {cfg.dtype} over process grid {grid.dims} "
         f"({grid.nprocs} rank(s)) on {where}")
    note = ""
    if args.deep:
        # Label the run with the depth that will execute (run_deep degrades
        # k to gcd(warmup, nt - warmup, K)).
        k_eff = model.effective_deep_depth(block_steps=args.deep, warn=False)
        variant = f"deep{k_eff}"
        log0(f"--deep: running deep-halo sweeps (k={k_eff}"
             + (f", degraded from {args.deep}" if k_eff != args.deep else "")
             + ") instead of the per-step variant")
        result = model.run_deep(block_steps=args.deep)
        log0(f"{variant}: local {schedule_note(result)}, one width-{k_eff} exchange per "
             f"{k_eff} steps; T_eff counts 3 passes per step, so it is an effective "
             "rate and may exceed the card's memory rate")
    else:
        result = model.run(variant, driver=args.driver)
        note = f"; {driver_note(args, result)}"
    log0(
        f"Executed {result.nt} steps ({result.warmup} warmup) in = "
        f"{result.wtime:.3e} sec (@ T_eff = {result.t_eff:.2f} GB/s aggregate, "
        f"{result.gpts:.4f} Gpts/s) on {where}{note}"
    )
    log0(f"maximum(T) = {global_max(result.T)}")
    if args.save_field:
        save_field(args.save_field, result.T, grid)
        log0(f"wrote {args.save_field}")
    distributed.finalize()
    return 0


def save_field(path, T, grid) -> None:
    """Gather the field to rank 0 (every rank takes part) and np.save it
    there."""
    import pathlib

    import numpy as np

    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    full = gather_to_host0(T, grid)
    if full is not None:
        out = pathlib.Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, full)
