#!/usr/bin/env python3
"""Trace the 2×2 `perf` and `hide` steps of diffusion and the wave under
torch.profiler, one rank per GPU over NCCL.

    python3 chip_trace_hide.py [--shape 12288 12288] [--steps 30] [--driver scan]
    python3 chip_trace_hide.py --device cpu --shape 64 48   # a rehearsal over gloo

The same configuration as `chip_smoke.py --gpus 4` phase 8 (f32, b_width
(32, 4)); it asserts nothing. Every rank runs every variant in fresh
processes (the steps exchange halos, so all ranks must step together):
5 untraced steps, `--steps` steps under a first profiler session that
is thrown away (it pays the profiler's start-up), then `--steps` steps
under the recorded one. Rank 0 prints, per variant, the host-clock
ms per step and the device ms per step summed over device-side events
only (kernels, NCCL, copies; a host op's device time is its kernels',
and NCCL's `nccl:coalesced` annotation spans its kernel, so counting
either would count a kernel twice) from the same window (their
ratio is the device's busy share, above 1 where streams overlap), and
the kernels that take most device time; it writes Chrome traces to
chiprun_out/hide_trace_<model>_<variant>[_scan].json. `--driver scan`
traces the scan driver's replays instead (each window one chunk of
`--steps` steps, the halo exchange inside the graphs over NCCL); its
warm-up is one untraced chunk, which captures the graphs.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HIDE_B_WIDTH = (32, 4)
TOP = 6


def trace_rank(rank, spec):
    """One rank (started by spawn_ranks): the traced windows of each model
    and variant; rank 0 exports the traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rocm_mpi_tpu_torch.config import DiffusionConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed

    cuda = spec["device"] == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        activities.append(ProfilerActivity.CUDA)
    else:
        device = torch.device("cpu")
    distributed.barrier()
    steps = spec["steps"]
    kw = dict(global_shape=tuple(spec["shape"]), nt=steps + 1, warmup=1, dtype="f32",
              dims=(2, 2), b_width=HIDE_B_WIDTH)
    models = (("diffusion", HeatDiffusion(DiffusionConfig(**kw), device=device)),
              ("wave", AcousticWave(WaveConfig(**kw), device=device)))
    out_dir = ROOT / "chiprun_out"
    if rank == 0:
        out_dir.mkdir(exist_ok=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()
        distributed.barrier()

    scan = spec["driver"] == "scan"
    rows = {}
    for label, model in models:
        for variant in ("perf", "hide"):
            if scan:
                advance, _ = model.scan_advance_fn(variant, nt=2 * steps, warmup=steps)
            else:
                advance = model.advance_fn(variant)
            state = model.init_state()
            if label == "diffusion":
                def run(n, T=state[0], Cp=state[1]):
                    advance(T.clone(), Cp, n)
            else:
                def run(n, U=state[0], Uprev=state[1], C2=state[2]):
                    advance(U.clone(), Uprev.clone(), C2, n)
            run(steps if scan else 5)
            sync()
            with profile(activities=activities):
                run(steps)
                sync()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                run(steps)
                if cuda:
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / steps * 1e3
            sync()
            if rank == 0:
                name = f"hide_trace_{label}_{variant}{'_scan' if scan else ''}.json"
                prof.export_chrome_trace(str(out_dir / name))
            events = [e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU and not e.is_user_annotation
                      and e.self_device_time_total > 0]
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]
            rows[f"{label} {variant}"] = dict(
                wall_ms=wall,
                device_ms=sum(e.self_device_time_total for e in events) / steps / 1e3,
                top=[(e.key[:60], e.self_device_time_total / steps / 1e3, e.count // steps)
                     for e in top])
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", type=int, nargs=2, default=(12288, 12288))
    parser.add_argument("--steps", type=int, default=30, help="steps in each traced window")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--driver", choices=["step", "scan"], default="step",
                        help="step: the eager steps; scan: the scan driver's graphs")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and torch.cuda.device_count() < 4:
        print(f"chip_trace_hide: needs 4 GPUs, {torch.cuda.device_count()} visible "
              "(--device cpu rehearses over gloo)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rocm_mpi_tpu_torch.apps._common import card_line
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    spec = dict(shape=list(args.shape), steps=args.steps, device=args.device,
                driver=args.driver)
    backend = "nccl" if args.device == "cuda" else "gloo"
    ranks = spawn_ranks(4, trace_rank, (spec,), backend=backend, timeout=600)
    card = card_line() if args.device == "cuda" else "the CPU: not a GPU measurement"
    n0, n1 = args.shape
    for key, row in ranks[0].items():
        print(f"[hide-trace] rank 0 {key} {n0}x{n1} f32 2x2, driver {args.driver}, "
              f"{args.steps} steps under "
              f"torch.profiler: {row['wall_ms']:.4f} ms/step on the host clock, "
              f"{row['device_ms']:.4f} ms/step of device time; most: "
              + "; ".join(f"{name} {ms:.4f} ms x{count}" for name, ms, count in row["top"])
              + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
