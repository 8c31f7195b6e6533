#!/usr/bin/env python3
"""Trace the 2×2 `perf` and `hide` steps of diffusion and the wave under
torch.profiler, one rank per GPU over NCCL.

    python3 chip_trace_hide.py [--shape 12288 12288] [--steps 30] [--driver scan]
    python3 chip_trace_hide.py --shape 256 256 128 --dims 2 2 1 --driver scan   # 3D, 128³ a rank
    python3 chip_trace_hide.py --device cpu --shape 64 48   # a rehearsal over gloo
    python3 chip_trace_hide.py --shape 24576 24576 --dtype f64 --driver scan   # the hide cell's ranks

The same configuration as `chip_smoke.py --gpus 4` phase 8 (f32 unless
`--dtype` says otherwise, b_width (32, 4); (8, 8, 8) in 3D, diffusion
only); it asserts nothing. Beside the
diffusion `perf` and `hide` steps (the face exchange and fused_step_cm
from the shard and its faces) it traces the same steps over the padded
route they replaced ("perf-padded", "hide-padded": chip_smoke.py
`register_padded_variants`). Every rank runs every variant in fresh
processes (the steps exchange halos, so all ranks must step together):
5 untraced steps, `--steps` steps under a first profiler session that
is thrown away (it pays the profiler's start-up), then `--steps` steps
under the recorded one. Rank 0 prints, per variant, the host-clock
ms per step and the device ms per step summed over device-side events
only (kernels, NCCL, copies; a host op's device time is its kernels',
and NCCL's `nccl:coalesced` annotation spans its kernel, so counting
either would count a kernel twice) from the same window (their
ratio is the device's busy share, above 1 where streams overlap), the
fused_step_cm launches the first call of a variant ran (LAUNCHES) and
the launches the wrapper made on the f64 route in it
(kernels.F64_ROUTE_LAUNCHES: under `--driver scan` the scratch step's and
the captured steps', the graphs' replays not counted), and
the kernels that take most device time, and the device time split into
fused_step_cm, copies (memcpy and elementwise copy kernels), NCCL and the
rest; it writes Chrome traces to
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
HIDE_B_WIDTH = {2: (32, 4), 3: (8, 8, 8)}
TOP = 6
# The device-time split: the first category whose fragment a kernel's name
# holds (lower case); the rest is "other".
SPLIT = (("fused_step_cm", ("fused_step_cm",)), ("nccl", ("nccl",)),
         ("copies", ("memcpy", "copy", "memset")))


def split_of(events, steps: int) -> dict:
    """Device ms a step of each SPLIT category (and "other")."""
    split = {name: 0.0 for name, _ in SPLIT} | {"other": 0.0}
    for e in events:
        key = e.key.lower()
        cat = next((name for name, frags in SPLIT if any(f in key for f in frags)), "other")
        split[cat] += e.self_device_time_total / steps / 1e3
    return split


def trace_rank(rank, spec):
    """One rank (started by spawn_ranks): the traced windows of each model
    and variant; rank 0 exports the traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import register_padded_variants
    from rocm_mpi_tpu_torch.config import DiffusionConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
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
    ndim = len(spec["shape"])
    kw = dict(global_shape=tuple(spec["shape"]), lengths=(10.0,) * ndim, nt=steps + 1,
              warmup=1, dtype=spec["dtype"], dims=tuple(spec["dims"]),
              b_width=HIDE_B_WIDTH[ndim])
    diffusion = HeatDiffusion(DiffusionConfig(**kw), device=device)
    register_padded_variants(diffusion)
    models = [("diffusion", diffusion, ("perf", "hide", "perf-padded", "hide-padded"))]
    if ndim == 2:
        models.append(("wave", AcousticWave(WaveConfig(**kw), device=device), ("perf", "hide")))
    out_dir = ROOT / "chiprun_out"
    if rank == 0:
        out_dir.mkdir(exist_ok=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()
        distributed.barrier()

    scan = spec["driver"] == "scan"
    rows = {}
    for label, model, variants in models:
        for variant in variants:
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
            launched, routed = kernels.LAUNCHES["fused_step_cm"], kernels.F64_ROUTE_LAUNCHES
            run(steps if scan else 5)
            sync()
            launched = kernels.LAUNCHES["fused_step_cm"] - launched
            routed = kernels.F64_ROUTE_LAUNCHES - routed
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
                name = (f"hide_trace_{label}{'_3d' if ndim == 3 else ''}_{variant}"
                        f"{'_scan' if scan else ''}.json")
                prof.export_chrome_trace(str(out_dir / name))
            events = [e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU and not e.is_user_annotation
                      and e.self_device_time_total > 0]
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]
            rows[f"{label} {variant}"] = dict(
                wall_ms=wall, split=split_of(events, steps), launched=launched, routed=routed,
                device_ms=sum(e.self_device_time_total for e in events) / steps / 1e3,
                top=[(e.key[:60], e.self_device_time_total / steps / 1e3, e.count // steps)
                     for e in top])
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", type=int, nargs="+", default=(12288, 12288),
                        help="the global grid, 2D or 3D")
    parser.add_argument("--dims", type=int, nargs="+", default=None,
                        help="the process grid of 4 ranks (default 2 2, or 2 2 1 in 3D)")
    parser.add_argument("--steps", type=int, default=30, help="steps in each traced window")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--dtype", choices=["f32", "f64", "bf16"], default="f32")
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

    dims = args.dims or (2, 2, 1)[:len(args.shape)]
    if len(args.shape) not in (2, 3) or len(dims) != len(args.shape) or \
            dims[0] * dims[1] * (dims[2] if len(dims) == 3 else 1) != 4:
        print(f"chip_trace_hide: --shape {args.shape} --dims {dims}: a 2D or 3D grid over 4 "
              "ranks", file=sys.stderr)
        return 2
    spec = dict(shape=list(args.shape), dims=list(dims), steps=args.steps, device=args.device,
                driver=args.driver, dtype=args.dtype)
    backend = "nccl" if args.device == "cuda" else "gloo"
    ranks = spawn_ranks(4, trace_rank, (spec,), backend=backend, timeout=600)
    card = card_line() if args.device == "cuda" else "the CPU: not a GPU measurement"
    grid = "x".join(map(str, args.shape))
    over = "x".join(map(str, dims))
    for key, row in ranks[0].items():
        print(f"[hide-trace] rank 0 {key} {grid} {args.dtype} {over}, driver {args.driver}, "
              f"{args.steps} steps under "
              f"torch.profiler: {row['wall_ms']:.4f} ms/step on the host clock, "
              f"first call: {row['launched']} fused_step_cm launches run, {row['routed']} made "
              f"on the f64 route; "
              f"{row['device_ms']:.4f} ms/step of device time ("
              + ", ".join(f"{k} {v:.4f}" for k, v in row["split"].items())
              + "); most: "
              + "; ".join(f"{name} {ms:.4f} ms x{count}" for name, ms, count in row["top"])
              + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
