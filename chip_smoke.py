#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (rocm_mpi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH]
    python3 chip_smoke.py --gpus 4     # phases 1, 2 and 5 only, over NCCL

Run from the repository root on a machine with one CUDA GPU (an H100 is
the target). Phases, printed as they run:

1. environment — torch, CUDA and nvcc versions, the card's name and power
   limit (nvidia-smi);
2. build — nvcc builds every kernel of the perf path from csrc/;
3. kernels — each kernel at the perf path's shapes, in f32, f64 and bf16,
   held bitwise against its plain PyTorch version on the card, and timed
   with CUDA events (median) beside the plain version and its bound;
4. main path, one GPU — HeatDiffusion.run("perf") at 12288² f32 for 1000
   steps and at 252² f32: every step one masked_step launch, the field
   bitwise equal to the plain versions' run of the same steps, and the
   252² field within the analytic Gaussian bound;
5. main path, sharded — the 2×2 perf path (halo exchange + fused_step_cm)
   run by 4 ranks that share this one card over a gloo group (halo slabs
   staged through host memory): every step one fused_step_cm launch per
   rank, each shard bitwise equal to the plain versions' run, the gathered
   field bitwise equal to the same kernel run over the whole zero-padded
   domain on one GPU. With `--gpus 4` the same phase runs one rank per
   GPU over NCCL, for 1000 steps, and the other phases are skipped.

Then it prints the card line, one JSON line describing every kernel, and
last `{"ok": true, "device": {...}}`. Any failed phase raises: the script
exits non-zero and prints no result line. It exits 1 without CUDA and 2
when the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0

# Published peaks (NVIDIA data sheets; dense rates at the full power
# limit): memory bytes/s, and flop/s outside the tensor cores in f32 and
# f64. Matched on the card's name, first hit wins.
PEAKS = (
    ("H200", 4.8e12, 67e12, 34e12),
    ("H100 NVL", 3.9e12, 60e12, 30e12),
    ("H100 PCIe", 2.0e12, 51e12, 26e12),
    ("H100", 3.35e12, 67e12, 34e12),  # SXM, HBM3
)

BIG, SMALL = (12288, 12288), (252, 252)
BLOCK = (6144, 6144)  # one rank's block of a 2×2 decomposition of 12288²
KERNELS = {
    # name: (source line of the TPU kernel it replaces, shapes it runs at)
    "masked_step": ("rocm_mpi_tpu/ops/pallas_kernels.py:1191", (SMALL, BIG)),
    "fused_step_cm": ("rocm_mpi_tpu/ops/pallas_kernels.py:290", (SMALL, BLOCK)),
}
MAIN_NT, MAIN_WARMUP = 1000, 10
SHARD_NT, SHARD_WARMUP = 20, 2


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def peaks(name: str):
    for frag, bw, f32, f64 in PEAKS:
        if frag in name:
            return {"bytes_per_s": bw, "f32": f32, "f64": f64, "assumed": False}
    return {"bytes_per_s": PEAKS[-1][1], "f32": PEAKS[-1][2], "f64": PEAKS[-1][3],
            "assumed": True}


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` launches of fn, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment(torch, card):
    from rocm_mpi_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}", flush=True)
    print(f"[env] card: {card} (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)


def phase_build():
    from rocm_mpi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(["stencil"], verbose=True)
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        print(f"[build] {name}.cu -> {info['path'].name} in {info['seconds']:.1f} s "
              "(nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false)", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)
    print(f"[build] total {seconds:.1f} s", flush=True)
    return seconds


def _kernel_inputs(torch, name, core, dtype, device):
    """Inputs of one kernel call as the perf path makes them: the field in
    [0, 1), Cm from the grid's dt (edge-masked for masked_step, whose
    field is the whole domain)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.ops import kernels

    domain = SMALL if core == SMALL else BIG
    cfg = DiffusionConfig(global_shape=domain, dtype=dtype)
    tdt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(SEED)
    dt = torch.tensor(cfg.dt, dtype=tdt, device=device)
    if name == "masked_step":
        T = torch.rand(core, generator=gen, device=device, dtype=torch.float64).to(tdt)
        Cm = kernels.edge_masked_cm(T, torch.ones_like(T), cfg.lam, dt)
        return T, Cm, cfg.spacing
    padded = tuple(n + 2 for n in core)
    Tp = torch.rand(padded, generator=gen, device=device, dtype=torch.float64).to(tdt)
    Cm = (torch.rand(core, generator=gen, device=device, dtype=torch.float64) * cfg.dt).to(tdt)
    return Tp, Cm, cfg.spacing


def phase_kernels(torch, card, pk):
    """Every kernel at every main-path shape and dtype: bitwise against
    its plain version on the card, then timed beside it and its bound."""
    from rocm_mpi_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    rows = []
    for name, (_, shapes) in KERNELS.items():
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        for core in shapes:
            for dtype in ("f32", "f64", "bf16"):
                field, Cm, spacing = _kernel_inputs(torch, name, core, dtype, device)
                inv_d2 = kernels.inv_d2_of(spacing)
                out = torch.empty(core, dtype=field.dtype, device=device)
                got = wrapper(field, Cm, spacing, out=out)
                want = plain(field, Cm, inv_d2)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                check(torch.equal(got, want),
                      f"{name} {core} {dtype}: kernel != plain version (max |diff| {err})")
                cells = field.numel() if name == "masked_step" else Cm.numel()
                reps = 200 if core == SMALL else 30
                ms = time_ms(lambda: wrapper(field, Cm, spacing, out=out), reps)
                plain_ms = time_ms(lambda: plain(field, Cm, inv_d2), max(reps // 4, 5))
                # Each input read once, the output written once.
                nbytes = (field.numel() + 2 * Cm.numel()) * field.element_size()
                flops = cells * (5 * len(core) + 1)
                t_bytes = nbytes / pk["bytes_per_s"] * 1e3
                t_ops = flops / pk["f64" if dtype == "f64" else "f32"] * 1e3
                bound_ms = max(t_bytes, t_ops)
                row = dict(kernel=name, shape=list(core), dtype=dtype, bitwise=True,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, flops=flops, fraction_of_bound=bound_ms / ms)
                rows.append(row)
                print(f"[kernel] {name} {core[0]}x{core[1]} {dtype}: bitwise == plain; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({row['bound_by']}; {row['fraction_of_bound']:.2f} of bound) "
                      f"on {card}; no single PyTorch call computes this step, "
                      "library_ms null", flush=True)
                del field, Cm, out, got, want
            torch.cuda.empty_cache()
    return rows


def _single_gpu_run(torch, shape, card):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = DiffusionConfig(global_shape=shape, nt=MAIN_NT, warmup=MAIN_WARMUP,
                          dtype="f32", dims=(1, 1))
    grid = init_global_grid(*shape, dims=(1, 1), nprocs=1, rank=0)
    model = HeatDiffusion(cfg, grid=grid, device="cuda")

    kernels.reset_launches()
    res = model.run("perf")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    check(launches == {"masked_step": cfg.nt, "fused_step_cm": 0},
          f"perf {shape}: launches {launches}, expected {cfg.nt} masked_step")
    check(tuple(res.T.shape) == shape and bool(torch.isfinite(res.T).all()),
          f"perf {shape}: result not finite or misshapen")
    # The same steps through the plain version, on the card.
    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    for _ in range(cfg.nt):
        T = kernels.masked_step_plain(T, Cm, inv_d2)
    check(torch.equal(res.T, T), f"perf {shape}: kernel run != plain-version run")
    print(f"[main] perf {shape[0]}x{shape[1]} f32, {cfg.nt} steps ({cfg.warmup} warmup): "
          f"{res.wtime:.4f} s, {res.wtime_it * 1e3:.5f} ms/step, T_eff {res.t_eff:.1f} GB/s, "
          f"{res.gpts:.3f} Gpts/s on {card}; masked_step launches {launches['masked_step']}; "
          "bitwise == plain-version run", flush=True)
    return model, res, launches


def phase_main(torch, card):
    from rocm_mpi_tpu_torch.ops.diffusion import analytic_solution

    _, big, big_launches = _single_gpu_run(torch, BIG, card)
    big_row = dict(shape=list(BIG), wtime_s=big.wtime, ms_per_step=big.wtime_it * 1e3,
                   t_eff_gbs=big.t_eff, gpts=big.gpts, launches=big_launches)
    del big
    torch.cuda.empty_cache()
    model, small, small_launches = _single_gpu_run(torch, SMALL, card)
    cfg = model.config
    coords = model.grid.coord_mesh(dtype=torch.float64, device=small.T.device)
    exact = analytic_solution(coords, cfg.lengths, cfg.lam / cfg.cp0, cfg.nt * cfg.dt)
    rel = float((small.T.double() - exact).abs().max() / exact.max())
    check(rel < 2e-3, f"perf 252x252: relative error vs analytic Gaussian {rel}")
    print(f"[main] perf 252x252: relative max error vs the analytic Gaussian {rel:.3e} "
          "(bound 2e-3); at 762 KB a step this size is launch-bound", flush=True)
    small_row = dict(shape=list(SMALL), wtime_s=small.wtime, ms_per_step=small.wtime_it * 1e3,
                     t_eff_gbs=small.t_eff, gpts=small.gpts, launches=small_launches,
                     analytic_rel_err=rel)
    return big_row, small_row


def sharded_rank(rank, spec):
    """One rank of the sharded perf path (started by spawn_ranks)."""
    import numpy as np
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
    from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel.halo import place_core

    # One card: every rank on cuda:0 (gloo). Several cards: rank r on
    # cuda:r, NCCL sending device to device.
    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape = tuple(spec["shape"])
    cfg = DiffusionConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"],
                          dtype="f32", dims=(2, 2))
    model = HeatDiffusion(cfg, device=device)

    kernels.reset_launches()
    res = model.run("perf")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    pad = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=device)
    for _ in range(cfg.nt):
        T = kernels.fused_step_cm_plain(exchange_halo(T, model.grid, out=pad), Cm, inv_d2)
    out = dict(rank=rank, launches=launches, bitwise=bool(torch.equal(res.T, T)),
               finite=bool(torch.isfinite(res.T).all()), wtime_s=res.wtime,
               t_eff_gbs=res.t_eff)
    full = gather_to_host0(res.T, model.grid)
    if rank == 0:
        # The same steps over the whole domain on one GPU, through the same
        # kernel on the zero-padded field: every cell sees the same
        # neighbours in the same order, so the gathered field must match
        # bit for bit — a check of the exchange itself.
        one = DiffusionConfig(global_shape=shape, dtype="f32", dims=(1, 1))
        ref = HeatDiffusion(one, grid=GlobalGrid(shape, one.lengths, (1, 1)), device=device)
        Tr, Cpr = ref.init_state()
        Cmr = ref.prepare_fn("perf")(Cpr)
        padr = torch.zeros(tuple(n + 2 for n in shape), dtype=Tr.dtype, device=device)
        for _ in range(cfg.nt):
            Tr = kernels.fused_step_cm(place_core(Tr, out=padr), Cmr, cfg.spacing)
        Tr = Tr.cpu().numpy()
        out["max_abs_vs_one_gpu"] = float(np.abs(full - Tr).max())
        out["bitwise_vs_one_gpu"] = bool(np.array_equal(full, Tr))
    return out


def phase_sharded(card, gpus: int):
    """The 2×2 perf path on 4 ranks: sharing one card over gloo, or one
    rank per card over NCCL when `gpus` is 4."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup = (SHARD_NT, SHARD_WARMUP) if gpus == 1 else (MAIN_NT, MAIN_WARMUP)
    spec = dict(shape=BIG, nt=nt, warmup=warmup, gpus=gpus)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, sharded_rank, (spec,), backend=backend, timeout=600)
    for r in ranks:
        check(r["launches"] == {"masked_step": 0, "fused_step_cm": nt},
              f"sharded rank {r['rank']}: launches {r['launches']}, expected "
              f"{nt} fused_step_cm")
        check(r["bitwise"] and r["finite"],
              f"sharded rank {r['rank']}: kernel run != plain-version run or not finite")
    check(ranks[0]["bitwise_vs_one_gpu"],
          f"sharded 2x2 field differs from the whole-domain run of the same kernel by "
          f"{ranks[0]['max_abs_vs_one_gpu']}")
    total = sum(r["launches"]["fused_step_cm"] for r in ranks)
    r0 = ranks[0]
    where = (f"4 ranks sharing {card} (gloo, halo slabs staged through host memory: "
             "not a multi-GPU measurement)" if gpus == 1
             else f"4 GPUs, one rank each, NCCL ({card} each)")
    print(f"[sharded] perf 12288x12288 f32 on a 2x2 grid, {where}, {nt} steps "
          f"({warmup} warmup): fused_step_cm launches {total} ({nt} per rank); each "
          "shard bitwise == plain-version run; gathered field bitwise == the whole-domain "
          f"run of the same kernel on one GPU; rank 0: {r0['wtime_s']:.4f} s, "
          f"{r0['wtime_s'] / (nt - warmup) * 1e3:.5f} ms/step, aggregate T_eff "
          f"{r0['t_eff_gbs']:.1f} GB/s", flush=True)
    return ranks, total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write every measurement to PATH")
    parser.add_argument("--gpus", type=int, default=1, choices=[1, 4],
                        help="4: run only the sharded perf path, one rank per GPU "
                        "over NCCL (1000 steps), on a host with 4 GPUs")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import rocm_mpi_tpu_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: the port's package rocm_mpi_tpu_torch is not in {ROOT}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rocm_mpi_tpu_torch.apps._common import card_line

    card = card_line()
    check(card is not None, "nvidia-smi gave no card name and power limit")
    kind = torch.cuda.get_device_name(0)
    pk = peaks(kind)
    t0 = time.perf_counter()
    phase_environment(torch, card)
    if pk["assumed"]:
        print(f"[env] no published peaks on record for {kind!r}: bounds use the "
              "H100 SXM's", flush=True)
    build_s = phase_build()
    if args.gpus > 1:
        check(torch.cuda.device_count() >= args.gpus,
              f"--gpus {args.gpus} needs {args.gpus} GPUs, "
              f"{torch.cuda.device_count()} visible")
        ranks, _ = phase_sharded(card, args.gpus)
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(dict(card=card, kind=kind, build_s=build_s,
                                            sharded_ranks=ranks), indent=1))
        print(f"[done] sharded phase passed in {time.perf_counter() - t0:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    rows = phase_kernels(torch, card, pk)
    big_row, small_row = phase_main(torch, card)
    ranks, fused_launches = phase_sharded(card, 1)

    launches = {"masked_step": big_row["launches"]["masked_step"],
                "fused_step_cm": fused_launches}
    main_shape = {"masked_step": list(BIG), "fused_step_cm": list(BLOCK)}
    line = []
    for name, (replaces, _) in KERNELS.items():
        main = next(r for r in rows if r["kernel"] == name and r["dtype"] == "f32"
                    and r["shape"] == main_shape[name])
        line.append(dict(
            name=name, route="cuda", source="rocm_mpi_tpu_torch/csrc/stencil.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
        ))
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            card=card, kind=kind, peaks=pk, build_s=build_s, kernel_phases=rows,
            main_12288=big_row, main_252=small_row, sharded_ranks=ranks, kernels=line,
            seconds=time.perf_counter() - t0,
        ), indent=1))
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
