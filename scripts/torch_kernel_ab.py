"""Time two checkouts of the PyTorch/CUDA port's masked_step, tb_sweep,
kp_update, multi_step_cm, wave_multi_step, swe_multi_step, fused_step_cm,
kp_flux, fused_step_padded and kp_residual side by side on one CUDA card.

    python scripts/torch_kernel_ab.py --roots OLD NEW NEW OLD [--kernels K ...] [--json PATH]

Each root is a directory that holds a `rocm_mpi_tpu_torch/` package (a
checkout, or an unpacked `git archive` of one). Every root runs in a
process of its own, in the order given, so the kernels of each are built
from its own sources into its own `_build/`; list each root twice, in the
order old, new, new, old, so that a drift of the card's clocks shows.
`--kernels` picks what each process times (default: all eleven):

- `masked_step`: `kernels.masked_step` at 12288² in f32, f64 and bf16
  (the one-GPU perf step): the median of CUDA-event-timed launches, each
  launch held bitwise against `masked_step_plain` first; and at 252² f32
  (entry()'s step) the same, with the wrapper's host µs a call;
- `tb_sweep`: `multistep.tb_sweep` (2D, f32/f64/bf16) at 12304² and
  6160², k = 8, and at 12320², k = 16: the median of CUDA-event-timed
  launches, each launch held bitwise against `tb_sweep_plain` first;
- `tb_sweep_3d`: the same in 3D, f32/f64/bf16, at the 3D app's 128³ and
  run_deep's 144³ block (k = 8) and at 64×96×96 (k = 16; a root whose
  kernel refuses it is recorded as refusing), each beside
  `tb_sweep_plain`'s time, with the plan where the root has one;
- `kp_update`: the host path of `kp.kp_update` at 128² f32: calls back
  to back, no sync between them, µs a call (median of repeats). Where the
  root has plain comparisons in front of the checks that name a fault
  (the shared `kernels._operands_ok`, or a wrapper's own
  `kp._update_operands_ok`), the wrapper is also timed with those
  comparisons made to refuse every call, so that the checks behind them
  run each time;
- `multi_step_cm`, `wave_multi_step`, `swe_multi_step`: the wrappers
  `multistep.multi_step` (eqc), `wave.leapfrog_multi_step` (A-form) and
  `swe.fb_multi_step` at the main paths' blocks: 252², n = 256 (the VMEM
  loops; the SWE's f64 at 180²), run_deep's 316² (diffusion, n = 32),
  268² (wave) and 256² (SWE) blocks (n = 8), and diffusion's 96×64×48
  f32 block (n = 8), in f32, f64 and bf16 where the JAX admission takes
  them. Each launch is held
  bitwise against the plain version first; then three figures: per call
  (the median of launches each between two CUDA events, as chip_smoke.py
  times kernels), device (the same, with the launches queued while the
  card is held behind torch.cuda._sleep, so none waits for the host),
  and the wrapper's host µs a call (calls back to back, no sync);
- `fused_step_cm`: the sharded main path's kernel at a 6144² shard (2×2
  of 12288²) in f32, f64 and bf16, at a 128³ shard in f32 and f64, and at
  the benchmark's hide rank (diff2d-hide-f64-2x2-12288: 12288² in f64,
  where each of the five boxes is also timed alone, against its own bytes,
  and the f64 route's launches a call are counted where the root has the
  route): the whole
  core from the padded block (`fused_step_cm(Tp)`, every root), the five
  (2D, b_width (32, 4)) or seven (3D, (8, 8, 8)) `hide` boxes from it
  (`fused_step_cm_region`: the interior from the raw shard, the slabs
  from the block), and, where the root has the face form
  (`fused_step_cm_faces`), the same whole core and boxes from the shard
  and contiguous faces, as the sharded steps call it; masked_step on the
  same shard beside them (the one-GPU layout's figure at this size). Each
  result is held bitwise against `fused_step_cm_plain(Tp)` first. Three
  figures a case: per call and device as above, and a loop (200 calls
  queued behind torch.cuda._sleep, between two CUDA events, over 200) —
  the figure for the 3D shard, whose single launch is too short for a
  pair of events; each with its share of the bytes bound (the core, the
  2·ndim faces and Cm read once, out written once, at 3.35 TB/s).
- `kp_flux`: `kp.kp_flux` at 12288² in f32, f64 and bf16 and at the kp
  app's 128² in f64;
- `kp_residual`: `kp.kp_residual` at 12288² and 128² in f32, f64 and
  bf16, and at 128² the device time of each of the three kp kernels
  beside an empty kernel's (`torch.cuda._sleep(0)`, queued and timed the
  same way): the launch floor;
- `fused_step_padded`: `kernels.fused_step_padded` at 12288² and 6144²
  in f32, f64 and bf16, at 252² f32 (with the wrapper's host µs a call)
  and on the 96×64×48 block in the three dtypes. Each launch of these two is held bitwise against its plain version
  first; two figures a case: per call (as above) and device (queued
  behind torch.cuda._sleep), each with its share of the bytes bound
  (Tp read once, the outputs written once; Cp too for the padded step).

To time a design beside the checkout's (another run length, another way
to read a row), list as a root a copy of the package with its source
changed.

The card's name and power limit (nvidia-smi) head the output; one JSON
object per process follows, and `--json` writes them all.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

TB_CASES = (((12304, 12304), 8), ((6160, 6160), 8), ((12320, 12320), 16))
DTYPES = ("f32", "f64", "bf16")
KP_SHAPE = (128, 128)
HOST_CALLS = 2000
HOST_REPEATS = 7
SEED = 1234
TB3_CASES = (((128, 128, 128), 8), ((144, 144, 144), 8), ((64, 96, 96), 16))
KERNELS = ("masked_step", "tb_sweep", "kp_update", "multi_step_cm", "wave_multi_step",
           "swe_multi_step", "fused_step_cm", "kp_flux", "fused_step_padded", "kp_residual",
           "tb_sweep_3d")
# (kernel, core, dtypes) of the kp_flux, kp_residual and fused_step_padded
# figures.
PADDED_CASES = (
    ("kp_flux", (12288, 12288), DTYPES),
    ("kp_flux", (128, 128), ("f64",)),
    ("kp_residual", (12288, 12288), DTYPES),
    ("kp_residual", (128, 128), DTYPES),
    ("fused_step_padded", (12288, 12288), DTYPES),
    ("fused_step_padded", (6144, 6144), DTYPES),
    ("fused_step_padded", (252, 252), ("f32",)),
    ("fused_step_padded", (96, 64, 48), DTYPES),
)
# fused_step_cm's shards: (shape, hide b_width, dtypes); the 128³ shard in
# f64 too, where the f64 route also takes 3D launches.
FUSED_CASES = (((6144, 6144), (32, 4), DTYPES), ((128, 128, 128), (8, 8, 8), ("f32", "f64")),
               ((12288, 12288), (32, 4), ("f64",)))
# The shard whose hide boxes are also timed one by one: the benchmark's
# diff2d-hide-f64-2x2-12288 rank.
FUSED_BOXES_ALONE = (12288, 12288)
FUSED_LOOP = 200  # launches between the two events of a loop figure
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
MASKED_BIG, MASKED_SMALL = (12288, 12288), (252, 252)
# (kernel, block, steps a launch, dtypes): the main paths' multi-step blocks.
MULTI_CASES = (
    ("multi_step_cm", (252, 252), 256, DTYPES),
    ("multi_step_cm", (316, 316), 32, DTYPES),
    ("multi_step_cm", (96, 64, 48), 8, ("f32",)),
    ("wave_multi_step", (252, 252), 256, DTYPES),
    ("wave_multi_step", (268, 268), 8, DTYPES),
    ("swe_multi_step", (252, 252), 256, ("f32", "bf16")),
    ("swe_multi_step", (180, 180), 256, ("f64",)),
    ("swe_multi_step", (256, 256), 8, ("f32", "bf16")),
)
MULTI_HOST_CALLS = 200  # fewer than the launch queue holds at a slow kernel


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` launches of fn, each between two CUDA events."""
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


def host_us(torch, fn, calls: int = HOST_CALLS, repeats: int = HOST_REPEATS) -> float:
    """Host µs a call of fn, `calls` calls back to back (median of
    `repeats` repeats)."""
    fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        reads.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(reads)


def device_ms(torch, fn, reps: int, host: float) -> float:
    """Median device time of `reps` launches of fn, each between two CUDA
    events, all queued while the card is held behind torch.cuda._sleep
    (long enough for the host to enqueue them at `host` µs a call)."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    hold_s = 2 * reps * (host + 20.0) * 1e-6 + 1e-3
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles; the card clocks at most 2 GHz
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def loop_ms(torch, fn, calls: int, host: float) -> float:
    """Device ms a call of fn over `calls` calls queued behind
    torch.cuda._sleep (long enough for the host to enqueue them at `host`
    µs a call), between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * calls * (host + 20.0) * 1e-6 + 1e-3) * 2e9))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def box_bound_ms(box, shape, dt) -> float:
    """The bytes bound of one box's launch, ms: its cells' T and Cm read and
    out written once, and the ghost cells beside it on the shard's edges
    (the faces it reads), at HBM_BYTES_PER_S."""
    import torch

    cells, ghosts = 1, 0
    for lo, hi in box:
        cells *= hi - lo
    for ax, (lo, hi) in enumerate(box):
        side = cells // (hi - lo)
        ghosts += side * ((lo == 0) + (hi == shape[ax]))
    return (3 * cells + ghosts) * torch.tensor([], dtype=dt).element_size() \
        / HBM_BYTES_PER_S * 1e3


def f64_route_launches(K, run):
    """Launches of the f64 route (kernels.F64_ROUTE_LAUNCHES) a call of
    `run`; None where the root has no such route."""
    if not hasattr(K, "F64_ROUTE_LAUNCHES"):
        return None
    before = K.F64_ROUTE_LAUNCHES
    run()
    return K.F64_ROUTE_LAUNCHES - before


def time_fused(torch, root, result, dev, tdts):
    """fused_step_cm at the sharded main paths' shards (module docstring)."""
    from rocm_mpi_tpu_torch.ops import kernels as K
    from rocm_mpi_tpu_torch.parallel import overlap

    faces_form = hasattr(K, "fused_step_cm_faces")
    for shape, bw, names in FUSED_CASES:
        nd = len(shape)
        spacing = (0.1, 0.07, 0.05)[:nd]
        inv_d2 = K.inv_d2_of(spacing)
        boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
        for name in names:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            dt = tdts[name]
            Tp = torch.rand(tuple(n + 2 for n in shape), generator=gen, device=dev,
                            dtype=torch.float64).to(dt)
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 0.002).to(dt)
            out = torch.empty(shape, dtype=dt, device=dev)
            want = K.fused_step_cm_plain(Tp, Cm, inv_d2)
            core = tuple(slice(1, -1) for _ in range(nd))
            T = Tp[core].contiguous()
            cases = {
                "padded": lambda: K.fused_step_cm(Tp, Cm, spacing, out=out),
                "padded boxes": lambda: [K.fused_step_cm_region(
                    T if overlap.ghost_free(b, shape) else Tp,
                    0 if overlap.ghost_free(b, shape) else 1, Cm, spacing, b, out)
                    for b in boxes],
                "masked_step": lambda: K.masked_step(T, Cm, spacing, out=out),
            }
            if faces_form:
                # Fresh buffers, as the face exchange's: a view of a size-1
                # axis counts as contiguous, and would sit off the 16-byte grid.
                faces = tuple(f.clone(memory_format=torch.contiguous_format)
                              for f in K.face_views(Tp)[1])
                cases["faces"] = lambda: K.fused_step_cm_faces(T, faces, Cm, spacing, out=out)
                none = (None,) * (2 * nd)
                cases["faces boxes"] = lambda: [K.fused_step_cm_faces(
                    T, none if overlap.ghost_free(b, shape) else faces, Cm, spacing, box=b,
                    out=out) for b in boxes]
                if shape == FUSED_BOXES_ALONE:
                    for b in boxes:
                        cases[f"faces box {b}"] = functools.partial(
                            K.fused_step_cm_faces, T, none if overlap.ghost_free(b, shape)
                            else faces, Cm, spacing, box=b, out=out)
            cells = 1
            for n in shape:
                cells *= n
            faces_cells = sum(cells // n for n in shape) * 2
            bound = (3 * cells + faces_cells) * torch.tensor([], dtype=dt).element_size() \
                / HBM_BYTES_PER_S * 1e3
            for label, run in cases.items():
                out.fill_(float("nan"))
                run()
                torch.cuda.synchronize()
                # A single box is held over its own cells, with its own bytes
                # (its cells' T, Cm and out, and its ghosts on a face).
                region = run.keywords["box"] if isinstance(run, functools.partial) else None
                sl = tuple(slice(lo, hi) for lo, hi in region) if region else ()
                equal = (label == "masked_step" or bool(torch.equal(out[sl], want[sl])))
                row = {"kernel": "fused_step_cm", "case": label, "shape": list(shape),
                       "dtype": name, "bitwise": equal,
                       "bound_ms": box_bound_ms(region, shape, dt) if region else bound}
                row["ms"] = time_ms(torch, run, 30)
                row["host_us"] = host_us(torch, run, 200, 5)
                row["device_ms"] = device_ms(torch, run, 30, row["host_us"])
                row["loop_ms"] = loop_ms(torch, run, FUSED_LOOP, row["host_us"])
                result["fused_step_cm"].append(row)
                if label in ("faces", "faces boxes") and dt == torch.float64:
                    row["f64_route_launches"] = f64_route_launches(K, run)
                print(f"[ab] {root} fused_step_cm {'x'.join(map(str, shape))} {name} {label}: "
                      f"per call {row['ms']:.4f} ms, device {row['device_ms']:.4f}, loop "
                      f"{row['loop_ms']:.4f} ms (of bound {row['bound_ms'] / row['loop_ms']:.2f})"
                      f", f64 route launches a call {row.get('f64_route_launches', '-')}, host "
                      f"{row['host_us']:.2f} µs a call, bitwise {equal}", flush=True)
            del Tp, Cm, out, want, T, cases
            torch.cuda.empty_cache()


def multi_case(torch, name, shape, steps, dtype, dev):
    """(launch, plain version) of a multi-step kernel case: fields in
    [0, 1), velocities in [-0.5, 0.5), held edges (the wave's interior
    mask; the SWE's high wall faces), small coefficients."""
    from rocm_mpi_tpu_torch.ops import kernels, multistep, swe, wave

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(lo=0.0):
        return (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                + lo).to(dtype)

    if name == "multi_step_cm":
        T = rand()
        Cm = kernels.edge_masked_cm(T, torch.ones_like(T), 1.0, 0.1)
        inv_d2 = (1.0,) * len(shape)
        out = torch.empty_like(T)
        return (lambda: multistep.multi_step(T, Cm, inv_d2, steps, "eqc", out=out),
                lambda: multistep.multi_step_cm_plain(T, Cm, inv_d2, steps, "eqc"))
    if name == "wave_multi_step":
        U, Uprev = rand(), rand()
        M = wave.interior_mask(shape, dtype, dev)
        Cw = (1e-3 * rand()) * M
        inv_d2 = (1.0, 1.0)
        outs = (torch.empty_like(U), torch.empty_like(U))
        return (lambda: wave.leapfrog_multi_step(U, Uprev, M, Cw, inv_d2, steps, "aform",
                                                 out=outs),
                lambda: wave.wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, steps, "aform"))
    Mus = []
    for a in range(len(shape)):
        Ma = torch.ones(shape, dtype=dtype, device=dev)
        Ma.narrow(a, shape[a] - 1, 1).zero_()
        Mus.append(Ma)
    h = rand()
    us = tuple(rand(-0.5) * Ma for Ma in Mus)
    cH, cg = (0.05,) * len(shape), (0.08,) * len(shape)
    outs = tuple(torch.empty_like(h) for _ in range(len(shape) + 1))

    def run():
        got = swe.fb_multi_step(h, us, Mus, cH, cg, steps, out=outs)
        return (got[0], *got[1])

    def plain():
        got = swe.swe_multi_step_plain(h, us, Mus, cH, cg, steps)
        return (got[0], *got[1])

    return run, plain


def time_multi(torch, root, kernels, result, dev, tdts):
    for name, shape, steps, dtypes in MULTI_CASES:
        if name not in kernels:
            continue
        for dtype in dtypes:
            run, plain = multi_case(torch, name, shape, steps, tdts[dtype], dev)
            got, want = run(), plain()
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            reps = 50
            row = {"kernel": name, "shape": list(shape), "steps": steps, "dtype": dtype,
                   "bitwise": equal, "ms": time_ms(torch, run, reps)}
            row["host_us"] = host_us(torch, run, MULTI_HOST_CALLS, 5)
            row["device_ms"] = device_ms(torch, run, reps, row["host_us"])
            result["multi_step"].append(row)
            print(f"[ab] {root} {name} {'x'.join(map(str, shape))} n={steps} {dtype}: per call "
                  f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, host "
                  f"{row['host_us']:.2f} µs a call, bitwise {equal}", flush=True)
            del run, plain, got, want
        torch.cuda.empty_cache()


def time_masked(torch, root, result, dev, tdts):
    """masked_step at 12288² (three dtypes) and 252² f32, each launch held
    bitwise against the plain version first."""
    from rocm_mpi_tpu_torch.ops import kernels as kernel_ops

    spacing = (0.1, 0.1)
    inv_d2 = kernel_ops.inv_d2_of(spacing)
    for shape, names in ((MASKED_BIG, DTYPES), (MASKED_SMALL, ("f32",))):
        for name in names:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            T = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(tdts[name])
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 0.002).to(tdts[name])
            out = torch.empty_like(T)

            def run():
                return kernel_ops.masked_step(T, Cm, spacing, out=out)

            got = run()
            equal = bool(torch.equal(got, kernel_ops.masked_step_plain(T, Cm, inv_d2)))
            row = {"shape": list(shape), "dtype": name, "bitwise": equal,
                   "ms": time_ms(torch, run, 30 if shape == MASKED_BIG else 200)}
            extra = ""
            if shape == MASKED_SMALL:
                row["host_us"] = host_us(torch, run)
                extra = f", host {row['host_us']:.2f} µs a call"
            result["masked_step"].append(row)
            print(f"[ab] {root} masked_step {shape[0]}x{shape[1]} {name}: {row['ms']:.4f} ms"
                  f"{extra}, bitwise {equal}", flush=True)
            del T, Cm, out, got
            torch.cuda.empty_cache()


def padded_case(torch, name, core, tdt, dev):
    """(launch, plain version, bytes moved) of a kp_flux, kp_residual or
    fused_step_padded case: Tp in [0, 1), Cp in [1, 2), the kp app's λ and
    a small dt; the residual's fluxes those the plain flux makes of Tp."""
    from rocm_mpi_tpu_torch.ops import kernels, kp

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo=0.0):
        return (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                + lo).to(tdt)

    spacing = (0.1, 0.07, 0.05)[:len(core)]
    item = torch.empty((), dtype=tdt).element_size()
    cells = 1
    for n in core:
        cells *= n
    Tp = rand(tuple(n + 2 for n in core))
    if name == "kp_flux":
        lx, ly = core
        outs = (torch.empty((lx + 1, ly), dtype=tdt, device=dev),
                torch.empty((lx, ly + 1), dtype=tdt, device=dev))
        return (lambda: kp.kp_flux(Tp, 1.0, spacing, out=outs),
                lambda: kp.kp_flux_plain(Tp, 1.0, kp.inv_d_of(spacing)),
                (Tp.numel() + outs[0].numel() + outs[1].numel()) * item)
    Cp = rand(core, 1.0)
    out = torch.empty(core, dtype=tdt, device=dev)
    if name == "kp_residual":
        qx, qy = kp.kp_flux_plain(Tp, 1.0, kp.inv_d_of(spacing))
        return (lambda: kp.kp_residual(qx, qy, Cp, spacing, out=out),
                lambda: kp.kp_residual_plain(qx, qy, Cp, kp.inv_d_of(spacing)),
                (qx.numel() + qy.numel() + 2 * cells) * item)
    return (lambda: kernels.fused_step_padded(Tp, Cp, 1.0, 1e-4, spacing, out=out),
            lambda: kernels.fused_step_padded_plain(Tp, Cp, 1.0, 1e-4,
                                                    kernels.inv_d2_of(spacing)),
            (Tp.numel() + 2 * cells) * item)


def time_padded(torch, root, kernels, result, dev, tdts):
    """kp_flux, kp_residual and fused_step_padded (module docstring)."""
    cases = [(name, core, dtype) for name, core, names in PADDED_CASES
             if name in kernels for dtype in names]
    for name, core, dtype in cases:
        run, plain, nbytes = padded_case(torch, name, core, tdts[dtype], dev)
        got, want = run(), plain()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        small = core[0] <= 252
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"kernel": name, "shape": list(core), "dtype": dtype,
               "bitwise": equal, "bound_ms": bound, "ms": time_ms(torch, run, 200 if small else 30)}
        row["host_us"] = host_us(torch, run, 200, 5)
        row["device_ms"] = device_ms(torch, run, 200 if small else 30, row["host_us"])
        result["padded"].append(row)
        print(f"[ab] {root} {name} {'x'.join(map(str, core))} {dtype}: "
              f"per call {row['ms']:.4f} ms (of bound {bound / row['ms']:.2f}), device "
              f"{row['device_ms']:.4f} ms (of bound {bound / row['device_ms']:.2f}), host "
              f"{row['host_us']:.2f} µs a call, bitwise {equal}", flush=True)
        del run, plain
        torch.cuda.empty_cache()


def time_kp_small(torch, root, result, dev, tdts):
    """The three kp kernels' device ms at the kp app's 128², each dtype,
    beside an empty kernel's (the launch floor), all queued behind
    torch.cuda._sleep and timed launch by launch."""
    from rocm_mpi_tpu_torch.ops import kp

    def empty():
        torch.cuda._sleep(0)

    floor = device_ms(torch, empty, 200, host_us(torch, empty, 200, 5))
    result["kp_small"] = {"empty_kernel_device_ms": floor}
    spacing = (0.1, 0.07)
    lx, ly = KP_SHAPE
    for name, tdt in tdts.items():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        Tp = torch.rand((lx + 2, ly + 2), generator=gen, device=dev, dtype=torch.float64).to(tdt)
        Cp = (torch.rand((lx, ly), generator=gen, device=dev, dtype=torch.float64) + 1).to(tdt)
        qx, qy = kp.kp_flux(Tp, 1.0, spacing)
        dTdt = kp.kp_residual(qx, qy, Cp, spacing)
        out = torch.empty_like(dTdt)
        row = {}
        for label, fn in (("kp_flux", lambda: kp.kp_flux(Tp, 1.0, spacing, out=(qx, qy))),
                          ("kp_residual", lambda: kp.kp_residual(qx, qy, Cp, spacing,
                                                                 out=dTdt)),
                          ("kp_update", lambda: kp.kp_update(Tp, dTdt, 1e-4, out=out))):
            row[label] = device_ms(torch, fn, 200, host_us(torch, fn, 200, 5))
        result["kp_small"][name] = row
        print(f"[ab] {root} kp 128² {name} device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; empty kernel {floor:.4f}", flush=True)


def time_tb3(torch, root, result, dev, tdts):
    """tb_sweep in 3D (module docstring)."""
    from rocm_mpi_tpu_torch.ops import multistep

    inv_d2 = (100.0, 156.25, 204.08163265306123)
    for shape, k in TB3_CASES:
        for name, tdt in tdts.items():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            T = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(tdt)
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 1e-4).to(tdt)
            out = torch.empty_like(T)
            row = {"shape": list(shape), "k": k, "dtype": name}
            want = multistep.tb_sweep_plain(T, Cm, inv_d2, k)
            try:
                got = multistep.tb_sweep(T, Cm, inv_d2, k, out=out)
                torch.cuda.synchronize()
            except RuntimeError as err:
                row.update(bitwise=True, refused=str(err).splitlines()[0])
                print(f"[ab] {root} tb_sweep {'x'.join(map(str, shape))} k={k} {name}: "
                      f"refused ({row['refused'][:80]})", flush=True)
                result["tb_sweep_3d"].append(row)
                continue
            row["bitwise"] = bool(torch.equal(got, want))
            row["ms"] = time_ms(torch, lambda: multistep.tb_sweep(T, Cm, inv_d2, k, out=out), 20)
            row["plain_ms"] = time_ms(torch, lambda: multistep.tb_sweep_plain(T, Cm, inv_d2, k),
                                      5)
            plan = ""
            if hasattr(multistep, "_device_plan3"):
                p = multistep._device_plan3(dev.index or 0, shape, k, tdt)
                row["plan"] = p._asdict()
                row["cell_updates"] = multistep.tb3_updates(p, shape)
                plan = (f"; tile {p.e1}x{p.e2}, {p.threads} threads, {p.segments} segments "
                        f"of {p.seg}, {row['cell_updates'] / (k * T.numel()):.2f} updates "
                        "per core update")
            result["tb_sweep_3d"].append(row)
            print(f"[ab] {root} tb_sweep {'x'.join(map(str, shape))} k={k} {name}: "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bitwise "
                  f"{row['bitwise']}{plan}", flush=True)
            del T, Cm, out, got, want
            torch.cuda.empty_cache()


def worker(root: str, kernels) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from rocm_mpi_tpu_torch.ops import kernels as kernel_ops
    from rocm_mpi_tpu_torch.ops import kp, multistep

    assert os.path.abspath(multistep.__file__).startswith(os.path.abspath(root))
    dev = torch.device("cuda", 0)
    tdts = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
    result = {"root": root, "masked_step": [], "tb_sweep": [], "kp_update_host_us": {},
              "multi_step": [], "fused_step_cm": [], "padded": [], "tb_sweep_3d": []}
    time_padded(torch, root, kernels, result, dev, tdts)
    if "kp_residual" in kernels:
        time_kp_small(torch, root, result, dev, tdts)
    if "tb_sweep_3d" in kernels:
        time_tb3(torch, root, result, dev, tdts)
    if "masked_step" in kernels:
        time_masked(torch, root, result, dev, tdts)
    if "fused_step_cm" in kernels:
        time_fused(torch, root, result, dev, tdts)
    time_multi(torch, root, kernels, result, dev, tdts)
    inv_d2 = (1.0, 1.0)
    for shape, k in TB_CASES if "tb_sweep" in kernels else ():
        for name in DTYPES:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            T = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(tdts[name])
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 0.2).to(tdts[name])
            out = torch.empty_like(T)
            got = multistep.tb_sweep(T, Cm, inv_d2, k, out=out)
            want = multistep.tb_sweep_plain(T, Cm, inv_d2, k)
            equal = bool(torch.equal(got, want))
            del want
            ms = time_ms(torch, lambda: multistep.tb_sweep(T, Cm, inv_d2, k, out=out), 20)
            row = {"shape": list(shape), "k": k, "dtype": name, "ms": ms, "bitwise": equal}
            result["tb_sweep"].append(row)
            print(f"[ab] {root} tb_sweep {shape[0]}x{shape[1]} k={k} {name}: {ms:.4f} ms, "
                  f"bitwise {equal}", flush=True)
            del T, Cm, out, got
            torch.cuda.empty_cache()
    if "kp_update" not in kernels:
        return result
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lx, ly = KP_SHAPE
    Tp = torch.rand((lx + 2, ly + 2), generator=gen, device=dev)
    dTdt = torch.rand((lx, ly), generator=gen, device=dev)
    out = torch.empty((lx, ly), device=dev)
    result["kp_update_host_us"]["wrapper"] = host_us(
        torch, lambda: kp.kp_update(Tp, dTdt, 1e-3, out=out))
    for module, name in ((kp, "_update_operands_ok"), (kernel_ops, "_operands_ok")):
        if hasattr(module, name):
            setattr(module, name, lambda *args: False)
            result["kp_update_host_us"][f"without {name}"] = host_us(
                torch, lambda: kp.kp_update(Tp, dTdt, 1e-3, out=out))
    print(f"[ab] {root} kp_update 128² f32 host µs a call: {result['kp_update_host_us']}",
          flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", help="checkouts to time, in order")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                        help="what each process times (default: all)")
    parser.add_argument("--json", help="write the results here")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print("AB_RESULT " + json.dumps(worker(args.worker, args.kernels)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ab] card: {card}", flush=True)
    results = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root,
                               "--kernels", *args.kernels], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            print(f"[ab] {root}: worker failed (rc {proc.returncode})", flush=True)
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT ")][-1]
        results.append(json.loads(line[len("AB_RESULT "):]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)
    ok = all(r["bitwise"] for run in results
             for r in run["masked_step"] + run["tb_sweep"] + run["multi_step"]
             + run.get("fused_step_cm", []) + run.get("padded", [])
             + run.get("tb_sweep_3d", []))
    print(f"[ab] every timed launch bitwise equal to its plain version: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
