"""Ranks of the port's multi-rank CPU checks (gloo), started by
rocm_mpi_tpu_torch.parallel.launcher.spawn_ranks from
tests/test_torch_distributed.py (`run_rank`), tests/test_torch_overlap.py
(`run_overlap_rank`), tests/test_torch_kp.py (`run_kp_rank`) and
tests/test_torch_scan.py (`run_scan_rank`), tests/test_torch_sharded_scan.py
(`run_sharded_scan_rank`), tests/test_torch_weak_scaling.py
(`run_weak_scaling_rank`), tests/test_torch_checkpoint.py
(`run_checkpoint_rank`), tests/test_torch_diffusion_3d.py
(`run_3d_rank`), tests/test_torch_telemetry.py (`run_weak_scaling_app`,
`run_telemetry_step_rank`) and tests/test_torch_health.py
(`run_progress_rank`); it holds no tests itself. Imports torch and the port
only, so a spawned rank starts fast; the parent holds the results against
the JAX package."""

from __future__ import annotations

import numpy as np
import torch


def global_field(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def run_rank(rank, spec):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
    from rocm_mpi_tpu_torch.state import state_from_numpy

    torch.set_num_threads(1)
    assert distributed.rank() == rank and distributed.world_size() == spec["nprocs"]
    out = {"halo": {}, "runs": {}, "from_jax": {}, "launches": None, "deep": {}}

    for key, (shape, dims) in spec["halo_cases"].items():
        grid = init_global_grid(*shape, dims=dims)
        G = global_field(shape)
        u = torch.from_numpy(np.ascontiguousarray(G[grid.shard_slices()]))
        out["halo"][key] = exchange_halo(u, grid).numpy()

    shape, dims = spec["shape"], spec["dims"]
    kernels.reset_launches()
    for dtype, variant in spec["runs"]:
        cfg = DiffusionConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"],
                              dtype=dtype, dims=dims)
        model = HeatDiffusion(cfg, device="cpu")
        res = model.run(variant)
        out["runs"][(dtype, variant)] = gather_to_host0(res.T, model.grid)
    out["launches"] = dict(kernels.LAUNCHES)

    # The deep schedule on its VMEM route, and on the temporal-blocked
    # route with the VMEM budget shrunk as the parent shrinks JAX's.
    from rocm_mpi_tpu_torch.ops import multistep

    deep = spec["deep"]
    budget = multistep._VMEM_BLOCK_BUDGET_BYTES
    for dtype, route in spec["deep_runs"]:
        cfg = DiffusionConfig(global_shape=deep["shape"], nt=deep["nt"],
                              warmup=deep["warmup"], dtype=dtype, dims=deep["dims"])
        model = HeatDiffusion(cfg, device="cpu")
        multistep._VMEM_BLOCK_BUDGET_BYTES = deep["hbm_budget"] if route == "hbm-tb" else budget
        try:
            res = model.run_deep(block_steps=deep["k"])
        finally:
            multistep._VMEM_BLOCK_BUDGET_BYTES = budget
        out["deep"][(dtype, route)] = (res.route, res.k, gather_to_host0(res.T, model.grid))

    # Start from the JAX package's state, carried across as numpy.
    for dtype, (T0, Cp) in spec["jax_states"].items():
        cfg = DiffusionConfig(global_shape=shape, dtype=dtype, dims=dims)
        model = HeatDiffusion(cfg, device="cpu")
        T, C = state_from_numpy(T0, Cp, model.grid, device="cpu")
        T = model.advance_fn("perf")(T, C, spec["nt"])
        out["from_jax"][dtype] = gather_to_host0(T, model.grid)
    return out


def run_overlap_rank(rank, spec):
    """One rank of tests/test_torch_overlap.py: the diffusion and wave
    `hide` variants, the wave `perf` variant, the wave deep schedule, and
    the shallow-water variants and deep schedule on small sharded grids,
    each shard gathered to rank 0."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.state import swe_state_from_numpy, wave_state_from_numpy

    torch.set_num_threads(1)
    kernels.reset_launches()
    out = {"diffusion": {}, "wave": {}, "wave_deep": {}, "swe": {}, "swe_deep": {}}
    for dtype, variant, b_width in spec["diffusion_runs"]:
        cfg = DiffusionConfig(**spec["diffusion"], dtype=dtype, b_width=b_width)
        model = HeatDiffusion(cfg, device="cpu")
        out["diffusion"][(dtype, variant, b_width)] = gather_to_host0(model.run(variant).T,
                                                                      model.grid)
    for key, case in spec["wave_runs"].items():
        cfg = WaveConfig(**case["cfg"])
        model = AcousticWave(cfg, device="cpu")
        U, Uprev, C2 = wave_state_from_numpy(*spec["wave_states"][case["state"]], model.grid,
                                             device="cpu")
        U, Uprev = model.advance_fn(case["variant"])(U, Uprev, C2, case["n"])
        out["wave"][key] = (gather_to_host0(U, model.grid), gather_to_host0(Uprev, model.grid))
    for dtype in spec["wave_deep_dtypes"]:
        cfg = WaveConfig(**spec["wave_deep"], dtype=dtype)
        model = AcousticWave(cfg, device="cpu")
        res = model.run_deep(block_steps=spec["wave_deep_k"])
        out["wave_deep"][dtype] = (res.route, res.k, gather_to_host0(res.U, model.grid))

    def gathered(h, us, grid):
        return (gather_to_host0(h, grid), tuple(gather_to_host0(u, grid) for u in us))

    for key, case in spec["swe_runs"].items():
        model = ShallowWater(SWEConfig(**case["cfg"]), device="cpu")
        h0, us0 = spec["swe_states"][case["state"]]
        h, us = swe_state_from_numpy(h0, us0, model.grid, device="cpu")
        h, us = model.advance_fn(case["variant"])(h, us, model.face_masks(), case["n"])
        out["swe"][key] = gathered(h, us, model.grid)
    for dtype in spec["swe_deep_dtypes"]:
        model = ShallowWater(SWEConfig(**spec["swe_deep"], dtype=dtype), device="cpu")
        res = model.run_deep(block_steps=spec["swe_deep_k"])
        out["swe_deep"][dtype] = (res.route, res.k, *gathered(res.h, res.us, model.grid))
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def run_kp_rank(rank, spec):
    """One rank of tests/test_torch_kp.py: the `kp` variant on each
    (dtype, process grid) case, the field gathered to rank 0, with the
    launch counts of the whole run (none on the CPU)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    torch.set_num_threads(1)
    kernels.reset_launches()
    out = {"runs": {}}
    for dtype, dims in spec["cases"]:
        cfg = DiffusionConfig(global_shape=spec["shape"], nt=spec["nt"], warmup=0, dtype=dtype,
                              dims=dims)
        model = HeatDiffusion(cfg, device="cpu")
        out["runs"][(dtype, dims)] = gather_to_host0(model.run("kp").T, model.grid)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def run_scan_rank(rank, spec):
    """One rank of tests/test_torch_scan.py: every variant of the three
    models through run(driver="step") and run(driver="scan") on this
    rank's shard. Returns {(model, variant): (scan bitwise == step, scan
    route, q)} and the launch counts (none on the CPU)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels

    torch.set_num_threads(1)
    kernels.reset_launches()
    kw = dict(global_shape=spec["shape"], nt=spec["nt"], warmup=spec["warmup"],
              dtype=spec["dtype"], dims=spec["dims"])
    out = {"runs": {}}
    models = (("diffusion", HeatDiffusion(DiffusionConfig(**kw), device="cpu"),
               lambda r: (r.T,)),
              ("wave", AcousticWave(WaveConfig(**kw), device="cpu"), lambda r: (r.U,)),
              ("swe", ShallowWater(SWEConfig(**kw), device="cpu"), lambda r: (r.h, *r.us)))
    for name, model, fields in models:
        variants = model.variants if name == "diffusion" else model.VARIANTS
        for variant in variants:
            step = model.run(variant, driver="step")
            scan = model.run(variant, driver="scan")
            same = all(torch.equal(a, b) for a, b in zip(fields(step), fields(scan)))
            out["runs"][(name, variant)] = (same, scan.route, scan.k)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def run_sharded_scan_rank(rank, spec):
    """One rank of tests/test_torch_sharded_scan.py: each (model, variant,
    wire mode, grid) of spec["cases"] through run(driver="step") and
    run(driver="scan") on one model, so both drivers share the grid's
    exchange buffers. Returns {case: (scan bitwise == step, scan route,
    q)}."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    torch.set_num_threads(1)
    models = {"diffusion": (HeatDiffusion, DiffusionConfig, lambda r: (r.T,)),
              "wave": (AcousticWave, WaveConfig, lambda r: (r.U,)),
              "swe": (ShallowWater, SWEConfig, lambda r: (r.h, *r.us))}
    out = {}
    for case in spec["cases"]:
        name, variant, mode, shape, dims = case
        model_cls, cfg_cls, fields = models[name]
        cfg = cfg_cls(global_shape=shape, lengths=(10.0,) * len(shape), nt=spec["nt"],
                      warmup=spec["warmup"], dtype="f64", dims=dims, wire_mode=mode)
        model = model_cls(cfg, device="cpu")
        scan = model.run(variant, driver="scan")
        step = model.run(variant, driver="step")
        same = all(torch.equal(a, b) for a, b in zip(fields(step), fields(scan)))
        out[case] = (same, scan.route, scan.k)
    return out


def run_weak_scaling_rank(rank, spec):
    """One rank of tests/test_torch_weak_scaling.py: the app's ladder of
    spec["argv"] with every diffusion model started from the JAX package's
    initial state (spec["jax_state"], numpy), and the last rung's field
    gathered to rank 0. Returns (rows, gathered field or None)."""
    from rocm_mpi_tpu_torch.apps import weak_scaling
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.state import state_from_numpy

    torch.set_num_threads(1)
    HeatDiffusion.init_state = lambda self: state_from_numpy(*spec["jax_state"], self.grid,
                                                             device="cpu")
    args = weak_scaling.make_parser().parse_args(spec["argv"])
    rows = weak_scaling.ladder(args, torch.device("cpu"), log=lambda msg: None)
    last = rows[-1][1]
    return [row for row, _ in rows], gather_to_host0(last.result.T, last.model.grid)


def run_checkpoint_rank(rank, spec):
    """One rank of tests/test_torch_checkpoint.py on a 2×2 grid: the
    shallow water's segmented runs (the step driver every 16, the scan
    driver with exact counts every 5) against the straight run, and a
    crash after 32 steps resumed from latest_valid_step into a fresh
    model. Returns the bitwise verdicts, the resumed step and rank 0's
    manifest."""
    from rocm_mpi_tpu_torch.config import SWEConfig
    from rocm_mpi_tpu_torch.models import ShallowWater
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    cfg = SWEConfig(global_shape=spec["shape"], nt=spec["nt"], warmup=0, dtype="f64",
                    dims=spec["dims"])

    def fresh():
        model = ShallowWater(cfg, device="cpu")
        Mus = model.face_masks()
        step = model.advance_fn("perf")
        scan, _ = model.scan_advance_fn("perf", nt=5, warmup=0, exact=True)
        return (model, lambda s, n: tuple(step(*s, Mus, n)),
                lambda s, n: tuple(scan(*s, Mus, n)))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(ckpt.tree_leaves(a), ckpt.tree_leaves(b)))

    model, step_adv, scan_adv = fresh()
    grid = model.grid
    nt = spec["nt"]
    ref = step_adv(model.init_state(), nt)
    root = spec["dir"]
    out = {}
    seg = ckpt.run_segmented(step_adv, model.init_state(), nt, f"{root}/step", 16, grid=grid)
    out["step_segments"] = same(seg, ref)
    seg = ckpt.run_segmented(scan_adv, model.init_state(), nt, f"{root}/scan", 5, grid=grid)
    out["scan_segments"] = same(seg, ref)
    # "Crash" after 32 of 48 steps, then a fresh model resumes.
    ckpt.run_segmented(step_adv, model.init_state(), 32, f"{root}/crash", 16, grid=grid)
    model, step_adv, _ = fresh()
    start = ckpt.latest_valid_step(f"{root}/crash", grid=model.grid)
    like = model.init_state()
    restored = ckpt.restore_state(f"{root}/crash", start, like, grid=model.grid)
    out["fresh_tensors"] = all(r.data_ptr() != t.data_ptr() for r, t in
                               zip(ckpt.tree_leaves(restored), ckpt.tree_leaves(like)))
    final = ckpt.run_segmented(step_adv, restored, nt, f"{root}/crash", 16, start_step=start,
                               grid=model.grid)
    out["resumed"] = same(final, ref)
    out["start"] = start
    flat = ckpt.restore_state(f"{root}/crash", nt, None, grid=model.grid, devices="cpu")
    out["like_none"] = same(flat, ref)
    out["manifest"] = ckpt.read_manifest(f"{root}/crash", nt) if rank == 0 else None
    return out


def run_3d_rank(rank, spec):
    """One rank of tests/test_torch_diffusion_3d.py: each 3D diffusion
    variant of spec["variants"] from the JAX package's initial state
    (spec["jax_state"], numpy) on spec["dims"], gathered to rank 0."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.state import state_from_numpy

    torch.set_num_threads(1)
    kernels.reset_launches()
    cfg = DiffusionConfig(global_shape=spec["shape"], lengths=(10.0,) * 3, nt=spec["nt"],
                          warmup=0, dtype="f64", dims=spec["dims"], b_width=spec["b_width"])
    model = HeatDiffusion(cfg, device="cpu")
    T0, Cp = state_from_numpy(*spec["jax_state"], model.grid, device="cpu")
    out = {}
    for variant in spec["variants"]:
        T = model.advance_fn(variant)(T0.clone(), Cp, spec["nt"])
        out[variant] = gather_to_host0(T, model.grid)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def run_weak_scaling_app(rank, argv):
    """One rank of the port's weak-scaling app, as its command line runs
    it (tests/test_torch_telemetry.py, under spawn_ranks(telemetry_dir=))."""
    from rocm_mpi_tpu_torch.apps import weak_scaling

    torch.set_num_threads(1)
    return weak_scaling.main(argv)


def run_telemetry_step_rank(rank, spec):
    """One rank of tests/test_torch_telemetry.py on a 2×1 grid: the
    diffusion `perf` and `hide` steps under the step driver, telemetry off
    then on (into spec["dir"]), each from the same initial state. Returns
    per variant: whether the fields are bitwise equal, the launch counts
    of both runs, the trace annotations of the telemetry-on run, and its
    step_window span's dur_s beside the run's wtime."""
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels

    torch.set_num_threads(1)
    cfg = DiffusionConfig(global_shape=(32, 16), lengths=(10.0, 10.0), nt=10, warmup=2,
                          dtype="f64", dims=(2, 1), b_width=(4, 4))
    out = {}
    for variant in ("perf", "hide"):
        runs = []
        for on in (False, True):
            telemetry.clear()
            if on:
                telemetry.configure(directory=spec["dir"], enabled=True, rank=rank)
            else:
                telemetry.configure(enabled=False)
            kernels.reset_launches()
            res = HeatDiffusion(cfg, device="cpu").run(variant, driver="step")
            runs.append((res, dict(kernels.LAUNCHES),
                         [(r["name"], r.get("attrs")) for r in telemetry.records("trace")],
                         [r for r in telemetry.records("span") if r["name"] == "step_window"]))
        telemetry.configure(enabled=False)
        (off, l_off, _, _), (on_, l_on, traced, windows) = runs
        out[variant] = dict(same=torch.equal(off.T, on_.T), launches=(l_off, l_on),
                            traced=traced, window=(windows[0]["dur_s"], on_.wtime),
                            window_attrs=windows[0]["attrs"])
    return out


def run_progress_rank(rank, spec):
    """One rank of tests/test_torch_health.py's stall drill: the flight
    recorder on into spec["dir"]; at each of 4 window boundaries the rank
    publishes its step and meets the other at a barrier, rank 1 sleeping
    spec["sleep"] seconds before publishing boundary 2's step."""
    import time

    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.telemetry import flight

    flight.enable(directory=spec["dir"], rank=rank)
    for w in range(4):
        if rank == 1 and w == 2:
            time.sleep(spec["sleep"])
        flight.progress(step=10 * w, windows=1)
        distributed.barrier()
    return flight.snapshot()["counters"]
