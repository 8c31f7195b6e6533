"""Driver entry points — twins of `__graft_entry__.entry()` and
`__graft_entry__.dryrun_multichip(n)`.

`entry()` returns the `perf` variant's single step at the benchmark
geometry (252², f32, one device) and its example state: on a GPU that
step is one launch of the masked_step kernel.

`dryrun_multichip(n)` runs every sharded path of the three workloads on
n ranks at tiny shapes and holds each against the host-staged oracle or
the `ap` referee, as the JAX dry run holds its n-device mesh.
"""

from __future__ import annotations

N_STEPS, WARMUP = 8, 4
LOCAL = (16, 8)  # a non-square shard: hide's b_width (32, 4) clamps to (8, 4)
LOCAL_3D = (8, 8, 8)
TOL = dict(rtol=2e-5, atol=2e-6)


def entry(device=None):
    """(fn, (T, Cp)): fn(T, Cp) -> new T, one perf step at 252² f32."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = DiffusionConfig(
        global_shape=(252, 252), lengths=(10.0, 10.0), nt=100, warmup=0,
        dtype="f32", dims=(1, 1),
    )
    grid = init_global_grid(*cfg.global_shape, lengths=cfg.lengths,
                            dims=cfg.dims, nprocs=1, rank=0)
    model = HeatDiffusion(cfg, grid=grid, device=device)
    T, Cp = model.init_state()
    return model.step_fn("perf"), (T, Cp)


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Run every sharded path of the three workloads on `n_devices` ranks
    (parallel/launcher.spawn_ranks) and hold each against its referee;
    prints `dryrun_multichip ok: ...` and returns the ranks' reports.

    Ranks: gloo on the CPU (`device="cpu"`); on CUDA (the default) one
    rank per card over NCCL when `n_devices` cards are visible, else gloo
    with the ranks sharing the visible cards (halo slabs staged through
    host memory). Every rank, as in `__graft_entry__.dryrun_multichip`:

    * diffusion on a 2D process grid of 16×8 shards (b_width (32, 4)
      clamps to (8, 4)): `ap`, `kp`, `perf` and `hide` advanced over a
      warmup window and a timed window (4 + 4 steps), each within rtol
      2e-5 / atol 2e-6 of the host-staged oracle (parallel/halo.py
      HostStagedStepper) over the same 8 steps; `gather_to_host0` of the
      `perf` field bitwise equal to every rank's all-gather of it; two k =
      4 deep sweeps against the oracle;
    * an HBM-class deep sweep (k = 8) on shards of
      `ops/multistep.hbm_class_edge()` cells a side, whose padded block
      exceeds the VMEM budget: its route is "hbm-tb", and on CUDA
      `kernels.LAUNCHES["tb_sweep"]` counts its launch; within the
      tolerance of 8 `ap` steps;
    * the wave: `perf` and `hide` against `ap`, and two k = 4 deep sweeps
      against `ap` (both fields of the pair);
    * the shallow water: `ap`'s closed-basin mass within 1e-6, `perf` and
      `hide` against `ap`, two k = 4 deep sweeps against `ap`;
    * the same in 3D on `suggest_dims(n, 3)` ((2, 2, 2) for n = 8) with
      8³ shards: diffusion `ap`, `perf`, `hide` and two k = 2 deep sweeps
      against the oracle, the wave and the shallow water against `ap`.

    * the checkpoint/resume leg: the `perf` advance of the 2D diffusion
      grid segmented with per-rank saves every 2 steps (utils/checkpoint
      `run_segmented`), stopped at the midpoint, `latest_step` restored
      into a fresh template and run to the end: bitwise the straight run.
    """
    import tempfile

    import torch

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.parallel.mesh import suggest_dims
    from rocm_mpi_tpu_torch.utils.backend import resolve_device

    n = int(n_devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        gpus = n if cards >= n else cards
        backend = "nccl" if cards >= n else "gloo"
    else:
        gpus, backend = 0, "gloo"
    with tempfile.TemporaryDirectory(prefix="rmt-dryrun-ckpt-") as ckpt_dir:
        spec = dict(device=dev.type, gpus=gpus, ckpt_dir=ckpt_dir)
        reports = spawn_ranks(n, _dryrun_rank, (spec,), backend=backend, timeout=600)
    dims, dims3 = suggest_dims(n, 2), suggest_dims(n, 3)
    where = (f"{n} CPU ranks (gloo)" if dev.type == "cpu" else
             f"{n} ranks on {gpus} GPU(s) ({backend})")
    r0 = reports[0]
    print(
        f"dryrun_multichip ok: {where}, grid {dims}, global "
        f"{tuple(a * d for a, d in zip(LOCAL, dims))}, shard {LOCAL}, b_width (32, 4) "
        f"clamped to {r0['b_width']}; variants ap/kp/perf/hide x{N_STEPS} steps "
        f"(warmup {WARMUP}) agree with the host-staged oracle (rtol 2e-5); "
        "gather_to_host0 ok; deep-halo sweeps (2x k=4) match the oracle; "
        f"HBM-class {r0['hbm_edge']}²-shard deep sweep routed to {r0['hbm_route']} "
        f"(tb_sweep launches {r0['hbm_tb_launches']}) and matches ap; wave "
        f"perf/hide and deep (2x k=4) agree with ap; SWE perf/hide and deep (2x k=4) "
        f"agree with ap, mass drift {r0['swe_mass_drift']:.2e}; 3D grid {dims3} "
        "ap/perf/hide + deep (2x k=2) match the 3D oracle; wave-3D and SWE-3D "
        "perf/hide + deep (2x k=2) agree with ap; checkpoint/resume: perf segmented with "
        f"per-rank saves every 2 steps, crashed at step {r0['ckpt_latest']}, resumed from "
        f"latest_step into a fresh template, bitwise == the straight {N_STEPS}-step run",
        flush=True,
    )
    return reports


def _check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def _allclose(got, want, what: str):
    import numpy as np

    np.testing.assert_allclose(np.asarray(got), want, **TOL,
                               err_msg=f"{what} disagrees with its referee")


def _host(t):
    return t.detach().cpu().numpy()


def _dryrun_rank(rank: int, spec: dict) -> dict:
    """One rank of dryrun_multichip (started by spawn_ranks)."""
    import numpy as np
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels, multistep
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.deep_halo import make_deep_sweep
    from rocm_mpi_tpu_torch.parallel.gather import allgather_to_host, gather_to_host0
    from rocm_mpi_tpu_torch.parallel.halo import HostStagedStepper
    from rocm_mpi_tpu_torch.parallel.mesh import suggest_dims

    if spec["device"] == "cuda":
        device = torch.device("cuda", rank % spec["gpus"])
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    distributed.barrier()
    n = distributed.world_size()
    report = {"rank": rank, "launches": {}, "routes": {}}

    def leg(name, fn):
        """Run one leg with the launch counts set to 0 around it."""
        kernels.reset_launches()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["launches"][name] = dict(kernels.LAUNCHES)
        return out

    def mine(full, grid):
        return full[grid.shard_slices()]

    # ---- diffusion, 2D ---------------------------------------------------
    dims = suggest_dims(n, 2)
    shape = tuple(a * d for a, d in zip(LOCAL, dims))
    cfg = DiffusionConfig(global_shape=shape, lengths=(10.0, 10.0), nt=100, warmup=0,
                          dtype="f32", dims=dims)
    model = HeatDiffusion(cfg, device=device)
    grid = model.grid
    _check(grid.nprocs == n and grid.local_shape == LOCAL,
           f"grid {grid.dims} of {grid.local_shape} shards for {n} ranks")
    T0, Cp = model.init_state()
    oracle = HostStagedStepper(grid, cfg.lam, cfg.dt).run(
        allgather_to_host(T0, grid), allgather_to_host(Cp, grid), N_STEPS)
    results = {}
    for variant in ("ap", "kp", "perf", "hide"):
        def advance(variant=variant):
            adv = model.advance_fn(variant)
            return adv(adv(T0.clone(), Cp, WARMUP), Cp, N_STEPS - WARMUP)

        T = leg(variant, advance)
        _check(tuple(T.shape) == LOCAL, f"variant {variant!r} returned {tuple(T.shape)}")
        _allclose(_host(T), mine(oracle, grid), f"variant {variant!r}")
        results[variant] = T
    report["b_width"] = _hide_b_width(model)

    full = gather_to_host0(results["perf"], grid)
    every = allgather_to_host(results["perf"], grid)
    if rank == 0:
        _check(full is not None and full.shape == shape, "gather_to_host0 gave no field")
        np.testing.assert_array_equal(full, every, err_msg="gather_to_host0 != all-gather")
    np.testing.assert_array_equal(mine(every, grid), _host(results["perf"]))

    sched = make_deep_sweep(grid, 4, cfg.lam, model.dt, cfg.spacing)

    def deep():
        Cm = sched.prepare(Cp)
        return sched.sweep(sched.sweep(T0.clone(), Cm), Cm)

    _allclose(_host(leg("deep", deep)), mine(oracle, grid), "deep-halo sweeps (2x k=4)")
    report["routes"]["deep"] = sched.route

    # Checkpoint/resume (__graft_entry__.py:201-236): the perf advance
    # segmented with per-rank saves on this grid, "crashed" at the
    # midpoint, resumed from the latest saved step into a fresh template:
    # bitwise the straight run.
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    perf_advance = model.advance_fn("perf")
    ckdir = spec["ckpt_dir"]

    def seg_advance(s, n):
        return (perf_advance(s[0], Cp, n),)

    def resumed_run():
        ckpt.run_segmented(seg_advance, (T0.clone(),), N_STEPS // 2, ckdir, every=2,
                           grid=grid)
        latest = ckpt.latest_step(ckdir)
        _check(latest == N_STEPS // 2,
               f"expected the latest checkpoint at {N_STEPS // 2}, got {latest}")
        fresh = (model.init_state()[0],)
        resumed = ckpt.restore_state(ckdir, latest, fresh, grid=grid)
        (final,) = ckpt.run_segmented(seg_advance, resumed, N_STEPS, ckdir, every=2,
                                      start_step=latest, grid=grid)
        return final, latest

    final, report["ckpt_latest"] = leg("checkpoint", resumed_run)
    straight = perf_advance(T0.clone(), Cp, N_STEPS)
    _check(torch.equal(final, straight),
           "crash-resumed segmented run is not bitwise-equal to the straight run")

    # The HBM-class deep sweep: a shard whose padded block exceeds the VMEM
    # budget takes the temporal-blocked route.
    edge = multistep.hbm_class_edge()
    hcfg = DiffusionConfig(global_shape=(edge * dims[0], edge * dims[1]), lengths=(10.0, 10.0),
                           nt=100, warmup=0, dtype="f32", dims=dims)
    hmodel = HeatDiffusion(hcfg, device=device)
    Th, Cph = hmodel.init_state()
    hsched = make_deep_sweep(hmodel.grid, 8, hcfg.lam, hmodel.dt, hcfg.spacing)
    out_h = leg("hbm", lambda: hsched.sweep(Th.clone(), hsched.prepare(Cph)))
    _check(hsched.route == "hbm-tb", f"HBM-class deep sweep took route {hsched.route!r}")
    tb = report["launches"]["hbm"]["tb_sweep"]
    _check(device.type == "cpu" or tb > 0, "HBM-class deep sweep launched no tb_sweep")
    ref_h = hmodel.advance_fn("ap")(Th.clone(), Cph, 8)
    _allclose(_host(out_h), _host(ref_h), "HBM-routed deep sweep")
    report.update(hbm_edge=edge, hbm_route=hsched.route, hbm_tb_launches=tb)
    del Th, Cph, out_h, ref_h, hmodel

    # ---- the wave, 2D ----------------------------------------------------
    wcfg = WaveConfig(global_shape=shape, lengths=(10.0, 10.0), nt=N_STEPS, warmup=0,
                      dtype="f32", dims=dims)
    _wave_legs(AcousticWave(wcfg, device=device), leg, 4, "wave")

    # ---- the shallow water, 2D -------------------------------------------
    scfg = SWEConfig(global_shape=shape, lengths=(10.0, 10.0), nt=N_STEPS, warmup=0,
                     dtype="f32", dims=dims)
    report["swe_mass_drift"] = _swe_legs(ShallowWater(scfg, device=device), leg, 4, "swe")

    # ---- 3D --------------------------------------------------------------
    dims3 = suggest_dims(n, 3)
    shape3 = tuple(a * d for a, d in zip(LOCAL_3D, dims3))
    n3 = 4
    cfg3 = DiffusionConfig(global_shape=shape3, lengths=(10.0,) * 3, nt=100, warmup=0,
                           dtype="f32", dims=dims3)
    model3 = HeatDiffusion(cfg3, device=device)
    T3, Cp3 = model3.init_state()
    oracle3 = HostStagedStepper(model3.grid, cfg3.lam, cfg3.dt).run(
        allgather_to_host(T3, model3.grid), allgather_to_host(Cp3, model3.grid), n3)
    for variant in ("ap", "perf", "hide"):
        out3 = leg(f"3d-{variant}", lambda v=variant: model3.advance_fn(v)(T3.clone(), Cp3, n3))
        _allclose(_host(out3), mine(oracle3, model3.grid), f"3D variant {variant!r}")
    sched3 = make_deep_sweep(model3.grid, 2, cfg3.lam, model3.dt, cfg3.spacing)

    def deep3():
        Cm3 = sched3.prepare(Cp3)
        return sched3.sweep(sched3.sweep(T3.clone(), Cm3), Cm3)

    _allclose(_host(leg("3d-deep", deep3)), mine(oracle3, model3.grid),
              "3D deep-halo sweeps (2x k=2)")
    w3cfg = WaveConfig(global_shape=shape3, lengths=(10.0,) * 3, nt=n3, warmup=0,
                       dtype="f32", dims=dims3)
    _wave_legs(AcousticWave(w3cfg, device=device), leg, 2, "wave-3d")
    s3cfg = SWEConfig(global_shape=shape3, lengths=(10.0,) * 3, nt=n3, warmup=0,
                      dtype="f32", dims=dims3)
    _swe_legs(ShallowWater(s3cfg, device=device), leg, 2, "swe-3d")
    return report


def _hide_b_width(model) -> tuple[int, ...]:
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width

    return effective_b_width(model.grid.local_shape, model.config.b_width)


def _wave_legs(wave, leg, k: int, label: str):
    """perf and hide against ap over 2k steps, then two k-step deep
    sweeps against ap (both fields)."""
    from rocm_mpi_tpu_torch.parallel.deep_halo import make_wave_deep_sweep

    cfg = wave.config
    n = 2 * k
    U, Uprev, C2 = wave.init_state()
    Ua, Ua_prev = leg(f"{label}-ap", lambda: wave.advance_fn("ap")(U.clone(), Uprev.clone(),
                                                                  C2, n))
    for variant in ("perf", "hide"):
        Uv, _ = leg(f"{label}-{variant}",
                    lambda v=variant: wave.advance_fn(v)(U.clone(), Uprev.clone(), C2, n))
        _allclose(_host(Uv), _host(Ua), f"{label} {variant}")
    sched = make_wave_deep_sweep(wave.grid, k, wave.dt_value, cfg.spacing)

    def deep():
        P = sched.prepare(C2)
        return sched.sweep(*sched.sweep(U.clone(), Uprev.clone(), P), P)

    Uw, Uw_prev = leg(f"{label}-deep", deep)
    _allclose(_host(Uw), _host(Ua), f"{label} deep-halo sweeps")
    _allclose(_host(Uw_prev), _host(Ua_prev), f"{label} deep-halo previous state")


def _swe_legs(swe, leg, k: int, label: str) -> float:
    """ap's closed-basin mass within 1e-6, perf and hide against ap over
    2k steps, then two k-step deep sweeps against ap. Returns ap's
    relative mass drift."""
    from rocm_mpi_tpu_torch.apps._common import global_sum
    from rocm_mpi_tpu_torch.parallel.deep_halo import make_swe_deep_sweep

    cfg = swe.config
    n = 2 * k
    h0, us0 = swe.init_state()
    Mus = swe.face_masks()

    def fresh():
        return h0.clone(), tuple(u.clone() for u in us0)

    mass0 = global_sum(h0)
    ha, _ = leg(f"{label}-ap", lambda: swe.advance_fn("ap")(*fresh(), Mus, n))
    drift = abs(global_sum(ha) - mass0) / abs(mass0)
    _check(drift <= 1e-6, f"{label} closed-basin mass drifted by {drift}")
    for variant in ("perf", "hide"):
        hv, _ = leg(f"{label}-{variant}",
                    lambda v=variant: swe.advance_fn(v)(*fresh(), Mus, n))
        _allclose(_host(hv), _host(ha), f"{label} {variant}")
    sched = make_swe_deep_sweep(swe.grid, k, cfg.dt, cfg.spacing, cfg.H0, cfg.g)

    def deep():
        P = sched.prepare(h0)
        h, us = fresh()
        return sched.sweep(*sched.sweep(h, us, P), P)

    hd, _ = leg(f"{label}-deep", deep)
    _allclose(_host(hd), _host(ha), f"{label} deep-halo sweeps")
    return drift
