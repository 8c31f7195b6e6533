"""Ranks of the transport plane's multi-rank CPU checks (gloo), started by
rocm_mpi_tpu_torch.parallel.launcher.spawn_ranks from
tests/test_torch_ring.py (`run_ring_rank`), tests/test_torch_wire.py
(`run_wire_rank`), tests/test_torch_host_staged.py
(`run_host_staged_rank`), tests/test_torch_sharded_scan.py
(`run_exchange_rank`) and tests/test_torch_deep_scan.py
(`run_deep_scan_rank`); it holds no tests itself. Imports torch and the
port only, so a spawned rank starts fast; the parent holds the results
against the JAX package."""

from __future__ import annotations

import numpy as np
import torch


def global_field(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def run_ring_rank(rank, spec):
    """(sent, received) of the ring demo (shift 1), and of `ring_exchange`
    of the same buffer for each other shift of spec."""
    from rocm_mpi_tpu_torch.parallel.ring import ring_exchange, ring_exchange_demo

    torch.set_num_threads(1)
    sent, received = ring_exchange_demo(spec["width"], device="cpu")
    return {shift: (sent.numpy(), (received if shift == 1 else ring_exchange(sent, shift))
                    .numpy())
            for shift in spec["shifts"]}


def _exchanges(grid, shape, width, mode, dtype, steps):
    """`steps` exchanges of this rank's shard of the seeded global field
    scaled by (1 + step/10), threading the wire state: each exchange's
    padded block and state as numpy."""
    from rocm_mpi_tpu_torch.parallel import wire
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    G = global_field(shape)
    state = wire.init_exchange_state(grid.local_shape, width, mode, dtype)
    out = []
    for t in range(steps):
        u = torch.from_numpy(np.ascontiguousarray(G[grid.shard_slices()] * (1.0 + t / 10)))
        u = u.to(dtype)
        if wire.is_stateful(mode):
            padded, state = exchange_halo(u, grid, width=width, wire_mode=mode,
                                          wire_state=state)
        else:
            padded = exchange_halo(u, grid, width=width, wire_mode=mode)
        out.append((padded.float().numpy() if dtype == torch.bfloat16 else padded.numpy(),
                    tuple(s.numpy() for s in state)))
    return out


def run_wire_rank(rank, spec):
    """The wire modes on a 2×2 grid: raw exchanges with their state, the
    diffusion per-step variants, and the three models' deep schedules, each
    field gathered to rank 0; then the refusals."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    torch.set_num_threads(1)
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    out = {"exchange": {}, "runs": {}, "deep": {}, "refused": {}}
    for key, (shape, dims, width, mode, dtype) in spec["exchanges"].items():
        grid = init_global_grid(*shape, dims=dims)
        out["exchange"][key] = _exchanges(grid, shape, width, mode, dtypes[dtype],
                                          spec["steps"])
    for dtype, variant, mode in spec["runs"]:
        cfg = DiffusionConfig(**spec["diffusion"], dtype=dtype, wire_mode=mode)
        model = HeatDiffusion(cfg, device="cpu")
        out["runs"][(dtype, variant, mode)] = gather_to_host0(model.run(variant).T, model.grid)
    for workload, mode in spec["deep_runs"]:
        if workload == "diffusion":
            model = HeatDiffusion(DiffusionConfig(**spec["diffusion"], wire_mode=mode),
                                  device="cpu")
            res = model.run_deep(block_steps=spec["k"])
            fields = (res.T,)
        elif workload == "wave":
            model = AcousticWave(WaveConfig(**spec["diffusion"], wire_mode=mode), device="cpu")
            res = model.run_deep(block_steps=spec["k"])
            fields = (res.U,)
        else:
            model = ShallowWater(SWEConfig(**spec["diffusion"], wire_mode=mode), device="cpu")
            res = model.run_deep(block_steps=spec["k"])
            fields = (res.h, *res.us)
        out["deep"][(workload, mode)] = (res.route, res.k,
                                         [gather_to_host0(f, model.grid) for f in fields])
    # A stateful mode on a per-step path: the exchange refuses it when the
    # step runs (every rank raises before posting anything).
    for variant in ("perf", "shard", "hide"):
        model = HeatDiffusion(DiffusionConfig(**spec["diffusion"], wire_mode="int8"),
                              device="cpu")
        try:
            model.run(variant)
        except ValueError as e:
            out["refused"][variant] = str(e)
    return out


def host_staged_run(cfg, jax_state):
    """run("shard") of `cfg` (halo_transport="host") started from the JAX
    package's initial state (numpy), so both packages step the same
    numbers: (route, the field gathered to rank 0)."""
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.state import state_from_numpy

    model = HeatDiffusion(cfg, device="cpu")
    model.init_state = lambda: state_from_numpy(*jax_state, model.grid, device="cpu")
    res = model.run("shard")
    return res.route, gather_to_host0(res.T, model.grid)


def run_host_staged_rank(rank, spec):
    """host_staged_run for each (dtype, wire mode) of spec."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig

    torch.set_num_threads(1)
    return {
        (dtype, mode): host_staged_run(
            DiffusionConfig(**spec["cfg"], dtype=dtype, halo_transport="host", wire_mode=mode),
            spec["jax_states"][dtype])
        for dtype, mode in spec["runs"]
    }


# The allocating calls a steady-state exchange must not make.
_FACTORIES = (("torch", "empty"), ("torch", "empty_like"), ("torch", "zeros"),
              ("torch", "zeros_like"), ("torch", "full"), ("Tensor", "contiguous"),
              ("Tensor", "clone"), ("Tensor", "cpu"), ("Tensor", "to"))


def _count_allocations(fn):
    """(fn(), the calls it made to the tensor factories of _FACTORIES)."""
    calls = []
    saved = []
    for owner_name, attr in _FACTORIES:
        owner = torch if owner_name == "torch" else torch.Tensor
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))

        def counted(*a, _orig=orig, _name=f"{owner_name}.{attr}", **k):
            calls.append(_name)
            return _orig(*a, **k)

        setattr(owner, attr, counted)
    try:
        return fn(), calls
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


def run_exchange_rank(rank, spec):
    """Each exchange case of spec: `_exchanges` (ghosts and state of
    spec["steps"] exchanges, held to JAX by the parent) and, for the
    stateless modes, the persistent buffers: the grid's buffers after the
    first exchange_into, their data pointers after every later call, and
    the allocating calls those later calls made."""
    from rocm_mpi_tpu_torch.parallel import wire
    from rocm_mpi_tpu_torch.parallel.halo import exchange_into, place_core
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    torch.set_num_threads(1)
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    out = {"exchange": {}, "reuse": {}}
    for key, (shape, dims, width, mode, dtype) in spec["exchanges"].items():
        grid = init_global_grid(*shape, dims=dims)
        out["exchange"][key] = _exchanges(grid, shape, width, mode, dtypes[dtype],
                                          spec["steps"])
        if wire.is_stateful(mode):
            continue
        grid = init_global_grid(*shape, dims=dims)
        G = global_field(shape)
        u = torch.from_numpy(np.ascontiguousarray(G[grid.shard_slices()])).to(dtypes[dtype])
        buf = place_core(u, width)

        def pointers():
            return sorted(t.data_ptr() for slabs in grid.exchange_buffers.values()
                          for pair in slabs.values() for t in pair)

        exchange_into(buf, grid, width, wire_mode=mode)
        first = pointers()
        later, allocations = [], []
        for _ in range(spec["steps"]):
            _, calls = _count_allocations(
                lambda: exchange_into(buf, grid, width, wire_mode=mode))
            later.append(pointers())
            allocations.extend(calls)
        out["reuse"][key] = dict(first=first, later=later, allocations=allocations,
                                 keys=len(grid.exchange_buffers))
    return out


def seeded_state(model, seed=0):
    """This rank's shard of a seeded numpy state of `model` (diffusion:
    (T, Cp); the wave: (U, U⁻, C2); the SWE: (h, us), the velocities
    zero on the wall faces as the masks hold them), in the model's dtype
    on its device — what `init_state` returns."""
    cfg, grid = model.config, model.grid
    rng = np.random.default_rng(seed)
    shape = cfg.global_shape

    def shard(a):
        return torch.from_numpy(np.ascontiguousarray(a[grid.shard_slices()])).to(
            device=model.device, dtype=cfg.torch_dtype)

    name = type(model).__name__
    if name == "HeatDiffusion":
        return shard(rng.random(shape)), shard(1.0 + rng.random(shape))
    if name == "AcousticWave":
        U = rng.random(shape)
        return (shard(U), shard(U + 0.01 * rng.random(shape)),
                shard(cfg.c0 ** 2 * (0.5 + 0.5 * rng.random(shape))))
    h = shard(0.1 * rng.random(shape))
    us = tuple(shard(0.01 * rng.random(shape)) * m for m in model.face_masks())
    return h, us


def eager_deep(model, k, wire_mode, calls):
    """The deep schedule as an eager loop of sweeps, from `model.init_state()`:
    per call of `calls` (steps each) the schedule's prepare once and a
    zero wire state, then the sweeps one Python call after another, each
    taking the last one's cropped view. Returns the state's leaves."""
    from rocm_mpi_tpu_torch.parallel import deep_halo

    cfg, grid = model.config, model.grid
    name = type(model).__name__
    if name == "HeatDiffusion":
        sched = deep_halo.make_deep_sweep(grid, k, cfg.lam, model.dt, cfg.spacing,
                                          wire_mode=wire_mode)
        T, coeff = model.init_state()
        state = (T,)
    elif name == "AcousticWave":
        sched = deep_halo.make_wave_deep_sweep(grid, k, model.dt_value, cfg.spacing,
                                               wire_mode=wire_mode)
        U, Uprev, coeff = model.init_state()
        state = (U, Uprev)
    else:
        sched = deep_halo.make_swe_deep_sweep(grid, k, cfg.dt, cfg.spacing, cfg.H0, cfg.g,
                                              wire_mode=wire_mode)
        h, us = model.init_state()
        state = (h, *us)
    for n in calls:
        P = sched.prepare(state[0] if name == "ShallowWater" else coeff)
        ws = (sched.init_wire(state[0].dtype, state[0].device),) if sched.init_wire else ()
        for _ in range(n // k):
            if name == "HeatDiffusion":
                out = sched.sweep(state[0], P, *ws)
                state, ws = ((out[0],), out[1:]) if ws else ((out,), ())
            elif name == "AcousticWave":
                out = sched.sweep(*state, P, *ws)
                state, ws = tuple(out[:2]), tuple(out[2:])
            else:
                out = sched.sweep(state[0], state[1:], P, *ws)
                state, ws = (out[0], *out[1]), tuple(out[2:])
    return [t.contiguous() for t in state], sched


def run_deep_scan_rank(rank, spec):
    """run_deep of each (workload, wire mode) of spec on a 2×2 grid from
    the seeded state: the local and loop routes, the fields gathered to
    rank 0, and whether this rank's shards equal the eager sweep loop's
    of the same windows bit for bit."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    torch.set_num_threads(1)
    classes = {"diffusion": (HeatDiffusion, DiffusionConfig),
               "wave": (AcousticWave, WaveConfig), "swe": (ShallowWater, SWEConfig)}
    out = {}
    for workload, mode in spec["runs"]:
        model_cls, cfg_cls = classes[workload]
        model = model_cls(cfg_cls(**spec["cfg"], wire_mode=mode), device="cpu")
        model.init_state = lambda model=model: seeded_state(model, spec["seed"])
        res = model.run_deep(block_steps=spec["k"])
        fields = {"diffusion": lambda: (res.T,), "wave": lambda: (res.U,),
                  "swe": lambda: (res.h, *res.us)}[workload]()
        cfg = model.config
        want, _ = eager_deep(model, spec["k"], mode, (cfg.warmup, cfg.nt - cfg.warmup))
        eager = want[:1] if workload == "wave" else want
        out[(workload, mode)] = dict(
            route=res.route, loop_route=res.loop_route, k=res.k,
            bitwise_eager=all(torch.equal(a, b) for a, b in zip(fields, eager)),
            fields=[gather_to_host0(f, model.grid) for f in fields])
    return out
