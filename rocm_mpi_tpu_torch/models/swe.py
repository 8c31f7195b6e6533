"""The shallow-water model — counterpart of rocm_mpi_tpu/models/swe.py (the
per-step variants, the VMEM-resident loop and the deep-halo schedule).

Physics and scheme: ops/swe.py — forward-backward stepping of the
linearised shallow-water equations on a C-grid in a closed basin,

    h' = h − dt·H·∇⁻·u,    u_a' = M_a ∘ (u_a − dt·g·∂a⁺ h'),

with the wall faces masked to exactly 0.0. The state is ndim+1 coupled
fields (h and one face velocity per axis), every one exchanged. Two
invariants hold exactly: Σh is conserved (the divergence telescopes to
wall − wall) and the update has a closed-form inverse.

Variants, each on this rank's shard:

  "ap"    — the roll form (ops.swe.masked_swe_step): on one rank on the
            global field; on a shard on the halo-padded block with width-1
            padded face masks, keeping the core (a k = 1 deep sweep);
  "shard" — exchange of every leaf + the field-dtype padded step;
  "perf"  — exchange of every leaf + the swe_step kernel, on any grid;
  "hide"  — the swe_step region kernel on the overlap decomposition
            (parallel/overlap.py) with the whole state as a tuple of
            leaves: the interior box from the raw shard during the
            exchange, then the boundary slabs. One rank runs "perf".

the step and scan drivers (`run(driver=...)`; the scan driver runs JAX's
q-step chunks as CUDA graphs, models/scan.py), and two schedules:
run_vmem_resident (one rank, `chunk` steps per launch
of the swe_multi_step kernel) and run_deep (any grid, one width-k
exchange of the whole state per k steps,
parallel/deep_halo.make_swe_deep_sweep), each run through an exact sweep
loop of models/scan.py: CUDA graphs of sweeps on a CUDA rank, as JAX runs
them in one compiled program.

In place of JAX buffer donation the advance keeps two state tuples, the
state and a spare the step writes into, and rotates them each step; the
exchange reuses one padded buffer per leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from rocm_mpi_tpu_torch.config import SWEConfig
from rocm_mpi_tpu_torch.models.diffusion import effective_block_steps
from rocm_mpi_tpu_torch.models.scan import (
    ScanLoop,
    auto_scan_chunk,
    check_sweeps,
    graph_plan,
    loop_record,
    padded_slot,
    scan_chunk,
    scan_route,
    sweep_loop,
    window_sweeps,
)
from rocm_mpi_tpu_torch.ops import multistep, swe
from rocm_mpi_tpu_torch.ops.diffusion import gaussian_ic
from rocm_mpi_tpu_torch.parallel import deep_halo, distributed, wire
from rocm_mpi_tpu_torch.models import lanes as _lanes
from rocm_mpi_tpu_torch.parallel.halo import exchange_halo, exchange_halo_batched
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid, init_batched_grid, init_global_grid
from rocm_mpi_tpu_torch.parallel.overlap import make_overlap_step
from rocm_mpi_tpu_torch.utils import metrics
from rocm_mpi_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class SWERunResult:
    h: torch.Tensor  # this rank's shard of the final surface height
    us: tuple  # this rank's shards of the final face velocities
    wtime: float  # seconds over the timed steps
    nt: int
    warmup: int
    config: SWEConfig
    # The schedules' record of what ran: the local route ("vmem-loop"; for
    # run_deep "vmem" or "jnp"; for the scan driver "scan-graph",
    # "scan-eager" or "scan-loop") and the steps per launch, sweep or
    # chunk; the loop that ran them ("scan-graph", "scan-loop",
    # "scan-eager") and its captures' host ms. None for the step driver.
    route: str | None = None
    k: int | None = None
    loop_route: str | None = None
    capture_ms: float | None = None

    @property
    def wtime_it(self) -> float:
        return metrics.wtime_per_it(self.wtime, self.nt, self.warmup)

    @property
    def t_eff(self) -> float:
        """Aggregate T_eff over the global field [GB/s]: 2·(ndim+1) passes
        per step (read and write h and each u_a; the masks are coefficient
        traffic and not counted), as JAX's SWERunResult counts."""
        return metrics.t_eff_gbs(self.config.global_shape, self.h.element_size(),
                                 self.wtime_it, n_passes=2 * (len(self.us) + 1))

    @property
    def gpts(self) -> float:
        return metrics.gpts_per_s(self.config.global_shape, self.wtime_it)


class ShallowWater:
    """Forward-backward linear shallow water on this rank's shard of a
    global grid."""

    DEFAULT_DEEP_STEPS = 8
    VARIANTS = ("ap", "shard", "perf", "hide")

    def __init__(self, config: SWEConfig, grid: GlobalGrid | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if grid is None:
            grid = init_global_grid(*config.global_shape, lengths=config.lengths,
                                    dims=config.dims)
        if grid.global_shape != config.global_shape:
            raise ValueError(f"grid shape {grid.global_shape} != config {config.global_shape}")
        if grid.lengths != config.lengths:
            raise ValueError(f"grid lengths {grid.lengths} != config {config.lengths}")
        self.grid = grid
        self.coeffs = swe.swe_coeffs(config.dt, config.spacing, config.H0, config.g)

    # ---- state ----------------------------------------------------------

    def face_masks(self) -> tuple[torch.Tensor, ...]:
        """This rank's shard of each axis's face mask: exactly 0.0 on the
        global high wall face (index n_a − 1 along axis a), 1.0 elsewhere.
        The low wall is the zero-ghost convention of the exchange."""
        cfg, grid = self.config, self.grid
        return tuple(deep_halo.padded_face_mask(grid.local_shape, grid, a, 0, cfg.torch_dtype,
                                                device=self.device)
                     for a in range(cfg.ndim))

    def init_state(self):
        """(h, us): this rank's shard of a Gaussian surface bump at rest (every
        velocity zero, so the wall faces start at 0 and the masks keep
        them there)."""
        cfg, grid = self.config, self.grid
        dtype = cfg.torch_dtype
        h = gaussian_ic(grid.local_coord_mesh(dtype=dtype, device=self.device), cfg.lengths,
                        dtype=dtype)
        us = tuple(torch.zeros(grid.local_shape, dtype=dtype, device=self.device)
                   for _ in range(cfg.ndim))
        return h, us

    # ---- variants -------------------------------------------------------

    def _step(self, variant: str):
        """step(h, us, Mus, out=None, pads=None) -> (h', us') of `variant`:
        `out` is a state tuple (h, u0, …) the step may write into (never the
        input state), `pads` one padded buffer per leaf for the exchange;
        either may be None, and the step allocates."""
        cfg, grid = self.config, self.grid
        sp, wm, ndim = cfg.spacing, cfg.wire_mode, cfg.ndim
        cH, cg = self.coeffs
        core = tuple(slice(1, -1) for _ in range(ndim))

        def exchange(h, us, pads, wire_mode=wm):
            pads = pads if pads is not None else (None,) * (ndim + 1)
            return tuple(exchange_halo(t, grid, out=p, wire_mode=wire_mode)
                         for t, p in zip((h, *us), pads))

        def split(leaves):
            return leaves[0], tuple(leaves[1:])

        if variant == "ap":
            if grid.nprocs == 1:
                def step(h, us, Mus, out=None, pads=None):
                    return swe.masked_swe_step(h, us, Mus, cH, cg)

                return step
            padded_shape = tuple(n + 2 for n in grid.local_shape)
            Mp = tuple(deep_halo.padded_face_mask(padded_shape, grid, a, 1, cfg.torch_dtype,
                                                  device=self.device) for a in range(ndim))

            # The stand-in for JAX's GSPMD communication: full precision,
            # whatever the wire mode (as diffusion's ap).
            def step(h, us, Mus, out=None, pads=None):
                hp, *ups = exchange(h, us, pads, wire_mode="f32")
                h2, us2 = swe.masked_swe_step(hp, ups, Mp, cH, cg)
                return h2[core], tuple(u[core] for u in us2)

            return step
        if variant == "shard":
            def step(h, us, Mus, out=None, pads=None):
                return split(swe.swe_step_padded(exchange(h, us, pads), Mus, (cfg.H0, cfg.g),
                                                 cfg.dt, sp))

            return step
        if variant == "perf":
            def step(h, us, Mus, out=None, pads=None):
                return split(swe.swe_step(exchange(h, us, pads), Mus, (cfg.H0, cfg.g), cfg.dt,
                                          sp, out=out))

            return step
        if variant == "hide":
            if grid.nprocs == 1:
                # No neighbours, nothing to hide: the perf step, bitwise.
                return self._step("perf")

            def region_update(src, offset, box, Mus, out):
                swe.swe_step_region(src, offset, box, Mus, self.coeffs, out)

            local = make_overlap_step(grid, region_update, cfg.b_width, mask_boundary=False,
                                      wire_mode=wm, device=self.device)

            def step(h, us, Mus, out=None, pads=None):
                return split(local((h, *us), tuple(Mus), out=out, pad=pads))

            return step
        raise ValueError(f"unknown SWE variant {variant!r} ({', '.join(self.VARIANTS)})")

    # ---- drivers --------------------------------------------------------

    def advance_fn(self, variant: str = "perf"):
        """(h, us, Mus, n) -> (h, us) after n steps of `variant`.

        The loop keeps two state tuples — the state and a spare the step
        writes into — and rotates them, and exchanges into one reused
        padded buffer per leaf, so steady-state stepping of `perf` and
        `hide` allocates no field. The passed-in state becomes a buffer of
        the loop: like donated JAX arguments, the caller must not use it
        afterwards."""
        step = self._step(variant)
        padded_shape = tuple(n + 2 for n in self.grid.local_shape)

        def advance(h, us, Mus, n):
            us = tuple(us)
            pads = tuple(torch.zeros(padded_shape, dtype=h.dtype, device=h.device)
                         for _ in range(len(us) + 1))
            spare = tuple(torch.empty_like(h) for _ in range(len(us) + 1))
            for _ in range(int(n)):
                h2, us2 = step(h, us, Mus, out=spare, pads=pads)
                h, us, spare = h2, us2, (h, *us)
            return h, us

        return advance

    # ---- multi-tenant batching (docs/SERVING.md) ------------------------

    def make_batched_grid(self, batch: int, batch_dims: int = 1, nprocs: int | None = None,
                          rank: int | None = None):
        """Space×batch grid for `batch` lanes of this model's problem (see
        HeatDiffusion.make_batched_grid)."""
        cfg = self.config
        return init_batched_grid(batch, *cfg.global_shape, lengths=cfg.lengths,
                                 space_dims=self.grid.dims, batch_dims=batch_dims,
                                 nprocs=nprocs, rank=rank)

    def batched_advance_fn(self, batch: int | None = None, variant: str = "shard", bgrid=None,
                           batch_dims: int = 1):
        """(advance(hb, usb, Mus, lane_steps, n) -> (hb, usb), bgrid) — the
        SWE edition of the batched advance (HeatDiffusion's has the
        contract; every state field freezes together at a lane's count).
        The face masks `Mus` are space-shaped, shared by every lane.
        "shard" exchanges every field of every lane once a step
        (exchange_halo_batched per field) and steps the whole block; "ap"
        runs the roll-form step lane by lane on one rank."""
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        cfg = self.config
        cH, cg = self.coeffs
        ndim = bgrid.space.ndim
        if variant == "shard":
            pads: dict = {}

            def step(leaves, Mus):
                Sp = []
                for i, t in enumerate(leaves):
                    key = (i, tuple(t.shape), t.dtype, t.device)
                    Sp.append(exchange_halo_batched(t, bgrid, wire_mode=cfg.wire_mode,
                                                    out=pads.get(key)))
                    pads[key] = Sp[-1]
                return swe.swe_step_padded(tuple(Sp), Mus, (cfg.H0, cfg.g), cfg.dt,
                                           cfg.spacing)
        elif variant == "ap":
            if bgrid.space.nprocs != 1:
                raise ValueError("the batched SWE 'ap' advance runs on one-rank space grids; "
                                 "use 'shard'")

            def step(leaves, Mus):
                outs = [swe.masked_swe_step(leaves[0][j], tuple(u[j] for u in leaves[1:]),
                                            Mus, cH, cg) for j in range(leaves[0].shape[0])]
                return (torch.stack([h for h, _ in outs]),) + tuple(
                    torch.stack([us[a] for _, us in outs]) for a in range(ndim))
        else:
            raise ValueError(f"batched SWE advance supports variants 'shard', 'ap'; got "
                             f"{variant!r} (the Pallas/overlap rungs are single-lane)")

        def advance(hb, usb, Mus, lane_steps, n):
            leaves = (hb, *usb)
            for active in _lanes.schedule(lane_steps, n, ndim, hb.device):
                new = step(leaves, Mus)
                if active is not None:
                    new = tuple(torch.where(active.mask, a, b) for a, b in zip(new, leaves))
                leaves = new
            return leaves[0], tuple(leaves[1:])

        return advance, bgrid

    def _run_timed(self, advance, nt, warmup, **span_attrs) -> SWERunResult:
        """Run `advance(h, us, Mus, n) -> (h, us)` from the initial state
        through metrics.timed_window, `span_attrs` stamping its
        step_window span (variant, driver)."""
        nt, warmup = metrics.resolve_windows(self.config, nt, warmup)
        h, us = self.init_state()
        Mus = self.face_masks()
        (h, us), wtime = metrics.timed_window(lambda s, n: advance(*s, Mus, n), (h, us),
                                              nt, warmup, sharded=self.grid.nprocs > 1,
                                              group=self.grid.group, workload="swe",
                                              **span_attrs)
        return SWERunResult(h=h, us=tuple(us), wtime=wtime, nt=nt, warmup=warmup,
                            config=self.config)

    def scan_advance_fn(self, variant: str = "perf", nt: int | None = None,
                        warmup: int | None = None, chunk: int | None = None,
                        config: str | None = None, exact: bool = False):
        """(advance(h, us, Mus, n) -> (h, us), q): the scan driver, SWE
        edition (see HeatDiffusion.scan_advance_fn). The whole state tuple
        and a spare tuple rotate with period 2; the masks are bound per
        call, read-only. `n` runs n // q chunks (all n steps with
        `exact=True`); the caller must rebind the state from the result."""
        cfg = self.config
        step = self._step(variant)
        tuned = None if chunk is not None else auto_scan_chunk(
            "swe.scan", self.grid, cfg.torch_dtype, config, self.device)
        q = scan_chunk(cfg.nt if nt is None else nt, cfg.warmup if warmup is None else warmup,
                       chunk, "SWE scan driver chunk", tuned)
        pads = tuple(torch.zeros(tuple(n + 2 for n in self.grid.local_shape),
                                 dtype=cfg.torch_dtype, device=self.device)
                     for _ in range(cfg.ndim + 1))

        def one_step(src, out, consts):
            ((h, *us),), (Mus,) = src, consts
            h2, us2 = step(h, tuple(us), Mus, out=out, pads=pads)
            return (h2, *us2)

        route = scan_route(self.device, self.grid.nprocs, distributed.backend())
        loop = ScanLoop(one_step, graph_plan(q, 2), route, exact=exact)

        def advance(h, us, Mus, n):
            ((h, *us),) = loop(((h, *us),), (tuple(Mus),), n)
            return h, tuple(us)

        advance.loop = loop
        return advance, q

    def run(self, variant: str = "perf", nt: int | None = None, warmup: int | None = None,
            driver: str = "step", config: str | None = None) -> SWERunResult:
        """Run `nt` steps of `variant` from the initial condition, timing all
        but the first `warmup`. `driver="scan"` runs scan_advance_fn's
        chunks, bitwise equal to "step", with `route`/`k` the scan route and
        q; `config` reaches the scan driver only."""
        if driver not in ("step", "scan"):
            raise ValueError(f"driver must be 'step' or 'scan', got {driver!r}")
        if driver == "step":
            return self._run_timed(self.advance_fn(variant), nt, warmup,
                                   variant=variant, driver=driver)
        nt, warmup = metrics.resolve_windows(self.config, nt, warmup)
        advance, q = self.scan_advance_fn(variant, nt=nt, warmup=warmup, config=config)
        res = self._run_timed(advance, nt, warmup, variant=variant, driver=driver)
        res.route, res.k = advance.loop.route, q
        vars(res).update(loop_record(advance.loop))
        return res

    # ---- schedules ------------------------------------------------------

    def run_vmem_resident(self, nt: int | None = None, warmup: int | None = None,
                          chunk: int | None = None, config: str | None = None) -> SWERunResult:
        """One-rank loop of `chunk` steps per launch of the swe_multi_step
        kernel (ops.swe.swe_sweeps, the launches of swe_multi_step through
        a sweep loop: CUDA graphs of launches on a CUDA device); the state
        must pass the JAX admission. `chunk` defaults to
        DEFAULT_STEP_CHUNK, gcd'd against both windows (a warning when an
        explicit chunk degrades); `config="auto"` fills an unset chunk
        from the tuning cache (op "swe.vmem_loop", where
        adoptable_vmem_chunk allows; gcd'd without a warning; a miss
        keeps the default)."""
        if self.grid.nprocs != 1:
            raise ValueError("the VMEM-resident path requires an unsharded grid")
        cfg = self.config
        explicit = chunk is not None
        if multistep.auto_config(config) and chunk is None:
            chunk = multistep.tuned_knobs("swe.vmem_loop", cfg.global_shape, cfg.torch_dtype,
                                          self.device).get("chunk")
        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        chunk = effective_block_steps(
            nt, warmup, multistep.DEFAULT_STEP_CHUNK if chunk is None else chunk,
            warn=explicit, label="SWE VMEM chunk")
        h0, _ = self.init_state()
        parts = swe.swe_sweeps(h0, cfg.dt, cfg.spacing, cfg.H0, cfg.g, 0, chunk=chunk,
                               warn_on_cap=False)

        def one_sweep(src, out, consts):
            ((h, *us),), (Mus,) = src, consts
            h2, us2 = parts.sweep(h, tuple(us), Mus, out=out)
            return (h2, *us2)

        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, parts.k), self.device, 1,
                          label=f"vmem-loop launch of {parts.k} steps")

        def advance(h, us, Mus, n):
            ((h, *us),) = loop(((h, *us),), (tuple(Mus),), check_sweeps(n, parts.k))
            return h, tuple(us)

        res = self._run_timed(advance, nt, warmup, variant="vmem")
        res.route, res.k = "vmem-loop", parts.k
        vars(res).update(loop_record(loop))
        return res

    def effective_deep_depth(self, nt: int | None = None, warmup: int | None = None,
                             block_steps: int | None = None, warn: bool = True) -> int:
        """The sweep depth run_deep executes for these arguments: the
        default (DEFAULT_DEEP_STEPS) clamps to the smallest shard extent; a
        depth is gcd'd against both windows, and an explicit one that still
        exceeds the shard raises."""
        cfg = self.config
        explicit = block_steps is not None
        if block_steps is None:
            block_steps = min(self.DEFAULT_DEEP_STEPS, min(self.grid.local_shape))
        eff = effective_block_steps(
            cfg.nt if nt is None else nt, cfg.warmup if warmup is None else warmup,
            block_steps, label="SWE deep-halo sweep depth", warn=warn, stacklevel=3)
        if explicit and eff > min(self.grid.local_shape):
            raise ValueError(
                f"SWE deep-halo sweep depth {eff} exceeds a local shard extent "
                f"{self.grid.local_shape}; ghost slices need width <= shard"
            )
        return eff

    def deep_advance_fn(self, block_steps: int | None = None, nt: int | None = None,
                        warmup: int | None = None, wire_mode: str | None = None):
        """(advance(h, us, Mus, n_steps) -> (h, us), executed depth k) of the
        deep schedule: the padded face masks are built once per call (`Mus`
        is accepted and ignored, so the signature matches advance_fn's),
        then n_steps/k sweeps (DeepSchedule.step) run through a sweep loop
        (models/scan.py: CUDA graphs of sweeps, the exchanges included, on
        a CUDA rank);
        `n_steps` must be a multiple of k. `advance.schedule` is the
        DeepSchedule (its `route` says which local route the sweeps took),
        `advance.loop` the loop. Each call places the state into the
        loop's k-padded blocks and returns their cores. A stateful wire
        mode starts each call from a zero wire state, as in the JAX
        package."""
        cfg = self.config
        k = self.effective_deep_depth(nt, warmup, block_steps)
        wm = cfg.wire_mode if wire_mode is None else wire.validate_mode(wire_mode)
        sched = deep_halo.make_swe_deep_sweep(self.grid, k, cfg.dt, cfg.spacing, cfg.H0, cfg.g,
                                              wire_mode=wm)
        lead = cfg.ndim + 1

        def one_sweep(src, out, consts):
            (slot,), (Mp,) = src, consts
            hp, ups, ws = slot[0], tuple(slot[1:lead]), tuple(slot[lead:])
            if sched.init_wire is None:
                h2, us2 = sched.step(hp, ups, Mp, out)
                return (h2, *us2)
            h2, us2, ws2 = sched.step(hp, ups, Mp, out[:lead], ws)
            return (h2, *us2, *ws2)

        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, k), self.device,
                          self.grid.nprocs, label=f"SWE deep sweep of {k} steps on local "
                          f"route {sched.route_of(cfg.torch_dtype)}")
        core = tuple(slice(k, -k) for _ in self.grid.local_shape)

        def advance(h, us, Mus, n_steps):
            del Mus
            sweeps = check_sweeps(n_steps, k)
            us = tuple(us)
            if sweeps == 0:
                return h, us
            Mp = sched.prepare(h)
            (slot,) = loop((padded_slot(loop, (h, *us), k, sched.init_wire),), (Mp,), sweeps)
            return slot[0][core].contiguous(), tuple(u[core].contiguous()
                                                     for u in slot[1:lead])

        advance.schedule = sched
        advance.loop = loop
        return advance, k

    def run_deep(self, nt: int | None = None, warmup: int | None = None,
                 block_steps: int | None = None, wire_mode: str | None = None) -> SWERunResult:
        """Deep-halo sweeps on any process grid: one width-k exchange of the
        whole coupled state per k steps (parallel.deep_halo.make_swe_deep_sweep)."""
        advance, k = self.deep_advance_fn(block_steps, nt, warmup, wire_mode=wire_mode)
        res = self._run_timed(advance, nt, warmup, variant="deep")
        res.route, res.k = advance.schedule.route, k
        vars(res).update(loop_record(advance.loop))
        return res
