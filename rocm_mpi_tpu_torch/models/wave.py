"""The acoustic-wave model — counterpart of rocm_mpi_tpu/models/wave.py (the
per-step variants, the VMEM-resident loop and the deep-halo schedule).

Physics: u_tt = c²∇²u with Dirichlet edges held at their initial values,
leapfrog time stepping over the state pair (U, U⁻):

    U⁺ = 2U − U⁻ + dt²·c²·∇²U

which is second-order accurate and exactly time-reversible: swapping the
pair runs the trajectory backward.

Variants, each on this rank's shard:

  "ap"    — the global-array step (ops.wave.wave_step_fused) on the
            halo-padded shard, keeping its core;
  "shard" — exchange_halo + the field-dtype padded step + Dirichlet select;
  "perf"  — exchange_halo + the wave_step kernel + Dirichlet select, on any
            process grid;
  "hide"  — the masked leapfrog (M, Cw prepared once per advance) on the
            overlap decomposition (parallel/overlap.py): the interior box
            on one CUDA stream while the exchange and then the boundary
            slabs run on another, each box one wave_step_masked region
            launch. One rank has nothing to hide and runs "perf".

the step and scan drivers (`run(driver=...)`; the scan driver runs JAX's
q-step chunks as CUDA graphs, models/scan.py), and two schedules:
run_vmem_resident (one rank, `chunk` steps per launch
of the wave_multi_step kernel) and run_deep (any grid, one width-k
exchange of the pair per k steps, parallel/deep_halo.make_wave_deep_sweep),
each run through an exact sweep loop of models/scan.py: CUDA graphs of
sweeps on a CUDA rank, as JAX runs them in one compiled program.

In place of JAX buffer donation the advance keeps three field buffers,
the pair and a spare the step writes into, and rotates them each step;
the exchange reuses one padded buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rocm_mpi_tpu_torch.config import WaveConfig
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
from rocm_mpi_tpu_torch.ops import multistep, wave
from rocm_mpi_tpu_torch.ops.diffusion import gaussian_ic
from rocm_mpi_tpu_torch.parallel import deep_halo, distributed, wire
from rocm_mpi_tpu_torch.models import lanes as _lanes
from rocm_mpi_tpu_torch.parallel.halo import (
    exchange_halo,
    exchange_halo_batched,
    global_boundary_mask,
    place_core,
)
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid, init_batched_grid, init_global_grid
from rocm_mpi_tpu_torch.parallel.overlap import make_overlap_step
from rocm_mpi_tpu_torch.utils import metrics
from rocm_mpi_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class WaveRunResult:
    U: torch.Tensor  # this rank's shard of the final displacement
    wtime: float  # seconds over the timed steps
    nt: int
    warmup: int
    config: WaveConfig
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
        """Aggregate T_eff over the global field [GB/s]: 4 passes per step
        (read U, U⁻ and C2; write U⁺)."""
        return metrics.t_eff_gbs(self.config.global_shape, self.U.element_size(),
                                 self.wtime_it, n_passes=4)

    @property
    def gpts(self) -> float:
        return metrics.gpts_per_s(self.config.global_shape, self.wtime_it)


# A step is step(U, Uprev, C2, P, out, pad) -> U⁺, with P what the
# variant's prepare(C2) built once per advance (None if it prepares
# nothing), `out` a field buffer for U⁺ (never U or Uprev) and `pad` the
# exchange's padded buffer; either may be None, and the step allocates.
Step = Callable[..., torch.Tensor]


class AcousticWave:
    """Leapfrog acoustic wave on this rank's shard of a global grid."""

    DEFAULT_DEEP_STEPS = 8
    VARIANTS = ("ap", "shard", "perf", "hide")

    def __init__(self, config: WaveConfig, grid: GlobalGrid | None = None, device=None):
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
        # The time step in the field dtype, as JAX rounds it
        # (cfg.jax_dtype(cfg.dt)), and the same value as a Python double:
        # the kernels take dt² as the double product of it.
        self.dt = torch.tensor(config.dt, dtype=config.torch_dtype, device=self.device)
        self.dt_value = float(self.dt)
        self._mask = global_boundary_mask(grid, device=self.device)

    # ---- state ----------------------------------------------------------

    def init_state(self):
        """(U, U⁻, C2): this rank's shard of the Gaussian displacement at
        rest (U⁻ = U) and of the uniform squared wave speed c0²."""
        cfg, grid = self.config, self.grid
        dtype = cfg.torch_dtype
        U = gaussian_ic(grid.local_coord_mesh(dtype=dtype, device=self.device), cfg.lengths,
                        dtype=dtype)
        C2 = torch.full(grid.local_shape, cfg.c0 * cfg.c0, dtype=dtype, device=self.device)
        return U, U.clone(), C2

    def _mask_prepare(self):
        """prepare(C2) -> (M, Cw): the interior mask (1.0 on updating cells,
        exactly 0.0 on the global Dirichlet edge) and Cw = dt²·C2·M, with
        dt² the field-dtype product, as JAX's `_mask_prepare` forms it."""
        dt2 = self.dt * self.dt

        def prepare(C2):
            M = torch.where(self._mask, torch.zeros_like(C2), torch.ones_like(C2))
            return M, (dt2 * C2) * M

        return prepare

    # ---- variants -------------------------------------------------------

    def _step(self, variant: str):
        """(step, prepare) of `variant`; prepare is None when the variant
        prepares nothing."""
        cfg, grid = self.config, self.grid
        sp, wm = cfg.spacing, cfg.wire_mode
        core = tuple(slice(1, -1) for _ in range(grid.ndim))

        if variant == "ap":
            # The stand-in for JAX's GSPMD communication: full precision,
            # whatever the wire mode (as diffusion's ap). The padded U⁻ is
            # made and dropped within the step, so a captured step's graph
            # pool reuses its memory and no replay reads a freed buffer.
            def step(U, Uprev, C2, C2p, out=None, pad=None):
                Up = exchange_halo(U, grid, out=pad)
                new = wave.wave_step_fused(Up, place_core(Uprev), C2p, self.dt, sp)[core]
                return torch.where(self._mask, U, new, out=out)

            return step, place_core
        if variant == "shard":
            def step(U, Uprev, C2, P, out=None, pad=None):
                Up = exchange_halo(U, grid, out=pad, wire_mode=wm)
                new = wave.wave_step_padded(Up, Uprev, C2, self.dt, sp)
                return torch.where(self._mask, U, new, out=out)

            return step, None
        if variant == "perf":
            def step(U, Uprev, C2, P, out=None, pad=None):
                Up = exchange_halo(U, grid, out=pad, wire_mode=wm)
                new = wave.wave_step(Up, Uprev, C2, self.dt_value, sp, out=out)
                return torch.where(self._mask, U, new, out=new)

            return step, None
        if variant == "hide":
            if grid.nprocs == 1:
                # No neighbours, nothing to hide: the perf step, bitwise.
                return self._step("perf")

            def region_update(src, offset, box, aux, out):
                Uprev, M, Cw = aux
                wave.wave_step_masked_region(src, offset, Uprev, M, Cw, sp, box, out)

            local = make_overlap_step(grid, region_update, cfg.b_width, mask_boundary=False,
                                      wire_mode=wm, device=self.device)

            def step(U, Uprev, C2, P, out=None, pad=None):
                M, Cw = P
                return local(U, (Uprev, M, Cw), out=out, pad=pad)

            return step, self._mask_prepare()
        raise ValueError(f"unknown wave variant {variant!r} ({', '.join(self.VARIANTS)})")

    # ---- drivers --------------------------------------------------------

    def prepare_fn(self, variant: str):
        """C2 -> what `variant`'s steps receive besides the state (None when
        the variant prepares nothing)."""
        _, prep = self._step(variant)
        return prep if prep is not None else (lambda C2: None)

    def advance_fn(self, variant: str = "perf"):
        """(U, U⁻, C2, n) -> (U after n steps, U after n − 1).

        The variant's loop-invariant operands are prepared once per call.
        The loop keeps three field buffers — the pair and a spare the step
        writes U⁺ into — and rotates them, and exchanges into one reused
        padded buffer, so steady-state stepping allocates no field. The
        passed-in U and U⁻ become buffers of the loop: like donated JAX
        arguments, the caller must not use them afterwards."""
        step, _ = self._step(variant)
        prep = self.prepare_fn(variant)
        padded_shape = tuple(n + 2 for n in self.grid.local_shape)

        def advance(U, Uprev, C2, n):
            P = prep(C2)
            pad = torch.zeros(padded_shape, dtype=U.dtype, device=U.device)
            spare = torch.empty_like(U)
            for _ in range(int(n)):
                U, Uprev, spare = step(U, Uprev, C2, P, out=spare, pad=pad), U, Uprev
            return U, Uprev

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

    def _batched_pair(self, bgrid, lane_step):
        """advance(Ub, Upb, C2, lane_steps, n, wire_mode, extra) -> (Ub,
        Upb) over a rank's lane block: each step exchanges every lane
        once, `lane_step(Tp, Ub, Upb, C2, hold, out, active, extra)` writes
        U⁺ (held cells and frozen lanes keep U), and the pair rotates as
        advance_fn's does; a lane past its count keeps both carries."""
        mask = global_boundary_mask(bgrid.space, device=self.device)
        slots = _lanes.LaneSlots()
        pads: dict = {}
        ndim = bgrid.space.ndim

        def advance(Ub, Upb, C2, lane_steps, n, wire_mode=self.config.wire_mode, extra=None):
            spare = slots.spare(Ub, avoid=(Ub, Upb))
            key = (tuple(Ub.shape), Ub.dtype, Ub.device)
            for active in _lanes.schedule(lane_steps, n, ndim, Ub.device):
                Tp = pads[key] = exchange_halo_batched(Ub, bgrid, wire_mode=wire_mode,
                                                       out=pads.get(key))
                lane_step(Tp, Ub, Upb, C2, _lanes.hold_mask(mask, active), spare, active, extra)
                if active is None:
                    Ub, Upb, spare = spare, Ub, Upb
                else:
                    torch.where(active.mask, Ub, Upb, out=Upb)
                    Ub, spare = spare, Ub
            return Ub, Upb

        advance.slots = slots
        return advance

    def batched_advance_fn(self, batch: int | None = None, variant: str = "shard", bgrid=None,
                           batch_dims: int = 1):
        """(advance(Ub, Upb, C2, lane_steps, n) -> (Ub, Upb), bgrid) — the
        wave edition of the batched advance (HeatDiffusion's has the
        contract; both leapfrog carries freeze together at a lane's count).
        "shard" steps the whole lane block at once after one exchange of
        every lane; "ap" runs the global-array step lane by lane."""
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        cfg = self.config
        if variant == "shard":
            def lane_step(Tp, Ub, Upb, C2, hold, out, active, extra):
                new = wave.wave_step_padded(Tp, Upb, C2, self.dt, cfg.spacing)
                torch.where(hold, Ub, new, out=out)

            adv = self._batched_pair(bgrid, lane_step)
            return adv, bgrid
        if variant == "ap":
            core = tuple(slice(1, -1) for _ in range(bgrid.space.ndim))

            def lane_step(Tp, Ub, Upb, C2p, hold, out, active, extra):
                live = range(Ub.shape[0]) if active is None else active.lanes
                for j in range(Ub.shape[0]):
                    if j not in live:
                        out[j].copy_(Ub[j])
                        continue
                    new = wave.wave_step_fused(Tp[j], place_core(Upb[j]), C2p, self.dt,
                                               cfg.spacing)[core]
                    torch.where(hold if hold.ndim == len(core) else hold[j], Ub[j], new,
                                out=out[j])

            inner = self._batched_pair(bgrid, lane_step)

            def adv(Ub, Upb, C2, lane_steps, n):
                return inner(Ub, Upb, place_core(C2), lane_steps, n, wire_mode="f32")

            adv.slots = inner.slots
            return adv, bgrid
        raise ValueError(f"batched wave advance supports variants 'shard', 'ap'; got "
                         f"{variant!r} (the Pallas/overlap rungs are single-lane)")

    def ladder_step(self, spacing, dt):
        """The shard step's arithmetic at a lane's own geometry (`dt` a
        0-dim tensor in the field dtype): `(Tp, Uprev, C2, hold, U, out)`
        writes U⁺ into `out`, held cells keeping U."""
        def step(Tp, Uprev, C2, hold, U, out):
            return torch.where(hold, U, wave.wave_step_padded(Tp, Uprev, C2, dt, spacing),
                               out=out)

        return step

    def batched_ladder_advance_fn(self, batch: int | None = None, bgrid=None,
                                  batch_dims: int = 1):
        """(advance(Ub, Upb, C2, hold, geom, lane_steps, n) -> (Ub, Upb),
        bgrid) — the wave edition of the ladder advance
        (HeatDiffusion.batched_ladder_advance_fn): per-lane `hold` masks
        and `geom[j] = (dt, spacing)` of lane j's original config; lane j
        steps its own view with its own scalars."""
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        def lane_step(Tp, Ub, Upb, C2, held, out, active, extra):
            hold, steps = extra
            live = range(Ub.shape[0]) if active is None else active.lanes
            for j, st in enumerate(steps):
                if j in live:
                    st(Tp[j], Upb[j], C2, hold[j], Ub[j], out[j])
                else:
                    out[j].copy_(Ub[j])

        inner = self._batched_pair(bgrid, lane_step)

        def advance(Ub, Upb, C2, hold, geom, lane_steps, n):
            steps = [self.ladder_step(sp, dt) for dt, sp in geom]
            return inner(Ub, Upb, C2, lane_steps, n, wire_mode="f32", extra=(hold, steps))

        advance.slots = inner.slots
        return advance, bgrid

    def _run_timed(self, advance, nt, warmup, **span_attrs) -> WaveRunResult:
        """Run `advance(U, U⁻, C2, n) -> (U, U⁻)` from the initial state
        through metrics.timed_window, `span_attrs` stamping its
        step_window span (variant, driver)."""
        nt, warmup = metrics.resolve_windows(self.config, nt, warmup)
        U, Uprev, C2 = self.init_state()
        (U, _), wtime = metrics.timed_window(lambda s, n: advance(*s, C2, n), (U, Uprev),
                                             nt, warmup, sharded=self.grid.nprocs > 1,
                                             group=self.grid.group, workload="wave",
                                             **span_attrs)
        return WaveRunResult(U=U, wtime=wtime, nt=nt, warmup=warmup, config=self.config)

    def scan_advance_fn(self, variant: str = "perf", nt: int | None = None,
                        warmup: int | None = None, chunk: int | None = None,
                        config: str | None = None, exact: bool = False):
        """(advance(U, U⁻, C2, n) -> (U, U⁻), q): the scan driver, wave
        edition (see HeatDiffusion.scan_advance_fn). The pair and a spare
        rotate with period 3, so a graph of c steps with c not a multiple
        of 3 comes in three phases (models/scan.py). `n` runs n // q
        chunks (all n steps with `exact=True`); the caller must rebind U
        and U⁻ from the result."""
        cfg = self.config
        step, _ = self._step(variant)
        prep = self.prepare_fn(variant)
        tuned = None if chunk is not None else auto_scan_chunk(
            "wave.scan", self.grid, cfg.torch_dtype, config, self.device)
        q = scan_chunk(cfg.nt if nt is None else nt, cfg.warmup if warmup is None else warmup,
                       chunk, "wave scan driver chunk", tuned)
        pad = torch.zeros(tuple(n + 2 for n in self.grid.local_shape), dtype=cfg.torch_dtype,
                          device=self.device)

        def one_step(src, out, consts):
            (U, Uprev), (C2, P) = src, consts
            return step(U, Uprev, C2, P, out=out, pad=pad)

        route = scan_route(self.device, self.grid.nprocs, distributed.backend())
        loop = ScanLoop(one_step, graph_plan(q, 3), route, exact=exact)

        def advance(U, Uprev, C2, n):
            return loop((U, Uprev), (C2, prep(C2)), n)

        advance.loop = loop
        return advance, q

    def run(self, variant: str = "perf", nt: int | None = None, warmup: int | None = None,
            driver: str = "step", config: str | None = None) -> WaveRunResult:
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
                          chunk: int | None = None, config: str | None = None) -> WaveRunResult:
        """One-rank loop of `chunk` steps per launch of the wave_multi_step
        kernel (ops.wave.wave_sweeps, the launches of wave_multi_step
        through a sweep loop: CUDA graphs of launches on a CUDA device, M
        and Cw formed once per call); the field must fit half the VMEM
        budget the JAX package routes by. `chunk` defaults to
        DEFAULT_STEP_CHUNK, gcd'd against both windows (a warning when an
        explicit chunk degrades); `config="auto"` fills an unset chunk
        from the tuning cache (op "wave.vmem_loop", where
        adoptable_vmem_chunk allows; gcd'd without a warning; a miss
        keeps the default)."""
        if self.grid.nprocs != 1:
            raise ValueError("the VMEM-resident path requires an unsharded grid")
        cfg = self.config
        explicit = chunk is not None
        if multistep.auto_config(config) and chunk is None:
            chunk = multistep.tuned_knobs("wave.vmem_loop", cfg.global_shape, cfg.torch_dtype,
                                          self.device).get("chunk")
        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        chunk = effective_block_steps(
            nt, warmup, multistep.DEFAULT_STEP_CHUNK if chunk is None else chunk,
            warn=explicit, label="wave VMEM chunk")
        U0, _, _ = self.init_state()
        parts = wave.wave_sweeps(U0, self.dt_value, cfg.spacing, 0, chunk=chunk,
                                 warn_on_cap=False)

        def one_sweep(src, out, consts):
            ((U, Uprev),), ((M, Cw),) = src, consts
            return parts.sweep(U, Uprev, M, Cw, out=out)

        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, parts.k), self.device, 1,
                          label=f"vmem-loop launch of {parts.k} steps")

        def advance(U, Uprev, C2, n):
            ((U, Uprev),) = loop(((U, Uprev),), (parts.prepare(U, C2),),
                                 check_sweeps(n, parts.k))
            return U, Uprev

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
            block_steps, label="wave deep-halo sweep depth", warn=warn, stacklevel=3)
        if explicit and eff > min(self.grid.local_shape):
            raise ValueError(
                f"wave deep-halo sweep depth {eff} exceeds a local shard extent "
                f"{self.grid.local_shape}; ghost slices need width <= shard"
            )
        return eff

    def deep_advance_fn(self, block_steps: int | None = None, nt: int | None = None,
                        warmup: int | None = None, wire_mode: str | None = None):
        """(advance(U, U⁻, C2, n_steps) -> (U, U⁻), executed depth k) of the
        deep schedule: c² is exchanged and masked once per call and the
        pair placed into the loop's k-padded blocks, then n_steps/k sweeps
        (DeepSchedule.step) run through a sweep loop (models/scan.py: CUDA
        graphs of sweeps, the exchanges included, on a CUDA rank), and the
        call returns the cores; `n_steps` must be a multiple of k.
        `advance.schedule` is the DeepSchedule (its `route` says which
        local route the sweeps took), `advance.loop` the loop. A stateful
        wire mode starts each call from a zero wire state, as in the JAX
        package."""
        cfg = self.config
        k = self.effective_deep_depth(nt, warmup, block_steps)
        wm = cfg.wire_mode if wire_mode is None else wire.validate_mode(wire_mode)
        sched = deep_halo.make_wave_deep_sweep(self.grid, k, self.dt_value, cfg.spacing,
                                               wire_mode=wm)

        def one_sweep(src, out, consts):
            ((Up, Upp, *ws),), (P,) = src, consts
            if sched.init_wire is None:
                return sched.step(Up, Upp, P, out)
            U2, Up2, ws2 = sched.step(Up, Upp, P, out[:2], tuple(ws))
            return (U2, Up2, *ws2)

        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, k), self.device,
                          self.grid.nprocs, label=f"wave deep sweep of {k} steps on local "
                          f"route {sched.route_of(cfg.torch_dtype)}")
        core = tuple(slice(k, -k) for _ in self.grid.local_shape)

        def advance(U, Uprev, C2, n_steps):
            sweeps = check_sweeps(n_steps, k)
            if sweeps == 0:
                return U, Uprev
            P = sched.prepare(C2)
            ((Up, Upp, *_),) = loop((padded_slot(loop, (U, Uprev), k, sched.init_wire),),
                                    (P,), sweeps)
            return Up[core].contiguous(), Upp[core].contiguous()

        advance.schedule = sched
        advance.loop = loop
        return advance, k

    def run_deep(self, nt: int | None = None, warmup: int | None = None,
                 block_steps: int | None = None, wire_mode: str | None = None) -> WaveRunResult:
        """Deep-halo sweeps on any process grid: one width-k exchange of the
        leapfrog pair per k steps (parallel.deep_halo.make_wave_deep_sweep)."""
        advance, k = self.deep_advance_fn(block_steps, nt, warmup, wire_mode=wire_mode)
        res = self._run_timed(advance, nt, warmup, variant="deep")
        res.route, res.k = advance.schedule.route, k
        vars(res).update(loop_record(advance.loop))
        return res
