"""The transient heat-diffusion model — counterpart of
rocm_mpi_tpu/models/diffusion.py (the ported subset).

One physics model at several performance levels, chosen by variant:

  "ap"    — flux-form array-programming step (ops.diffusion.step_flux_form)
  "fused" — the single fused stencil (ops.diffusion.step_fused)
  "shard" — explicit halo exchange + step_fused_padded + Dirichlet select
  "perf"  — the Cm contract: the Dirichlet mask and the (dt·λ)/Cp divide
            are folded into a coefficient prepared once per advance, so a
            step is ONE hand kernel — masked_step on one rank; when
            sharded, the face exchange (halo.exchange_faces: the 2·ndim
            faces in one batch) + one fused_step_cm launch that reads
            the shard and the received faces in place.
  "kp"    — 2D only: the kernel-programming rung, the shard step's
            exchange and Dirichlet select around THREE hand kernels on
            the staggered grid (ops.kp.kp_step_padded: flux, residual,
            update), every step exchanging, on one rank too.
  "hide"  — the Cm contract on the overlap decomposition
            (parallel/overlap.py): the interior box on one CUDA stream
            while the exchange and then the boundary slabs run on
            another, every box one fused_step_cm launch from the shard
            (and the slabs from the received faces), in every dtype. One
            rank has nothing to hide and runs "perf".

two drivers of the per-step variants, chosen by `run(driver=...)`:

  "step" — advance_fn, one Python step call after another;
  "scan" — scan_advance_fn, JAX's q-step chunks as CUDA graphs
           (models/scan.py), bitwise equal to "step";

the batched advances of the serving layer (docs/SERVING.md): `batch`
lanes of one problem, each its own simulation, stepped together on a
BatchedGrid (`batched_advance_fn` for "shard", "hide", "ap" and "fused",
`batched_ladder_advance_fn`, `batched_deep_advance_fn`), every lane
bitwise equal to the standalone run of its own length;

and three multi-step schedules beside the per-step variants:

  run_vmem_resident — one rank: `chunk` steps per launch of the
                      multi_step_cm kernel (ops.multistep.vmem_sweeps);
  run_hbm_blocked   — one rank: k steps per pass over device memory, the
                      tb_sweep kernel (ops.multistep.hbm_sweeps);
  run_deep          — any process grid: one width-k exchange per k steps,
                      the local k steps on multi_step_cm or tb_sweep by
                      block size (parallel.deep_halo).

Each schedule runs its sweeps (a launch, or a deep sweep with its
exchange) through an exact loop of models/scan.py (`sweep_loop`), as JAX
runs them in one compiled program: CUDA graphs of sweeps on one CUDA rank
and on CUDA ranks over NCCL ("scan-graph"), the eager loop over gloo
("scan-loop"), the same replay schedule eagerly on one CPU rank
("scan-eager"). The per-call work (the coefficient, the zero wire state)
runs eagerly before the replays.

Every variant runs on this rank's shard. "ap" and "fused" are written for
the whole domain; on a shard they run on the halo-padded block and keep
its core, which gives each cell the arithmetic of the global form. Their
exchange stands in for the JAX package's GSPMD communication, so it
always ships full precision: a reduced `wire_mode` reaches the `shard`,
`perf`, `kp` and `hide` exchanges and the deep sweeps only.

`halo_transport="host"` routes `run("shard")` to the host-staged numpy
oracle (parallel/halo.HostStagedStepper, `_run_host_staged`); the other
variants keep their device exchange and warn, as in the JAX package.

In place of JAX buffer donation the advance keeps two field buffers and
swaps them each step, as the reference swaps `T, T2 = T2, T`; the sharded
`shard`, `kp`, `ap` and `fused` steps also reuse one padded buffer for the
exchange (`perf` and `hide` build none: their faces live on the grid).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import numpy as np
import torch

from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.ops import kernels, multistep
from rocm_mpi_tpu_torch.ops.diffusion import (
    gaussian_ic,
    step_flux_form,
    step_fused,
    step_fused_padded,
)
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
from rocm_mpi_tpu_torch.ops.kp import kp_step_padded
from rocm_mpi_tpu_torch.parallel import deep_halo, distributed, wire
from rocm_mpi_tpu_torch.parallel.gather import allgather_to_host
from rocm_mpi_tpu_torch.parallel.halo import (
    HostStagedStepper,
    exchange_faces,
    exchange_halo,
    exchange_halo_batched,
    global_boundary_mask,
    place_core,
)
from rocm_mpi_tpu_torch.models import lanes as _lanes
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid, init_batched_grid, init_global_grid
from rocm_mpi_tpu_torch.parallel.overlap import make_batched_overlap_step, make_overlap_step
from rocm_mpi_tpu_torch.utils import metrics
from rocm_mpi_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class RunResult:
    T: torch.Tensor  # this rank's shard of the final field
    wtime: float  # seconds over the timed steps
    nt: int
    warmup: int
    config: DiffusionConfig
    # The multi-step schedules' record of what ran: the local route
    # ("vmem-loop", "hbm-tb"; for run_deep "vmem", "hbm-tb" or "jnp";
    # for the scan driver "scan-graph", "scan-eager" or "scan-loop"; for
    # the host-staged oracle "host-staged") and the steps per launch,
    # sweep or chunk. None for the step driver.
    route: str | None = None
    k: int | None = None
    # The loop the schedules and the scan driver ran ("scan-graph",
    # "scan-loop" or "scan-eager") and the host ms its graphs' captures
    # took (0.0 off the graph route). None for the step driver.
    loop_route: str | None = None
    capture_ms: float | None = None

    @property
    def wtime_it(self) -> float:
        return metrics.wtime_per_it(self.wtime, self.nt, self.warmup)

    @property
    def t_eff(self) -> float:
        """Aggregate T_eff over the global field [GB/s]."""
        return metrics.t_eff_gbs(
            self.config.global_shape, self.T.element_size(), self.wtime_it
        )

    @property
    def gpts(self) -> float:
        return metrics.gpts_per_s(self.config.global_shape, self.wtime_it)


def effective_block_steps(nt: int, warmup: int, k: int, *, label: str = "block_steps",
                          warn: bool = True, stacklevel: int = 3) -> int:
    """The sweep/chunk depth usable for the given step counts:
    gcd(warmup, nt - warmup, k), so that k divides both windows. Warns
    when that degrades the requested k."""
    if k < 1:
        raise ValueError(f"{label} must be >= 1, got {k}")
    eff = math.gcd(math.gcd(warmup, nt - warmup), k) or 1
    if warn and eff != k:
        warnings.warn(
            f"{label} degraded: {k} requested but warmup={warmup} / "
            f"timed={nt - warmup} force k={eff}; pick step counts "
            f"divisible by {k} to keep the full k-steps-per-sweep saving.",
            stacklevel=stacklevel,
        )
    return eff


def default_deep_depth(local_shape, itemsize: int) -> int:
    """run_deep's automatic depth for a shard: DEFAULT_DEEP_STEPS clamped
    to the shard extent, halved while the k-padded shard exceeds the VMEM
    budget but a shallower sweep would fit; shards that fit at no depth
    take the temporal-blocked sweep's DEFAULT_TB_STEPS."""
    budget = multistep._VMEM_BLOCK_BUDGET_BYTES

    def padded_bytes(kk):
        b = itemsize
        for ln in local_shape:
            b *= ln + 2 * kk
        return b

    k = min(multistep.DEFAULT_DEEP_STEPS, min(local_shape))
    while k > multistep.DEFAULT_TB_STEPS and padded_bytes(k) > budget:
        k //= 2
    if padded_bytes(k) > budget:
        k = min(k, multistep.DEFAULT_TB_STEPS)
    return max(1, k)


def warn_host_transport_ignored(variant: str, stacklevel: int = 3) -> None:
    """The warning for halo_transport='host' on a variant that keeps its
    device exchange (only 'shard' routes to the host-staged oracle) — the
    JAX package's text."""
    warnings.warn(
        f"halo_transport='host' is not honored by variant {variant!r} — "
        "only variant 'shard' routes to the host-staged oracle stepper; "
        "all other variants keep their device-side communication (GSPMD "
        "or ppermute).",
        stacklevel=stacklevel,
    )


# A step is step(T, C, out, pad) -> new T. `out` is a field-shaped buffer
# the step may write the result into (never T itself); `pad` the padded
# buffer of the exchange. Either may be None, and the step allocates.
Step = Callable[..., torch.Tensor]


class HeatDiffusion:
    """Heat diffusion on this rank's shard of a global grid."""

    def __init__(self, config: DiffusionConfig, grid: GlobalGrid | None = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        if grid is None:
            grid = init_global_grid(*config.global_shape, lengths=config.lengths,
                                    dims=config.dims)
        if grid.global_shape != config.global_shape:
            raise ValueError(
                f"grid shape {grid.global_shape} != config {config.global_shape}"
            )
        if grid.lengths != config.lengths:
            raise ValueError(f"grid lengths {grid.lengths} != config {config.lengths}")
        self.grid = grid
        # The time step in the field dtype, as the JAX package rounds it
        # (cfg.jax_dtype(cfg.dt)) before any arithmetic.
        self.dt = torch.tensor(config.dt, dtype=config.torch_dtype, device=self.device)
        self.dt_value = float(self.dt)  # the same value as a Python double
        self._mask = global_boundary_mask(grid, device=self.device)
        self._step_fns: dict[str, Step] = {}
        self._prep_fns: dict[str, Callable] = {}
        self.register_variant("ap", *self._make_global_step(step_flux_form))
        self.register_variant("fused", *self._make_global_step(step_fused))
        self.register_variant("shard", self._make_shard_step(step_fused_padded, self.dt))
        self.register_variant("perf", *self._make_masked_step())
        if grid.ndim == 2:
            # The kernels take dt as a double: the float, read once here.
            self.register_variant("kp", self._make_shard_step(kp_step_padded, self.dt_value))
        self.register_variant("hide", *self._make_hide_step())

    # ---- state ----------------------------------------------------------

    def init_state(self):
        """(T, Cp): this rank's shard of the centred Gaussian IC and of
        Cp = cp0, both in the config dtype on the model's device."""
        cfg, grid = self.config, self.grid
        dtype = cfg.torch_dtype
        coords = grid.local_coord_mesh(dtype=dtype, device=self.device)
        T = gaussian_ic(coords, cfg.lengths, dtype=dtype)
        Cp = torch.full(grid.local_shape, cfg.cp0, dtype=dtype, device=self.device)
        return T, Cp

    # ---- variants -------------------------------------------------------

    def register_variant(self, name: str, step_fn: Step,
                         prepare: Callable | None = None):
        """`prepare(Cp) -> C` (optional) builds the loop-invariant
        coefficient every step receives, once per advance; without it C is
        Cp itself."""
        self._step_fns[name] = step_fn
        if prepare is not None:
            self._prep_fns[name] = prepare
        else:
            self._prep_fns.pop(name, None)

    @property
    def variants(self) -> tuple[str, ...]:
        return tuple(self._step_fns)

    def _get_step(self, variant: str) -> Step:
        try:
            return self._step_fns[variant]
        except KeyError:
            raise ValueError(
                f"unknown variant {variant!r} for a {self.grid.ndim}D grid; "
                f"available: {', '.join(self.variants)}"
            ) from None

    def _padded_shape(self) -> tuple[int, ...]:
        return tuple(n + 2 for n in self.grid.local_shape)

    def _make_global_step(self, raw_step):
        """A whole-domain step on the halo-padded shard: the prepared C is
        Cp padded once (ghost values unused), each step exchanges T, runs
        `raw_step` on the padded block and keeps its core; global boundary
        cells keep their old values."""
        cfg, grid = self.config, self.grid
        core = tuple(slice(1, -1) for _ in range(grid.ndim))

        def prepare(Cp):
            return place_core(Cp)

        def step(T, Cpp, out=None, pad=None):
            Tp = exchange_halo(T, grid, out=pad)
            new = raw_step(Tp, Cpp, cfg.lam, self.dt, cfg.spacing)[core]
            return torch.where(self._mask, T, new, out=out)

        return step, prepare

    def _make_shard_step(self, padded_update, dt):
        """Explicit-decomposition step: exchange, `padded_update(Tp, Cp,
        lam, dt, spacing)` on the padded block, Dirichlet select."""
        cfg, grid = self.config, self.grid

        def step(T, Cp, out=None, pad=None):
            Tp = exchange_halo(T, grid, out=pad, wire_mode=cfg.wire_mode)
            new = padded_update(Tp, Cp, cfg.lam, dt, cfg.spacing)
            return torch.where(self._mask, T, new, out=out)

        return step

    def _cm_prepare(self):
        """prepare(Cp) -> Cm: (dt·λ)/Cp on updating cells, exactly 0.0 on
        global Dirichlet boundary cells."""
        lam = self.config.lam

        def prepare(Cp):
            return torch.where(self._mask, torch.zeros_like(Cp), (self.dt * lam) / Cp)

        return prepare

    def _make_masked_step(self):
        """perf rung: one hand kernel per step (plus the exchange when
        sharded). Returns (step, prepare)."""
        cfg, grid = self.config, self.grid
        prepare = self._cm_prepare()

        if grid.nprocs == 1:
            # Unsharded: the block edge IS the global boundary — no
            # exchange, no pad.
            def step(T, Cm, out=None, pad=None):
                return kernels.masked_step(T, Cm, cfg.spacing, out=out)

            return step, prepare

        # Sharded: the 2·ndim faces in one batch, then one face-form launch
        # from the shard and the received faces; no padded block.
        def step(T, Cm, out=None, pad=None):
            faces = exchange_faces(T, grid, wire_mode=cfg.wire_mode)
            return kernels.fused_step_cm_faces(T, faces, Cm, cfg.spacing, out=out)

        return step, prepare

    def _make_hide_step(self, overlap_on_one_rank: bool = False):
        """hide rung: the Cm contract on the overlap decomposition, every
        region one fused_step_cm launch in every dtype (the JAX package's
        f64 jnp strips exist only because Mosaic has no f64), the slabs
        read from the shard and the exchanged faces. One rank routes to
        the perf step, bitwise. Returns (step, prepare)."""
        cfg, grid = self.config, self.grid
        if grid.nprocs == 1 and not overlap_on_one_rank:
            return self._make_masked_step()

        def region_update(T, faces, box, Cm, out):
            kernels.fused_step_cm_faces(T, faces or (None,) * (2 * T.ndim), Cm, cfg.spacing,
                                        box=box, out=out)

        local = make_overlap_step(grid, region_update, cfg.b_width, mask_boundary=False,
                                  wire_mode=cfg.wire_mode, device=self.device, faces=True)

        def step(T, Cm, out=None, pad=None):
            return local(T, Cm, out=out, pad=pad)

        return step, self._cm_prepare()

    # ---- drivers --------------------------------------------------------

    def lane_advance_fn(self, variant: str):
        """The standalone single-lane advance a batched lane of `variant`
        equals bit for bit: advance_fn(variant), except that on a one-rank
        grid "hide" keeps the overlap decomposition (fused_step_cm over
        the boxes, the faces at the domain edge zeros) where the
        single-lane "hide" takes the perf step (masked_step, another
        operation order): the batched hide lanes run the overlap form on
        every grid."""
        if variant != "hide" or self.grid.nprocs != 1:
            return self.advance_fn(variant)
        step, prep = self._make_hide_step(overlap_on_one_rank=True)

        def advance(T, Cp, n):
            C = prep(Cp)
            spare = torch.empty_like(T)
            for _ in range(int(n)):
                T, spare = step(T, C, out=spare), T
            return T

        return advance

    def prepare_fn(self, variant: str):
        """Cp -> the coefficient `variant`'s steps receive (Cp itself when
        the variant prepares nothing)."""
        self._get_step(variant)
        return self._prep_fns.get(variant, lambda Cp: Cp)

    def step_fn(self, variant: str):
        """(T, Cp) -> new T, one step with the coefficient prepared inside;
        leaves T untouched."""
        step, prep = self._get_step(variant), self.prepare_fn(variant)

        def one_step(T, Cp):
            return step(T, prep(Cp))

        return one_step

    def advance_fn(self, variant: str):
        """(T, Cp, n) -> T after n steps.

        The coefficient is prepared once per call, outside the step loop.
        The loop keeps two field buffers and swaps them every step (the
        reference's `T, T2 = T2, T`), and the sharded steps exchange into
        one reused padded buffer, so steady-state stepping allocates no
        field. The passed-in T is one of the two buffers: like a donated
        JAX argument, the caller must not use it afterwards.
        """
        step, prep = self._get_step(variant), self.prepare_fn(variant)
        pads = self._pads(variant)

        def advance(T, Cp, n):
            C = prep(Cp)
            pad = None
            if pads:
                pad = torch.zeros(self._padded_shape(), dtype=T.dtype, device=T.device)
            spare = torch.empty_like(T)
            for _ in range(int(n)):
                T, spare = step(T, C, out=spare, pad=pad), T
            return T

        return advance

    def _pads(self, variant: str) -> bool:
        """Whether `variant`'s steps exchange into a padded buffer: all but
        perf and hide, which read the shard (and, sharded, the exchanged
        faces) in place."""
        return variant not in ("perf", "hide")

    def scan_advance_fn(self, variant: str, nt: int | None = None,
                        warmup: int | None = None, chunk: int | None = None,
                        config: str | None = None, exact: bool = False):
        """(advance(T, Cp, n) -> T, q): the scan driver (models/scan.py).

        q is JAX's: the largest chunk serving both timing windows,
        gcd(warmup, nt − warmup, chunk or nt − warmup), with a warning when
        an explicit chunk degrades. A call runs n // q chunks of q steps,
        JAX's floor: on one CUDA rank, or CUDA ranks over NCCL (the halo
        exchange captured too), as replays of captured CUDA graphs; on one
        CPU rank as the same schedule of eager steps; over gloo as a plain
        loop. The coefficient is prepared once per call, outside the
        chunks. `config="auto"` takes an unset chunk from the tuning cache
        (op "diffusion.scan" at this shard and process grid; rank 0
        decides for every rank), gcd'd against the windows; a miss keeps
        the default. The passed-in T becomes a buffer of the
        driver: like a donated JAX argument, the caller must rebind T from
        the result. `advance.loop` is the ScanLoop (route, plan, graphs).

        `exact=True` runs every step a call asks for, as the schedules'
        sweep loops do: n // c graphs of c steps, then one-step graphs
        (checkpoint mode's segments, whose lengths need not be multiples
        of q; the graphs are captured once and serve every segment).
        """
        cfg = self.config
        step, prep = self._get_step(variant), self.prepare_fn(variant)
        tuned = None if chunk is not None else auto_scan_chunk(
            "diffusion.scan", self.grid, cfg.torch_dtype, config, self.device)
        q = scan_chunk(cfg.nt if nt is None else nt, cfg.warmup if warmup is None else warmup,
                       chunk, "scan driver chunk", tuned)
        pad = None
        if self._pads(variant):
            pad = torch.zeros(self._padded_shape(), dtype=cfg.torch_dtype, device=self.device)

        def one_step(src, out, consts):
            (T,), (C,) = src, consts
            return step(T, C, out=out, pad=pad)

        route = scan_route(self.device, self.grid.nprocs, distributed.backend())
        loop = ScanLoop(one_step, graph_plan(q, 2), route, exact=exact)

        def advance(T, Cp, n):
            (T,) = loop((T,), (prep(Cp),), n)
            return T

        advance.loop = loop
        return advance, q

    # ---- multi-tenant batching (docs/SERVING.md) ------------------------

    def make_batched_grid(self, batch: int, batch_dims: int = 1, nprocs: int | None = None,
                          rank: int | None = None):
        """The space×batch grid for `batch` lanes of this model's problem
        (mesh.init_batched_grid), the space decomposition pinned to the
        model's own grid dims, so a lane's shards match its standalone
        twin's."""
        cfg = self.config
        return init_batched_grid(batch, *cfg.global_shape, lengths=cfg.lengths,
                                 space_dims=self.grid.dims, batch_dims=batch_dims,
                                 nprocs=nprocs, rank=rank)

    def _make_batched_step(self, bgrid, variant: str):
        """(step, prepare-or-None) over a rank's lane block — the JAX
        package's _make_batched_step. `step(Tb, C, out, active) -> out`
        writes the next state of every lane into `out` (never Tb); lanes
        not in `active` (lanes.Active; None = all) keep their cells. C is
        the lane-shared coefficient, prepared by `prepare(Cp)` once per
        advance where the variant prepares one (hide).

        "shard" runs one exchange of every lane (exchange_halo_batched)
        and the padded step over the whole block; "hide" the lane-batched
        overlap on the Cm contract (make_batched_overlap_step: every
        lane's boxes one fused_step_cm launch each, fed by one face
        exchange of the block); "ap" and "fused" exchange the block and
        run the global-array step lane by lane. Each gives every lane
        the arithmetic of its standalone step (lane_advance_fn)."""
        cfg = self.config
        space = bgrid.space
        mask = global_boundary_mask(space, device=self.device)
        pads: dict = {}

        def padded(Tb, wire_mode):
            key = (tuple(Tb.shape), Tb.dtype, Tb.device)
            pads[key] = exchange_halo_batched(Tb, bgrid, wire_mode=wire_mode,
                                              out=pads.get(key))
            return pads[key]

        if variant in ("ap", "fused"):
            raw = step_flux_form if variant == "ap" else step_fused
            core = tuple(slice(1, -1) for _ in range(space.ndim))

            def step(Tb, Cpp, out, active=None):
                Tp = padded(Tb, "f32")
                live = range(Tb.shape[0]) if active is None else active.lanes
                for j in range(Tb.shape[0]):
                    if j not in live:
                        out[j].copy_(Tb[j])
                        continue
                    new = raw(Tp[j], Cpp, cfg.lam, self.dt, cfg.spacing)[core]
                    torch.where(mask, Tb[j], new, out=out[j])
                return out

            return step, place_core

        if variant == "hide":
            def region_update(T, faces, box, Cm, out):
                kernels.fused_step_cm_faces(T, faces or (None,) * (2 * T.ndim), Cm,
                                            cfg.spacing, box=box, out=out)

            local = make_batched_overlap_step(bgrid, region_update, cfg.b_width,
                                              wire_mode=cfg.wire_mode, device=self.device)

            def step(Tb, Cm, out, active=None):
                return local(Tb, Cm, out, None if active is None else active.lanes)

            def prepare(Cp):
                return torch.where(mask, torch.zeros_like(Cp), (self.dt * cfg.lam) / Cp)

            return step, prepare

        if variant != "shard":
            raise ValueError(
                f"batched advance supports variants 'shard', 'hide', 'ap', 'fused'; got "
                f"{variant!r} (the Pallas rungs are single-lane)")

        def step(Tb, Cp, out, active=None):
            new = step_fused_padded(padded(Tb, cfg.wire_mode), Cp, cfg.lam, self.dt, cfg.spacing)
            return torch.where(_lanes.hold_mask(mask, active), Tb, new, out=out)

        return step, None

    def batched_step_fn(self, bgrid, variant: str = "shard"):
        """`step(Tb, C) -> Tb'`: one batched step of every lane, C the
        prepared coefficient (batched_prepare_fn) — the JAX package's
        audit surface of one batched step."""
        step, _ = self._make_batched_step(bgrid, variant)
        return lambda Tb, C: step(Tb, C, torch.empty_like(Tb))

    def batched_prepare_fn(self, bgrid, variant: str = "shard"):
        """`prepare(Cp) -> C` of the batched variant (the identity for
        the variants that prepare nothing but ap/fused's padding)."""
        _, prep = self._make_batched_step(bgrid, variant)
        return prep if prep is not None else (lambda C: C)

    def batched_advance_fn(self, batch: int | None = None, variant: str = "shard", bgrid=None,
                           batch_dims: int = 1):
        """(advance(Tb, Cp, lane_steps, n) -> Tb, bgrid) — the batched
        advance of the serving layer (docs/SERVING.md). `Tb` is this
        rank's `(local lanes, *shard)` block (bgrid.local_block of the
        full batch), `Cp` the space shard every lane shares, `lane_steps`
        the host step counts of the local lanes, `n` the batch's steps
        (the longest lane's). Lane j freezes bitwise after its own
        lane_steps[j] (models/lanes.py), so every lane equals a standalone
        run of its own length (lane_advance_fn). The steps ping-pong
        between Tb and a spare kept by the advance (`advance.slots`): the
        caller must rebind from the result, as from a donated JAX
        argument. One advance serves any lane_steps and n."""
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        step, prep = self._make_batched_step(bgrid, variant)
        slots = _lanes.LaneSlots()
        ndim = bgrid.space.ndim

        def advance(Tb, Cp, lane_steps, n):
            C = Cp if prep is None else prep(Cp)
            spare = slots.spare(Tb, avoid=(Tb,))
            for active in _lanes.schedule(lane_steps, n, ndim, Tb.device):
                Tb, spare = step(Tb, C, spare, active), Tb
            return Tb

        advance.slots = slots
        return advance, bgrid

    def ladder_step(self, spacing, dt):
        """The shard step's arithmetic at another geometry: `(Tp, Cp,
        hold, out) -> out` with `dt` (a 0-dim tensor in the field dtype)
        and `spacing` a lane's own — the ladder lane's step."""
        lam = self.config.lam

        def step(Tp, Cp, hold, out):
            return torch.where(hold, Tp[tuple(slice(1, -1) for _ in spacing)],
                               step_fused_padded(Tp, Cp, lam, dt, spacing), out=out)

        return step

    def batched_ladder_advance_fn(self, batch: int | None = None, bgrid=None,
                                  batch_dims: int = 1):
        """(advance(Tb, Cp, hold, geom, lane_steps, n) -> Tb, bgrid) — the
        ladder edition of the batched advance (the JAX package's
        batched_ladder_advance_fn): this model's shape is the ladder rung,
        and lane j embeds a smaller original domain at the origin corner.
        `hold` is `(lanes, *shard)` bool, True on a lane's held cells (its
        original domain's Dirichlet ring and everything outside it);
        `geom[j]` is lane j's `(dt, spacing)`, its original config's
        (serving adapters' ladder_geom). Each lane runs the shard step's
        operations with its own Python-scalar spacing and dt on its view of
        the block, after one exchange of every lane, so its interior cells
        get the bits of its standalone run. Single-controller, as in the
        JAX package; the 'f32' wire only."""
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        slots = _lanes.LaneSlots()
        pads: dict = {}
        ndim = bgrid.space.ndim

        def advance(Tb, Cp, hold, geom, lane_steps, n):
            steps = [self.ladder_step(sp, dt) for dt, sp in geom]
            spare = slots.spare(Tb, avoid=(Tb,))
            key = (tuple(Tb.shape), Tb.dtype, Tb.device)
            for active in _lanes.schedule(lane_steps, n, ndim, Tb.device):
                Tp = pads[key] = exchange_halo_batched(Tb, bgrid, out=pads.get(key))
                live = range(Tb.shape[0]) if active is None else active.lanes
                for j, st in enumerate(steps):
                    if j in live:
                        st(Tp[j], Cp, hold[j], spare[j])
                    else:
                        spare[j].copy_(Tb[j])
                Tb, spare = spare, Tb
            return Tb

        advance.slots = slots
        return advance, bgrid

    def batched_deep_advance_fn(self, batch: int | None = None, block_steps: int | None = None,
                                bgrid=None, batch_dims: int = 1, wire_mode: str | None = None):
        """(advance(Tb, Cp, n) -> Tb, bgrid, k) — the deep-halo schedule
        on a BatchedGrid (parallel.deep_halo.make_deep_sweep): one width-k
        exchange of every lane per k steps, the local k steps in the
        "jnp" form over the block. Uniform steps only: `n` a multiple of
        k for every lane."""
        cfg = self.config
        if bgrid is None:
            if batch is None:
                raise ValueError("pass batch= or a prebuilt bgrid=")
            bgrid = self.make_batched_grid(batch, batch_dims)
        k = block_steps
        if k is None:
            k = default_deep_depth(bgrid.space.local_shape,
                                   multistep._compute_itemsize(cfg.torch_dtype))
        wm = cfg.wire_mode if wire_mode is None else wire_mode
        sched = deep_halo.make_deep_sweep(bgrid, k, cfg.lam, self.dt, cfg.spacing,
                                          wire_mode=wm)

        def advance(Tb, Cp, n):
            sweeps = check_sweeps(n, sched.k)
            Cm = sched.prepare(Cp)
            for _ in range(sweeps):
                Tb = sched.sweep(Tb, Cm)
            return Tb

        return advance, bgrid, sched.k

    def run(self, variant: str = "ap", nt: int | None = None,
            warmup: int | None = None, driver: str = "step",
            config: str | None = None, windows: int = 1,
            on_boundary=None) -> RunResult:
        """Run `nt` steps from the initial condition; time all but the
        first `warmup`. `driver="scan"` runs scan_advance_fn's chunks, with
        the same steps in the same order as "step": the result is bitwise
        equal, and `route`/`k` report the scan route and q.
        `config` reaches the scan driver only. `windows` and
        `on_boundary` reach metrics.timed_window (the timed steps split
        into windows, multiples of q under the scan driver, and a hook
        at each window's start).

        With halo_transport="host", "shard" runs the host-staged oracle
        (`_run_host_staged`, whatever the driver) and every other variant
        warns and keeps its device exchange."""
        if driver not in ("step", "scan"):
            raise ValueError(f"driver must be 'step' or 'scan', got {driver!r}")
        nt, warmup = metrics.resolve_windows(self.config, nt, warmup)
        cfg = self.config
        if cfg.halo_transport == "host":
            if variant == "shard":
                return self._run_host_staged(nt, warmup)
            warn_host_transport_ignored(variant)
        if cfg.wire_mode != "f32" and variant in ("ap", "fused"):
            warnings.warn(
                f"wire_mode={cfg.wire_mode!r} is not honored by variant "
                f"{variant!r} — the GSPMD global-array variants have no "
                "explicit exchange to encode; use shard/perf/hide or the "
                "deep schedule.",
                stacklevel=2,
            )
        T, Cp = self.init_state()
        if driver == "step":
            advance = self.advance_fn(variant)
            T, wtime = self._timed(lambda T, n: advance(T, Cp, n), T, nt, warmup,
                                   windows=windows, on_boundary=on_boundary,
                                   variant=variant, driver=driver)
            return RunResult(T=T, wtime=wtime, nt=nt, warmup=warmup, config=self.config)
        advance, k = self.scan_advance_fn(variant, nt=nt, warmup=warmup, config=config)
        T, wtime = self._timed(lambda T, n: advance(T, Cp, n), T, nt, warmup,
                               windows=windows, unit=k, on_boundary=on_boundary,
                               variant=variant, driver=driver)
        return RunResult(T=T, wtime=wtime, nt=nt, warmup=warmup, config=self.config,
                         route=advance.loop.route, k=k, **loop_record(advance.loop))

    def _run_host_staged(self, nt: int, warmup: int) -> RunResult:
        """The host-staged oracle run (the IGG_ROCMAWARE_MPI=0 analog):
        every rank gathers the initial field, runs HostStagedStepper over
        the whole process grid in numpy (the native engine for f64 where
        it builds), timing only the stepper's steps after `warmup`, and
        keeps its own shard, on the model's device. Each rank runs the
        same deterministic steps, so every shard is the stepper's. bf16
        fields step in float32 and are rounded back at the end."""
        cfg, grid = self.config, self.grid
        T, Cp = self.init_state()
        T_np, Cp_np = allgather_to_host(T, grid), allgather_to_host(Cp, grid)
        stepper = HostStagedStepper(grid, cfg.lam, cfg.dt, wire_mode=cfg.wire_mode)
        T_np, wtime = metrics.timed_window(lambda T_, n: stepper.run(T_, Cp_np, n), T_np,
                                           nt, warmup, variant="shard-host",
                                           workload="diffusion")
        shard = np.ascontiguousarray(T_np[grid.shard_slices()])
        T_out = torch.from_numpy(shard).to(device=self.device, dtype=cfg.torch_dtype)
        return RunResult(T=T_out, wtime=wtime, nt=nt, warmup=warmup, config=cfg,
                         route="host-staged")

    # ---- multi-step schedules -------------------------------------------

    def _timed(self, advance, T, nt, warmup, **kw):
        """metrics.timed_window of `advance(T, n)` on this model's grid;
        `kw` carries its windows, unit and on_boundary, and the stamps of
        its step_window spans (variant, driver)."""
        return metrics.timed_window(advance, T, nt, warmup, sharded=self.grid.nprocs > 1,
                                    group=self.grid.group, workload="diffusion", **kw)

    def _run_single_shard(self, nt, warmup, sweeps_fn, granularity: int,
                          granularity_kw: str, route: str, explicit: bool = False,
                          extra_kw=None) -> RunResult:
        """Shared scaffold of the one-rank multi-step paths: pick a
        granularity dividing both the warmup and timed windows
        (effective_block_steps), cut the loop with
        `sweeps_fn(T, lam, dt, spacing, 0, <granularity_kw>=g)` (a
        multistep.SweepPlan), then run and time it through a sweep loop:
        the coefficient (and the pow2 pad) once per call, eagerly, and the
        launches as CUDA graphs on a CUDA device. `explicit` marks a
        caller-requested granularity, whose degradation warns."""
        cfg = self.config
        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        if self.grid.nprocs != 1:
            raise ValueError("single-shard fast paths require an unsharded grid")
        key = granularity_kw
        gran = effective_block_steps(nt, warmup, granularity, warn=explicit, label=key,
                                     stacklevel=4)
        kw = {key: gran}
        if key == "chunk":
            kw["warn_on_cap"] = explicit
        if extra_kw:
            kw.update(extra_kw)
        T, Cp = self.init_state()
        parts = sweeps_fn(T, cfg.lam, self.dt_value, cfg.spacing, 0, **kw)

        def one_sweep(src, out, consts):
            (T,), (Cm,) = src, consts
            return parts.sweep(T, Cm, out=out)

        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, parts.k), self.device, 1,
                          label=f"{route} launch of {parts.k} steps")

        def advance(T, n):
            sweeps = check_sweeps(n, parts.k)
            Tb, Cm = parts.prepare(T, Cp)
            (Tb,) = loop((Tb,), (Cm,), sweeps)
            return parts.finish(Tb)

        T, wtime = self._timed(advance, T, nt, warmup, variant=key)
        return RunResult(T=T, wtime=wtime, nt=nt, warmup=warmup, config=cfg,
                         route=route, k=parts.k, **loop_record(loop))

    def run_vmem_resident(self, nt: int | None = None, warmup: int | None = None,
                          chunk: int | None = None, body_form: str | None = None,
                          pad_pow2: bool | None = None, config: str | None = None,
                          program_cache: dict | None = None) -> RunResult:
        """One-rank loop of `chunk` steps per launch of the multi_step_cm
        kernel (ops.multistep.vmem_sweeps, the launches of
        fused_multi_step through a sweep loop); the field must fit the
        VMEM budget the JAX package routes by. `chunk` defaults to
        DEFAULT_STEP_CHUNK, gcd'd against both windows; `body_form` and
        `pad_pow2` select the kernel form. `config="auto"` fills the knobs
        left None from the tuning cache (op "diffusion.vmem_loop"; a tuned
        chunk only where adoptable_vmem_chunk allows, gcd'd against the
        windows without a warning; a miss keeps the defaults).
        `program_cache` is accepted so callers written for the JAX package
        run unchanged; eager PyTorch has no compiled program to cache, and
        it is unused."""
        explicit = chunk is not None
        if multistep.auto_config(config):
            cfg = self.config
            tuned = multistep.tuned_knobs("diffusion.vmem_loop", cfg.global_shape,
                                          cfg.torch_dtype, self.device)
            if chunk is None:
                chunk = tuned.get("chunk")
            if body_form is None:
                body_form = tuned.get("body_form")
            if pad_pow2 is None:
                pad_pow2 = tuned.get("pad_pow2")
        if body_form is None:
            body_form = multistep.EQC_BODY_FORM
        if pad_pow2 is None:
            pad_pow2 = multistep.VMEM_PAD_POW2
        return self._run_single_shard(
            nt, warmup, multistep.vmem_sweeps,
            multistep.DEFAULT_STEP_CHUNK if chunk is None else chunk, "chunk", "vmem-loop",
            explicit=explicit,
            extra_kw={"body_form": body_form, "pad_pow2": pad_pow2},
        )

    def run_hbm_blocked(self, nt: int | None = None, warmup: int | None = None,
                        block_steps: int | None = None) -> RunResult:
        """One-rank temporal blocking: each launch of the tb_sweep kernel
        advances the field `block_steps` steps (default DEFAULT_TB_STEPS)
        in one pass over device memory (ops.multistep.hbm_sweeps, the
        launches of fused_multi_step_hbm through a sweep loop)."""
        cfg = self.config
        k = multistep.DEFAULT_TB_STEPS if block_steps is None else block_steps
        effective_block_steps(cfg.nt if nt is None else nt,
                              cfg.warmup if warmup is None else warmup, k,
                              label="temporal blocking block_steps", stacklevel=2)
        return self._run_single_shard(nt, warmup, multistep.hbm_sweeps, k, "block_steps",
                                      "hbm-tb")

    def effective_deep_depth(self, nt: int | None = None, warmup: int | None = None,
                             block_steps: int | None = None, warn: bool = True,
                             config: str | None = None) -> int:
        """The sweep depth run_deep executes for these arguments: an
        explicit `block_steps`, else with `config="auto"` the tuned depth
        (op "diffusion.deep"; dropped where it exceeds a shard edge), else
        default_deep_depth for this shard at the compute width, then
        gcd'd against both windows."""
        cfg = self.config
        if block_steps is None:
            k = deep_halo.resolve_deep_k(self.grid, cfg.torch_dtype, config, self.device)
            if k is None:
                k = default_deep_depth(self.grid.local_shape,
                                       multistep._compute_itemsize(cfg.torch_dtype))
        else:
            k = block_steps
        return effective_block_steps(
            cfg.nt if nt is None else nt, cfg.warmup if warmup is None else warmup, k,
            label="deep-halo sweep depth", warn=warn, stacklevel=3,
        )

    def effective_wire_mode(self, wire_mode: str | None = None,
                            config: str | None = None) -> str:
        """The state exchange's on-wire precision of a deep run: an explicit
        `wire_mode`, else the tuned one with `config="auto"` (op
        "diffusion.deep"), else the config's."""
        if wire_mode is not None:
            return wire.validate_mode(wire_mode)
        tuned = deep_halo.resolve_deep_config(self.grid, self.config.torch_dtype,
                                              config, self.device)["wire_mode"]
        return tuned if tuned is not None else self.config.wire_mode

    def deep_advance_fn(self, block_steps: int | None = None, nt: int | None = None,
                        warmup: int | None = None, config: str | None = None,
                        wire_mode: str | None = None):
        """(advance(T, Cp, n_steps) -> T, executed depth k) of the deep
        schedule. The coefficient is exchanged and masked once per call,
        and T placed into the core of the loop's k-padded block; then
        n_steps/k sweeps (DeepSchedule.step, the state kept padded) run
        through a sweep loop (models/scan.py: CUDA graphs of sweeps, the
        exchange included, on a CUDA rank), and the call returns the
        core. `n_steps` must be a multiple of k. `advance.schedule` is the
        DeepSchedule (its `route` says which local route the sweeps
        took), `advance.loop` the loop. For the stateful wire modes each
        call starts from a zero wire state (the JAX package's first-sweep
        contract), zeroed eagerly in the loop's slot, and threads it
        through its sweeps."""
        cfg = self.config
        if cfg.halo_transport == "host":
            warn_host_transport_ignored("deep", stacklevel=3)
        k = self.effective_deep_depth(nt, warmup, block_steps, config=config)
        wm = self.effective_wire_mode(wire_mode, config)
        sched = deep_halo.make_deep_sweep(self.grid, k, cfg.lam, self.dt, cfg.spacing,
                                          wire_mode=wm)

        def one_sweep(src, out, consts):
            ((Tp, *ws),), (Cm,) = src, consts
            if sched.init_wire is None:
                return sched.step(Tp, Cm, out[0])
            Tp, ws = sched.step(Tp, Cm, out[0], tuple(ws))
            return (Tp, *ws)

        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        loop = sweep_loop(one_sweep, window_sweeps(nt, warmup, k), self.device,
                          self.grid.nprocs, label=f"deep sweep of {k} steps on local route "
                          f"{sched.route_of(cfg.torch_dtype)}")
        core = tuple(slice(k, -k) for _ in self.grid.local_shape)

        def advance(T, Cp, n_steps):
            sweeps = check_sweeps(n_steps, k)
            if sweeps == 0:
                return T
            Cm = sched.prepare(Cp)
            (slot,) = loop((padded_slot(loop, (T,), k, sched.init_wire),), (Cm,), sweeps)
            return slot[0][core].contiguous()

        advance.schedule = sched
        advance.loop = loop
        return advance, k

    def run_deep(self, nt: int | None = None, warmup: int | None = None,
                 block_steps: int | None = None, config: str | None = None,
                 wire_mode: str | None = None) -> RunResult:
        """Deep-halo sweeps on any process grid: one width-k exchange per k
        steps (parallel.deep_halo). The default depth is
        default_deep_depth's (32 where the padded shard fits the VMEM
        budget, 8 on the temporal-blocked route), gcd'd against both
        windows."""
        cfg = self.config
        nt, warmup = metrics.resolve_windows(cfg, nt, warmup)
        advance, k = self.deep_advance_fn(block_steps=block_steps, nt=nt, warmup=warmup,
                                          config=config, wire_mode=wire_mode)
        T, Cp = self.init_state()
        T, wtime = self._timed(lambda T, n: advance(T, Cp, n), T, nt, warmup, variant="deep")
        return RunResult(T=T, wtime=wtime, nt=nt, warmup=warmup, config=cfg,
                         route=advance.schedule.route, k=k, **loop_record(advance.loop))
