"""The transient heat-diffusion model — counterpart of
rocm_mpi_tpu/models/diffusion.py (the ported subset).

One physics model at several performance levels, chosen by variant:

  "ap"    — flux-form array-programming step (ops.diffusion.step_flux_form)
  "fused" — the single fused stencil (ops.diffusion.step_fused)
  "shard" — explicit halo exchange + step_fused_padded + Dirichlet select
  "perf"  — the Cm contract: the Dirichlet mask and the (dt·λ)/Cp divide
            are folded into a coefficient prepared once per advance, so a
            step is ONE hand kernel — masked_step on one rank,
            exchange_halo + fused_step_cm when sharded.

Every variant runs on this rank's shard. "ap" and "fused" are written for
the whole domain; on a shard they run on the halo-padded block and keep
its core, which gives each cell the arithmetic of the global form.

In place of JAX buffer donation the advance keeps two field buffers and
swaps them each step, as the reference swaps `T, T2 = T2, T`; the sharded
steps also reuse one padded buffer for the exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.ops import kernels
from rocm_mpi_tpu_torch.ops.diffusion import (
    gaussian_ic,
    step_flux_form,
    step_fused,
    step_fused_padded,
)
from rocm_mpi_tpu_torch.parallel import distributed
from rocm_mpi_tpu_torch.parallel.halo import exchange_halo, global_boundary_mask, place_core
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid, init_global_grid
from rocm_mpi_tpu_torch.utils import metrics
from rocm_mpi_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class RunResult:
    T: torch.Tensor  # this rank's shard of the final field
    wtime: float  # seconds over the timed steps
    nt: int
    warmup: int
    config: DiffusionConfig

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
        self._mask = global_boundary_mask(grid, device=self.device)
        self._step_fns: dict[str, Step] = {}
        self._prep_fns: dict[str, Callable] = {}
        self.register_variant("ap", *self._make_global_step(step_flux_form))
        self.register_variant("fused", *self._make_global_step(step_fused))
        self.register_variant("shard", self._make_shard_step())
        self.register_variant("perf", *self._make_masked_step())

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
            Tp = exchange_halo(T, grid, out=pad, wire_mode=cfg.wire_mode)
            new = raw_step(Tp, Cpp, cfg.lam, self.dt, cfg.spacing)[core]
            return torch.where(self._mask, T, new, out=out)

        return step, prepare

    def _make_shard_step(self):
        """Explicit-decomposition step: exchange, fused padded update,
        Dirichlet select."""
        cfg, grid = self.config, self.grid

        def step(T, Cp, out=None, pad=None):
            Tp = exchange_halo(T, grid, out=pad, wire_mode=cfg.wire_mode)
            new = step_fused_padded(Tp, Cp, cfg.lam, self.dt, cfg.spacing)
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

        def step(T, Cm, out=None, pad=None):
            Tp = exchange_halo(T, grid, out=pad, wire_mode=cfg.wire_mode)
            return kernels.fused_step_cm(Tp, Cm, cfg.spacing, out=out)

        return step, prepare

    # ---- drivers --------------------------------------------------------

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
        # Every step exchanges except the unsharded perf step.
        exchanges = not (variant == "perf" and self.grid.nprocs == 1)

        def advance(T, Cp, n):
            C = prep(Cp)
            pad = None
            if exchanges:
                pad = torch.zeros(self._padded_shape(), dtype=T.dtype, device=T.device)
            spare = torch.empty_like(T)
            for _ in range(int(n)):
                T, spare = step(T, C, out=spare, pad=pad), T
            return T

        return advance

    def run(self, variant: str = "ap", nt: int | None = None,
            warmup: int | None = None) -> RunResult:
        """Run `nt` steps from the initial condition; time all but the
        first `warmup`."""
        cfg = self.config
        nt = cfg.nt if nt is None else nt
        warmup = cfg.warmup if warmup is None else warmup
        if not 0 <= warmup < nt:
            raise ValueError(f"need 0 <= warmup < nt, got {warmup}, {nt}")
        T, Cp = self.init_state()
        advance = self.advance_fn(variant)
        if warmup:
            T = advance(T, Cp, warmup)
        timer = metrics.Timer()
        metrics.force(T)
        distributed.barrier()
        timer.tic()
        T = advance(T, Cp, nt - warmup)
        metrics.force(T)
        distributed.barrier()
        wtime = timer.toc()
        return RunResult(T=T, wtime=wtime, nt=nt, warmup=warmup, config=cfg)
