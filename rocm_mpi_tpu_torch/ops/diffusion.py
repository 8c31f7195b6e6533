"""Heat-diffusion step functions and the analytic golden solution —
counterpart of rocm_mpi_tpu/ops/diffusion.py.

Physics: q = -λ ∇T, ∂T/∂t = -∇·q / cₚ; global-domain edge cells are never
updated (Dirichlet, initial values held). Every function keeps the JAX
version's order of floating-point operations, so f64 results agree to
rounding. They return new tensors and leave their inputs untouched.
"""

from __future__ import annotations

import torch

from rocm_mpi_tpu_torch.ops.stencil import d_a, d_i, inn


def _core(ndim: int) -> tuple:
    """The core of the trailing `ndim` axes (any lane axes before them
    kept whole, so a lane-batched block steps every lane at once)."""
    return (Ellipsis,) + tuple(slice(1, -1) for _ in range(ndim))


def _hi_lo(ndim: int, ax: int):
    hi = (Ellipsis,) + tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
    lo = (Ellipsis,) + tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
    return hi, lo


def step_flux_form(T, Cp, lam, dt, spacing):
    """One explicit step in staggered flux form (ap variant, any ndim):
    per axis a flux q = -λ d_i(T)/d on the staggered grid, then
    dT/dt = Σ_ax (-d_a(q)/d) / cₚ, then an interior-only update."""
    dTdt = torch.zeros_like(inn(T))
    for ax in range(T.ndim):
        d = spacing[ax]
        q = -lam * d_i(T, ax) / d
        dTdt = dTdt - d_a(q, ax) / d
    dTdt = dTdt / inn(Cp)
    out = T.clone()
    interior = _core(T.ndim)
    out[interior] = T[interior] + dt * dTdt
    return out


def step_fused(T, Cp, lam, dt, spacing):
    """One explicit step as a single fused stencil (any ndim): edge cells
    pass through unchanged, T's own boundary ring serves as the padding."""
    interior = _core(T.ndim)
    out = T.clone()
    out[interior] = step_fused_padded(T, Cp[interior], lam, dt, spacing)
    return out


def step_fused_padded(Tp, Cp, lam, dt, spacing):
    """Candidate update for every cell of a block given its width-1-padded
    neighbourhood `Tp` (shape = Cp.shape + 2 per axis); the caller masks
    the global-boundary cells. `Tp` may lead with lane axes
    (`(lanes, *padded)`), which `Cp`, shared by every lane, broadcasts
    over: each lane gets the arithmetic of its own unbatched call."""
    ndim = Cp.ndim
    core = _core(ndim)
    lap = torch.zeros_like(Cp)
    for ax in range(ndim):
        d2 = spacing[ax] * spacing[ax]
        hi, lo = _hi_lo(ndim, ax)
        lap = lap + (Tp[hi] - 2.0 * Tp[core] + Tp[lo]) / d2
    return Tp[core] + dt * lam / Cp * lap


def step_fused_padded_geom(Tp, Cp, dt_lam, inv_d2):
    """`step_fused_padded` with the geometry given as operands — the JAX
    package's ladder lane step: `dt_lam` = dt·λ and `inv_d2` the per-axis
    reciprocals 1/spacing² (scalars, or per-lane tensors broadcasting over
    the lane axis), each Laplacian term multiplied by its reciprocal."""
    ndim = Cp.ndim
    core = _core(ndim)
    lap = torch.zeros_like(Cp)
    for ax in range(ndim):
        hi, lo = _hi_lo(ndim, ax)
        lap = lap + (Tp[hi] - 2.0 * Tp[core] + Tp[lo]) * inv_d2[ax]
    return Tp[core] + dt_lam / Cp * lap


def step_cm_padded(Tp, Cm, spacing):
    """Candidate update under the Cm contract: `Cm` is (dt·λ)/Cp on
    updating cells and exactly 0.0 on held cells, which therefore come
    back unchanged (Tp[core] + 0·lap)."""
    ndim = Cm.ndim
    core = _core(ndim)
    lap = torch.zeros_like(Cm)
    for ax in range(ndim):
        d2 = spacing[ax] * spacing[ax]
        hi, lo = _hi_lo(ndim, ax)
        lap = lap + (Tp[hi] - 2.0 * Tp[core] + Tp[lo]) / d2
    return Tp[core] + Cm * lap


def gaussian_ic(coords, lengths, dtype=None):
    """Initial condition: T₀ = exp(-Σ_ax (x_ax - l_ax/2)²), a unit
    Gaussian at the domain centre. `coords` are broadcastable per-axis
    cell-centre tensors (GlobalGrid.coord_mesh)."""
    r2 = sum((c - l / 2.0) ** 2 for c, l in zip(coords, lengths))
    T = torch.exp(-r2)
    return T.to(dtype) if dtype is not None else T


def analytic_solution(coords, lengths, diffusivity, t):
    """Exact free-space solution for `gaussian_ic`:
    T(x, t) = (1 + 4Dt)^(-d/2) · exp(-r² / (1 + 4Dt)), valid while the
    field is negligible at the domain boundary."""
    d = len(coords)
    s = 1.0 + 4.0 * diffusivity * t
    r2 = sum((c - l / 2.0) ** 2 for c, l in zip(coords, lengths))
    return s ** (-d / 2.0) * torch.exp(-r2 / s)
