"""The inputs of a run, made from the seed: the initial field T0 and the
heat capacity Cp of any block of the global grid.

The program and the plain reference both take their inputs from here, so
the two sides start from the same numbers. Every value is a function of
the seed and of the cell's global index alone: a rank's shard and the
reference's larger block around it hold the same bits where they overlap,
whatever the process grid.

    T0[i, j] = exp(-(x_i - x0)^2) * exp(-(y_j - y0)^2)
               + A * (u_i * v_j + w_i * z_j)
    Cp[i, j] = cp0 * (1 + p_i * q_j)

x and y are the cell centres, (i + 1/2) * h. The first term is the
reference's unit Gaussian with its centre (x0, y0) moved off the domain's
centre by up to `centre_jitter` along each axis; the second gives every
cell, the global boundary included, a value of its own, so that a cell
that is stepped wrongly, or held where it should move, shows. Cp >= cp0
keeps the reference's time step min(h^2) * cp0 / lam / 4.1 stable. The
vectors u, v, w, z, p, q (uniform on [0, 1)) and the centre come from one
torch.Generator on the target device seeded with the seed, in a fixed
order of calls; a block is three element-wise calls over it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Vectors:
    """The per-axis vectors of one seed, over the whole global axis."""

    gauss: tuple[torch.Tensor, torch.Tensor]
    noise: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    cp: tuple[torch.Tensor, torch.Tensor]
    amplitude: float
    cp0: float


def seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def make_vectors(seed: int, global_shape, lengths, ic: dict, cp0: float,
                 device) -> Vectors:
    """The seed's vectors in float64 on `device`. `ic` is the
    configuration's `initial_condition` block: `centre_jitter` (length
    units) and `noise_amplitude` (A above)."""
    if len(global_shape) != 2:
        raise ValueError(f"the diffusion inputs are 2D, got shape {tuple(global_shape)}")
    gen = seed_generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    shift = (torch.rand(2, generator=gen, **f64) - 0.5) * (2.0 * float(ic["centre_jitter"]))
    gauss = []
    for ax, (n, length) in enumerate(zip(global_shape, lengths)):
        x = (torch.arange(n, **f64) + 0.5) * (float(length) / n)
        gauss.append(torch.exp(-(x - (float(length) / 2.0 + shift[ax])) ** 2))
    nx, ny = global_shape
    noise = tuple(torch.rand(n, generator=gen, **f64) for n in (nx, ny, nx, ny))
    cp = tuple(torch.rand(n, generator=gen, **f64) for n in (nx, ny))
    return Vectors(gauss=tuple(gauss), noise=noise, cp=cp,
                   amplitude=float(ic["noise_amplitude"]), cp0=float(cp0))


def write_T0(vec: Vectors, region, out: torch.Tensor) -> torch.Tensor:
    """T0 of the block `region` ((slice, slice) of global indices) into
    `out`, in out's dtype (computed in float64 where out is float64)."""
    sx, sy = region
    u, v, w, z = vec.noise
    if out.dtype == torch.float64:
        torch.outer(vec.gauss[0][sx], vec.gauss[1][sy], out=out)
        out.addr_(u[sx], v[sy], alpha=vec.amplitude)
        out.addr_(w[sx], z[sy], alpha=vec.amplitude)
        return out
    full = torch.empty(out.shape, dtype=torch.float64, device=out.device)
    out.copy_(write_T0(vec, region, full))
    return out


def make_T0(vec: Vectors, region, dtype=torch.float64) -> torch.Tensor:
    sx, sy = region
    shape = (len(range(*sx.indices(len(vec.gauss[0])))),
             len(range(*sy.indices(len(vec.gauss[1])))))
    return write_T0(vec, region, torch.empty(shape, dtype=dtype, device=vec.gauss[0].device))


def make_Cp(vec: Vectors, region, dtype=torch.float64) -> torch.Tensor:
    """Cp of the block `region`: cp0 * (1 + p_i * q_j)."""
    sx, sy = region
    p, q = vec.cp
    Cp = torch.outer(p[sx], q[sy])
    Cp.add_(1.0).mul_(vec.cp0)
    return Cp.to(dtype)
