"""The plain reference of 2D heat diffusion, in PyTorch alone.

It imports nothing of the program and takes nothing the program made:
given T0 and Cp of a block of the global grid
(stencil_bench/inputs/diffusion2d.py), it works out its own time step
and coefficient and steps the block,

    T'[i, j] = T + (dt * lam / Cp) * ((T[i+1, j] + T[i-1, j] - 2 T) / dx^2
                                      + (T[i, j+1] + T[i, j-1] - 2 T) / dy^2)

on every cell inside the block's outer ring, which it holds at its
initial values: the global Dirichlet boundary, where the ring is the
domain's edge. A block cut out of a larger domain (a rank's shard grown
by a margin) is exact after n steps on the cells at least n cells away
from every cut, since a wrong value at a cut travels one cell a step.

`dtype` is the precision it computes in: float64, as the configuration
states, or float32 for the control that has to come out not correct.
"""

from __future__ import annotations

import torch


def time_step(spacing, cp0: float, lam: float) -> float:
    """The reference's stable step: min(h^2) * cp0 / lam / (2 ndim + 0.1)."""
    h2 = min(d * d for d in spacing)
    return h2 * cp0 / lam / (2 * len(spacing) + 0.1)


def run(T0: torch.Tensor, Cp: torch.Tensor, steps: int, lam: float, dt: float, spacing,
        dtype=torch.float64) -> torch.Tensor:
    """The block after `steps` steps from T0, in `dtype`."""
    if T0.ndim != 2 or T0.shape != Cp.shape:
        raise ValueError(f"need two 2D blocks of one shape, got {tuple(T0.shape)} and "
                         f"{tuple(Cp.shape)}")
    T = T0.to(dtype=dtype, copy=True)
    out = T.clone()
    core = (slice(1, -1), slice(1, -1))
    coef = torch.tensor(dt, dtype=dtype, device=T.device) * lam / Cp[core].to(dtype)
    idx2, idy2 = 1.0 / (spacing[0] * spacing[0]), 1.0 / (spacing[1] * spacing[1])
    xs = torch.empty_like(coef)
    ys = torch.empty_like(coef)
    for _ in range(int(steps)):
        c = T[core]
        torch.add(T[2:, 1:-1], T[:-2, 1:-1], out=xs)
        xs.sub_(c, alpha=2.0).mul_(idx2)
        torch.add(T[1:-1, 2:], T[1:-1, :-2], out=ys)
        ys.sub_(c, alpha=2.0)
        xs.add_(ys, alpha=idy2).mul_(coef)
        torch.add(c, xs, out=out[core])
        T, out = out, T
    return T


def margin_region(shard, global_shape, steps: int):
    """The block the reference steps for a shard: the shard grown by
    `steps` cells on each side, clipped to the domain, and the shard's
    place inside it. Returns (block slices, shard slices within the block)."""
    block, inner = [], []
    for s, n in zip(shard, global_shape):
        lo, hi = max(0, s.start - int(steps)), min(n, s.stop + int(steps))
        block.append(slice(lo, hi))
        inner.append(slice(s.start - lo, s.stop - lo))
    return tuple(block), tuple(inner)
