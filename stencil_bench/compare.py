"""The comparison that decides `correct` for heat diffusion
(stencil_bench/programs/diffusion2d.py).

A run of the cell is a simulation of nt steps from the seed's T0. The
window runs them back to back; once it has closed, the last one's final
field, which the program produced on the timed path at the timed size,
is held against the plain reference's run of the same nt steps from the
same T0 and Cp, on every rank's whole shard (the global boundary, the
cells beside the shard edges and the overlap's frame included).

The number compared is

    err_over_change = max |P - R| / max |R - T0|

over every cell of every shard: the program's widest gap from the
reference, as a share of the most that any cell moved over the run. A
step that returned its state unchanged reads 1; a field that is not
finite reads inf. The limit is the configuration's, set from the
program's readings over a dozen seeds and the float32 control's
(PERF.md gives both readings).
"""

from __future__ import annotations

import math

import torch


def readings(program: torch.Tensor, reference: torch.Tensor, T0: torch.Tensor) -> dict:
    """This shard's widest gap and widest move, in float64 (nan: inf)."""
    P, R = program.to(torch.float64), reference.to(torch.float64)
    gap = float((P - R).abs().max())
    moved = float((R - T0.to(torch.float64)).abs().max())
    return {"max_gap": gap if math.isfinite(gap) else math.inf, "max_moved": moved}


def err_over_change(per_rank: list[dict]) -> float:
    """The compared number over every rank's readings."""
    gap = max(r["max_gap"] for r in per_rank)
    moved = max(r["max_moved"] for r in per_rank)
    if not math.isfinite(gap):
        return math.inf
    return gap / moved if moved > 0 else math.inf


def judge(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit
