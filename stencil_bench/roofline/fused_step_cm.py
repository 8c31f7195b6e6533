"""Bytes of one step of `fused_step_cm` (csrc/stencil.cu
`rmt_fused_step_cm`) over a rank's shard, in the face form of the
sharded `perf` and `hide` steps: the least the step's launches must move
together, each input byte read once and each output byte written once.

The launches of a step (one for `perf`, one a box for `hide`) read the
shard's T and the coefficient Cm once, each received face once (a face at
a domain edge is absent and read as zero), and write the new T once.
"""

from __future__ import annotations

import math


def face_cells(local_shape, coords, dims) -> int:
    """Cells of the faces a rank receives: one face of the shard's extent
    across each axis toward each neighbour it has."""
    total = 0
    for ax, n in enumerate(local_shape):
        face = math.prod(local_shape) // n
        total += face * ((coords[ax] > 0) + (coords[ax] < dims[ax] - 1))
    return total


def bytes_per_step(local_shape, itemsize: int, coords, dims) -> int:
    cells = math.prod(local_shape)
    return (3 * cells + face_cells(local_shape, coords, dims)) * int(itemsize)
