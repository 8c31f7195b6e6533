"""Analytic A_eff ideals — counterpart of the analytic half of
rocm_mpi_tpu/perf/traffic.py (its lines 168-215): closed-form bytes a
shard must move per step or sweep, from its shape alone.

The HLO half of the JAX module (the audit of compiled XLA programs) has
no counterpart: the port compiles no XLA program. The tuning gate
(tuning/gate.py) holds each config's modeled bytes against these ideals,
and its wire ladder is parallel/wire.DEFAULT_LADDER.
"""

from __future__ import annotations

import math

from rocm_mpi_tpu_torch.parallel.halo import exchange_nbytes


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def ideal_exchanged_step_bytes(local_shape, itemsize: int, width: int = 1) -> int:
    """Per-shard ideal of ONE exchanged step: the (2+1)-traversal bound
    (read T, write the new field, read C) plus the exchange machinery: one
    padded staging buffer (written once, read once in place of a raw T
    read) and the ghost slices over the wire (read, send, receive, write)."""
    n = _prod(local_shape) * itemsize
    npad = _prod(ln + 2 * width for ln in local_shape) * itemsize
    halo = exchange_nbytes(local_shape, itemsize, width)
    return 3 * n + 2 * npad + 4 * halo


def ideal_deep_sweep_bytes(local_shape, itemsize: int, k: int) -> int:
    """Per-shard ideal of one deep-halo sweep (k steps, one width-k
    exchange): the exchange staging as above, then k local steps, each
    bounded by (2+1) traversals of the PADDED block."""
    n = _prod(local_shape) * itemsize
    npad = _prod(ln + 2 * k for ln in local_shape) * itemsize
    halo = exchange_nbytes(local_shape, itemsize, k)
    return n + npad + 4 * halo + k * 3 * npad


def ideal_wire_bytes(local_shape, itemsize: int, width: int, wire_mode: str = "f32") -> int:
    """Closed-form wire bytes of one exchange at `wire_mode`'s on-wire
    itemsize: the wire-bytes ladder's row anchor."""
    return exchange_nbytes(local_shape, itemsize, width, wire_mode=wire_mode)
