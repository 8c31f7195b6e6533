"""Frozen copies of the program's rate arithmetic, so that no later change
to the program moves the yardstick.

`gpts_per_s` and `wtime_per_it` are copied from
rocm_mpi_tpu_torch/utils/metrics.py as it stood when the benchmark was
defined; the benchmark imports neither that module nor
rocm_mpi_tpu_torch/perf/traffic.py. (perf/traffic.py's
`ideal_exchanged_step_bytes` still charges a padded staging buffer,
2 * npad, that the face-form `perf` and `hide` steps no longer move; the
byte counts of the rooflines live in stencil_bench/roofline/ instead.)
"""

from __future__ import annotations

import math


def wtime_per_it(wtime: float, nt: int, warmup: int = 10) -> float:
    """wtime_it = wtime / (nt - warmup)."""
    if nt <= warmup:
        raise ValueError(f"nt={nt} must exceed warmup={warmup}")
    return wtime / (nt - warmup)


def gpts_per_s(shape, wtime_it: float) -> float:
    """Grid points processed per second [Gpts/s]."""
    return math.prod(shape) / wtime_it / 1e9
