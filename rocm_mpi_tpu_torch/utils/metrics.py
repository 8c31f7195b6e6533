"""Wall-time timer and the performance metrics — counterpart of
rocm_mpi_tpu/utils/metrics.py.

The reference's one metric is the effective memory throughput
    T_eff = A_eff / wtime_it,  A_eff = 3 · n_cells · itemsize / 1e9 GB
(read T, read Cp, write T2), with wtime_it = wtime / (nt - warmup); the
headline Gpts/s = n_cells / wtime_it / 1e9 is the same measurement per
grid point. CUDA work is asynchronous, so the timer synchronises the
device before reading the host clock.
"""

from __future__ import annotations

import math
import time

import torch

from rocm_mpi_tpu_torch.parallel import distributed


def force(x):
    """Wait until the device work producing `x` is done (a no-op for CPU
    tensors, whose ops complete before returning)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


class Timer:
    """tic/toc wall-time timer (ImplicitGlobalGrid tic()/toc() analog):

        timer.tic(T)              # synchronise on T, then start
        T = advance(T, Cp, n)
        wtime = timer.toc(T)      # synchronise on T, then stop
    """

    def __init__(self):
        self._t0 = None
        self.elapsed = None

    def tic(self, *sync):
        """Start timing, after the device work behind `sync` is done."""
        for x in sync:
            force(x)
        self.elapsed = None
        self._t0 = time.perf_counter()

    def toc(self, *sync) -> float:
        """Stop timing after the device work behind `sync`; returns seconds."""
        for x in sync:
            force(x)
        if self._t0 is None:
            raise RuntimeError("toc() before tic()")
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


def resolve_windows(config, nt: int | None = None,
                    warmup: int | None = None) -> tuple[int, int]:
    """(nt, warmup), each defaulting to the config's; a run needs
    0 <= warmup < nt."""
    nt = config.nt if nt is None else int(nt)
    warmup = config.warmup if warmup is None else int(warmup)
    if not 0 <= warmup < nt:
        raise ValueError(f"need 0 <= warmup < nt, got {warmup}, {nt}")
    return nt, warmup


def timed_window(advance, state, nt: int, warmup: int, sharded: bool = False,
                 group=None):
    """Run `advance(state, n) -> state` over the first `warmup` steps, then
    time it over the other nt - warmup: the device synchronised, and on a
    sharded grid every rank of `group` (None: the default group)
    barriered, on each side of the timed window. `state` is a tensor or a
    tuple led by one. Returns (state, seconds)."""

    def settle(state):
        force(state[0] if isinstance(state, tuple) else state)
        if sharded:
            distributed.barrier(group)

    if warmup:
        state = advance(state, warmup)
    timer = Timer()
    settle(state)
    timer.tic()
    state = advance(state, nt - warmup)
    settle(state)
    return state, timer.toc()


def wtime_per_it(wtime: float, nt: int, warmup: int = 10) -> float:
    """wtime_it = wtime / (nt - warmup)."""
    if nt <= warmup:
        raise ValueError(f"nt={nt} must exceed warmup={warmup}")
    return wtime / (nt - warmup)


def a_eff_gb(shape, itemsize: int, n_passes: int = 3) -> float:
    """A_eff in GB: n_passes whole-array memory passes per step."""
    return n_passes / 1e9 * math.prod(shape) * itemsize


def t_eff_gbs(shape, itemsize: int, wtime_it: float, n_passes: int = 3) -> float:
    """Effective memory throughput T_eff [GB/s]."""
    return a_eff_gb(shape, itemsize, n_passes) / wtime_it


def gpts_per_s(shape, wtime_it: float) -> float:
    """Grid points processed per second [Gpts/s]."""
    return math.prod(shape) / wtime_it / 1e9
