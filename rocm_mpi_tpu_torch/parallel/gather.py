"""Gather the global field to rank 0 — counterpart of
rocm_mpi_tpu/parallel/gather.py (the reference's `gather!`) — or to every
rank (`allgather_to_host`, what the host-staged oracle starts from).

Shards do not overlap, so the gather places each rank's shard at its
bounds in one host array. bf16 fields come back as float32 (exact;
numpy has no bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from rocm_mpi_tpu_torch.parallel import distributed
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _sendable(x: torch.Tensor, grid: GlobalGrid) -> torch.Tensor:
    """This rank's shard as the process group can carry it."""
    if tuple(x.shape) != grid.local_shape:
        raise ValueError(f"shard shape {tuple(x.shape)} != {grid.local_shape}")
    x = x.contiguous()
    return x.cpu() if distributed.staged(x) else x


def gather_to_host0(x: torch.Tensor, grid: GlobalGrid) -> np.ndarray | None:
    """The full global field as numpy on rank 0, None on the other ranks."""
    x = _sendable(x, grid)
    if grid.nprocs == 1:
        return _host(x)
    parts = [torch.empty_like(x) for _ in range(grid.nprocs)] if grid.rank == 0 else None
    dist.gather(x, gather_list=parts, dst=0)
    return _assemble(parts, grid) if grid.rank == 0 else None


def _assemble(parts, grid: GlobalGrid) -> np.ndarray:
    """The global field from every rank's shard, in rank order."""
    out = np.empty(grid.global_shape, dtype=_host(parts[0]).dtype)
    for r, part in enumerate(parts):
        out[grid.shard_slices(r)] = _host(part)
    return out


def allgather_to_host(x: torch.Tensor, grid: GlobalGrid) -> np.ndarray:
    """The full global field as numpy on every rank."""
    x = _sendable(x, grid)
    if grid.nprocs == 1:
        return _host(x)
    parts = [torch.empty_like(x) for _ in range(grid.nprocs)]
    dist.all_gather(parts, x)
    return _assemble(parts, grid)
