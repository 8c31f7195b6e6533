"""Gather the global field to rank 0 — counterpart of
rocm_mpi_tpu/parallel/gather.py (the reference's `gather!`).

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


def gather_to_host0(x: torch.Tensor, grid: GlobalGrid) -> np.ndarray | None:
    """The full global field as numpy on rank 0, None on the other ranks."""
    if tuple(x.shape) != grid.local_shape:
        raise ValueError(f"shard shape {tuple(x.shape)} != {grid.local_shape}")
    if grid.nprocs == 1:
        return _host(x)
    x = x.contiguous()
    if x.is_cuda and distributed.backend() == "gloo":
        x = x.cpu()  # gloo carries CPU tensors only
    parts = [torch.empty_like(x) for _ in range(grid.nprocs)] if grid.rank == 0 else None
    dist.gather(x, gather_list=parts, dst=0)
    if grid.rank != 0:
        return None
    out = np.empty(grid.global_shape, dtype=_host(parts[0]).dtype)
    for r, part in enumerate(parts):
        out[grid.shard_slices(r)] = _host(part)
    return out
