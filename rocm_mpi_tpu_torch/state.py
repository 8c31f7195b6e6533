"""Carry a state across from the JAX package.

The JAX package's state is a pair of global fields (T, Cp); its numpy
image (`np.asarray`) is the hand-over format. `state_from_numpy` cuts
this rank's shard out of each and puts it on the device, so both
packages can start from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """A tensor with `a`'s values and dtype. numpy's bfloat16 (ml_dtypes,
    what JAX hands out) has no torch counterpart to share memory with: its
    bits are reinterpreted."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array's buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def state_from_numpy(T_np: np.ndarray, Cp_np: np.ndarray, grid: GlobalGrid,
                     device=None):
    """This rank's shard of the global fields (T, Cp), on `device`."""
    for name, a in (("T", T_np), ("Cp", Cp_np)):
        if tuple(a.shape) != grid.global_shape:
            raise ValueError(f"{name} shape {a.shape} != grid {grid.global_shape}")
    sl = grid.shard_slices()
    return (
        tensor_from_numpy(T_np[sl], device).contiguous(),
        tensor_from_numpy(Cp_np[sl], device).contiguous(),
    )
