"""Carry a state across from the JAX package.

The JAX package's state is a tuple of global fields — (T, Cp) for
diffusion, (U, U⁻, C2) for the wave, (h, (u0, …)) for the shallow water;
their numpy images (`np.asarray`) are the hand-over format.
`state_from_numpy`, `wave_state_from_numpy` and `swe_state_from_numpy`
cut this rank's shard out of each and put it on the device, so both
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


def shards_from_numpy(fields: dict, grid: GlobalGrid, device=None) -> tuple:
    """This rank's shard of each global field of `fields` ({name: array}),
    contiguous, on `device`, in the dict's order."""
    for name, a in fields.items():
        if tuple(a.shape) != grid.global_shape:
            raise ValueError(f"{name} shape {a.shape} != grid {grid.global_shape}")
    sl = grid.shard_slices()
    return tuple(tensor_from_numpy(a[sl], device).contiguous() for a in fields.values())


def state_from_numpy(T_np: np.ndarray, Cp_np: np.ndarray, grid: GlobalGrid,
                     device=None):
    """This rank's shard of the global diffusion fields (T, Cp), on `device`."""
    return shards_from_numpy({"T": T_np, "Cp": Cp_np}, grid, device)


def wave_state_from_numpy(U_np: np.ndarray, Uprev_np: np.ndarray, C2_np: np.ndarray,
                          grid: GlobalGrid, device=None):
    """This rank's shard of the global wave fields (U, U⁻, C2), on `device`
    — the JAX AcousticWave.init_state's images."""
    return shards_from_numpy({"U": U_np, "Uprev": Uprev_np, "C2": C2_np}, grid, device)


def swe_state_from_numpy(h_np: np.ndarray, us_np, grid: GlobalGrid, device=None):
    """This rank's shard of the global shallow-water state (h, (u0, …)), on
    `device` — the JAX ShallowWater.init_state's images."""
    fields = {"h": h_np, **{f"u{a}": u for a, u in enumerate(us_np)}}
    h, *us = shards_from_numpy(fields, grid, device)
    return h, tuple(us)
