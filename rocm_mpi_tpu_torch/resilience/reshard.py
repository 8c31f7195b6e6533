"""Topology resharding: move a global state between process grids —
counterpart of rocm_mpi_tpu/resilience/reshard.py, on torch.distributed
and the port's own checkpoint layout.

A device dies, a job shrinks, a resumed run lands on another machine:
the decomposition is a run-time variable for state. Given a checkpoint
manifest's topology metadata, or live shards on a grid, this module plans
a valid process grid for the ranks there are now and moves the data.

* `state_meta` — the topology block a manifest records for a state: the
  grid's dims and axis names, and one spec per leaf (the grid's axes for
  a leaf of the grid's local shape, None for a leaf whole on every rank;
  utils/checkpoint.validate_manifest_meta checks it).
* `plan_mesh_dims` — the largest near-square process grid within a rank
  budget whose dims divide every sharded axis of every leaf (the JAX
  package's policy, on the port's `mesh.suggest_dims`).
* `template_from_meta(manifest, grid)` — the restore template from the
  manifest alone: one meta tensor a leaf, of this rank's block shape on
  `grid` and the saved dtype (the ShapeDtypeStruct analog).
* `read_block` — this rank's block of every leaf of a saved step on any
  grid: it reads only the saved shards that overlap the block (a rank of
  3 over a 2×2 save of 12288² reads two 6144² shards, never the field),
  each checked against its manifest crc32.
* `gather_slabs` / `scatter_slabs` / `reshard_state` — live state over
  torch.distributed, on the host: every rank's shards gathered into
  whole fields, then each rank's block of a new grid cut from them
  (fresh tensors: nothing aliases a buffer a loop holds). A
  12288² f32 field is 604 MB on every rank, so live resharding is for
  small states; a run at that size reshards through its checkpoint.
"""

from __future__ import annotations

import math
import pathlib
from typing import Sequence

import numpy as np
import torch

from rocm_mpi_tpu_torch.parallel.mesh import suggest_dims


def state_meta(state, grid=None) -> dict:
    """The topology metadata a manifest records for `state` (this rank's
    shards) on `grid` (None: one rank, whole fields)."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    dims, axes, specs, _ = ckpt._layout(ckpt.tree_leaves(state), grid)
    return {"mesh": {"dims": dims, "axes": axes}, "specs": specs}


def plan_mesh_dims(meta: dict, leaf_shapes: Sequence[Sequence[int]],
                   max_devices: int) -> tuple[int, ...]:
    """The largest valid process grid for a budget of `max_devices` ranks
    given a manifest's topology metadata: the biggest p ≤ max_devices
    whose near-square factorisation divides every sharded axis of every
    leaf (per its recorded spec). p = 1 always works."""
    axes = [str(a) for a in meta["mesh"]["axes"]]
    specs = meta.get("specs") or [None] * len(leaf_shapes)

    def divides(dims) -> bool:
        by_axis = dict(zip(axes, dims))
        for shape, spec in zip(leaf_shapes, specs):
            if spec is None:
                continue
            for size, entry in zip(shape, spec):
                if entry is None:
                    continue
                names = entry if isinstance(entry, (list, tuple)) else (entry,)
                if size % math.prod(by_axis.get(name, 1) for name in names):
                    return False
        return True

    for p in range(int(max_devices), 0, -1):
        dims = suggest_dims(p, len(axes))
        if divides(dims):
            return dims
    raise AssertionError("unreachable: p=1 divides every shape")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _local_shape(rec: dict, spec, dims) -> list[int]:
    """A leaf's block shape on a grid of `dims`: sharded leaves split
    over every axis, others whole."""
    return [n // d for n, d in zip(rec["shape"], dims)] if spec else list(rec["shape"])


def template_from_meta(manifest: dict, grid=None) -> list:
    """The restore template from a v2 manifest alone: a meta tensor per
    leaf, of this rank's block shape on `grid` (None: one rank, whole
    fields) and the saved dtype, in tree order. Raises ValueError on a
    manifest without topology metadata, or a grid that does not divide a
    sharded leaf."""
    meta = manifest.get("meta")
    if not meta:
        raise ValueError("manifest has no topology metadata (v1 manifest)")
    leaves = manifest.get("leaves", [])
    specs = meta.get("specs") or [None] * len(leaves)
    ndim = len(meta["mesh"]["dims"])
    dims = tuple(grid.dims) if grid is not None else (1,) * ndim
    out = []
    for i, (rec, spec) in enumerate(zip(leaves, specs)):
        if spec and any(n % d for n, d in zip(rec["shape"], dims)):
            raise ValueError(f"leaf {i}: global shape {rec['shape']} is not divisible by the "
                             f"process grid {dims}")
        out.append(torch.empty(_local_shape(rec, spec, dims), dtype=_torch_dtype(rec["dtype"]),
                               device="meta"))
    return out


def _bounds(coords, local) -> list[tuple[int, int]]:
    return [(c * n, (c + 1) * n) for c, n in zip(coords, local)]


def _coords(rank: int, dims) -> tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(rank, tuple(dims)))


def read_block(directory, step: int, manifest: dict, grid=None, verify: bool = True,
               read=None) -> list[np.ndarray]:
    """This rank's block on `grid` (None: one rank) of every leaf of the
    step saved in `directory`, as numpy arrays (bf16 as its 16-bit
    pattern), assembled from the saved shards that overlap it — on any
    grid the manifest's shards tile. `read(path) -> ndarray` reads one
    shard file. verify=True checks each shard read against its manifest
    crc32 and raises CheckpointCorruptionError on a mismatch."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    read = read or ckpt._read_array
    meta = manifest["meta"]
    saved_dims = [int(d) for d in meta["mesh"]["dims"]]
    leaves = manifest["leaves"]
    specs = meta.get("specs") or [None] * len(leaves)
    shards = {int(s["rank"]): s for s in manifest.get("shards", [])}
    here_dims = list(grid.dims) if grid is not None else [1] * len(saved_dims)
    here = _coords(0 if grid is None else grid.rank, here_dims)
    step_dir = pathlib.Path(directory) / str(int(step))
    cache: dict[tuple[int, int], np.ndarray] = {}

    def shard(rank: int, i: int) -> np.ndarray:
        key = (rank, i)
        if key not in cache:
            a = read(step_dir / ckpt._leaf_file(rank, i))
            want = shards.get(rank, {}).get("crc32", [None] * len(leaves))[i] \
                if shards else leaves[i].get("crc32")
            if verify and want is not None and ckpt._crc(a) != want:
                raise ckpt.CheckpointCorruptionError(
                    f"step {step} leaf {i}: rank {rank}'s shard crc32 {ckpt._crc(a)} != "
                    f"manifest {want} — restored data is corrupt")
            cache[key] = a
        return cache[key]

    out = []
    for i, (rec, spec) in enumerate(zip(leaves, specs)):
        if not spec:
            out.append(np.array(shard(0, i)))  # whole on every rank: rank 0's copy
            continue
        old_local = _local_shape(rec, spec, saved_dims)
        new_local = _local_shape(rec, spec, here_dims)
        want = _bounds(here, new_local)
        block = None
        for rank in range(math.prod(saved_dims)):
            have = _bounds(_coords(rank, saved_dims), old_local)
            lo = [max(a, c) for (a, _), (c, _) in zip(want, have)]
            hi = [min(b, d) for (_, b), (_, d) in zip(want, have)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            a = shard(rank, i)
            if list(a.shape) != old_local:
                raise ckpt.CheckpointCorruptionError(
                    f"step {step} leaf {i}: rank {rank}'s shard has shape {list(a.shape)}, "
                    f"manifest implies {old_local}")
            if block is None:
                block = np.empty(new_local, dtype=a.dtype)
            src = tuple(slice(l - c, h - c) for l, h, (c, _) in zip(lo, hi, have))
            dst = tuple(slice(l - c, h - c) for l, h, (c, _) in zip(lo, hi, want))
            block[dst] = a[src]
        out.append(block)
        # A block's shards are used once: let them go before the next leaf.
        cache.clear()
    return out


# ---------------------------------------------------------------------------
# Live state: gather to host, scatter onto another grid
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    return ckpt._to_host([t])[0]


def gather_slabs(state, grid=None) -> list[np.ndarray]:
    """Every leaf of `state` (this rank's shards on `grid`; None: one
    process holding whole fields) as a whole field in host memory, on
    every rank of the process group, in tree order (bf16 as its 16-bit
    pattern). Every rank of the group calls it; a rank holding no shard
    (outside the grid) passes state=None and contributes nothing."""
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    mine = None
    if state is not None:
        leaves = ckpt.tree_leaves(state)
        dims, _, specs, shapes = ckpt._layout(leaves, grid)
        mine = dict(rank=0 if grid is None else grid.rank, dims=dims, specs=specs,
                    shapes=shapes, slabs=[_host(t) for t in leaves])
    if distributed.is_distributed() and distributed.world_size() > 1:
        got = [None] * distributed.world_size()
        dist.all_gather_object(got, mine)
    else:
        got = [mine]
    got = [g for g in got if g is not None]
    first = got[0]
    fields = []
    for i, (spec, shape) in enumerate(zip(first["specs"], first["shapes"])):
        if not spec:
            fields.append(first["slabs"][i])
            continue
        whole = np.empty(shape, dtype=first["slabs"][i].dtype)
        for g in got:
            local = g["slabs"][i].shape
            coords = _coords(g["rank"], g["dims"])
            whole[tuple(slice(a, b) for a, b in _bounds(coords, local))] = g["slabs"][i]
        fields.append(whole)
    return fields


def scatter_slabs(slabs, grid=None, like=None, device=None):
    """This rank's blocks on `grid` (None: one rank) of whole host fields
    `slabs`, as fresh tensors on `device` (default: `like`'s leaves', else
    the CPU), arranged as `like` (a tuple of leaves without it). `like`
    also gives each leaf's dtype (bf16 travels as its 16-bit pattern). A
    field of another shape than the grid's global shape is whole on every
    rank."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    leaves = ckpt.tree_leaves(like) if like is not None else None
    out = []
    for i, a in enumerate(slabs):
        if grid is not None and tuple(a.shape) == tuple(grid.global_shape):
            a = a[grid.shard_slices()]
        name = ckpt._dtype_name(leaves[i]) if leaves is not None else str(a.dtype)
        dev = device if device is not None else (leaves[i].device if leaves is not None
                                                 else "cpu")
        out.append(ckpt._tensor(np.ascontiguousarray(a), name, dev))
    return ckpt._unflatten(like, out) if like is not None else tuple(out)


def reshard_state(state, old_grid, new_grid, device=None, like=None):
    """Move live `state` (this rank's shards on `old_grid`) onto
    `new_grid` (this rank's view of another process grid of the same
    domain): gather every field to the host of every rank, then cut this
    rank's block of `new_grid`. The result is fresh tensors on `device`
    (default: the state's), arranged as `like` (default: `state`). Every
    rank of the process group calls it; a rank outside the old grid
    passes state=None (and `like`), one outside the new grid
    new_grid=None and gets None."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    slabs = gather_slabs(state, old_grid)
    if new_grid is None:
        return None
    like = state if like is None else like
    device = device if device is not None else ckpt.tree_leaves(like)[0].device
    return scatter_slabs(slabs, new_grid, like=like, device=device)

