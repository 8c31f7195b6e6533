"""Global grid and cartesian process grid — counterpart of
rocm_mpi_tpu/parallel/mesh.py.

One rank per GPU, as the reference binds one MPI rank per GPU. Rank r
holds the shard at cartesian coordinates `np.unravel_index(r, dims)` —
the position device r takes in the JAX package's mesh
(`np.asarray(devices).reshape(dims)`), so dims, local shapes, coordinates
and shard bounds agree rank for rank. Shards do not overlap; ghost cells
live only in the padded buffer of each exchange (parallel/halo.py).
Cell i along an axis of n cells and length l has its centre at
(i + 0.5)·l/n.

`BatchedGrid` is the space×batch layout of the serving layer
(docs/SERVING.md): `batch` independent lanes of one space grid over
`batch_dims` rows of ranks, each row one space grid. Rank r is in row
r // prod(space_dims) and holds that row's lanes at the space
coordinates of r % prod(space_dims); nothing ever crosses the lane axis.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Sequence

import numpy as np
import torch

AXIS_NAMES = ("gx", "gy", "gz")
BATCH_AXIS = "batch"


def suggest_dims(nprocs: int, ndim: int) -> tuple[int, ...]:
    """Factor `nprocs` into `ndim` near-equal factors, largest first
    (the MPI_Dims_create analog)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if ndim < 1:
        raise ValueError(f"ndim must be >= 1, got {ndim}")
    dims = [1] * ndim
    remaining = nprocs
    for i in range(ndim - 1):
        ideal = round(remaining ** (1.0 / (ndim - i)))
        f = 1
        for cand in range(min(remaining, max(ideal, 1)), 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        dims[i] = f
        remaining //= f
    dims[ndim - 1] = remaining
    dims.sort(reverse=True)
    return tuple(dims)


def plan_dims(global_shape: Sequence[int], max_devices: int) -> tuple[int, ...]:
    """The largest process grid over at most `max_devices` ranks whose
    near-square factorisation divides every grid axis."""
    if max_devices < 1:
        raise ValueError(f"max_devices must be >= 1, got {max_devices}")
    ndim = len(global_shape)
    for p in range(int(max_devices), 0, -1):
        dims = suggest_dims(p, ndim)
        if all(n % d == 0 for n, d in zip(global_shape, dims)):
            return dims
    raise AssertionError("unreachable: p=1 divides every shape")


@dataclasses.dataclass(frozen=True)
class GlobalGrid:
    """A global cartesian grid of cells split over a process grid, seen
    from one rank (`rank`).

    `group` is the process group whose barriers a run on this grid
    takes: None for the default group, or a subgroup of the grid's ranks
    0 … nprocs − 1 when the process group holds more ranks than the grid
    (a weak-scaling rung, apps/weak_scaling.py). Halo messages name
    ranks of the default group, which are the grid's ranks either way.
    `exchange_buffers` holds the halo exchange's persistent slab buffers
    (parallel/halo.py), so a rank's exchanges on this grid allocate once.
    """

    global_shape: tuple[int, ...]
    lengths: tuple[float, ...]
    dims: tuple[int, ...]
    rank: int = 0
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    base: int = 0
    exchange_buffers: dict = dataclasses.field(default_factory=dict, init=False,
                                               compare=False, repr=False)

    def __post_init__(self):
        if len(self.dims) != len(self.global_shape):
            raise ValueError(
                f"global_shape {self.global_shape} rank != dims {self.dims}"
            )
        if len(self.lengths) != len(self.global_shape):
            raise ValueError("lengths rank must match global_shape rank")
        for n, d, name in zip(self.global_shape, self.dims, self.axis_names):
            if n % d != 0:
                raise ValueError(
                    f"global size {n} along '{name}' not divisible by mesh dim {d}"
                )
        if not 0 <= self.rank < self.nprocs:
            raise ValueError(f"rank {self.rank} outside a grid of {self.nprocs}")

    # ---- topology -------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXIS_NAMES[: self.ndim]

    @property
    def nprocs(self) -> int:
        return math.prod(self.dims)

    def rank_coords(self, rank: int) -> tuple[int, ...]:
        """Cartesian coordinates of `rank` in the process grid."""
        return tuple(int(c) for c in np.unravel_index(rank, self.dims))

    def coords_rank(self, coords) -> int | None:
        """Rank at `coords`, or None outside the process grid."""
        if not all(0 <= c < d for c, d in zip(coords, self.dims)):
            return None
        return int(np.ravel_multi_index(tuple(coords), self.dims))

    @property
    def coords(self) -> tuple[int, ...]:
        return self.rank_coords(self.rank)

    def neighbor(self, axis: int, direction: int) -> int | None:
        """Default-group rank one step along `axis` (direction ±1), None
        at the domain edge (non-periodic)."""
        c = list(self.coords)
        c[axis] += direction
        r = self.coords_rank(c)
        return None if r is None else self.base + r

    # ---- shards ---------------------------------------------------------

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // d for n, d in zip(self.global_shape, self.dims))

    def shard_bounds(self, rank: int | None = None) -> tuple[tuple[int, int], ...]:
        """(start, stop) of `rank`'s shard (default this rank) per axis."""
        coords = self.rank_coords(self.rank if rank is None else rank)
        return tuple(
            (c * ln, (c + 1) * ln) for c, ln in zip(coords, self.local_shape)
        )

    def shard_slices(self, rank: int | None = None) -> tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.shard_bounds(rank))

    # ---- geometry -------------------------------------------------------

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(l / n for l, n in zip(self.lengths, self.global_shape))

    def cell_centers(self, axis: int, dtype=torch.float64, device=None) -> torch.Tensor:
        """Global cell-centre coordinates along `axis`."""
        n = self.global_shape[axis]
        d = self.spacing[axis]
        return (torch.arange(n, dtype=dtype, device=device) + 0.5) * d

    def coord_mesh(self, dtype=torch.float64, device=None) -> tuple[torch.Tensor, ...]:
        """Broadcastable global coordinate tensors, one per axis."""
        out = []
        for ax in range(self.ndim):
            shape = [1] * self.ndim
            shape[ax] = self.global_shape[ax]
            out.append(self.cell_centers(ax, dtype, device).reshape(shape))
        return tuple(out)

    def local_coord_mesh(self, dtype=torch.float64, device=None) -> tuple[torch.Tensor, ...]:
        """This rank's slice of `coord_mesh`: the global centres computed
        in `dtype` and cut to the shard, so every rank's values equal the
        corresponding entries of the global coordinates."""
        out = []
        for ax, (a, b) in enumerate(self.shard_bounds()):
            shape = [1] * self.ndim
            shape[ax] = b - a
            out.append(self.cell_centers(ax, dtype, device)[a:b].reshape(shape))
        return tuple(out)


def init_global_grid(
    *global_shape: int,
    lengths: Sequence[float] | None = None,
    dims: Sequence[int] | None = None,
    nprocs: int | None = None,
    rank: int | None = None,
    group=None,
) -> GlobalGrid:
    """Build this rank's view of a GlobalGrid.

    `nprocs` and `rank` default to the process group's world size and
    rank (1 and 0 without one); `group` is the grid's barrier group
    (GlobalGrid.group). Trailing size-1 axes are dropped (the
    reference's `nz=1` idiom). `dims=None` picks the near-square
    factorisation of `nprocs`, shrunk to divide the grid (with a warning
    when ranks are left out, as the JAX package warns about devices).
    """
    from rocm_mpi_tpu_torch.parallel import distributed

    shape = tuple(int(n) for n in global_shape)
    while len(shape) > 1 and shape[-1] == 1:
        shape = shape[:-1]
        if dims is not None and len(dims) == len(shape) + 1 and dims[-1] == 1:
            dims = tuple(dims)[:-1]
    ndim = len(shape)
    if lengths is None:
        lengths = (10.0,) * ndim
    lengths = tuple(float(l) for l in lengths)
    if nprocs is None:
        nprocs = distributed.world_size()
    if rank is None:
        rank = distributed.rank()
    if dims is None:
        dims = suggest_dims(nprocs, ndim)
        dims = tuple(d if n % d == 0 else math.gcd(n, d) for n, d in zip(shape, dims))
        used = math.prod(dims)
        if used < nprocs:
            warnings.warn(
                f"global shape {shape} is not divisible by the natural "
                f"{suggest_dims(nprocs, ndim)} process grid; shrunk to dims "
                f"{dims}, using {used} of {nprocs} ranks. Pass a divisible "
                f"shape (or explicit dims=) to use every rank.",
                stacklevel=2,
            )
    dims = tuple(int(d) for d in dims)
    if math.prod(dims) > nprocs:
        raise ValueError(f"dims {dims} need {math.prod(dims)} ranks, have {nprocs}")
    return GlobalGrid(global_shape=shape, lengths=lengths, dims=dims, rank=rank, group=group)


def rebuild_for_mesh(grid: GlobalGrid, dims: Sequence[int] | None = None,
                     nprocs: int | None = None, rank: int | None = None,
                     group=None) -> GlobalGrid:
    """Re-derive `grid` for a new process grid over the same global
    domain — the JAX package's mesh.rebuild_for_mesh.

    A run checkpointed on one process grid resumes on another, and what
    derives from the decomposition (local shapes, neighbours, the halo
    exchange's buffers, deep-halo schedules) comes from the new dims while
    the global problem (global_shape, lengths) stays. The rebuilt grid is
    a new GlobalGrid with empty `exchange_buffers`, so its exchanges make
    buffers of the new geometry. `dims` defaults to the plan_dims
    sub-grid over `nprocs` ranks (default: the process group's size);
    `rank` defaults to this process's rank. GlobalGrid checks that the
    dims divide the domain, so an invalid explicit dims fails here."""
    from rocm_mpi_tpu_torch.parallel import distributed

    if nprocs is None:
        nprocs = distributed.world_size()
    if dims is None:
        dims = plan_dims(grid.global_shape, nprocs)
    dims = tuple(int(d) for d in dims)
    if len(dims) != grid.ndim:
        raise ValueError(f"dims {dims} rank != grid rank {grid.ndim}")
    if math.prod(dims) > nprocs:
        raise ValueError(f"dims {dims} need {math.prod(dims)} ranks, have {nprocs}")
    if rank is None:
        rank = distributed.rank()
    return GlobalGrid(global_shape=grid.global_shape, lengths=grid.lengths, dims=dims,
                      rank=rank, group=group)


_ROW_GROUPS: dict = {}


def row_group(ranks: tuple[int, ...]):
    """The process group of one batch row's ranks: None when the row is
    the whole default group, else a subgroup made once per set of ranks
    (`dist.new_group`, which every rank of the default group must call in
    the same order: BatchedGrid makes every row's group on every rank)."""
    from rocm_mpi_tpu_torch.parallel import distributed

    if not distributed.is_distributed() or len(ranks) == distributed.world_size():
        return None
    import torch.distributed as dist

    key = (id(dist.group.WORLD), tuple(ranks))
    if key not in _ROW_GROUPS:
        _ROW_GROUPS[key] = dist.new_group(list(ranks))
    return _ROW_GROUPS[key]


@dataclasses.dataclass(frozen=True)
class BatchedGrid:
    """A space×batch process grid, seen from one rank — the JAX package's
    BatchedGrid: `batch` lanes of one space problem over `batch_dims` rows
    of `space_nprocs` ranks each (docs/SERVING.md).

    Batched state is `(lanes, *space shard)`: rank r holds the lanes of
    its row, r // space_nprocs, at the space coordinates of
    r % space_nprocs. `space` is this rank's row's GlobalGrid (its `base`
    the row's first rank, its `group` the row's subgroup), so the halo
    machinery runs on it unchanged and its messages stay inside the row:
    nothing ever crosses the lane axis. A rank beyond the rows
    (`active` False) holds no lane; its `space` is row 0's descriptor.
    """

    batch: int
    space: GlobalGrid
    batch_dims: int
    rank: int = 0

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.batch % self.batch_dims != 0:
            raise ValueError(
                f"batch {self.batch} not divisible by the {self.batch_dims} "
                f"device rows along {BATCH_AXIS!r}")

    # ---- topology -------------------------------------------------------

    @property
    def space_nprocs(self) -> int:
        return self.space.nprocs

    @property
    def nprocs(self) -> int:
        """Ranks the grid spans: batch_dims · space_nprocs."""
        return self.batch_dims * self.space_nprocs

    @property
    def active(self) -> bool:
        """Whether this rank holds lanes (ranks past the rows do not)."""
        return self.rank < self.nprocs

    @property
    def row(self) -> int | None:
        """This rank's batch row, None past the rows."""
        return self.rank // self.space_nprocs if self.active else None

    def row_ranks(self, row: int) -> tuple[int, ...]:
        p = self.space_nprocs
        return tuple(range(row * p, (row + 1) * p))

    @property
    def local_batch(self) -> int:
        """Lanes per batch row."""
        return self.batch // self.batch_dims

    def lane_range(self, row: int | None = None) -> range:
        """The global lanes of `row` (default this rank's; empty past the
        rows)."""
        row = self.row if row is None else row
        if row is None:
            return range(0)
        return range(row * self.local_batch, (row + 1) * self.local_batch)

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.batch_dims,) + self.space.dims

    @property
    def ndim(self) -> int:
        """Rank of the BATCHED state (1 + space rank)."""
        return 1 + self.space.ndim

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (BATCH_AXIS,) + self.space.axis_names

    @property
    def global_shape(self) -> tuple[int, ...]:
        """Batched state shape: (batch, *space global shape)."""
        return (self.batch,) + self.space.global_shape

    @property
    def local_shape(self) -> tuple[int, ...]:
        return (self.local_batch,) + self.space.local_shape

    def local_block(self, full, row: int | None = None):
        """This rank's block `(local lanes, *space shard)` of a full
        batched array (any object indexable by slices: a numpy array or
        a tensor)."""
        lanes = self.lane_range(row)
        return full[(slice(lanes.start, lanes.stop),) + self.space.shard_slices()]


def init_batched_grid(batch: int, *global_shape: int, lengths: Sequence[float] | None = None,
                      space_dims: Sequence[int] | None = None, batch_dims: int = 1,
                      nprocs: int | None = None, rank: int | None = None) -> BatchedGrid:
    """Build this rank's view of a BatchedGrid: `batch` lanes of a
    `global_shape` space grid over `batch_dims` × `space_dims` ranks.

    `nprocs` and `rank` default to the process group's; `space_dims`
    defaults to the largest valid sub-grid over the ranks left after the
    batch rows take theirs (plan_dims). Every rank makes every row's
    subgroup (mesh.row_group), so every rank of the default group must
    build the same grids in the same order."""
    from rocm_mpi_tpu_torch.parallel import distributed

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if batch_dims < 1:
        raise ValueError(f"batch_dims must be >= 1, got {batch_dims}")
    if batch % batch_dims != 0:
        raise ValueError(f"batch {batch} not divisible by batch_dims {batch_dims}")
    shape = tuple(int(n) for n in global_shape)
    ndim = len(shape)
    lengths = (10.0,) * ndim if lengths is None else tuple(float(l) for l in lengths)
    if nprocs is None:
        nprocs = distributed.world_size()
    if rank is None:
        rank = distributed.rank()
    if batch_dims > nprocs:
        raise ValueError(f"batch_dims {batch_dims} needs {batch_dims} devices, have {nprocs}")
    if space_dims is None:
        space_dims = plan_dims(shape, nprocs // batch_dims)
    space_dims = tuple(int(d) for d in space_dims)
    p = math.prod(space_dims)
    need = batch_dims * p
    if need > nprocs:
        raise ValueError(f"batched mesh ({batch_dims}, {space_dims}) needs {need} devices, "
                         f"have {nprocs}")
    groups = [row_group(tuple(range(r * p, (r + 1) * p))) for r in range(batch_dims)]
    row = rank // p if rank < need else 0
    space = GlobalGrid(global_shape=shape, lengths=lengths, dims=space_dims,
                       rank=rank % p if rank < need else 0, group=groups[row], base=row * p)
    return BatchedGrid(batch=int(batch), space=space, batch_dims=int(batch_dims), rank=rank)


def rebuild_batched_for_mesh(bgrid: BatchedGrid, batch: int | None = None,
                             batch_dims: int | None = None, nprocs: int | None = None,
                             rank: int | None = None) -> BatchedGrid:
    """Re-derive a BatchedGrid for a new rank budget or lane width — the
    serving layer's elastic resize. The space problem stays; the space
    dims are plan_dims over the ranks a row gets."""
    from rocm_mpi_tpu_torch.parallel import distributed

    if nprocs is None:
        nprocs = distributed.world_size()
    batch_dims = bgrid.batch_dims if batch_dims is None else batch_dims
    batch = bgrid.batch if batch is None else batch
    space_dims = plan_dims(bgrid.space.global_shape, max(nprocs // batch_dims, 1))
    return init_batched_grid(batch, *bgrid.space.global_shape, lengths=bgrid.space.lengths,
                             space_dims=space_dims, batch_dims=batch_dims, nprocs=nprocs,
                             rank=bgrid.rank if rank is None else rank)
