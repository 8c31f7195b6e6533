"""The port's process grid against the JAX package's device mesh: dims,
local shapes, spacing, cell centres, and each rank's coordinates and shard
bounds, rank r standing where device r stands in the JAX mesh."""

import jax
import numpy as np
import pytest
import torch

from rocm_mpi_tpu.parallel import mesh as jmesh
from rocm_mpi_tpu_torch.parallel import mesh as tmesh

NPROCS = [1, 2, 3, 4, 6, 8]


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_suggest_and_plan_dims_match_jax(ndim):
    for n in range(1, 33):
        assert tmesh.suggest_dims(n, ndim) == jmesh.suggest_dims(n, ndim)
    for shape in [(48, 24, 12)[:ndim], (7, 9, 5)[:ndim], (64, 30, 18)[:ndim]]:
        for n in range(1, 13):
            assert tmesh.plan_dims(shape, n) == jmesh.plan_dims(shape, n)


def _jax_shards(jgrid):
    """{device: tuple of (start, stop)} from the JAX grid's sharding."""
    idx = jgrid.sharding.devices_indices_map(jgrid.global_shape)
    return {
        d: tuple((s.start or 0, s.stop if s.stop is not None else n)
                 for s, n in zip(sl, jgrid.global_shape))
        for d, sl in idx.items()
    }


@pytest.mark.parametrize("nprocs", NPROCS)
@pytest.mark.parametrize("shape", [(48, 24), (24, 12, 12), (96, 36)])
def test_rank_coords_and_shards_match_jax(shape, nprocs):
    devices = jax.devices()[:nprocs]
    jgrid = jmesh.init_global_grid(*shape, devices=devices)
    shards = _jax_shards(jgrid)
    for rank, dev in enumerate(devices):
        tgrid = tmesh.init_global_grid(*shape, nprocs=nprocs, rank=rank)
        assert tgrid.dims == jgrid.dims
        assert tgrid.local_shape == jgrid.local_shape
        assert tgrid.spacing == jgrid.spacing
        assert tgrid.axis_names == jgrid.axis_names
        assert tgrid.nprocs == jgrid.nprocs
        assert tgrid.coords == jgrid.device_coords(dev)
        assert tgrid.shard_bounds() == shards[dev]


@pytest.mark.parametrize("dims", [(4, 2), (2, 4), (8, 1), (1, 1)])
def test_explicit_dims_match_jax(dims):
    n = int(np.prod(dims))
    devices = jax.devices()[:n]
    jgrid = jmesh.init_global_grid(64, 32, dims=dims, devices=devices)
    shards = _jax_shards(jgrid)
    for rank, dev in enumerate(devices):
        tgrid = tmesh.init_global_grid(64, 32, dims=dims, nprocs=n, rank=rank)
        assert tgrid.coords == jgrid.device_coords(dev)
        assert tgrid.shard_bounds() == shards[dev]


def test_trailing_unit_axis_dropped_like_jax():
    jgrid = jmesh.init_global_grid(32, 16, 1, dims=(2, 1, 1), devices=jax.devices()[:2])
    tgrid = tmesh.init_global_grid(32, 16, 1, dims=(2, 1, 1), nprocs=2, rank=1)
    assert tgrid.global_shape == jgrid.global_shape == (32, 16)
    assert tgrid.dims == jgrid.dims


def test_shrunk_dims_warn_like_jax():
    with pytest.warns(UserWarning, match="shrunk"):
        jgrid = jmesh.init_global_grid(30, 7, devices=jax.devices()[:4])
    with pytest.warns(UserWarning, match="shrunk"):
        tgrid = tmesh.init_global_grid(30, 7, nprocs=4, rank=0)
    assert tgrid.dims == jgrid.dims


def test_invalid_grids_raise():
    with pytest.raises(ValueError):
        tmesh.GlobalGrid((30, 30), (1.0, 1.0), (4, 1))
    with pytest.raises(ValueError):
        tmesh.GlobalGrid((32, 32), (1.0, 1.0), (2, 2), rank=4)
    with pytest.raises(ValueError):
        tmesh.init_global_grid(32, 32, dims=(4, 2), nprocs=4)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cell_centres_match_jax(dtype):
    jdt = {"f64": np.float64, "f32": np.float32}[dtype]
    tdt = {"f64": torch.float64, "f32": torch.float32}[dtype]
    devices = jax.devices()[:4]
    jgrid = jmesh.init_global_grid(40, 24, lengths=(10.0, 6.0), devices=devices)
    jc = [np.asarray(c) for c in jgrid.coord_mesh(dtype=jdt)]
    for rank in range(4):
        tgrid = tmesh.init_global_grid(40, 24, lengths=(10.0, 6.0), nprocs=4, rank=rank)
        for ax in range(2):
            np.testing.assert_array_equal(
                tgrid.cell_centers(ax, dtype=tdt).numpy(),
                np.asarray(jgrid.cell_centers(ax, dtype=jdt)),
            )
        sl = tgrid.shard_slices()
        for ax, c in enumerate(tgrid.local_coord_mesh(dtype=tdt)):
            want = jc[ax][tuple(sl[a] if a == ax else slice(None) for a in range(2))]
            np.testing.assert_array_equal(c.numpy(), want)


def test_neighbors_are_the_cartesian_ones():
    grid = tmesh.init_global_grid(32, 32, dims=(2, 2), nprocs=4, rank=0)
    assert grid.neighbor(0, +1) == 2 and grid.neighbor(1, +1) == 1
    assert grid.neighbor(0, -1) is None and grid.neighbor(1, -1) is None
    grid3 = tmesh.init_global_grid(32, 32, dims=(2, 2), nprocs=4, rank=3)
    assert grid3.neighbor(0, -1) == 1 and grid3.neighbor(1, -1) == 2
