"""The port across 4 gloo ranks (2×2 process grid) against the JAX
package's 4-device mesh: halo exchange, the sharded perf path (exchange +
fused_step_cm's plain version), the ap/fused/shard variants, gather, a
run started from the JAX package's own state, and the deep-halo schedule
on its VMEM and temporal-blocked routes. One launch of 4 ranks
serves every test here (tests/test_torch_rank_worker.py)."""

import jax
import numpy as np
import pytest

import test_torch_rank_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.parallel.halo import HostStagedStepper
from rocm_mpi_tpu.parallel.halo import exchange_halo as jax_exchange_halo
from rocm_mpi_tpu.parallel.mesh import init_global_grid as jax_grid
from rocm_mpi_tpu.utils.compat import shard_map
from rocm_mpi_tpu_torch.parallel.halo import exchange_nbytes
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

NPROCS = 4
SHAPE, DIMS, NT, WARMUP = (32, 24), (2, 2), 8, 2
HALO_CASES = {
    "2x2": ((32, 24), (2, 2)),
    "4x1": ((32, 12), (4, 1)),
    "1x4": ((12, 32), (1, 4)),
    "3d": ((8, 12, 6), (2, 2, 1)),
}
RUNS = [("f64", "perf"), ("f32", "perf"), ("f64", "ap"), ("f64", "fused"),
        ("f64", "shard"), ("f32", "shard")]
# The deep schedule on a 2x2 grid of 48x24: shards of 24x12, k = 4, so the
# k-padded block (32, 20) passes the temporal-blocked route's stripe rule
# when the VMEM budget is shrunk below it.
DEEP = dict(shape=(48, 24), dims=(2, 2), nt=16, warmup=8, k=4, hbm_budget=1024)
DEEP_RUNS = [("f64", "vmem"), ("f32", "vmem"), ("f64", "hbm-tb"), ("f32", "hbm-tb")]
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}


def _jax_model(dtype):
    cfg = JaxConfig(global_shape=SHAPE, nt=NT, warmup=WARMUP, dtype=dtype, dims=DIMS)
    return JaxHeatDiffusion(cfg, devices=jax.devices()[:NPROCS])


@pytest.fixture(scope="module")
def ranks():
    jax_states = {}
    for dtype in ("f64", "f32"):
        T0, Cp = _jax_model(dtype).init_state()
        jax_states[dtype] = (np.asarray(T0), np.asarray(Cp))
    spec = dict(nprocs=NPROCS, halo_cases=HALO_CASES, shape=SHAPE, dims=DIMS,
                nt=NT, warmup=WARMUP, runs=RUNS, jax_states=jax_states,
                deep=DEEP, deep_runs=DEEP_RUNS)
    return spawn_ranks(NPROCS, worker.run_rank, (spec,), backend="gloo", timeout=240)


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_equals_zero_padded_global_slicing(ranks, case):
    # Ghosts, corners included, are the neighbours' cells; zero at the
    # domain edge — i.e. a window of the zero-padded global field.
    shape, dims = HALO_CASES[case]
    G = np.pad(worker.global_field(shape), 1)
    for rank, out in enumerate(ranks):
        grid = init_global_grid(*shape, dims=dims, nprocs=NPROCS, rank=rank)
        window = tuple(slice(a, b + 2) for a, b in grid.shard_bounds())
        np.testing.assert_array_equal(out["halo"][case], G[window])


def test_halo_equals_jax_exchange(ranks):
    shape, dims = HALO_CASES["2x2"]
    jgrid = jax_grid(*shape, dims=dims, devices=jax.devices()[:NPROCS])
    padded = shard_map(
        lambda u: jax_exchange_halo(u, jgrid), mesh=jgrid.mesh,
        in_specs=(jgrid.spec,), out_specs=jgrid.spec,
    )(jax.device_put(worker.global_field(shape), jgrid.sharding))
    padded = np.asarray(padded)
    block = tuple(n + 2 for n in jgrid.local_shape)
    for rank, out in enumerate(ranks):
        c = init_global_grid(*shape, dims=dims, nprocs=NPROCS, rank=rank).coords
        sl = tuple(slice(ci * b, (ci + 1) * b) for ci, b in zip(c, block))
        np.testing.assert_array_equal(out["halo"]["2x2"], padded[sl])


def test_exchange_nbytes_matches_jax():
    from rocm_mpi_tpu.parallel.halo import exchange_nbytes as jax_nbytes

    for local in [(16, 12), (6144, 6144), (4, 6, 3)]:
        for itemsize in (2, 4, 8):
            assert exchange_nbytes(local, itemsize) == jax_nbytes(local, itemsize)


@pytest.mark.parametrize("dtype,variant", RUNS)
def test_sharded_runs_match_jax_4_device(ranks, dtype, variant):
    got = ranks[0]["runs"][(dtype, variant)]
    assert all(r["runs"][(dtype, variant)] is None for r in ranks[1:])  # rank-0 gather
    model = _jax_model(dtype)
    ref = np.asarray(model.run(variant).T)
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_sharded_perf_matches_host_staged_oracle(ranks, dtype):
    model = _jax_model(dtype)
    T0, Cp = model.init_state()
    oracle = HostStagedStepper(model.grid, model.config.lam, model.config.dt)
    ref = oracle.run(np.asarray(T0), np.asarray(Cp), NT)
    np.testing.assert_allclose(ranks[0]["runs"][(dtype, "perf")], ref, **TOL[dtype])


def test_sharded_perf_launches_no_kernel_on_cpu(ranks):
    for out in ranks:
        assert out["launches"] == {"masked_step": 0, "fused_step_cm": 0,
                                   "multi_step_cm": 0, "tb_sweep": 0, "wave_step": 0,
                                   "wave_step_masked": 0, "wave_multi_step": 0,
                                   "swe_step": 0, "swe_multi_step": 0,
                                   "fused_step_padded": 0, "kp_flux": 0, "kp_residual": 0,
                                   "kp_update": 0}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_run_from_jax_state_matches_jax_advance(ranks, dtype):
    model = _jax_model(dtype)
    T0, Cp = model.init_state()
    ref = np.asarray(model.advance_fn("perf")(T0, Cp, NT))
    np.testing.assert_allclose(ranks[0]["from_jax"][dtype], ref, **TOL[dtype])


@pytest.mark.parametrize("dtype,route", DEEP_RUNS)
def test_sharded_deep_matches_jax_4_device(ranks, dtype, route, monkeypatch):
    import rocm_mpi_tpu.ops.pallas_kernels as pk

    for out in ranks:
        got_route, k, _ = out["deep"][(dtype, route)]
        assert (got_route, k) == (route, DEEP["k"])
    got = ranks[0]["deep"][(dtype, route)][2]
    if route == "hbm-tb":
        monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", DEEP["hbm_budget"])
    cfg = JaxConfig(global_shape=DEEP["shape"], nt=DEEP["nt"], warmup=DEEP["warmup"],
                    dtype=dtype, dims=DEEP["dims"])
    ref = np.asarray(JaxHeatDiffusion(cfg, devices=jax.devices()[:NPROCS])
                     .run_deep(block_steps=DEEP["k"]).T)
    assert got.shape == DEEP["shape"]
    np.testing.assert_allclose(got, ref, **TOL[dtype])
