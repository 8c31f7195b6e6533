"""The port's host-staged oracle (rocm_mpi_tpu_torch/parallel/halo.py
HostStagedStepper), its native engine (parallel/native_halo.py over
csrc/halostage.cpp) and the model route (`run("shard")` with
halo_transport="host") against the JAX package's: bitwise in f64, with
and without each wire mode, on 1D, 2D and 3D process grids, on 1 and 4
gloo ranks; the engine's build, its concurrency and its refusals; and
the warnings of the variants that keep their device exchange."""

import multiprocessing
import pathlib
import warnings

import jax
import numpy as np
import pytest

import test_torch_transport_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeat
from rocm_mpi_tpu.models.diffusion import warn_host_transport_ignored as jax_warn
from rocm_mpi_tpu.parallel import wire as jwire
from rocm_mpi_tpu.parallel.halo import HostStagedStepper as JaxStepper
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.parallel import native_halo, wire
from rocm_mpi_tpu_torch.parallel.halo import HostStagedStepper
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOMETRIES = [((64, 48), (4, 2)), ((24, 24, 24), (2, 2, 2)), ((40,), (8,))]
HOST_CFG = dict(global_shape=(32, 24), nt=10, warmup=3, dims=(2, 2))
HOST_RUNS = [("f64", "f32"), ("f64", "bf16"), ("f64", "int8"), ("f64", "int8_delta"),
             ("f32", "f32")]


def _grids(shape, dims):
    spacing = tuple(10.0 / n for n in shape)
    return (wire.OracleGrid(tuple(shape), tuple(dims), spacing),
            jwire._OracleGrid(tuple(shape), tuple(dims), spacing))


def _state(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.random(shape), 1.0 + rng.random(shape)


@pytest.mark.parametrize("mode", wire.WIRE_MODES)
@pytest.mark.parametrize("shape,dims", GEOMETRIES, ids=["2d", "3d", "1d"])
def test_step_python_bitwise_equal_jax(shape, dims, mode):
    ours_grid, jax_grid = _grids(shape, dims)
    T, Cp = _state(shape)
    ours = HostStagedStepper(ours_grid, 1.3, 1e-4, use_native=False, wire_mode=mode)
    theirs = JaxStepper(jax_grid, 1.3, 1e-4, use_native=False, wire_mode=mode)
    a, b = T, T
    for _ in range(4):  # the stateful codecs' state carries across steps
        a, b = ours.step_python(a, Cp), theirs.step_python(b, Cp)
        np.testing.assert_array_equal(a, b)
    if mode != "f32" and len(shape) > 1:  # a one-cell int8 slab is exact
        assert not np.array_equal(a, HostStagedStepper(ours_grid, 1.3, 1e-4, use_native=False)
                                  .run(T, Cp, 4))


@pytest.mark.parametrize("shape,dims", GEOMETRIES[:2], ids=["2d", "3d"])
def test_native_engine_bitwise_equal_numpy(shape, dims):
    grid, _ = _grids(shape, dims)
    T, Cp = _state(shape)
    ref = HostStagedStepper(grid, 1.3, 1e-4, use_native=False).step_python(T, Cp)
    got = native_halo.host_staged_step(T, Cp, dims, grid.spacing, 1.3, 1e-4)
    np.testing.assert_array_equal(ref, got)


def test_native_engine_on_1d_matches_numpy():
    grid, _ = _grids((40,), (8,))
    T, Cp = _state((40,))
    np.testing.assert_array_equal(
        native_halo.host_staged_step(T, Cp, (8,), grid.spacing, 1.3, 1e-4),
        HostStagedStepper(grid, 1.3, 1e-4, use_native=False).step_python(T, Cp))


def test_native_single_thread_matches_threaded():
    grid, _ = _grids((64, 64), (4, 2))
    T, Cp = _state((64, 64), 3)
    a = native_halo.host_staged_step(T, Cp, (4, 2), grid.spacing, 1.0, 1e-4, threads=1)
    b = native_halo.host_staged_step(T, Cp, (4, 2), grid.spacing, 1.0, 1e-4, threads=8)
    np.testing.assert_array_equal(a, b)


def test_native_rejects_bad_geometry():
    with pytest.raises(ValueError, match="code 2"):
        native_halo.host_staged_step(np.zeros((10, 10)), np.ones((10, 10)), (3, 3),
                                     (0.1, 0.1), 1.0, 1e-4)
    # Axes that disagree are refused before any pointer is passed.
    with pytest.raises(ValueError, match="disagree on the axes"):
        native_halo.host_staged_step(np.zeros((10, 10)), np.ones((10, 10)), (2,),
                                     (0.1, 0.1), 1.0, 1e-4)
    with pytest.raises(ValueError, match="disagree on the axes"):
        native_halo.host_staged_step(np.zeros((10, 10)), np.ones((10, 8)), (2, 2),
                                     (0.1, 0.1), 1.0, 1e-4)


def test_stepper_dispatch():
    grid, _ = _grids((32, 32), (2, 2))
    T, Cp = _state((32, 32), 2)
    auto = HostStagedStepper(grid, 1.0, 1e-4)
    assert auto.use_native
    np.testing.assert_array_equal(auto.step(T, Cp), auto.step_python(T, Cp))
    # A reduced wire runs the numpy steps; f32 fields never take the engine.
    assert not HostStagedStepper(grid, 1.0, 1e-4, use_native=True, wire_mode="bf16").use_native
    T32, Cp32 = T.astype(np.float32), Cp.astype(np.float32)
    np.testing.assert_array_equal(auto.step(T32, Cp32), auto.step_python(T32, Cp32))


def test_engine_source_is_the_jax_packages():
    # The port's copy differs from native/halostage.cpp in its header
    # comment only.
    ours = (REPO / "rocm_mpi_tpu_torch/csrc/halostage.cpp").read_text()
    theirs = (REPO / "native/halostage.cpp").read_text()
    key = "// Semantics"
    assert ours[ours.index(key):] == theirs[theirs.index(key):]
    assert native_halo.SOURCE == REPO / "rocm_mpi_tpu_torch/csrc/halostage.cpp"
    assert native_halo.library_path().parent == REPO / "rocm_mpi_tpu_torch/_build"


def _build_in(build_dir, results):
    from rocm_mpi_tpu_torch.parallel import native_halo as nh

    nh.BUILD_DIR = pathlib.Path(build_dir)
    path = nh.build()
    results.put((str(path), nh.available()))


def test_concurrent_builds_are_safe(tmp_path):
    # Four processes build into one empty directory at once: each compiles
    # to a name of its own and renames it into place, so all load.
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_build_in, args=(str(tmp_path), results)) for _ in range(4)]
    for p in procs:
        p.start()
    got = [results.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    assert all(p.exitcode == 0 for p in procs)
    assert {g[0] for g in got} == {str(tmp_path / native_halo.library_path().name)}
    assert all(ok for _, ok in got)
    assert sorted(f.name for f in tmp_path.iterdir()) == [native_halo.library_path().name]


def test_failed_build_raises_when_required(tmp_path, monkeypatch):
    # A source g++ refuses stands for a failed build.
    bad = tmp_path / "halostage.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_halo, "SOURCE", bad)
    monkeypatch.setattr(native_halo, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_halo, "_lib", None)
    monkeypatch.setattr(native_halo, "_error", None)
    grid, _ = _grids((32, 32), (2, 2))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for halostage.cpp"):
        HostStagedStepper(grid, 1.0, 1e-4, use_native=True)
    assert not native_halo.available()
    auto = HostStagedStepper(grid, 1.0, 1e-4)  # None: the numpy steps
    assert not auto.use_native
    T, Cp = _state((32, 32))
    with pytest.raises(RuntimeError, match="unavailable"):
        native_halo.host_staged_step(T, Cp, (2, 2), grid.spacing, 1.0, 1e-4)


# ---------------------------------------------------------------------------
# The model route
# ---------------------------------------------------------------------------


# Both packages start the host-staged run from the JAX package's initial
# state on as many devices (the packages, and JAX on one device and on
# four, compute the Gaussian's exp a unit in the last place apart), so the
# runs are held bitwise.


def _jax_model(dtype, mode, ndev):
    cfg = JaxConfig(**{**HOST_CFG, "dims": (2, 2) if ndev == 4 else (1, 1)}, dtype=dtype,
                    halo_transport="host", wire_mode=mode)
    return JaxHeat(cfg, devices=jax.devices()[:ndev])


def _jax_states(ndev):
    return {dtype: tuple(np.asarray(a) for a in _jax_model(dtype, "f32", ndev).init_state())
            for dtype in ("f64", "f32")}


@pytest.mark.parametrize("dtype,mode", HOST_RUNS)
def test_host_staged_run_on_one_rank_equals_jax(dtype, mode):
    cfg = DiffusionConfig(**{**HOST_CFG, "dims": (1, 1)}, dtype=dtype, halo_transport="host",
                          wire_mode=mode)
    route, got = worker.host_staged_run(cfg, _jax_states(1)[dtype])
    assert route == "host-staged"
    np.testing.assert_array_equal(got, np.asarray(_jax_model(dtype, mode, 1).run("shard").T))


def test_host_staged_run_times_its_steps():
    cfg = DiffusionConfig(**{**HOST_CFG, "dims": (1, 1)}, halo_transport="host")
    res = HeatDiffusion(cfg, device="cpu").run("shard")
    assert res.route == "host-staged" and res.wtime > 0 and res.T.dtype == cfg.torch_dtype
    assert tuple(res.T.shape) == cfg.global_shape


@pytest.fixture(scope="module")
def four_ranks():
    spec = dict(cfg=HOST_CFG, runs=HOST_RUNS, jax_states=_jax_states(4))
    return spawn_ranks(4, worker.run_host_staged_rank, (spec,), backend="gloo", timeout=240)


@pytest.mark.parametrize("dtype,mode", HOST_RUNS)
def test_host_staged_run_on_four_ranks_equals_jax(four_ranks, dtype, mode):
    for out in four_ranks:
        assert out[(dtype, mode)][0] == "host-staged"
    np.testing.assert_array_equal(four_ranks[0][(dtype, mode)][1],
                                  np.asarray(_jax_model(dtype, mode, 4).run("shard").T))


def test_host_staged_f64_matches_the_device_exchange(four_ranks):
    # The oracle and the shard variant's device exchange agree (the
    # bisection the reference's IGG_ROCMAWARE_MPI toggle affords).
    cfg = JaxConfig(**HOST_CFG, dtype="f64")
    ref = np.asarray(JaxHeat(cfg, devices=jax.devices()[:4]).run("shard").T)
    np.testing.assert_allclose(four_ranks[0][("f64", "f32")][1], ref, rtol=1e-12, atol=1e-14)


def _messages(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught]


@pytest.mark.parametrize("variant", ["ap", "fused", "perf", "kp", "hide"])
def test_other_variants_warn_like_jax(variant):
    cfg = DiffusionConfig(**{**HOST_CFG, "dims": (1, 1)}, halo_transport="host")
    model = HeatDiffusion(cfg, device="cpu")
    got = _messages(lambda: model.run(variant))
    want = _messages(lambda: jax_warn(variant, stacklevel=2))
    assert got == want
    assert _messages(lambda: model.run_deep(block_steps=1)) == _messages(
        lambda: jax_warn("deep", stacklevel=2))


def test_host_transport_from_the_environment(monkeypatch):
    monkeypatch.setenv("RMT_HALO_TRANSPORT", "host")
    assert DiffusionConfig().halo_transport == "host"
    monkeypatch.setenv("RMT_HALO_TRANSPORT", "mpi")
    with pytest.raises(ValueError, match="halo_transport"):
        DiffusionConfig()


def test_reduced_wire_on_ap_warns_like_jax():
    cfg = DiffusionConfig(**{**HOST_CFG, "dims": (1, 1)}, wire_mode="bf16")
    model = HeatDiffusion(cfg, device="cpu")
    for variant in ("ap", "fused"):
        msgs = _messages(lambda v=variant: model.run(v))
        assert len(msgs) == 1 and f"wire_mode='bf16' is not honored by variant {variant!r}" \
            in msgs[0]
    assert _messages(lambda: model.run("perf")) == []
