"""The overlap (`hide`) variant of the port (rocm_mpi_tpu_torch/parallel/
overlap.py, HeatDiffusion, AcousticWave and ShallowWater "hide") against
the JAX package on the CPU: the frame-width clamp, the box decomposition,
the proof that the interior reads no exchanged ghost, and 4 gloo ranks on
2×2 grids — diffusion `hide` against JAX's and the port's `perf`, wave
`hide` and `perf` against JAX's 4-device runs, the wave deep schedule, one
3D case, and the shallow water's variants and deep schedule against JAX's
4-device runs, with Σh conserved.
One launch of 4 ranks serves every sharded test here
(tests/test_torch_rank_worker.py `run_overlap_rank`).

Tolerances as tests/test_torch_distributed.py: f64 rtol 1e-12, f32 rtol
2e-5 / atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_rank_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.models.swe import ShallowWater as JaxSWE
from rocm_mpi_tpu.models.swe import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.models.wave import AcousticWave as JaxWave
from rocm_mpi_tpu.models.wave import WaveConfig as JaxWaveConfig
from rocm_mpi_tpu.parallel.overlap import effective_b_width as jax_effective_b_width
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import swe as S
from rocm_mpi_tpu_torch.ops import wave as W
from rocm_mpi_tpu_torch.parallel import overlap
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

NPROCS = 4
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}
# Diffusion on a 2×2 grid of 40×36 (shards 20×18): b_width (32, 4) clamps
# to (10, 4), so the axis-0 slabs cover the shard and there is no interior
# box; (4, 3) leaves one.
DIFFUSION = dict(global_shape=(40, 36), lengths=(10.0, 10.0), nt=12, warmup=2, dims=(2, 2))
DIFFUSION_RUNS = [("f64", "hide", (32, 4)), ("f32", "hide", (32, 4)), ("f64", "hide", (4, 3)),
                  ("f32", "hide", (4, 3)), ("f64", "perf", (32, 4)), ("f32", "perf", (32, 4))]
# Wave cases, each from JAX's own initial state: (shape, dims, dtype,
# variant, b_width, steps).
WAVE_CASES = {
    "perf-f64": ((24, 20), (2, 2), "f64", "perf", (32, 4), 20),
    "perf-f32": ((24, 20), (2, 2), "f32", "perf", (32, 4), 20),
    "hide-f64": ((24, 20), (2, 2), "f64", "hide", (32, 4), 20),
    "hide-f32": ((24, 20), (2, 2), "f32", "hide", (32, 4), 20),
    "hide-f64-interior": ((24, 20), (2, 2), "f64", "hide", (3, 3), 20),
    "hide-3d": ((12, 10, 8), (2, 2, 1), "f64", "hide", (32, 4), 10),
}
WAVE_DEEP = dict(global_shape=(24, 20), lengths=(10.0, 10.0), nt=48, warmup=16, dims=(2, 2))
WAVE_DEEP_K = 8
# Shallow-water cases, each from JAX's own initial state: (shape, dims,
# dtype, variant, b_width, steps). b_width (32, 4) on 12×10 shards clamps
# to (6, 4): no interior box; (3, 3) leaves one.
SWE_CASES = {
    "ap-f64": ((24, 20), (2, 2), "f64", "ap", (32, 4), 20),
    "shard-f64": ((24, 20), (2, 2), "f64", "shard", (32, 4), 20),
    "perf-f64": ((24, 20), (2, 2), "f64", "perf", (32, 4), 20),
    "perf-f32": ((24, 20), (2, 2), "f32", "perf", (32, 4), 20),
    "hide-f64": ((24, 20), (2, 2), "f64", "hide", (32, 4), 20),
    "hide-f32": ((24, 20), (2, 2), "f32", "hide", (32, 4), 20),
    "hide-f64-interior": ((24, 20), (2, 2), "f64", "hide", (3, 3), 20),
    "hide-3d": ((12, 10, 8), (2, 2, 1), "f64", "hide", (32, 4), 10),
}
SWE_DEEP = dict(global_shape=(24, 20), lengths=(10.0, 10.0), nt=48, warmup=16, dims=(2, 2))
SWE_DEEP_K = 8


def _wave_cfg(shape, dims, dtype, b_width):
    return dict(global_shape=shape, lengths=(10.0,) * len(shape), nt=40, warmup=8,
                dtype=dtype, dims=dims, b_width=b_width)


def _jax_wave(key):
    shape, dims, dtype, _, bw, _ = WAVE_CASES[key]
    return JaxWave(JaxWaveConfig(**_wave_cfg(shape, dims, dtype, bw)),
                   devices=jax.devices()[:NPROCS])


def _jax_swe(key):
    shape, dims, dtype, _, bw, _ = SWE_CASES[key]
    return JaxSWE(JaxSWEConfig(**_wave_cfg(shape, dims, dtype, bw)),
                  devices=jax.devices()[:NPROCS])


def _swe_images(model):
    h, us = model.init_state()
    return np.asarray(h), [np.asarray(u) for u in us]


@pytest.fixture(scope="module")
def ranks():
    states, runs = {}, {}
    for key, (shape, dims, dtype, variant, bw, n) in WAVE_CASES.items():
        states[key] = tuple(np.asarray(a) for a in _jax_wave(key).init_state())
        runs[key] = dict(cfg=_wave_cfg(shape, dims, dtype, bw), state=key, variant=variant, n=n)
    swe_states, swe_runs = {}, {}
    for key, (shape, dims, dtype, variant, bw, n) in SWE_CASES.items():
        swe_states[key] = _swe_images(_jax_swe(key))
        swe_runs[key] = dict(cfg=_wave_cfg(shape, dims, dtype, bw), state=key,
                             variant=variant, n=n)
    spec = dict(diffusion=DIFFUSION, diffusion_runs=DIFFUSION_RUNS, wave_runs=runs,
                wave_states=states, wave_deep=WAVE_DEEP, wave_deep_k=WAVE_DEEP_K,
                wave_deep_dtypes=("f64", "f32"), swe_runs=swe_runs, swe_states=swe_states,
                swe_deep=SWE_DEEP, swe_deep_k=SWE_DEEP_K, swe_deep_dtypes=("f64", "f32"))
    return spawn_ranks(NPROCS, worker.run_overlap_rank, (spec,), backend="gloo", timeout=300)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("local,bw", [
    ((64, 64), (32, 4)), ((16, 64), (32, 4)), ((3, 3), (32, 32)), ((20, 18), (32, 4)),
    ((12, 10, 8), (32, 4)), ((6144, 6144), (32, 4)), ((5, 9, 7), (2,)), ((2, 2), (1, 1)),
])
def test_effective_b_width_matches_jax(local, bw):
    assert overlap.effective_b_width(local, bw) == jax_effective_b_width(local, bw)


def test_effective_b_width_rejects_degenerate_shards():
    for fn in (overlap.effective_b_width, jax_effective_b_width):
        with pytest.raises(ValueError, match=">= 2 cells"):
            fn((1, 8), (32, 4))


@pytest.mark.parametrize("local,bw", [
    ((20, 18), (10, 4)), ((20, 18), (4, 3)), ((6144, 6144), (32, 4)), ((7, 5), (3, 2)),
    ((12, 10, 8), (6, 4, 4)), ((12, 10, 8), (2, 2, 2)), ((2, 2), (1, 1)),
])
def test_boxes_cover_every_cell_exactly_once(local, bw):
    boxes = overlap.region_boxes(local, bw)
    count = np.zeros(local, np.int32)
    for box in boxes:
        count[tuple(slice(lo, hi) for lo, hi in box)] += 1
    assert (count == 1).all()
    interior = [b for b in boxes if overlap.ghost_free(b, local)]
    has_middle = all(n - 2 * b > 0 for n, b in zip(local, bw))
    assert len(interior) == (1 if has_middle else 0)
    if has_middle:
        assert len(boxes) == 2 * len(local) + 1
        assert interior[0] == tuple((b, n - b) for n, b in zip(local, bw))


def test_mask_boundary_true_is_not_ported():
    grid = GlobalGrid((16, 12), (10.0, 10.0), (1, 1))
    with pytest.raises(NotImplementedError, match="mask_boundary"):
        overlap.make_overlap_step(grid, lambda *a: None, (4, 4), mask_boundary=True)
    # A bf16 wire is accepted; a stateful mode is refused by the exchange
    # when the (stateless) step runs, as in the JAX package.
    overlap.make_overlap_step(grid, lambda *a: None, (4, 4), wire_mode="bf16")
    step = overlap.make_overlap_step(grid, lambda *a: None, (4, 4), wire_mode="int8")
    with pytest.raises(ValueError, match="carries error-feedback state"):
        step(torch.zeros(16, 12), None)
    with pytest.raises(ValueError, match="unknown wire_mode"):
        overlap.make_overlap_step(grid, lambda *a: None, (4, 4), wire_mode="fp8")


# ---------------------------------------------------------------------------
# The interior reads no exchanged ghost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["fused_step_cm", "wave_step_masked", "swe_step"])
@pytest.mark.parametrize("shape,bw", [((24, 20), (4, 3)), ((10, 9, 8), (3, 2, 2))])
def test_nan_poisoned_ghosts_reach_only_the_slabs(shape, bw, kernel):
    # The padded buffer's ghost layers hold NaN (on one rank nothing fills
    # them). The interior box must come back finite and bitwise equal to
    # the clean run — it reads the raw shard — and every slab box must
    # show the NaN: its cells on the shard face read the ghosts.
    grid = GlobalGrid(shape, (10.0,) * len(shape), (1,) * len(shape))
    sp = grid.spacing
    rng = np.random.default_rng(0)
    T = torch.from_numpy(rng.random(shape))
    if kernel == "fused_step_cm":
        C = torch.from_numpy(rng.random(shape) * 1e-3)

        def update(src, off, box, c, out):
            K.fused_step_cm_region(src, off, c, sp, box, out)
    elif kernel == "swe_step":
        # The coupled state: every leaf's padded buffer is poisoned, and the
        # interior's diagonal h' reads must stay inside the shard.
        return _swe_nan_poison(grid, shape, rng)
    else:
        C = (torch.from_numpy(rng.random(shape)), torch.ones(shape, dtype=torch.float64),
             torch.from_numpy(rng.random(shape) * 1e-3))

        def update(src, off, box, aux, out):
            W.wave_step_masked_region(src, off, *aux, sp, box, out)

    step = overlap.make_overlap_step(grid, update, bw)
    clean = step(T, C)
    poison = torch.full(tuple(n + 2 for n in shape), float("nan"), dtype=torch.float64)
    dirty = step(T, C, pad=poison)
    interior = [b for b in step.boxes if overlap.ghost_free(b, shape)]
    assert len(interior) == 1 and len(step.boxes) == 2 * len(shape) + 1
    sl = tuple(slice(lo, hi) for lo, hi in interior[0])
    assert torch.isfinite(dirty[sl]).all()
    assert torch.equal(dirty[sl], clean[sl])
    for box in step.boxes:
        if box != interior[0]:
            assert torch.isnan(dirty[tuple(slice(lo, hi) for lo, hi in box)]).any()
    assert torch.isfinite(clean).all()


def _swe_nan_poison(grid, shape, rng):
    ndim = len(shape)
    state = tuple(torch.from_numpy(rng.random(shape) - 0.5) for _ in range(ndim + 1))
    Mus = tuple(torch.ones(shape, dtype=torch.float64) for _ in range(ndim))
    coeffs = S.swe_coeffs(0.01, grid.spacing, 1.0, 1.0)

    def update(src, off, box, M, out):
        S.swe_step_region(src, off, box, M, coeffs, out)

    step = overlap.make_overlap_step(grid, update, (4, 3) if ndim == 2 else (3, 2, 2))
    clean = step(state, Mus)
    poison = tuple(torch.full(tuple(n + 2 for n in shape), float("nan"), dtype=torch.float64)
                   for _ in state)
    dirty = step(state, Mus, pad=poison)
    # The clean run is perf's step: one exchange of every leaf, then swe_step.
    perf = S.swe_step(tuple(torch.nn.functional.pad(t, (1, 1) * ndim) for t in state), Mus,
                      (1.0, 1.0), 0.01, grid.spacing)
    interior = [b for b in step.boxes if overlap.ghost_free(b, shape)]
    assert len(interior) == 1 and len(step.boxes) == 2 * ndim + 1
    sl = tuple(slice(lo, hi) for lo, hi in interior[0])
    for c, d, p in zip(clean, dirty, perf):
        assert torch.equal(c, p)
        assert torch.isfinite(d[sl]).all()
        assert torch.equal(d[sl], p[sl])
    for box in step.boxes:
        if box != interior[0]:
            cells = tuple(slice(lo, hi) for lo, hi in box)
            assert any(torch.isnan(d[cells]).any() for d in dirty)


def test_overlap_step_takes_a_tuple_of_leaves():
    # A state of several leaves (as the shallow-water model will exchange):
    # each leaf is exchanged, and the update sees the tuples.
    shape = (14, 12)
    grid = GlobalGrid(shape, (10.0, 10.0), (1, 1))
    sp = grid.spacing
    rng = np.random.default_rng(1)
    A, B = (torch.from_numpy(rng.random(shape)) for _ in range(2))
    Cm = torch.from_numpy(rng.random(shape) * 1e-3)

    def update(src, off, box, c, out):
        for s, o in zip(src, out):
            K.fused_step_cm_region(s, off, c, sp, box, o)

    got = overlap.make_overlap_step(grid, update, (3, 3))((A, B), Cm)
    for leaf, g in zip((A, B), got):
        want = K.fused_step_cm(torch.nn.functional.pad(leaf, (1, 1, 1, 1)), Cm, sp)
        assert torch.equal(g, want)


# ---------------------------------------------------------------------------
# 4 gloo ranks on 2×2 grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,variant,bw", DIFFUSION_RUNS)
def test_diffusion_sharded_runs_match_jax_4_device(ranks, dtype, variant, bw):
    got = ranks[0]["diffusion"][(dtype, variant, bw)]
    assert all(r["diffusion"][(dtype, variant, bw)] is None for r in ranks[1:])
    cfg = JaxConfig(**DIFFUSION, dtype=dtype, b_width=bw)
    ref = np.asarray(JaxHeatDiffusion(cfg, devices=jax.devices()[:NPROCS]).run(variant).T)
    assert got.shape == DIFFUSION["global_shape"]
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("bw", [(32, 4), (4, 3)])
def test_diffusion_hide_is_perf_bitwise(ranks, dtype, bw):
    # Every region is the fused_step_cm update of its cells from the same
    # neighbours as the whole-block perf step: the same bits.
    hide = ranks[0]["diffusion"][(dtype, "hide", bw)]
    np.testing.assert_array_equal(hide, ranks[0]["diffusion"][(dtype, "perf", (32, 4))])


@pytest.mark.parametrize("key", sorted(WAVE_CASES))
def test_wave_sharded_advance_matches_jax_4_device(ranks, key):
    shape, _, dtype, variant, _, n = WAVE_CASES[key]
    got = ranks[0]["wave"][key]
    assert all(r["wave"][key] == (None, None) for r in ranks[1:])
    model = _jax_wave(key)
    U, Uprev, C2 = model.init_state()
    want = model.advance_fn(variant)(jnp.copy(U), jnp.copy(Uprev), C2, n)
    for g, w in zip(got, want):  # both leaves of the pair
        assert g.shape == shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_wave_hide_is_perf_bitwise(ranks, dtype):
    # M == 1 gives M·cand + 0·U == cand, and Cw = (dt²·C2)·1 is perf's
    # coefficient: in f32 and f64 the masked region steps are the perf
    # step's bits.
    for h, p in zip(ranks[0]["wave"][f"hide-{dtype}"], ranks[0]["wave"][f"perf-{dtype}"]):
        np.testing.assert_array_equal(h, p)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_wave_run_deep_matches_jax_4_device(ranks, dtype):
    for r in ranks:
        route, k, _ = r["wave_deep"][dtype]
        assert (route, k) == ("vmem", WAVE_DEEP_K)
    got = ranks[0]["wave_deep"][dtype][2]
    ref = JaxWave(JaxWaveConfig(**WAVE_DEEP, dtype=dtype), devices=jax.devices()[:NPROCS])
    want = np.asarray(ref.run_deep(block_steps=WAVE_DEEP_K).U)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("key", sorted(SWE_CASES))
def test_swe_sharded_advance_matches_jax_4_device(ranks, key):
    shape, _, dtype, variant, _, n = SWE_CASES[key]
    got_h, got_us = ranks[0]["swe"][key]
    assert all(r["swe"][key][0] is None for r in ranks[1:])
    model = _jax_swe(key)
    h, us = model.init_state()
    want_h, want_us = model.advance_fn(variant)(h, us, model.face_masks(), n)
    for g, w in zip((got_h, *got_us), (want_h, *want_us)):
        assert g.shape == shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL[dtype])
    # The closed basin conserves Σh over the gathered field.
    h0 = _swe_images(model)[0]
    if dtype == "f64":
        assert abs(got_h.sum() - h0.sum()) <= 1e-13 * abs(h0.sum())


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_swe_hide_is_perf_bitwise(ranks, dtype):
    # Every box recomputes perf's h' from the same neighbours in the same
    # order: the same bits, every leaf.
    for h, p in zip((ranks[0]["swe"][f"hide-{dtype}"][0], *ranks[0]["swe"][f"hide-{dtype}"][1]),
                    (ranks[0]["swe"][f"perf-{dtype}"][0], *ranks[0]["swe"][f"perf-{dtype}"][1])):
        np.testing.assert_array_equal(h, p)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_swe_run_deep_matches_jax_4_device(ranks, dtype):
    for r in ranks:
        route, k = r["swe_deep"][dtype][:2]
        assert (route, k) == ("vmem", SWE_DEEP_K)
    _, _, got_h, got_us = ranks[0]["swe_deep"][dtype]
    ref = JaxSWE(JaxSWEConfig(**SWE_DEEP, dtype=dtype), devices=jax.devices()[:NPROCS])
    want = ref.run_deep(block_steps=SWE_DEEP_K)
    for g, w in zip((got_h, *got_us), (want.h, *want.us)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL[dtype])
    h0 = _swe_images(ref)[0]
    if dtype == "f64":
        assert abs(got_h.sum() - h0.sum()) <= 1e-13 * abs(h0.sum())


def test_sharded_runs_launch_no_kernel_on_cpu(ranks):
    for r in ranks:
        assert set(r["launches"].values()) == {0}
