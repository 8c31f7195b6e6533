"""The port's plain ops (rocm_mpi_tpu_torch/ops/stencil.py, ops/diffusion.py)
against the JAX package's on the same numpy-made inputs, in f64 at the
tolerance of tests/test_diffusion_ops.py, plus the analytic golden check."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_mpi_tpu.ops import diffusion as jops
from rocm_mpi_tpu.ops import stencil as jst
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.ops import diffusion as tops
from rocm_mpi_tpu_torch.ops import stencil as tst

RTOL, ATOL = 1e-12, 1e-14
SHAPES = [(33, 47), (16, 9), (12, 13, 14)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.random(shape)
    Cp = 1.0 + rng.random(shape)
    return T, Cp


def _both(fn_j, fn_t, *arrays, args=()):
    got_j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), *args))
    got_t = fn_t(*(torch.from_numpy(a) for a in arrays), *args).numpy()
    return got_j, got_t


@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_helpers_match_jax(shape):
    (T, _) = _inputs(shape)
    for ax in range(len(shape)):
        for fj, ft in ((jst.d_a, tst.d_a), (jst.d_i, tst.d_i)):
            j, t = _both(lambda A: fj(A, ax), lambda A: ft(A, ax), T)
            np.testing.assert_array_equal(t, j)
    j, t = _both(jst.inn, tst.inn, T)
    np.testing.assert_array_equal(t, j)
    j, t = _both(jst.d_yi, tst.d_yi, T)
    np.testing.assert_array_equal(t, j)


def _spacing(ndim):
    return (0.1, 0.07, 0.12)[:ndim]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["step_flux_form", "step_fused"])
def test_global_steps_match_jax(shape, name):
    T, Cp = _inputs(shape)
    args = (1.3, 1e-4, _spacing(len(shape)))
    j, t = _both(getattr(jops, name), getattr(tops, name), T, Cp, args=args)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    # Dirichlet: edge cells pass through bit-unchanged.
    edge = np.ones(shape, bool)
    edge[tuple(slice(1, -1) for _ in shape)] = False
    np.testing.assert_array_equal(t[edge], T[edge])


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_steps_match_jax(shape):
    rng = np.random.default_rng(3)
    Tp = rng.random(tuple(n + 2 for n in shape))
    Cp = 1.0 + rng.random(shape)
    Cm = rng.random(shape) * 1e-4
    Cm[0] = 0.0
    sp = _spacing(len(shape))
    j, t = _both(jops.step_fused_padded, tops.step_fused_padded, Tp, Cp,
                 args=(0.8, 2e-4, sp))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    j, t = _both(jops.step_cm_padded, tops.step_cm_padded, Tp, Cm, args=(sp,))
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    # Held cells (Cm == 0) come back bit-unchanged.
    np.testing.assert_array_equal(t[0], Tp[(1,) + tuple(slice(1, -1) for _ in shape[1:])])


@pytest.mark.parametrize("shape", [(64, 48), (10, 12, 14)])
def test_ic_and_analytic_match_jax(shape):
    lengths = (10.0, 7.0, 5.0)[: len(shape)]
    coords = [(np.arange(n) + 0.5) * l / n for n, l in zip(shape, lengths)]
    mesh = [c.reshape([-1 if a == ax else 1 for a in range(len(shape))])
            for ax, c in enumerate(coords)]
    j = np.asarray(jops.gaussian_ic([jnp.asarray(m) for m in mesh], lengths))
    t = tops.gaussian_ic([torch.from_numpy(m) for m in mesh], lengths).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    j = np.asarray(jops.analytic_solution([jnp.asarray(m) for m in mesh], lengths, 0.9, 0.37))
    t = tops.analytic_solution([torch.from_numpy(m) for m in mesh], lengths, 0.9, 0.37).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    t32 = tops.gaussian_ic([torch.from_numpy(m) for m in mesh], lengths,
                           dtype=torch.float32)
    assert t32.dtype == torch.float32


@pytest.mark.parametrize("variant", ["ap", "perf"])
def test_golden_analytic_gaussian_252(variant):
    # The quantitative form of the reference's smooth-Gaussian acceptance
    # image, at the flagship 252² geometry (bound of test_diffusion_ops).
    cfg = DiffusionConfig(global_shape=(252, 252), nt=400, warmup=0, dims=(1, 1))
    model = HeatDiffusion(cfg, device="cpu")
    res = model.run(variant=variant)
    coords = model.grid.coord_mesh(dtype=torch.float64)
    exact = tops.analytic_solution(coords, cfg.lengths, cfg.lam / cfg.cp0,
                                   cfg.nt * cfg.dt).numpy()
    err = np.abs(res.T.numpy() - exact).max() / exact.max()
    assert err < 2e-3, f"relative max error vs analytic solution: {err}"
