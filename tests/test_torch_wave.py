"""The acoustic-wave workload of the port (rocm_mpi_tpu_torch/ops/wave.py and
models/wave.py) against the JAX package on the CPU, one rank: the three
kernels' plain versions (what a CPU tensor runs) against the Pallas kernels
in interpret mode, every variant and schedule against JAX's from JAX's own
initial state, and the numpy oracle, boundary hold and time reversal of
tests/test_wave.py. The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.

Tolerances: f64 at rtol 1e-12. f32 at rtol 2e-5 / atol 2e-6: XLA's CPU
compile may contract a multiply and an add into one rounding where the
port rounds twice.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_mpi_tpu.models.wave import AcousticWave as JaxWave
from rocm_mpi_tpu.models.wave import WaveConfig as JaxWaveConfig
from rocm_mpi_tpu.ops import wave_kernels as jwk
from rocm_mpi_tpu_torch.config import DiffusionConfig, WaveConfig
from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import wave as W
from rocm_mpi_tpu_torch.state import tensor_from_numpy, wave_state_from_numpy
from test_wave import _numpy_leapfrog

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}
NP = {"f64": np.float64, "f32": np.float32}
EQUAL = {2: (0.1, 0.1), 3: (0.3, 0.3, 0.3)}
UNEQUAL = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}
SHAPES = [(30, 20), (12, 10, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _padded(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Up = rng.random(tuple(n + 2 for n in shape)).astype(dtype)
    Uprev = rng.random(shape).astype(dtype)
    C2 = (0.5 + rng.random(shape)).astype(dtype)
    return Up, Uprev, C2


def _masked(shape, dtype, seed=1):
    """(M, Cw): the interior mask with a few more held cells, Cw = dt²·C2·M."""
    rng = np.random.default_rng(seed)
    M = (rng.random(shape) > 0.1).astype(dtype)
    M[tuple(slice(None) if a else 0 for a in range(len(shape)))] = 0
    Cw = (rng.random(shape) * 1e-3).astype(dtype) * M
    return M, Cw


def _cfg(shape=(24, 20), dtype="f64", nt=40, warmup=8, dims=None, lengths=None, **kw):
    return dict(global_shape=shape, lengths=lengths or (10.0,) * len(shape), nt=nt,
                warmup=warmup, dtype=dtype, dims=dims or (1,) * len(shape), **kw)


def _pair(**kw):
    """(the port's model on the CPU, the JAX model on one device)."""
    cfg = _cfg(**kw)
    return (AcousticWave(WaveConfig(**cfg), device="cpu"),
            JaxWave(JaxWaveConfig(**cfg), devices=jax.devices()[:1]))


# ---------------------------------------------------------------------------
# The three kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wave_step_plain_matches_pallas(shape, dtype):
    Up, Uprev, C2 = _padded(shape, NP[dtype])
    sp, dt = UNEQUAL[len(shape)], 0.013
    ref = np.asarray(jwk.wave_step_padded_pallas(jnp.asarray(Up), jnp.asarray(Uprev),
                                                 jnp.asarray(C2), dt, sp))
    got = W.wave_step(_t(Up), _t(Uprev), _t(C2), dt, sp).numpy()
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    # The field-dtype jnp form is the same function.
    np.testing.assert_allclose(W.wave_step_padded(_t(Up), _t(Uprev), _t(C2), dt, sp).numpy(),
                               ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wave_step_masked_plain_matches_pallas(shape, dtype):
    Up, Uprev, _ = _padded(shape, NP[dtype])
    M, Cw = _masked(shape, NP[dtype])
    sp = UNEQUAL[len(shape)]
    ref = np.asarray(jwk.wave_step_padded_masked_pallas(
        jnp.asarray(Up), jnp.asarray(Uprev), jnp.asarray(M), jnp.asarray(Cw), sp))
    got = W.wave_step_masked(_t(Up), _t(Uprev), _t(M), _t(Cw), sp).numpy()
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    held = M == 0
    np.testing.assert_array_equal(got[held], Up[(slice(1, -1),) * len(shape)][held])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("form", ["aform", "direct"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wave_multi_step_masked_matches_pallas(shape, form, dtype):
    # A held edge (the one-GPU block): the JAX kernel's rolls wrap where the
    # port reads zeros, and both only meet held cells, so the whole block
    # agrees — both leaves of the pair.
    n = 8 if form == "aform" else 3
    sp = EQUAL[len(shape)]
    rng = np.random.default_rng(2)
    U, Uprev = (rng.random(shape).astype(NP[dtype]) for _ in range(2))
    M = np.asarray(jwk.interior_mask(shape, NP[dtype]))
    Cw = (rng.random(shape) * 1e-3).astype(NP[dtype]) * M
    assert W.wave_multi_step_form(n, K.inv_d2_of(sp)) == form
    ref = jwk.wave_multi_step_masked(*(jnp.asarray(a) for a in (U, Uprev, M, Cw)), sp, n)
    got = W.wave_multi_step_masked(_t(U), _t(Uprev), _t(M), _t(Cw), sp, n)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL[dtype])
    edge = K.edge_mask(shape).numpy()
    np.testing.assert_array_equal(got[0].numpy()[edge], U[edge])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("spacing", ["equal", "unequal"])
def test_wave_multi_step_on_a_deep_block_matches_pallas_core(spacing, dtype):
    # A k-padded block whose ghost ring updates (M == 1 there): after n = k
    # steps only the ring can differ, so the core must agree.
    k, shape = 6, (20, 16)
    padded = tuple(s + 2 * k for s in shape)
    rng = np.random.default_rng(3)
    U, Uprev = (rng.random(padded).astype(NP[dtype]) for _ in range(2))
    M = np.ones(padded, NP[dtype])
    Cw = (rng.random(padded) * 1e-3).astype(NP[dtype])
    sp = (EQUAL if spacing == "equal" else UNEQUAL)[2]
    ref = jwk.wave_multi_step_masked(*(jnp.asarray(a) for a in (U, Uprev, M, Cw)), sp, k)
    got = W.wave_multi_step_masked(_t(U), _t(Uprev), _t(M), _t(Cw), sp, k)
    core = tuple(slice(k, -k) for _ in shape)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[core], np.asarray(r)[core], **TOL[dtype])


@pytest.mark.parametrize("form", ["aform", "direct"])
def test_multi_step_forms_agree_in_f64(form):
    # The two bodies are one function in two operation orders.
    shape, sp = (22, 18), EQUAL[2]
    rng = np.random.default_rng(4)
    U, Uprev = (_t(rng.random(shape)) for _ in range(2))
    M = W.interior_mask(shape, torch.float64)
    Cw = _t(rng.random(shape) * 1e-3) * M
    inv = K.inv_d2_of(sp)
    a = W.wave_multi_step_plain(U, Uprev, M, Cw, inv, 7, form)
    b = W.wave_multi_step_plain(U, Uprev, M, Cw, inv, 7, "direct")
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-13, atol=1e-15)


def test_masked_leapfrog_step_and_interior_mask_match_jax():
    shape, sp = (14, 11), UNEQUAL[2]
    rng = np.random.default_rng(5)
    U, Uprev = (rng.random(shape) for _ in range(2))
    M = np.asarray(jwk.interior_mask(shape, np.float64))
    np.testing.assert_array_equal(W.interior_mask(shape, torch.float64).numpy(), M)
    Cw = rng.random(shape) * 1e-3 * M
    inv = K.inv_d2_of(sp)
    ref = jwk.masked_leapfrog_step(*(jnp.asarray(a) for a in (U, Uprev, M, Cw)), inv)
    got = W.masked_leapfrog_step(*(_t(a) for a in (U, Uprev, M, Cw)), inv)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL["f64"])


@pytest.mark.parametrize("kernel", ["wave_step", "wave_step_masked", "wave_multi_step"])
def test_bf16_is_storage_only_rounded_once(kernel):
    # bf16 in, bf16 out, f32 arithmetic in between: equal to the f32 call on
    # the widened inputs rounded once.
    shape, sp = (26, 18), EQUAL[2]
    Up, Uprev, C2 = (tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)))
                     for a in _padded(shape, np.float32))
    M, Cw = (tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)))
             for a in _masked(shape, np.float32))
    if kernel == "wave_step":
        got = (W.wave_step(Up, Uprev, C2, 0.01, sp),)
        once = (W.wave_step(Up.float(), Uprev.float(), C2.float(), 0.01, sp),)
    elif kernel == "wave_step_masked":
        got = (W.wave_step_masked(Up, Uprev, M, Cw, sp),)
        once = (W.wave_step_masked(Up.float(), Uprev.float(), M.float(), Cw.float(), sp),)
    else:
        U = Up[1:-1, 1:-1].contiguous()
        got = W.wave_multi_step_masked(U, Uprev, M, Cw, sp, 8)
        once = W.wave_multi_step_masked(U.float(), Uprev.float(), M.float(), Cw.float(), sp, 8)
    for g, o in zip(got, once):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, o.to(torch.bfloat16))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(16, 12), (8, 7, 6)])
def test_region_form_equals_the_whole_block_on_its_box(shape, offset):
    # A box launch writes exactly its box, with the values the whole-block
    # launch gives there; from the raw shard (offset 0) for a box whose
    # stencil stays inside it, from the padded block otherwise.
    Up, Uprev, C2 = (_t(a) for a in _padded(shape, np.float64))
    M, Cw = (_t(a) for a in _masked(shape, np.float64))
    sp = UNEQUAL[len(shape)]
    box = tuple((1, n - 2) for n in shape) if offset == 0 else tuple((0, n // 2) for n in shape)
    src = Up[(slice(1, -1),) * len(shape)].contiguous() if offset == 0 else Up
    sl = tuple(slice(lo, hi) for lo, hi in box)
    for region, whole, core in (
        (lambda o: W.wave_step_masked_region(src, offset, Uprev, M, Cw, sp, box, o),
         W.wave_step_masked(Up, Uprev, M, Cw, sp), (Uprev, M, Cw)),
        (lambda o: K.fused_step_cm_region(src, offset, Cw, sp, box, o),
         K.fused_step_cm(Up, Cw, sp), (Cw,)),
    ):
        out = torch.full(shape, -7.0, dtype=torch.float64)
        assert region(out) is out
        assert torch.equal(out[sl], whole[sl])
        outside = torch.ones(shape, dtype=torch.bool)
        outside[sl] = False
        assert (out[outside] == -7.0).all()


def test_region_form_rejects_what_it_cannot_do():
    shape, sp = (12, 10), EQUAL[2]
    Up, Uprev, C2 = (_t(a) for a in _padded(shape, np.float64))
    M, Cw = (_t(a) for a in _masked(shape, np.float64))
    raw = Up[1:-1, 1:-1].contiguous()
    out = torch.empty(shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="reads ghost cells"):
        W.wave_step_masked_region(raw, 0, Uprev, M, Cw, sp, ((0, 4), (1, 9)), out)
    with pytest.raises(ValueError, match="empty or outside"):
        K.fused_step_cm_region(Up, 1, Cw, sp, ((3, 3), (0, 10)), out)
    with pytest.raises(ValueError, match="grown by"):
        K.fused_step_cm_region(Up, 0, Cw, sp, ((1, 3), (1, 9)), out)
    with pytest.raises(ValueError, match="must be given"):
        K.fused_step_cm_region(Up, 1, Cw, sp, ((0, 3), (0, 10)), None)
    with pytest.raises(ValueError, match="alias"):
        W.wave_step_masked_region(Up, 1, Uprev, M, Cw, sp, ((0, 3), (0, 10)), Uprev)
    with pytest.raises(TypeError):
        K.fused_step_cm_region(Up, 1, Cw.float(), sp, ((0, 3), (0, 10)), out)


def test_multi_step_wrappers_validate_like_jax():
    rng = np.random.default_rng(6)
    U = _t(rng.random((16, 16)))
    M = W.interior_mask((16, 16), torch.float64)
    with pytest.raises(ValueError, match="shape mismatch"):
        W.wave_multi_step_masked(U, U[:-1], M, M, EQUAL[2], 4)
    big = torch.zeros(600, 600)
    with pytest.raises(ValueError, match="wave VMEM-resident budget"):
        W.wave_multi_step(big, big, big, 0.01, EQUAL[2], 8)
    with pytest.raises(ValueError, match="must divide"):
        W.wave_multi_step(U, U, U, 0.01, EQUAL[2], 10, chunk=4)
    with pytest.raises(ValueError, match="config must be"):
        W.wave_multi_step(U, U, U, 0.01, EQUAL[2], 8, config="fast")
    out = torch.empty_like(U)
    with pytest.raises(ValueError, match="alias"):
        W.leapfrog_multi_step(U, U.clone(), M, M, K.inv_d2_of(EQUAL[2]), 4, "aform",
                              out=(out, U))
    with pytest.raises(ValueError, match="unknown body form"):
        W.leapfrog_multi_step(U, U.clone(), M, M, K.inv_d2_of(EQUAL[2]), 4, "eqc")
    z = W.wave_multi_step_masked(U, U, M, M, EQUAL[2], 0)
    assert torch.equal(z[0], U) and z[0] is not U


def test_wave_multi_step_matches_jax_and_leaves_inputs():
    shape, sp, dt = (24, 24), EQUAL[2], 0.02
    rng = np.random.default_rng(7)
    U, Uprev = (rng.random(shape) for _ in range(2))
    C2 = 0.5 + rng.random(shape)
    Ut, Upt = _t(U), _t(Uprev)
    got = W.wave_multi_step(Ut, Upt, _t(C2), dt, sp, 24, chunk=8)
    ref = jwk.wave_multi_step(jnp.asarray(U), jnp.asarray(Uprev), jnp.asarray(C2), dt, sp, 24,
                              chunk=8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL["f64"])
    assert np.array_equal(Ut.numpy(), U) and np.array_equal(Upt.numpy(), Uprev)


def test_cpu_calls_count_no_launches():
    K.reset_launches()
    shape, sp = (12, 10), EQUAL[2]
    Up, Uprev, C2 = (_t(a) for a in _padded(shape, np.float64))
    M, Cw = (_t(a) for a in _masked(shape, np.float64))
    W.wave_step(Up, Uprev, C2, 0.01, sp)
    W.wave_step_masked(Up, Uprev, M, Cw, sp)
    W.wave_multi_step_masked(Uprev, Uprev.clone(), M, Cw, sp, 4)
    model, _ = _pair(shape=(16, 12), nt=8, warmup=2)
    for variant in AcousticWave.VARIANTS:
        model.run(variant)
    model.run_vmem_resident()
    model.run_deep(block_steps=2)
    assert set(K.LAUNCHES) >= {"wave_step", "wave_step_masked", "wave_multi_step"}
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_other_devices_raise():
    m = torch.empty(8, 8, device="meta")
    p = torch.empty(10, 10, device="meta")
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        W.wave_step(p, m, m, 0.1, EQUAL[2])
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        W.wave_step_masked(p, m, m, m, EQUAL[2])
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        W.leapfrog_multi_step(m, torch.empty(8, 8, device="meta"), m, m, (1.0, 1.0), 4,
                              "aform")


# ---------------------------------------------------------------------------
# The model, one rank
# ---------------------------------------------------------------------------


def _from_jax(model, jstate):
    return wave_state_from_numpy(*(np.asarray(a) for a in jstate), model.grid, device="cpu")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("variant", ["ap", "shard", "perf", "hide"])
@pytest.mark.parametrize("shape", [(24, 20), (12, 10, 8)])
def test_variants_match_jax_advance(shape, variant, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype)
    jstate = ref.init_state()
    want = ref.advance_fn(variant)(*(jnp.copy(a) for a in jstate[:2]), jstate[2], 12)
    got = ours.advance_fn(variant)(*_from_jax(ours, jstate), 12)
    for g, w in zip(got, want):  # both leaves of the pair
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])


def test_init_state_matches_jax():
    # exp rounds a unit apart in places between the two runtimes.
    ours, ref = _pair(shape=(20, 16), dtype="f64")
    (U, Uprev, C2), (Uj, Uprevj, C2j) = ours.init_state(), ref.init_state()
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=1e-15, atol=0)
    assert torch.equal(U, Uprev) and U is not Uprev
    np.testing.assert_array_equal(C2.numpy(), np.asarray(C2j))


def test_matches_numpy_oracle():
    ours, _ = _pair()
    U, Uprev, C2 = ours.init_state()
    cfg = ours.config
    ref = _numpy_leapfrog(U.numpy(), Uprev.numpy(), C2.numpy(), cfg.dt, cfg.spacing, 25)
    got, _ = ours.advance_fn("perf")(U.clone(), Uprev.clone(), C2, 25)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("variant", ["ap", "perf"])
def test_boundary_cells_held(variant):
    ours, _ = _pair()
    U0, Uprev, C2 = ours.init_state()
    got, _ = ours.advance_fn(variant)(U0.clone(), Uprev, C2, 30)
    edge = K.edge_mask(U0.shape)
    assert torch.equal(got[edge], U0[edge])


def test_time_reversal_exact():
    ours, _ = _pair(nt=60)
    U0, Uprev0, C2 = ours.init_state()
    adv = ours.advance_fn("perf")
    n = 60
    U, Uprev = adv(U0.clone(), Uprev0.clone(), C2, n)
    Ub, _ = adv(Uprev, U, C2, n - 1)
    np.testing.assert_allclose(Ub.numpy(), U0.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_one_rank_hide_is_perf_bitwise(dtype):
    ours, _ = _pair(dtype=dtype, nt=16, warmup=4)
    assert torch.equal(ours.run("hide").U, ours.run("perf").U)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,lengths,route_k", [
    ((24, 24), None, 16), ((24, 20), None, 16), ((12, 12, 12), None, 16),
])
def test_run_vmem_resident_matches_jax(shape, lengths, route_k, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype, nt=48, warmup=16, lengths=lengths)
    got = ours.run_vmem_resident()
    assert (got.route, got.k) == ("vmem-loop", route_k)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.run_vmem_resident().U),
                               **TOL[dtype])


def test_run_vmem_resident_chunk_and_validation():
    ours, ref = _pair(shape=(24, 24), nt=20, warmup=4)
    with pytest.warns(UserWarning, match="degraded"):
        got = ours.run_vmem_resident(chunk=8)
    assert got.k == 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(ref.run_vmem_resident(chunk=8).U)
    np.testing.assert_allclose(got.U.numpy(), want, **TOL["f64"])
    with pytest.raises(ValueError, match="config must be"):
        ours.run_vmem_resident(config="fast")
    sharded = AcousticWave(WaveConfig(**_cfg(dims=(2, 1))), grid=_grid((24, 20), (2, 1)),
                           device="cpu")
    with pytest.raises(ValueError, match="unsharded"):
        sharded.run_vmem_resident()


def _grid(shape, dims, rank=0):
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    return init_global_grid(*shape, dims=dims, nprocs=int(np.prod(dims)), rank=rank)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,k", [((24, 20), 8), ((24, 24), 4), ((12, 10, 8), 4)])
def test_run_deep_one_rank_matches_jax(shape, k, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype, nt=48, warmup=16)
    got = ours.run_deep(block_steps=k)
    assert (got.route, got.k) == ("vmem", k)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.run_deep(block_steps=k).U),
                               **TOL[dtype])


def test_run_deep_jnp_route_matches_jax(monkeypatch):
    # A padded pair beyond the (shrunk) budget takes the jnp route on both
    # sides.
    import rocm_mpi_tpu.ops.pallas_kernels as pk
    from rocm_mpi_tpu_torch.ops import multistep

    monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", 1024)
    monkeypatch.setattr(multistep, "_VMEM_BLOCK_BUDGET_BYTES", 1024)
    ours, ref = _pair(shape=(24, 20), nt=24, warmup=8)
    got = ours.run_deep(block_steps=8)
    assert (got.route, got.k) == ("jnp", 8)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.run_deep(block_steps=8).U),
                               **TOL["f64"])


def test_deep_sweep_prepare_matches_jax():
    from rocm_mpi_tpu.parallel import deep_halo as jax_deep
    from rocm_mpi_tpu_torch.parallel import deep_halo

    ours, ref = _pair(shape=(20, 16))
    cfg = ref.config
    jstate = ref.init_state()
    jsched = jax_deep.make_wave_deep_sweep(ref.grid, 4, cfg.jax_dtype(cfg.dt), cfg.spacing)
    jP = jsched.prepare(jstate[2])
    want = jsched.sweep(jstate[0], jstate[1], jP)
    sched = deep_halo.make_wave_deep_sweep(ours.grid, 4, ours.dt_value, cfg.spacing)
    U, Uprev, C2 = _from_jax(ours, jstate)
    P = sched.prepare(C2)
    for g, w in zip(P, jP):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = sched.sweep(U, Uprev, P)
    assert sched.route == "vmem"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL["f64"])


def test_effective_deep_depth_matches_jax_and_oversized_raises():
    ours, ref = _pair(shape=(24, 20), nt=48, warmup=16)
    for block in (None, 8, 24, 3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert (ours.effective_deep_depth(block_steps=block)
                    == ref.effective_deep_depth(block_steps=block))
    sharded = AcousticWave(WaveConfig(**_cfg(dims=(2, 2), nt=48, warmup=16)),
                           grid=_grid((24, 20), (2, 2)), device="cpu")  # shard (12, 10)
    with pytest.raises(ValueError, match="exceeds a local shard extent"):
        sharded.effective_deep_depth(block_steps=16, warn=False)
    assert sharded.effective_deep_depth(block_steps=8, warn=False) == 8
    assert sharded.effective_deep_depth(block_steps=24, warn=False) == 8
    assert sharded.effective_deep_depth(warn=False) == 8


def test_deep_advance_rejects_a_count_the_depth_does_not_divide():
    ours, _ = _pair(nt=48, warmup=16)
    advance, k = ours.deep_advance_fn(block_steps=8)
    U, Uprev, C2 = ours.init_state()
    with pytest.raises(ValueError, match="multiple of the depth"):
        advance(U, Uprev, C2, 12)
    assert k == 8 and advance.schedule.k == 8


def test_run_reports_metrics_and_refuses_what_is_not_ported():
    ours, _ = _pair(nt=24, warmup=8)
    r = ours.run("perf")
    assert r.wtime > 0 and r.gpts > 0 and r.t_eff > 0
    assert tuple(r.U.shape) == (24, 20) and (r.route, r.k) == (None, None)
    assert float(r.U.abs().max()) < 2.0
    assert r.t_eff == pytest.approx(4 * 24 * 20 * 8 / 1e9 / r.wtime_it)
    scan = ours.run("perf", driver="scan")
    assert torch.equal(scan.U, r.U) and (scan.route, scan.k) == ("scan-eager", 8)
    with pytest.raises(ValueError, match="driver"):
        ours.run("perf", driver="loop")
    with pytest.raises(ValueError, match="unknown wave variant"):
        ours.run("kp")
    assert WaveConfig(wire_mode="bf16").wire_mode == "bf16"  # ported
    with pytest.raises(ValueError):
        WaveConfig(wire_mode="f16")


def test_both_models_share_one_timed_window(tmp_path):
    from rocm_mpi_tpu_torch.tuning import resolve
    from rocm_mpi_tpu_torch.utils import metrics

    calls = []

    def advance(state, n):
        calls.append(n)
        return (state[0] + n, state[1])

    state, seconds = metrics.timed_window(advance, (torch.zeros(3), "aux"), 24, 8)
    assert calls == [8, 16] and seconds >= 0
    assert torch.equal(state[0], torch.full((3,), 24.0)) and state[1] == "aux"
    wave_model, _ = _pair(nt=24, warmup=8)
    diff = HeatDiffusion(DiffusionConfig(global_shape=(24, 20), nt=24, warmup=8), device="cpu")
    for model in (wave_model, diff):
        assert metrics.resolve_windows(model.config) == (24, 8)
        assert metrics.resolve_windows(model.config, 12, 0) == (12, 0)
        with pytest.raises(ValueError, match="warmup"):
            model.run("perf", nt=4, warmup=4)
    # `config` reaches the scan driver only, as in JAX; with a cold tuning
    # cache its "auto" is the default chunk, bitwise.
    resolve.configure(tmp_path / "cold.json")
    try:
        assert torch.equal(wave_model.run("perf", config="auto").U, wave_model.run("perf").U)
        auto = wave_model.run("perf", driver="scan", config="auto")
        assert torch.equal(auto.U, wave_model.run("perf", driver="scan").U) and auto.k == 8
    finally:
        resolve.configure(None)


def test_entry_point_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AcousticWave(WaveConfig(**_cfg()))


def test_wave_app_runs_on_cpu(capsys):
    from rocm_mpi_tpu_torch.apps import wave_2d

    base = ["--device", "cpu", "--nx", "24", "--ny", "20", "--nt", "12", "--warmup", "4"]
    for extra in (["--variant", "perf"], ["--variant", "hide"], ["--vmem"], ["--deep", "4"],
                  ["--nz", "8", "--nx", "12", "--ny", "10", "--variant", "shard"]):
        assert wave_2d.main(base + extra) == 0
    text = capsys.readouterr().out
    assert "T_eff" in text and "Gpts/s" in text and "not a GPU measurement" in text
    assert "route vmem-loop" in text and "deep4: route vmem" in text
    with pytest.raises(SystemExit) as exc:
        wave_2d.main(["--deep", "4", "--vmem"])
    assert exc.value.code == 2


def test_hide_app_runs_on_cpu(capsys):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf_hide

    assert diffusion_2d_perf_hide.main(["--device", "cpu", "--nx", "48", "--ny", "40", "--nt",
                                        "12", "--warmup", "4", "--b-width", "8,4"]) == 0
    text = capsys.readouterr().out
    assert "T_eff" in text and "not a GPU measurement" in text
