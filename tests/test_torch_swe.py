"""The shallow-water workload of the port (rocm_mpi_tpu_torch/ops/swe.py and
models/swe.py) against the JAX package on the CPU, one rank: the two
kernels' plain versions (what a CPU tensor runs) against the Pallas kernels
in interpret mode, every variant and schedule against JAX's from JAX's own
initial state, the admission and route rule, and the numpy oracle, exact
mass conservation, sealed walls and algebraic time reversal of
tests/test_swe.py. The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.

Tolerances: f64 at rtol 1e-12. f32 at rtol 2e-5 / atol 2e-6: XLA's CPU
compile may contract a multiply and an add into one rounding where the
port rounds twice. bf16 at one bf16 unit (rtol 8e-3, atol 8e-3): both
sides compute in f32 and round once, and a contraction in f32 may move a
value across a bf16 rounding boundary.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_mpi_tpu.models.swe import ShallowWater as JaxSWE
from rocm_mpi_tpu.models.swe import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.ops import pallas_kernels as jpk
from rocm_mpi_tpu.ops import swe_kernels as jsk
from rocm_mpi_tpu_torch.config import SWEConfig
from rocm_mpi_tpu_torch.models import ShallowWater
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import multistep
from rocm_mpi_tpu_torch.ops import swe as S
from rocm_mpi_tpu_torch.parallel import deep_halo, overlap
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
from rocm_mpi_tpu_torch.state import swe_state_from_numpy, tensor_from_numpy
from test_swe import _numpy_fb

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6),
       "bf16": dict(rtol=8e-3, atol=8e-3)}
NP = {"f64": np.float64, "f32": np.float32}
SPACING = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}
SHAPES = [(30, 20), (12, 10, 8)]
DT, H, G = 0.013, 1.3, 0.9


def _t(a):
    return torch.from_numpy(np.array(a))


def _coeffs(ndim):
    return S.swe_coeffs(DT, SPACING[ndim], H, G)


def _padded_state(shape, dtype, seed=0):
    """Random width-1-padded leaves (h, u0, …) and core face masks with
    the high wall faces and a few more faces zeroed."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    padded = tuple(n + 2 for n in shape)
    Sp = [rng.random(padded).astype(dtype)]
    Sp += [(rng.random(padded) - 0.5).astype(dtype) for _ in range(ndim)]
    Mus = []
    for a in range(ndim):
        M = (rng.random(shape) > 0.1).astype(dtype)
        M[tuple(slice(-1, None) if ax == a else slice(None) for ax in range(ndim))] = 0
        Mus.append(M)
    return Sp, Mus


def _field_state(shape, dtype, seed=1):
    """Random unpadded (h, us) and the global face masks (0 on each high
    wall face): a one-GPU block whose edge is the domain's."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    h = rng.random(shape).astype(dtype)
    us = [(rng.random(shape) - 0.5).astype(dtype) for _ in range(ndim)]
    Mus = []
    for a in range(ndim):
        M = np.ones(shape, dtype)
        M[tuple(slice(-1, None) if ax == a else slice(None) for ax in range(ndim))] = 0
        us[a] = us[a] * M
        Mus.append(M)
    return h, us, Mus


def _cfg(shape=(24, 20), dtype="f64", nt=40, warmup=8, dims=None, **kw):
    return dict(global_shape=shape, lengths=(10.0,) * len(shape), nt=nt, warmup=warmup,
                dtype=dtype, dims=dims or (1,) * len(shape), **kw)


def _pair(**kw):
    """(the port's model on the CPU, the JAX model on one device)."""
    cfg = _cfg(**kw)
    return (ShallowWater(SWEConfig(**cfg), device="cpu"),
            JaxSWE(JaxSWEConfig(**cfg), devices=jax.devices()[:1]))


def _from_jax(model, jstate):
    h, us = jstate
    return swe_state_from_numpy(np.asarray(h), [np.asarray(u) for u in us], model.grid,
                                device="cpu")


def _close(got, want, dtype):
    got_h, got_us = got
    want_h, want_us = want
    np.testing.assert_allclose(got_h.float().numpy() if dtype == "bf16" else got_h.numpy(),
                               np.asarray(want_h, np.float64 if dtype != "bf16" else np.float32),
                               **TOL[dtype])
    assert len(got_us) == len(want_us)
    for g, w in zip(got_us, want_us):
        g = g.float().numpy() if dtype == "bf16" else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w, g.dtype), **TOL[dtype])


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [2, 3])
def test_swe_coeffs_are_jax_coeffs(ndim):
    assert S.swe_coeffs(DT, SPACING[ndim], H, G) == jsk.swe_coeffs(DT, SPACING[ndim], H, G)
    cfg = _cfg(shape=(24, 20, 16)[:ndim])
    assert SWEConfig(**cfg).dt == JaxSWEConfig(**cfg).dt


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_swe_step_plain_matches_pallas(shape, dtype):
    Sp, Mus = _padded_state(shape, NP[dtype])
    ndim, sp = len(shape), SPACING[len(shape)]
    ref = jsk.swe_step_padded_pallas(tuple(jnp.asarray(a) for a in Sp),
                                     tuple(jnp.asarray(a) for a in Mus), (H, G), DT, sp)
    got = S.swe_step(tuple(_t(a) for a in Sp), tuple(_t(a) for a in Mus), (H, G), DT, sp)
    assert len(got) == ndim + 1
    _close((got[0], got[1:]), (ref[0], ref[1:]), dtype)
    # The field-dtype jnp form is the same function.
    jnp_form = S.swe_step_padded(tuple(_t(a) for a in Sp), tuple(_t(a) for a in Mus), (H, G),
                                 DT, sp)
    _close((jnp_form[0], jnp_form[1:]), (ref[0], ref[1:]), dtype)
    # A zero face mask holds its face at zero.
    for a in range(ndim):
        held = Mus[a] == 0
        assert (got[1 + a].numpy()[held] == 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,bw", [((30, 20), (4, 3)), ((12, 10, 8), (3, 2, 2))])
def test_swe_step_hide_boxes_match_pallas(shape, bw, dtype):
    # The five (seven in 3D) boxes of the hide decomposition, written into
    # one output tuple: the interior from the raw shard, the slabs from the
    # padded leaves. Together they are the whole-block Pallas step.
    Sp, Mus = _padded_state(shape, NP[dtype], seed=2)
    sp = SPACING[len(shape)]
    ref = jsk.swe_step_padded_pallas(tuple(jnp.asarray(a) for a in Sp),
                                     tuple(jnp.asarray(a) for a in Mus), (H, G), DT, sp)
    src = tuple(_t(a) for a in Sp)
    raw = tuple(t[(slice(1, -1),) * len(shape)].contiguous() for t in src)
    out = tuple(torch.full(shape, np.nan, dtype=src[0].dtype) for _ in src)
    boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
    assert len(boxes) == 2 * len(shape) + 1
    for box in boxes:
        inner = overlap.ghost_free(box, shape)
        got = S.swe_step_region(raw if inner else src, 0 if inner else 1, box,
                                tuple(_t(a) for a in Mus), _coeffs(len(shape)), out)
        assert got == out
    _close((out[0], out[1:]), (ref[0], ref[1:]), dtype)
    # The boxes give the whole-block call's bits.
    whole = S.swe_step(src, tuple(_t(a) for a in Mus), (H, G), DT, sp)
    for o, w in zip(out, whole):
        assert torch.equal(o, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_swe_step_bf16_is_storage_only_and_near_pallas(shape):
    Sp32, Mus32 = _padded_state(shape, np.float32, seed=3)
    Sp = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in Sp32]
    Mus = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in Mus32]
    sp = SPACING[len(shape)]
    ref = jsk.swe_step_padded_pallas(tuple(jnp.asarray(a) for a in Sp),
                                     tuple(jnp.asarray(a) for a in Mus), (H, G), DT, sp)
    Spt, Mt = tuple(tensor_from_numpy(a) for a in Sp), tuple(tensor_from_numpy(a) for a in Mus)
    got = S.swe_step(Spt, Mt, (H, G), DT, sp)
    once = S.swe_step(tuple(t.float() for t in Spt), tuple(t.float() for t in Mt), (H, G), DT,
                      sp)
    for g, o in zip(got, once):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, o.to(torch.bfloat16))
    _close((got[0], got[1:]), (np.asarray(ref[0], np.float32),
                               [np.asarray(r, np.float32) for r in ref[1:]]), "bf16")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_swe_multi_step_masked_matches_pallas(shape, n, dtype):
    # The one-GPU block: its edge is the domain's. The JAX kernel's rolls
    # wrap where the port reads zeros; both meet only zero wall faces, so
    # the whole block agrees (up to the sign of a zero).
    h, us, Mus = _field_state(shape, NP[dtype])
    cH, cg = _coeffs(len(shape))
    ref = jsk.swe_multi_step_masked(jnp.asarray(h), tuple(jnp.asarray(u) for u in us),
                                    tuple(jnp.asarray(M) for M in Mus), cH, cg, n)
    got = S.swe_multi_step_masked(_t(h), tuple(_t(u) for u in us), tuple(_t(M) for M in Mus),
                                  cH, cg, n)
    _close(got, ref, dtype)
    for a, u in enumerate(got[1]):
        wall = tuple(slice(-1, None) if ax == a else slice(None) for ax in range(len(shape)))
        assert (u[wall] == 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_swe_multi_step_on_a_deep_block_matches_pallas_core(dtype):
    # A k-padded block whose ghost ring updates (masks 1 there): after k
    # steps only the ring can differ (wrap against zeros), so the core
    # must agree.
    k, shape = 6, (20, 16)
    padded = tuple(s + 2 * k for s in shape)
    rng = np.random.default_rng(4)
    h = rng.random(padded).astype(NP[dtype])
    us = [(rng.random(padded) - 0.5).astype(NP[dtype]) for _ in range(2)]
    Mus = [np.ones(padded, NP[dtype]) for _ in range(2)]
    cH, cg = _coeffs(2)
    ref = jsk.swe_multi_step_masked(jnp.asarray(h), tuple(jnp.asarray(u) for u in us),
                                    tuple(jnp.asarray(M) for M in Mus), cH, cg, k)
    got = S.swe_multi_step_masked(_t(h), tuple(_t(u) for u in us), tuple(_t(M) for M in Mus),
                                  cH, cg, k)
    core = tuple(slice(k, -k) for _ in shape)
    np.testing.assert_allclose(got[0].numpy()[core], np.asarray(ref[0])[core], **TOL[dtype])
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(g.numpy()[core], np.asarray(r)[core], **TOL[dtype])


def test_swe_multi_step_bf16_is_storage_only_rounded_once():
    shape = (22, 18)
    h, us, Mus = _field_state(shape, np.float32, seed=5)
    bf = [tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16))) for a in (h, *us, *Mus)]
    hb, ub, Mb = bf[0], tuple(bf[1:3]), tuple(bf[3:])
    cH, cg = _coeffs(2)
    got = S.swe_multi_step_masked(hb, ub, Mb, cH, cg, 8)
    once = S.swe_multi_step_masked(hb.float(), tuple(u.float() for u in ub),
                                   tuple(M.float() for M in Mb), cH, cg, 8)
    for g, o in zip((got[0], *got[1]), (once[0], *once[1])):
        assert g.dtype == torch.bfloat16 and torch.equal(g, o.to(torch.bfloat16))
    ref = jsk.swe_multi_step_masked(*(jnp.asarray(np.asarray(t.float()), jnp.bfloat16)
                                      for t in (hb,)), tuple(jnp.asarray(
                                          np.asarray(u.float()), jnp.bfloat16) for u in ub),
                                    tuple(jnp.asarray(np.asarray(M.float()), jnp.bfloat16)
                                          for M in Mb), cH, cg, 8)
    _close(got, (np.asarray(ref[0], np.float32), [np.asarray(r, np.float32) for r in ref[1]]),
           "bf16")


def test_masked_swe_step_matches_jax():
    shape = (14, 11)
    h, us, Mus = _field_state(shape, np.float64, seed=6)
    cH, cg = _coeffs(2)
    ref = jsk.masked_swe_step(jnp.asarray(h), tuple(jnp.asarray(u) for u in us),
                              tuple(jnp.asarray(M) for M in Mus), cH, cg)
    got = S.masked_swe_step(_t(h), tuple(_t(u) for u in us), tuple(_t(M) for M in Mus), cH, cg)
    _close(got, ref, "f64")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(16, 12), (8, 7, 6)])
def test_region_form_writes_only_its_box(shape, offset):
    Sp, Mus = (tuple(_t(a) for a in x) for x in _padded_state(shape, np.float64, seed=7))
    box = tuple((1, n - 2) for n in shape) if offset == 0 else tuple((0, n // 2) for n in shape)
    src = tuple(t[(slice(1, -1),) * len(shape)].contiguous() for t in Sp) if offset == 0 else Sp
    sl = tuple(slice(lo, hi) for lo, hi in box)
    out = tuple(torch.full(shape, -7.0, dtype=torch.float64) for _ in Sp)
    assert S.swe_step_region(src, offset, box, Mus, _coeffs(len(shape)), out) == out
    whole = S.swe_step(Sp, Mus, (H, G), DT, SPACING[len(shape)])
    outside = torch.ones(shape, dtype=torch.bool)
    outside[sl] = False
    for o, w in zip(out, whole):
        assert torch.equal(o[sl], w[sl])
        assert (o[outside] == -7.0).all()


def test_region_form_rejects_what_it_cannot_do():
    shape = (12, 10)
    Sp, Mus = (tuple(_t(a) for a in x) for x in _padded_state(shape, np.float64))
    raw = tuple(t[1:-1, 1:-1].contiguous() for t in Sp)
    out = tuple(torch.empty(shape, dtype=torch.float64) for _ in Sp)
    co = _coeffs(2)
    with pytest.raises(ValueError, match="reads ghost cells"):
        S.swe_step_region(raw, 0, ((0, 4), (1, 9)), Mus, co, out)
    with pytest.raises(ValueError, match="empty or outside"):
        S.swe_step_region(Sp, 1, ((3, 3), (0, 10)), Mus, co, out)
    with pytest.raises(ValueError, match="must be given"):
        S.swe_step_region(Sp, 1, ((0, 3), (0, 10)), Mus, co, None)
    with pytest.raises(ValueError, match="alias"):
        S.swe_step_region(Sp, 1, ((0, 3), (0, 10)), Mus, co, (out[0], out[0], out[2]))
    with pytest.raises(ValueError, match="alias"):
        S.swe_step_region(Sp, 1, ((0, 3), (0, 10)), Mus, co, (out[0], Mus[0], out[2]))
    with pytest.raises(ValueError, match="state leaves"):
        S.swe_step_region(Sp[:2], 1, ((0, 3), (0, 10)), Mus, co, out)
    with pytest.raises(TypeError):
        S.swe_step_region((Sp[0], Sp[1].float(), Sp[2]), 1, ((0, 3), (0, 10)), Mus, co, out)


def test_multi_step_wrappers_validate_like_jax():
    h, us, Mus = (np.zeros((16, 16)),) * 3
    ht, ust, Mt = _t(h), (_t(h), _t(h)), (_t(h), _t(h))
    cH, cg = _coeffs(2)
    with pytest.raises(ValueError, match="share one shape"):
        S.swe_multi_step_masked(ht, (ust[0], ust[1][:-1]), Mt, cH, cg, 4)
    with pytest.raises(ValueError, match="velocity fields and masks"):
        S.swe_multi_step_masked(ht, ust[:1], Mt, cH, cg, 4)
    big = torch.zeros(300, 300)  # 8 f32 arrays of 360 KB: over 2 MiB
    with pytest.raises(ValueError, match="VMEM-resident budget"):
        S.swe_multi_step(big, (big, big), (big, big), 0.01, SPACING[2], H, G, 8)
    with pytest.raises(ValueError, match="must divide"):
        S.swe_multi_step(ht, ust, Mt, 0.01, SPACING[2], H, G, 10, chunk=4)
    with pytest.raises(ValueError, match="config must be"):
        S.swe_multi_step(ht, ust, Mt, 0.01, SPACING[2], H, G, 8, config="fast")
    with pytest.raises(ValueError, match="alias"):
        S.fb_multi_step(ht, ust, Mt, cH, cg, 4, out=(ust[0], torch.empty_like(ht),
                                                      torch.empty_like(ht)))
    z = S.swe_multi_step_masked(ht, ust, Mt, cH, cg, 0)
    assert torch.equal(z[0], ht) and z[0] is not ht


def test_swe_multi_step_matches_jax_and_leaves_inputs():
    shape = (24, 24)
    h, us, Mus = _field_state(shape, np.float64, seed=8)
    args = (0.02, SPACING[2], H, G, 24)
    ht, ust = _t(h), tuple(_t(u) for u in us)
    got = S.swe_multi_step(ht, ust, tuple(_t(M) for M in Mus), *args, chunk=8)
    ref = jsk.swe_multi_step(jnp.asarray(h), tuple(jnp.asarray(u) for u in us),
                             tuple(jnp.asarray(M) for M in Mus), *args, chunk=8)
    _close(got, ref, "f64")
    assert np.array_equal(ht.numpy(), h)
    assert all(np.array_equal(u.numpy(), w) for u, w in zip(ust, us))


def _jax_admitted(shape, dtype):
    """The JAX rule of swe_kernels.py:219-225 and deep_halo.py:501."""
    nbytes = (3 * len(shape) + 2) * jpk._compute_nbytes(jnp.zeros(shape, dtype))
    return nbytes <= jpk._VMEM_BLOCK_BUDGET_BYTES


@pytest.mark.parametrize("shape,dtype,admitted", [
    ((252, 252), "f32", True), ((252, 252), "bf16", True), ((252, 252), "f64", False),
    ((268, 268), "f32", False), ((256, 256), "f32", True), ((181, 181), "f64", True),
    ((182, 182), "f64", False), ((32, 24, 24), "f64", True),
])
def test_admission_and_route_follow_the_jax_rule(shape, dtype, admitted):
    from rocm_mpi_tpu_torch.config import DTYPES

    jdt = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[dtype]
    assert _jax_admitted(shape, jdt) is admitted
    assert S.swe_admitted(shape, DTYPES[dtype]) is admitted
    assert deep_halo.swe_local_route(shape, DTYPES[dtype]) == ("vmem" if admitted else "jnp")


def test_vmem_resident_admission_at_252():
    # 252² f32 runs the loop; 252² f64 raises, as the JAX package does.
    for dtype, ok in (("f32", True), ("f64", False)):
        ours, ref = _pair(shape=(252, 252), dtype=dtype, nt=2, warmup=0)
        if ok:
            assert ours.run_vmem_resident(chunk=2).route == "vmem-loop"
            continue
        with pytest.raises(ValueError, match="VMEM-resident budget"):
            ours.run_vmem_resident(chunk=2)
        with pytest.raises(ValueError, match="VMEM-resident budget"):
            ref.run_vmem_resident(chunk=2)


def test_cpu_calls_count_no_launches():
    K.reset_launches()
    Sp, Mus = (tuple(_t(a) for a in x) for x in _padded_state((12, 10), np.float64))
    S.swe_step(Sp, Mus, (H, G), DT, SPACING[2])
    h, us, Ms = _field_state((12, 10), np.float64)
    S.swe_multi_step_masked(_t(h), tuple(_t(u) for u in us), tuple(_t(M) for M in Ms),
                            *_coeffs(2), 4)
    model, _ = _pair(shape=(16, 12), nt=8, warmup=2)
    for variant in ShallowWater.VARIANTS:
        model.run(variant)
    model.run_vmem_resident()
    model.run_deep(block_steps=2)
    assert {"swe_step", "swe_multi_step"} <= set(K.LAUNCHES)
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_other_devices_raise():
    m = torch.empty(8, 8, device="meta")
    p = tuple(torch.empty(10, 10, device="meta") for _ in range(3))
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        S.swe_step(p, (m, torch.empty(8, 8, device="meta")), (H, G), DT, SPACING[2])
    us = (torch.empty(8, 8, device="meta"), torch.empty(8, 8, device="meta"))
    Ms = (torch.empty(8, 8, device="meta"), torch.empty(8, 8, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        S.fb_multi_step(m, us, Ms, *_coeffs(2), 4)


# ---------------------------------------------------------------------------
# The model, one rank
# ---------------------------------------------------------------------------


def test_init_state_and_face_masks_match_jax():
    # exp rounds a unit apart in places between the two runtimes.
    ours, ref = _pair(shape=(20, 16))
    (h, us), (hj, usj) = ours.init_state(), ref.init_state()
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-15, atol=0)
    assert len(us) == 2 and all((u == 0).all() for u in us)
    for M, Mj in zip(ours.face_masks(), ref.face_masks()):
        np.testing.assert_array_equal(M.numpy(), np.asarray(Mj))
    # The hand-over carries JAX's images bit for bit.
    hh, uh = _from_jax(ours, (hj, usj))
    np.testing.assert_array_equal(hh.numpy(), np.asarray(hj))
    assert len(uh) == 2


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("variant", ["ap", "shard", "perf", "hide"])
@pytest.mark.parametrize("shape", [(24, 20), (12, 10, 8)])
def test_variants_match_jax_advance(shape, variant, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype)
    jh, jus = ref.init_state()
    want = ref.advance_fn(variant)(jnp.copy(jh), tuple(map(jnp.copy, jus)), ref.face_masks(),
                                   12)
    h, us = _from_jax(ours, (jh, jus))
    got = ours.advance_fn(variant)(h, us, ours.face_masks(), 12)
    _close(got, want, dtype)


def test_matches_numpy_oracle():
    ours, _ = _pair()
    cfg = ours.config
    h0, us0 = ours.init_state()
    ref_h, ref_us = _numpy_fb(h0.numpy(), [u.numpy() for u in us0], cfg.dt, cfg.spacing,
                              cfg.H0, cfg.g, 25)
    for variant in ("ap", "perf"):
        h, us = ours.advance_fn(variant)(h0.clone(), tuple(u.clone() for u in us0),
                                         ours.face_masks(), 25)
        np.testing.assert_allclose(h.numpy(), ref_h, rtol=1e-12)
        for g, r in zip(us, ref_us):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("variant", ["ap", "perf"])
def test_mass_exactly_conserved(variant):
    # 200 f64 steps: the closed-basin divergence telescopes to 0.
    ours, _ = _pair(nt=200, warmup=0)
    h0, us0 = ours.init_state()
    mass0 = float(h0.sum(dtype=torch.float64))
    h, _ = ours.advance_fn(variant)(h0.clone(), us0, ours.face_masks(), 200)
    assert abs(float(h.sum(dtype=torch.float64)) - mass0) <= 1e-13 * abs(mass0)


@pytest.mark.parametrize("variant", ["ap", "perf"])
def test_wall_faces_stay_exactly_zero(variant):
    ours, _ = _pair()
    h0, us0 = ours.init_state()
    _, us = ours.advance_fn(variant)(h0, us0, ours.face_masks(), 30)
    for a, u in enumerate(us):
        wall = tuple(slice(-1, None) if ax == a else slice(None) for ax in range(2))
        assert (u[wall] == 0).all()
        assert float(u.abs().max()) > 0


def test_time_reversal_algebraic():
    # The forward-backward map has a closed-form inverse (test_swe.py:130):
    # undo the velocity update, then the height update, n times.
    ours, _ = _pair(nt=60)
    h0, us0 = ours.init_state()
    Mus = ours.face_masks()
    n = 40
    h, us = ours.advance_fn("perf")(h0.clone(), tuple(u.clone() for u in us0), Mus, n)
    cH, cg = ours.coeffs
    for _ in range(n):
        us = tuple(u + cg[a] * Mus[a] * (torch.roll(h, -1, a) - h) for a, u in enumerate(us))
        h = h + sum(cH[a] * (u - torch.roll(u, 1, a)) for a, u in enumerate(us))
    np.testing.assert_allclose(h.numpy(), h0.numpy(), rtol=1e-11, atol=1e-13)
    for u, u0 in zip(us, us0):
        np.testing.assert_allclose(u.numpy(), u0.numpy(), atol=1e-13)


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_one_rank_hide_is_perf_bitwise(dtype):
    ours, _ = _pair(dtype=dtype, nt=16, warmup=4)
    a, b = ours.run("hide"), ours.run("perf")
    assert torch.equal(a.h, b.h) and all(torch.equal(x, y) for x, y in zip(a.us, b.us))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,route_k", [((24, 24), 16), ((24, 20), 16),
                                           ((12, 12, 12), 16)])
def test_run_vmem_resident_matches_jax(shape, route_k, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype, nt=48, warmup=16)
    got = ours.run_vmem_resident()
    assert (got.route, got.k) == ("vmem-loop", route_k)
    want = ref.run_vmem_resident()
    _close((got.h, got.us), (want.h, want.us), dtype)


def test_run_vmem_resident_chunk_and_validation():
    ours, ref = _pair(shape=(24, 24), nt=20, warmup=4)
    with pytest.warns(UserWarning, match="degraded"):
        got = ours.run_vmem_resident(chunk=8)
    assert got.k == 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.run_vmem_resident(chunk=8)
    _close((got.h, got.us), (want.h, want.us), "f64")
    with pytest.raises(ValueError, match="config must be"):
        ours.run_vmem_resident(config="fast")
    sharded = ShallowWater(SWEConfig(**_cfg(dims=(2, 1))), grid=_grid((24, 20), (2, 1)),
                           device="cpu")
    with pytest.raises(ValueError, match="unsharded"):
        sharded.run_vmem_resident()


def _grid(shape, dims, rank=0):
    return init_global_grid(*shape, dims=dims, nprocs=int(np.prod(dims)), rank=rank)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,k", [((24, 20), 8), ((24, 24), 4), ((12, 10, 8), 4)])
def test_run_deep_one_rank_matches_jax(shape, k, dtype):
    ours, ref = _pair(shape=shape, dtype=dtype, nt=48, warmup=16)
    got = ours.run_deep(block_steps=k)
    assert (got.route, got.k) == ("vmem", k)
    want = ref.run_deep(block_steps=k)
    _close((got.h, got.us), (want.h, want.us), dtype)


def test_run_deep_jnp_route_matches_jax(monkeypatch):
    # A padded state beyond the (shrunk) budget takes the jnp route on both
    # sides.
    monkeypatch.setattr(jpk, "_VMEM_BLOCK_BUDGET_BYTES", 1024)
    monkeypatch.setattr(multistep, "_VMEM_BLOCK_BUDGET_BYTES", 1024)
    ours, ref = _pair(shape=(24, 20), nt=24, warmup=8)
    got = ours.run_deep(block_steps=8)
    assert (got.route, got.k) == ("jnp", 8)
    want = ref.run_deep(block_steps=8)
    _close((got.h, got.us), (want.h, want.us), "f64")


def test_deep_sweep_prepare_matches_jax():
    from rocm_mpi_tpu.parallel import deep_halo as jax_deep

    ours, ref = _pair(shape=(20, 16))
    cfg = ref.config
    jh, jus = ref.init_state()
    jsched = jax_deep.make_swe_deep_sweep(ref.grid, 4, cfg.dt, cfg.spacing, cfg.H0, cfg.g)
    jMp = jsched.prepare(jh)
    want = jsched.sweep(jh, jus, jMp)
    sched = deep_halo.make_swe_deep_sweep(ours.grid, 4, ours.config.dt, cfg.spacing, cfg.H0,
                                          cfg.g)
    h, us = _from_jax(ours, (jh, jus))
    Mp = sched.prepare(h)
    for g, w in zip(Mp, jMp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = sched.sweep(h, us, Mp)
    assert sched.route == "vmem"
    _close(got, want, "f64")


def test_effective_deep_depth_matches_jax_and_oversized_raises():
    ours, ref = _pair(shape=(24, 20), nt=48, warmup=16)
    for block in (None, 8, 24, 3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert (ours.effective_deep_depth(block_steps=block)
                    == ref.effective_deep_depth(block_steps=block))
    sharded = ShallowWater(SWEConfig(**_cfg(dims=(2, 2), nt=48, warmup=16)),
                           grid=_grid((24, 20), (2, 2)), device="cpu")  # shard (12, 10)
    with pytest.raises(ValueError, match="exceeds a local shard extent"):
        sharded.effective_deep_depth(block_steps=16, warn=False)
    with pytest.raises(ValueError, match="exceeds a local shard extent"):
        sharded.run_deep(nt=64, warmup=0, block_steps=64)
    assert sharded.effective_deep_depth(block_steps=8, warn=False) == 8
    assert sharded.effective_deep_depth(warn=False) == 8


def test_deep_advance_rejects_a_count_the_depth_does_not_divide():
    ours, _ = _pair(nt=48, warmup=16)
    advance, k = ours.deep_advance_fn(block_steps=8)
    h, us = ours.init_state()
    with pytest.raises(ValueError, match="multiple of the depth"):
        advance(h, us, ours.face_masks(), 12)
    assert k == 8 and advance.schedule.k == 8


def test_run_reports_metrics_and_refuses_what_is_not_ported():
    ours, _ = _pair(nt=24, warmup=8)
    r = ours.run("perf")
    assert r.wtime > 0 and r.gpts > 0 and r.t_eff > 0
    assert tuple(r.h.shape) == (24, 20) and (r.route, r.k) == (None, None)
    assert r.t_eff == pytest.approx(6 * 24 * 20 * 8 / 1e9 / r.wtime_it)
    scan = ours.run("perf", driver="scan")
    assert torch.equal(scan.h, r.h) and all(torch.equal(a, b) for a, b in zip(scan.us, r.us))
    assert (scan.route, scan.k) == ("scan-eager", 8)
    with pytest.raises(ValueError, match="driver"):
        ours.run("perf", driver="loop")
    with pytest.raises(ValueError, match="unknown SWE variant"):
        ours.run("kp")
    assert SWEConfig(wire_mode="bf16").wire_mode == "bf16"  # ported
    with pytest.raises(ValueError):
        SWEConfig(wire_mode="f16")
    with pytest.raises(ValueError, match="lengths rank"):
        SWEConfig(global_shape=(8, 8), lengths=(1.0,))


def test_swe_app_runs_on_cpu(capsys):
    from rocm_mpi_tpu_torch.apps import swe_2d

    base = ["--device", "cpu", "--nx", "24", "--ny", "20", "--nt", "12", "--warmup", "4"]
    for extra in (["--variant", "perf"], ["--variant", "hide"], ["--vmem"], ["--deep", "4"],
                  ["--nz", "8", "--nx", "12", "--ny", "10", "--variant", "shard"],
                  ["--variant", "ap", "--dtype", "f32"]):
        assert swe_2d.main(base + extra) == 0
    text = capsys.readouterr().out
    assert "T_eff" in text and "Gpts/s" in text and "not a GPU measurement" in text
    assert "route vmem-loop" in text and "deep4: route vmem" in text
    assert text.count("mass drift") == 6 and "maximum(|h|)" in text
    with pytest.raises(SystemExit) as exc:
        swe_2d.main(["--deep", "4", "--vmem"])
    assert exc.value.code == 2
