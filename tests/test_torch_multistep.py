"""The multi-step schedules of the port (rocm_mpi_tpu_torch/ops/multistep.py,
parallel/deep_halo.py and HeatDiffusion's run_vmem_resident,
run_hbm_blocked and run_deep) against the JAX package on the CPU: the
plain versions (what a CPU tensor runs) against the Pallas kernels in
interpret mode, the planners against JAX's on a table of shapes, and the
schedules against the JAX model's. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.

Tolerances: f64 at rtol 1e-12. f32 at rtol 2e-5 / atol 2e-6, the dryrun's
f32 tolerance: XLA's CPU compile may contract a multiply and an add into
one rounding where the port rounds twice, a few ulps over <= 16 steps.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_mpi_tpu.ops.pallas_kernels as pk
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.models import diffusion as jax_diffusion
from rocm_mpi_tpu.parallel import deep_halo as jax_deep
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.models import diffusion as port_diffusion
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import multistep as M
from rocm_mpi_tpu_torch.parallel import deep_halo
from rocm_mpi_tpu_torch.state import tensor_from_numpy

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}
NP = {"f64": np.float64, "f32": np.float32}
TD = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
JD = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}
EQUAL = {2: (0.1, 0.1), 3: (0.3, 0.3, 0.3)}
UNEQUAL = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}
LAM, DT = 1.1, 1e-4


def _field(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.random(shape).astype(dtype)
    Cp = (1.0 + rng.random(shape)).astype(dtype)
    return T, Cp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _force_hbm(monkeypatch, budget=1024):
    """Shrink both packages' VMEM budget so a small block takes the
    temporal-blocked route, as tests/test_pallas_kernels.py does."""
    monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", budget)
    monkeypatch.setattr(M, "_VMEM_BLOCK_BUDGET_BYTES", budget)


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------


PLAN_CASES = [
    # (shape, dtype, n_steps, chunk, body_form, pad_pow2)
    ((252, 252), "f32", 4096, None, None, None),
    ((252, 252), "f32", 1000, None, None, None),
    ((252, 252), "bf16", 256, 64, "conly", True),
    ((256, 256), "f32", 512, None, None, True),
    ((300, 300), "f32", 256, None, None, None),
    ((300, 300), "f32", 256, 256, None, None),
    ((700, 700), "f32", 64, None, None, True),
    ((40, 36), "f64", 24, 8, "eqc", True),
    ((12, 10, 8), "f64", 48, None, None, True),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_plan_vmem_loop_matches_jax(case):
    shape, dtype, n, chunk, form, pad = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = M.plan_vmem_loop(shape, TD[dtype], n, chunk=chunk, body_form=form,
                               pad_pow2=pad)
        want = pk.plan_vmem_loop(shape, JD[dtype], n, chunk=chunk, body_form=form,
                                 pad_pow2=pad)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("n,chunk,nbytes", [
    (4096, None, 254016), (1000, None, 254016), (96, 32, 100), (256, 64, 400_000),
    (48, None, 400_000), (24, 8, 10**6), (10, 5, 10**6),
])
def test_resolve_step_chunk_matches_jax(n, chunk, nbytes):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert M.resolve_step_chunk(n, chunk, nbytes) == pk.resolve_step_chunk(n, chunk, nbytes)


@pytest.mark.parametrize("v", [None, True, 2, 4, 12, 16, 64, 256, 255, "64"])
def test_adoptable_vmem_chunk_matches_jax(v):
    assert M.adoptable_vmem_chunk(v) == pk.adoptable_vmem_chunk(v)


def test_resolve_step_chunk_rejects_a_chunk_that_does_not_divide():
    for mod in (M, pk):
        with pytest.raises(ValueError, match="must divide"):
            mod.resolve_step_chunk(100, 64, 100)


def test_step_chunk_cap_warns_only_when_asked():
    with pytest.warns(UserWarning, match="chunk degraded"):
        M.resolve_step_chunk(256, 64, 400_000)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert M.resolve_step_chunk(256, 64, 400_000, warn_on_cap=False) == 16


@pytest.mark.parametrize("k", list(range(1, 17)))
def test_tb_geometry_matches_jax(k):
    assert M.tb_geometry(k) == pk.tb_geometry(k)


@pytest.mark.parametrize("shape", [(12304, 12304), (6160, 6160), (12320, 12288),
                                   (12320, 4096), (64, 48), (32, 20, 18)])
@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_tb_slab_fits_matches_jax(shape, dtype):
    for k in (1, 8, 9, 16):
        assert M.tb_slab_fits(k, shape, TD[dtype]) == pk.tb_slab_fits(k, shape, JD[dtype])


def test_tb_geometry_and_hbm_edge_reject_like_jax():
    for bad in (0, -3, 17):
        with pytest.raises(ValueError):
            M.tb_geometry(bad)
    for itemsize in (2, 4, 8):
        for k in (8, 16):
            assert M.hbm_class_edge(itemsize, k) == pk.hbm_class_edge(itemsize, k)
    with pytest.raises(ValueError, match="divisible"):
        M.hbm_class_edge(k=5)


@pytest.mark.parametrize("local", [(252, 252), (6144, 6144), (12288, 12288), (672, 672),
                                   (126, 126), (16, 12), (40, 30, 20), (5, 9)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_default_deep_depth_matches_jax(local, itemsize):
    assert (port_diffusion.default_deep_depth(local, itemsize)
            == jax_diffusion.default_deep_depth(local, itemsize))


@pytest.mark.parametrize("nt,warmup,k", [(1000, 10, 8), (4352, 256, 256), (1056, 32, 32),
                                          (1016, 16, 8), (48, 16, 8), (16, 0, 8), (7, 2, 3)])
def test_effective_block_steps_matches_jax(nt, warmup, k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (port_diffusion.effective_block_steps(nt, warmup, k)
                == jax_diffusion.effective_block_steps(nt, warmup, k))


def test_effective_block_steps_warns_on_degradation():
    with pytest.warns(UserWarning, match="degraded"):
        assert port_diffusion.effective_block_steps(1000, 10, 8) == 2
    with pytest.raises(ValueError):
        port_diffusion.effective_block_steps(10, 2, 0)


def _pair(shape, dtype, nt, warmup, dims=None, lengths=None):
    dims = dims or (1,) * len(shape)
    kw = dict(global_shape=shape, lengths=lengths or (10.0,) * len(shape), nt=nt,
              warmup=warmup, dtype=dtype, dims=dims)
    n = int(np.prod(dims))
    return (HeatDiffusion(DiffusionConfig(**kw), device="cpu") if n == 1 else None,
            JaxHeatDiffusion(JaxConfig(**kw), devices=jax.devices()[:n]))


@pytest.mark.parametrize("shape,dtype,nt,warmup,block", [
    ((252, 252), "f32", 1056, 32, None), ((252, 252), "f32", 1000, 10, None),
    ((1024, 512), "f32", 1016, 16, None), ((64, 48), "f64", 24, 8, 4),
    ((40, 30, 20), "f32", 64, 32, None),
])
def test_effective_deep_depth_matches_jax(shape, dtype, nt, warmup, block):
    ours, ref = _pair(shape, dtype, nt, warmup)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (ours.effective_deep_depth(block_steps=block)
                == ref.effective_deep_depth(block_steps=block))


def test_config_auto_is_not_ported(tmp_path):
    # The tuning plane is ported now (tests/test_torch_tuning.py): with a
    # cold cache, config="auto" is the default policy, bitwise.
    from rocm_mpi_tpu_torch.tuning import resolve

    resolve.configure(tmp_path / "cold.json")
    try:
        ours, _ = _pair((32, 24), "f64", 16, 8)
        assert torch.equal(ours.run_vmem_resident(config="auto").T,
                           ours.run_vmem_resident().T)
        assert ours.effective_deep_depth(config="auto") == ours.effective_deep_depth()
        assert (M.plan_vmem_loop((16, 16), torch.float32, 16, config="auto", device="cpu")
                == M.plan_vmem_loop((16, 16), torch.float32, 16))
        with pytest.raises(ValueError, match="config must be"):
            M.plan_vmem_loop((16, 16), torch.float32, 16, config="fast")
    finally:
        resolve.configure(None)


# ---------------------------------------------------------------------------
# The VMEM loop: fused_multi_step and multi_step_cm
# ---------------------------------------------------------------------------


FORM_CASES = {
    # name: (spacing table, n_steps, chunk, body_form) — the form
    # _multi_step_kernel picks for that chunk and spacing.
    "direct": (EQUAL, 6, 2, None),
    "ac": (UNEQUAL, 8, 8, None),
    "eqc": (EQUAL, 8, 8, "eqc"),
    "conly": (EQUAL, 8, 4, "conly"),
}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("form", sorted(FORM_CASES))
@pytest.mark.parametrize("shape", [(30, 20), (12, 10, 6)])
def test_fused_multi_step_matches_pallas(shape, form, pad, dtype):
    spacings, n, chunk, body_form = FORM_CASES[form]
    sp = spacings[len(shape)]
    inv = K.inv_d2_of(sp)
    assert M.multi_step_form(shape, TD[dtype], chunk, inv, body_form) == form
    T, Cp = _field(shape, NP[dtype])
    got = M.fused_multi_step(_t(T), _t(Cp), LAM, DT, sp, n, chunk=chunk,
                             body_form=body_form, pad_pow2=pad).numpy()
    ref = np.asarray(pk.fused_multi_step(jnp.asarray(T), jnp.asarray(Cp), LAM, DT, sp, n,
                                         chunk=chunk, body_form=body_form, pad_pow2=pad))
    assert got.shape == shape
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    edge = K.edge_mask(shape).numpy()
    np.testing.assert_array_equal(got[edge], T[edge])  # the Dirichlet edge is held


@pytest.mark.parametrize("form", ["direct", "ac", "eqc", "conly"])
def test_multi_step_forms_agree_in_f64(form):
    # The four bodies are one function in four operation orders.
    T, Cp = _field((24, 18), np.float64)
    Cm = K.edge_masked_cm(_t(T), _t(Cp), LAM, DT)
    inv = K.inv_d2_of(EQUAL[2])
    ref = M.multi_step_cm_plain(_t(T), Cm, inv, 6, "direct")
    np.testing.assert_allclose(M.multi_step_cm_plain(_t(T), Cm, inv, 6, form).numpy(),
                               ref.numpy(), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("spacing,n", [("equal", 8), ("unequal", 8), ("equal", 3)])
@pytest.mark.parametrize("shape", [(20, 16), (10, 8, 6)])
def test_multi_step_cm_on_a_deep_block_matches_pallas_core(shape, spacing, n, dtype):
    # A k-padded block whose ghost ring updates (Cm != 0 there): the JAX
    # kernel's rolls wrap where the port reads zeros, so only the ring
    # differs; after n = k steps the core must agree.
    k = n
    padded = tuple(s + 2 * k for s in shape)
    rng = np.random.default_rng(3)
    Tp = rng.random(padded).astype(NP[dtype])
    Cm = (rng.random(padded) * 1e-3).astype(NP[dtype])
    sp = (EQUAL if spacing == "equal" else UNEQUAL)[len(shape)]
    got = M.multi_step_cm(_t(Tp), _t(Cm), sp, n).numpy()
    ref = np.asarray(pk.multi_step_cm(jnp.asarray(Tp), jnp.asarray(Cm), sp, n))
    core = tuple(slice(k, -k) for _ in shape)
    np.testing.assert_allclose(got[core], ref[core], **TOL[dtype])


def test_multi_step_cm_on_a_held_edge_matches_pallas_everywhere():
    # With Cm = 0 on the block edge (the one-GPU deep block), wrap and zero
    # neighbours only meet held cells: the whole block agrees.
    T, Cp = _field((28, 24), np.float64)
    Cm = K.edge_masked_cm(_t(T), _t(Cp), LAM, DT)
    got = M.multi_step_cm(_t(T), Cm, EQUAL[2], 8).numpy()
    ref = np.asarray(pk.multi_step_cm(jnp.asarray(T), jnp.asarray(Cm.numpy()), EQUAL[2], 8))
    np.testing.assert_allclose(got, ref, **TOL["f64"])


@pytest.mark.parametrize("kind", ["vmem", "hbm"])
def test_bf16_multi_step_is_storage_only(kind):
    # bf16 in and out, f32 arithmetic in between, one rounding: equal to
    # the f32 run on the widened inputs rounded once, and to JAX's.
    shape = (32, 24)
    T32, Cp32 = _field(shape, np.float32)
    Tj, Cpj = jnp.asarray(T32, jnp.bfloat16), jnp.asarray(Cp32, jnp.bfloat16)
    T, Cp = tensor_from_numpy(np.asarray(Tj)), tensor_from_numpy(np.asarray(Cpj))
    if kind == "vmem":
        fn, jfn, kw = M.fused_multi_step, pk.fused_multi_step, dict(chunk=8)
    else:
        fn, jfn, kw = M.fused_multi_step_hbm, pk.fused_multi_step_hbm, dict(block_steps=8)
    got = fn(T, Cp, LAM, DT, EQUAL[2], 8, **kw)
    assert got.dtype == torch.bfloat16
    Cm = K.edge_masked_cm(T, Cp, LAM, DT)
    once = M.multi_step_cm_plain(T.float(), Cm.float(), K.inv_d2_of(EQUAL[2]), 8,
                                 "eqc" if kind == "vmem" else "direct").to(torch.bfloat16)
    assert torch.equal(got, once)
    ref = np.asarray(jfn(Tj, Cpj, LAM, DT, EQUAL[2], 8, **kw)).astype(np.float32)
    # One bf16 rounding of two f32 results a few ulps apart (JAX's CPU
    # compile contracts multiply-adds): equal, or one bf16 ulp apart where
    # the f32 values straddle a rounding edge.
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= np.abs(ref) * 2.0 ** -7).all()


def test_fused_multi_step_rejects_what_jax_rejects():
    T, Cp = _field((16, 16), np.float64)
    with pytest.raises(ValueError, match="must divide"):
        M.fused_multi_step(_t(T), _t(Cp), LAM, DT, EQUAL[2], 10, chunk=4)
    big = torch.zeros(1024, 1024)
    with pytest.raises(ValueError, match="VMEM-resident budget"):
        M.fused_multi_step(big, big, LAM, DT, EQUAL[2], 8)
    with pytest.raises(ValueError, match="VMEM-resident budget"):
        M.multi_step_cm(big, big, EQUAL[2], 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        M.multi_step_cm(_t(T), _t(T[:-1]), EQUAL[2], 8)
    with pytest.raises(ValueError, match="body_form"):
        M.fused_multi_step(_t(T), _t(Cp), LAM, DT, EQUAL[2], 8, body_form="fast")
    with pytest.raises(TypeError):
        M.multi_step_cm(_t(T).half(), _t(T).half(), EQUAL[2], 8)
    with pytest.warns(UserWarning, match="SKIPPED"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_VMEM_BLOCK_BUDGET_BYTES", 16 * 15 * 8)  # 16x16 does not fit
        M.fused_multi_step(_t(T[:, :15]).contiguous(), _t(Cp[:, :15]).contiguous(),
                           LAM, DT, EQUAL[2], 8, pad_pow2=True)


def test_multi_step_out_buffer_and_no_input_writes():
    T, Cp = _field((20, 16), np.float64)
    Tt, Cm = _t(T), K.edge_masked_cm(_t(T), _t(Cp), LAM, DT)
    before = Tt.clone()
    out = torch.empty_like(Tt)
    assert M.multi_step_cm(Tt, Cm, EQUAL[2], 8, out=out) is out
    assert torch.equal(out, M.multi_step_cm(Tt, Cm, EQUAL[2], 8))
    with pytest.raises(ValueError, match="alias"):
        M.multi_step_cm(Tt, Cm, EQUAL[2], 8, out=Tt)
    M.fused_multi_step(Tt, _t(Cp), LAM, DT, EQUAL[2], 24, chunk=8)
    M.fused_multi_step_hbm(_t(np.pad(T, ((6, 6), (0, 0)))), _t(np.pad(Cp, ((6, 6), (0, 0)))),
                           LAM, DT, EQUAL[2], 16, block_steps=8)
    assert torch.equal(Tt, before)
    assert torch.equal(M.multi_step_cm(Tt, Cm, EQUAL[2], 0), Tt)


# ---------------------------------------------------------------------------
# Temporal blocking: fused_multi_step_hbm and multi_step_cm_hbm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,k,n", [((48, 20), 8, 16), ((32, 24), 3, 6), ((64, 40), 16, 32),
                                       ((32, 12, 10), 4, 8)])
def test_fused_multi_step_hbm_matches_pallas(shape, k, n, dtype):
    T, Cp = _field(shape, NP[dtype])
    sp = UNEQUAL[len(shape)]
    got = M.fused_multi_step_hbm(_t(T), _t(Cp), LAM, DT, sp, n, block_steps=k).numpy()
    ref = np.asarray(pk.fused_multi_step_hbm(jnp.asarray(T), jnp.asarray(Cp), LAM, DT, sp, n,
                                             block_steps=k))
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,k", [((16, 24), 8), ((16, 10, 8), 8), ((24, 16), 4)])
def test_multi_step_cm_hbm_on_a_deep_block_matches_pallas_core(shape, k, dtype):
    padded = tuple(s + 2 * k for s in shape)
    rng = np.random.default_rng(5)
    Tp = rng.random(padded).astype(NP[dtype])
    Cm = (rng.random(padded) * 1e-3).astype(NP[dtype])
    sp = EQUAL[len(shape)]
    got = M.multi_step_cm_hbm(_t(Tp), _t(Cm), sp, k).numpy()
    ref = np.asarray(pk.multi_step_cm_hbm(jnp.asarray(Tp), jnp.asarray(Cm), sp, k))
    core = tuple(slice(k, -k) for _ in shape)
    np.testing.assert_allclose(got[core], ref[core], **TOL[dtype])


def test_hbm_validation_matches_jax():
    T, Cp = (_t(a) for a in _field((48, 48), np.float32))
    cases = [(dict(n_steps=12, block_steps=8), "multiple"),
             (dict(n_steps=34, block_steps=17), "block_steps"),
             (dict(n_steps=18, block_steps=9), "axis-0")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            M.fused_multi_step_hbm(T, Cp, 1.0, 1e-4, (0.5, 0.5), **kw)
        with pytest.raises(ValueError, match=msg):
            pk.fused_multi_step_hbm(jnp.asarray(T.numpy()), jnp.asarray(Cp.numpy()), 1.0, 1e-4,
                                    (0.5, 0.5), **kw)
    with pytest.raises(ValueError, match="axis-0"):
        M.fused_multi_step_hbm(T[:20].contiguous(), Cp[:20].contiguous(), 1.0, 1e-4,
                               (0.5, 0.5), 8, block_steps=8)
    wide = torch.zeros(12320, 12288)
    with pytest.raises(ValueError, match="compile envelope"):
        M.multi_step_cm_hbm(wide, wide, (0.1, 0.1), 16)
    with pytest.raises(ValueError, match=r"n_steps must be in \[1, 16\]"):
        M.multi_step_cm_hbm(T, T, (0.1, 0.1), 17)


# ---------------------------------------------------------------------------
# The 2D tb_sweep kernel's decomposition (strips × segments), on the CPU
# ---------------------------------------------------------------------------

TB_PLAN_SHAPES = [(97, 131), (300, 517), (1000, 777), (6160, 6160), (12304, 12304),
                  (12320, 12320), (16, 24)]


@pytest.mark.parametrize("resident", [4, 64, 132 * 16])
@pytest.mark.parametrize("k", [1, 5, 7, 8, 16])
@pytest.mark.parametrize("shape", TB_PLAN_SHAPES)
def test_tb_plan_covers_every_core_cell_once(shape, k, resident):
    plan = M.tb_plan(shape, k, resident)
    assert plan.core_cols == M.tb_layout().strip_cols - 2 * k and plan.k == k
    assert plan.seg_rows >= 1 and plan.waves >= 1
    assert plan.waves == -(-(plan.strips * plan.segments) // resident)
    tiles = list(M.tb_tiles(plan, shape))
    assert len(tiles) == plan.strips * plan.segments
    # Rows and columns are each cut into consecutive non-empty intervals
    # that end at the block's edge, so the tiles' product covers every cell
    # once.
    for ax, n in enumerate(shape):
        cuts = sorted({t[ax] for t in tiles})
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(lo < hi for lo, hi in cuts)
    if shape[0] * shape[1] <= 10**6:
        count = np.zeros(shape, dtype=np.int32)
        for (r0, r1), (c0, c1) in tiles:
            count[r0:r1, c0:c1] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
@pytest.mark.parametrize("k", list(range(1, 17)))
def test_tb_plan_shared_memory_fits_a_block(k, dtype):
    # The kernel keeps each lane's ring of k + 1 rows of its columns' Cm in
    # shared memory, at compute width (csrc/multistep.cu tb2_smem_bytes):
    # a block of the layout must fit an H100's opt-in limit a block.
    h100_smem_optin = 232_448
    layout = M.tb_layout()
    assert (layout.lane_cols, layout.warps_per_block) == (4, 4)
    width = 8 if dtype == "f64" else 4  # bf16 is computed, and kept, at f32 width
    assert layout.warps_per_block * 32 * (k + 1) * layout.lane_cols * width <= h100_smem_optin
    plan = M.tb_plan((12304, 12304), k, 132 * 16)
    assert plan.core_cols == layout.strip_cols - 2 * k > 0


def test_tb_plan_fills_whole_waves_and_rejects_bad_input():
    # Many resident warps: one wave of short segments; few: tall ones.
    wide = M.tb_plan((12304, 12304), 8, 132 * 16)
    narrow = M.tb_plan((12304, 12304), 8, 4)
    assert wide.waves == 1 and narrow.seg_rows > wide.seg_rows
    for bad in (dict(k=0), dict(k=17), dict(shape=(0, 8)), dict(resident=0)):
        args = dict(shape=(64, 64), k=8, resident=16) | bad
        with pytest.raises(ValueError):
            M.tb_plan(args["shape"], args["k"], args["resident"])


def _tb_emulated(T, Cm, inv_d2, k, plan):
    """The kernel's decomposition in plain PyTorch: each tile's window
    (its core grown by k a side, zeros only beyond the block's edge), k
    plain steps on it, its core kept, the cores stitched."""
    n0, n1 = T.shape
    out = torch.empty_like(T)
    for (r0, r1), (c0, c1) in M.tb_tiles(plan, T.shape):
        w0, w1 = max(r0 - k, 0), min(r1 + k, n0)
        v0, v1 = max(c0 - k, 0), min(c1 + k, n1)
        win = M.tb_sweep_plain(T[w0:w1, v0:v1].contiguous(), Cm[w0:w1, v0:v1].contiguous(),
                               inv_d2, k)
        out[r0:r1, c0:c1] = win[r0 - w0:r1 - w0, c0 - v0:c1 - v0]
    return out


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("resident", [8, 132 * 16])
@pytest.mark.parametrize("k", [1, 7, 8, 16])
@pytest.mark.parametrize("shape", [(97, 131), (300, 517)])
def test_tb_decomposition_equals_the_whole_block_bitwise(shape, k, resident, dtype):
    rng = np.random.default_rng(k)
    T = _t(rng.random(shape).astype(NP[dtype]))
    Cm = K.edge_masked_cm(T, _t((1.0 + rng.random(shape)).astype(NP[dtype])), LAM, 0.2)
    inv_d2 = K.inv_d2_of(UNEQUAL[2])
    plan = M.tb_plan(shape, k, resident)
    assert plan.strips * plan.segments > 1  # the block really is cut
    want = M.tb_sweep_plain(T, Cm, inv_d2, k)
    assert torch.equal(_tb_emulated(T, Cm, inv_d2, k, plan), want)


def test_tb_sweep_plans_once_per_device_shape_k_and_dtype(monkeypatch):
    calls = []

    def resident(index, k, dtype):
        calls.append((index, k, dtype))
        return 132 * 16

    monkeypatch.setattr(M, "_resident_warps", resident)
    M._device_plan.cache_clear()
    try:
        for _ in range(3):
            a = M._device_plan(0, (12304, 12304), 8, torch.float32)
        b = M._device_plan(0, (6160, 6160), 8, torch.float32)
        assert calls == [(0, 8, torch.float32), (0, 8, torch.float32)]
        assert a == M.tb_plan((12304, 12304), 8, 132 * 16)
        assert b == M.tb_plan((6160, 6160), 8, 132 * 16)
    finally:
        M._device_plan.cache_clear()



# ---------------------------------------------------------------------------
# The 3D tb_sweep kernel's stream (cross-section tiles × axis-0 segments)
# ---------------------------------------------------------------------------

TB3_PLAN_SHAPES = [(128, 128, 128), (144, 144, 144), (64, 96, 96), (96, 64, 48), (17, 9, 40),
                   (32, 12, 10), (5, 3, 2)]


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
@pytest.mark.parametrize("k", [1, 5, 8, 13, 16])
@pytest.mark.parametrize("shape", TB3_PLAN_SHAPES)
def test_tb3_plan_covers_every_core_cell_once(shape, k, dtype):
    plan = M.tb3_plan(shape, k, TD[dtype], 132)
    assert plan.k == k and plan.seg >= 1 and plan.waves >= 1
    assert plan.waves == -(-(plan.tiles1 * plan.tiles2 * plan.segments)
                           // (132 * plan.blocks_per_sm))
    tiles = list(M.tb3_tiles(plan, shape))
    assert len(tiles) == plan.tiles1 * plan.tiles2 * plan.segments
    # Each axis is cut into consecutive non-empty intervals that end at the
    # block's edge, so the boxes' product covers every cell once.
    for ax, n in enumerate(shape):
        cuts = sorted({t[ax] for t in tiles})
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(lo < hi for lo, hi in cuts)
    count = np.zeros(shape, dtype=np.int32)
    for (r0, r1), (a0, a1), (b0, b1) in tiles:
        count[r0:r1, a0:a1, b0:b1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
@pytest.mark.parametrize("k", list(range(1, 17)))
def test_tb3_plan_shared_memory_fits_a_block(k, dtype):
    # Every depth in every dtype has a plan whose rings fit an H100's
    # opt-in shared memory a block, at most max_cells cells a thread of at
    # most max_threads: the kernel takes every k that JAX's _tb_kernel does.
    limits = M.tb3_limits()
    assert limits == (3, 1024)
    for shape in ((128, 128, 128), (64, 96, 96), (5, 3, 2)):
        plan = M.tb3_plan(shape, k, TD[dtype], 132)
        assert plan.smem == M.tb3_smem_bytes(k, plan.e1, plan.e2, TD[dtype], plan.cm_ring)
        assert plan.smem <= M.H100_SMEM_OPTIN
        assert plan.e1 - 2 * k >= 1 and plan.e2 - 2 * k >= 1
        assert plan.threads % 32 == 0 and plan.threads <= limits.max_threads
        assert plan.e1 * M.tb3_pitch(plan.e2) <= limits.max_cells * plan.threads
        assert 1 <= plan.blocks_per_sm == M.tb3_resident_estimate(plan.threads, plan.smem)


def test_tb3_plan_fills_the_card_and_rejects_bad_input():
    # The 3D app's 128³ in f32 at k = 8 fills the card's SMs in one wave;
    # the plan asks the card's answer for each candidate it weighs.
    plan = M.tb3_plan((128, 128, 128), 8, torch.float32, 132)
    blocks = plan.tiles1 * plan.tiles2 * plan.segments
    assert plan.waves == 1 and blocks > 66
    asked = []

    def resident(e1, e2, threads, cm_ring):
        asked.append((e1, e2, threads))
        return 0 if threads == 1024 else 1

    other = M.tb3_plan((128, 128, 128), 8, torch.float32, 132, resident)
    assert other.threads < 1024 and (other.e1, other.e2, other.threads) in asked
    assert M.tb3_updates(plan, (128, 128, 128)) >= 8 * 128 ** 3
    for bad in (dict(k=0), dict(k=17), dict(shape=(0, 8, 8)), dict(sms=0)):
        args = dict(shape=(64, 64, 64), k=8, sms=132) | bad
        with pytest.raises(ValueError):
            M.tb3_plan(args["shape"], args["k"], torch.float32, args["sms"])
    with pytest.raises(ValueError, match="no 3D plan"):
        M.tb3_plan((64, 64, 64), 16, torch.float64, 132, smem_limit=48 * 1024)


def _tb3_streamed(T, Cm, inv_d2, k, plan):
    """The 3D kernel's stream in plain PyTorch, block by block: a ring of
    three planes for level 0 (the tile of T, the storage type) and for each
    level L < k (its cone, e - 2L on both axes, the compute type), plane x
    in slot (x - g_begin) mod 3. Plane step g stores plane g into level 0's
    ring (its own cells' values, loaded the step before, also level 1's
    down) and advances level s over its cone at plane g - s from level
    s - 1's planes g - s - 1 (up, from the ring), g - s (the centre and its
    neighbours, from the ring) and g - s + 1 (down: the value the thread
    computed for level s - 1 this step); Cm of plane g - s; a level's plane
    outside the block is 0; level k writes its core plane where it lies in
    the segment. Neighbours outside the block read as 0. In the kernel's
    operation order (update<C, 3, kDirect>), rounded once a store."""
    cdt = K._compute_dtype(T.dtype)
    n0, n1, n2 = T.shape
    k, e1, e2 = plan.k, plan.e1, plan.e2
    c1, c2 = e1 - 2 * k, e2 - 2 * k
    out = torch.full_like(T, float("nan"))
    inv0, inv1, inv2 = (torch.tensor(v, dtype=cdt) for v in inv_d2)

    def window(src, g, o1, o2):
        """Plane g of src over the tile at block coordinates (o1, o2), 0
        outside the block."""
        tile = torch.zeros(e1, e2, dtype=src.dtype)
        if 0 <= g < n0:
            a0, a1 = max(o1, 0), min(o1 + e1, n1)
            b0, b1 = max(o2, 0), min(o2 + e2, n2)
            if a0 < a1 and b0 < b1:
                tile[a0 - o1:a1 - o1, b0 - o2:b1 - o2] = src[g, a0:a1, b0:b1]
        return tile

    for blk in range(plan.tiles1 * plan.tiles2):
        t1, t2 = divmod(blk, plan.tiles2)
        o1, o2 = t1 * c1 - k, t2 * c2 - k
        for seg in range(plan.segments):
            r0, r1 = seg * plan.seg, min((seg + 1) * plan.seg, n0)
            g_begin, g_end = max(r0 - k, 0), r1 + k
            rings = [torch.zeros(3, e1 - 2 * L, e2 - 2 * L, dtype=cdt if L else T.dtype)
                     for L in range(k)]
            tg = window(T, g_begin, o1, o2)
            for g in range(g_begin, g_end):
                slot = g - g_begin
                rings[0][slot % 3] = tg
                down = tg.to(cdt)[1:-1, 1:-1]
                for s in range(1, k + 1):
                    p = g - s
                    src = rings[s - 1].to(cdt)
                    cen = src[(slot - s) % 3]   # plane g - s of level s - 1
                    up = src[(slot - s - 1) % 3][1:-1, 1:-1]
                    if 0 <= p < n0:
                        t = cen[1:-1, 1:-1]
                        cm = window(Cm, p, o1 + s, o2 + s)[:e1 - 2 * s, :e2 - 2 * s].to(cdt)
                        p1 = cen[2:, 1:-1] + cen[:-2, 1:-1]
                        p2 = cen[1:-1, 2:] + cen[1:-1, :-2]
                        lap = ((down + up) - 2 * t) * inv0
                        lap = lap + (p1 - 2 * t) * inv1
                        lap = lap + (p2 - 2 * t) * inv2
                        new = t + cm * lap
                    else:
                        new = torch.zeros(e1 - 2 * s, e2 - 2 * s, dtype=cdt)
                    if s < k:
                        rings[s][(slot - s) % 3] = new
                        down = new[1:-1, 1:-1]
                    elif r0 <= p < r1:
                        a1, b1 = min(c1, n1 - (o1 + k)), min(c2, n2 - (o2 + k))
                        out[p, o1 + k:o1 + k + a1, o2 + k:o2 + k + b1] = new[:a1, :b1].to(T.dtype)
                tg = window(T, g + 1, o1, o2)
    return out


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
@pytest.mark.parametrize("shape,k,sms", [((20, 13, 11), 1, 8), ((20, 13, 11), 3, 8),
                                         ((21, 9, 14), 4, 132), ((12, 30, 8), 2, 4)])
def test_tb3_stream_equals_the_whole_block_bitwise(shape, k, sms, dtype):
    rng = np.random.default_rng(k)
    T = torch.from_numpy(rng.random(shape)).to(TD[dtype])
    Cm = torch.from_numpy(rng.random(shape) * 0.1).to(TD[dtype])
    inv_d2 = K.inv_d2_of(UNEQUAL[3])
    plan = M.tb3_plan(shape, k, TD[dtype], sms)
    assert plan.tiles1 * plan.tiles2 * plan.segments > 1  # the block really is cut
    want = M.tb_sweep_plain(T, Cm, inv_d2, k)
    assert torch.equal(_tb3_streamed(T, Cm, inv_d2, k, plan), want)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fused_multi_step_hbm_3d_at_k16_matches_pallas(dtype):
    # k = 16 on a 3D field whose 64-plane slab JAX admits: the port's sweep
    # takes it (the light-cone tiles it replaced refused k > 12).
    shape = (64, 12, 10)
    assert M.tb_slab_fits(16, shape, TD[dtype])
    T, Cp = _field(shape, NP[dtype], 7)
    sp = UNEQUAL[3]
    got = M.fused_multi_step_hbm(_t(T), _t(Cp), LAM, DT, sp, 32, block_steps=16).numpy()
    ref = np.asarray(pk.fused_multi_step_hbm(jnp.asarray(T), jnp.asarray(Cp), LAM, DT, sp, 32,
                                             block_steps=16))
    np.testing.assert_allclose(got, ref, **TOL[dtype])


def test_cpu_calls_count_no_launches():
    K.reset_launches()
    T, Cp = (_t(a) for a in _field((32, 16), np.float64))
    M.fused_multi_step(T, Cp, LAM, DT, EQUAL[2], 8, chunk=4)
    M.fused_multi_step_hbm(T, Cp, LAM, DT, EQUAL[2], 8, block_steps=8)
    assert K.LAUNCHES["multi_step_cm"] == K.LAUNCHES["tb_sweep"] == 0


def test_other_devices_raise():
    T = torch.empty(32, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        M.multi_step_cm(T, torch.empty(32, 16, device="meta"), EQUAL[2], 8)
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        M.multi_step_cm_hbm(T, torch.empty(32, 16, device="meta"), EQUAL[2], 8)


# ---------------------------------------------------------------------------
# make_deep_sweep and the model's schedules, one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_run_vmem_resident_matches_jax(dtype):
    ours, ref = _pair((40, 32), dtype, 24, 8)
    got = ours.run_vmem_resident()
    want = np.asarray(ref.run_vmem_resident().T)
    assert (got.route, got.k) == ("vmem-loop", 8)
    np.testing.assert_allclose(got.T.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kw", [dict(chunk=4, body_form="conly"), dict(pad_pow2=True),
                                dict(chunk=2)], ids=["conly", "pad", "direct"])
def test_run_vmem_resident_knobs_match_jax(kw, dtype):
    ours, ref = _pair((30, 20), dtype, 16, 8, lengths=(10.0, 7.0))
    np.testing.assert_allclose(ours.run_vmem_resident(**kw).T.numpy(),
                               np.asarray(ref.run_vmem_resident(**kw).T), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(64, 40), (32, 12, 10)])
def test_run_hbm_blocked_matches_jax(shape, dtype):
    ours, ref = _pair(shape, dtype, 24, 8)
    got = ours.run_hbm_blocked()
    assert (got.route, got.k) == ("hbm-tb", 8)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.run_hbm_blocked().T),
                               **TOL[dtype])


def test_single_shard_paths_warn_and_validate():
    ours, _ = _pair((32, 32), "f64", 20, 4)
    with pytest.warns(UserWarning, match="block_steps degraded"):
        assert ours.run_hbm_blocked().k == 4
    with pytest.warns(UserWarning, match="chunk degraded"):
        assert ours.run_vmem_resident(chunk=8).k == 4
    with pytest.raises(ValueError, match="warmup"):
        ours.run_vmem_resident(nt=4, warmup=4)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("route", ["vmem", "hbm-tb"])
@pytest.mark.parametrize("shape", [(48, 40), (32, 12, 10)])
def test_run_deep_one_rank_matches_jax(shape, route, dtype, monkeypatch):
    if route == "hbm-tb":
        _force_hbm(monkeypatch)
    ours, ref = _pair(shape, dtype, 24, 8)
    got = ours.run_deep(block_steps=8)
    assert (got.route, got.k) == (route, 8)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.run_deep(block_steps=8).T),
                               **TOL[dtype])


def test_run_deep_default_depth_and_jnp_route(monkeypatch):
    # Default depth on a small field; then a shape the stripe rule refuses
    # ((24 + 2·4) rows are fine, (20 + 2·4) = 28 are not a multiple of 16)
    # takes the jnp route on both sides.
    ours, ref = _pair((48, 40), "f64", 64, 32)
    got = ours.run_deep()
    assert (got.route, got.k) == ("vmem", 32)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.run_deep().T), **TOL["f64"])
    _force_hbm(monkeypatch)
    ours, ref = _pair((20, 24), "f64", 16, 8)
    got = ours.run_deep(block_steps=4)
    assert got.route == "jnp"
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.run_deep(block_steps=4).T),
                               **TOL["f64"])


@pytest.mark.parametrize("local_form", ["auto", "jnp"])
def test_make_deep_sweep_matches_jax(local_form):
    # One sweep of the schedule itself, from the same state, on one rank.
    cfg = JaxConfig(global_shape=(40, 36), dtype="f64", dims=(1, 1))
    ref_model = JaxHeatDiffusion(cfg, devices=jax.devices()[:1])
    T0, Cp = ref_model.init_state()
    jsched = jax_deep.make_deep_sweep(ref_model.grid, 6, cfg.lam, cfg.dt, cfg.spacing,
                                      local_form=local_form)
    want = np.asarray(jsched.sweep(T0, jsched.prepare(Cp)))
    ours = HeatDiffusion(DiffusionConfig(global_shape=(40, 36), dtype="f64", dims=(1, 1)),
                         device="cpu")
    sched = deep_halo.make_deep_sweep(ours.grid, 6, cfg.lam, cfg.dt, cfg.spacing,
                                      local_form=local_form)
    Cm = sched.prepare(_t(np.asarray(Cp)))
    np.testing.assert_array_equal(Cm.numpy()[6:-6, 6:-6],
                                  np.asarray(pk.edge_masked_cm(T0, Cp, cfg.lam, cfg.dt)))
    got = sched.sweep(_t(np.asarray(T0)), Cm)
    assert sched.route == ("vmem" if local_form == "auto" else "jnp")
    assert tuple(got.shape) == (40, 36)
    np.testing.assert_allclose(got.numpy(), want, **TOL["f64"])


def test_deep_prepare_holds_boundary_and_off_domain_ghosts():
    grid_model = HeatDiffusion(DiffusionConfig(global_shape=(20, 16), dtype="f64",
                                               dims=(1, 1)), device="cpu")
    k = 3
    hold = deep_halo.padded_hold_mask((26, 22), grid_model.grid, k).numpy()
    idx0, idx1 = np.arange(26)[:, None] - k, np.arange(22)[None, :] - k
    want = (idx0 <= 0) | (idx0 >= 19) | (idx1 <= 0) | (idx1 >= 15)
    np.testing.assert_array_equal(hold, want)
    _, Cp = grid_model.init_state()
    sched = deep_halo.make_deep_sweep(grid_model.grid, k, 1.0, 1e-3, (0.5, 0.625))
    Cm = sched.prepare(Cp).numpy()
    assert (Cm[hold] == 0).all() and (Cm[~hold] == 1e-3).all()


def test_deep_sweep_validation():
    grid = HeatDiffusion(DiffusionConfig(global_shape=(16, 12), dtype="f64", dims=(1, 1)),
                         device="cpu").grid
    with pytest.raises(ValueError, match="exceeds a local shard extent"):
        deep_halo.make_deep_sweep(grid, 13, 1.0, 1e-3, (0.5, 0.5))
    with pytest.raises(ValueError, match=">= 1"):
        deep_halo.make_deep_sweep(grid, 0, 1.0, 1e-3, (0.5, 0.5))
    with pytest.raises(ValueError, match="local_form"):
        deep_halo.make_deep_sweep(grid, 2, 1.0, 1e-3, (0.5, 0.5), local_form="pallas")
    # Every wire mode builds; a stateful one threads its state through the
    # sweep (init_wire), and an unknown one raises as the JAX package does.
    assert deep_halo.make_deep_sweep(grid, 2, 1.0, 1e-3, (0.5, 0.5),
                                     wire_mode="bf16").init_wire is None
    assert deep_halo.make_deep_sweep(grid, 2, 1.0, 1e-3, (0.5, 0.5),
                                     wire_mode="int8").init_wire is not None
    with pytest.raises(ValueError, match="unknown wire_mode"):
        deep_halo.make_deep_sweep(grid, 2, 1.0, 1e-3, (0.5, 0.5), wire_mode="fp8")


def test_deep_advance_rejects_a_count_the_depth_does_not_divide():
    ours, _ = _pair((32, 24), "f64", 16, 8)
    advance, k = ours.deep_advance_fn(block_steps=8)
    T, Cp = ours.init_state()
    with pytest.raises(ValueError, match="multiple of the depth"):
        advance(T, Cp, 12)
    assert k == 8 and advance.schedule.k == 8


def test_app_deep_runs_on_cpu(capsys):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    rc = diffusion_2d_perf.main(["--device", "cpu", "--nx", "48", "--ny", "40", "--nt", "24",
                                 "--warmup", "8", "--deep", "8"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "deep8" in text and "local route vmem" in text
    assert "T_eff" in text and "Gpts/s" in text and "not a GPU measurement" in text
    diffusion_2d_perf.main(["--device", "cpu", "--nx", "48", "--ny", "40", "--nt", "20",
                            "--warmup", "10", "--deep", "8"])
    assert "degraded from 8" in capsys.readouterr().out
