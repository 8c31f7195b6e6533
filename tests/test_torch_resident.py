"""The cluster route of the multi-step kernels (rocm_mpi_tpu_torch/ops/
resident.py, csrc/resident.cuh): the band plan and the route by size, and
a plain emulation of the band decomposition, on the CPU.

The multi_step_cm, wave_multi_step and swe_multi_step kernels hold a
block in one thread-block cluster's shared memory, CTA r a band of rows
along axis 0, each step reading its neighbours' edge rows of the previous
step. The emulation below steps each band from its own rows and those
edge rows (the SWE computing h' once over the band and the next band's
first row), in the kernels' operation order, and must equal the
whole-block plain version bitwise: the same operations on the same
operands. The JAX parity of the plain versions is in
test_torch_multistep.py, test_torch_wave.py and test_torch_swe.py (the
diffusion emulation is also held to the JAX kernel here); the CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_mpi_tpu.ops.pallas_kernels as pk
from rocm_mpi_tpu_torch.ops import _build
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import multistep as MS
from rocm_mpi_tpu_torch.ops import resident as R
from rocm_mpi_tpu_torch.ops import swe as S
from rocm_mpi_tpu_torch.ops import wave as W

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
# What an H100 SXM grants the cluster kernels (the caps query on the card):
# clusters of 16 CTAs and 227 KB of dynamic shared memory a CTA; and a card
# that grants only the portable 8.
H100_SMEM_OPTIN = 232_448
H100_CAPS = R.Caps(16, H100_SMEM_OPTIN)
CAPS = {"c16": H100_CAPS, "c8": R.Caps(8, H100_SMEM_OPTIN)}
# Blocks and band counts: a ragged split (253 rows over 8 or 16 bands),
# bands of a single row (16 rows over 16, 8 planes over 8), and 3D.
SPLITS = [((253, 251), 16), ((253, 251), 8), ((40, 24), 16), ((16, 20), 16),
          ((20, 9, 7), 16), ((8, 6, 5), 8)]
# The main paths' blocks of the three kernels (chip_smoke.RESIDENT_MAIN):
# the VMEM loops at 252² (the SWE's f64 at 180²), run_deep's 316²
# (diffusion), 268² (wave) and 256² (SWE) blocks, one GPU and per rank on
# the 2×2 grid of 480², and the 3D SWE block (diffusion's 3D block below).
MAIN = [("diffusion", (252, 252), "f32"), ("diffusion", (252, 252), "f64"),
        ("diffusion", (252, 252), "bf16"), ("diffusion", (316, 316), "f32"),
        ("diffusion", (316, 316), "f64"), ("diffusion", (316, 316), "bf16"),
        ("wave", (252, 252), "f32"), ("wave", (252, 252), "bf16"),
        ("wave", (268, 268), "f32"), ("wave", (268, 268), "f64"),
        ("wave", (268, 268), "bf16"), ("swe", (252, 252), "f32"),
        ("swe", (252, 252), "bf16"), ("swe", (180, 180), "f64"),
        ("swe", (256, 256), "f32"), ("swe", (256, 256), "bf16"),
        ("swe", (32, 24, 24), "f32"), ("swe", (32, 24, 24), "f64"),
        ("swe", (32, 24, 24), "bf16")]


# ---------------------------------------------------------------------------
# The band plan and the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n0,cluster", [(253, 16), (253, 8), (252, 16), (17, 16), (16, 16),
                                        (1, 1), (3, 2), (512, 16)])
def test_bands_cover_every_row_once(n0, cluster):
    bands = R.bands(n0, cluster)
    assert len(bands) == cluster
    assert bands[0][0] == 0 and bands[-1][1] == n0
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    sizes = [hi - lo for lo, hi in bands]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)  # the larger bands first
    assert max(sizes) == -(-n0 // cluster)  # the layout's rows


def test_bands_reject_more_ctas_than_rows():
    for n0, cluster in ((4, 5), (0, 1), (8, 0)):
        with pytest.raises(ValueError):
            R.bands(n0, cluster)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("kind,shape,dtype", MAIN)
def test_main_path_blocks_take_the_cluster_route(kind, shape, dtype, caps):
    plan = R.plan(kind, shape, DTYPES[dtype], CAPS[caps])
    assert plan.route == "cluster"
    assert plan.cluster == min(CAPS[caps].cluster, shape[0])
    assert plan.rows == -(-shape[0] // plan.cluster)
    assert plan.nbytes == R.smem_bytes(kind, shape, DTYPES[dtype], plan.rows, plan.stage)
    assert plan.nbytes <= H100_SMEM_OPTIN


def test_the_3d_diffusion_block_takes_a_cluster_of_16():
    # chip_smoke.py's 96×64×48 block: in f32 two buffers of 6-row bands
    # (plus halos) fit a CTA of a 16-CTA cluster, Cm read from device
    # memory (128 warp-columns: more than a CTA's 32 warps, so no register
    # layout); 12-row bands of a cluster of 8 do not fit, nor do f64's.
    plan = R.plan("diffusion", (96, 64, 48), torch.float32, H100_CAPS)
    assert (plan.route, plan.cluster, plan.rows) == ("cluster", 16, 6)
    assert not plan.stage and not plan.registers
    assert R.reg_rows((96, 64, 48), 6) is None
    assert R.plan("diffusion", (96, 64, 48), torch.float32, CAPS["c8"]) == R.COOPERATIVE
    assert R.plan("diffusion", (96, 64, 48), torch.float64, H100_CAPS) == R.COOPERATIVE


@pytest.mark.parametrize("caps", list(CAPS))
def test_the_oversized_3d_wave_block_takes_the_cooperative_route(caps):
    # chip_smoke.py's 96×64×48 wave block: 2.36 MB a field in f64, two
    # buffers of it beyond a cluster's shared memory.
    plan = R.plan("wave", (96, 64, 48), torch.float64, CAPS[caps])
    assert plan == R.COOPERATIVE


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", R.KINDS)
def test_plans_stay_under_the_shared_memory_limit(kind, dtype):
    tdt = DTYPES[dtype]
    seen = set()
    for shape in [(n, n) for n in range(1, 700, 7)] + [(n, 9, 13) for n in range(1, 90, 3)]:
        plan = R.plan(kind, shape, tdt, H100_CAPS)
        seen.add(plan.route)
        if plan.route == "cooperative":
            assert plan == R.COOPERATIVE
            continue
        assert plan.nbytes <= H100_SMEM_OPTIN
        assert plan.nbytes == R.smem_bytes(kind, shape, tdt, plan.rows, plan.stage)
        # Staging the read-only operands is taken whenever it fits, unless
        # diffusion's Cm stays in registers.
        staged = R.smem_bytes(kind, shape, tdt, plan.rows, True)
        assert plan.stage == (staged <= H100_SMEM_OPTIN and not plan.registers)
    assert seen == {"cluster", "cooperative"}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,n0", [("diffusion", 724), ("wave", 512), ("swe", 256)])
def test_edge_shape_is_the_capacity_edge(kind, n0, dtype):
    tdt = DTYPES[dtype]
    edge = R.edge_shape(kind, n0, tdt, H100_CAPS)
    assert edge[0] == n0
    assert R.plan(kind, edge, tdt, H100_CAPS).route == "cluster"
    assert R.plan(kind, (n0, edge[1] + 1), tdt, H100_CAPS).route == "cooperative"
    # The widest admitted square of the wave (1 MiB a field: 512² f32,
    # 362² f64) fits with room to spare.
    if kind == "wave":
        assert edge[1] >= (512 if dtype != "f64" else 362)


def test_no_granted_cluster_means_the_cooperative_route():
    for kind in R.KINDS:
        assert R.plan(kind, (252, 252), torch.float32, R.Caps(0, H100_SMEM_OPTIN)) == \
            R.COOPERATIVE
    with pytest.raises(ValueError):
        R.smem_bytes("heat", (8, 8), torch.float32, 1, False)


def test_device_plans_ask_the_card_once_per_instantiation(monkeypatch):
    calls = []

    class Lib:
        rmt_wave_multi_step_caps = "wave"
        rmt_swe_multi_step_caps = "swe"

    def query(fn, index, *args):
        calls.append((fn, index, args))
        return H100_CAPS

    monkeypatch.setattr(_build, "load", lambda name, signatures: Lib)
    monkeypatch.setattr(R, "query_caps", query)
    for f in (W.device_caps, W.device_plan, S.device_caps, S.device_plan):
        f.cache_clear()
    try:
        for _ in range(3):
            assert W.device_plan(0, (252, 252), torch.float32, "aform") == \
                R.plan("wave", (252, 252), torch.float32, H100_CAPS)
            W.device_plan(0, (268, 268), torch.float32, "aform")
            assert S.device_plan(0, (256, 256), torch.float32) == \
                R.plan("swe", (256, 256), torch.float32, H100_CAPS)
        assert calls == [("wave", 0, (0, 2, W.FORMS["aform"])), ("swe", 0, (0, 2))]
    finally:
        for f in (W.device_caps, W.device_plan, S.device_caps, S.device_plan):
            f.cache_clear()


def test_cpu_tensors_never_plan_a_route(monkeypatch):
    # The plain version runs for CPU tensors before any route is asked for.
    def refuse(*args):
        raise AssertionError("a CPU call asked for a device plan")

    monkeypatch.setattr(W, "device_plan", refuse)
    monkeypatch.setattr(S, "device_plan", refuse)
    U = torch.rand(12, 10, dtype=torch.float64)
    M = W.interior_mask(U.shape, U.dtype)
    W.leapfrog_multi_step(U, U.clone(), M, 1e-3 * M, (1.0, 1.0), 3, "aform")
    h, us, Mus = _swe_state((12, 10), "f64")
    S.fb_multi_step(h, us, Mus, (0.1, 0.1), (0.2, 0.2), 3)


# ---------------------------------------------------------------------------
# The band decomposition, emulated, against the whole block
# ---------------------------------------------------------------------------


def _wave_operands(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]
    U = torch.from_numpy(rng.random(shape)).to(tdt)
    Uprev = torch.from_numpy(rng.random(shape)).to(tdt)
    M = torch.from_numpy((rng.random(shape) > 0.1).astype(np.float64)).to(tdt)
    M = M * W.interior_mask(shape, tdt)
    Cw = (torch.from_numpy(rng.random(shape) * 1e-3).to(tdt)) * M
    return U, Uprev, M, Cw


def _wave_emulated(U, Uprev, M, Cw, inv_d2, n, form, cluster, halo=1):
    """The cluster route in plain PyTorch: each step, each band's new rows
    from its own rows and the `halo` rows just outside it of the previous
    step (zeros beyond the block), in the compute type, rounded once."""
    cdt = K._compute_dtype(U.dtype)
    Uc, Upc, Mc, Cwc = (t.to(cdt) for t in (U, Uprev, M, Cw))
    n0 = U.shape[0]
    for _ in range(n):
        new = torch.empty_like(Uc)
        for lo, hi in R.bands(n0, cluster):
            w0, w1 = max(lo - halo, 0), min(hi + halo, n0)
            stepped, _ = W.wave_multi_step_plain(Uc[w0:w1], Upc[w0:w1], Mc[w0:w1],
                                                 Cwc[w0:w1], inv_d2, 1, form)
            new[lo:hi] = stepped[lo - w0:hi - w0]
        Uc, Upc = new, Uc
    return Uc.to(U.dtype), Upc.to(U.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", list(W.FORMS))
@pytest.mark.parametrize("shape,cluster", SPLITS)
def test_wave_band_decomposition_equals_the_whole_block_bitwise(shape, cluster, form, dtype):
    U, Uprev, M, Cw = _wave_operands(shape, dtype)
    inv_d2 = K.inv_d2_of((0.1,) * len(shape) if form == "aform" else (0.1, 0.07, 0.05)[:len(shape)])
    want = W.wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, 5, form)
    got = _wave_emulated(U, Uprev, M, Cw, inv_d2, 5, form, cluster)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _swe_state(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]
    ndim = len(shape)
    h = torch.from_numpy(rng.random(shape)).to(tdt)
    Mus = []
    for a in range(ndim):
        Ma = (rng.random(shape) > 0.1).astype(np.float64)
        Ma[tuple(slice(-1, None) if ax == a else slice(None) for ax in range(ndim))] = 0
        Mus.append(torch.from_numpy(Ma).to(tdt))
    us = tuple(torch.from_numpy(rng.random(shape) - 0.5).to(tdt) * Ma for Ma in Mus)
    return h, us, tuple(Mus)


def _swe_emulated(h, us, Mus, cH, cg, n, cluster):
    """The cluster route in plain PyTorch: each step, each band computes h'
    once over its rows and the next band's first row (from the rows just
    outside the band, zeros beyond the block), then u' of its rows from
    that h', in swe_multi_step_plain's operation order; rounded once."""
    cdt = K._compute_dtype(h.dtype)
    hc = h.to(cdt)
    uc = tuple(u.to(cdt) for u in us)
    Mc = tuple(M.to(cdt) for M in Mus)
    n0 = h.shape[0]
    for _ in range(n):
        h_new = torch.empty_like(hc)
        u_new = tuple(torch.empty_like(u) for u in uc)
        for lo, hi in R.bands(n0, cluster):
            w0, top = max(lo - 1, 0), min(hi + 1, n0)  # u rows read; h' rows [lo, top)
            div = None
            for a, u in enumerate(uc):
                win = u[w0:top]
                d = cH[a] * (win - S._shift(win, a, +1))
                div = d if div is None else div + d
            hp = (hc[w0:top] - div)[lo - w0:]
            for a, u in enumerate(uc):
                ua = Mc[a][lo:top] * (u[lo:top] - cg[a] * (S._shift(hp, a, -1) - hp))
                u_new[a][lo:hi] = ua[:hi - lo]
            h_new[lo:hi] = hp[:hi - lo]
        hc, uc = h_new, u_new
    return hc.to(h.dtype), tuple(u.to(h.dtype) for u in uc)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,cluster", SPLITS)
def test_swe_band_decomposition_equals_the_whole_block_bitwise(shape, cluster, dtype):
    h, us, Mus = _swe_state(shape, dtype)
    cH, cg = S.swe_coeffs(0.013, (0.1, 0.07, 0.05)[:len(shape)], 1.3, 0.9)
    want_h, want_us = S.swe_multi_step_plain(h, us, Mus, cH, cg, 5)
    got_h, got_us = _swe_emulated(h, us, Mus, cH, cg, 5, cluster)
    assert torch.equal(got_h, want_h)
    assert all(torch.equal(g, w) for g, w in zip(got_us, want_us))


def test_the_emulation_needs_the_neighbour_rows():
    # Bands that read zeros where their neighbours' edge rows belong (no
    # exchange between CTAs) do not give the whole block: the bitwise
    # tests above can fail.
    U, Uprev, M, Cw = _wave_operands((40, 24), "f64")
    inv_d2 = K.inv_d2_of((0.1, 0.1))
    want = W.wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, 5, "aform")
    got = _wave_emulated(U, Uprev, M, Cw, inv_d2, 5, "aform", 2, halo=0)
    assert not torch.equal(got[0], want[0])


# ---------------------------------------------------------------------------
# multi_step_cm on the cluster route ("diffusion")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,rows", [((252, 252), 16), ((253, 251), 16), ((96, 64, 48), 6)])
def test_diffusion_shared_bytes_are_two_haloed_buffers_and_staged_cm(shape, rows, dtype,
                                                                     stage):
    tdt = DTYPES[dtype]
    csize = 8 if dtype == "f64" else 4
    ssize = {"f32": 4, "f64": 8, "bf16": 2}[dtype]
    plane = int(np.prod(shape[1:]))
    want = 16 + 2 * (rows + 2) * plane * csize + (rows * plane * ssize if stage else 0)
    assert R.smem_bytes("diffusion", shape, tdt, rows, stage) == want


def test_the_kernel_constants_are_read_from_the_sources():
    assert R.reg_cells() == 8
    src = (_build.CSRC / "multistep.cu").read_text()
    assert "constexpr int kRegCells = 8;" in src
    assert "constexpr int kResidentThreads = 1024;" in (_build.CSRC / "resident.cuh").read_text()


@pytest.mark.parametrize("shape,rows,cells", [
    ((252, 252), 16, 4),       # 8 warp-columns × 4 segments of 4 rows: 32 warps
    ((316, 316), 20, 7),       # 10 × 3 segments of 7, 7 and 6 rows
    ((253, 251), 16, 4),
    ((724, 150), 46, 8),       # 5 × 6 segments of 8
    ((724, 200), 46, 12),      # 7 × 4 segments of 12: more than kRegCells
    ((10, 40), 1, 1),          # a single row a band
    ((6, 5, 7), 1, 1),         # 5 warp-columns of a plane
    ((96, 64, 48), 6, None),   # 128 warp-columns: more than 32 warps
])
def test_reg_rows_is_a_warps_run(shape, rows, cells):
    assert R.reg_rows(shape, rows) == cells


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(252, 252), (316, 316), (253, 251), (10, 40), (6, 5, 7)])
def test_diffusion_keeps_cm_in_registers_on_the_main_blocks(shape, dtype, caps):
    # At C = 16 every block here keeps Cm in registers; a card granting only
    # 8 doubles the bands, and 316² (runs of 14 rows) stages Cm instead.
    plan = R.plan("diffusion", shape, DTYPES[dtype], CAPS[caps])
    assert plan.route == "cluster"
    assert plan.cluster == min(CAPS[caps].cluster, shape[0])
    assert plan.registers == (R.reg_rows(shape, plan.rows) <= R.reg_cells())
    assert plan.registers or caps == "c8"
    if plan.registers:
        assert not plan.stage and MS.cm_at(plan) == 2
        assert plan.nbytes == R.smem_bytes("diffusion", shape, DTYPES[dtype], plan.rows, False)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_diffusion_plans_place_cm_by_what_fits(dtype):
    # Registers while a warp's run has at most kRegCells rows, then staged
    # in shared memory while that fits, then device memory, then the
    # cooperative route: along the rows of the 724-row capacity edge.
    tdt = DTYPES[dtype]
    seen = []
    for n1 in range(8, 800, 8):
        plan = R.plan("diffusion", (724, n1), tdt, H100_CAPS)
        where = ("cooperative" if plan.route == "cooperative" else
                 "registers" if plan.registers else "shared" if plan.stage else "device")
        if not seen or seen[-1] != where:
            seen.append(where)
        if plan.route == "cluster":
            assert MS.cm_at(plan) == {"registers": 2, "shared": 1, "device": 0}[where]
    assert seen == ["registers", "shared", "device", "cooperative"]


def test_multi_step_cm_plans_ask_the_card_once_per_instantiation(monkeypatch):
    calls = []

    class Lib:
        rmt_multi_step_cm_caps = "diffusion"

    def query(fn, index, *args):
        calls.append((fn, index, args))
        return H100_CAPS

    monkeypatch.setattr(_build, "load", lambda name, signatures: Lib)
    monkeypatch.setattr(R, "query_caps", query)
    MS.device_caps.cache_clear()
    MS.device_plan.cache_clear()
    try:
        for _ in range(3):
            assert MS.device_plan(0, (252, 252), torch.float32, "eqc") == \
                R.plan("diffusion", (252, 252), torch.float32, H100_CAPS)
            MS.device_plan(0, (316, 316), torch.float32, "eqc")
            MS.device_plan(0, (316, 316), torch.float32, "direct")
        assert calls == [("diffusion", 0, (0, 2, MS.FORMS["eqc"])),
                         ("diffusion", 0, (0, 2, MS.FORMS["direct"]))]
    finally:
        MS.device_caps.cache_clear()
        MS.device_plan.cache_clear()


def test_cpu_multi_step_never_plans_a_route(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU call asked for a device plan")

    monkeypatch.setattr(MS, "device_plan", refuse)
    T = torch.rand(12, 10, dtype=torch.float64)
    MS.multi_step(T, 1e-3 * torch.ones_like(T), (1.0, 1.0), 3, "eqc")


def _diffusion_operands(shape, dtype, seed=2):
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]
    T = torch.from_numpy(rng.random(shape)).to(tdt)
    Cm = torch.from_numpy(rng.random(shape) * 2e-3).to(tdt)
    return T, Cm


def _diffusion_emulated(T, Cm, inv_d2, n, form, cluster, halo=1):
    """The cluster route in plain PyTorch: each step, each band's new rows
    from its own rows and the `halo` rows just outside it, which its
    neighbours traded the step before (zeros beyond the block), in the
    compute type, rounded once."""
    cdt = K._compute_dtype(T.dtype)
    Tc, Cmc = T.to(cdt), Cm.to(cdt)
    n0 = T.shape[0]
    for _ in range(n):
        new = torch.empty_like(Tc)
        for lo, hi in R.bands(n0, cluster):
            w0, w1 = max(lo - halo, 0), min(hi + halo, n0)
            stepped = MS.multi_step_cm_plain(Tc[w0:w1], Cmc[w0:w1], inv_d2, 1, form)
            new[lo:hi] = stepped[lo - w0:hi - w0]
        Tc = new
    return Tc.to(T.dtype)


# Blocks of the diffusion emulation: the main paths' 252² and 316², a
# ragged split, a block with fewer rows than the cluster's CTAs (a band a
# row), and 3D.
DIFFUSION_SPLITS = [((252, 252), 16), ((316, 316), 16), ((253, 251), 16), ((253, 251), 8),
                    ((10, 40), 16), ((20, 9, 7), 16), ((8, 6, 5), 8), ((6, 5, 7), 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", list(MS.FORMS))
@pytest.mark.parametrize("shape,granted", DIFFUSION_SPLITS)
def test_diffusion_band_decomposition_equals_the_whole_block_bitwise(shape, granted, form,
                                                                     dtype):
    plan = R.plan("diffusion", shape, DTYPES[dtype], R.Caps(granted, H100_SMEM_OPTIN))
    assert plan.route == "cluster" and plan.cluster == min(granted, shape[0])
    T, Cm = _diffusion_operands(shape, dtype)
    spacing = (0.1,) * len(shape) if form in ("eqc", "conly") else (0.1, 0.07, 0.05)[:len(shape)]
    inv_d2 = K.inv_d2_of(spacing)
    want = MS.multi_step_cm_plain(T, Cm, inv_d2, 5, form)
    got = _diffusion_emulated(T, Cm, inv_d2, 5, form, plan.cluster)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("form,n", [("eqc", 8), ("ac", 8), ("direct", 3), ("conly", 8)])
@pytest.mark.parametrize("shape", [(40, 36), (12, 10, 8)])
def test_diffusion_band_decomposition_matches_jax(shape, form, n, cluster):
    # f64, the block's edge held (the one-GPU deep block): the JAX kernel's
    # wrapping rolls meet only held cells. multi_step_cm picks eqc, A/c or
    # direct by spacing and step count, as the port's wrapper does; conly
    # only through fused_multi_step's body_form.
    rng = np.random.default_rng(5)
    T = rng.random(shape)
    Cp = 1.0 + rng.random(shape)
    lam, dt = 1.1, 1e-4
    spacing = (0.3, 0.4, 0.5)[:len(shape)] if form == "ac" else (0.3,) * len(shape)
    inv_d2 = K.inv_d2_of(spacing)
    Cm = K.edge_masked_cm(torch.from_numpy(T), torch.from_numpy(Cp), lam, dt)
    if form == "conly":
        ref = pk.fused_multi_step(jnp.asarray(T), jnp.asarray(Cp), lam, dt, spacing, n,
                                  chunk=n, body_form="conly")
    else:
        assert MS.multi_step_form(shape, torch.float64, n, inv_d2) == form
        ref = pk.multi_step_cm(jnp.asarray(T), jnp.asarray(Cm.numpy()), spacing, n)
    got = _diffusion_emulated(torch.from_numpy(T), Cm, inv_d2, n, form, min(cluster, shape[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_the_diffusion_emulation_needs_the_neighbour_rows():
    # Without the traded halo rows the bands do not give the whole block.
    T, Cm = _diffusion_operands((40, 24), "f64")
    inv_d2 = K.inv_d2_of((0.1, 0.1))
    want = MS.multi_step_cm_plain(T, Cm, inv_d2, 5, "eqc")
    assert not torch.equal(_diffusion_emulated(T, Cm, inv_d2, 5, "eqc", 2, halo=0), want)
