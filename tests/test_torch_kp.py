"""The kp rung and fused_step_padded of the port (rocm_mpi_tpu_torch/ops/kp.py,
ops/kernels.py) against the Pallas kernels they port, run as the JAX
package's own tests run them on the CPU (interpret mode): each of the
three kp stages and the whole padded step, fused_step_padded on both of
its JAX routes, the `kp` variant on one rank and on 4 gloo ranks, the kp
app, and the error cases. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rocm_mpi_tpu.ops.pallas_kernels as pk
import test_torch_rank_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import kp
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.state import tensor_from_numpy
from test_torch_kernels import NP, TOL

REPO = pathlib.Path(__file__).resolve().parent.parent
LAM, DT = 1.3, 1e-4
SPACING = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}
# Padded 2D blocks: an even core (32, 28) and an odd, unequal one (33, 27),
# where an off-by-one on qx's extra row or qy's extra column shows.
KP_PADDED = [(34, 30), (35, 29)]


def _kp_inputs(padded, dtype, seed=0):
    rng = np.random.default_rng(seed)
    lx, ly = padded[0] - 2, padded[1] - 2
    Tp = rng.random(padded).astype(dtype)
    Cp = (1.0 + rng.random((lx, ly))).astype(dtype)
    qx = (rng.random((lx + 1, ly)) - 0.5).astype(dtype)
    qy = (rng.random((lx, ly + 1)) - 0.5).astype(dtype)
    dTdt = (rng.random((lx, ly)) - 0.5).astype(dtype)
    return Tp, Cp, qx, qy, dTdt


def _pallas(kernel, out_shapes, *args, **params):
    """One of kp_step_padded's kernel bodies as its own pallas_call, in
    interpret mode, whole arrays in and out as kp_step_padded calls it."""
    structs = tuple(jax.ShapeDtypeStruct(s, args[0].dtype) for s in out_shapes)
    res = pl.pallas_call(functools.partial(kernel, **params),
                         out_shape=structs if len(structs) > 1 else structs[0],
                         interpret=True)(*(jnp.asarray(a) for a in args))
    return tuple(np.asarray(r) for r in res) if len(structs) > 1 else (np.asarray(res),)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("padded", KP_PADDED, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("stage", ["flux", "residual", "update", "step"])
def test_kp_stage_matches_pallas(stage, padded, dtype):
    Tp, Cp, qx, qy, dTdt = _kp_inputs(padded, NP[dtype])
    lx, ly = Cp.shape
    sp = SPACING[2]
    inv_d = tuple(1.0 / d for d in sp)
    if stage == "flux":
        ref = _pallas(pk._flux_kernel, ((lx + 1, ly), (lx, ly + 1)), Tp, lam=LAM, inv_d=inv_d)
        got = kp.kp_flux(*_t(Tp), LAM, sp)
        plain = kp.kp_flux_plain(*_t(Tp), LAM, inv_d)
    elif stage == "residual":
        ref = _pallas(pk._residual_kernel, ((lx, ly),), qx, qy, Cp, inv_d=inv_d)
        got = (kp.kp_residual(*_t(qx, qy, Cp), sp),)
        plain = (kp.kp_residual_plain(*_t(qx, qy, Cp), inv_d),)
    elif stage == "update":
        ref = _pallas(pk._update_kernel, ((lx, ly),), Tp, dTdt, dt=DT)
        got = (kp.kp_update(*_t(Tp, dTdt), DT),)
        plain = (kp.kp_update_plain(*_t(Tp, dTdt), DT),)
    else:
        ref = (np.asarray(pk.kp_step_padded(jnp.asarray(Tp), jnp.asarray(Cp), LAM, DT, sp)),)
        got = (kp.kp_step_padded(*_t(Tp, Cp), LAM, DT, sp),)
        plain = (kp.kp_update_plain(torch.from_numpy(Tp), kp.kp_residual_plain(
            *kp.kp_flux_plain(torch.from_numpy(Tp), LAM, inv_d), torch.from_numpy(Cp), inv_d),
            DT),)
    assert len(got) == len(ref)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == p.dtype and g.numpy().dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, p)  # a CPU tensor takes the plain version
        np.testing.assert_allclose(g.numpy(), r, **TOL[dtype])


# Both fused_step_padded routes of the JAX package: the whole-block kernel,
# and the row-striped kernel with the VMEM budget shrunk so a small block
# takes it, as tests/test_torch_kernels.py does for fused_step_cm.
ROUTES = {"whole": None, "striped": 1024}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("core", [(32, 28), (33, 27), (12, 10, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_step_padded_matches_pallas(core, route, dtype, monkeypatch):
    if ROUTES[route] is not None:
        monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", ROUTES[route])
    rng = np.random.default_rng(3)
    Tp = rng.random(tuple(n + 2 for n in core)).astype(NP[dtype])
    Cp = (1.0 + rng.random(core)).astype(NP[dtype])
    sp = SPACING[len(core)]
    ref = np.asarray(pk.fused_step_padded(jnp.asarray(Tp), jnp.asarray(Cp), LAM, DT, sp))
    got = K.fused_step_padded(*_t(Tp, Cp), LAM, DT, sp)
    assert torch.equal(got, K.fused_step_padded_plain(*_t(Tp, Cp), LAM, DT,
                                                      K.inv_d2_of(sp)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL[dtype])


def _bf16(a):
    return jnp.asarray(a, dtype=jnp.bfloat16)


@pytest.mark.parametrize("fn", ["kp_step_padded", "fused_step_padded"])
def test_bf16_is_storage_only(fn):
    # bf16 in and out, f32 arithmetic inside each launch. kp rounds at each
    # of its three stores (qx, qy, dTdt are bf16 between the TPU kernels
    # too); fused_step_padded rounds once. JAX's kernels follow the same
    # contract, so they agree to within a bf16 rounding of the result.
    Tp, Cp, *_ = _kp_inputs((34, 30), np.float32)
    Tp_j, Cp_j = _bf16(Tp), _bf16(Cp)
    Tp_t, Cp_t = (tensor_from_numpy(np.asarray(a)) for a in (Tp_j, Cp_j))
    sp = SPACING[2]
    if fn == "kp_step_padded":
        got = kp.kp_step_padded(Tp_t, Cp_t, LAM, DT, sp)
        inv_d = kp.inv_d_of(sp)
        qx, qy = (q.to(torch.bfloat16) for q in kp.kp_flux_plain(Tp_t.float(), LAM, inv_d))
        dTdt = kp.kp_residual_plain(qx.float(), qy.float(), Cp_t.float(), inv_d)
        want = kp.kp_update_plain(Tp_t.float(), dTdt.to(torch.bfloat16).float(), DT)
        ref = pk.kp_step_padded(Tp_j, Cp_j, LAM, DT, sp)
    else:
        got = K.fused_step_padded(Tp_t, Cp_t, LAM, DT, sp)
        want = K.fused_step_padded(Tp_t.float(), Cp_t.float(), LAM, DT, sp)
        ref = pk.fused_step_padded(Tp_j, Cp_j, LAM, DT, sp)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               rtol=2 ** -7, atol=0)


def _one_rank(dtype, shape=(64, 64), nt=30):
    cfg = DiffusionConfig(global_shape=shape, nt=nt, warmup=0, dtype=dtype, dims=(1, 1))
    return HeatDiffusion(cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kp_run_matches_jax_one_rank(dtype):
    jcfg = JaxConfig(global_shape=(64, 64), nt=30, warmup=0, dtype=dtype, dims=(1, 1))
    ref = np.asarray(JaxHeatDiffusion(jcfg, devices=jax.devices()[:1]).run(variant="kp").T)
    got = _one_rank(dtype).run("kp").T.numpy()
    np.testing.assert_allclose(got, ref, **TOL[dtype])


def test_kp_run_matches_ap():
    # The JAX package's own bound for kp against ap
    # (tests/test_pallas_kernels.py, kp on a mesh).
    model = _one_rank("f64")
    np.testing.assert_allclose(model.run("kp").T.numpy(), model.run("ap").T.numpy(),
                               rtol=1e-13, atol=1e-15)


def test_kp_step_is_kp_step_padded_between_exchange_and_select():
    # The variant's step is the shard step around kp_step_padded: the
    # same exchange and Dirichlet select, the three stages in between.
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    model = _one_rank("f64", shape=(24, 20), nt=5)
    T, Cp = model.init_state()
    cfg = model.config
    ref = T
    for _ in range(cfg.nt):
        new = kp.kp_step_padded(exchange_halo(ref, model.grid), Cp, cfg.lam, float(model.dt),
                                cfg.spacing)
        ref = torch.where(model._mask, ref, new)
    assert torch.equal(model.run("kp").T, ref)
    assert "kp" in model.variants


SHARD_SHAPE, SHARD_NT = (32, 24), 8
SHARD_CASES = [("f64", (2, 2)), ("f64", (4, 1)), ("f32", (2, 2))]


@pytest.fixture(scope="module")
def kp_ranks():
    spec = dict(shape=SHARD_SHAPE, nt=SHARD_NT, cases=SHARD_CASES)
    return spawn_ranks(4, worker.run_kp_rank, (spec,), backend="gloo", timeout=240)


@pytest.mark.parametrize("dtype,dims", SHARD_CASES, ids=lambda v: str(v))
def test_sharded_kp_matches_jax_4_device(kp_ranks, dtype, dims):
    jcfg = JaxConfig(global_shape=SHARD_SHAPE, nt=SHARD_NT, warmup=0, dtype=dtype, dims=dims)
    ref = np.asarray(JaxHeatDiffusion(jcfg, devices=jax.devices()[:4]).run(variant="kp").T)
    np.testing.assert_allclose(kp_ranks[0]["runs"][(dtype, dims)], ref, **TOL[dtype])
    assert all(r["runs"][(dtype, dims)] is None for r in kp_ranks[1:])


@pytest.mark.parametrize("dtype,dims", SHARD_CASES, ids=lambda v: str(v))
def test_sharded_kp_equals_one_rank_bitwise(kp_ranks, dtype, dims):
    # Every face flux takes the same two cells in the same order whether
    # its neighbour is a ghost or not: the gathered field is the one-rank
    # field bit for bit, a check of the exchange.
    one = _one_rank(dtype, shape=SHARD_SHAPE, nt=SHARD_NT).run("kp").T.numpy()
    np.testing.assert_array_equal(kp_ranks[0]["runs"][(dtype, dims)], one)


def test_sharded_kp_launches_no_kernel_on_cpu(kp_ranks):
    for r in kp_ranks:
        assert set(r["launches"].values()) == {0}


def test_kp_absent_on_a_3d_grid():
    # Registered on 2D grids only, as in the JAX package: a 3D run("kp")
    # raises the same "unknown variant" error, listing the same variants.
    shape3 = dict(global_shape=(8, 8, 8), lengths=(10.0,) * 3, nt=2, warmup=0, dims=(1, 1, 1))
    model = HeatDiffusion(DiffusionConfig(**shape3), device="cpu")
    jmodel = JaxHeatDiffusion(JaxConfig(**shape3), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="unknown variant 'kp'") as got:
        model.run("kp")
    with pytest.raises(ValueError, match="unknown variant 'kp'") as want:
        jmodel.run(variant="kp")
    assert str(got.value) == str(want.value)
    assert "kp" in _one_rank("f64", shape=(8, 8)).variants


def test_kp_step_padded_rejects_3d():
    Tp, Cp = np.zeros((6, 6, 6)), np.ones((4, 4, 4))
    with pytest.raises(ValueError, match="2D-only") as got:
        kp.kp_step_padded(*_t(Tp, Cp), LAM, DT, SPACING[3])
    with pytest.raises(ValueError, match="2D-only") as want:
        pk.kp_step_padded(jnp.asarray(Tp), jnp.asarray(Cp), LAM, DT, SPACING[3])
    assert str(want.value) in str(got.value)


def test_wrappers_refuse_bad_operands():
    Tp, Cp, qx, qy, dTdt = _t(*_kp_inputs((12, 10), np.float64))
    sp = SPACING[2]
    with pytest.raises(ValueError, match="must not alias"):
        kp.kp_update(Tp, dTdt, DT, out=dTdt)
    with pytest.raises(ValueError, match="out must be"):
        kp.kp_flux(Tp, LAM, sp, out=(torch.empty_like(qy), torch.empty_like(qy)))
    with pytest.raises(ValueError, match="must not alias"):
        q = torch.empty(qx.numel() + qy.numel() - 1, dtype=qx.dtype)
        kp.kp_flux(Tp, LAM, sp, out=(q[:qx.numel()].view(qx.shape),
                                     q[-qy.numel():].view(qy.shape)))
    with pytest.raises(ValueError, match="qx shape"):
        kp.kp_residual(qy, qx, Cp, sp)
    with pytest.raises(TypeError, match="dtype"):
        kp.kp_residual(qx.float(), qy, Cp, sp)
    with pytest.raises(ValueError, match="must not alias"):
        K.fused_step_padded(Tp, Cp, LAM, DT, sp, out=Cp)
    with pytest.raises(ValueError, match="Cp shape"):
        K.fused_step_padded(Tp, dTdt[1:], LAM, DT, sp)
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        kp.kp_update(Tp.to("meta"), dTdt.to("meta"), DT)
    # Written into `out` when given, and equal to the allocating call.
    out = torch.empty_like(Cp)
    assert kp.kp_step_padded(Tp, Cp, LAM, DT, sp, out=out) is out
    assert torch.equal(out, kp.kp_step_padded(Tp, Cp, LAM, DT, sp))


def _update_cases():
    """(label, Tp, dTdt, out) operand sets of kp_update: one good, the rest
    each wrong in one way that check_operands refuses."""
    Tp, _, _, _, dTdt = _t(*_kp_inputs((12, 10), np.float64))
    out = torch.empty_like(dTdt)
    big = torch.empty(2 * dTdt.numel())
    return [
        ("good", Tp, dTdt, out),
        ("out dtype", Tp, dTdt, out.float()),
        ("dTdt dtype", Tp, dTdt.float(), out),
        ("out shape", Tp, dTdt, torch.empty(dTdt.shape[0], dTdt.shape[1] + 1,
                                            dtype=torch.float64)),
        ("dTdt shape", Tp, dTdt[1:], out),
        ("Tp strided", Tp.t(), dTdt.t().contiguous(), out.t().contiguous()),
        ("out strided", Tp, dTdt, torch.empty(dTdt.shape[1], dTdt.shape[0],
                                              dtype=torch.float64).t()),
        ("out is dTdt", Tp, dTdt, dTdt),
        ("out inside Tp", Tp, dTdt, Tp.view(-1)[:dTdt.numel()].view(dTdt.shape)),
        ("out straddles dTdt", Tp, big[:dTdt.numel()].view(dTdt.shape),
         big[dTdt.numel() // 2:dTdt.numel() // 2 + dTdt.numel()].view(dTdt.shape)),
    ]


@pytest.mark.parametrize("case", _update_cases(), ids=lambda c: c[0])
def test_kp_update_plain_checks_agree_with_check_operands(case, monkeypatch):
    """check_operands' plain comparisons pass exactly the kp_update operands
    that its full checks pass; a refused set then raises the full checks'
    error from kp_update."""
    label, Tp, dTdt, out = case
    lx, ly = Tp.shape[0] - 2, Tp.shape[1] - 2
    ok = K._operands_ok(Tp, {"dTdt": dTdt}, (lx, ly), None, out)
    with monkeypatch.context() as m:
        m.setattr(K, "_operands_ok", lambda *args: False)  # the full checks alone
        try:
            K.check_operands("kp_update", Tp, {"dTdt": dTdt}, (lx, ly), None, out)
            accepted = True
        except (TypeError, ValueError):
            accepted = False
    assert ok == accepted == (label == "good")
    if not ok:
        with pytest.raises((TypeError, ValueError)):
            kp.kp_update(Tp, dTdt, DT, out=out)
    else:
        assert kp.kp_update(Tp, dTdt, DT, out=out) is out


@pytest.mark.parametrize("variant", ["kp", "ap"])
def test_app_saves_the_runs_field(variant, tmp_path):
    path = tmp_path / "T.npy"
    cmd = [sys.executable, "-m", f"rocm_mpi_tpu_torch.apps.diffusion_2d_{variant}",
           "--device", "cpu", "--nx", "32", "--ny", "32", "--nt", "20",
           "--save-field", str(path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "not a GPU measurement" in proc.stdout and f"wrote {path}" in proc.stdout
    cfg = DiffusionConfig(global_shape=(32, 32), lengths=(10.0, 10.0), nt=20, warmup=10,
                          dtype="f64")
    want = HeatDiffusion(cfg, device="cpu").run(variant).T.numpy()
    np.testing.assert_array_equal(np.load(path), want)


# ---------------------------------------------------------------------------
# kp_flux's lane tiling (csrc/kp.cu rmt_kp_flux_kernel)
# ---------------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _kp_constant(name):
    from rocm_mpi_tpu_torch.ops import resident

    return resident._constant("kp.cu", name)


def _lane_tiled_flux(Tp, lam, inv_d, vec, run_rows=None, outer=True):
    """kp_flux's lane tiling in plain PyTorch: a warp's strip of 32·W
    columns walked down runs of qx rows (the launcher's run length, read
    from kp.cu, unless `run_rows`), with R_r[j] = Tp[r, j + 1]: lane l's
    cells l·W + e (`vec`, the 16-byte vectors) or l + 32·e (scalar
    cells), cells past column
    ly 0; qx row i = R_{i+1} - R_i; qy row i =
    R_{i+1}[j] - R_{i+1}[j - 1], the left neighbour from the lane's own
    cells or the lane before (a shift across lanes for vectors, a rotation
    for scalar cells) and, for the strip's first cell, lane 0's outer load
    R[first - 1]; where the strips end at ly, qy's extra column from lane
    31's outer load R[ly] (both outer cells 0 when not `outer`). With
    vectors, qy goes through the warp's staging row: lane-major in, cell
    first + 32·e + lane out. In the kernel's operation order, rounded once
    a store."""
    cdt = K._compute_dtype(Tp.dtype)
    w = K.LANE_CELLS[Tp.dtype]
    lx, ly = Tp.shape[0] - 2, Tp.shape[1] - 2
    assert not vec or ly % w == 0
    strips = -(-ly // (32 * w))
    width = strips * 32 * w
    if run_rows is None:
        longest = "kFluxRunRowsBf16" if Tp.dtype == torch.bfloat16 else "kFluxRunRows"
        run_rows = strips * (lx + 1) // _kp_constant("kFluxFillWarps")
        run_rows = min(max(run_rows, 1), _kp_constant(longest))
    # Rz[r, j + 1] = R_r[j] for j = -1 .. ly, 0 past it (to width + 1)
    Rz = torch.zeros(lx + 2, width + 2, dtype=cdt)
    Rz[:, :ly + 2] = Tp.to(cdt)
    lane = torch.arange(32)[:, None]
    e = torch.arange(w)[None, :]
    idx = lane * w + e if vec else lane + 32 * e
    qx = torch.zeros(lx + 1, width, dtype=cdt)
    qy = torch.zeros(lx, width + 1, dtype=cdt)
    zero = torch.zeros((), dtype=cdt)
    for s in range(strips):
        first = s * 32 * w
        cols = first + idx
        ends = first + 32 * w == ly  # lane 31's outer cell is R[ly]

        def row(r):  # past the last row: the load a run never makes
            return Rz[r][cols + 1] if r <= lx + 1 else torch.zeros(32, w, dtype=cdt)

        for r0 in range(0, lx + 1, run_rows):
            lo, hi = row(r0), row(r0 + 1)
            for i in range(r0, min(r0 + run_rows, lx + 1)):
                qx[i, cols] = ((-lam) * (hi - lo)) * inv_d[0]
                if i < lx:
                    h = hi
                    if vec:
                        left = torch.cat([torch.roll(h[:, -1], 1)[:, None], h[:, :-1]], 1)
                    else:
                        rot_l = torch.roll(h, 1, dims=0)
                        left = rot_l.clone()
                        left[0, 1:] = rot_l[0, :-1]
                    left[0, 0] = Rz[i + 1, first] if outer else zero
                    oy = ((-lam) * (h - left)) * inv_d[1]
                    if vec:
                        staged = oy.reshape(-1)  # lane-major: cell l·W + e
                        for k in range(w):
                            qy[i, first + 32 * k + torch.arange(32)] = staged[32 * k:32 * k + 32]
                    else:
                        qy[i, cols] = oy
                    if ends:
                        right = Rz[i + 1, ly + 1] if outer else zero
                        qy[i, ly] = ((-lam) * (right - h[31, w - 1])) * inv_d[1]
                lo, hi = hi, row(i + 2)
    return qx[:, :ly].to(Tp.dtype), qy[:, :ly + 1].to(Tp.dtype)


# Padded blocks: ragged rows (53, 45 fit no lane width; 300 fits f32's and
# f64's but not bf16's), whole ones (40), and rows the strips end at (256:
# two strips in f32, four in f64, one in bf16; 128: one in f32), where
# lane 31 writes qy's extra column. Both tiled layouts the kernel builds:
# scalar cells in every dtype, the vectors outside f64. One cell a thread
# is the per-cell arithmetic of the plain version.
FLUX_CASES = [(core, dtype, vec) for core in [(37, 53), (9, 300), (11, 256), (7, 45),
                                              (6, 40), (4, 128)]
              for dtype in DTYPES for vec in (False, True)
              if not vec or (dtype != "f64" and core[1] % K.LANE_CELLS[DTYPES[dtype]] == 0)]


def _flux_input(core, tdt, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(tuple(n + 2 for n in core))).to(tdt)


@pytest.mark.parametrize("run_rows", [None, 4])
@pytest.mark.parametrize("core,dtype,vec", FLUX_CASES)
def test_flux_lane_tiling_equals_the_plain_flux_bitwise(core, dtype, vec, run_rows):
    Tp = _flux_input(core, DTYPES[dtype], 11)
    inv_d = kp.inv_d_of(SPACING[2])
    got = _lane_tiled_flux(Tp, LAM, inv_d, vec, run_rows)
    want = kp.kp_flux_plain(Tp, LAM, inv_d)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("core", [(5, 300), (5, 256)])
@pytest.mark.parametrize("vec", [False, True])
def test_the_flux_lane_tiling_needs_the_outer_loads(core, vec):
    # Without lane 0's load of R[first - 1] (and, where the strips end at
    # ly, lane 31's of R[ly]) qy is not the flux: the test above can fail.
    Tp = _flux_input(core, torch.float32, 12)
    inv_d = kp.inv_d_of(SPACING[2])
    qx, qy = _lane_tiled_flux(Tp, LAM, inv_d, vec, outer=False)
    want_x, want_y = kp.kp_flux_plain(Tp, LAM, inv_d)
    assert torch.equal(qx, want_x) and not torch.equal(qy, want_y)
    if core[1] == 256:  # the extra column alone differs at the strips' end
        assert not torch.equal(qy[:, -1], want_y[:, -1])


def test_flux_vectors_only_on_the_16_byte_grid():
    # The wrapper allows the vectors (masked_layout over qx alone) for rows
    # of whole 16-byte lanes with qx on the 16-byte grid, never in f64; the
    # launcher takes one cell a thread below the fill whatever it allows.
    base = 1 << 20
    for dtype, tdt in DTYPES.items():
        w = K.LANE_CELLS[tdt]
        item = 16 // w
        vec = dtype != "f64"
        assert K.masked_layout(12288, tdt, base) == vec
        assert K.masked_layout(3 * w, tdt, base + 4096) == vec
        for ragged in (12287, w + 1, 1):
            assert not K.masked_layout(ragged, tdt, base)
        assert not K.masked_layout(12288, tdt, base + item)  # qx off the grid


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kp_flux_wrapper_passes_its_verdict_to_the_kernel(dtype, monkeypatch):
    # With the dispatch forced to the kernel path on CPU tensors, the
    # launch receives masked_layout's verdict over qx as its last argument
    # (Tp and qy, read and written cell by cell, play no part), and
    # flux_layout asks the launcher's query with the same verdict.
    tdt = DTYPES[dtype]
    w = K.LANE_CELLS[tdt]
    calls, asked = [], []
    monkeypatch.setattr(kp, "use_kernel", lambda *t: True)
    monkeypatch.setattr(kp, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(kp, "launch_layout", lambda *args: asked.append(args))
    K.reset_launches()
    sp = SPACING[2]

    def run(Tp, out=None):
        kp.kp_flux(Tp, LAM, sp, out=out)
        qx = out[0] if out is not None else torch.zeros(Tp.shape[0] - 1, Tp.shape[1] - 2,
                                                        dtype=tdt)
        kp.flux_layout(Tp, qx)
        assert asked[-1][3:] == (K._DTYPE_CODE[tdt], Tp.shape[0] - 2, Tp.shape[1] - 2,
                                 calls[-1][-1])
        return calls[-1][-1]

    lx, ly = 12, 4 * w
    vec = dtype != "f64"
    Tp = torch.zeros(lx + 2, ly + 2, dtype=tdt)
    assert run(Tp) == vec
    assert run(torch.zeros(lx + 2, ly + 3, dtype=tdt)) is False  # ragged
    qx_off = torch.zeros((lx + 1) * ly + 1, dtype=tdt)[1:].view(lx + 1, ly)
    qy = torch.zeros(lx, ly + 1, dtype=tdt)
    assert run(Tp, (qx_off, qy)) is False
    qy_off = torch.zeros(lx * (ly + 1) + 1, dtype=tdt)[1:].view(lx, ly + 1)
    assert run(Tp, (torch.zeros(lx + 1, ly, dtype=tdt), qy_off)) == vec
    Tp_off = torch.zeros(Tp.numel() + 1, dtype=tdt)[1:].view(Tp.shape)
    assert run(Tp_off) == vec
    assert K.LAUNCHES["kp_flux"] == 5
    K.reset_launches()


# ---------------------------------------------------------------------------
# kp_residual's lane tiling (csrc/kp.cu rmt_kp_residual_kernel)
# ---------------------------------------------------------------------------


def _lane_tiled_residual(qx, qy, Cp, inv_d, vec, run_rows=None, extra=True):
    """kp_residual's lane tiling in plain PyTorch: a warp's strip of 32·W
    columns walked down runs of core rows (the launcher's run length, read
    from kp.cu, unless `run_rows`), qx row i + 1 loaded one row ahead and
    kept as the next row's row i. Lane l's cells l·W + e (`vec`) or
    l + 32·e (scalar cells); qy's j + 1 neighbour from the lane's own next
    cell or the lane after (a shift across lanes for vectors, a rotation
    for scalar cells) and, for the strip's last cell, lane 31's load of
    qy[i, first + 32·W] where it lies in the row (0 when not `extra`). In
    the kernel's operation order, rounded once a store."""
    cdt = K._compute_dtype(Cp.dtype)
    w = K.LANE_CELLS[Cp.dtype]
    lx, ly = Cp.shape
    assert not vec or ly % w == 0
    if run_rows is None:
        strips = -(-ly // (32 * w))
        longest = "kResRunRowsBf16" if Cp.dtype == torch.bfloat16 else "kResRunRows"
        run_rows = strips * lx // _kp_constant("kResFillWarps")
        run_rows = min(max(run_rows, 1), _kp_constant(longest))
    strips = -(-ly // (32 * w))
    width = strips * 32 * w
    # Zero past the row: qx and Cp past ly, qy past its ly + 1 cells.
    X = torch.zeros(lx + 1, width, dtype=cdt)
    X[:, :ly] = qx.to(cdt)
    Y = torch.zeros(lx, width + 1, dtype=cdt)
    Y[:, :ly + 1] = qy.to(cdt)
    P = torch.ones(lx, width, dtype=cdt)
    P[:, :ly] = Cp.to(cdt)
    lane = torch.arange(32)[:, None]
    e = torch.arange(w)[None, :]
    idx = lane * w + e if vec else lane + 32 * e
    out = torch.zeros(lx, width, dtype=cdt)
    zero = torch.zeros((), dtype=cdt)
    for s in range(strips):
        first = s * 32 * w
        cols = first + idx
        for r0 in range(0, lx, run_rows):
            lo, hi = X[r0][cols], X[r0 + 1][cols]
            for i in range(r0, min(r0 + run_rows, lx)):
                y = Y[i][cols]
                outer = Y[i, first + 32 * w] if extra and first + 32 * w <= ly else zero
                if vec:
                    right = torch.cat([y[:, 1:], torch.roll(y[:, 0], -1)[:, None]], 1)
                else:
                    rot_r = torch.roll(y, -1, dims=0)
                    right = rot_r.clone()
                    right[31, :-1] = rot_r[31, 1:]
                right[31, w - 1] = outer
                div = (hi - lo) * inv_d[0] + (right - y) * inv_d[1]
                out[i, cols] = (-div) / P[i][cols]
                if i + 1 < min(r0 + run_rows, lx):
                    lo, hi = hi, X[i + 2][cols]
    return out[:, :ly].to(Cp.dtype)


# Cores: ragged rows (53, 45 fit no lane width; 300 fits f32's and f64's
# but not bf16's), whole ones (40, 128), and rows the strips end at (256:
# two strips in f32, four in f64, one in bf16), where qy's last cell is the
# extra load of the row's last strip. Both tiled layouts the kernel builds.
RES_CASES = [(core, dtype, vec) for core in [(37, 53), (9, 300), (11, 256), (7, 45),
                                             (6, 40), (4, 128)]
             for dtype in DTYPES for vec in (False, True)
             if not vec or (dtype != "f64" and core[1] % K.LANE_CELLS[DTYPES[dtype]] == 0)]


def _residual_input(core, tdt, seed):
    lx, ly = core
    rng = np.random.default_rng(seed)
    qx = torch.from_numpy(rng.random((lx + 1, ly)) - 0.5).to(tdt)
    qy = torch.from_numpy(rng.random((lx, ly + 1)) - 0.5).to(tdt)
    Cp = torch.from_numpy(1.0 + rng.random(core)).to(tdt)
    return qx, qy, Cp


@pytest.mark.parametrize("run_rows", [None, 4])
@pytest.mark.parametrize("core,dtype,vec", RES_CASES)
def test_residual_lane_tiling_equals_the_plain_residual_bitwise(core, dtype, vec, run_rows):
    qx, qy, Cp = _residual_input(core, DTYPES[dtype], 13)
    inv_d = kp.inv_d_of(SPACING[2])
    got = _lane_tiled_residual(qx, qy, Cp, inv_d, vec, run_rows)
    assert torch.equal(got, kp.kp_residual_plain(qx, qy, Cp, inv_d))


@pytest.mark.parametrize("core", [(5, 300), (5, 256)])
@pytest.mark.parametrize("vec", [False, True])
def test_the_residual_lane_tiling_needs_the_extra_load(core, vec):
    # Without lane 31's load of qy's cell past each strip the strips' last
    # columns are not the residual: the test above can fail.
    qx, qy, Cp = _residual_input(core, torch.float32, 14)
    inv_d = kp.inv_d_of(SPACING[2])
    got = _lane_tiled_residual(qx, qy, Cp, inv_d, vec, extra=False)
    want = kp.kp_residual_plain(qx, qy, Cp, inv_d)
    assert not torch.equal(got, want)
    strip = 32 * K.LANE_CELLS[torch.float32]
    ends = torch.zeros(core[1], dtype=torch.bool)
    ends[strip - 1::strip] = True
    ends[-1] = True
    assert torch.equal(got[:, ~ends], want[:, ~ends])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kp_residual_wrapper_passes_its_verdict_to_the_kernel(dtype, monkeypatch):
    # With the dispatch forced to the kernel path on CPU tensors, the
    # launch receives masked_layout's verdict over qx, Cp and out as its
    # last argument (qy, read cell by cell, plays no part), and
    # residual_layout asks the launcher's query with the same verdict.
    tdt = DTYPES[dtype]
    w = K.LANE_CELLS[tdt]
    calls, asked = [], []
    monkeypatch.setattr(kp, "use_kernel", lambda *t: True)
    monkeypatch.setattr(kp, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(kp, "launch_layout", lambda *args: asked.append(args))
    sp = SPACING[2]

    def shifted(shape):  # a view one element past an allocation's start
        n = shape[0] * shape[1]
        return torch.zeros(n + 1, dtype=tdt)[1:].view(shape)

    def run(lx, ly, qx=None, qy=None, Cp=None, out=None):
        qx = torch.zeros(lx + 1, ly, dtype=tdt) if qx is None else qx
        qy = torch.zeros(lx, ly + 1, dtype=tdt) if qy is None else qy
        Cp = torch.ones(lx, ly, dtype=tdt) if Cp is None else Cp
        out = torch.empty(lx, ly, dtype=tdt) if out is None else out
        kp.kp_residual(qx, qy, Cp, sp, out=out)
        kp.residual_layout(qx, Cp, out)
        assert asked[-1][3:] == (K._DTYPE_CODE[tdt], lx, ly, calls[-1][-1])
        return calls[-1][-1]

    lx, ly = 12, 4 * w
    vec = dtype != "f64"
    assert run(lx, ly) == vec
    assert run(lx, ly + 1) is False  # ragged
    assert run(lx, ly, qx=shifted((lx + 1, ly))) is False
    assert run(lx, ly, Cp=shifted((lx, ly))) is False
    assert run(lx, ly, out=shifted((lx, ly))) is False
    assert run(lx, ly, qy=shifted((lx, ly + 1))) == vec
