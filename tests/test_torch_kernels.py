"""The kernels' plain versions (rocm_mpi_tpu_torch/ops/kernels.py — what a
CPU tensor runs) against the Pallas kernels they port, run as the JAX
package's own tests run them on the CPU (interpret mode), plus the
wrappers' contracts. The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_mpi_tpu.ops.pallas_kernels as pk
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import kp
from rocm_mpi_tpu_torch.state import tensor_from_numpy

TOL = {
    "f64": dict(rtol=1e-12, atol=0.0),
    # The dryrun's f32 tolerance (__graft_entry__.py); the two runtimes
    # may round one multiply-add differently.
    "f32": dict(rtol=2e-5, atol=2e-6),
}
NP = {"f64": np.float64, "f32": np.float32}
SPACING = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}


def _masked_inputs(shape, dtype, seed=0):
    """T and the edge-masked coefficient (dt·λ)/Cp, 0.0 on the edge."""
    rng = np.random.default_rng(seed)
    T = rng.random(shape).astype(dtype)
    Cp = (1.0 + rng.random(shape)).astype(dtype)
    Cm = (dtype(2e-4) * dtype(1.1)) / Cp
    Cm[~np.pad(np.ones(tuple(n - 2 for n in shape), bool), 1)] = 0
    return T, Cm.astype(dtype)


def _padded_inputs(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    Tp = rng.random(tuple(n + 2 for n in shape)).astype(dtype)
    Cm = (rng.random(shape) * 1e-3).astype(dtype)
    return Tp, Cm


def _masked_jax(T, Cm, spacing):
    return np.asarray(pk.masked_step(jnp.asarray(T), jnp.asarray(Cm), spacing))


def _masked_torch(T, Cm, spacing):
    return K.masked_step(torch.from_numpy(T), torch.from_numpy(Cm), spacing).numpy()


# Both masked_step routes of the JAX package: the VMEM-resident one-step
# kernel (whole field) and the ghost-block striped kernel (budget shrunk
# so a small field takes it, as tests/test_pallas_kernels.py does).
ROUTES = {"vmem": None, "striped": 1024}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", [(64, 48), (32, 40), (16, 10, 8)])
def test_masked_step_plain_matches_pallas(shape, route, dtype, monkeypatch):
    if ROUTES[route] is not None:
        monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", ROUTES[route])
    T, Cm = _masked_inputs(shape, NP[dtype])
    sp = SPACING[len(shape)]
    got, ref = _masked_torch(T, Cm, sp), _masked_jax(T, Cm, sp)
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    edge = Cm == 0
    np.testing.assert_array_equal(got[edge], T[edge])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", [(63, 50), (24, 16), (12, 10, 8)])
def test_fused_step_cm_plain_matches_pallas(shape, route, dtype, monkeypatch):
    if ROUTES[route] is not None:
        monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", ROUTES[route])
    Tp, Cm = _padded_inputs(shape, NP[dtype])
    sp = SPACING[len(shape)]
    ref = np.asarray(pk.fused_step_cm(jnp.asarray(Tp), jnp.asarray(Cm), sp))
    got = K.fused_step_cm(torch.from_numpy(Tp), torch.from_numpy(Cm), sp).numpy()
    np.testing.assert_allclose(got, ref, **TOL[dtype])


def test_masked_step_252_matches_pallas():
    # The flagship geometry's own route and constants: 252², f32,
    # h = 10/252, Cm from the config's dt.
    from rocm_mpi_tpu_torch.config import DiffusionConfig

    cfg = DiffusionConfig(global_shape=(252, 252), dtype="f32")
    rng = np.random.default_rng(7)
    T = rng.random((252, 252)).astype(np.float32)
    Cm = np.full_like(T, np.float32(cfg.dt))
    Cm[[0, -1], :] = 0
    Cm[:, [0, -1]] = 0
    np.testing.assert_allclose(_masked_torch(T, Cm, cfg.spacing),
                               _masked_jax(T, Cm, cfg.spacing), **TOL["f32"])


def _bf16(a):
    return jnp.asarray(a, dtype=jnp.bfloat16)


@pytest.mark.parametrize("kernel", ["masked_step", "fused_step_cm"])
def test_bf16_is_storage_only_rounded_once(kernel):
    # bf16 in, bf16 out, f32 arithmetic in between: the result equals the
    # f32 step on the widened inputs, rounded to bf16 once — and the JAX
    # kernel's, which follows the same contract.
    if kernel == "masked_step":
        A, Cm = _masked_inputs((40, 24), np.float32)
    else:
        A, Cm = _padded_inputs((40, 24), np.float32)
    A_j, Cm_j = _bf16(A), _bf16(Cm)
    A_t = tensor_from_numpy(np.asarray(A_j))
    Cm_t = tensor_from_numpy(np.asarray(Cm_j))
    fn = getattr(K, kernel)
    got = fn(A_t, Cm_t, SPACING[2])
    assert got.dtype == torch.bfloat16
    once = fn(A_t.float(), Cm_t.float(), SPACING[2]).to(torch.bfloat16)
    assert torch.equal(got, once)
    ref = np.asarray(getattr(pk, kernel)(A_j, Cm_j, SPACING[2])).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_cpu_calls_do_not_count_launches():
    K.reset_launches()
    T, Cm = _masked_inputs((16, 16), np.float64)
    K.masked_step(torch.from_numpy(T), torch.from_numpy(Cm), SPACING[2])
    Tp, Cm2 = _padded_inputs((16, 16), np.float64)
    K.fused_step_cm(torch.from_numpy(Tp), torch.from_numpy(Cm2), SPACING[2])
    Cp = torch.from_numpy(1.0 + Cm2)
    K.fused_step_padded(torch.from_numpy(Tp), Cp, 1.0, 1e-4, SPACING[2])
    kp.kp_step_padded(torch.from_numpy(Tp), Cp, 1.0, 1e-4, SPACING[2])
    assert K.LAUNCHES == {"masked_step": 0, "fused_step_cm": 0, "multi_step_cm": 0,
                          "tb_sweep": 0, "wave_step": 0, "wave_step_masked": 0,
                          "wave_multi_step": 0, "swe_step": 0, "swe_multi_step": 0,
                          "fused_step_padded": 0, "kp_flux": 0, "kp_residual": 0,
                          "kp_update": 0}


@pytest.mark.parametrize("kernel", ["masked_step", "fused_step_cm"])
def test_out_buffer_is_written_and_returned(kernel):
    if kernel == "masked_step":
        A, Cm = (torch.from_numpy(a) for a in _masked_inputs((20, 12), np.float64))
    else:
        A, Cm = (torch.from_numpy(a) for a in _padded_inputs((20, 12), np.float64))
    fn = getattr(K, kernel)
    out = torch.empty_like(Cm)
    assert fn(A, Cm, SPACING[2], out=out) is out
    assert torch.equal(out, fn(A, Cm, SPACING[2]))


def test_wrapper_rejects_bad_operands():
    T = torch.rand(16, 12, dtype=torch.float64)
    Cm = torch.rand(16, 12, dtype=torch.float64)
    sp = SPACING[2]
    with pytest.raises(ValueError, match="alias"):
        K.masked_step(T, Cm, sp, out=T)
    with pytest.raises(ValueError, match="alias"):
        K.masked_step(T, Cm, sp, out=Cm)
    Tp = torch.rand(18, 14, dtype=torch.float64)
    with pytest.raises(ValueError, match="alias"):
        K.fused_step_cm(Tp, Cm, sp, out=Tp.view(-1)[: 16 * 12].view(16, 12))
    with pytest.raises(TypeError):
        K.masked_step(T, Cm.float(), sp)
    with pytest.raises(TypeError):
        K.masked_step(T.half(), Cm.half(), sp)
    with pytest.raises(ValueError, match="contiguous"):
        K.masked_step(T.t(), Cm.t(), sp)
    with pytest.raises(ValueError, match="shape"):
        K.masked_step(T, Cm[:-1], sp)
    with pytest.raises(ValueError, match="shape"):
        K.fused_step_cm(T, Cm, sp)
    with pytest.raises(ValueError, match="2D and 3D"):
        K.masked_step(T[0], Cm[0], sp[:1])
    with pytest.raises(ValueError, match="spacings"):
        K.masked_step(T, Cm, (0.1,))
    with pytest.raises(ValueError, match="out must be"):
        K.masked_step(T, Cm, sp, out=torch.empty(16, 12, dtype=torch.float32))


def test_other_devices_raise():
    # Neither CPU (plain version) nor CUDA (kernel): no dispatch exists.
    T = torch.empty(8, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        K.masked_step(T, torch.empty(8, 8, device="meta"), SPACING[2])
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        K.fused_step_cm(torch.empty(10, 10, device="meta"),
                        torch.empty(8, 8, device="meta"), SPACING[2])


@pytest.mark.parametrize("shape", [(9, 13), (6, 5, 4)])
def test_edge_masked_cm_matches_jax(shape):
    rng = np.random.default_rng(2)
    T, Cp = rng.random(shape), 1.0 + rng.random(shape)
    np.testing.assert_array_equal(K.edge_mask(shape).numpy(), np.asarray(pk.edge_mask(shape)))
    got = K.edge_masked_cm(torch.from_numpy(T), torch.from_numpy(Cp), 1.1, 2e-4).numpy()
    ref = np.asarray(pk.edge_masked_cm(jnp.asarray(T), jnp.asarray(Cp), 1.1, 2e-4))
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


def test_launch_binds_once_and_enters_only_another_devices_context(monkeypatch):
    """The shared launch helper: the library is loaded and the symbol bound
    at its first launch only; the device's context is entered only when the
    operands' device is not the current one; a non-zero code raises."""
    entered, calls, loads = [], [], []

    class Context:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    class Lib:
        @staticmethod
        def rmt_fake(*args):
            calls.append(args)
            return args[0]

    def load(name, signatures):
        loads.append(name)
        return Lib

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Context)
    monkeypatch.setattr(K, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(K._build, "load", load)
    monkeypatch.delitem(K._FUNCS, "rmt_fake", raising=False)
    try:
        K.launch("fake", {}, "rmt_fake", torch.device("cuda", 0), 0, 7)
        K.launch("fake", {}, "rmt_fake", torch.device("cuda", 0), 0, 8)
        assert loads == ["fake"] and entered == []
        assert calls == [(0, 7, 1000), (0, 8, 1000)]
        K.launch("fake", {}, "rmt_fake", torch.device("cuda", 1), 0, 9)
        assert entered == [1] and calls[-1] == (0, 9, 1001)
        with pytest.raises(RuntimeError, match="rmt_fake launch failed with code 5"):
            K.launch("fake", {}, "rmt_fake", torch.device("cuda", 0), 5)
    finally:
        K._FUNCS.pop("rmt_fake", None)


def _operand_cases():
    """(label, field, core, spacing, out) operand sets of check_operands:
    good ones in 2D and 3D, the rest each wrong in one way."""
    T2, T3 = torch.rand(6, 5, dtype=torch.float64), torch.rand(4, 3, 5)
    return [
        ("good 2D", T2, {"Cm": torch.rand(6, 5, dtype=torch.float64)}, (0.1, 0.2),
         torch.empty(6, 5, dtype=torch.float64)),
        ("good 3D, no out", T3, {"Cm": torch.rand(4, 3, 5)}, None, None),
        ("good bf16", T2.bfloat16(), {}, (0.1, 0.2), torch.empty(6, 5, dtype=torch.bfloat16)),
        ("int field", T2.int(), {}, None, None),
        ("1D field", torch.rand(7), {}, None, None),
        ("strided field", T2.t(), {}, None, None),
        ("spacing count", T2, {}, (0.1,), None),
        ("core dtype", T2, {"Cm": torch.rand(6, 5)}, None, None),
        ("core shape", T2, {"Cm": torch.rand(5, 5, dtype=torch.float64)}, None, None),
        ("out is the field", T2, {}, None, T2),
        ("out dtype", T2, {}, None, torch.empty(6, 5)),
    ]


@pytest.mark.parametrize("case", _operand_cases(), ids=lambda c: c[0])
def test_check_operands_comparisons_agree_with_full_checks(case, monkeypatch):
    """check_operands passes good operands on plain comparisons alone; the
    comparisons refuse exactly what the full checks (with their messages)
    refuse."""
    label, field, core, spacing, out = case
    shape = tuple(field.shape)
    ok = K._operands_ok(field, core, shape, spacing, out)
    monkeypatch.setattr(K, "_operands_ok", lambda *args: False)  # the full checks alone
    try:
        K.check_operands("case", field, core, shape, spacing, out)
        accepted = True
    except (TypeError, ValueError):
        accepted = False
    assert ok == accepted == label.startswith("good")


# ---------------------------------------------------------------------------
# masked_step's 16-byte lane tiling (csrc/stencil.cu rmt_masked_step_kernel)
# ---------------------------------------------------------------------------

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_lane_moves_16_bytes(dtype):
    tdt = DTYPES[dtype]
    assert K.LANE_CELLS[tdt] * torch.empty((), dtype=tdt).element_size() == 16


def test_f64_always_takes_scalar_cells():
    base = 1 << 20
    assert not K.masked_layout(12288, torch.float64, base, base + 4096, base + 8192)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_layout_takes_vectors_only_on_the_16_byte_grid(dtype):
    tdt = DTYPES[dtype]
    w = K.LANE_CELLS[tdt]
    item = 16 // w
    base = 1 << 20
    assert K.masked_layout(12288, tdt, base, base + 4096, base + 8192)
    assert K.masked_layout(3 * w, tdt, base, base, base)
    for ragged in (12287, w + 1, 1):
        assert not K.masked_layout(ragged, tdt, base, base, base)
    # any one operand off the grid by an element (a view with a storage
    # offset) takes the scalar cells
    for off in range(3):
        ptrs = [base, base + 256, base + 512]
        ptrs[off] += item
        assert not K.masked_layout(12288, tdt, *ptrs)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_masked_step_wrapper_passes_its_layout_to_the_kernel(dtype, monkeypatch):
    # With the dispatch forced to the kernel path on CPU tensors, the
    # launch receives masked_layout's verdict as its last argument.
    tdt = DTYPES[dtype]
    w = K.LANE_CELLS[tdt]
    calls = []
    monkeypatch.setattr(K, "use_kernel", lambda *t: True)
    monkeypatch.setattr(K, "launch", lambda *args: calls.append(args))
    sp = (0.1, 0.1)

    def run(T, Cm, out):
        K.masked_step(T, Cm, sp, out=out)
        return calls[-1][-1]

    shape = (12, 4 * w)
    T, Cm, out = (torch.zeros(shape, dtype=tdt) for _ in range(3))
    assert run(T, Cm, out) == (dtype != "f64")
    ragged = (12, 4 * w + 1)
    assert not run(*(torch.zeros(ragged, dtype=tdt) for _ in range(3)))
    shifted = torch.zeros(12 * 4 * w + 1, dtype=tdt)[1:].view(shape)  # storage offset 1
    assert shifted.is_contiguous() and shifted.storage_offset() == 1
    assert not run(shifted, Cm, out)
    assert not run(T, Cm, torch.zeros(12 * 4 * w + 1, dtype=tdt)[1:].view(shape))
    assert K.LAUNCHES["masked_step"] == 4
    K.reset_launches()


def _stencil_constant(name):
    from rocm_mpi_tpu_torch.ops import resident

    return resident._constant("stencil.cu", name)


def _lane_tiled_step(T, Cm, inv_d2, vec, run_rows=None, outer=True):
    """masked_step's lane tiling in plain PyTorch: a warp's strip of 32·W
    cells of the last axis walked down runs of rows (the launcher's run
    length unless `run_rows`), the rows above and below carried; lane l's
    cells l·W + e (vec) or l + 32·e (scalar cells); each cell's last-axis
    neighbours from the lane's own cells, the lanes beside it (the
    shuffles: a shift across lanes for vec, a rotation for scalar cells)
    or, for the strip's two outer cells, the loads of lanes 0 and 31 (0
    when not `outer`); every cell past the field 0. In the kernel's
    operation order, rounded once."""
    cdt = K._compute_dtype(T.dtype)
    w = K.LANE_CELLS[T.dtype]
    n0, n_last = T.shape[0], T.shape[-1]
    n_mid = int(np.prod(T.shape[1:-1], dtype=np.int64))
    assert not vec or n_last % w == 0
    strips = -(-n_last // (32 * w))
    width = strips * 32 * w
    if run_rows is None:
        run_rows = strips * n_mid * n0 // _stencil_constant("kMsFillWarps")
        run_rows = min(max(run_rows, 1), _stencil_constant("kMsRunRows"))
    Tz = torch.zeros(n0, n_mid, width + 1, dtype=cdt)  # + the cell past the last strip
    Tz[:, :, :n_last] = T.to(cdt).reshape(n0, n_mid, n_last)
    Cz = torch.zeros(n0, n_mid, width, dtype=cdt)
    Cz[:, :, :n_last] = Cm.to(cdt).reshape(n0, n_mid, n_last)
    lane = torch.arange(32)[:, None]
    e = torch.arange(w)[None, :]
    idx = lane * w + e if vec else lane + 32 * e  # the strip's cell of lane l's cell e
    zero = torch.zeros(32, w, dtype=cdt)
    out = torch.zeros(n0, n_mid, width, dtype=cdt)
    for mid in range(n_mid):
        for s in range(strips):
            first = s * 32 * w
            cols = first + idx

            def row(g, m=mid):
                return Tz[g, m][cols] if 0 <= g < n0 and 0 <= m < n_mid else zero

            for r0 in range(0, n0, run_rows):
                up, cen, dn = row(r0 - 1), row(r0), row(r0 + 1)
                for g in range(r0, min(r0 + run_rows, n0)):
                    c = cen
                    outer_lo = Tz[g, mid, first - 1] if first > 0 else torch.zeros((), dtype=cdt)
                    outer_hi = Tz[g, mid, first + 32 * w]
                    if vec:
                        lo = torch.cat([torch.roll(c[:, -1], 1)[:, None], c[:, :-1]], 1)
                        hi = torch.cat([c[:, 1:], torch.roll(c[:, 0], -1)[:, None]], 1)
                    else:
                        rot_l, rot_r = torch.roll(c, 1, dims=0), torch.roll(c, -1, dims=0)
                        lo, hi = rot_l.clone(), rot_r.clone()
                        lo[0, 1:] = rot_l[0, :-1]
                        hi[31, :-1] = rot_r[31, 1:]
                    lo[0, 0] = outer_lo if outer else 0.0
                    hi[31, w - 1] = outer_hi if outer else 0.0
                    lap = ((dn + up) - 2.0 * c) * inv_d2[0]
                    if T.ndim == 3:
                        lap = lap + ((row(g, mid + 1) + row(g, mid - 1)) - 2.0 * c) * inv_d2[1]
                        lap = lap + ((hi + lo) - 2.0 * c) * inv_d2[2]
                    else:
                        lap = lap + ((hi + lo) - 2.0 * c) * inv_d2[1]
                    out[g, mid, cols] = c + Cz[g, mid][cols] * lap
                    up, cen, dn = cen, dn, row(g + 2)
    return out[:, :, :n_last].reshape(T.shape).to(T.dtype)


# Ragged and whole last axes: 53 and 45 cells fit no lane width, 300 fits
# f32's and f64's but not bf16's, 40 and 256 every one's; 300 and 256
# cells take two strips in f64. Vectors only where the wrapper takes them
# (never in f64).
LANE_CASES = [(shape, dtype, vec) for shape in [(37, 53), (9, 300), (11, 256), (7, 5, 45),
                                                (6, 4, 40)]
              for dtype in DTYPES for vec in (False, True)
              if not vec or (dtype != "f64" and shape[-1] % K.LANE_CELLS[DTYPES[dtype]] == 0)]


@pytest.mark.parametrize("run_rows", [None, 4])
@pytest.mark.parametrize("shape,dtype,vec", LANE_CASES)
def test_lane_tiling_equals_the_plain_step_bitwise(shape, dtype, vec, run_rows):
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    T = torch.from_numpy(rng.random(shape)).to(tdt)
    Cm = torch.from_numpy(rng.random(shape) * 1e-3).to(tdt)  # the edge too: ghosts must be 0
    inv_d2 = K.inv_d2_of(SPACING[len(shape)])
    got = _lane_tiled_step(T, Cm, inv_d2, vec, run_rows)
    assert torch.equal(got, K.masked_step_plain(T, Cm, inv_d2))


@pytest.mark.parametrize("vec", [False, True])
def test_the_lane_tiling_needs_the_outer_loads(vec):
    # Without lanes 0 and 31's loads of the strip's outer neighbours the
    # strips do not give the step: the bitwise test above can fail.
    rng = np.random.default_rng(8)
    T = torch.from_numpy(rng.random((5, 300))).float()
    Cm = torch.from_numpy(rng.random((5, 300)) * 1e-3).float()
    inv_d2 = K.inv_d2_of(SPACING[2])
    got = _lane_tiled_step(T, Cm, inv_d2, vec, outer=False)
    assert not torch.equal(got, K.masked_step_plain(T, Cm, inv_d2))


# ---------------------------------------------------------------------------
# fused_step_padded's lane tiling (csrc/stencil.cu rmt_fused_step_padded_kernel)
# ---------------------------------------------------------------------------


def _lane_tiled_padded_step(Tp, Cp, lam, dt, inv_d2, vec, run_rows=None, outer=True):
    """fused_step_padded's lane tiling in plain PyTorch: masked_step's
    strips of 32·W cells walked down runs of rows (the launcher's run
    length, read from stencil.cu, unless `run_rows`), read from the padded
    block: lane l's cells l·W + e (`vec`, the 16-byte vectors) or l + 32·e
    (scalar cells) of a Tp row up to the ghost column n_last, the rows
    above and below and (3D) at axis-1 indices ± 1 the block's own rows,
    the last-axis neighbours from the lane's cells and the lanes beside
    (shift or rotation), the strip's two outer cells from the padded ring
    by lanes 0 and 31 (0 when not `outer`), cells past the ghost column 0.
    In the kernel's operation order (lap_at's, and the division dt·λ /
    Cp), rounded once."""
    cdt = K._compute_dtype(Tp.dtype)
    w = K.LANE_CELLS[Tp.dtype]
    core = tuple(n - 2 for n in Tp.shape)
    n0, n_last = core[0], core[-1]
    n_mid = core[1] if len(core) == 3 else 1
    assert not vec or n_last % w == 0
    strips = -(-n_last // (32 * w))
    width = strips * 32 * w
    if run_rows is None:
        longest = "kPadRunRowsBf16" if Tp.dtype == torch.bfloat16 else "kPadRunRows"
        run_rows = strips * n_mid * n0 // _stencil_constant("kMsFillWarps")
        run_rows = min(max(run_rows, 1), _stencil_constant(longest))
    # Tz[g + 1, m + 1, j + 1] = Tp's cell j of core row g at axis-1 index m,
    # ghosts included, 0 past the ghost column.
    T3 = Tp.to(cdt) if len(core) == 3 else Tp.to(cdt)[:, None, :].expand(n0 + 2, 3, n_last + 2)
    Tz = torch.zeros(n0 + 2, n_mid + 2, width + 2, dtype=cdt)
    Tz[:, :, :n_last + 2] = T3
    Cz = torch.zeros(n0, n_mid, width, dtype=cdt)
    Cz[:, :, :n_last] = Cp.to(cdt).reshape(n0, n_mid, n_last)
    coef_num = torch.tensor(float(dt) * float(lam), dtype=cdt)
    lane = torch.arange(32)[:, None]
    e = torch.arange(w)[None, :]
    idx = lane * w + e if vec else lane + 32 * e
    out = torch.zeros(n0, n_mid, width, dtype=cdt)
    for mid in range(n_mid):
        for s in range(strips):
            first = s * 32 * w
            cols = first + idx

            def row(g, m=mid):  # past the last ghost row: the load a run never makes
                return Tz[g + 1, m + 1][cols + 1] if g <= n0 else torch.zeros(32, w, dtype=cdt)

            for r0 in range(0, n0, run_rows):
                up, cen, dn = row(r0 - 1), row(r0), row(r0 + 1)
                for g in range(r0, min(r0 + run_rows, n0)):
                    c = cen
                    outer_lo = Tz[g + 1, mid + 1, first]
                    outer_hi = (Tz[g + 1, mid + 1, first + 32 * w + 1]
                                if first + 32 * w <= n_last else torch.zeros((), dtype=cdt))
                    if vec:
                        lo = torch.cat([torch.roll(c[:, -1], 1)[:, None], c[:, :-1]], 1)
                        hi = torch.cat([c[:, 1:], torch.roll(c[:, 0], -1)[:, None]], 1)
                    else:
                        rot_l, rot_r = torch.roll(c, 1, dims=0), torch.roll(c, -1, dims=0)
                        lo, hi = rot_l.clone(), rot_r.clone()
                        lo[0, 1:] = rot_l[0, :-1]
                        hi[31, :-1] = rot_r[31, 1:]
                    lo[0, 0] = outer_lo if outer else 0.0
                    hi[31, w - 1] = outer_hi if outer else 0.0
                    lap = ((dn - 2.0 * c) + up) * inv_d2[0]
                    if len(core) == 3:
                        lap = lap + ((row(g, mid + 1) - 2.0 * c) + row(g, mid - 1)) * inv_d2[1]
                        lap = lap + ((hi - 2.0 * c) + lo) * inv_d2[2]
                    else:
                        lap = lap + ((hi - 2.0 * c) + lo) * inv_d2[1]
                    out[g, mid, cols] = c + (coef_num / Cz[g, mid][cols]) * lap
                    up, cen, dn = cen, dn, row(g + 2)
    return out[:, :, :n_last].reshape(core).to(Tp.dtype)


# As LANE_CASES, plus last axes that the strips end at exactly (256: two
# strips in f32, one in bf16), where lane 31's outer cell is the ghost
# column; both tiled layouts, in the dtypes the kernel builds them for (f32
# and bf16: f64 takes one cell a thread, the per-cell arithmetic of the
# plain version).
PADDED_CASES = [(shape, dtype, vec) for shape in [(37, 53), (9, 300), (11, 256), (7, 5, 45),
                                                  (6, 4, 40), (5, 3, 256)]
                for dtype in ("f32", "bf16") for vec in (False, True)
                if not vec or shape[-1] % K.LANE_CELLS[DTYPES[dtype]] == 0]


def _padded_step_inputs(core, tdt, seed):
    rng = np.random.default_rng(seed)
    Tp = torch.from_numpy(rng.random(tuple(n + 2 for n in core))).to(tdt)
    Cp = torch.from_numpy(1.0 + rng.random(core)).to(tdt)
    return Tp, Cp


@pytest.mark.parametrize("run_rows", [None, 4])
@pytest.mark.parametrize("shape,dtype,vec", PADDED_CASES)
def test_padded_lane_tiling_equals_the_plain_step_bitwise(shape, dtype, vec, run_rows):
    Tp, Cp = _padded_step_inputs(shape, DTYPES[dtype], 9)
    inv_d2 = K.inv_d2_of(SPACING[len(shape)])
    got = _lane_tiled_padded_step(Tp, Cp, 1.3, 1e-4, inv_d2, vec, run_rows)
    assert torch.equal(got, K.fused_step_padded_plain(Tp, Cp, 1.3, 1e-4, inv_d2))


@pytest.mark.parametrize("vec", [False, True])
def test_the_padded_lane_tiling_needs_the_outer_loads(vec):
    # Without lanes 0 and 31's loads of the strip's outer cells from the
    # padded ring the strips do not give the step (the ghosts are not 0).
    Tp, Cp = _padded_step_inputs((5, 256), torch.float32, 10)
    inv_d2 = K.inv_d2_of(SPACING[2])
    got = _lane_tiled_padded_step(Tp, Cp, 1.3, 1e-4, inv_d2, vec, outer=False)
    assert not torch.equal(got, K.fused_step_padded_plain(Tp, Cp, 1.3, 1e-4, inv_d2))


def test_padded_step_vectors_only_on_the_16_byte_grid():
    # The wrapper allows the vectors (masked_layout over Cp and out) for a
    # last axis of whole 16-byte lanes with both on the 16-byte grid, never
    # in f64; Tp plays no part. The launcher takes one cell a thread in f64
    # and below the fill whatever it allows.
    base = 1 << 20
    for dtype, tdt in DTYPES.items():
        w = K.LANE_CELLS[tdt]
        item = 16 // w
        vec = dtype != "f64"
        assert K.masked_layout(12288, tdt, base, base + 4096) == vec
        assert not K.masked_layout(12287, tdt, base, base)
        assert not K.masked_layout(4096 + 1, tdt, base, base)
        assert not K.masked_layout(12288, tdt, base + item, base)
        assert not K.masked_layout(12288, tdt, base, base + item)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_step_padded_wrapper_passes_its_verdict_to_the_kernel(dtype, monkeypatch):
    # With the dispatch forced to the kernel path on CPU tensors, the
    # launch receives masked_layout's verdict over Cp and out as its last
    # argument, and padded_layout asks the launcher's query with the same
    # verdict.
    tdt = DTYPES[dtype]
    w = K.LANE_CELLS[tdt]
    calls, asked = [], []
    monkeypatch.setattr(K, "use_kernel", lambda *t: True)
    monkeypatch.setattr(K, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(K, "launch_layout", lambda *args: asked.append(args))
    K.reset_launches()

    def run(Tp, Cp, out):
        K.fused_step_padded(Tp, Cp, 1.3, 1e-4, SPACING[Tp.ndim], out=out)
        K.padded_layout(Tp, Cp, out)
        assert asked[-1][3:] == (K._DTYPE_CODE[tdt], Tp.ndim, *K.extents(out.shape),
                                 calls[-1][-1])
        return calls[-1][-1]

    core = (12, 4 * w)
    vec = dtype != "f64"
    Tp = torch.zeros(tuple(n + 2 for n in core), dtype=tdt)
    Cp, out = torch.ones(core, dtype=tdt), torch.zeros(core, dtype=tdt)
    assert run(Tp, Cp, out) == vec
    ragged = (12, 4 * w + 1)
    assert run(torch.zeros(14, 4 * w + 3, dtype=tdt), torch.ones(ragged, dtype=tdt),
               torch.zeros(ragged, dtype=tdt)) is False
    shifted = torch.ones(12 * 4 * w + 1, dtype=tdt)[1:].view(core)  # storage offset 1
    assert run(Tp, shifted, out) is False
    assert run(Tp, Cp, torch.zeros(12 * 4 * w + 1, dtype=tdt)[1:].view(core)) is False
    # Tp off the 16-byte grid keeps the vectors: it is read cell by cell
    Tp_shifted = torch.zeros(Tp.numel() + 1, dtype=tdt)[1:].view(Tp.shape)
    assert run(Tp_shifted, Cp, out) == vec
    core3 = (3, 2, 4 * w)  # 3D: the last axis decides
    assert run(torch.zeros(5, 4, 4 * w + 2, dtype=tdt), torch.ones(core3, dtype=tdt),
               torch.zeros(core3, dtype=tdt)) == vec
    assert K.LAUNCHES["fused_step_padded"] == 6
    K.reset_launches()
