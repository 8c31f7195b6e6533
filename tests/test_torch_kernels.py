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
