"""The kp rung's kernels — counterpart of the kp section of
rocm_mpi_tpu/ops/pallas_kernels.py (`kp_step_padded`, file:365, over
`_flux_kernel` :339, `_residual_kernel` :350 and `_update_kernel` :359).

The reference's kernel-programming ladder (Flux!, Residual!, Update!) on
the staggered grid, against a width-1-padded 2D block Tp of shape
(lx + 2, ly + 2):

  flux      qx = ((-λ)·(Tp[1:, 1:-1] - Tp[:-1, 1:-1]))·inv_d[0]   (lx + 1, ly)
            qy = ((-λ)·(Tp[1:-1, 1:] - Tp[1:-1, :-1]))·inv_d[1]   (lx, ly + 1)
  residual  dTdt = (-((qx[1:] - qx[:-1])·inv_d[0]
                      + (qy[:, 1:] - qy[:, :-1])·inv_d[1])) / Cp   (lx, ly)
  update    Tp[1:-1, 1:-1] + dt·dTdt                               (lx, ly)

with inv_d = 1/h (not 1/h²) and λ, dt Python doubles applied in the
compute dtype. Three CUDA kernels (csrc/kp.cu, built by _build.py) sit
behind the wrappers, with the dispatch rule of ops/kernels.py: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
kernel, anything else raises. Launches count in kernels.LAUNCHES under
"kp_flux", "kp_residual" and "kp_update".

A step stays three launches with qx, qy and dTdt in device memory between
them: that cost is what the rung exists to show beside the fused `perf`
step. The intermediates are stored in the field dtype, as the TPU kernels'
outputs are, so bf16 rounds three times a step. The TPU kernels are
whole-array VMEM programs (and Mosaic has no f64); on CUDA they launch at
every size and in f32, f64 and bf16.
"""

from __future__ import annotations

import torch

from rocm_mpi_tpu_torch.ops.kernels import (
    _DTYPE_CODE,
    C_DBL,
    C_I64,
    C_INT,
    C_PTR,
    LAUNCHES,
    _check_dtypes,
    _check_out,
    _compute_dtype,
    _overlaps,
    _store,
    check_operands,
    launch,
    launch_layout,
    masked_layout,
)
from rocm_mpi_tpu_torch.utils.backend import use_kernel

_SIGNATURES = {
    "rmt_kp_flux": (C_INT, [C_INT, C_PTR, C_PTR, C_PTR, C_I64, C_I64, C_DBL, C_DBL, C_DBL,
                            C_INT, C_PTR]),  # vectors, stream
    "rmt_kp_flux_layout": (C_INT, [C_INT, C_I64, C_I64, C_INT]),
    "rmt_kp_residual": (C_INT, [C_INT, C_PTR, C_PTR, C_PTR, C_PTR, C_I64, C_I64, C_DBL,
                                C_DBL, C_INT, C_PTR]),  # vectors, stream
    "rmt_kp_residual_layout": (C_INT, [C_INT, C_I64, C_I64, C_INT]),
    "rmt_kp_update": (C_INT, [C_INT, C_PTR, C_PTR, C_PTR, C_I64, C_I64, C_DBL, C_PTR]),
}


def inv_d_of(spacing) -> tuple[float, ...]:
    """Per-axis 1/h, computed in Python doubles as the JAX kernels do."""
    return tuple(1.0 / float(d) for d in spacing)


def _core_shape(Tp) -> tuple[int, int]:
    lx, ly = (int(n) - 2 for n in Tp.shape)
    return lx, ly


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.ndim != 2:
        raise ValueError(
            f"{name}: the kp ladder rung is 2D-only (as is the reference's kp app); "
            "use variants 'perf'/'hide' for 3D grids"
        )


# ---------------------------------------------------------------------------
# Plain versions (what a CPU tensor runs; the card's kernels are held
# bitwise against them)
# ---------------------------------------------------------------------------


def kp_flux_plain(Tp, lam, inv_d, out=None):
    """Plain version of the kp_flux kernel: (qx, qy) on the staggered
    faces, into the pair `out` when given."""
    T = Tp.to(_compute_dtype(Tp.dtype))
    qx = ((-lam) * (T[1:, 1:-1] - T[:-1, 1:-1])) * inv_d[0]
    qy = ((-lam) * (T[1:-1, 1:] - T[1:-1, :-1])) * inv_d[1]
    outs = (None, None) if out is None else out
    return _store(qx, Tp.dtype, outs[0]), _store(qy, Tp.dtype, outs[1])


def kp_residual_plain(qx, qy, Cp, inv_d, out=None):
    """Plain version of the kp_residual kernel: dTdt = (-div)/Cp."""
    cdt = _compute_dtype(Cp.dtype)
    qxc, qyc, Cpc = qx.to(cdt), qy.to(cdt), Cp.to(cdt)
    div = (qxc[1:, :] - qxc[:-1, :]) * inv_d[0] + (qyc[:, 1:] - qyc[:, :-1]) * inv_d[1]
    return _store((-div) / Cpc, Cp.dtype, out)


def kp_update_plain(Tp, dTdt, dt, out=None):
    """Plain version of the kp_update kernel: Tp[core] + dt·dTdt."""
    cdt = _compute_dtype(Tp.dtype)
    return _store(Tp.to(cdt)[1:-1, 1:-1] + float(dt) * dTdt.to(cdt), Tp.dtype, out)


# ---------------------------------------------------------------------------
# The three wrappers: one launch each on CUDA tensors
# ---------------------------------------------------------------------------


def flux_layout(Tp, qx) -> str:
    """The layout (kernels.LAYOUT_NAMES) of kp_flux's launch on these CUDA
    operands, asked of the built kernel (csrc/kp.cu flux_layout): one cell
    a thread for a field too small to fill the card with 16-byte lanes (the
    kp app's 128²), else the vectors where masked_layout allows them over
    qx (never in f64), else scalar cells. Tp and qy are read and written
    cell by cell in every layout."""
    lx, ly = _core_shape(Tp)
    return launch_layout("kp", _SIGNATURES, "rmt_kp_flux_layout", _DTYPE_CODE[Tp.dtype], lx, ly,
                         masked_layout(ly, Tp.dtype, qx.data_ptr()))


def kp_flux(Tp, lam, spacing, out=None):
    """Fourier's law on the staggered faces of a padded 2D block: returns
    (qx (lx+1, ly), qy (lx, ly+1)), into the pair `out` when given.

    Replaces pallas_kernels._flux_kernel (file:339; its pallas_call :387).
    Bound on the H100: memory — read Tp, write qx and qy (three passes).
    Design: a lane moves 16 bytes of a row and walks a run of rows, each
    Tp row read once, or, for a field too small to fill the card that way,
    one cell a thread (csrc/kp.cu, flux_layout). One launch
    writes both outputs, qx's extra row and qy's extra column included.
    """
    _check_2d("kp_flux", Tp)
    lx, ly = _core_shape(Tp)
    check_operands("kp_flux", Tp, {}, (lx, ly), spacing, None)
    shapes = ((lx + 1, ly), (lx, ly + 1))
    if out is not None:
        for o, shape in zip(out, shapes):
            _check_out("kp_flux", o, shape, Tp.dtype, (Tp,))
        if _overlaps(out[0], out[1]):
            raise ValueError("kp_flux: the two outputs must not alias")
    inv_d = inv_d_of(spacing)
    if not use_kernel(Tp, *(out or ())):
        return kp_flux_plain(Tp, float(lam), inv_d, out=out)
    if out is None:
        out = tuple(torch.empty(shape, dtype=Tp.dtype, device=Tp.device) for shape in shapes)
    x = out[0].data_ptr()
    launch("kp", _SIGNATURES, "rmt_kp_flux", Tp.device, _DTYPE_CODE[Tp.dtype], Tp.data_ptr(),
           x, out[1].data_ptr(), lx, ly, float(lam), *inv_d, masked_layout(ly, Tp.dtype, x))
    LAUNCHES["kp_flux"] += 1
    return tuple(out)


def residual_layout(qx, Cp, out) -> str:
    """The layout (kernels.LAYOUT_NAMES) of kp_residual's launch on these
    CUDA operands, asked of the built kernel (csrc/kp.cu residual_layout):
    one cell a thread for a field too small to fill the card with 16-byte
    lanes (the kp app's 128²), else the vectors where masked_layout allows
    them over qx, Cp and out (never in f64), else scalar cells. qy is read
    cell by cell in every layout."""
    lx, ly = (int(n) for n in Cp.shape)
    return launch_layout("kp", _SIGNATURES, "rmt_kp_residual_layout", _DTYPE_CODE[Cp.dtype],
                         lx, ly, _residual_vectors(qx, Cp, out))


def _residual_vectors(qx, Cp, out) -> bool:
    return masked_layout(int(Cp.shape[-1]), Cp.dtype, qx.data_ptr(), Cp.data_ptr(),
                         out.data_ptr())


def kp_residual(qx, qy, Cp, spacing, out=None):
    """Conservation of energy: dTdt = -∇·q / Cp on the core (lx, ly).

    Replaces pallas_kernels._residual_kernel (file:350; its pallas_call
    :397). Bound on the H100: memory — read qx, qy and Cp, write dTdt
    (four passes). Design: the flux's walk — a lane moves 16 bytes of a
    row down a run of rows, each qx row read once, or, for a field too
    small to fill the card that way, one cell a thread (csrc/kp.cu,
    residual_layout).
    """
    _check_2d("kp_residual", Cp)
    lx, ly = (int(n) for n in Cp.shape)
    _check_dtypes("kp_residual", {"Cp": Cp, "qx": qx, "qy": qy})
    for label, t, shape in (("qx", qx, (lx + 1, ly)), ("qy", qy, (lx, ly + 1))):
        if tuple(t.shape) != shape:
            raise ValueError(f"kp_residual: {label} shape {tuple(t.shape)} != {shape}")
    if len(spacing) != 2:
        raise ValueError(f"kp_residual: {len(spacing)} spacings for a 2D field")
    if out is not None:
        _check_out("kp_residual", out, (lx, ly), Cp.dtype, (qx, qy, Cp))
    inv_d = inv_d_of(spacing)
    operands = (qx, qy, Cp) if out is None else (qx, qy, Cp, out)
    if not use_kernel(*operands):
        return kp_residual_plain(qx, qy, Cp, inv_d, out=out)
    if out is None:
        out = torch.empty((lx, ly), dtype=Cp.dtype, device=Cp.device)
    launch("kp", _SIGNATURES, "rmt_kp_residual", Cp.device, _DTYPE_CODE[Cp.dtype],
           qx.data_ptr(), qy.data_ptr(), Cp.data_ptr(), out.data_ptr(), lx, ly, *inv_d,
           _residual_vectors(qx, Cp, out))
    LAUNCHES["kp_residual"] += 1
    return out


def kp_update(Tp, dTdt, dt, out=None):
    """Temperature update: Tp[core] + dt·dTdt, with `dt` a float or the
    field-dtype time step, taken as a double.

    Replaces pallas_kernels._update_kernel (file:359; its pallas_call
    :404). Bound on the H100: memory — read Tp and dTdt, write out (three
    passes).
    """
    _check_2d("kp_update", Tp)
    lx, ly = _core_shape(Tp)
    check_operands("kp_update", Tp, {"dTdt": dTdt}, (lx, ly), None, out)
    operands = (Tp, dTdt) if out is None else (Tp, dTdt, out)
    if not use_kernel(*operands):
        return kp_update_plain(Tp, dTdt, dt, out=out)
    if out is None:
        out = torch.empty((lx, ly), dtype=Tp.dtype, device=Tp.device)
    launch("kp", _SIGNATURES, "rmt_kp_update", Tp.device, _DTYPE_CODE[Tp.dtype], Tp.data_ptr(),
           dTdt.data_ptr(), out.data_ptr(), lx, ly, float(dt))
    LAUNCHES["kp_update"] += 1
    return out


def kp_step_padded(Tp, Cp, lam, dt, spacing, out=None):
    """Candidate core update of the padded 2D block `Tp` through the
    three-kernel ladder (the `kp` variant's step): kp_flux, kp_residual and
    kp_update launched in a row on the current stream, nothing
    synchronised between them. Same contract as fused_step_padded: the
    caller supplies ghosts and masks the global boundary.

    Replaces pallas_kernels.kp_step_padded (file:365). `dt` is a float or
    the field-dtype time step (then a device tensor is read once per call;
    the model passes the float).
    """
    _check_2d("kp_step_padded", Cp)
    _check_2d("kp_step_padded", Tp)
    check_operands("kp_step_padded", Tp, {"Cp": Cp}, _core_shape(Tp), spacing, out)
    qx, qy = kp_flux(Tp, lam, spacing)
    dTdt = kp_residual(qx, qy, Cp, spacing)
    return kp_update(Tp, dTdt, dt, out=out)
