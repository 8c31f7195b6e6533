"""The perf path's stencil kernels — counterpart of the Cm-contract kernels
of rocm_mpi_tpu/ops/pallas_kernels.py (`masked_step`, `fused_step_cm`,
`edge_mask`, `edge_masked_cm`).

Each kernel is CUDA C++ for Hopper (csrc/stencil.cu, built by _build.py)
behind a wrapper that:

* takes its plain PyTorch version — same arithmetic, same order — for CPU
  tensors, launches the kernel for CUDA tensors, and raises for anything
  else (utils/backend.use_kernel; there is no fallback);
* checks device, dtype, shape and contiguity, and refuses an `out=` that
  overlaps an input (the advance loop reuses two buffers);
* counts its launches in LAUNCHES, so a run can show that it went
  through the kernel.

Numerics shared by both kernels: `inv_d2[ax] = 1/(h·h)` is a Python double
applied in the compute dtype (f32 for f32 and bf16, as JAX applies a
weak-typed scalar); bf16 is storage-only — operands are widened to f32 and
the result rounded once per launch (pallas_kernels._upcast_for_compute).
"""

from __future__ import annotations

import ctypes

import torch

from rocm_mpi_tpu_torch.ops import _build
from rocm_mpi_tpu_torch.utils.backend import use_kernel

# Launches of each hand kernel since the last reset_launches(). Only a
# kernel launch counts; the plain versions never do. The multi-step
# kernels' wrappers (ops/multistep.py) count here too.
LAUNCHES = {"masked_step": 0, "fused_step_cm": 0, "multi_step_cm": 0, "tb_sweep": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_C_ARGS = [
    ctypes.c_int, ctypes.c_int,                       # dtype code, ndim
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in, Cm, out
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,   # core extents
    ctypes.c_double, ctypes.c_double, ctypes.c_double,  # inv_d2
    ctypes.c_void_p,                                  # cudaStream_t
]
_SIGNATURES = {
    "rmt_masked_step": (ctypes.c_int, _C_ARGS),
    "rmt_fused_step_cm": (ctypes.c_int, _C_ARGS),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def inv_d2_of(spacing) -> tuple[float, ...]:
    """Per-axis 1/h², computed in Python doubles as the JAX kernels do."""
    return tuple(1.0 / (float(d) * float(d)) for d in spacing)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _store(result: torch.Tensor, dtype: torch.dtype, out):
    """Round once to the storage dtype, into `out` when given."""
    if out is None:
        return result.to(dtype)
    return out.copy_(result)


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        return False
    a0, a1 = _span(a)
    b0, b1 = _span(b)
    return a0 < b1 and b0 < a1


def _check(name: str, field: torch.Tensor, Cm: torch.Tensor, core_shape,
           spacing, out) -> None:
    if field.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {field.dtype} not supported "
                        "(float32, float64, bfloat16)")
    if Cm.dtype != field.dtype:
        raise TypeError(f"{name}: Cm dtype {Cm.dtype} != field dtype {field.dtype}")
    if field.ndim not in (2, 3):
        raise ValueError(f"{name}: only 2D and 3D fields, got {field.ndim}D")
    if tuple(Cm.shape) != tuple(core_shape):
        raise ValueError(f"{name}: Cm shape {tuple(Cm.shape)} != {tuple(core_shape)}")
    if len(spacing) != field.ndim:
        raise ValueError(f"{name}: {len(spacing)} spacings for a {field.ndim}D field")
    for label, t in (("field", field), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if out is not None:
        if tuple(out.shape) != tuple(core_shape) or out.dtype != field.dtype:
            raise ValueError(
                f"{name}: out must be {tuple(core_shape)} {field.dtype}, got "
                f"{tuple(out.shape)} {out.dtype}"
            )
        if not out.is_contiguous():
            raise ValueError(f"{name}: out must be contiguous")
        if _overlaps(out, field) or _overlaps(out, Cm):
            raise ValueError(f"{name}: out must not alias an input")


def _launch(symbol: str, field, Cm, out, core_shape, inv_d2) -> None:
    lib = _build.load("stencil", _SIGNATURES)
    ndim = len(core_shape)
    n = tuple(int(s) for s in core_shape) + (1,) * (3 - ndim)
    inv = tuple(inv_d2) + (0.0,) * (3 - ndim)
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream(field.device).cuda_stream
        rc = getattr(lib, symbol)(
            _DTYPE_CODE[field.dtype], ndim, field.data_ptr(), Cm.data_ptr(),
            out.data_ptr(), *n, *inv, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{symbol} launch failed with code {rc} "
            "(-1: bad dtype/rank, -2: grid overflow, >0: CUDA error)"
        )


# ---------------------------------------------------------------------------
# masked_step — one step on an unpadded field, zero ghosts at the edge.
# ---------------------------------------------------------------------------


def masked_step_plain(T, Cm, inv_d2, out=None):
    """Plain version of the masked_step kernel:
    out = T + Cm · Σ_ax ((T[i+1] + T[i-1]) - 2·T) · inv_d2[ax], with
    neighbours outside the field read as 0 — the operation order of
    pallas_kernels._per_step_kernel."""
    cdt = _compute_dtype(T.dtype)
    Tc, Cmc = T.to(cdt), Cm.to(cdt)
    ndim = T.ndim
    core = tuple(slice(1, -1) for _ in range(ndim))
    Tp = torch.zeros(tuple(n + 2 for n in T.shape), dtype=cdt, device=T.device)
    Tp[core] = Tc
    lap = None
    for ax in range(ndim):
        hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
        lo = tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
        term = ((Tp[hi] + Tp[lo]) - 2.0 * Tc) * inv_d2[ax]
        lap = term if lap is None else lap + term
    return _store(Tc + Cmc * lap, T.dtype, out)


def masked_step(T, Cm, spacing, out=None):
    """One explicit step with the Dirichlet mask folded into `Cm`.

    Replaces pallas_kernels.masked_step (file:1191: its ghost-block striped
    `_per_step_kernel`, and at small sizes the one-step
    `_multi_step_kernel`, the same function). `T` and `Cm` share the
    unpadded shape; `Cm` is (dt·λ)/Cp where cells update and 0.0 where
    they are held, so held cells come back bit-unchanged.

    Bound on the H100: memory — 3 passes of the field per step (read T and
    Cm, write out) at ~11 flops per cell. Design: one thread per cell, 32x8
    blocks coalesced along the last axis; the 2·ndim neighbour reads are
    served from L1/L2 lines the block already loads, so device memory sees
    about one pass per operand. At 252² the step is launch-bound instead
    (762 KB in f32).
    """
    _check("masked_step", T, Cm, T.shape, spacing, out)
    inv_d2 = inv_d2_of(spacing)
    operands = (T, Cm) if out is None else (T, Cm, out)
    if not use_kernel(*operands):
        return masked_step_plain(T, Cm, inv_d2, out=out)
    if out is None:
        out = torch.empty_like(T)
    _launch("rmt_masked_step", T, Cm, out, T.shape, inv_d2)
    LAUNCHES["masked_step"] += 1
    return out


# ---------------------------------------------------------------------------
# fused_step_cm — one step of every core cell from a width-1-padded block.
# ---------------------------------------------------------------------------


def fused_step_cm_plain(Tp, Cm, inv_d2, out=None):
    """Plain version of the fused_step_cm kernel:
    out = c + Cm · Σ_ax ((hi - 2·c) + lo) · inv_d2[ax], c = Tp[core] — the
    operation order of pallas_kernels._lap_from_padded."""
    cdt = _compute_dtype(Tp.dtype)
    Tpc, Cmc = Tp.to(cdt), Cm.to(cdt)
    ndim = Tp.ndim
    core = tuple(slice(1, -1) for _ in range(ndim))
    c = Tpc[core]
    lap = None
    for ax in range(ndim):
        hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
        lo = tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
        term = ((Tpc[hi] - 2.0 * c) + Tpc[lo]) * inv_d2[ax]
        lap = term if lap is None else lap + term
    return _store(c + Cmc * lap, Tp.dtype, out)


def fused_step_cm(Tp, Cm, spacing, out=None):
    """Masked per-step core update from the padded block: new =
    Tp[core] + Cm · ∇²(Tp).

    Replaces pallas_kernels.fused_step_cm (file:290: whole-block
    `_fused_kernel_whole_cm`, striped `_fused_kernel_striped_cm`). `Tp` is
    the shard grown by one ghost layer per side (halo.exchange_halo);
    `Cm` the core-shaped masked coefficient.

    Bound on the H100: memory — (n+2)^d reads of Tp, n^d of Cm, n^d writes
    per step. Design: as masked_step, one thread per core cell in 32x8
    blocks along the last axis; neighbour reads come from cached lines.
    """
    if Tp.ndim != Cm.ndim:
        raise ValueError(f"fused_step_cm: Tp is {Tp.ndim}D, Cm {Cm.ndim}D")
    core_shape = tuple(n - 2 for n in Tp.shape)
    _check("fused_step_cm", Tp, Cm, core_shape, spacing, out)
    inv_d2 = inv_d2_of(spacing)
    operands = (Tp, Cm) if out is None else (Tp, Cm, out)
    if not use_kernel(*operands):
        return fused_step_cm_plain(Tp, Cm, inv_d2, out=out)
    if out is None:
        out = torch.empty(core_shape, dtype=Tp.dtype, device=Tp.device)
    _launch("rmt_fused_step_cm", Tp, Cm, out, core_shape, inv_d2)
    LAUNCHES["fused_step_cm"] += 1
    return out


# ---------------------------------------------------------------------------
# The unsharded masked coefficient.
# ---------------------------------------------------------------------------


def edge_mask(shape, device=None) -> torch.Tensor:
    """True on the edge of an unsharded block (every axis's first/last
    cell) — the global Dirichlet boundary when the block is the domain."""
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        m = (idx == 0) | (idx == n - 1)
        view = [1] * len(shape)
        view[ax] = n
        mask = mask | m.reshape(view)
    return mask


def edge_masked_cm(T, Cp, lam, dt):
    """(dt·λ)/Cp on the interior, exactly 0.0 on the edge of `T`."""
    return torch.where(
        edge_mask(T.shape, device=T.device), torch.zeros_like(Cp), (dt * lam) / Cp
    )
