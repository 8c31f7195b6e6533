"""The perf path's stencil kernels — counterpart of the Cm-contract kernels
of rocm_mpi_tpu/ops/pallas_kernels.py (`masked_step`, `fused_step_cm`,
`edge_mask`, `edge_masked_cm`) and of its unmasked `fused_step_padded` —
and what every kernel wrapper of the port shares: the launch counts, the
ctypes launch, the operand checks and the region form.

Each kernel is CUDA C++ for Hopper (csrc/stencil.cu, built by _build.py)
behind a wrapper that:

* takes its plain PyTorch version — same arithmetic, same order — for CPU
  tensors, launches the kernel for CUDA tensors, and raises for anything
  else (utils/backend.use_kernel; there is no fallback);
* checks device, dtype, shape and contiguity, and refuses an `out=` that
  overlaps an input (the advance loop reuses two buffers);
* counts its launches in LAUNCHES, so a run can show that it went
  through the kernel.

A region launch (`fused_step_cm_region`, and ops/wave.py's
`wave_step_masked_region`) updates one box of the core, `[lo, hi)` per
axis, reading its stencil from a source grown by `offset` cells per axis
— the padded buffer of the exchange (1) or the raw shard (0, for boxes
whose stencil stays inside it) — and writes that box of `out` in place.
The whole-block call is the box of the whole core with offset 1. This is
the overlap decomposition's splice (parallel/overlap.py) without a copy
per region: operands stay whole and contiguous, the box goes to the
kernel as numbers.

`fused_step_cm` goes one step further, in its face form
(`fused_step_cm_faces`): it reads the core and its 2·ndim ghost faces
where they lie — views into a padded block (`fused_step_cm`,
`fused_step_cm_region`), or the shard and the receive buffers of
halo.exchange_faces (the sharded `perf` and `hide` steps), so those
steps build no padded block.

Numerics shared by the three kernels: `inv_d2[ax] = 1/(h·h)` is a Python double
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
# kernels' wrappers (ops/multistep.py), the wave kernels' (ops/wave.py), the
# shallow-water kernels' (ops/swe.py) and the kp kernels' (ops/kp.py) count
# here too.
LAUNCHES = {"masked_step": 0, "fused_step_cm": 0, "multi_step_cm": 0, "tb_sweep": 0,
            "wave_step": 0, "wave_step_masked": 0, "wave_multi_step": 0,
            "swe_step": 0, "swe_multi_step": 0, "fused_step_padded": 0,
            "kp_flux": 0, "kp_residual": 0, "kp_update": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# ctypes argument lists of the C interfaces (csrc/*.cu).
C_INT, C_I64, C_DBL, C_PTR = ctypes.c_int, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
C_I64P = ctypes.POINTER(ctypes.c_int64)  # a host array of int64 (strides, face pointers)
EXTENTS = [C_I64] * 3                  # core extents (n2 = 1 in 2D)
BOX_CELLS = [C_I64] * 6               # lo0..lo2, e0..e2
BOX = BOX_CELLS + [C_INT]              # and the source offset
INV_D2 = [C_DBL] * 3
_SIGNATURES = {
    "rmt_masked_step": (C_INT, [C_INT, C_INT, C_PTR, C_PTR, C_PTR, *EXTENTS, *INV_D2,
                                C_INT, C_INT, C_PTR]),  # run_cap, vec, stream
    "rmt_fused_step_cm": (C_INT, [C_INT, C_INT, C_PTR, C_I64P, C_I64P, C_I64P, C_PTR, C_PTR,
                                  *EXTENTS, *BOX_CELLS, *INV_D2, C_INT, C_PTR]),
    "rmt_fused_step_padded": (C_INT, [C_INT, C_INT, C_PTR, C_PTR, C_PTR, *EXTENTS, C_DBL,
                                      *INV_D2, C_INT, C_PTR]),  # vectors, stream
    "rmt_fused_step_padded_layout": (C_INT, [C_INT, C_INT, *EXTENTS, C_INT]),
}


# Launches of fused_step_cm that took its f64 route (csrc/stencil.cu
# rmt_fused_step_cm_f64_kernel, which launch_fused_cm picks for every f64
# launch by the storage type alone) since the last reset_launches(): the
# wrapper's own launches, eager or recorded into a CUDA graph while it is
# captured (so a hide run's capture shows five a step), where
# LAUNCHES["fused_step_cm"] counts what runs (models/scan.py sets the
# captures aside and adds each replay's recorded launches).
F64_ROUTE_LAUNCHES = 0


def reset_launches() -> None:
    global F64_ROUTE_LAUNCHES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    F64_ROUTE_LAUNCHES = 0


def inv_d2_of(spacing) -> tuple[float, ...]:
    """Per-axis 1/h², computed in Python doubles as the JAX kernels do."""
    return tuple([1.0 / (float(d) * float(d)) for d in spacing])


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _store(result: torch.Tensor, dtype: torch.dtype, out):
    """Round once to the storage dtype, into `out` when given."""
    if out is None:
        return result.to(dtype)
    return out.copy_(result)


def _span(t: torch.Tensor) -> int:
    """Bytes from a tensor's first element to past its last, strides
    included (a view's nbytes undercounts a strided face)."""
    if t.is_contiguous():
        return t.nbytes
    if t.numel() == 0:
        return 0
    return (sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1) * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + _span(b) and b0 < a0 + _span(a)


def _check_dtypes(name: str, operands: dict) -> None:
    first = None
    for label, t in operands.items():
        if first is None:
            first = t.dtype
            if first not in _DTYPE_CODE:
                raise TypeError(f"{name}: dtype {first} not supported "
                                "(float32, float64, bfloat16)")
        elif t.dtype != first:
            raise TypeError(f"{name}: {label} dtype {t.dtype} != field dtype {first}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _check_out(name: str, out, core_shape, dtype, inputs) -> None:
    if out.shape != tuple(core_shape) or out.dtype != dtype:
        raise ValueError(f"{name}: out must be {tuple(core_shape)} {dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous")
    for t in inputs:
        if _overlaps(out, t):
            raise ValueError(f"{name}: out must not alias an input")


def _operands_ok(field: torch.Tensor, core: dict, core_shape: tuple, spacing, out) -> bool:
    """check_operands' verdict as plain comparisons, with no message: the
    path every launch takes when its operands are good."""
    dtype = field.dtype
    if dtype not in _DTYPE_CODE or field.ndim not in (2, 3) or not field.is_contiguous():
        return False
    if spacing is not None and len(spacing) != field.ndim:
        return False
    for t in core.values():
        if t.dtype != dtype or t.shape != core_shape or not t.is_contiguous():
            return False
    if out is None:
        return True
    if out.dtype != dtype or out.shape != core_shape or not out.is_contiguous():
        return False
    if _overlaps(out, field):
        return False
    for t in core.values():
        if _overlaps(out, t):
            return False
    return True


def check_operands(name: str, field: torch.Tensor, core: dict, core_shape, spacing,
                   out) -> None:
    """Checks of a whole-block launch: `field` (unpadded or padded) and the
    core-shaped operands `core` ({label: tensor}) share a supported dtype
    and are contiguous, `core` has `core_shape`, one spacing per axis
    (unless `spacing` is None), and `out` (if given) is a core-shaped buffer
    aliasing no input. Good operands pass on plain comparisons; the checks
    that name the fault run only when those fail."""
    core_shape = tuple(core_shape)
    if _operands_ok(field, core, core_shape, spacing, out):
        return
    _check_dtypes(name, {"field": field, **core})
    if field.ndim not in (2, 3):
        raise ValueError(f"{name}: only 2D and 3D fields, got {field.ndim}D")
    for label, t in core.items():
        if t.shape != core_shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != {core_shape}")
    if spacing is not None and len(spacing) != field.ndim:
        raise ValueError(f"{name}: {len(spacing)} spacings for a {field.ndim}D field")
    if out is not None:
        _check_out(name, out, core_shape, field.dtype, (field, *core.values()))


def core_box(shape) -> tuple[tuple[int, int], ...]:
    """The box of a whole core: [0, n) on every axis."""
    return tuple((0, int(n)) for n in shape)


def check_region(name: str, src: torch.Tensor, offset: int, core: dict, box, spacing,
                 out: torch.Tensor) -> None:
    """Checks of a region launch: `out` is the whole core buffer the box
    is written into; `src` is the core grown by `offset` (0 or 1) cells per
    axis; the box lies in the core, and with offset 0 its stencil must not
    leave the raw shard."""
    if offset not in (0, 1):
        raise ValueError(f"{name}: source offset must be 0 or 1, got {offset}")
    if out is None:
        raise ValueError(f"{name}: a region launch writes into `out`, which must be given")
    core_shape = tuple(out.shape)
    check_operands(name, src, core, core_shape, spacing, out)
    if tuple(src.shape) != tuple(n + 2 * offset for n in core_shape):
        raise ValueError(f"{name}: source shape {tuple(src.shape)} is not the core "
                         f"{core_shape} grown by {offset} per axis")
    if len(box) != len(core_shape):
        raise ValueError(f"{name}: a {len(box)}-axis box for a {len(core_shape)}D core")
    for (lo, hi), n in zip(box, core_shape):
        if not 0 <= lo < hi <= n:
            raise ValueError(f"{name}: box {tuple(box)} is empty or outside the core "
                             f"{core_shape}")
        if offset == 0 and (lo < 1 or hi > n - 1):
            raise ValueError(f"{name}: box {tuple(box)} reads ghost cells; read it from "
                             "the padded source (offset 1)")


def region_slices(box, offset: int):
    """(the source window of the box's stencil, the box in the core)."""
    window = tuple(slice(lo + offset - 1, hi + offset + 1) for lo, hi in box)
    return window, tuple(slice(lo, hi) for lo, hi in box)


def box_args(box) -> tuple[int, ...]:
    """lo0, lo1, lo2, e0, e1, e2 of a 2D or 3D box (2D: lo2 = 0, e2 = 1)."""
    lo = [int(a) for a, _ in box] + [0] * (3 - len(box))
    ext = [int(b) - int(a) for a, b in box] + [1] * (3 - len(box))
    return (*lo, *ext)


def extents(shape) -> tuple[int, ...]:
    out = tuple(map(int, shape))
    return out + (1,) * (3 - len(out))


def inv3(inv_d2) -> tuple[float, ...]:
    return tuple(inv_d2) + (0.0,) * (3 - len(inv_d2))


# The ctypes function of each symbol, bound at its first launch.
_FUNCS: dict = {}


def _raw_stream(index: int) -> int:
    """The cudaStream_t of device `index`'s current stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _function(lib_name: str, signatures: dict, symbol: str):
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = _FUNCS[symbol] = getattr(_build.load(lib_name, signatures), symbol)
    return fn


def launch(lib_name: str, signatures: dict, symbol: str, device, *args,
           route: str | None = None) -> None:
    """Call `symbol` of library `lib_name` (built at first use) with `args`
    and this device's current stream; raise if it reports a failure,
    naming `route` (the multi-step kernels' cluster or cooperative launch)
    where given. The device's context is entered only when it is not the
    current one."""
    fn = _function(lib_name, signatures, symbol)
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        on = f" on the {route} route" if route else ""
        raise RuntimeError(
            f"{symbol} launch{on} failed with code {rc} (-1: bad dtype/rank/form/steps/box/plan, "
            "-2: grid overflow, -3: does not fit the card, >0: CUDA error)"
        )


# The layouts a launch of kp_flux or fused_step_padded takes, by the code
# their C layout queries return.
LAYOUT_NAMES = ("scalar cells", "16-byte vectors", "one cell a thread")


def launch_layout(lib_name: str, signatures: dict, symbol: str, *args) -> str:
    """The layout (LAYOUT_NAMES) that a launch takes, asked of the built
    kernel's host query `symbol` (library `lib_name`) with `args`."""
    code = _function(lib_name, signatures, symbol)(*args)
    if not 0 <= code < len(LAYOUT_NAMES):
        raise RuntimeError(f"{symbol} refused its arguments (code {code})")
    return LAYOUT_NAMES[code]


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


# Cells in 16 bytes, by dtype: the cells a lane of masked_step moves.
LANE_CELLS = {torch.float32: 4, torch.float64: 2, torch.bfloat16: 8}


def masked_layout(n_last: int, dtype: torch.dtype, *addresses: int) -> bool:
    """Whether a 16-byte-lane kernel may move vectors (masked_step, kp_flux,
    fused_step_padded): True when the last axis's `n_last` cells are a
    whole number of 16-byte lanes and the operands it moves as vectors
    (masked_step: T, Cm and out; kp_flux: qx; fused_step_padded: Cp and
    out; their `addresses`) all lie on the 16-byte grid; False (scalar
    cells) for a ragged last axis or a view off the grid, and always for
    f64, whose two-cell vectors measured slower on an H100 than its scalar
    cells (masked_step at 12288²: 1.27 ms against 1.185, kp_flux 1.3260
    against 1.2466, scripts/torch_kernel_ab.py)."""
    bits = 0
    for a in addresses:
        bits |= a
    return (dtype is not torch.float64 and n_last % LANE_CELLS[dtype] == 0
            and not bits & 15)


def masked_run_rows(T, run_rows=None, config=None) -> int:
    """The run-length cap of a masked_step launch on `T` (0: the kernel's
    own rule, runs of up to 4 rows). An explicit `run_rows` must be a
    positive int; `config="auto"` fills an unset one from the tuning cache
    (op "diffusion.masked_step") at fields the VMEM loop would not serve,
    as pallas_kernels.py:1225-1245 fills `tm`; a miss keeps 0."""
    from rocm_mpi_tpu_torch.ops import multistep

    if run_rows is not None:
        if not (isinstance(run_rows, int) and not isinstance(run_rows, bool)
                and run_rows >= 1):
            raise ValueError(f"run_rows must be a positive int, got {run_rows!r}")
        return run_rows
    if (multistep.auto_config(config) and multistep._compute_nbytes(T.shape, T.dtype)
            > multistep._VMEM_BLOCK_BUDGET_BYTES):
        from rocm_mpi_tpu_torch.tuning import resolve as tuning_resolve

        tuned = tuning_resolve.resolve("diffusion.masked_step", T.shape, T.dtype,
                                       device=T.device)
        if tuned and tuned.get("run_rows"):
            return int(tuned["run_rows"])
    return 0


def masked_step(T, Cm, spacing, out=None, run_rows=None, config=None):
    """One explicit step with the Dirichlet mask folded into `Cm`.

    Replaces pallas_kernels.masked_step (file:1191: its ghost-block striped
    `_per_step_kernel`, and at small sizes the one-step
    `_multi_step_kernel`, the same function). `T` and `Cm` share the
    unpadded shape; `Cm` is (dt·λ)/Cp where cells update and 0.0 where
    they are held, so held cells come back bit-unchanged.

    Bound on the H100: memory — 3 passes of the field per step (read T and
    Cm, write out) at ~11 flops per cell. Design: a lane moves 16 bytes of
    a row and walks a run of rows with the rows around it in registers,
    neighbours along the last axis by shuffle (csrc/stencil.cu); the
    layout, vectors or scalar cells, is masked_layout's. At 252² the step
    is launch-bound instead (762 KB in f32).

    `run_rows` caps the rows a warp walks (the tuning plane's knob, the
    counterpart of the TPU kernel's stripe height `tm`), and
    `config="auto"` takes it from the tuning cache (masked_run_rows); a
    cell's arithmetic does not depend on its run, so every run length
    gives the same bits. The plain version has no runs.
    """
    check_operands("masked_step", T, {"Cm": Cm}, T.shape, spacing, out)
    cap = masked_run_rows(T, run_rows, config)
    inv_d2 = inv_d2_of(spacing)
    operands = (T, Cm) if out is None else (T, Cm, out)
    if not use_kernel(*operands):
        return masked_step_plain(T, Cm, inv_d2, out=out)
    if out is None:
        out = torch.empty_like(T)
    t, cm, o = T.data_ptr(), Cm.data_ptr(), out.data_ptr()
    launch("stencil", _SIGNATURES, "rmt_masked_step", T.device, _DTYPE_CODE[T.dtype], T.ndim,
           t, cm, o, *extents(T.shape), *inv3(inv_d2), cap,
           masked_layout(T.shape[-1], T.dtype, t, cm, o))
    LAUNCHES["masked_step"] += 1
    return out


# ---------------------------------------------------------------------------
# fused_step_cm — one step of a box of the core, from the core and its faces.
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


def ghost_slices(ndim: int):
    """The 2·ndim ghost faces of a width-1-padded block, in the face order
    of the face form (axis 0 below, axis 0 above, axis 1 below, …): each
    slice tuple spans the core on the other axes."""
    core = slice(1, -1)
    return tuple(
        tuple(at if a == ax else core for a in range(ndim))
        for ax in range(ndim) for at in (slice(0, 1), slice(-1, None)))


def face_views(Tp):
    """(T, faces) of a width-1-padded block as views: its core and its
    2·ndim ghost faces (ghost_slices' order), each face the core's shape
    with extent 1 along its axis."""
    core = tuple(slice(1, -1) for _ in range(Tp.ndim))
    return Tp[core], tuple(Tp[sl] for sl in ghost_slices(Tp.ndim))


def assemble_padded(T, faces):
    """The width-1-padded block of core `T` and its faces (zeros where a
    face is None): the block the face form reads in place."""
    ndim = T.ndim
    Tp = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=T.device)
    Tp[tuple(slice(1, -1) for _ in range(ndim))] = T
    for sl, face in zip(ghost_slices(ndim), faces):
        if face is not None:
            Tp[sl] = face
    return Tp


def fused_step_cm_faces_plain(T, faces, Cm, inv_d2, box=None, out=None):
    """Plain version of the face form: fused_step_cm_plain on the padded
    block assembled from `T` and `faces`, over `box` (default the whole
    core), written into `out` (required with a box)."""
    Tp = assemble_padded(T, faces)
    if box is None:
        return fused_step_cm_plain(Tp, Cm, inv_d2, out=out)
    window, sl = region_slices(box, 1)
    fused_step_cm_plain(Tp[window], Cm[sl], inv_d2, out=out[sl])
    return out


def _face_shape(shape, ax: int) -> tuple[int, ...]:
    return tuple(1 if a == ax else int(n) for a, n in enumerate(shape))


def _rows_contiguous(t: torch.Tensor) -> bool:
    return t.shape[-1] == 1 or t.stride(-1) == 1


def check_faces(name: str, T, faces, Cm, box, spacing, out) -> None:
    """Checks of a face-form launch: `T` (any strides, its last axis
    contiguous), `faces` (2·ndim tensors or None, each the core's shape
    with extent 1 along its axis, a row face's last axis contiguous), `Cm`
    and `out` (contiguous, the core's shape) share a supported dtype and
    device, `out` aliases no input, and `box` lies in the core."""
    if T.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {T.dtype} not supported (float32, float64, bfloat16)")
    ndim = T.ndim
    if ndim not in (2, 3):
        raise ValueError(f"{name}: only 2D and 3D fields, got {ndim}D")
    if not _rows_contiguous(T):
        raise ValueError(f"{name}: T's last axis must be contiguous")
    if spacing is not None and len(spacing) != ndim:
        raise ValueError(f"{name}: {len(spacing)} spacings for a {ndim}D field")
    core_shape = tuple(T.shape)
    if len(faces) != 2 * ndim:
        raise ValueError(f"{name}: {len(faces)} faces for a {ndim}D field (2 per axis)")
    given = [f for f in faces if f is not None]
    for k, face in enumerate(faces):
        if face is None:
            continue
        ax = k // 2
        if face.dtype != T.dtype or face.device != T.device:
            raise TypeError(f"{name}: face {k} is {face.dtype} on {face.device}, T "
                            f"{T.dtype} on {T.device}")
        if tuple(face.shape) != _face_shape(core_shape, ax):
            raise ValueError(f"{name}: face {k} shape {tuple(face.shape)} != "
                             f"{_face_shape(core_shape, ax)}")
        if ax < ndim - 1 and not _rows_contiguous(face):
            raise ValueError(f"{name}: face {k}'s last axis must be contiguous")
    for label, t in (("Cm", Cm), ("out", out)):
        if t is None:
            continue
        if t.dtype != T.dtype or t.device != T.device:
            raise TypeError(f"{name}: {label} is {t.dtype} on {t.device}, T {T.dtype} on "
                            f"{T.device}")
        if tuple(t.shape) != core_shape or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {core_shape}, got "
                             f"{tuple(t.shape)}")
    if out is not None:
        for t in (T, Cm, *given):
            if _overlaps(out, t):
                raise ValueError(f"{name}: out must not alias an input")
    if box is not None:
        if len(box) != ndim:
            raise ValueError(f"{name}: a {len(box)}-axis box for a {ndim}D core")
        for (lo, hi), n in zip(box, core_shape):
            if not 0 <= lo < hi <= n:
                raise ValueError(f"{name}: box {tuple(box)} is empty or outside the core "
                                 f"{core_shape}")


def face_layout(T, faces, Cm, out) -> bool:
    """fused_step_cm's layout, masked_layout's rule over every row it reads
    as vectors: True (16-byte vectors) when the dtype is f32 or bf16, the
    last axis is a whole number of 16-byte lanes, T's and the row faces'
    row strides are too, and T, Cm, out and the row faces lie on the
    16-byte grid; False (scalar cells) otherwise — the padded caller's core,
    a view one cell into the block, always."""
    dtype = T.dtype
    if dtype is torch.float64:
        return False
    kn = LANE_CELLS[dtype]
    ndim = T.ndim
    if T.shape[-1] % kn or T.stride(0) % kn or (ndim == 3 and T.stride(1) % kn):
        return False
    grid = T.data_ptr() | Cm.data_ptr() | out.data_ptr()
    for k, face in enumerate(faces[:2 * (ndim - 1)]):  # the row faces
        if face is None:
            continue
        grid |= face.data_ptr()
        if ndim == 3 and face.stride(1 if k < 2 else 0) % kn:  # its row stride
            return False
    return not grid & 15


def _face_args(T, faces):
    """ctypes arrays of T's strides (axes 0 and 1), the face pointers (0 for
    none) and each face's strides along its other axes."""
    ndim = T.ndim
    strides = (ctypes.c_int64 * 2)(T.stride(0), T.stride(1) if ndim == 3 else 0)
    ptrs = (ctypes.c_int64 * 6)(*[0 if f is None else f.data_ptr() for f in faces])
    fstr = [0] * 12
    for k, face in enumerate(faces):
        if face is not None:
            other = [face.stride(a) for a in range(ndim) if a != k // 2]
            fstr[2 * k:2 * k + len(other)] = other
    return strides, ptrs, (ctypes.c_int64 * 12)(*fstr)


# The checked launch arguments of recent face-form calls, keyed by every
# property of the operands the checks read (pointers, shapes, strides,
# dtypes, devices) with the box and the spacing: a step calls with the
# same few operands again and again, so the checks and the ctypes arrays
# are made once each. Holds no tensor.
_FACE_CALLS: dict = {}
_FACE_CALLS_MAX = 256


def _operand_key(t):
    return None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)


def _face_call(T, faces, Cm, spacing, box, out):
    """check_faces' verdict and the launch's ctypes arguments (T's
    strides, face pointers, face strides, the layout), from _FACE_CALLS
    or made and kept."""
    key = (_operand_key(T), tuple(_operand_key(f) for f in faces), _operand_key(Cm),
           _operand_key(out), tuple(map(tuple, box)), tuple(spacing))
    args = _FACE_CALLS.get(key)
    if args is None:
        check_faces("fused_step_cm", T, faces, Cm, box, spacing, out)
        args = (*_face_args(T, faces), face_layout(T, faces, Cm, out))
        if len(_FACE_CALLS) >= _FACE_CALLS_MAX:
            _FACE_CALLS.clear()
        _FACE_CALLS[key] = args
    return args


def fused_step_cm_faces(T, faces, Cm, spacing, box=None, out=None):
    """fused_step_cm in the face form: a step of `box` (default the whole
    core) of `T` from T and its ghost faces where they lie, written into
    `out` in place (allocated for the whole core when absent); returns
    `out`.

    `faces` holds 2·ndim tensors or None, axis 0 below and above, then
    axis 1, …: each the core's shape with extent 1 along its axis (a
    ghost of the padded block, or a receive buffer of
    halo.exchange_faces). A None face reads as zeros: a domain edge, whose
    cells Cm holds. This is the sharded `perf` and `hide` steps' launch;
    fused_step_cm and fused_step_cm_region pass views into a padded block.

    Bound on the H100: memory — T, the faces and Cm read once, out written
    once, per box. Design: masked_step's (csrc/stencil.cu
    rmt_fused_step_cm_kernel), in the layout of face_layout; f64 takes a
    route of its own (rmt_fused_step_cm_f64_kernel, its warps cut by the
    box's shape), counted in F64_ROUTE_LAUNCHES.
    """
    global F64_ROUTE_LAUNCHES
    if out is None:
        check_faces("fused_step_cm", T, faces, Cm, box, spacing, None)
        out = torch.empty(T.shape, dtype=T.dtype, device=T.device)
    if box is None:
        box = core_box(T.shape)
    strides, ptrs, fstr, vec = _face_call(T, faces, Cm, spacing, box, out)
    if not use_kernel(T, Cm, out, *[f for f in faces if f is not None]):
        return fused_step_cm_faces_plain(T, faces, Cm, inv_d2_of(spacing), box=box, out=out)
    launch("stencil", _SIGNATURES, "rmt_fused_step_cm", T.device, _DTYPE_CODE[T.dtype],
           T.ndim, T.data_ptr(), strides, ptrs, fstr, Cm.data_ptr(), out.data_ptr(),
           *extents(T.shape), *box_args(box), *inv3(inv_d2_of(spacing)), vec)
    LAUNCHES["fused_step_cm"] += 1
    if T.dtype is torch.float64:
        F64_ROUTE_LAUNCHES += 1
    return out


def fused_step_cm(Tp, Cm, spacing, out=None):
    """Masked per-step core update from the padded block: new =
    Tp[core] + Cm · ∇²(Tp).

    Replaces pallas_kernels.fused_step_cm (file:290: whole-block
    `_fused_kernel_whole_cm`, striped `_fused_kernel_striped_cm`). `Tp` is
    the shard grown by one ghost layer per side (halo.exchange_halo);
    `Cm` the core-shaped masked coefficient. On the card this is the face
    form over the whole core, given views into `Tp` (face_views): a core
    one cell into the block, so the scalar layout.

    Bound on the H100: memory — the core and the 2·ndim faces of Tp and
    Cm read once, out written once per step.
    """
    if Tp.ndim != Cm.ndim:
        raise ValueError(f"fused_step_cm: Tp is {Tp.ndim}D, Cm {Cm.ndim}D")
    core_shape = tuple(n - 2 for n in Tp.shape)
    check_operands("fused_step_cm", Tp, {"Cm": Cm}, core_shape, spacing, out)
    operands = (Tp, Cm) if out is None else (Tp, Cm, out)
    if not use_kernel(*operands):
        return fused_step_cm_plain(Tp, Cm, inv_d2_of(spacing), out=out)
    T, faces = face_views(Tp)
    return fused_step_cm_faces(T, faces, Cm, spacing, out=out)


def fused_step_cm_region(src, offset: int, Cm, spacing, box, out):
    """fused_step_cm on one box of the core, written into `out` in place
    (module docstring: the region form). `src` is the padded block
    (offset 1), read through its core and faces, or the raw shard (offset
    0, a box whose stencil stays inside it), read with no faces; returns
    `out`."""
    check_region("fused_step_cm", src, offset, {"Cm": Cm}, box, spacing, out)
    if offset == 1:
        T, faces = face_views(src)
    else:
        T, faces = src, (None,) * (2 * src.ndim)
    return fused_step_cm_faces(T, faces, Cm, spacing, box=box, out=out)


# ---------------------------------------------------------------------------
# fused_step_padded — the unmasked contract's step from a padded block.
# ---------------------------------------------------------------------------


def fused_step_padded_plain(Tp, Cp, lam, dt, inv_d2, out=None):
    """Plain version of the fused_step_padded kernel:
    out = c + ((dt·λ)/Cp) · Σ_ax ((hi - 2·c) + lo) · inv_d2[ax], c = Tp[core],
    with the double dt·λ rounded once to the compute dtype — the operation
    order of pallas_kernels._fused_kernel_whole."""
    cdt = _compute_dtype(Tp.dtype)
    Tpc, Cpc = Tp.to(cdt), Cp.to(cdt)
    ndim = Tp.ndim
    c = Tpc[tuple(slice(1, -1) for _ in range(ndim))]
    lap = None
    for ax in range(ndim):
        hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
        lo = tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
        term = ((Tpc[hi] - 2.0 * c) + Tpc[lo]) * inv_d2[ax]
        lap = term if lap is None else lap + term
    # A 0-dim tensor, not a Python float: `float / tensor` multiplies by
    # the reciprocal in PyTorch, which rounds differently from a division.
    coef = torch.tensor(float(dt) * float(lam), dtype=cdt) / Cpc
    return _store(c + coef * lap, Tp.dtype, out)


def padded_layout(Tp, Cp, out) -> str:
    """The layout (LAYOUT_NAMES) of fused_step_padded's launch on these
    CUDA operands, asked of the built kernel (csrc/stencil.cu
    padded_layout): one cell a thread in f64 and for a field too small to
    fill the card with 16-byte lanes (252², a 96×64×48 block), else the
    vectors where masked_layout allows them over Cp and out, else scalar
    cells. Tp is read cell by cell in every layout."""
    core = tuple(n - 2 for n in Tp.shape)
    return launch_layout("stencil", _SIGNATURES, "rmt_fused_step_padded_layout",
                         _DTYPE_CODE[Tp.dtype], Tp.ndim, *extents(core),
                         masked_layout(core[-1], Tp.dtype, Cp.data_ptr(), out.data_ptr()))


def fused_step_padded(Tp, Cp, lam, dt, spacing, out=None):
    """Candidate update of every core cell from the padded block:
    new = Tp[core] + (dt·λ)/Cp · ∇²(Tp).

    Replaces pallas_kernels.fused_step_padded (file:136: whole-block
    `_fused_kernel_whole` :128, and above the 2 MiB VMEM budget the
    row-striped `_fused_kernel_striped` :180). The whole/striped split is a
    limit of the TPU's VMEM, not of the arithmetic: on the card one launch
    of masked_step's lane tiling covers every size, 2D and 3D,
    f32/f64/bf16, with Tp read cell by cell (csrc/stencil.cu); the launch
    takes the vectors where masked_layout allows them over Cp and out and
    the field fills the card (padded_layout).
    The caller supplies ghosts (halo.exchange_halo) and masks the global
    boundary. Unlike fused_step_cm the coefficient is formed per cell in
    the kernel from Cp and the double dt·λ (`dt` a float or the
    field-dtype time step). No model path calls it, as in the JAX package,
    whose `shard` variant runs the jnp ops.diffusion.step_fused_padded.

    Bound on the H100: memory — (n+2)^d reads of Tp, n^d of Cp, n^d writes.
    """
    if Tp.ndim != Cp.ndim:
        raise ValueError(f"fused_step_padded: Tp is {Tp.ndim}D, Cp {Cp.ndim}D")
    core_shape = tuple(n - 2 for n in Tp.shape)
    check_operands("fused_step_padded", Tp, {"Cp": Cp}, core_shape, spacing, out)
    inv_d2 = inv_d2_of(spacing)
    operands = (Tp, Cp) if out is None else (Tp, Cp, out)
    if not use_kernel(*operands):
        return fused_step_padded_plain(Tp, Cp, lam, dt, inv_d2, out=out)
    if out is None:
        out = torch.empty(core_shape, dtype=Tp.dtype, device=Tp.device)
    cp, o = Cp.data_ptr(), out.data_ptr()
    launch("stencil", _SIGNATURES, "rmt_fused_step_padded", Tp.device, _DTYPE_CODE[Tp.dtype],
           Tp.ndim, Tp.data_ptr(), cp, o, *extents(core_shape), float(dt) * float(lam),
           *inv3(inv_d2), masked_layout(core_shape[-1], Tp.dtype, cp, o))
    LAUNCHES["fused_step_padded"] += 1
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
