"""The acoustic-wave kernels and step functions — counterpart of
rocm_mpi_tpu/ops/wave_kernels.py.

The leapfrog update U⁺ = 2U − U⁻ + dt²·c²·∇²U reads the padded
displacement and a second state array core-only. A zeroed coefficient
alone cannot hold a Dirichlet cell (c² == 0 gives 2U − U⁻ ≠ U), so the
per-step `perf` path masks in the caller, and the masked forms carry the
interior mask M itself: U⁺ = U + M∘(U − U⁻) + Cw∘∇²U with Cw = dt²·c²·M
holds M == 0 cells bitwise.

Three CUDA kernels (csrc/wave.cu, built by _build.py) sit behind the
wrappers, with the dispatch rule of ops/kernels.py: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel, anything
else raises. Launches count in kernels.LAUNCHES under "wave_step",
"wave_step_masked" and "wave_multi_step". The multi-step kernel holds a
block in one thread-block cluster's shared memory where it fits, else in
L2 behind a grid barrier: ops/resident.py picks the route by size before
the launch.

The JAX wrappers fall back to jnp beyond the TPU's VMEM budget and for
f64 on a TPU: both are limits of the TPU, not different arithmetic. On
CUDA the per-step kernels launch at every size and in every dtype. The
multi-step entry points keep the JAX package's admission (half the VMEM
budget: the kernel holds four field-sized arrays) so the port routes the
same shapes the same way.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rocm_mpi_tpu_torch.ops import _build, multistep, resident
from rocm_mpi_tpu_torch.ops.kernels import (
    _DTYPE_CODE,
    BOX,
    C_DBL,
    C_INT,
    C_PTR,
    EXTENTS,
    INV_D2,
    LAUNCHES,
    _check_out,
    _compute_dtype,
    _overlaps,
    _store,
    box_args,
    check_operands,
    check_region,
    core_box,
    edge_mask,
    extents,
    inv3,
    inv_d2_of,
    launch,
    region_slices,
)
from rocm_mpi_tpu_torch.ops.stencil import inn
from rocm_mpi_tpu_torch.utils.backend import use_kernel

# Body forms of _wave_multi_step_kernel, by the code the CUDA kernel takes.
FORMS = {"direct": 0, "aform": 1}

_SIGNATURES = {
    "rmt_wave_step": (C_INT, [C_INT, C_INT, C_PTR, C_PTR, C_PTR, C_PTR, *EXTENTS, C_DBL,
                              *INV_D2, C_PTR]),
    "rmt_wave_step_masked": (C_INT, [C_INT, C_INT, C_PTR, C_PTR, C_PTR, C_PTR, C_PTR,
                                     *EXTENTS, *BOX, *INV_D2, C_PTR]),
    "rmt_wave_multi_step": (C_INT, [C_INT, C_INT, C_INT, C_INT,            # dtype, ndim, form, n
                                    C_PTR, C_PTR, C_PTR, C_PTR,            # U, U⁻, M, Cw
                                    C_PTR, C_PTR, C_PTR,                   # oU, oU⁻, scratch
                                    *EXTENTS, *INV_D2,
                                    C_INT, C_INT, C_INT, C_PTR]),          # cluster, stage, dev
    "rmt_wave_multi_step_caps": (C_INT, [C_INT, C_INT, C_INT, C_INT,
                                         ctypes.POINTER(C_INT)]),
}


def _core(ndim: int) -> tuple:
    """The core of the trailing `ndim` axes; lane axes before them stay
    whole."""
    return (Ellipsis,) + tuple(slice(1, -1) for _ in range(ndim))


def lap_from_padded(Up, inv_d2):
    """Σ_ax ((hi − 2c) + lo)·inv_d2[ax] of every core cell of a width-1
    padded block — pallas_kernels._lap_from_padded's order. The block's
    space axes are its last len(inv_d2); any axes before them are lanes."""
    ndim = len(inv_d2)
    core = _core(ndim)
    lap = None
    for ax in range(ndim):
        hi = (Ellipsis,) + tuple(slice(2, None) if a == ax else slice(1, -1)
                                 for a in range(ndim))
        lo = (Ellipsis,) + tuple(slice(None, -2) if a == ax else slice(1, -1)
                                 for a in range(ndim))
        term = (Up[hi] - 2.0 * Up[core] + Up[lo]) * inv_d2[ax]
        lap = term if lap is None else lap + term
    return lap


def _candidate(Up, Uprev, W, inv_d2):
    """(2c − U⁻) + W·lap, c = Up[core]: the leapfrog candidate with the
    coefficient W (dt²·C2, or the masked Cw) already formed."""
    return (2.0 * Up[_core(len(inv_d2))] - Uprev) + W * lap_from_padded(Up, inv_d2)


# ---------------------------------------------------------------------------
# The jnp-form step functions (field-dtype arithmetic)
# ---------------------------------------------------------------------------


def wave_step_padded(Up, Uprev, C2, dt, spacing):
    """Candidate leapfrog update of every core cell of the padded block, in
    the field dtype: 2U − U⁻ + (dt·dt)·C2·∇²U. `dt` is a Python float or a
    0-dim tensor in the field dtype (then dt·dt rounds in that dtype, as
    JAX's `cfg.jax_dtype(cfg.dt)` squares). The caller supplies ghosts and
    holds the global boundary — the `shard` and `ap` variants' step."""
    return _candidate(Up, Uprev, (dt * dt) * C2, inv_d2_of(spacing))


def wave_step_fused(U, Uprev, C2, dt, spacing):
    """Global-array leapfrog step: edge cells pass through unchanged, the
    block's own boundary ring serves as the padding."""
    out = U.clone()
    out[_core(U.ndim)] = wave_step_padded(U, inn(Uprev), inn(C2), dt, spacing)
    return out


def masked_leapfrog_step(U, Uprev, M, Cw, inv_d2):
    """One roll-based masked leapfrog step, wave_kernels.masked_leapfrog_step:
    (U + M·(U − U⁻)) + Cw·lap with lap = Σ_ax ((roll(U,−1) + roll(U,1)) −
    2U)·inv_d2[ax]. Roll wraparound only feeds cells that M == 0, Cw == 0
    hold, or a deep block's ghost ring. Returns the advanced (U, U⁻)."""
    lap = None
    for ax in range(U.ndim):
        term = (torch.roll(U, -1, ax) + torch.roll(U, 1, ax) - 2.0 * U) * inv_d2[ax]
        lap = term if lap is None else lap + term
    return U + M * (U - Uprev) + Cw * lap, U


def interior_mask(shape, dtype, device=None) -> torch.Tensor:
    """1.0 on interior cells, exactly 0.0 on the edge of an unsharded block."""
    return torch.where(edge_mask(shape, device=device),
                       torch.zeros(tuple(shape), dtype=dtype, device=device),
                       torch.ones(tuple(shape), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# wave_step — the perf step's kernel
# ---------------------------------------------------------------------------


def wave_step_plain(Up, Uprev, C2, dt2: float, inv_d2, out=None):
    """Plain version of the wave_step kernel: ((2c − U⁻) + (dt2·C2)·lap),
    with `dt2` a Python double applied in the compute dtype."""
    cdt = _compute_dtype(Up.dtype)
    res = _candidate(Up.to(cdt), Uprev.to(cdt), dt2 * C2.to(cdt), inv_d2)
    return _store(res, Up.dtype, out)


def wave_step(Up, Uprev, C2, dt, spacing, out=None):
    """Candidate leapfrog update of every core cell of a padded block.

    Replaces wave_kernels.wave_step_padded_pallas (file:76, kernel
    `_wave_kernel_whole` :68). `Up` is the width-1-padded displacement
    (halo.exchange_halo); `Uprev` and `C2` are core-shaped. dt² is the
    double product of `dt` (a float or the field-dtype time step), applied
    in the compute dtype, as the JAX wrapper forms it. The JAX wrapper
    takes its jnp form beyond the VMEM budget and for f64 on a TPU; here
    the kernel launches at every size and in every dtype.

    Bound on the H100: memory — four passes of the field per step (read
    the padded U, U⁻ and C2; write out) at ~12 flops a cell.
    """
    if Up.ndim != C2.ndim:
        raise ValueError(f"wave_step: Up is {Up.ndim}D, C2 {C2.ndim}D")
    core_shape = tuple(n - 2 for n in Up.shape)
    check_operands("wave_step", Up, {"Uprev": Uprev, "C2": C2}, core_shape, spacing, out)
    dt2 = float(dt) * float(dt)
    inv_d2 = inv_d2_of(spacing)
    operands = (Up, Uprev, C2) if out is None else (Up, Uprev, C2, out)
    if not use_kernel(*operands):
        return wave_step_plain(Up, Uprev, C2, dt2, inv_d2, out=out)
    if out is None:
        out = torch.empty(core_shape, dtype=Up.dtype, device=Up.device)
    launch("wave", _SIGNATURES, "rmt_wave_step", Up.device, _DTYPE_CODE[Up.dtype], Up.ndim,
           Up.data_ptr(), Uprev.data_ptr(), C2.data_ptr(), out.data_ptr(),
           *extents(core_shape), dt2, *inv3(inv_d2))
    LAUNCHES["wave_step"] += 1
    return out


# ---------------------------------------------------------------------------
# wave_step_masked — the hide step's region kernel
# ---------------------------------------------------------------------------


def wave_step_masked_plain(Up, Uprev, M, Cw, inv_d2, out=None):
    """Plain version of the wave_step_masked kernel: M·cand + (1 − M)·c,
    cand = (2c − U⁻) + Cw·lap. In f32 and f64 it is also JAX's jnp
    `wave_step_padded_masked` (the compute dtype is the field dtype)."""
    cdt = _compute_dtype(Up.dtype)
    Upc, Mc = Up.to(cdt), M.to(cdt)
    cand = _candidate(Upc, Uprev.to(cdt), Cw.to(cdt), inv_d2)
    return _store(Mc * cand + (1.0 - Mc) * Upc[_core(Up.ndim)], Up.dtype, out)


def wave_step_masked(Up, Uprev, M, Cw, spacing, out=None):
    """Masked-contract leapfrog update of every core cell of a padded block.

    Replaces wave_kernels.wave_step_padded_masked_pallas (file:140, kernel
    `_wave_kernel_whole_masked` :129): M (1.0 updating, exactly 0.0 held)
    and Cw = dt²·c²·M are core-shaped operands prepared once per advance.
    The hold is the arithmetic select M·cand + (1 − M)·U, as JAX computes
    it — not a branch. On the card: the region kernel over the whole core.
    Bound: memory, five passes of the field per step.
    """
    if Up.ndim != M.ndim:
        raise ValueError(f"wave_step_masked: Up is {Up.ndim}D, M {M.ndim}D")
    core_shape = tuple(n - 2 for n in Up.shape)
    check_operands("wave_step_masked", Up, {"Uprev": Uprev, "M": M, "Cw": Cw}, core_shape,
                   spacing, out)
    operands = (Up, Uprev, M, Cw) if out is None else (Up, Uprev, M, Cw, out)
    if not use_kernel(*operands):
        return wave_step_masked_plain(Up, Uprev, M, Cw, inv_d2_of(spacing), out=out)
    if out is None:
        out = torch.empty(core_shape, dtype=Up.dtype, device=Up.device)
    return wave_step_masked_region(Up, 1, Uprev, M, Cw, spacing, core_box(core_shape), out)


def wave_step_masked_region(src, offset: int, Uprev, M, Cw, spacing, box, out):
    """wave_step_masked on one box of the core, written into `out` in place
    (ops/kernels.py: the region form). `src` is the padded displacement
    (offset 1) or the raw shard (offset 0); returns `out`."""
    check_region("wave_step_masked", src, offset, {"Uprev": Uprev, "M": M, "Cw": Cw}, box,
                 spacing, out)
    inv_d2 = inv_d2_of(spacing)
    if not use_kernel(src, Uprev, M, Cw, out):
        window, sl = region_slices(box, offset)
        wave_step_masked_plain(src[window], Uprev[sl], M[sl], Cw[sl], inv_d2, out=out[sl])
        return out
    launch("wave", _SIGNATURES, "rmt_wave_step_masked", src.device, _DTYPE_CODE[src.dtype],
           src.ndim, src.data_ptr(), Uprev.data_ptr(), M.data_ptr(), Cw.data_ptr(),
           out.data_ptr(), *extents(out.shape), *box_args(box), offset, *inv3(inv_d2))
    LAUNCHES["wave_step_masked"] += 1
    return out


# ---------------------------------------------------------------------------
# wave_multi_step — the VMEM-resident loop and the deep sweep's local steps
# ---------------------------------------------------------------------------


def wave_multi_step_form(chunk: int, inv_d2) -> str:
    """The body form _wave_multi_step_kernel computes (file:211): the
    A-form for chunks >= 4 on equal spacing, else the direct form."""
    if chunk >= 4 and all(inv == inv_d2[0] for inv in inv_d2):
        return "aform"
    return "direct"


def wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, n: int, form: str, out=None):
    """Plain version of the wave_multi_step kernel: `n` masked leapfrog
    steps in body form `form` ("aform" or "direct") in
    _wave_multi_step_kernel's operation order, neighbours outside the
    block read as 0. bf16 is widened once and the pair rounded once.
    Returns (U, U⁻), into the pair `out` when given."""
    if form not in FORMS:
        raise ValueError(f"unknown body form {form!r}; known: {tuple(FORMS)}")
    cdt = _compute_dtype(U.dtype)
    Uc, Upc, Mc, Cwc = (t.to(cdt) for t in (U, Uprev, M, Cw))
    ndim = U.ndim
    P = torch.zeros(tuple(s + 2 for s in U.shape), dtype=cdt, device=U.device)
    if form == "aform":
        c = Cwc * inv_d2[0]
        A = (1.0 + Mc) - (2.0 * ndim) * c
    for _ in range(int(n)):
        P[_core(ndim)] = Uc
        pairs = multistep._neighbour_pairs(P, ndim)
        if form == "aform":
            S = functools.reduce(lambda a, b: a + b, pairs)
            new = (A * Uc + c * S) - Mc * Upc
        else:
            lap = None
            for ax in range(ndim):
                term = (pairs[ax] - 2.0 * Uc) * inv_d2[ax]
                lap = term if lap is None else lap + term
            new = (Uc + Mc * (Uc - Upc)) + Cwc * lap
        Uc, Upc = new, Uc
    if out is None:
        return Uc.to(U.dtype), Upc.to(U.dtype)
    return out[0].copy_(Uc), out[1].copy_(Upc)


def _check_shapes(U, Uprev, M, Cw) -> None:
    if not (U.shape == Uprev.shape == M.shape == Cw.shape):
        raise ValueError(f"shape mismatch: U {tuple(U.shape)}, Uprev {tuple(Uprev.shape)}, "
                         f"M {tuple(M.shape)}, Cw {tuple(Cw.shape)}")


def _check_pair(name: str, U, Uprev, M, Cw, out) -> None:
    _check_shapes(U, Uprev, M, Cw)
    check_operands(name, U, {"Uprev": Uprev, "M": M, "Cw": Cw}, U.shape, None, None)
    if out is not None:
        for o in out:
            _check_out(name, o, U.shape, U.dtype, (U, Uprev, M, Cw))
        if _overlaps(out[0], out[1]):
            raise ValueError(f"{name}: the two outputs must not alias")


def leapfrog_multi_step(U, Uprev, M, Cw, inv_d2, n: int, form: str, out=None):
    """The wave_multi_step kernel's wrapper: `n` steps of body form `form`
    in one launch for CUDA tensors, wave_multi_step_plain for CPU ones.
    Returns the pair (U, U⁻), into `out` (a pair) when given."""
    _check_pair("wave_multi_step", U, Uprev, M, Cw, out)
    if form not in FORMS:
        raise ValueError(f"unknown body form {form!r}; known: {tuple(FORMS)}")
    operands = (U, Uprev, M, Cw) + (tuple(out) if out is not None else ())
    if not use_kernel(*operands):
        return wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, n, form, out=out)
    if out is None:
        out = (torch.empty_like(U), torch.empty_like(U))
    index = U.device.index
    plan = device_plan(index, tuple(U.shape), U.dtype, form)
    scratch = None  # the cluster route keeps the state in shared memory
    if plan.route == "cooperative":
        scratch = resident.scratch(2, U.shape, _compute_dtype(U.dtype), U.device)
    launch("wave", _SIGNATURES, "rmt_wave_multi_step", U.device, _DTYPE_CODE[U.dtype], U.ndim,
           FORMS[form], int(n), U.data_ptr(), Uprev.data_ptr(), M.data_ptr(), Cw.data_ptr(),
           out[0].data_ptr(), out[1].data_ptr(),
           None if scratch is None else scratch.data_ptr(), *extents(U.shape),
           *inv3(inv_d2), plan.cluster, int(plan.stage), index, route=plan.route)
    LAUNCHES["wave_multi_step"] += 1
    return tuple(out)


@functools.lru_cache(maxsize=None)
def device_caps(index: int, dtype: torch.dtype, ndim: int, form: str) -> resident.Caps:
    """What CUDA device `index` grants the cluster route of one kernel
    instantiation, asked of the built kernel once."""
    fn = _build.load("wave", _SIGNATURES).rmt_wave_multi_step_caps
    return resident.query_caps(fn, index, _DTYPE_CODE[dtype], ndim, FORMS[form])


@functools.lru_cache(maxsize=None)
def device_plan(index: int, shape: tuple, dtype: torch.dtype, form: str) -> resident.ResidentPlan:
    """The route of a wave_multi_step launch on CUDA device `index`
    (ops/resident.py), made once per (device, shape, dtype, form)."""
    return resident.plan("wave", shape, dtype, device_caps(index, dtype, len(shape), form))


def _check_wave_vmem(U, what: str, hint: str = "") -> int:
    """The JAX package's admission of the wave loop: half the VMEM budget
    at the compute width (four field-sized arrays). Returns the bytes."""
    if U.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {U.dtype} not supported (float32, float64, bfloat16)")
    nbytes = multistep._compute_nbytes(U.shape, U.dtype)
    budget = multistep._VMEM_BLOCK_BUDGET_BYTES // 2
    if nbytes > budget:
        raise ValueError(f"{what} of {nbytes} bytes (f32 compute width) exceeds the wave "
                         f"VMEM-resident budget ({budget}){hint}")
    return nbytes


def wave_multi_step_masked(U, Uprev, M, Cw, spacing, n_steps: int, out=None):
    """`n_steps` masked leapfrog steps on a block with caller-supplied M and
    Cw (dt²·c² where the cell updates, exactly 0.0 where held), in one
    launch of the wave_multi_step kernel. Returns the pair (U, U⁻).

    Replaces wave_kernels.wave_multi_step_masked (file:244, kernel
    `_wave_multi_step_kernel` :188): the deep-halo sweep's local compute,
    and each chunk of wave_multi_step. The body form is the TPU kernel's
    choice for this chunk and spacing (wave_multi_step_form).
    """
    _check_shapes(U, Uprev, M, Cw)
    _check_wave_vmem(U, "block")
    n = int(n_steps)
    if n == 0:
        return U.clone(), Uprev.clone()
    inv_d2 = inv_d2_of(spacing)
    return leapfrog_multi_step(U, Uprev, M, Cw, inv_d2, n, wave_multi_step_form(n, inv_d2),
                               out=out)


def wave_sweeps(U, dt, spacing, n_steps: int, chunk=None, warn_on_cap=True,
                config=None) -> multistep.SweepPlan:
    """The wave's VMEM loop of a single-shard state like `U` as a
    multistep.SweepPlan: the chunk policy of multistep.resolve_step_chunk
    for `n_steps`; `prepare(U, C2) -> (M, Cw)` per call (M =
    interior_mask, Cw = dt²·C2·M with dt² the double product, as the JAX
    package forms it); `sweep(U, Uprev, M, Cw, out=None) -> (U, U⁻)` one
    launch of the wave_multi_step kernel."""
    if multistep.auto_config(config) and chunk is None:
        tuned = multistep.tuned_knobs("wave.vmem_loop", U.shape, U.dtype, U.device)
        if "chunk" in tuned:
            chunk = math.gcd(int(n_steps), tuned["chunk"]) or None
    nbytes = _check_wave_vmem(U, "field", "; use the per-step path")
    chunk = multistep.resolve_step_chunk(n_steps, chunk, nbytes, warn_on_cap)
    dt2 = float(dt) * float(dt)

    def prepare(U, C2):
        M = interior_mask(U.shape, U.dtype, U.device)
        return M, (dt2 * C2) * M

    def sweep(U, Uprev, M, Cw, out=None):
        return wave_multi_step_masked(U, Uprev, M, Cw, spacing, chunk, out=out)

    return multistep.SweepPlan(chunk, sweep, prepare)


def wave_multi_step(U, Uprev, C2, dt, spacing, n_steps: int, chunk=None, warn_on_cap=True,
                    config=None):
    """Advance a single-shard leapfrog state `n_steps`, `chunk` steps per
    launch of the wave_multi_step kernel, with the Dirichlet edge held by
    M = interior_mask and Cw = dt²·C2·M formed once per call (dt² the
    double product, as the JAX package forms it).

    Replaces wave_kernels.wave_multi_step (file:283): the chunk policy is
    multistep.resolve_step_chunk's (default gcd(n_steps, 256), capped past
    256 KB), a chunk that does not divide `n_steps` raises, and
    `config="auto"` fills an unset chunk from the tuning cache (op
    "wave.vmem_loop", gcd'd against `n_steps`; a miss keeps the default).
    Returns the pair (U, U⁻); the inputs are not written.
    """
    plan = wave_sweeps(U, dt, spacing, n_steps, chunk, warn_on_cap, config)
    M, Cw = plan.prepare(U, C2)
    pair, spare = (U, Uprev), None
    for _ in range(int(n_steps) // plan.k):
        nxt = plan.sweep(*pair, M, Cw, out=spare)
        spare = None if pair[0] is U else pair
        pair = nxt
    return pair
