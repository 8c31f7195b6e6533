"""The shallow-water kernels and step functions — counterpart of
rocm_mpi_tpu/ops/swe_kernels.py.

The linearised shallow-water equations in a closed basin, on a C-grid
where every field keeps the same array shape (h at cell centres, u_a at
the +a face of its cell), stepped forward-backward:

    h' = h − Σ_a cH_a·(u_a − u_a[−e_a])           (backward differences)
    u_a' = M_a ∘ (u_a − cg_a·(h'[+e_a] − h'))       (forward, updated h)

with cH_a = dt·H/d_a and cg_a = dt·g/d_a (`swe_coeffs`). The face mask M_a
is exactly 0.0 on the global high wall face and 1.0 elsewhere, so wall
velocities stay 0 and Σh is conserved exactly: the divergence telescopes
to wall − wall.

The state is ndim+1 coupled fields: the update of each reads neighbours
of the others, and u_a'[c] reads h'[c + e_a], which reads u_b[c + e_a −
e_b], a diagonal neighbour. One exchange of the whole state (corners by
the exchange's two-stage trick) advances a step, because the padded form
computes h' one cell beyond the core on the high side.

Two CUDA kernels (csrc/swe.cu, built by _build.py) sit behind the
wrappers, with the dispatch rule of ops/kernels.py: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel, anything
else raises. Launches count in kernels.LAUNCHES under "swe_step" and
"swe_multi_step". The multi-step kernel holds a block in one thread-block
cluster's shared memory where it fits, else in L2 behind a grid barrier:
ops/resident.py picks the route by size before the launch.

The JAX wrapper of the per-step kernel falls back to jnp beyond the TPU's
VMEM budget and for f64 on a TPU: limits of the TPU, not different
arithmetic. On CUDA the per-step kernel launches at every size and in
every dtype. The multi-step entry points keep the JAX package's admission,
(3·ndim + 2)·compute_nbytes(h) <= 2 MiB, so the port routes the same
shapes the same way.

Where the roll form wraps around (`masked_swe_step`, the JAX multi-step
kernel), the multi-step kernel and its plain version read zeros instead.
On the global field the wrapped value is a wall face (held 0 by M) and
the cell it feeds is a wall face (M == 0), so both give the same value,
up to the sign of a zero; on a deep block both only reach the ghost ring
the sweep crops.
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
    LAUNCHES,
    _check_out,
    _compute_dtype,
    _overlaps,
    _store,
    box_args,
    check_region,
    core_box,
    extents,
    launch,
    region_slices,
)
from rocm_mpi_tpu_torch.utils.backend import use_kernel

COEFFS = [C_DBL] * 6  # cH0..cH2, cg0..cg2 (0.0 past ndim)
_SIGNATURES = {
    "rmt_swe_step": (C_INT, [C_INT, C_INT,                     # dtype, ndim
                             C_PTR, C_PTR, C_PTR, C_PTR,       # source h, u0, u1, u2
                             C_PTR, C_PTR, C_PTR,              # M0, M1, M2
                             C_PTR, C_PTR, C_PTR, C_PTR,       # out h, u0, u1, u2
                             *EXTENTS, *BOX, *COEFFS, C_PTR]),
    "rmt_swe_multi_step": (C_INT, [C_INT, C_INT, C_INT,        # dtype, ndim, n
                                   C_PTR, C_PTR, C_PTR, C_PTR,  # h, u0, u1, u2
                                   C_PTR, C_PTR, C_PTR,         # M0, M1, M2
                                   C_PTR, C_PTR, C_PTR, C_PTR,  # out h, u0, u1, u2
                                   C_PTR,                       # scratch
                                   *EXTENTS, *COEFFS,
                                   C_INT, C_INT, C_INT, C_PTR]),  # cluster, stage, dev
    "rmt_swe_multi_step_caps": (C_INT, [C_INT, C_INT, C_INT, ctypes.POINTER(C_INT)]),
}


def swe_coeffs(dt, spacing, H, g):
    """Per-axis update coefficients (cH_a, cg_a) = (dt·H/d_a, dt·g/d_a), in
    Python doubles, as swe_kernels.swe_coeffs forms them."""
    cH = tuple(float(dt) * float(H) / float(d) for d in spacing)
    cg = tuple(float(dt) * float(g) / float(d) for d in spacing)
    return cH, cg


def _coeff_args(cH, cg) -> tuple[float, ...]:
    pad = (0.0,) * (3 - len(cH))
    return (*cH, *pad, *cg, *pad)


def _ptrs(ts) -> tuple:
    """data_ptr of each of up to four tensors, None past the last."""
    return tuple(t.data_ptr() for t in ts) + (None,) * (4 - len(ts))


# ---------------------------------------------------------------------------
# The jnp-form step functions (field-dtype arithmetic)
# ---------------------------------------------------------------------------


def masked_swe_step(h, us, Mus, cH, cg):
    """One forward-backward step in the roll form, in the field dtype —
    swe_kernels.masked_swe_step: the `ap` variant's step and the deep
    sweep's "jnp" route. Rolls wrap around; on the global field the
    wrapped value meets a zero mask, on a deep block only its ghost ring.
    Returns (h', us')."""
    div = None
    for a, u in enumerate(us):
        d = cH[a] * (u - torch.roll(u, 1, a))
        div = d if div is None else div + d
    h = h - div
    us = tuple(Mus[a] * (u - cg[a] * (torch.roll(h, -1, a) - h)) for a, u in enumerate(us))
    return h, us


def _swe_padded_math(hp, ups, Mus, cH, cg):
    """The staggered-index update of every core cell of width-1-padded
    leaves — swe_kernels._swe_padded_math, its slices and operation order:
    h' on the core plus the high pad, then each u_a' from the forward
    difference of h'. Returns the core tuple (h', u0', …)."""
    ndim = len(ups)  # the space axes are the last ndim; any before are lanes
    E = (Ellipsis,)
    ext = E + tuple(slice(1, None) for _ in range(ndim))
    div = None
    for a, up in enumerate(ups):
        lo = E + tuple(slice(0, -1) if ax == a else slice(1, None) for ax in range(ndim))
        d = cH[a] * (up[ext] - up[lo])
        div = d if div is None else div + d
    h_ext = hp[ext] - div
    h_core = h_ext[E + tuple(slice(0, -1) for _ in range(ndim))]
    core = E + tuple(slice(1, -1) for _ in range(ndim))
    outs = [h_core]
    for a, up in enumerate(ups):
        sh = E + tuple(slice(1, None) if ax == a else slice(0, -1) for ax in range(ndim))
        dh = h_ext[sh] - h_core
        outs.append(Mus[a] * (up[core] - cg[a] * dh))
    return tuple(outs)


def swe_step_padded(Sp, Mus, consts, dt, spacing):
    """The padded SWE update in the field dtype — swe_kernels.swe_step_padded,
    the `shard` variant's step: `Sp = (hp, u0p, …)` width-1 padded,
    `Mus` core-shaped, `consts = (H, g)`. Returns the core tuple."""
    hp, *ups = Sp
    H, g = consts
    cH, cg = swe_coeffs(dt, spacing, H, g)
    return _swe_padded_math(hp, ups, Mus, cH, cg)


# ---------------------------------------------------------------------------
# swe_step — the perf step's kernel, and its region form for hide
# ---------------------------------------------------------------------------


def swe_step_plain(Sp, Mus, cH, cg, out=None):
    """Plain version of the swe_step kernel: `_swe_padded_math` on the
    widened leaves with cH/cg applied in the compute dtype, each result
    rounded once (into the tuple `out` when given)."""
    dtype = Sp[0].dtype
    cdt = _compute_dtype(dtype)
    res = _swe_padded_math(Sp[0].to(cdt), [u.to(cdt) for u in Sp[1:]],
                           [M.to(cdt) for M in Mus], cH, cg)
    if out is None:
        return tuple(r.to(dtype) for r in res)
    return tuple(_store(r, dtype, o) for r, o in zip(res, out))


def _check_leaves(name: str, src, Mus, out, core_shape) -> int:
    """Leaf counts, shapes, dtypes and aliasing of an SWE step's tuples:
    ndim+1 contiguous source leaves of one shape and dtype, ndim masks,
    ndim+1 outputs of `core_shape` that alias neither an input nor each
    other. Returns ndim."""
    ndim = src[0].ndim
    if ndim not in (2, 3):
        raise ValueError(f"{name}: only 2D and 3D fields, got {ndim}D")
    if len(src) != ndim + 1 or len(Mus) != ndim or len(out) != ndim + 1:
        raise ValueError(f"{name}: need {ndim + 1} state leaves, {ndim} masks and "
                         f"{ndim + 1} outputs, got {len(src)}, {len(Mus)} and {len(out)}")
    if src[0].dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {src[0].dtype} not supported "
                        "(float32, float64, bfloat16)")
    for t in (*src, *Mus):
        if t.dtype != src[0].dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != field dtype {src[0].dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every leaf and mask must be contiguous")
    for t in src[1:]:
        if tuple(t.shape) != tuple(src[0].shape):
            raise ValueError(f"{name}: state leaves share one shape: {tuple(src[0].shape)} "
                             f"vs {tuple(t.shape)}")
    inputs = (*src, *Mus)
    for i, o in enumerate(out):
        _check_out(name, o, core_shape, src[0].dtype, inputs)
        if any(_overlaps(o, p) for p in out[:i]):
            raise ValueError(f"{name}: the outputs must not alias each other")
    return ndim


def swe_step_region(src, offset: int, box, Mus, coeffs, out):
    """swe_step on one box of the core, each leaf of the tuple `out`
    written in place (ops/kernels.py: the region form). `src` is the
    padded state (offset 1) or the raw shard (offset 0, for a box whose
    stencil, diagonal neighbours included, stays inside it); `coeffs` is
    swe_coeffs' (cH, cg). h' one cell beyond the box on the high side is
    recomputed from `src`, never read from another box's output.
    Returns `out`."""
    if out is None:
        raise ValueError("swe_step: a region launch writes into `out`, which must be given")
    src, out = tuple(src), tuple(out)
    ndim = _check_leaves("swe_step", src, Mus, out, out[0].shape)
    check_region("swe_step", src[0], offset, {f"M{a}": M for a, M in enumerate(Mus)}, box,
                 None, out[0])
    cH, cg = coeffs
    if len(cH) != ndim or len(cg) != ndim:
        raise ValueError(f"swe_step: {len(cH)}/{len(cg)} coefficients for a {ndim}D field")
    if not use_kernel(*src, *Mus, *out):
        window, sl = region_slices(box, offset)
        swe_step_plain(tuple(s[window] for s in src), tuple(M[sl] for M in Mus), cH, cg,
                       out=tuple(o[sl] for o in out))
        return out
    launch("swe", _SIGNATURES, "rmt_swe_step", src[0].device, _DTYPE_CODE[src[0].dtype],
           ndim, *_ptrs(src), *_ptrs(Mus)[:3], *_ptrs(out), *extents(out[0].shape),
           *box_args(box), offset, *_coeff_args(cH, cg))
    LAUNCHES["swe_step"] += 1
    return out


def swe_step(Sp, Mus, consts, dt, spacing, out=None):
    """One forward-backward step of every core cell of the padded state.

    Replaces swe_kernels.swe_step_padded_pallas (file:142, kernel
    `_swe_kernel_whole` :125). `Sp = (hp, u0p, …)` is the width-1-padded
    state (one halo.exchange_halo per leaf), `Mus` the core-shaped face
    masks, `consts = (H, g)`; cH and cg are formed in Python doubles and
    applied in the compute dtype. The JAX wrapper takes its jnp form
    beyond the VMEM budget and for f64 on a TPU; here the kernel launches
    at every size and in every dtype: the region kernel over the whole
    core. Returns the core tuple (h', u0', …), into `out` when given.

    Bound on the H100: memory — 3·ndim + 2 field passes a step (ndim+1
    padded reads, ndim masks, ndim+1 writes: 8 in 2D) at 7·ndim
    operations a cell.
    """
    Sp = tuple(Sp)
    core_shape = tuple(n - 2 for n in Sp[0].shape)
    use_kernel(*Sp, *Mus)  # raises for a device with no dispatch before allocating
    if out is None:
        out = tuple(torch.empty(core_shape, dtype=Sp[0].dtype, device=Sp[0].device)
                    for _ in Sp)
    if len(spacing) != Sp[0].ndim:
        raise ValueError(f"swe_step: {len(spacing)} spacings for a {Sp[0].ndim}D field")
    H, g = consts
    return swe_step_region(Sp, 1, core_box(core_shape), Mus, swe_coeffs(dt, spacing, H, g),
                           out)


# ---------------------------------------------------------------------------
# swe_multi_step — the VMEM-resident loop and the deep sweep's local steps
# ---------------------------------------------------------------------------


def _shift(x, axis: int, direction: int):
    """x moved one cell along `axis`, zero where nothing moves in:
    direction +1 gives out[i] = x[i − 1], −1 gives out[i] = x[i + 1]."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    if direction > 0:
        out.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
    return out


def swe_multi_step_plain(h, us, Mus, cH, cg, n: int, out=None):
    """Plain version of the swe_multi_step kernel: `n` masked_swe_step
    updates in its operation order, with neighbours outside the block read
    as 0 (module docstring) — u_a at i − e_a, and h' at i + e_a. bf16 is
    widened once and the state rounded once. Returns (h, us), into the
    tuple `out` ((h, u0, …)) when given."""
    dtype = h.dtype
    cdt = _compute_dtype(dtype)
    hc = h.to(cdt)
    uc = tuple(u.to(cdt) for u in us)
    Mc = tuple(M.to(cdt) for M in Mus)
    for _ in range(int(n)):
        div = None
        for a, u in enumerate(uc):
            d = cH[a] * (u - _shift(u, a, +1))
            div = d if div is None else div + d
        hc = hc - div
        uc = tuple(Mc[a] * (u - cg[a] * (_shift(hc, a, -1) - hc)) for a, u in enumerate(uc))
    if out is None:
        return hc.to(dtype), tuple(u.to(dtype) for u in uc)
    out = tuple(out)
    return out[0].copy_(hc), tuple(o.copy_(u) for o, u in zip(out[1:], uc))


def _check_shapes(h, us, Mus) -> None:
    """The JAX multi-step wrapper's checks: ndim velocities and masks, all
    of h's shape."""
    ndim = h.ndim
    if len(us) != ndim or len(Mus) != ndim:
        raise ValueError(f"need ndim={ndim} velocity fields and masks, got {len(us)} and "
                         f"{len(Mus)}")
    for t in (*us, *Mus):
        if tuple(t.shape) != tuple(h.shape):
            raise ValueError(f"all SWE fields share one shape: h {tuple(h.shape)} vs "
                             f"{tuple(t.shape)}")


def fb_multi_step(h, us, Mus, cH, cg, n: int, out=None):
    """The swe_multi_step kernel's wrapper: `n` forward-backward steps in
    one launch for CUDA tensors, swe_multi_step_plain for CPU ones.
    Returns (h, us), into the tuple `out` ((h, u0, …)) when given."""
    _check_shapes(h, us, Mus)
    n = int(n)
    if n < 1:
        raise ValueError(f"swe_multi_step: n must be >= 1, got {n}")
    src = (h, *us)
    use_kernel(*src, *Mus)  # raises for a device with no dispatch before allocating
    outs = tuple(out) if out is not None else tuple(torch.empty_like(h) for _ in src)
    ndim = _check_leaves("swe_multi_step", src, Mus, outs, h.shape)
    if len(cH) != ndim or len(cg) != ndim:
        raise ValueError(f"swe_multi_step: {len(cH)}/{len(cg)} coefficients for a {ndim}D "
                         "field")
    if not use_kernel(*src, *Mus, *outs):
        return swe_multi_step_plain(h, us, Mus, cH, cg, n, out=out)
    index = h.device.index
    plan = device_plan(index, tuple(h.shape), h.dtype)
    scratch = None  # the cluster route keeps the state in shared memory
    if plan.route == "cooperative":
        scratch = resident.scratch(2 * (ndim + 1), h.shape, _compute_dtype(h.dtype), h.device)
    launch("swe", _SIGNATURES, "rmt_swe_multi_step", h.device, _DTYPE_CODE[h.dtype], ndim, n,
           *_ptrs(src), *_ptrs(Mus)[:3], *_ptrs(outs),
           None if scratch is None else scratch.data_ptr(), *extents(h.shape),
           *_coeff_args(cH, cg), plan.cluster, int(plan.stage), index, route=plan.route)
    LAUNCHES["swe_multi_step"] += 1
    return outs[0], outs[1:]


@functools.lru_cache(maxsize=None)
def device_caps(index: int, dtype: torch.dtype, ndim: int) -> resident.Caps:
    """What CUDA device `index` grants the cluster route of one kernel
    instantiation, asked of the built kernel once."""
    fn = _build.load("swe", _SIGNATURES).rmt_swe_multi_step_caps
    return resident.query_caps(fn, index, _DTYPE_CODE[dtype], ndim)


@functools.lru_cache(maxsize=None)
def device_plan(index: int, shape: tuple, dtype: torch.dtype) -> resident.ResidentPlan:
    """The route of a swe_multi_step launch on CUDA device `index`
    (ops/resident.py), made once per (device, shape, dtype)."""
    return resident.plan("swe", shape, dtype, device_caps(index, dtype, len(shape)))


def swe_state_nbytes(shape, dtype) -> int:
    """The JAX admission's measure: 2·(ndim+1) state and ndim mask arrays
    at the compute width (>= 4 bytes), (3·ndim + 2)·compute_nbytes."""
    return (3 * len(shape) + 2) * multistep._compute_nbytes(shape, dtype)


def swe_admitted(shape, dtype) -> bool:
    """True when a block of `shape` passes the JAX multi-step admission
    (swe_kernels.py:219-225, deep_halo.py:501)."""
    return swe_state_nbytes(shape, dtype) <= multistep._VMEM_BLOCK_BUDGET_BYTES


def _check_swe_vmem(h, hint: str = "") -> None:
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {h.dtype} not supported (float32, float64, bfloat16)")
    nbytes = swe_state_nbytes(h.shape, h.dtype)
    if nbytes > multistep._VMEM_BLOCK_BUDGET_BYTES:
        raise ValueError(f"state of {nbytes} bytes (f32 compute width) exceeds the "
                         f"VMEM-resident budget ({multistep._VMEM_BLOCK_BUDGET_BYTES}){hint}")


def swe_multi_step_masked(h, us, Mus, cH, cg, n_steps: int, out=None):
    """`n_steps` forward-backward steps on a block with caller-supplied face
    masks (wall and off-domain faces at exactly 0.0), in one launch of the
    swe_multi_step kernel. Returns (h, us).

    Replaces swe_kernels.swe_multi_step_masked (file:197, kernel
    `_swe_multi_step_kernel` :177): the deep-halo sweep's local compute,
    and each chunk of swe_multi_step. The JAX admission holds: the state
    must fit (3·ndim + 2)·compute_nbytes <= 2 MiB.
    """
    _check_shapes(h, us, Mus)
    _check_swe_vmem(h)
    n = int(n_steps)
    if n == 0:
        return h.clone(), tuple(u.clone() for u in us)
    return fb_multi_step(h, us, Mus, cH, cg, n, out=out)


def swe_sweeps(h, dt, spacing, H, g, n_steps: int, chunk=None, warn_on_cap=True,
               config=None) -> multistep.SweepPlan:
    """The SWE's VMEM loop of a single-shard state like `h` as a
    multistep.SweepPlan: the JAX admission and the chunk policy of
    multistep.resolve_step_chunk for `n_steps`; `sweep(h, us, Mus,
    out=None) -> (h, us)` one launch of the swe_multi_step kernel (no
    per-call work: the masks are the caller's)."""
    if multistep.auto_config(config) and chunk is None:
        tuned = multistep.tuned_knobs("swe.vmem_loop", h.shape, h.dtype, h.device)
        if "chunk" in tuned:
            chunk = math.gcd(int(n_steps), tuned["chunk"]) or None
    _check_swe_vmem(h, "; use the per-step path")
    chunk = multistep.resolve_step_chunk(
        n_steps, chunk, multistep._compute_nbytes(h.shape, h.dtype), warn_on_cap)
    cH, cg = swe_coeffs(dt, spacing, H, g)

    def sweep(h, us, Mus, out=None):
        return swe_multi_step_masked(h, us, Mus, cH, cg, chunk, out=out)

    return multistep.SweepPlan(chunk, sweep)


def swe_multi_step(h, us, Mus, dt, spacing, H, g, n_steps: int, chunk=None,
                   warn_on_cap=True, config=None):
    """Advance a single-shard SWE state `n_steps`, `chunk` steps per launch
    of the swe_multi_step kernel. `Mus` must already hold the wall faces
    (ShallowWater.face_masks).

    Replaces swe_kernels.swe_multi_step (file:242): the chunk policy is
    multistep.resolve_step_chunk's (default gcd(n_steps, 256), capped past
    256 KB a field), a chunk that does not divide `n_steps` raises, the
    admission is the JAX one, and `config="auto"` fills an unset chunk
    from the tuning cache (op "swe.vmem_loop", gcd'd against `n_steps`; a
    miss keeps the default). Returns (h, us); the inputs are not written.
    """
    plan = swe_sweeps(h, dt, spacing, H, g, n_steps, chunk, warn_on_cap, config)
    state, spare = (h, tuple(us)), None
    for _ in range(int(n_steps) // plan.k):
        nxt = plan.sweep(*state, Mus, out=spare)
        spare = None if state[0] is h else (state[0], *state[1])
        state = nxt
    return state
