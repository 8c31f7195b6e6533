"""The multi-step schedules' kernels — counterpart of the VMEM-resident
loop and the temporal-blocked sweep of rocm_mpi_tpu/ops/pallas_kernels.py
(`fused_multi_step`, `multi_step_cm`, `fused_multi_step_hbm`,
`multi_step_cm_hbm`, and the planners that route them).

Two CUDA kernels (csrc/multistep.cu, built by _build.py) sit behind the
wrappers, with the same dispatch rule as ops/kernels.py: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel, and
anything else raises. Launches count in kernels.LAUNCHES under
"multi_step_cm" and "tb_sweep". The multi_step_cm kernel holds a block in
one thread-block cluster's shared memory where it fits, else in L2 behind
a grid barrier: ops/resident.py picks the route by size before the launch.

The constants below are the JAX package's TPU budgets (VMEM, Mosaic's
compile envelope, the sublane-tiled stripe geometry). They mean nothing
to an H100; they are kept, with the planners, so the port takes the same
route and the same floating-point body form at every shape as the JAX
package does, which is what makes the two comparable.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
import re
import warnings
from typing import Callable, NamedTuple

import torch

from rocm_mpi_tpu_torch.ops import _build, resident
from rocm_mpi_tpu_torch.ops.kernels import (
    _DTYPE_CODE,
    LAUNCHES,
    _compute_dtype,
    _overlaps,
    edge_masked_cm,
    extents,
    inv3,
    inv_d2_of,
    launch,
)
from rocm_mpi_tpu_torch.utils.backend import use_kernel

# pallas_kernels.py:40 — whole-block (VMEM-resident) admission budget.
_VMEM_BLOCK_BUDGET_BYTES = 2 * 1024 * 1024
# :44 — the striped kernels' slab budget (Mosaic compile envelope).
_PS_SLAB_BUDGET_BYTES = 2_500_000
# :423, :433 — the equal-spacing body form and the pow2 pad default.
EQC_BODY_FORM = "eqc"
VMEM_PAD_POW2 = False
# :672, :676 — default chunk, and the largest field the A/c forms take.
DEFAULT_STEP_CHUNK = 256
_AC_FORM_MAX_BYTES = 512 * 1024
# :949-958 — temporal blocking and deep-sweep depths, stripe geometry.
DEFAULT_TB_STEPS = 8
DEFAULT_DEEP_STEPS = 32
_TB_G = 8
_TB_TM = 16
_TB_MAX_STEPS = 16

# Body forms of _multi_step_kernel, by the code the CUDA kernel takes.
FORMS = {"direct": 0, "ac": 1, "eqc": 2, "conly": 3}

_SIGNATURES = {
    "rmt_multi_step_cm": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # dtype, ndim, form, n
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # T, Cm, out
        ctypes.c_void_p,                                          # scratch
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,           # extents
        ctypes.c_double, ctypes.c_double, ctypes.c_double,        # inv_d2
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # cluster, cm_at, device
        ctypes.c_void_p,                                          # cudaStream_t
    ]),
    "rmt_multi_step_cm_caps": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "rmt_tb_sweep": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # dtype, ndim, k
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # T, Cm, out
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,           # extents
        ctypes.c_int64,                                           # seg_rows
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # 3D: e1, e2, threads, cm_ring
        ctypes.c_double, ctypes.c_double, ctypes.c_double,        # inv_d2
        ctypes.c_int,                                             # device index
        ctypes.c_void_p,                                          # cudaStream_t
    ]),
    "rmt_tb_warps_per_sm": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    # dtype, k, e1, e2, threads, cm_ring, dev; dtype, k, e1, e2, cm_ring
    "rmt_tb3_blocks_per_sm": (ctypes.c_int, [ctypes.c_int] * 7),
    "rmt_tb3_smem_bytes": (ctypes.c_int64, [ctypes.c_int] * 5),
}


def _compute_itemsize(dtype: torch.dtype) -> int:
    """In-kernel bytes per element: bf16 is computed at f32 width, so
    every budget is taken at >= 4 bytes (pallas_kernels._compute_itemsize)."""
    return max(torch.empty((), dtype=dtype).element_size(), 4)


def _compute_nbytes(shape, dtype) -> int:
    return math.prod(shape) * _compute_itemsize(dtype)


# ---------------------------------------------------------------------------
# Planners (pallas_kernels.py:435-711, :961-1016)
# ---------------------------------------------------------------------------


class KernelChoice(NamedTuple):
    """What the VMEM loop decided for a call: route, effective chunk and
    body form, and the pad outcome (True applied, False requested but
    skipped for the budget, None not requested or nothing to pad)."""

    op: str
    dispatch: str
    chunk: int | None = None
    body_form: str | None = None
    pad_requested: bool = False
    pad_applied: bool | None = None
    padded_shape: tuple | None = None


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def adoptable_vmem_chunk(v) -> bool:
    """May a tuned chunk steer the VMEM loop? Only a power of two >= 4, so
    gcd(n, v) stays in the default chunk's body-form class."""
    return (
        isinstance(v, int) and not isinstance(v, bool)
        and v >= 4 and (v & (v - 1)) == 0
    )


def auto_config(config) -> bool:
    """True for config="auto" (the tuning cache fills the knobs a caller
    left unset); False for None and "default" (the defaults); anything
    else raises."""
    if config == "auto":
        return True
    if config not in (None, "default"):
        raise ValueError(f"config must be None, 'default' or 'auto', got {config!r}")
    return False


def tuned_knobs(op: str, shape, dtype, device) -> dict:
    """The knobs the tuning cache holds for VMEM loop `op` at `shape` on
    `device` ({} on a miss), its chunk only where adoptable_vmem_chunk
    allows it: the config="auto" seam of the three VMEM loops."""
    from rocm_mpi_tpu_torch.tuning import resolve as tuning_resolve

    tuned = dict(tuning_resolve.resolve(op, shape, dtype, device=device) or {})
    if not adoptable_vmem_chunk(tuned.get("chunk")):
        tuned.pop("chunk", None)
    return tuned


def plan_vmem_loop(shape, dtype, n_steps, chunk=None, body_form=None,
                   pad_pow2=None, config=None, warn_on_cap=False, device=None) -> KernelChoice:
    """The VMEM loop's decisions as a pure function of its inputs: body
    form, pow2 pad, and the chunk that resolve_step_chunk allows.

    `config="auto"` fills the knobs left None from the tuning cache (op
    "diffusion.vmem_loop" at `shape` on `device`, the device the loop
    runs on); a tuned chunk is a preference, gcd'd against `n_steps` and
    taken only where adoptable_vmem_chunk allows; a miss keeps the
    defaults (pallas_kernels.py:500-535)."""
    shape = tuple(int(d) for d in shape)
    if auto_config(config):
        tuned = tuned_knobs("diffusion.vmem_loop", shape, dtype, device)
        if chunk is None and "chunk" in tuned:
            chunk = math.gcd(int(n_steps), tuned["chunk"]) or None
        if body_form is None:
            body_form = tuned.get("body_form")
        if pad_pow2 is None:
            pad_pow2 = tuned.get("pad_pow2")
    if body_form is None:
        body_form = EQC_BODY_FORM
    if body_form not in ("eqc", "conly"):
        raise ValueError(f"body_form must be 'eqc' or 'conly', got {body_form!r}")
    if pad_pow2 is None:
        pad_pow2 = VMEM_PAD_POW2
    nbytes = _compute_nbytes(shape, dtype)
    pad_applied: bool | None = None
    padded_shape = None
    if pad_pow2:
        padded = tuple(_next_pow2(d) for d in shape)
        pad_bytes = _compute_nbytes(padded, dtype)
        if padded == shape:
            pad_applied = None
        elif pad_bytes <= _VMEM_BLOCK_BUDGET_BYTES:
            pad_applied = True
            padded_shape = padded
            nbytes = pad_bytes  # the unroll cap must see the padded size
        else:
            pad_applied = False
    eff_chunk = resolve_step_chunk(n_steps, chunk, nbytes, warn_on_cap)
    return KernelChoice(
        op="diffusion.vmem_loop", dispatch="vmem-loop", chunk=eff_chunk,
        body_form=body_form, pad_requested=bool(pad_pow2),
        pad_applied=pad_applied, padded_shape=padded_shape,
    )


def resolve_step_chunk(n_steps: int, chunk, nbytes: int, warn_on_cap=True) -> int:
    """The chunk policy of the VMEM loop: default gcd(n_steps, 256); an
    explicit chunk must divide n_steps; fields beyond 256 KB cap the chunk
    at gcd(chunk, 16), warning when that degrades an explicit request."""
    n_steps = int(n_steps)
    explicit = chunk is not None
    if chunk is None:
        chunk = math.gcd(n_steps, DEFAULT_STEP_CHUNK)
    if n_steps % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide n_steps {n_steps}")
    if nbytes > 256 * 1024:
        capped = math.gcd(chunk, 16) or 1
        if explicit and warn_on_cap and capped != chunk:
            warnings.warn(
                f"chunk degraded: {chunk} requested but the {nbytes}-byte "
                f"field exceeds the 256 KB unroll-friendly class; running "
                f"chunk={capped}.",
                stacklevel=3,
            )
        chunk = capped
    return chunk


def multi_step_form(shape, dtype, chunk: int, inv_d2, body_form=None) -> str:
    """The body form _multi_step_kernel computes for this launch:
    "direct" for chunks under 4 or fields over 512 KB, else "ac" for
    unequal spacing, else the equal-spacing form `body_form` (default
    EQC_BODY_FORM)."""
    if chunk >= 4 and _compute_nbytes(shape, dtype) <= _AC_FORM_MAX_BYTES:
        if all(inv == inv_d2[0] for inv in inv_d2):
            form = EQC_BODY_FORM if body_form is None else body_form
            if form not in ("eqc", "conly"):
                raise ValueError(f"body_form must be 'eqc' or 'conly', got {form!r}")
            return form
        return "ac"
    return "direct"


def tb_geometry(k: int) -> tuple[int, int]:
    """(ghost rows g, stripe height tm) of a k-step sweep in the JAX
    package: (8, 16) for k <= 8, (16, 32) for k <= 16. The port keeps it
    for the same shape checks and routing; its kernel tiles otherwise."""
    if 1 <= k <= _TB_G:
        return _TB_G, _TB_TM
    if _TB_G < k <= _TB_MAX_STEPS:
        return 16, 32
    raise ValueError(
        f"temporal-blocked sweeps support 1 <= k <= {_TB_MAX_STEPS}, got {k}"
    )


def tb_slab_fits(k: int, shape, dtype) -> bool:
    """True when a k-deep sweep's (tm+2g)-row slab at f32 compute width
    fits the JAX package's slab budget (_PS_SLAB_BUDGET_BYTES)."""
    g, tm = tb_geometry(k)
    row = _compute_itemsize(dtype)
    for n in shape[1:]:
        row *= n
    return (tm + 2 * g) * row <= _PS_SLAB_BUDGET_BYTES


def hbm_class_edge(itemsize: int = 4, k: int = DEFAULT_TB_STEPS) -> int:
    """Smallest square-shard edge whose k-padded block exceeds the VMEM
    budget, in stripe-height steps (so the padded rows stay divisible)."""
    g, tm = tb_geometry(k)
    if (2 * k) % tm != 0:
        raise ValueError(
            f"hbm_class_edge needs 2k divisible by the stripe height "
            f"(k={k}, tm={tm}) so the padded row count stays "
            "stripe-divisible; pass k=8 or k=16"
        )
    n = tm
    while (n + 2 * k) ** 2 * itemsize <= _VMEM_BLOCK_BUDGET_BYTES:
        n += tm
    return n


class TbLayout(NamedTuple):
    """The 2D tb_sweep kernel's layout: columns a lane holds and warps a
    block (csrc/multistep.cu's kTbLaneCols, kTbWarpsPerBlock)."""

    lane_cols: int
    warps_per_block: int

    @property
    def strip_cols(self) -> int:
        """Loaded columns of a warp's strip: 32 lanes of lane_cols."""
        return 32 * self.lane_cols


@functools.lru_cache(maxsize=None)
def tb_layout() -> TbLayout:
    """The layout as the kernel's source states it, read from it, so that
    the plan and the kernel cannot disagree."""
    src = (_build.CSRC / "multistep.cu").read_text()
    return TbLayout(*(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                      for name in ("kTbLaneCols", "kTbWarpsPerBlock")))


class TbPlan(NamedTuple):
    """How the 2D tb_sweep kernel cuts an (n0, n1) block: `strips` column
    strips of `core_cols` core columns (each loaded with k halo columns a
    side, tb_layout().strip_cols in all), `segments` row segments of
    `seg_rows` core rows (loaded with k halo rows a side); one warp a
    (strip, segment) tile, in `waves` rounds of the card's resident warps.
    The kernel takes `seg_rows` and derives the rest itself."""

    k: int
    core_cols: int
    strips: int
    seg_rows: int
    segments: int
    waves: int


def tb_plan(shape, k: int, resident_warps: int) -> TbPlan:
    """The 2D tb_sweep plan of a k-step sweep over `shape` on a card that
    holds `resident_warps` of the kernel's warps at once. The segment
    height minimises the sweep's estimated time, waves × (rows a warp
    walks): tall segments waste less on halo rows, and enough of them
    fill the card in whole waves."""
    n0, n1 = (int(n) for n in shape)
    if not 1 <= k <= _TB_MAX_STEPS:
        raise ValueError(f"tb_sweep supports 1 <= k <= {_TB_MAX_STEPS}, got {k}")
    if n0 < 1 or n1 < 1 or resident_warps < 1:
        raise ValueError(f"tb_plan: empty block {tuple(shape)} or no resident warps")
    core_cols = tb_layout().strip_cols - 2 * k
    strips = -(-n1 // core_cols)
    best = None
    for segments in range(1, n0 + 1):
        seg_rows = -(-n0 // segments)
        if segments > 1 and seg_rows == best[1]:
            continue  # the same height as fewer segments
        waves = -(-(strips * -(-n0 // seg_rows)) // resident_warps)
        cost = waves * (seg_rows + 2 * k)
        if best is None or cost < best[0]:
            best = (cost, seg_rows, waves)
        if seg_rows <= 2 * k:
            break  # shorter segments are mostly halo
    _, seg_rows, waves = best
    return TbPlan(k, core_cols, strips, seg_rows, -(-n0 // seg_rows), waves)


def tb_tiles(plan: TbPlan, shape):
    """The core boxes ((r0, r1), (c0, c1)) of the plan's tiles over
    `shape`, clipped to the block."""
    n0, n1 = (int(n) for n in shape)
    for seg in range(plan.segments):
        for strip in range(plan.strips):
            yield ((seg * plan.seg_rows, min((seg + 1) * plan.seg_rows, n0)),
                   (strip * plan.core_cols, min((strip + 1) * plan.core_cols, n1)))


class Tb3Limits(NamedTuple):
    """The 3D tb_sweep kernel's limits: cells of the tile a thread owns
    and threads a block (csrc/multistep.cu's kTb3MaxCells,
    kTb3MaxThreads)."""

    max_cells: int
    max_threads: int


@functools.lru_cache(maxsize=None)
def tb3_limits() -> Tb3Limits:
    """The limits as the kernel's source states them, read from it."""
    return Tb3Limits(*(resident._constant("multistep.cu", name)
                       for name in ("kTb3MaxCells", "kTb3MaxThreads")))


def tb3_pitch(e2: int) -> int:
    """Lanes of a tile row: whole warps (multistep.cu tb3_pitch)."""
    return -(-e2 // 32) * 32


def tb3_smem_bytes(k: int, e1: int, e2: int, dtype: torch.dtype, cm_ring: bool) -> int:
    """Shared bytes of a 3D block (multistep.cu tb3_smem_bytes): level 0's
    ring of three planes of the e1 × e2 tile of T and, with `cm_ring`, the
    ring of k + 1 planes of Cm, both in the storage type (each rounded up
    to 16 bytes), then a ring of three planes of each level L = 1..k-1
    over its cone (e1 - 2L) × (e2 - 2L) in the compute type."""
    item = torch.empty((), dtype=dtype).element_size()

    def tile(planes):
        return -(-planes * e1 * e2 * item // 16) * 16

    cone = sum((e1 - 2 * L) * (e2 - 2 * L) for L in range(1, k))
    return tile(3) + (tile(k + 1) if cm_ring else 0) + 3 * cone * _compute_itemsize(dtype)


# An H100's shared memory a block may opt into, and the resident blocks the
# plan assumes where it is not given the card's answer (the CPU tests).
H100_SMEM_OPTIN = 232_448
_SM_SMEM = 233_472  # an SM's shared memory; each block also takes 1 KB of it


def tb3_resident_estimate(threads: int, smem: int) -> int:
    """Blocks an H100 SM holds of a 3D plan, from threads (at most 64
    registers a thread, the kernel's launch bound) and shared bytes: what
    rmt_tb3_blocks_per_sm answers on the card, for plans made without
    one."""
    return max(0, min(65536 // (64 * threads), _SM_SMEM // (smem + 1024), 32))


class Tb3Plan(NamedTuple):
    """How the 3D tb_sweep kernel cuts an (n0, n1, n2) block: tiles of the
    (axis 1, axis 2) cross-section of e1 × e2 loaded cells (a core of
    (e1 - 2k) × (e2 - 2k) and k halo cells a side), `tiles1` × `tiles2` of
    them, over `segments` segments of `seg` core planes (loaded with k
    halo planes a side); one block of `threads` a (tile, segment), in
    `waves` rounds of the card's `blocks_per_sm` resident blocks an SM.
    `cm_ring`: Cm goes through a ring in shared memory (where it fits),
    else each level reads it from device memory. The kernel takes k, e1,
    e2, threads, seg and cm_ring and derives the rest."""

    k: int
    e1: int
    e2: int
    threads: int
    seg: int
    cm_ring: bool
    tiles1: int
    tiles2: int
    segments: int
    blocks_per_sm: int
    waves: int
    smem: int


# The 3D plan's cost model, in SM cycles: the issue cycles of one warp's
# pass over one level of its row (a cell's ~30 instructions: six shared
# reads, a read of Cm, the update, a store), and the latency of one
# thread's dependent chain through a level (a shared read, the update's
# operations in a row, the store). A level that reads Cm from device
# memory is weighed double, so the plan takes the ring wherever it fits
# (measured 2-6 % faster at a given plan on an H100).
_TB3_PASS_CYCLES = 30 / 4  # four schedulers an SM
_TB3_LATENCY = 100
_TB3_DEVICE_CM = 2.0


@functools.lru_cache(maxsize=None)
def _tb3_row_levels(k: int, e1: int, e2: int) -> int:
    """Warp passes a plane step costs a block: for each tile row and warp
    of it, one pass for level 0 and one for each level its lanes reach
    (the farthest lane's: the one nearest the row's middle)."""
    passes = 0
    for first in range(0, e2, 32):
        j2 = min(max((e2 - 1) // 2, first), min(first + 32, e2) - 1)
        cols = min(j2, e2 - 1 - j2)
        passes += sum(1 + min(j1, e1 - 1 - j1, k, cols) for j1 in range(e1))
    return passes


def _tb3_candidates(shape, k: int):
    """(e1, e2, threads) of the plans considered: cores of a few sizes up to
    the block's extent (e2 also at the warp widths 32..128), 32 to 1024
    threads, at most max_cells cells a thread and no thread without one."""
    _, n1, n2 = shape
    limits = tb3_limits()
    cores1 = {c for c in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, n1) if c <= n1}
    e2s = {2 * k + c for c in (1, 2, 4, 8, n2) if c <= n2}
    e2s |= {w for w in (32, 64, 96, 128) if 2 * k < w <= n2 + 2 * k}
    for e1 in sorted(2 * k + c for c in cores1):
        for e2 in sorted(e2s):
            lanes = e1 * tb3_pitch(e2)
            for threads in (32, 64, 128, 256, 512, 1024):
                if (threads <= min(lanes, limits.max_threads)
                        and lanes <= limits.max_cells * threads):
                    yield e1, e2, threads


def tb3_plan(shape, k: int, dtype: torch.dtype, sms: int, blocks_per_sm=None,
             smem_limit: int = H100_SMEM_OPTIN) -> Tb3Plan:
    """The 3D tb_sweep plan of a k-step sweep over `shape` in `dtype` on a
    card of `sms` SMs. `blocks_per_sm(e1, e2, threads, cm_ring)` is the
    card's answer for a candidate (tb3_resident_estimate where None). Each
    candidate tile, thread count and Cm route is sized in segments to
    minimise the estimated time, waves × the slower of a wave's issue
    cycles (the blocks of an SM share its schedulers) and one block's
    latency chain; ties go to the smaller tile."""
    n0, n1, n2 = (int(n) for n in shape)
    if not 1 <= k <= _TB_MAX_STEPS:
        raise ValueError(f"tb_sweep supports 1 <= k <= {_TB_MAX_STEPS}, got {k}")
    if min(n0, n1, n2) < 1 or sms < 1:
        raise ValueError(f"tb3_plan: empty block {tuple(shape)} or no SMs")
    best = None
    for (e1, e2, threads), cm_ring in itertools.product(_tb3_candidates((n0, n1, n2), k),
                                                        (True, False)):
        smem = tb3_smem_bytes(k, e1, e2, dtype, cm_ring)
        if smem > smem_limit:
            continue
        resident = (tb3_resident_estimate(threads, smem) if blocks_per_sm is None
                    else blocks_per_sm(e1, e2, threads, cm_ring))
        if resident < 1:
            continue
        tiles1, tiles2 = -(-n1 // (e1 - 2 * k)), -(-n2 // (e2 - 2 * k))
        slow = 1.0 if cm_ring else _TB3_DEVICE_CM
        passes = _tb3_row_levels(k, e1, e2) * slow
        chain = -(-e1 * tb3_pitch(e2) // threads) * (k + 1) * _TB3_LATENCY * slow
        last = None
        for segments in range(1, n0 + 1):
            seg = -(-n0 // segments)
            if seg == last:
                continue
            last = seg
            segments = -(-n0 // seg)
            blocks = tiles1 * tiles2 * segments
            waves = -(-blocks // (sms * resident))
            per_sm = min(resident, -(-blocks // sms))
            steps = seg + (k if segments == 1 else 2 * k)
            cost = waves * steps * max(per_sm * passes * _TB3_PASS_CYCLES, chain)
            key = (cost, e1 * e2, threads)
            if best is None or key < best[0]:
                best = (key, Tb3Plan(k, e1, e2, threads, seg, cm_ring, tiles1, tiles2,
                                     segments, resident, waves, smem))
            if seg <= 2 * k:
                break  # shorter segments are mostly halo
    if best is None:
        raise ValueError(f"tb_sweep: no 3D plan of k={k} {dtype} fits {smem_limit} B of "
                         f"shared memory for {tuple(shape)}")
    return best[1]


def tb3_tiles(plan: Tb3Plan, shape):
    """The core boxes ((r0, r1), (a0, a1), (b0, b1)) of the plan's blocks
    over `shape`, clipped to the block."""
    n0, n1, n2 = (int(n) for n in shape)
    c1, c2 = plan.e1 - 2 * plan.k, plan.e2 - 2 * plan.k
    for seg in range(plan.segments):
        for t1 in range(plan.tiles1):
            for t2 in range(plan.tiles2):
                yield ((seg * plan.seg, min((seg + 1) * plan.seg, n0)),
                       (t1 * c1, min((t1 + 1) * c1, n1)), (t2 * c2, min((t2 + 1) * c2, n2)))


def tb3_updates(plan: Tb3Plan, shape) -> int:
    """Cell updates a launch of the plan computes: each block's plane
    steps times the cones of its levels (halo and cells past the block's
    edge included) — against math.prod(shape) · k that the sweep needs."""
    n0 = int(shape[0])
    k, e1, e2 = plan.k, plan.e1, plan.e2
    cone = sum((e1 - 2 * s) * (e2 - 2 * s) for s in range(1, k + 1))
    steps = 0
    for seg in range(plan.segments):
        r0, r1 = seg * plan.seg, min((seg + 1) * plan.seg, n0)
        steps += r1 + k - max(r0 - k, 0)
    return steps * plan.tiles1 * plan.tiles2 * cone


@functools.lru_cache(maxsize=None)
def _device_plan3(index: int, shape: tuple, k: int, dtype) -> Tb3Plan:
    """tb3_plan for CUDA device `index`: its SMs, shared memory a block and
    resident blocks of each candidate asked of the card and the built
    kernel once per (device, shape, k, dtype)."""
    lib = _build.load("multistep", _SIGNATURES)
    props = torch.cuda.get_device_properties(index)
    code = _DTYPE_CODE[dtype]

    def blocks_per_sm(e1, e2, threads, cm_ring):
        with torch.cuda.device(index):
            return max(0, lib.rmt_tb3_blocks_per_sm(code, k, e1, e2, threads, int(cm_ring),
                                                    index))

    return tb3_plan(shape, k, dtype, props.multi_processor_count, blocks_per_sm,
                    getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN))


@functools.lru_cache(maxsize=None)
def _device_plan(index: int, shape: tuple, k: int, dtype) -> TbPlan:
    """tb_plan for CUDA device `index`, its resident warps read from the
    built kernel once per (device, dtype, k)."""
    return tb_plan(shape, k, _resident_warps(index, k, dtype))


@functools.lru_cache(maxsize=None)
def _resident_warps(index: int, k: int, dtype) -> int:
    lib = _build.load("multistep", _SIGNATURES)
    with torch.cuda.device(index):
        per_sm = lib.rmt_tb_warps_per_sm(_DTYPE_CODE[dtype], k, index)
    if per_sm < 1:
        raise RuntimeError(f"tb_sweep: no resident warp of the k={k} {dtype} kernel "
                           f"(code {per_sm})")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _neighbour_pairs(P: torch.Tensor, ndim: int):
    """p_ax = (cell at +1) + (cell at -1) along each axis, for every core
    cell of the zero-ringed buffer P."""
    pairs = []
    for ax in range(ndim):
        hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
        lo = tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
        pairs.append(P[hi] + P[lo])
    return pairs


def multi_step_cm_plain(T, Cm, inv_d2, n: int, body_form: str, out=None):
    """Plain version of the multi_step_cm kernel: `n` steps of body form
    `body_form` ("direct", "ac", "eqc", "conly") in _multi_step_kernel's
    operation order, with neighbours outside the block read as 0. bf16 is
    widened once and the result rounded once."""
    if body_form not in FORMS:
        raise ValueError(f"unknown body form {body_form!r}; known: {tuple(FORMS)}")
    cdt = _compute_dtype(T.dtype)
    Tc, Cmc = T.to(cdt), Cm.to(cdt)
    ndim = T.ndim
    core = tuple(slice(1, -1) for _ in range(ndim))
    P = torch.zeros(tuple(s + 2 for s in T.shape), dtype=cdt, device=T.device)
    if body_form == "ac":
        cs = [Cmc * inv for inv in inv_d2]
        A = 1.0 - 2.0 * functools.reduce(lambda a, b: a + b, cs)
    elif body_form in ("eqc", "conly"):
        c = Cmc * inv_d2[0]
        coef = 1.0 - (2.0 * ndim) * c if body_form == "eqc" else 2.0 * ndim
    for _ in range(int(n)):
        P[core] = Tc
        pairs = _neighbour_pairs(P, ndim)
        if body_form == "direct":
            lap = None
            for ax in range(ndim):
                term = (pairs[ax] - 2.0 * Tc) * inv_d2[ax]
                lap = term if lap is None else lap + term
            Tc = Tc + Cmc * lap
        elif body_form == "ac":
            acc = A * Tc
            for ax in range(ndim):
                acc = acc + cs[ax] * pairs[ax]
            Tc = acc
        else:
            s = functools.reduce(lambda a, b: a + b, pairs)
            Tc = coef * Tc + c * s if body_form == "eqc" else Tc + c * (s - coef * Tc)
    if out is None:
        return Tc.to(T.dtype)
    return out.copy_(Tc)


def tb_sweep_plain(T, Cm, inv_d2, k: int, out=None):
    """Plain version of the tb_sweep kernel: `k` direct-form steps
    (_tb_kernel's body) with neighbours outside the block read as 0 — on
    the whole block, which the light-cone tiling reproduces exactly."""
    return multi_step_cm_plain(T, Cm, inv_d2, k, "direct", out=out)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check_operands(name: str, T, Cm, out) -> None:
    if T.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {T.dtype} not supported "
                        "(float32, float64, bfloat16)")
    if Cm.dtype != T.dtype:
        raise TypeError(f"{name}: Cm dtype {Cm.dtype} != field dtype {T.dtype}")
    if T.ndim not in (2, 3):
        raise ValueError(f"{name}: only 2D and 3D fields, got {T.ndim}D")
    if tuple(T.shape) != tuple(Cm.shape):
        raise ValueError(f"shape mismatch: T {tuple(T.shape)} vs Cm {tuple(Cm.shape)}")
    for label, t in (("field", T), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if out is not None:
        if tuple(out.shape) != tuple(T.shape) or out.dtype != T.dtype:
            raise ValueError(f"{name}: out must be {tuple(T.shape)} {T.dtype}, got "
                             f"{tuple(out.shape)} {out.dtype}")
        if not out.is_contiguous():
            raise ValueError(f"{name}: out must be contiguous")
        if _overlaps(out, T) or _overlaps(out, Cm):
            raise ValueError(f"{name}: out must not alias an input")


def multi_step(T, Cm, inv_d2, n: int, form: str, out=None):
    """The multi_step_cm kernel's wrapper: `n` steps of body form `form`
    in one launch for CUDA tensors, multi_step_cm_plain for CPU ones. The
    route is device_plan's; the cooperative route keeps its state in
    resident.scratch."""
    _check_operands("multi_step_cm", T, Cm, out)
    if form not in FORMS:
        raise ValueError(f"unknown body form {form!r}; known: {tuple(FORMS)}")
    operands = (T, Cm) if out is None else (T, Cm, out)
    if not use_kernel(*operands):
        return multi_step_cm_plain(T, Cm, inv_d2, n, form, out=out)
    if out is None:
        out = torch.empty_like(T)
    index = T.device.index
    plan = device_plan(index, tuple(T.shape), T.dtype, form)
    scratch = None  # the cluster route keeps the state in shared memory
    if plan.route == "cooperative":
        scratch = resident.scratch(2, T.shape, _compute_dtype(T.dtype), T.device)
    launch("multistep", _SIGNATURES, "rmt_multi_step_cm", T.device, _DTYPE_CODE[T.dtype],
           T.ndim, FORMS[form], int(n), T.data_ptr(), Cm.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), *extents(T.shape),
           *inv3(inv_d2), plan.cluster, cm_at(plan), index, route=plan.route)
    LAUNCHES["multi_step_cm"] += 1
    return out


def cm_at(plan: resident.ResidentPlan) -> int:
    """Where a multi_step_cm launch reads Cm (multistep.cu CmAt): 0 device
    memory, 1 staged into shared memory, 2 registers."""
    return 2 if plan.registers else int(plan.stage)


@functools.lru_cache(maxsize=None)
def device_caps(index: int, dtype: torch.dtype, ndim: int, form: str) -> resident.Caps:
    """What CUDA device `index` grants the cluster route of one kernel
    instantiation, asked of the built kernel once."""
    fn = _build.load("multistep", _SIGNATURES).rmt_multi_step_cm_caps
    return resident.query_caps(fn, index, _DTYPE_CODE[dtype], ndim, FORMS[form])


@functools.lru_cache(maxsize=None)
def device_plan(index: int, shape: tuple, dtype: torch.dtype,
                form: str) -> resident.ResidentPlan:
    """The route of a multi_step_cm launch on CUDA device `index`
    (ops/resident.py), made once per (device, shape, dtype, form)."""
    return resident.plan("diffusion", shape, dtype,
                         device_caps(index, dtype, len(shape), form))


def tb_sweep(T, Cm, inv_d2, k: int, out=None):
    """The tb_sweep kernel's wrapper: `k` (1..16) direct-form steps by
    temporal blocking in one launch for CUDA tensors, tb_sweep_plain for
    CPU ones. Each launch follows its plan for the device, shape, k and
    dtype: a 2D launch tb_plan's column strips and row segments, a 3D one
    tb3_plan's cross-section tiles, segments, threads and Cm route."""
    _check_operands("tb_sweep", T, Cm, out)
    k = int(k)
    if not 1 <= k <= _TB_MAX_STEPS:
        raise ValueError(f"tb_sweep supports 1 <= k <= {_TB_MAX_STEPS}, got k={k}")
    operands = (T, Cm) if out is None else (T, Cm, out)
    if not use_kernel(*operands):
        return tb_sweep_plain(T, Cm, inv_d2, k, out=out)
    if out is None:
        out = torch.empty_like(T)
    index = T.device.index
    if T.ndim == 2:
        cut = (_device_plan(index, tuple(T.shape), k, T.dtype).seg_rows, 0, 0, 0, 0)
    else:
        p = _device_plan3(index, tuple(T.shape), k, T.dtype)
        cut = (p.seg, p.e1, p.e2, p.threads, int(p.cm_ring))
    launch("multistep", _SIGNATURES, "rmt_tb_sweep", T.device, _DTYPE_CODE[T.dtype], T.ndim,
           k, T.data_ptr(), Cm.data_ptr(), out.data_ptr(), *extents(T.shape), *cut,
           *inv3(inv_d2), index)
    LAUNCHES["tb_sweep"] += 1
    return out


def _repeat(launch, T, count: int):
    """Apply `launch(field, out)` `count` times, ping-ponging between two
    buffers of its own (the caller's T is read, never written)."""
    cur, spare = T, None
    for _ in range(count):
        nxt = launch(cur, spare)
        spare = None if cur is T else cur
        cur = nxt
    return cur


# ---------------------------------------------------------------------------
# Entry points (pallas_kernels.py:714-852, :1019-1137)
# ---------------------------------------------------------------------------


def _check_vmem(T, what: str, hint: str) -> None:
    if T.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {T.dtype} not supported (float32, float64, bfloat16)")
    nbytes = _compute_nbytes(T.shape, T.dtype)
    if nbytes > _VMEM_BLOCK_BUDGET_BYTES:
        raise ValueError(
            f"{what} of {nbytes} bytes (f32 compute width) exceeds the "
            f"VMEM-resident budget ({_VMEM_BLOCK_BUDGET_BYTES}); {hint}"
        )


class SweepPlan(NamedTuple):
    """A one-rank multi-step loop cut for a driver: `sweep(...)` one
    launch of `k` steps; `prepare(...)` the per-call work (diffusion:
    `(T, Cp) -> (T, Cm)`, the edge-masked coefficient and the pow2 pad of
    the field and the coefficient where one applies), and `finish(T)`
    the launch's block back at the caller's shape, each None where there
    is nothing to do. The ops' loops (fused_multi_step,
    fused_multi_step_hbm, wave.wave_multi_step, swe.swe_multi_step) drive
    it eagerly; the models' schedules through a sweep loop
    (models/scan.py)."""

    k: int
    sweep: Callable
    prepare: Callable | None = None
    finish: Callable | None = None


def vmem_sweeps(T, lam, dt, spacing, n_steps: int, chunk=None, warn_on_cap=True,
                body_form=None, pad_pow2=None, config=None) -> SweepPlan:
    """The VMEM loop of a single-shard field like `T` as a SweepPlan: the
    chunk, body form and pad of plan_vmem_loop for `n_steps`, one launch
    of the multi_step_cm kernel a sweep."""
    _check_vmem(T, "field", "use the per-step path")
    lam, dt = float(lam), float(dt)
    inv_d2 = inv_d2_of(spacing)
    orig_shape = tuple(T.shape)
    choice = plan_vmem_loop(orig_shape, T.dtype, n_steps, chunk=chunk, body_form=body_form,
                            pad_pow2=pad_pow2, config=config, warn_on_cap=warn_on_cap,
                            device=T.device)
    widths = []
    if choice.pad_applied:
        for p, d in reversed(list(zip(choice.padded_shape, orig_shape))):
            widths += [0, p - d]
    elif choice.pad_applied is False:
        warnings.warn(
            f"pad_pow2 requested but SKIPPED: the padded field would exceed "
            f"the VMEM budget ({_VMEM_BLOCK_BUDGET_BYTES}); the program runs "
            "unpadded — do not label this measurement 'pad'",
            stacklevel=3,
        )
    block = choice.padded_shape if choice.pad_applied else orig_shape
    form = multi_step_form(block, T.dtype, choice.chunk, inv_d2, choice.body_form)

    def prepare(T, Cp):
        Cm = edge_masked_cm(T, Cp, lam, dt)
        if widths:  # pad cells are frozen: Cm pads to 0
            return torch.nn.functional.pad(T, widths), torch.nn.functional.pad(Cm, widths)
        return T, Cm

    def sweep(T, Cm, out=None):
        return multi_step(T, Cm, inv_d2, choice.chunk, form, out=out)

    def finish(T):
        if tuple(T.shape) != orig_shape:
            return T[tuple(slice(0, d) for d in orig_shape)].contiguous()
        return T

    return SweepPlan(choice.chunk, sweep, prepare, finish)


def fused_multi_step(T, Cp, lam, dt, spacing, n_steps: int, chunk=None,
                     warn_on_cap=True, body_form=None, pad_pow2=None, config=None):
    """Advance a single-shard field `n_steps`, `chunk` steps per launch of
    the multi_step_cm kernel, with the Dirichlet edge held by an
    edge-masked coefficient computed once per call.

    Replaces pallas_kernels.fused_multi_step (file:714). The chunk,
    body form and pad follow plan_vmem_loop (vmem_sweeps); the outer loop
    is a Python loop over launches, and a chunk that does not divide
    `n_steps` raises. Returns a new tensor; `T` is not written.
    """
    plan = vmem_sweeps(T, lam, dt, spacing, n_steps, chunk=chunk, warn_on_cap=warn_on_cap,
                       body_form=body_form, pad_pow2=pad_pow2, config=config)
    T, Cm = plan.prepare(T, Cp)
    return plan.finish(_repeat(lambda x, o: plan.sweep(x, Cm, out=o), T,
                               int(n_steps) // plan.k))


def multi_step_cm(T, Cm, spacing, n_steps: int, out=None):
    """`n_steps` steps on a block with a caller-supplied masked coefficient
    `Cm` (dt·λ/Cp where the cell updates, exactly 0.0 where it is held), in
    one launch of the multi_step_cm kernel.

    Replaces pallas_kernels.multi_step_cm (file:815): the deep-halo
    sweep's local compute on blocks within the VMEM budget. The body form
    is _multi_step_kernel's choice for this chunk and block.
    """
    if tuple(T.shape) != tuple(Cm.shape):
        raise ValueError(f"shape mismatch: T {tuple(T.shape)} vs Cm {tuple(Cm.shape)}")
    _check_vmem(T, "padded block",
                "for HBM-resident blocks use multi_step_cm_hbm (the deep-halo "
                "sweep routes there automatically) or the per-step variants")
    inv_d2 = inv_d2_of(spacing)
    n = int(n_steps)
    if n == 0:
        return T.clone()
    return multi_step(T, Cm, inv_d2, n, multi_step_form(T.shape, T.dtype, n, inv_d2),
                       out=out)


def _check_tb(T, k: int) -> tuple[int, int]:
    """JAX's shape checks of a k-step sweep; returns (g, tm)."""
    g, tm = tb_geometry(k)
    if not tb_slab_fits(k, T.shape, T.dtype):
        raise ValueError(
            f"a k={k} sweep's (tm+2g)={tm + 2 * g}-row slab exceeds the "
            f"compile envelope ({_PS_SLAB_BUDGET_BYTES} B at f32 compute "
            f"width) for rows this wide; use k <= {_TB_G} or a narrower "
            "block (the deep-halo router falls back to the plain path)"
        )
    n0 = T.shape[0]
    if n0 % tm != 0 or (n0 // tm) < 2:
        raise ValueError(f"axis-0 length {n0} must be a multiple of {tm} (>= 2 stripes)")
    return g, tm


def hbm_sweeps(T, lam, dt, spacing, n_steps: int, block_steps=None) -> SweepPlan:
    """Temporal blocking of a single-shard field like `T` as a SweepPlan:
    one launch of the tb_sweep kernel advances the whole field
    `block_steps` steps. fused_multi_step_hbm's checks."""
    if T.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {T.dtype} not supported (float32, float64, bfloat16)")
    k = DEFAULT_TB_STEPS if block_steps is None else int(block_steps)
    if not 1 <= k <= _TB_MAX_STEPS:
        raise ValueError(f"block_steps must be in [1, {_TB_MAX_STEPS}], got {k}")
    _check_tb(T, k)
    if int(n_steps) % k != 0:
        raise ValueError(f"n_steps {int(n_steps)} must be a multiple of {k}")
    inv_d2 = inv_d2_of(spacing)
    lam, dt = float(lam), float(dt)

    def prepare(T, Cp):
        return T, edge_masked_cm(T, Cp, lam, dt)

    def sweep(T, Cm, out=None):
        return tb_sweep(T, Cm, inv_d2, k, out=out)

    return SweepPlan(k, sweep, prepare, lambda T: T)


def fused_multi_step_hbm(T, Cp, lam, dt, spacing, n_steps: int, block_steps=None):
    """Advance a single-shard field `n_steps` by temporal blocking: each
    launch of the tb_sweep kernel advances the whole field `block_steps`
    steps in one pass over device memory.

    Replaces pallas_kernels.fused_multi_step_hbm (file:1019). Same
    checks: 1 <= block_steps <= 16, the stripe divisibility and slab
    envelope of tb_geometry/tb_slab_fits, and `n_steps` a multiple of
    `block_steps` (hbm_sweeps). Returns a new tensor; `T` is not written.
    """
    plan = hbm_sweeps(T, lam, dt, spacing, n_steps, block_steps)
    T, Cm = plan.prepare(T, Cp)
    return _repeat(lambda x, o: plan.sweep(x, Cm, out=o), T, int(n_steps) // plan.k)


def multi_step_cm_hbm(T, Cm, spacing, n_steps: int, out=None):
    """One temporal-blocked sweep of `n_steps` (<= 16) steps on a block
    with a caller-supplied masked coefficient — the large-block form of
    multi_step_cm, one launch of the tb_sweep kernel.

    Replaces pallas_kernels.multi_step_cm_hbm (file:1095): the deep-halo
    sweep's local compute on blocks beyond the VMEM budget.
    """
    if tuple(T.shape) != tuple(Cm.shape):
        raise ValueError(f"shape mismatch: T {tuple(T.shape)} vs Cm {tuple(Cm.shape)}")
    n = int(n_steps)
    if not 1 <= n <= _TB_MAX_STEPS:
        raise ValueError(
            f"n_steps must be in [1, {_TB_MAX_STEPS}] per HBM sweep, got {n} "
            "(the stripe ghosts bound the in-sweep light cone)"
        )
    _check_tb(T, n)
    return tb_sweep(T, Cm, inv_d2_of(spacing), n, out=out)
