"""The route and band plan of the multi-step kernels' cluster route
(csrc/resident.cuh; the multi_step_cm, wave_multi_step and swe_multi_step
kernels).

A multi-step launch keeps its block on chip for every step, as the TPU
kernels keep theirs in VMEM: one thread-block cluster of C CTAs holds the
block in distributed shared memory, CTA r a band of rows along axis 0, and
the CTAs trade their edge rows between steps through their mbarriers. This
module decides, before the
launch, whether a block fits one cluster ("cluster" route) or takes the
cooperative kernel that keeps the state in L2 ("cooperative" route), with
how many CTAs, and where the read-only operands (diffusion's Cm, the
wave's M and Cw, the SWE's face masks) are read: staged into shared memory
too, or for diffusion kept in registers. The route is a
function of the shape, the dtype and what the card grants (`Caps`, asked of
the built kernel once per device: on an H100, clusters of 16 CTAs and
232,448 bytes of shared memory a CTA); it is never a retry after a
failure. The cooperative route's state lives in a buffer kept per block
shape (`scratch`), so no launch of either route allocates after the
first, and a launch captured into a CUDA graph replays unchanged.

The plan: C = min(granted, n0) CTAs; bands of ceil(n0 / C) or floor(n0 / C)
rows (the larger first); each CTA lays out its shared memory for the
largest band, in the compute type (f32 for bf16):

* diffusion: two buffers of T with a halo row each side (the neighbour
  bands' edge rows), `2·(rows + 2)·plane` cells;
* wave: two buffers of U with a halo row each side, the same;
* SWE: two buffers of h (one row more: the next band's first row, whose
  h' the CTA computes itself) and ndim velocities with a halo row each
  side, `2·((rows + 1) + ndim·(rows + 2))·plane` cells;

ahead of them the CTA's two mbarriers (16 bytes), and, when they fit behind
them, the read-only operands in the storage type (diffusion: Cm; wave: M
and Cw; SWE: ndim masks). Diffusion's Cm needs no shared memory where the
band cuts into one run of at most `reg_cells()` rows a warp (`reg_rows`):
each lane keeps its run's coefficients in registers for the whole launch.
The launcher recomputes the bytes and the run, and refuses a plan beyond
the card's limit or its registers.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from rocm_mpi_tpu_torch.ops import _build

KINDS = ("diffusion", "wave", "swe")
BARRIER_BYTES = 16  # the CTA's two mbarriers, ahead of the buffers (resident.cuh)


class Caps(NamedTuple):
    """What a device grants one kernel instantiation: the largest cluster
    size (16, 8, or 0 for none) and the dynamic shared memory a CTA."""

    cluster: int
    smem_limit: int


class ResidentPlan(NamedTuple):
    """`route` "cluster" or "cooperative"; on the cluster route, `cluster`
    CTAs of `rows` rows at most, `nbytes` of shared memory a CTA, whether
    the read-only operands are staged, and (diffusion) whether Cm is kept
    in registers instead. The cooperative route has cluster 0, rows 0,
    nbytes 0."""

    route: str
    cluster: int
    rows: int
    nbytes: int
    stage: bool
    registers: bool = False


COOPERATIVE = ResidentPlan("cooperative", 0, 0, 0, False)


@functools.lru_cache(maxsize=None)
def _constant(source: str, name: str) -> int:
    """`constexpr int name = N;` of a kernel source, read from it, so that
    the plan and the kernel cannot disagree."""
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def reg_cells() -> int:
    """The longest run a warp (cells a lane) whose coefficients the
    diffusion kernel keeps in registers (multistep.cu kRegCells)."""
    return _constant("multistep.cu", "kRegCells")


def reg_rows(shape, rows: int) -> int | None:
    """The diffusion kernel's register layout of a band of `rows` rows of
    `shape` (multistep.cu reg_seg_rows): one run of rows a warp, each
    warp-column (32 cells of the last axis at one axis-1 index) cut into
    warps / columns segments. The rows of a segment, the cells a lane
    keeps; None when the band has more warp-columns than a CTA has warps
    (kResidentThreads / 32)."""
    warps = _constant("resident.cuh", "kResidentThreads") // 32
    cols = 1
    for n in shape[1:-1]:
        cols *= int(n)
    cols *= -(-int(shape[-1]) // 32)
    if cols > warps:
        return None
    return -(-int(rows) // (warps // cols))


def bands(n0: int, cluster: int) -> list[tuple[int, int]]:
    """The rows [start, end) of each CTA's band (resident.cuh band_of)."""
    n0, cluster = int(n0), int(cluster)
    if not 1 <= cluster <= n0:
        raise ValueError(f"a cluster of {cluster} CTAs cannot split {n0} rows")
    base, rem = divmod(n0, cluster)
    out = []
    for rank in range(cluster):
        start = rank * base + min(rank, rem)
        out.append((start, start + base + (1 if rank < rem else 0)))
    return out


def _itemsizes(dtype: torch.dtype) -> tuple[int, int]:
    """(compute, storage) bytes of an element."""
    storage = torch.empty((), dtype=dtype).element_size()
    return (8 if dtype == torch.float64 else 4), storage


def smem_bytes(kind: str, shape, dtype: torch.dtype, rows: int, stage: bool) -> int:
    """Shared memory a CTA of `rows` rows (multistep.cu / wave.cu / swe.cu
    resident_bytes)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; known: {KINDS}")
    csize, ssize = _itemsizes(dtype)
    plane = 1
    for n in shape[1:]:
        plane *= int(n)
    band = rows * plane
    if kind in ("diffusion", "wave"):
        state = 2 * (band + 2 * plane) * csize
        staged = (1 if kind == "diffusion" else 2) * band * ssize
        return BARRIER_BYTES + state + (staged if stage else 0)
    ndim = len(shape)
    state = 2 * ((band + plane) + ndim * (band + 2 * plane)) * csize
    return BARRIER_BYTES + state + (ndim * band * ssize if stage else 0)


def plan(kind: str, shape, dtype: torch.dtype, caps: Caps) -> ResidentPlan:
    """The route of a `kind` block of `shape` and `dtype` on a card that
    grants `caps`."""
    n0 = int(shape[0])
    if caps.cluster < 1 or n0 < 1:
        return COOPERATIVE
    cluster = min(caps.cluster, n0)
    rows = -(-n0 // cluster)
    nbytes = smem_bytes(kind, shape, dtype, rows, False)
    if nbytes > caps.smem_limit:
        return COOPERATIVE
    if kind == "diffusion":
        run = reg_rows(shape, rows)
        if run is not None and run <= reg_cells():
            return ResidentPlan("cluster", cluster, rows, nbytes, False, True)
    staged = smem_bytes(kind, shape, dtype, rows, True)
    if staged <= caps.smem_limit:
        return ResidentPlan("cluster", cluster, rows, staged, True)
    return ResidentPlan("cluster", cluster, rows, nbytes, False)


# The cooperative route's state buffers, one per (device, planes, shape,
# compute dtype), made at a block's first launch and kept: a launch
# captured into a CUDA graph finds at every replay the buffer it was
# captured with, and no launch allocates after the first. Launches on one
# stream run one after another, so they share it.
_SCRATCH: dict[tuple, torch.Tensor] = {}


def scratch(planes: int, shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The cooperative route's `planes` × `shape` state buffer on `device`."""
    key = (device, int(planes), tuple(int(n) for n in shape), dtype)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.empty((int(planes),) + key[2], dtype=dtype, device=device)
    return buf


def query_caps(fn, index: int, *args) -> Caps:
    """Caps of CUDA device `index` from the built library's caps entry `fn`
    (rmt_multi_step_cm_caps, rmt_wave_multi_step_caps,
    rmt_swe_multi_step_caps), called with
    `args` in the device's context."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        rc = fn(*args, index, out)
    if rc != 0:
        raise RuntimeError(f"the cluster route's capacity query failed with code {rc}")
    return Caps(int(out[0]), int(out[1]))


def edge_shape(kind: str, n0: int, dtype: torch.dtype, caps: Caps) -> tuple[int, int]:
    """The widest 2D block (n0, n1) of `kind` that still takes the cluster
    route under `caps`: (n0, n1 + 1) takes the cooperative one."""
    if plan(kind, (n0, 1), dtype, caps).route != "cluster":
        raise ValueError(f"no {kind} block of {n0} rows takes the cluster route")
    lo, hi = 1, 1
    while plan(kind, (n0, hi), dtype, caps).route == "cluster":
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # the route is "cluster" at lo, "cooperative" at hi
        mid = (lo + hi) // 2
        if plan(kind, (n0, mid), dtype, caps).route == "cluster":
            lo = mid
        else:
            hi = mid
    return (n0, lo)
