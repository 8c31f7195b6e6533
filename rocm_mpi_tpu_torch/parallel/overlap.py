"""Communication/computation overlap — the `hide` variant; counterpart of
rocm_mpi_tpu/parallel/overlap.py.

The reference (`diffusion_2D_perf_hide.jl`, its intended variant (3))
computes a boundary frame of width `b_width` on a high-priority queue
and the interior on a low-priority one, with `update_halo!` issued in
between so the exchange hides behind the interior. The JAX package gets
the overlap from dataflow: the interior reads the unpadded block, so XLA
may run it beside the collective. On the card the port makes the
schedule explicit, per step, on CUDA streams of two priorities:

  1. an event on the current stream marks the state ready;
  2. the interior stream (normal priority) waits for it and launches the
     ghost-free interior box from the RAW shard: its width-1 stencil never
     leaves the shard, so it reads no ghost;
  3. the current stream runs the halo exchange (NCCL point-to-point): by
     default into the padded buffer (`exchange_halo`: `place_core`, then
     a batch per axis); with `faces=True` the face exchange
     (`exchange_faces`: the 2·ndim faces in one batch, no padded block,
     no copy of the shard), as the diffusion step asks;
  4. the boundary stream (high priority, `torch.cuda.Stream(priority=-1)`)
     waits for the exchange and launches the slab boxes, from the padded
     buffer (offset 1) or from the shard and the received faces;
  5. the current stream waits for both. The next step's exchange, on the
     current stream, so never overwrites a face or a padded buffer that
     the boundary stream still reads.

Every box writes its own cells of one output buffer in place (the region
form of ops/kernels.py), so there is no splice copy and, with the
masked-coefficient contracts, no trailing Dirichlet select.

The step synchronises no host: the fork and the join are stream waits,
which a CUDA graph capture records as edges between its nodes, so the
scan driver captures the whole step, exchange included
(models/scan.py). The two side streams are made when the step is built
for a CUDA device, never inside a capture. Tensors the
side streams touch are allocated on the current stream before step 1 and
only reused by it after step 5, so the caching allocator never hands
their memory to another user while a side stream still reads it. On the
CPU the same code runs the boxes one after another through the plain
versions.

The shard is decomposed axis by axis: axis 0 gives its first and last
`b` rows (full extent elsewhere), axis 1 the first and last `b` columns of
the remaining middle, and so on; the innermost box is the interior. Only
`mask_boundary=False` is ported — every caller in the repository holds
its boundary by data (Cm == 0, M == 0).

`wire_mode` reaches every leaf's exchange. The step is stateless, so a
stateful mode (int8, int8_delta) is refused by the exchange when the step
runs, as in the JAX package, where a model whose config names a
deep-only mode still builds its per-step variants.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from rocm_mpi_tpu_torch.parallel import wire
from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.parallel.halo import (
    exchange_faces,
    exchange_faces_batched,
    exchange_halo,
)
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

# Stream priorities: lower is more urgent. The boundary slabs gate the
# next step's exchange, so they go first when both streams have work.
INTERIOR_PRIORITY = 0
BOUNDARY_PRIORITY = -1


def effective_b_width(local_shape, b_width) -> tuple[int, ...]:
    """Clamp the boundary-frame width per axis to at most half the shard
    (the reference's b_width=(32,4) knob, hide.jl:42). A short b_width is
    extended by repeating its last entry, so the 2D default applies to 3D."""
    b_width = tuple(b_width)
    if len(b_width) < len(local_shape):
        b_width = b_width + (b_width[-1],) * (len(local_shape) - len(b_width))
    for ln in local_shape:
        if ln < 2:
            raise ValueError(
                f"hide variant needs every shard axis >= 2 cells (local shape "
                f"{tuple(local_shape)}); use variant 'shard' for degenerate decompositions"
            )
    return tuple(max(1, min(int(b), ln // 2)) for b, ln in zip(b_width, local_shape))


def region_boxes(local_shape, bw) -> list[tuple[tuple[int, int], ...]]:
    """The boxes of the decomposition, in _make_region_splice's order: per
    axis the lo slab, the boxes of the middle, the hi slab. Each box is a
    tuple of (lo, hi) core ranges; together they cover the shard once."""
    local = tuple(int(n) for n in local_shape)
    ndim = len(local)

    def boxes(axis, prefix):
        if axis == ndim:
            return [tuple(prefix)]
        n, b = local[axis], bw[axis]
        rest = [(0, local[a]) for a in range(axis + 1, ndim)]
        out = [tuple(prefix + [(0, b)] + rest), tuple(prefix + [(n - b, n)] + rest)]
        if n - 2 * b > 0:
            out[1:1] = boxes(axis + 1, prefix + [(b, n - b)])
        return out

    return boxes(0, [])


def ghost_free(box, local_shape) -> bool:
    """True when the box's width-1 stencil never leaves the unpadded shard."""
    return all(lo >= 1 and hi <= n - 1 for (lo, hi), n in zip(box, local_shape))


def _leaves(x) -> tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def make_overlap_step(grid: GlobalGrid, region_update: Callable, b_width,
                      mask_boundary: bool = False, wire_mode: str = "f32", device=None,
                      faces: bool = False):
    """Build the shard-local overlap step (any ndim).

    `region_update(src, offset, box, C, out)` updates core box `box` of
    `out` in place from `src`, the state grown by `offset` cells per axis
    (a region-form kernel wrapper, e.g. kernels.fused_step_cm_region).
    With `faces=True` the step exchanges faces instead (halo.exchange_faces)
    and calls `region_update(T, faces, box, C, out)`: `faces` the received
    faces for a slab box, None for the interior box (a face-form wrapper,
    e.g. kernels.fused_step_cm_faces). Returns
    `local_step(T, C, out=None, pad=None) -> out`; `pad` is unused with
    faces.

    `T`, the exchanged state, is a tensor or a tuple of same-shaped leaves
    (each exchanged; `src` and `out` then have the same structure, for a
    coupled update such as the shallow-water one). `C` is whatever the
    update reads core-only (a coefficient, or a tuple such as the wave's
    (U⁻, M, Cw)); it is never exchanged. `out` and `pad` (same structure
    as `T`) are buffers the caller reuses across steps; absent, they are
    allocated. `device`, when a CUDA device, makes its side streams now.
    """
    wire.validate_mode(wire_mode)
    if mask_boundary:
        raise NotImplementedError(
            "mask_boundary=True (a Dirichlet hold after the region updates) is not "
            "ported; every caller holds its boundary by data (mask_boundary=False)"
        )
    local = grid.local_shape
    bw = effective_b_width(local, b_width)
    boxes = region_boxes(local, bw)
    interior = [b for b in boxes if ghost_free(b, local)]
    slabs = [b for b in boxes if not ghost_free(b, local)]
    streams: dict[torch.device, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}

    def side_streams(device):
        """(interior, boundary) streams of `device`, made at first use."""
        if device not in streams:
            streams[device] = (torch.cuda.Stream(device, priority=INTERIOR_PRIORITY),
                               torch.cuda.Stream(device, priority=BOUNDARY_PRIORITY))
        return streams[device]

    if device is not None and torch.device(device).type == "cuda":
        side_streams(torch.device(device))

    def local_step(T, C, out=None, pad=None):
        tupled = isinstance(T, (tuple, list))
        if telemetry.enabled():
            # The JAX package's overlap.step annotation: this step's slab
            # geometry (the per-leaf halo.exchange annotations come from
            # the exchanges below).
            n_leaves = len(T) if tupled else 1
            telemetry.annotate_once(("overlap.step", bw, n_leaves, wire_mode), "overlap.step",
                                    lambda: dict(b_width=tuple(int(b) for b in bw),
                                                 leaves=n_leaves, wire=wire_mode))

        def run(boxes_, src, ghosts):
            # ghosts: the padded route's source offset, or the faces (None: none)
            for box in boxes_:
                region_update(src if tupled else src[0], ghosts, box, C,
                              outs if tupled else outs[0])

        Ts = _leaves(T)
        outs = _leaves(out) if out is not None else tuple(torch.empty_like(t) for t in Ts)
        pads = _leaves(pad) if pad is not None else (None,) * len(Ts)
        if Ts[0].is_cuda:
            current = torch.cuda.current_stream(Ts[0].device)
            inner_s, bound_s = side_streams(Ts[0].device)
            inner_ctx, bound_ctx = torch.cuda.stream(inner_s), torch.cuda.stream(bound_s)
            inner_s.wait_stream(current)  # (1) the state and `out` are ready
        else:
            current = None
            inner_ctx = bound_ctx = contextlib.nullcontext()
        with inner_ctx:  # (2) the interior, from the raw shard
            run(interior, Ts, None if faces else 0)
        # (3) the exchange, on the current stream
        if faces:
            src, ghosts = Ts, tuple(exchange_faces(t, grid, wire_mode=wire_mode) for t in Ts)
            ghosts = ghosts if tupled else ghosts[0]
        else:
            src, ghosts = tuple(exchange_halo(t, grid, wire_mode=wire_mode, out=p)
                                for t, p in zip(Ts, pads)), 1
        if current is not None:
            bound_s.wait_stream(current)
        with bound_ctx:  # (4) the slabs, from the padded buffer or the faces
            run(slabs, src, ghosts)
        if current is not None:  # (5) join
            current.wait_stream(inner_s)
            current.wait_stream(bound_s)
        return outs if tupled else outs[0]

    local_step.b_width = bw
    local_step.boxes = boxes
    return local_step


def make_batched_overlap_step(bgrid, region_update: Callable, b_width,
                              wire_mode: str = "f32", device=None):
    """The lane-batched overlap step — the JAX package's
    make_batched_overlap_step, on the face route: `make_overlap_step`'s
    schedule over a rank's whole lane block.

    `bgrid` is a BatchedGrid (or the space GlobalGrid of its row).
    Returns `batched_step(Tb, C, out, lanes=None) -> out`: `Tb` and `out`
    are `(lanes, *space shard)`, `C` the lane-shared coefficient. The
    interior stream launches every lane's ghost-free interior box from
    the raw lane; the current stream runs ONE face exchange of the whole
    lane block (halo.exchange_faces_batched, each message spanning the
    lane axis); the boundary stream then launches every lane's slab boxes
    from the lane and its faces. `region_update(T, faces, box, C, out)`
    is called per lane and box, exactly as the single-lane step calls it,
    so each lane's cells get the arithmetic of its standalone step. A
    lane not in `lanes` (a frozen lane, an iterable of lane indices) is
    not updated: its cells are copied into `out`. Only the stateless wire
    modes are served (the exchange refuses the others)."""
    wire.validate_mode(wire_mode)
    space = bgrid.space if hasattr(bgrid, "space") else bgrid
    local = space.local_shape
    bw = effective_b_width(local, b_width)
    boxes = region_boxes(local, bw)
    interior = [b for b in boxes if ghost_free(b, local)]
    slabs = [b for b in boxes if not ghost_free(b, local)]
    streams: dict = {}

    def side_streams(device):
        if device not in streams:
            streams[device] = (torch.cuda.Stream(device, priority=INTERIOR_PRIORITY),
                               torch.cuda.Stream(device, priority=BOUNDARY_PRIORITY))
        return streams[device]

    if device is not None and torch.device(device).type == "cuda":
        side_streams(torch.device(device))

    def batched_step(Tb, C, out, lanes=None):
        n = Tb.shape[0]
        active = range(n) if lanes is None else sorted(lanes)
        frozen = [j for j in range(n) if j not in set(active)]
        if telemetry.enabled():
            telemetry.annotate_once(("overlap.step.batched", bw, n, wire_mode),
                                    "overlap.step.batched",
                                    lambda: dict(b_width=tuple(int(b) for b in bw), lanes=n,
                                                 leaves=1, wire=wire_mode))
        if Tb.is_cuda:
            current = torch.cuda.current_stream(Tb.device)
            inner_s, bound_s = side_streams(Tb.device)
            inner_ctx, bound_ctx = torch.cuda.stream(inner_s), torch.cuda.stream(bound_s)
            inner_s.wait_stream(current)
        else:
            current = None
            inner_ctx = bound_ctx = contextlib.nullcontext()
        with inner_ctx:
            for j in active:
                for box in interior:
                    region_update(Tb[j], None, box, C, out[j])
        faces = exchange_faces_batched(Tb, space, wire_mode=wire_mode)
        for j in frozen:
            out[j].copy_(Tb[j])
        if current is not None:
            bound_s.wait_stream(current)
        with bound_ctx:
            for j in active:
                lane_faces = tuple(None if f is None else f[j] for f in faces)
                for box in slabs:
                    region_update(Tb[j], lane_faces, box, C, out[j])
        if current is not None:
            current.wait_stream(inner_s)
            current.wait_stream(bound_s)
        return out

    batched_step.b_width = bw
    batched_step.boxes = boxes
    return batched_step
