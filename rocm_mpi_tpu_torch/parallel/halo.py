"""Halo exchange — counterpart of rocm_mpi_tpu/parallel/halo.py
(`update_halo!` of the reference), over torch.distributed point-to-point.

Contracts kept from the JAX package:

* Shards do not overlap; ghosts live in ONE padded buffer per exchange.
  `place_core` writes the shard into it (the one whole-shard copy),
  `exchange_into` writes each received ghost slab in place.
* Axes are exchanged in sequence, and axis k's slabs span the ghosts of
  the axes exchanged before it (and only the core of those after), so
  corner ghosts arrive from diagonal neighbours in two stages without any
  diagonal message — the same slab shapes as `exchange_nbytes` counts.
* Non-periodic domain: a rank at the domain edge posts nothing toward the
  missing neighbour, and that ghost layer stays zero. Those zeros only
  ever feed cells the Cm coefficient holds fixed.

Each axis posts its sends and receives together (dist.batch_isend_irecv)
and waits for them before the next axis, whose slabs include the ghosts
just received. Slabs are made contiguous before sending. A gloo process
group carries CPU tensors only, so for CUDA buffers on gloo every slab is
staged through host memory; NCCL sends device to device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from rocm_mpi_tpu_torch.config import validate_wire_mode
from rocm_mpi_tpu_torch.parallel import distributed
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid


def slab_shapes(local_shape, width: int = 1, axes=None) -> list[tuple[int, ...]]:
    """Per-shard send slab shapes in exchange order (axis-major, lo then
    hi): padded extent on axes exchanged earlier, core extent after."""
    local_shape = tuple(int(n) for n in local_shape)
    ndim = len(local_shape)
    axes = tuple(range(ndim) if axes is None else axes)
    shapes: list[tuple[int, ...]] = []
    done: list[int] = []
    for ax in axes:
        shape = tuple(
            width if a == ax
            else local_shape[a] + 2 * width if a in done
            else local_shape[a]
            for a in range(ndim)
        )
        shapes.extend((shape, shape))
        done.append(ax)
    return shapes


def exchange_nbytes(local_shape, itemsize: int, width: int = 1, axes=None,
                    wire_mode: str = "f32") -> int:
    """Bytes an interior rank SENDS per `exchange_halo` call: two slabs per
    exchanged axis at the state's itemsize (edge ranks send less)."""
    validate_wire_mode(wire_mode)
    return sum(
        math.prod(s) * int(itemsize) for s in slab_shapes(local_shape, width, axes)
    )


def place_core(u: torch.Tensor, width: int = 1, axes=None, out=None) -> torch.Tensor:
    """Write `u` into the core of a ghost-ringed buffer (grown by 2·width
    along each of `axes`) and return the buffer. `out`, when given, is a
    buffer of that shape reused across steps: only its core is written,
    so ghost layers no neighbour fills keep the zeros they were made with.
    """
    axes = set(range(u.ndim) if axes is None else axes)
    shape = tuple(n + 2 * width if a in axes else n for a, n in enumerate(u.shape))
    if out is None:
        out = torch.zeros(shape, dtype=u.dtype, device=u.device)
    elif tuple(out.shape) != shape or out.dtype != u.dtype:
        raise ValueError(f"padded buffer must be {shape} {u.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    core = tuple(
        slice(width, width + n) if a in axes else slice(None)
        for a, n in enumerate(u.shape)
    )
    out[core] = u
    return out


def _staged(t: torch.Tensor) -> bool:
    """True when the process group cannot carry `t` where it lies (gloo
    and a CUDA tensor): the slab then goes through host memory."""
    return t.is_cuda and distributed.backend() == "gloo"


def exchange_into(buf: torch.Tensor, grid: GlobalGrid, width: int = 1,
                  axes=None, wire_mode: str = "f32") -> torch.Tensor:
    """Fill the ghost layers of a `place_core`-shaped buffer from the
    neighbouring ranks, in place; returns `buf`."""
    validate_wire_mode(wire_mode)
    axes = tuple(range(grid.ndim) if axes is None else axes)
    exchanged = set(axes)
    ndim = buf.ndim
    width = int(width)

    def core_extent(a):
        return buf.shape[a] - (2 * width if a in exchanged else 0)

    done: list[int] = []
    for ax in axes:
        n = core_extent(ax)

        def region(lo_idx):
            # Axis `ax` at [lo_idx, lo_idx + width); padded extent on axes
            # already exchanged, core extent on the rest of `axes`.
            return tuple(
                slice(lo_idx, lo_idx + width) if a == ax
                else slice(None) if a in done or a not in exchanged
                else slice(width, width + core_extent(a))
                for a in range(ndim)
            )

        ops, landings = [], []
        for direction, send_at, recv_at in ((+1, n, n + width), (-1, width, 0)):
            peer = grid.neighbor(ax, direction)
            if peer is None:
                continue  # domain edge: nothing posted, the ghost stays zero
            send = buf[region(send_at)].contiguous()
            recv = torch.empty_like(send)
            if _staged(buf):
                send, recv = send.cpu(), recv.cpu()
            ops.append(dist.P2POp(dist.isend, send, peer))
            ops.append(dist.P2POp(dist.irecv, recv, peer))
            landings.append((region(recv_at), recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for dst, recv in landings:
                buf[dst] = recv
        done.append(ax)
    return buf


def exchange_halo(u: torch.Tensor, grid: GlobalGrid, width: int = 1, axes=None,
                  wire_mode: str = "f32", out=None) -> torch.Tensor:
    """Pad the local shard `u` with its neighbours' ghost cells: the
    `update_halo!` analog, one call per step, all axes. `out` reuses a
    padded buffer (see `place_core`)."""
    return exchange_into(place_core(u, width, axes, out=out), grid, width, axes,
                         wire_mode=wire_mode)


def global_boundary_mask(grid: GlobalGrid, dtype=torch.bool, device=None) -> torch.Tensor:
    """This rank's mask of global-domain boundary cells — the cells the
    reference never updates."""
    local = grid.local_shape
    mask = torch.zeros(local, dtype=torch.bool, device=device)
    for ax, (start, _) in enumerate(grid.shard_bounds()):
        gidx = start + torch.arange(local[ax], device=device)
        edge = (gidx == 0) | (gidx == grid.global_shape[ax] - 1)
        view = [1] * grid.ndim
        view[ax] = local[ax]
        mask = mask | edge.reshape(view)
    return mask if dtype == torch.bool else mask.to(dtype)
