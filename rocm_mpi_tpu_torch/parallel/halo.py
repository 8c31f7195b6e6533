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
* On-wire precision (`wire_mode`, parallel/wire.py): "f32" sends the
  slab as it is; the other modes encode each slab before it is sent and
  decode it, in the buffer's dtype, before it lands.

Each axis posts its sends and receives together (dist.batch_isend_irecv)
and waits for them before the next axis, whose slabs include the ghosts
just received. On NCCL the wait is a stream wait: the exchange never
synchronises the host, so a CUDA graph can capture it (models/scan.py).
NCCL sends device to device. A gloo process group carries CPU tensors
only, so for CUDA buffers on gloo every slab is staged through host
memory (an eager route: a capture cannot hold a host wait).

The stateless wire modes ("f32", "bf16") pack each slab with `copy_`
into a send buffer of the wire dtype, receive into a buffer of the same
shape and land it with `copy_` into the ghost view. Those buffers are
made at a geometry's first exchange and kept on the grid
(`GlobalGrid.exchange_buffers`, keyed by padded shape, dtype, width,
axes, wire mode and device), so every later exchange allocates nothing
and a captured exchange always finds the buffers it was captured with.
The stateful modes (int8, int8_delta) run only on the deep schedules;
their codecs write each slab's codes and scale into buffers kept the
same way, so their exchange captures too (models/scan.sweep_loop).

`exchange_faces` serves the sharded diffusion `perf` and `hide` steps,
whose 5- and 7-point stencils read no corner: it sends the 2·ndim faces
of the shard in one batch and returns the receive buffers, which the
face form of `fused_step_cm` reads in place, so those steps build no
padded buffer and copy no shard.

`HaloProgram` (`build_for_mesh`, `rebuild_for_mesh`) binds the exchanges
to one decomposition, as in the JAX package: an elastic resume on another
process grid rebuilds it, and the new grid's exchanges make buffers of
the new geometry.

`HostStagedStepper` is the host-staged oracle (the reference's
IGG_ROCMAWARE_MPI=0 path): a numpy diffusion stepper over every shard of
the global field, its halos copied between shards in host memory.

Telemetry, as in the JAX package: with collection on, each exchange
geometry records one `halo.exchange` annotation (its on-wire bytes,
width, block and wire mode; the face exchange adds `exchange="faces"`).
The annotation's host code runs at every eager exchange, deduplicated by
a set lookup on the exchange's buffer key (`telemetry.annotate_once`),
and once per CUDA-graph capture, never at a replay.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.parallel import distributed, wire
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid


def exchange_nbytes(local_shape, itemsize: int, width: int = 1, axes=None,
                    wire_mode: str = "f32") -> int:
    """Bytes an interior rank SENDS per `exchange_halo` call: two slabs per
    exchanged axis at `wire_mode`'s on-wire itemsize (bf16 2 bytes, the
    int8 modes 1 byte plus a scale per slab, "f32" the state's itemsize).
    Edge ranks send less."""
    return wire.exchange_wire_nbytes(local_shape, int(itemsize), width, axes, wire_mode)


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


def _refuse_stateful(wire_mode: str):
    """Raise for a stateful wire mode on a per-step exchange."""
    raise ValueError(
        f"wire_mode {wire_mode!r} carries error-feedback state across exchanges; "
        "per-step (stateless) paths support f32/bf16 only — use the deep-halo "
        "schedules (run_deep / --deep), which thread the state through their sweeps"
    )


def exchange_into(buf: torch.Tensor, grid: GlobalGrid, width: int = 1,
                  axes=None, wire_mode: str = "f32", wire_state=None):
    """Fill the ghost layers of a `place_core`-shaped buffer from the
    neighbouring ranks, in place; returns `buf`.

    `wire_mode` is the on-wire slab precision (parallel/wire.py). "f32"
    sends the slabs as they are. "bf16" rounds each slab to bfloat16 for
    the wire and widens it to the buffer dtype as it lands; a ghost no
    neighbour sends is zeroed, as it decodes from a zero payload below.
    The stateful modes ("int8", "int8_delta") also take `wire_state`,
    this rank's flat state tuple (`wire.init_exchange_state`), send each
    slab as int8 codes and a one-element scale, and return
    `(buf, new_state)`.

    Slab state follows the JAX package's order: per axis a "lo" group (the
    slab this rank sends up, the ghost it receives from below) and a "hi"
    group (sent down, received from above). Every group runs its codec's
    send, a rank at the domain edge included, and a ghost no neighbour
    sends decodes from a zero payload, as an omitted `ppermute` delivers
    zeros in the JAX package; so each rank's state and ghosts equal its
    JAX shard's.
    """
    stateful = wire.is_stateful(wire_mode)
    if stateful and wire_state is None:
        _refuse_stateful(wire_mode)
    axes = tuple(range(grid.ndim) if axes is None else axes)
    width = int(width)
    if telemetry.enabled():
        _annotate_exchange(buf, width, axes, wire_mode)
    if stateful:
        return _exchange_stateful(buf, grid, width, axes, wire_mode, wire_state)
    return _exchange_slabs(buf, grid, width, axes, wire_mode)


def _exchange_slabs(buf: torch.Tensor, grid: GlobalGrid, width: int, axes, wire_mode: str,
                    lead: int = 0):
    """The stateless exchange of exchange_into: `axes` index `buf`, whose
    first `lead` axes are lane axes (exchange_halo_batched), so buffer
    axis `ax` is space axis `ax - lead`; each slab spans every lane."""
    key = (tuple(buf.shape), buf.dtype, width, axes, wire_mode, buf.device)
    slabs = grid.exchange_buffers.setdefault(key, {})
    wire_dtype = wire.payload_dtype(wire_mode, buf.dtype)
    home = torch.device("cpu") if distributed.staged(buf) else buf.device
    for ax, region, n in _axis_regions(buf, axes, width):
        ops, landings = [], []
        for direction, send_at, recv_at in ((+1, n, n + width), (-1, width, 0)):
            ghost = buf[region(recv_at)]
            peer = grid.neighbor(ax - lead, direction)
            if peer is None:
                # Domain edge: nothing posted. The f32 ghost keeps the zeros
                # `place_core` made it with; a codec's ghost decodes zeros.
                if wire_mode != "f32":
                    ghost.zero_()
                continue
            pair = slabs.get((ax, direction))
            if pair is None:
                pair = slabs[(ax, direction)] = tuple(
                    torch.empty(ghost.shape, dtype=wire_dtype, device=home) for _ in range(2))
            send, recv = pair
            send.copy_(buf[region(send_at)])
            ops.append(dist.P2POp(dist.isend, send, peer))
            ops.append(dist.P2POp(dist.irecv, recv, peer))
            landings.append((ghost, recv))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for ghost, recv in landings:
                ghost.copy_(recv)
    return buf


def _annotate_exchange(buf, width: int, axes, wire_mode: str) -> None:
    """The `halo.exchange` annotation of a padded-buffer exchange: the
    JAX package's attrs (bytes an interior rank sends at `wire_mode`'s
    on-wire width, the ghost width, the unpadded block, the wire mode)."""
    key = ("halo.exchange", tuple(buf.shape), buf.dtype, width, axes, wire_mode)

    def attrs():
        block = tuple(n - 2 * width if a in axes else n for a, n in enumerate(buf.shape))
        return dict(bytes=exchange_nbytes(block, buf.element_size(), width, axes, wire_mode),
                    width=width, block=block, wire=wire_mode)

    telemetry.annotate_once(key, "halo.exchange", attrs)


def faces_nbytes(local_shape, itemsize: int, grid: GlobalGrid, wire_mode: str = "f32") -> int:
    """Bytes this rank SENDS per `exchange_faces` call: one face of the
    shard toward each neighbour it has, at `wire_mode`'s on-wire width
    (no corners: the faces span the shard's own extent only)."""
    total = 0
    for ax, n in enumerate(local_shape):
        face = math.prod(local_shape) // n
        for direction in (-1, +1):
            if grid.neighbor(ax, direction) is not None:
                total += wire.wire_slab_nbytes(face, int(itemsize), wire_mode)
    return total


def _axis_regions(buf: torch.Tensor, axes: tuple[int, ...], width: int):
    """(axis, region, core extent) for each exchanged axis in turn:
    `region(lo)` indexes axis `axis` at [lo, lo + width), the padded
    extent of the axes exchanged before it and the core extent of the
    rest of `axes`."""
    exchanged = set(axes)
    ndim = buf.ndim

    def core_extent(a):
        return buf.shape[a] - (2 * width if a in exchanged else 0)

    done: list[int] = []
    for ax in axes:
        def region(lo_idx, ax=ax, done=tuple(done)):
            return tuple(
                slice(lo_idx, lo_idx + width) if a == ax
                else slice(None) if a in done or a not in exchanged
                else slice(width, width + core_extent(a))
                for a in range(ndim)
            )

        yield ax, region, core_extent(ax)
        done.append(ax)


def _exchange_stateful(buf, grid, width, axes, wire_mode, wire_state):
    """exchange_into for the int8 modes: each group runs its codec's send
    and the state threads through, in the JAX package's order. The codes
    and scales travel in buffers kept on the grid beside the f32 slabs
    (per group: the send and receive pair, and zeros for a ghost no
    neighbour sends), so a captured exchange allocates no message."""
    codec = wire.slab_codec(wire_mode)
    arity = wire.state_arity(wire_mode)
    staged = distributed.staged(buf)
    home = torch.device("cpu") if staged else buf.device
    key = (tuple(buf.shape), buf.dtype, width, axes, wire_mode, buf.device)
    slabs = grid.exchange_buffers.setdefault(key, {})
    new_state: list[torch.Tensor] = []
    for i_ax, (ax, region, n) in enumerate(_axis_regions(buf, axes, width)):
        ops, landings = [], []
        # (group, slab sent, toward, ghost received, from)
        for g, (send_at, to_dir, recv_at, from_dir) in enumerate(
                ((n, +1, 0, -1), (width, -1, n + width, +1))):
            first = (2 * i_ax + g) * arity
            slab = buf[region(send_at)]
            msgs = slabs.get((ax, g))
            if msgs is None:
                msgs = slabs[(ax, g)] = _int8_messages(slab.shape, buf.dtype, buf.device, home)
            send, recv, zero = msgs
            payload, st = codec.send(slab, tuple(wire_state[first:first + arity]), out=send)
            to_peer = grid.neighbor(ax, to_dir)
            from_peer = grid.neighbor(ax, from_dir)
            if to_peer is not None:
                ops.extend(dist.P2POp(dist.isend, p.cpu() if staged else p, to_peer)
                           for p in payload)
            if from_peer is None:
                got = zero
            else:
                got = recv
                ops.extend(dist.P2POp(dist.irecv, r, from_peer) for r in got)
            landings.append((region(recv_at), got, st))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, got, st in landings:
            decoded, st = codec.recv(tuple(r.to(buf.device) for r in got), st, buf.dtype)
            buf[dst] = decoded
            new_state.extend(st)
    return buf, tuple(new_state)


def _int8_messages(shape, dtype, device, home):
    """(send, receive, zeros) of one int8 group, each (codes, scale): the
    codes of the slab's shape in int8, the scale one element of the field
    dtype. The receive pair lies where the process group carries it
    (`home`: host memory for a gloo group and a CUDA field); the zeros,
    never written, decode a ghost no neighbour sends."""
    def pair(where, make):
        return (make(shape, dtype=torch.int8, device=where),
                make((1,), dtype=dtype, device=where))

    return pair(device, torch.empty), pair(home, torch.empty), pair(device, torch.zeros)


def exchange_faces(u: torch.Tensor, grid: GlobalGrid, wire_mode: str = "f32"):
    """The width-1 face exchange of the sharded diffusion `perf` and `hide`
    steps: this rank's 2·ndim ghost faces, received from its neighbours,
    with no padded block and no copy of the shard.

    Returns a tuple in the face order of kernels.fused_step_cm_faces (axis
    0 below, axis 0 above, axis 1 below, …): each face the shard's shape
    with extent 1 along its axis, None where no neighbour is (a domain
    edge, read as zeros). Each face of `u` is packed into a send buffer
    of the wire dtype (the axis-1 face of a C-ordered shard is strided: it
    is packed once, as every slab is), and every axis goes in ONE
    `batch_isend_irecv`: the 5- and 7-point stencils read no corner, so
    no axis waits for another. Each message carries its own tag (axis and
    direction), so a pair of ranks that meet on one axis never confuses
    two messages. The bf16 wire lands each payload in a face of the
    field's dtype (a face-sized copy), widened as `exchange_into` widens
    it, so the ghosts equal its (and JAX's) bit for bit. The buffers live
    in `grid.exchange_buffers` beside the slabs: a captured step finds the
    same tensors at every replay and allocates nothing. The stateful wire
    modes are refused, as on every per-step path.
    """
    if wire.is_stateful(wire_mode):
        _refuse_stateful(wire_mode)
    key = ("faces", tuple(u.shape), u.dtype, wire_mode, u.device)
    if telemetry.enabled():
        telemetry.annotate_once(("halo.exchange", key), "halo.exchange", lambda: dict(
            bytes=faces_nbytes(u.shape, u.element_size(), grid, wire_mode), width=1,
            block=tuple(u.shape), wire=wire_mode, exchange="faces"))
    return _exchange_face_set(u, grid, wire_mode, key)


def _exchange_face_set(u, grid, wire_mode, key, lead: int = 0):
    """exchange_faces' batch of messages: the faces of `u` along each of
    its axes past the first `lead` (lane axes, exchange_faces_batched),
    buffer axis `ax` being space axis `ax - lead`."""
    bufs = grid.exchange_buffers.setdefault(key, {})
    wire_dtype = wire.payload_dtype(wire_mode, u.dtype)
    home = torch.device("cpu") if distributed.staged(u) else u.device
    ops, landings, faces = [], [], []
    for ax in range(lead, u.ndim):
        n = u.shape[ax]
        # (side, toward, the face of u sent that way): below first.
        for side, direction, at in ((0, -1, 0), (1, +1, n - 1)):
            sax = ax - lead
            peer = grid.neighbor(sax, direction)
            if peer is None:
                faces.append(None)
                continue
            msgs = bufs.get((ax, side))
            if msgs is None:
                msgs = bufs[(ax, side)] = _face_messages(u, ax, wire_dtype, home)
            send, recv, face = msgs
            send.copy_(u.narrow(ax, at, 1))
            # A message's tag: its axis and the way it travels, the same at
            # both ends (what this rank sends down, its peer receives from up).
            ops.append(dist.P2POp(dist.isend, send, peer, tag=2 * sax + side))
            ops.append(dist.P2POp(dist.irecv, recv, peer, tag=2 * sax + 1 - side))
            if face is not recv:
                landings.append((face, recv))
            faces.append(face)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for face, recv in landings:
            face.copy_(recv)
    return tuple(faces)


def _face_messages(u, ax, wire_dtype, home):
    """(send, receive, face) of one face of `u` along `ax`: the send and
    receive buffers in the wire dtype where the process group carries them
    (`home`), and the face the kernel reads, the receive buffer itself
    when it already is the field's dtype on the field's device."""
    shape = tuple(1 if a == ax else n for a, n in enumerate(u.shape))
    send = torch.empty(shape, dtype=wire_dtype, device=home)
    recv = torch.empty(shape, dtype=wire_dtype, device=home)
    if wire_dtype == u.dtype and home == u.device:
        return send, recv, recv
    return send, recv, torch.empty(shape, dtype=u.dtype, device=u.device)


def exchange_halo(u: torch.Tensor, grid: GlobalGrid, width: int = 1, axes=None,
                  wire_mode: str = "f32", out=None, wire_state=None):
    """Pad the local shard `u` with its neighbours' ghost cells: the
    `update_halo!` analog, one call per step, all axes. `out` reuses a
    padded buffer (see `place_core`). The stateful wire modes take
    `wire_state` and return `(padded, new_state)` (see `exchange_into`)."""
    return exchange_into(place_core(u, width, axes, out=out), grid, width, axes,
                         wire_mode=wire_mode, wire_state=wire_state)


def _space_of(bgrid) -> GlobalGrid:
    return bgrid.space if hasattr(bgrid, "space") else bgrid


def exchange_halo_batched(ub: torch.Tensor, bgrid, width: int = 1, axes=None,
                          wire_mode: str = "f32", out=None) -> torch.Tensor:
    """The halo exchange of a rank's whole lane block — the JAX package's
    exchange_halo_batched: `ub` is `(lanes, *space shard)` (a BatchedGrid's
    local block, or any lane-leading block of `bgrid`'s space grid), and
    the result is `(lanes, *padded shard)`, every lane's ghosts from that
    lane's space neighbours. One exchange carries every lane: each slab
    message spans the lane axis, so an axis posts one send and one receive
    per neighbour however many lanes there are, and nothing crosses the
    lane axis. `axes` are space axes; `out` reuses a padded buffer
    (place_core). The stateful wire modes are refused: their error
    feedback is per logical wire, and no lane-batched state plane carries
    it. With collection on, the exchange records one
    `halo.exchange.batched` annotation per geometry: the lane count and
    the lane-aggregate bytes an interior rank sends."""
    if wire.is_stateful(wire_mode):
        raise ValueError(f"wire_mode {wire_mode!r} is stateful; batched exchanges support "
                         "the stateless modes (f32/bf16) only")
    space = _space_of(bgrid)
    axes = tuple(range(space.ndim) if axes is None else axes)
    width = int(width)
    if telemetry.enabled():
        key = ("halo.exchange.batched", tuple(ub.shape), ub.dtype, width, axes, wire_mode)
        telemetry.annotate_once(key, "halo.exchange.batched", lambda: dict(
            lanes=int(ub.shape[0]),
            bytes=int(ub.shape[0]) * exchange_nbytes(ub.shape[1:], ub.element_size(), width,
                                                     axes, wire_mode),
            width=width, block=tuple(int(n) for n in ub.shape[1:]), wire=wire_mode))
    baxes = tuple(a + 1 for a in axes)
    return _exchange_slabs(place_core(ub, width, baxes, out=out), space, width, baxes,
                           wire_mode, lead=1)


def exchange_faces_batched(ub: torch.Tensor, bgrid, wire_mode: str = "f32"):
    """exchange_faces of a rank's whole lane block `(lanes, *space shard)`:
    the 2·ndim faces, each `(lanes, *face)`, in ONE batch of messages that
    each span the lane axis (None at a domain edge). Lane j's faces are
    `face[j]`, views the face form of fused_step_cm reads in place. The
    stateful wire modes are refused; the `halo.exchange.batched`
    annotation carries the lanes and their aggregate bytes."""
    if wire.is_stateful(wire_mode):
        raise ValueError(f"wire_mode {wire_mode!r} is stateful; batched exchanges support "
                         "the stateless modes (f32/bf16) only")
    space = _space_of(bgrid)
    key = ("faces-batched", tuple(ub.shape), ub.dtype, wire_mode, ub.device)
    if telemetry.enabled():
        telemetry.annotate_once(("halo.exchange.batched", key), "halo.exchange.batched",
                                lambda: dict(
            lanes=int(ub.shape[0]),
            bytes=int(ub.shape[0]) * faces_nbytes(ub.shape[1:], ub.element_size(), space,
                                                  wire_mode),
            width=1, block=tuple(int(n) for n in ub.shape[1:]), wire=wire_mode,
            exchange="faces"))
    return _exchange_face_set(ub, space, wire_mode, key, lead=1)


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


@dataclasses.dataclass(frozen=True)
class HaloProgram:
    """The halo exchanges bound to one decomposition — the JAX package's
    HaloProgram: the grid they were derived for, the ghost width and wire
    mode, `exchange(u, axes=None)` (exchange_halo on the grid),
    `faces(u)` (exchange_faces, the sharded diffusion steps' form),
    `nbytes(itemsize, axes=None)` the bytes one exchange sends from an
    interior rank (exchange_nbytes) and `faces_nbytes(itemsize)` those of
    one face exchange of this rank. The send and receive buffers live on
    the grid (`GlobalGrid.exchange_buffers`), so a rebuilt program's
    first exchange makes buffers of the new geometry."""

    grid: GlobalGrid
    width: int
    wire_mode: str = "f32"

    def exchange(self, u: torch.Tensor, axes=None, wire_state=None):
        return exchange_halo(u, self.grid, self.width, axes, wire_mode=self.wire_mode,
                             wire_state=wire_state)

    def faces(self, u: torch.Tensor):
        return exchange_faces(u, self.grid, self.wire_mode)

    def nbytes(self, itemsize: int, axes=None) -> int:
        return exchange_nbytes(self.grid.local_shape, itemsize, self.width, axes,
                               self.wire_mode)

    def faces_nbytes(self, itemsize: int) -> int:
        return faces_nbytes(self.grid.local_shape, itemsize, self.grid, self.wire_mode)


def build_for_mesh(grid: GlobalGrid, width: int = 1, wire_mode: str = "f32") -> HaloProgram:
    """Bind the halo exchanges to `grid` — the derivation
    `rebuild_for_mesh` re-runs when the decomposition changes."""
    wire.validate_mode(wire_mode)
    return HaloProgram(grid=grid, width=int(width), wire_mode=wire_mode)


def rebuild_for_mesh(program_or_grid, dims=None, nprocs=None, width: int | None = None,
                     rank: int | None = None) -> HaloProgram:
    """Re-derive the halo exchanges for a new decomposition of the same
    global domain — the JAX package's halo.rebuild_for_mesh: neighbours,
    ghost and face shapes, wire bytes and buffers all come from the new
    dims. Takes a HaloProgram (its width and wire mode kept) or a
    GlobalGrid; `dims`, `nprocs` and `rank` as mesh.rebuild_for_mesh.
    A width wider than a shard of the new grid raises."""
    from rocm_mpi_tpu_torch.parallel import mesh

    if isinstance(program_or_grid, HaloProgram):
        old_grid = program_or_grid.grid
        width = program_or_grid.width if width is None else width
        wire_mode = program_or_grid.wire_mode
    else:
        old_grid = program_or_grid
        width = 1 if width is None else width
        wire_mode = "f32"
    new_grid = mesh.rebuild_for_mesh(old_grid, dims=dims, nprocs=nprocs,
                                     rank=old_grid.rank if rank is None else rank)
    if any(width > ln for ln in new_grid.local_shape):
        raise ValueError(f"halo width {width} exceeds a local shard extent "
                         f"{new_grid.local_shape} on the rebuilt grid {new_grid.dims}")
    return build_for_mesh(new_grid, width, wire_mode=wire_mode)


class HostStagedStepper:
    """Numpy diffusion stepper with explicitly host-staged halos — the
    JAX package's HostStagedStepper (rocm_mpi_tpu/parallel/halo.py).

    The IGG_ROCMAWARE_MPI=0 analog: every step, each shard's boundary
    slices are copied through host memory into its neighbours' ghost
    layers, then every shard is updated on its own. It needs no device and
    no process group, so a disagreement with a device run isolates the
    device's transport: an oracle, not a fast path.

    `grid` is any object with `global_shape`, `dims`, `spacing`,
    `local_shape` and `ndim` (a GlobalGrid, or wire.OracleGrid). It works
    on the whole global field. `wire_mode` applies the numpy wire codec
    (wire.NumpyWireCodec) to every ghost slab it copies, its state kept per
    logical wire across steps. `use_native` picks the C++ engine
    (parallel/native_halo.py, bitwise equal, one thread per shard): None
    takes it when it builds and the grid has at most 3 axes; True requires
    it and raises when it cannot be built. The engine stages
    full-precision ghosts only, so any other wire mode runs the numpy
    steps.

    As in the JAX package, the numpy step's two phases are real host
    seams, timed as the `halo.host_staged` span (with the bytes its
    ghosts carried on the wire) and the `interior.host_staged` span, and
    `run` advances the flight recorder's step counter every step, after
    the "step" fault point (resilience/faults.py) of that step.
    """

    def __init__(self, grid, lam: float, dt: float, use_native: bool | None = None,
                 wire_mode: str = "f32"):
        from rocm_mpi_tpu_torch.parallel import native_halo

        self.grid = grid
        self.lam = lam
        self.dt = dt
        self.wire_mode = wire.validate_mode(wire_mode)
        self._codec = wire.NumpyWireCodec(wire_mode) if wire_mode != "f32" else None
        if use_native is None:
            use_native = grid.ndim <= 3 and native_halo.available()
        elif use_native and wire_mode == "f32":
            native_halo._load()  # raises when the engine cannot be built
        self.use_native = bool(use_native) and wire_mode == "f32"

    def _shard_slices(self, coords) -> tuple[slice, ...]:
        local = self.grid.local_shape
        return tuple(slice(c * ln, (c + 1) * ln) for c, ln in zip(coords, local))

    def step(self, T: np.ndarray, Cp: np.ndarray) -> np.ndarray:
        """One host-staged step: the native engine for f64 fields when it
        was chosen, else `step_python`."""
        if self.use_native and T.dtype == np.float64 and Cp.dtype == np.float64:
            from rocm_mpi_tpu_torch.parallel import native_halo

            return native_halo.host_staged_step(T, Cp, self.grid.dims, self.grid.spacing,
                                                self.lam, self.dt)
        return self.step_python(T, Cp)

    def step_python(self, T: np.ndarray, Cp: np.ndarray) -> np.ndarray:
        # Phase 1 — the host-staged exchange: each shard's padded block is
        # assembled in host memory, its ghosts read from the neighbouring
        # shards (zero at the domain edge, as in exchange_halo).
        padded = {}
        with telemetry.span("halo.host_staged", phase="halo") as hsp:
            copied = self._exchange_host(T, padded)
            hsp.set(bytes=copied)

        # Phase 2 — every shard updated on its own, global boundary cells
        # held. The reciprocal is multiplied (not divided by), so the
        # result is bitwise the native engine's.
        with telemetry.span("interior.host_staged", phase="interior"):
            return self._update_shards(T, Cp, padded)

    def _exchange_host(self, T: np.ndarray, padded: dict) -> int:
        """Fill `padded` with each shard's ghost-ringed block; returns
        the bytes its ghosts carried at the wire mode's width."""
        grid = self.grid
        ndim = grid.ndim
        local = grid.local_shape
        inner = tuple(slice(1, -1) for _ in range(ndim))
        copied = 0
        for coords in np.ndindex(*grid.dims):
            block = np.zeros(tuple(ln + 2 for ln in local), dtype=T.dtype)
            block[inner] = T[self._shard_slices(coords)]
            for ax in range(ndim):
                for side, nb_off in (("lo", -1), ("hi", +1)):
                    nb = list(coords)
                    nb[ax] += nb_off
                    if not 0 <= nb[ax] < grid.dims[ax]:
                        continue  # domain edge: the ghost stays zero (unused)
                    nb_core = self._shard_slices(nb)
                    src = list(nb_core)
                    dst = [slice(1, 1 + ln) for ln in local]
                    if nb_off == -1:  # ghost row 0 <- the neighbour's last row
                        src[ax] = slice(nb_core[ax].stop - 1, nb_core[ax].stop)
                        dst[ax] = slice(0, 1)
                    else:  # the last ghost row <- the neighbour's first row
                        src[ax] = slice(nb_core[ax].start, nb_core[ax].start + 1)
                        dst[ax] = slice(local[ax] + 1, local[ax] + 2)
                    ghost = T[tuple(src)]
                    if self._codec is not None:
                        # One logical wire per (receiver, axis, side): its
                        # codec state persists across steps under this key.
                        ghost = self._codec.apply((coords, ax, side), ghost)
                    block[tuple(dst)] = ghost
                    copied += wire.wire_slab_nbytes(ghost.size, T.dtype.itemsize,
                                                    self.wire_mode)
            padded[coords] = block
        return copied

    def _update_shards(self, T: np.ndarray, Cp: np.ndarray, padded: dict) -> np.ndarray:
        grid = self.grid
        ndim = grid.ndim
        local = grid.local_shape
        inner = tuple(slice(1, -1) for _ in range(ndim))
        inv_d2 = tuple(1.0 / (d * d) for d in grid.spacing)
        out = np.array(T, copy=True)
        for coords, block in padded.items():
            core = self._shard_slices(coords)
            lap = np.zeros(local, dtype=T.dtype)
            for ax in range(ndim):
                hi_s = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
                lo_s = tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
                lap += (block[hi_s] - 2.0 * block[inner] + block[lo_s]) * inv_d2[ax]
            new = T[core] + self.dt * self.lam / Cp[core] * lap
            keep = np.zeros(local, dtype=bool)
            for ax in range(ndim):
                gidx = coords[ax] * local[ax] + np.arange(local[ax])
                edge = (gidx == 0) | (gidx == grid.global_shape[ax] - 1)
                sh = [1] * ndim
                sh[ax] = local[ax]
                keep |= edge.reshape(sh)
            out[core] = np.where(keep, T[core], new)
        return out

    def run(self, T: np.ndarray, Cp: np.ndarray, nt: int) -> np.ndarray:
        from rocm_mpi_tpu_torch.resilience import faults
        from rocm_mpi_tpu_torch.telemetry import flight

        for i in range(int(nt)):
            faults.fault_point("step", step=i + 1)
            # Additive: the recorder's step counter is process-global.
            flight.progress(step_inc=1)
            T = self.step(T, Cp)
        return T
