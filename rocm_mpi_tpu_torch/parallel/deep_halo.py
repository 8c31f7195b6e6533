"""Deep-halo sweeps: width-k ghost exchange every k steps — counterpart of
rocm_mpi_tpu/parallel/deep_halo.py (the diffusion and wave schedules).

Each rank receives a k-wide ghost region once, then advances its padded
block k steps locally and keeps the core: after s local steps only ghost
cells at depth >= s+1 from the core can be stale (the outermost layer
sees zeros, or a held value, and the error moves inward one cell per
step), so for s <= k the core is exact. Global Dirichlet boundary cells
and off-domain ghost cells are held by a zero coefficient.

The loop-invariant coefficient is exchanged once per advance
(`prepare`), the field once per sweep (`sweep`). The local k steps take
the JAX package's route for the padded block's shape:

* "vmem"   — within the VMEM budget: ops.multistep.multi_step_cm;
* "hbm-tb" — beyond it, where the temporal-blocked sweep's shape checks
  pass: ops.multistep.multi_step_cm_hbm;
* "jnp"    — otherwise, or with local_form="jnp": k steps of plain
  PyTorch slicing (the JAX package's XLA route, taken by shape alone).

The wave schedule (`make_wave_deep_sweep`) exchanges the time-invariant
c² once per advance and the leapfrog pair once per sweep; its local k
steps take ops.wave.wave_multi_step_masked ("vmem") when twice the padded
block fits the VMEM budget, else k plain masked_leapfrog_steps ("jnp").

The shallow-water schedule (`make_swe_deep_sweep`) builds its padded face
masks once per advance and exchanges all ndim+1 coupled fields once per
sweep; its local k steps take ops.swe.swe_multi_step_masked ("vmem") when
the padded state passes the JAX admission, (3·ndim + 2)·compute_nbytes <=
2 MiB, else k plain roll-form masked_swe_steps ("jnp").

A sweep returns the core of a padded buffer the schedule reuses, as a
view the next sweep overwrites: a driver copies it out before the next
sweep. The models' deep advances (models/scan.sweep_loop) copy it into
their loop's out slot, so on a CUDA rank a sweep, its exchange included,
is captured into a CUDA graph and replayed; nothing in a sweep syncs the
host. The "jnp" routes allocate their step temporaries inside the sweep,
and a captured sweep takes them from its graph's pool.

`wire_mode` is the state exchange's on-wire precision (parallel/wire.py);
the loop-invariant `prepare` exchange always ships full precision, as in
the JAX package. For the stateful modes (int8, int8_delta) the schedule's
`init_wire(dtype, device)` builds this rank's zero wire state, and the
sweep takes it last and returns it last: `sweep(state…, prepared,
wire_state) -> (state…, wire_state)`, the state of each exchanged field
in turn (`wire.init_exchange_state` with one field per leaf).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.ops import multistep, swe, wave
from rocm_mpi_tpu_torch.ops.kernels import inv_d2_of
from rocm_mpi_tpu_torch.parallel import wire
from rocm_mpi_tpu_torch.parallel.halo import exchange_halo, exchange_into, place_core
from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid


@dataclasses.dataclass
class DeepSchedule:
    """A deep-halo schedule: `prepare(Cp)` exchanges and masks the
    coefficient once, returning this rank's k-padded Cm; `sweep(T, Cm)`
    advances this rank's shard k steps with one exchange of T.

    `step(Tp, Cm, out)` is the same sweep on state that stays padded: the
    exchange fills the ghosts of the k-padded block `Tp` in place, and the
    k steps write the whole padded result into `out` (a block of Tp's
    shape, never Tp), whose core is the next sweep's state. The sweep
    loops of the models (models/scan.sweep_loop) keep their state so,
    which saves `sweep`'s two copies of the core a sweep (into the
    padded buffer, out of the result). It takes the same cells as
    `sweep`: interior ghosts are exchanged every sweep, and a ghost no
    neighbour sends stays what the first block held there (zero): the
    schedules hold off-domain cells (diffusion's Cm and the wave's M and
    Cw are 0 there, so the k steps return them unchanged), and the
    shallow water's sealed walls keep them at rest.

    `route` is the local route the last sweep took ("vmem", "hbm-tb" or
    "jnp"), set each time a sweep's Python runs: at every eager sweep,
    and at the warm-up and capture of a captured one, whose replays take
    the route it recorded (a function of the block's shape and dtype
    alone, `route_of(dtype)`). `init_wire(dtype, device)` is None for the
    stateless wire modes; for the stateful ones it builds the zero wire
    state the sweep threads (`sweep(..., ws) -> (..., ws)`, and `step`
    alike). `rebuild(new_grid)` builds the same schedule (constants,
    depth, local form, wire mode) for another process grid of the same
    domain (`rebuild_for_mesh`)."""

    prepare: Callable
    sweep: Callable
    k: int
    wire_mode: str = "f32"
    route: str | None = None
    init_wire: Callable | None = None
    route_of: Callable | None = None
    step: Callable | None = None
    rebuild: Callable | None = None


def _wire_exchange(grid: GlobalGrid, k: int, wire_mode: str, fields: int):
    """(exchange(i, Tp, ws) -> (Tp, ws-part), init_wire) for a schedule
    exchanging `fields` same-shaped fields per sweep: the width-k ghosts
    of the padded block `Tp` filled in place, field `i` taking its slice
    of the flat wire state `ws` (empty for the stateless modes).
    init_wire is None for the stateless modes."""
    per_field = wire.state_arity(wire_mode) * 2 * grid.ndim
    if not wire.is_stateful(wire.validate_mode(wire_mode)):
        def exchange(i, Tp, ws):
            return exchange_into(Tp, grid, width=k, wire_mode=wire_mode), ()

        return exchange, None

    def exchange(i, Tp, ws):
        return exchange_into(Tp, grid, width=k, wire_mode=wire_mode,
                             wire_state=ws[i * per_field:(i + 1) * per_field])

    def init_wire(dtype, device=None):
        return wire.init_exchange_state(grid.local_shape, k, wire_mode, dtype,
                                        fields=fields, device=device)

    return exchange, init_wire


def _pads(padded_shape, k: int):
    """padded(i, t) -> a k-padded buffer of field `i` (kept per field,
    dtype and device, so every sweep reuses it) holding `t` in its core,
    zeros in its ghosts until the exchange fills them."""
    bufs: dict[int, torch.Tensor] = {}

    def padded(i, t):
        buf = bufs.get(i)
        if buf is None or buf.dtype != t.dtype or buf.device != t.device:
            buf = bufs[i] = torch.zeros(padded_shape, dtype=t.dtype, device=t.device)
        return place_core(t, k, out=buf)

    return padded


def _validate_depth(grid: GlobalGrid, k: int, label: str = "sweep depth"):
    if k < 1:
        raise ValueError(f"{label} k must be >= 1, got {k}")
    if any(k > ln for ln in grid.local_shape):
        raise ValueError(
            f"{label} {k} exceeds a local shard extent "
            f"{grid.local_shape}; ghost slices need width <= shard"
        )


def padded_hold_mask(shape, grid: GlobalGrid, width: int, device=None) -> torch.Tensor:
    """True over a width-`width` padded block where the cell must NOT
    update: global Dirichlet boundary cells and off-domain ghost cells,
    located by global index from this rank's shard bounds."""
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for ax, (start, _) in enumerate(grid.shard_bounds()):
        gidx = start + torch.arange(shape[ax], device=device) - width
        m = (gidx <= 0) | (gidx >= grid.global_shape[ax] - 1)
        view = [1] * len(shape)
        view[ax] = shape[ax]
        mask = mask | m.reshape(view)
    return mask


def padded_update_coefficient(Cp_padded, grid: GlobalGrid, width: int, lam, dt):
    """Masked dt·λ/Cp over a width-`width` padded block: zero where the
    cell must not update; off-domain ghosts, where the exchanged Cp is 0,
    are guarded so the division cannot produce inf."""
    mask = padded_hold_mask(Cp_padded.shape, grid, width, device=Cp_padded.device)
    safe = torch.where(Cp_padded == 0, torch.ones_like(Cp_padded), Cp_padded)
    return torch.where(mask, torch.zeros_like(Cp_padded), (dt * lam) / safe)


def resolve_deep_config(grid: GlobalGrid, dtype, config: str | None, device=None) -> dict:
    """The tuned deep configuration ({"k", "wire_mode"}, None = default
    policy) — deep_halo.py:125-172's seam. `config="auto"` consults the
    tuning cache (op "diffusion.deep", keyed by the LOCAL shard shape and
    the process grid, on `device`); rank 0 decides for every rank of the
    grid (tuning/resolve.py), so the ranks never disagree on k or the
    wire mode. A cached depth deeper than a shard edge (an entry that
    outlived a reshard) falls back to the default silently; the gate and
    the validate CLI are the loud half."""
    nothing = {"k": None, "wire_mode": None}
    if not multistep.auto_config(config):
        return nothing
    from rocm_mpi_tpu_torch.tuning import resolve as tuning_resolve

    tuned = tuning_resolve.resolve("diffusion.deep", grid.local_shape, dtype,
                                   topology=grid.dims, grid=grid, device=device)
    if not tuned:
        return nothing
    out = dict(nothing)
    if tuned.get("k"):
        k = int(tuned["k"])
        if k >= 1 and all(k <= ln for ln in grid.local_shape):
            out["k"] = k
    if tuned.get("wire_mode"):
        out["wire_mode"] = str(tuned["wire_mode"])
    return out


def resolve_deep_k(grid: GlobalGrid, dtype, config: str | None, device=None) -> int | None:
    """The tuned sweep depth alone (resolve_deep_config's k field)."""
    return resolve_deep_config(grid, dtype, config, device)["k"]


def rebuild_for_mesh(sched: DeepSchedule, new_grid: GlobalGrid, dims=None,
                     nprocs=None) -> DeepSchedule:
    """Re-derive `sched` for a new decomposition of the same global
    domain — the JAX package's deep_halo.rebuild_for_mesh. `new_grid` is
    the rebuilt GlobalGrid (mesh.rebuild_for_mesh), or the old grid with
    `dims`/`nprocs` to rebuild here. The ghost width, the padded block
    and the local route depend on the shard's shape, so nothing built for
    the old grid is reused; make_*_deep_sweep's own depth check fails loudly
    where k exceeds a shard of the new grid, as a fresh build does. A
    schedule without its `rebuild` (built by hand) raises."""
    if sched.rebuild is None:
        raise ValueError("this DeepSchedule has no rebuild (built by hand?): reconstruct it "
                         "with its make_*_deep_sweep function")
    if dims is not None or nprocs is not None:
        from rocm_mpi_tpu_torch.parallel import mesh

        new_grid = mesh.rebuild_for_mesh(new_grid, dims=dims, nprocs=nprocs,
                                         rank=new_grid.rank)
    return sched.rebuild(new_grid)


def local_route(padded_shape, dtype, k: int, local_form: str = "auto") -> str:
    """The local route of a k-step sweep on a block of `padded_shape`:
    deep_halo.py:315-326's rule, a function of the shape alone."""
    if local_form == "jnp":
        return "jnp"
    if multistep._compute_nbytes(padded_shape, dtype) <= multistep._VMEM_BLOCK_BUDGET_BYTES:
        return "vmem"
    n0p = padded_shape[0]
    if (
        k <= multistep._TB_MAX_STEPS
        and len(padded_shape) in (2, 3)
        and multistep.tb_slab_fits(k, padded_shape, dtype)
        and n0p % multistep.tb_geometry(k)[1] == 0
        and (n0p // multistep.tb_geometry(k)[1]) >= 2
    ):
        return "hbm-tb"
    return "jnp"


def jnp_k_steps(Tp, Cm, inv_d2, k: int):
    """k steps of the padded-slice stencil on the inner box (the outermost
    ghost layer is held) — deep_halo.py's any-shape XLA route, in plain
    PyTorch and its operation order: ((hi - 2c) + lo)·inv per axis."""
    ndim = len(inv_d2)  # the space axes are the last ndim; any before are lanes
    E = (Ellipsis,)
    inner = E + tuple(slice(1, -1) for _ in range(ndim))
    Tp = Tp.clone()
    for _ in range(k):
        lap = None
        for ax in range(ndim):
            hi = E + tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(ndim))
            lo = E + tuple(slice(None, -2) if a == ax else slice(1, -1) for a in range(ndim))
            term = (Tp[hi] - 2.0 * Tp[inner] + Tp[lo]) * inv_d2[ax]
            lap = term if lap is None else lap + term
        Tp[inner] = Tp[inner] + Cm[inner] * lap
    return Tp


def make_deep_sweep(grid: GlobalGrid, k: int, lam, dt, spacing,
                    local_form: str = "auto", wire_mode: str = "f32") -> DeepSchedule:
    """Build the diffusion DeepSchedule on this rank's shard of `grid`.

    `prepare(Cp)` -> k-padded Cm (one width-k exchange of Cp, once per
    advance); `sweep(T, Cm)` -> T advanced k steps (one width-k exchange
    of T into a padded buffer the schedule reuses, the local k steps on
    the route `local_route` picks, the core kept); `step(Tp, Cm, out)`
    the same on a padded block (DeepSchedule). `dt` may be a Python
    float or a 0-dim tensor in the field dtype, as the model passes it.
    A stateful `wire_mode` makes it `sweep(T, Cm, wire_state) -> (T,
    wire_state)`.

    `grid` may be a BatchedGrid (docs/SERVING.md): the sweep then
    advances a rank's `(lanes, *space shard)` block with ONE width-k
    exchange of every lane (halo.exchange_halo_batched), `prepare` takes
    the space-shaped Cp every lane shares, and the local k steps take the
    "jnp" form over the whole block, as the JAX package pins its batched
    sweeps. Batched sweeps serve the stateless wire modes only.
    """
    from rocm_mpi_tpu_torch.parallel.mesh import BatchedGrid

    if isinstance(grid, BatchedGrid):
        return _make_batched_deep_sweep(grid, k, lam, dt, spacing, wire_mode)
    _validate_depth(grid, k, "sweep depth")
    exchange, init_wire = _wire_exchange(grid, k, wire_mode, 1)
    if local_form not in ("auto", "jnp"):
        raise ValueError(f"local_form must be 'auto' or 'jnp', got {local_form!r}")
    core = tuple(slice(k, -k) for _ in range(grid.ndim))
    inv_d2 = inv_d2_of(spacing)
    padded_shape = tuple(n + 2 * k for n in grid.local_shape)
    padded = _pads(padded_shape, k)

    def prepare(Cp):
        return padded_update_coefficient(exchange_halo(Cp, grid, width=k), grid, k, lam, dt)

    def route_of(dtype):
        return local_route(padded_shape, dtype, k, local_form)

    def step(Tp, Cm, out=None, *wire_state):
        Tp, ws = exchange(0, Tp, wire_state[0] if wire_state else ())
        route = sched.route = route_of(Tp.dtype)
        if telemetry.enabled():
            # The JAX package's deep.sweep annotation: the local route this
            # sweep took (the halo.exchange annotation came from the exchange).
            telemetry.annotate_once(("deep.sweep", k, route, wire_mode), "deep.sweep",
                                    lambda: dict(k=k, route=route, steps_per_exchange=k,
                                                 wire=wire_mode))
        if route == "vmem":
            out = multistep.multi_step_cm(Tp, Cm, spacing, k, out=out)
        elif route == "hbm-tb":
            out = multistep.multi_step_cm_hbm(Tp, Cm, spacing, k, out=out)
        else:
            out = _into(out, jnp_k_steps(Tp, Cm, inv_d2, k))
        return (out, ws) if init_wire else out

    def sweep(T, Cm, *wire_state):
        got = step(padded(0, T), Cm, None, *wire_state)
        return (got[0][core], got[1]) if init_wire else got[core]

    sched = DeepSchedule(prepare, sweep, k, wire_mode=wire_mode, init_wire=init_wire,
                         route_of=route_of, step=step,
                         rebuild=lambda g: make_deep_sweep(g, k, lam, dt, spacing,
                                                           local_form=local_form,
                                                           wire_mode=wire_mode))
    return sched


def _make_batched_deep_sweep(bgrid, k: int, lam, dt, spacing, wire_mode: str) -> DeepSchedule:
    """make_deep_sweep on a BatchedGrid (its docstring)."""
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo_batched

    space = bgrid.space
    _validate_depth(space, k, "sweep depth")
    if wire.is_stateful(wire.validate_mode(wire_mode)):
        raise ValueError(f"wire_mode {wire_mode!r} is stateful; batched deep sweeps support "
                         "the stateless modes (f32/bf16) only")
    core = (Ellipsis,) + tuple(slice(k, -k) for _ in range(space.ndim))
    inv_d2 = inv_d2_of(spacing)
    bufs: dict = {}

    def prepare(Cp):
        return padded_update_coefficient(exchange_halo(Cp, space, width=k), space, k, lam, dt)

    def sweep(Tb, Cm):
        key = (tuple(Tb.shape), Tb.dtype, Tb.device)
        Tp = exchange_halo_batched(Tb, bgrid, width=k, wire_mode=wire_mode, out=bufs.get(key))
        bufs[key] = Tp
        sched.route = "jnp"
        if telemetry.enabled():
            telemetry.annotate_once(("deep.sweep.batched", k, wire_mode), "deep.sweep",
                                    lambda: dict(k=k, route="jnp", steps_per_exchange=k,
                                                 wire=wire_mode, lanes=int(Tb.shape[0])))
        return jnp_k_steps(Tp, Cm, inv_d2, k)[core]

    sched = DeepSchedule(prepare, sweep, k, wire_mode=wire_mode, route_of=lambda dtype: "jnp")
    return sched


def _into(out, result):
    """`result`, copied into `out` when a buffer is given."""
    if out is None:
        return result
    if isinstance(out, tuple):
        return tuple(o.copy_(r) for o, r in zip(out, result))
    return out.copy_(result)


def wave_local_route(padded_shape, dtype) -> str:
    """The local route of a wave sweep on a block of `padded_shape`:
    deep_halo.py:616's rule — the multi-step kernel when twice the block
    (the state pair) fits the VMEM budget, else the jnp steps."""
    if 2 * multistep._compute_nbytes(padded_shape, dtype) <= multistep._VMEM_BLOCK_BUDGET_BYTES:
        return "vmem"
    return "jnp"


def make_wave_deep_sweep(grid: GlobalGrid, k: int, dt, spacing,
                         wire_mode: str = "f32") -> DeepSchedule:
    """Build the acoustic-wave DeepSchedule on this rank's shard of `grid`.

    `prepare(C2)` -> (M, Cw) over the k-padded block: one width-k exchange
    of c², the hold mask M (0.0 on global Dirichlet and off-domain ghost
    cells, else 1.0) and Cw = dt²·C2·M with dt² the double product of `dt`
    (a float or the field-dtype step), as the JAX schedule forms it.
    `sweep(U, Uprev, (M, Cw))` -> (U, Uprev) advanced k steps: one width-k
    exchange of each leaf of the pair into buffers the schedule reuses,
    the local k steps on `wave_local_route`'s route, both leaves cropped to
    the core; `step(Up, Upp, (M, Cw), out)` the same on padded blocks, into
    the pair `out` (DeepSchedule). A stateful `wire_mode` adds a trailing
    wire state to the sweep's arguments and results.
    """
    _validate_depth(grid, k, "sweep depth")
    exchange, init_wire = _wire_exchange(grid, k, wire_mode, 2)
    core = tuple(slice(k, -k) for _ in range(grid.ndim))
    inv_d2 = inv_d2_of(spacing)
    dt2 = float(dt) * float(dt)
    padded_shape = tuple(n + 2 * k for n in grid.local_shape)
    padded = _pads(padded_shape, k)

    def prepare(C2):
        C2p = exchange_halo(C2, grid, width=k)
        hold = padded_hold_mask(C2p.shape, grid, k, device=C2p.device)
        M = torch.where(hold, torch.zeros_like(C2p), torch.ones_like(C2p))
        return M, (dt2 * C2p) * M

    def route_of(dtype):
        return wave_local_route(padded_shape, dtype)

    def step(Up, Upp, prepared, out=None, *wire_state):
        M, Cw = prepared
        ws = wire_state[0] if wire_state else ()
        (Up, ws_u), (Upp, ws_p) = exchange(0, Up, ws), exchange(1, Upp, ws)
        route = sched.route = route_of(Up.dtype)
        if route == "vmem":
            pair = wave.wave_multi_step_masked(Up, Upp, M, Cw, spacing, k, out=out)
        else:
            pair = Up, Upp
            for _ in range(k):
                pair = wave.masked_leapfrog_step(*pair, M, Cw, inv_d2)
            pair = _into(out, pair)
        return (*pair, ws_u + ws_p) if init_wire else tuple(pair)

    def sweep(U, Uprev, prepared, *wire_state):
        got = step(padded(0, U), padded(1, Uprev), prepared, None, *wire_state)
        return (got[0][core], got[1][core], *got[2:])

    sched = DeepSchedule(prepare, sweep, k, wire_mode=wire_mode, init_wire=init_wire,
                         route_of=route_of, step=step,
                         rebuild=lambda g: make_wave_deep_sweep(g, k, dt, spacing,
                                                                wire_mode=wire_mode))
    return sched


def padded_face_mask(shape, grid: GlobalGrid, axis: int, width: int, dtype,
                     device=None) -> torch.Tensor:
    """Face mask of u_axis over a width-`width` padded block: exactly 0.0 on
    the global high wall face (global index n_g − 1 along `axis`) and on
    off-domain ghost faces along `axis`, 1.0 elsewhere — deep_halo.py's
    `padded_face_mask`. Sealed walls keep off-domain ghost values from
    reaching any in-domain cell however many local steps a sweep takes;
    off-domain faces along other axes would have to cross that axis's wall
    first, so they need no zero."""
    start = grid.shard_bounds()[axis][0]
    gidx = start + torch.arange(shape[axis], device=device) - width
    invalid = (gidx >= grid.global_shape[axis] - 1) | (gidx < 0)
    view = [1] * len(shape)
    view[axis] = shape[axis]
    invalid = invalid.reshape(view).expand(tuple(shape))
    return torch.where(invalid, torch.zeros(tuple(shape), dtype=dtype, device=device),
                       torch.ones(tuple(shape), dtype=dtype, device=device))


def swe_local_route(padded_shape, dtype) -> str:
    """The local route of an SWE sweep on a block of `padded_shape`:
    deep_halo.py:501's rule — the multi-step kernel when the padded state
    passes the admission, else the jnp steps."""
    return "vmem" if swe.swe_admitted(padded_shape, dtype) else "jnp"


def make_swe_deep_sweep(grid: GlobalGrid, k: int, dt, spacing, H, g,
                        wire_mode: str = "f32") -> DeepSchedule:
    """Build the shallow-water DeepSchedule on this rank's shard of `grid`.

    `prepare(h)` -> the ndim padded face masks (geometry only: `h` gives
    the dtype and device; once per advance). `sweep(h, us, Mp)` -> (h, us)
    advanced k steps: one width-k exchange of each of the ndim+1 coupled
    fields into buffers the schedule reuses, the local k steps on
    `swe_local_route`'s route, every leaf cropped to the core; `step(hp,
    ups, Mp, out)` the same on padded blocks, into the tuple `out` (h, u0,
    …) (DeepSchedule). The light cone is the diffusion one: a step moves
    information one cell (a diagonal counts as one), so width-k ghosts
    keep the core exact for k steps. A stateful `wire_mode` adds a
    trailing wire state (h's, then each velocity's) to the sweep's
    arguments and results.
    """
    _validate_depth(grid, k, "sweep depth")
    ndim = grid.ndim
    exchange, init_wire = _wire_exchange(grid, k, wire_mode, ndim + 1)
    core = tuple(slice(k, -k) for _ in range(ndim))
    cH, cg = swe.swe_coeffs(dt, spacing, H, g)
    padded_shape = tuple(n + 2 * k for n in grid.local_shape)
    padded = _pads(padded_shape, k)

    def prepare(h):
        return tuple(padded_face_mask(padded_shape, grid, a, k, h.dtype, device=h.device)
                     for a in range(ndim))

    def route_of(dtype):
        return swe_local_route(padded_shape, dtype)

    def step(hp, ups, Mp, out=None, *wire_state):
        ws = wire_state[0] if wire_state else ()
        outs = [exchange(i, t, ws) for i, t in enumerate((hp, *ups))]
        hp, ups = outs[0][0], tuple(p for p, _ in outs[1:])
        route = sched.route = route_of(hp.dtype)
        if route == "vmem":
            h2, us2 = swe.swe_multi_step_masked(hp, ups, Mp, cH, cg, k, out=out)
        else:
            h2, us2 = hp, ups
            for _ in range(k):
                h2, us2 = swe.masked_swe_step(h2, us2, Mp, cH, cg)
            h2, *us2 = _into(out, (h2, *us2))
        if init_wire:
            return h2, tuple(us2), sum((w for _, w in outs), ())
        return h2, tuple(us2)

    def sweep(h, us, Mp, *wire_state):
        got = step(padded(0, h), tuple(padded(i + 1, u) for i, u in enumerate(us)), Mp,
                   None, *wire_state)
        return (got[0][core], tuple(u[core] for u in got[1]), *got[2:])

    sched = DeepSchedule(prepare, sweep, k, wire_mode=wire_mode, init_wire=init_wire,
                         route_of=route_of, step=step,
                         rebuild=lambda ng: make_swe_deep_sweep(ng, k, dt, spacing, H, g,
                                                                wire_mode=wire_mode))
    return sched
