"""The service driver: batches queued requests onto the space×batch grid —
counterpart of rocm_mpi_tpu/serving/service.py (docs/SERVING.md).

One `SimulationService` owns a `RequestQueue`, a per-bin model and
program cache, and the serving accounting. The drain loop pops pending
tickets, groups them by `bins.bin_key`, packs each group into power-of-two
lane widths (`bins.plan_batches`: the occupancy floor splits an
under-occupied wide batch into a narrower program class instead of
shipping padding), and runs every batch through the workload's batched
advance (models/*.batched_advance_fn). Programs are cached by
(bin key | width | batch rows): a program is the built batched advance
of a class, and building one is recorded as one compile
(`telemetry.compiles`, program "serve:<key>"), so a repeat trace builds
nothing and `compiles.steady_state` stays 0 — the steady-state contract.

Resilience: requests with a `session` id get their final state saved
through utils/checkpoint.py (``sessions/<id>/``; `resume=True` continues
from the latest valid step); a SIGTERM preemption notice
(resilience/preempt.py, rc 75) stops dispatch at the next batch boundary
and requeues every unserved ticket; transient failures ride the retry
budget, poison requests are quarantined, and a per-BinKey circuit breaker
(resilience/policy.py) keeps one failing class from starving the others.
The queue depth drives batch-row growth through the ElasticPolicy.

Where the port differs from the JAX package (one process drives one
card):

* Ranks, not devices. A batch row is a set of ranks (parallel/mesh.py
  BatchedGrid). `device_budget` defaults to the world size. The program
  key's rows (`bd`) are the service's logical batch rows, as in the JAX
  package; rows beyond the ranks a row's space grid leaves fold onto the
  rank's device as lane slices (`_physical_rows`): lanes are independent,
  so each lane's result does not depend on the fold.
* Lanes are assembled on the device: lane j is `ic_scale × the standard
  initial condition` (one multiply on the device) or a session restore.
* The pipeline has no async dispatch to lean on. Dispatch enqueues the
  batched advance (the host issues every launch; the device runs behind
  it) and a non-blocking copy of the result into pinned host memory,
  then records a CUDA event; fetch is the one `event.synchronize()` a
  batch. The in-flight record keeps the batch's tensors alive until its
  fetch, so the caching allocator never hands an in-flight buffer to
  another batch (the counterpart of JAX's deletion anchors); every
  launch is on the current stream (the hide lanes' side streams join it
  each step), so stream order protects the rest. Whatever reads a
  batch's result is enqueued at dispatch (the host copies and the lane
  finiteness flags): the result may be the program's spare buffer,
  which the next batch of the same program overwrites before the fetch.
* Multi-controller: every rank plans identical batches; ranks past the
  batch rows hold no lane but join the lane-finiteness verdict, an
  all-reduce over the world group; with `fetch_results=True` a rank's
  tickets resolve with its shards of its row's lanes (None for lanes of
  other rows).
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import time
from typing import Callable

import numpy as np
import torch

from rocm_mpi_tpu_torch.resilience.policy import CircuitPolicy, RequestRetryPolicy
from rocm_mpi_tpu_torch.serving import bins as _bins
from rocm_mpi_tpu_torch.serving.bins import BinKey, BinStats
from rocm_mpi_tpu_torch.serving.queue import (
    Request,
    RequestQueue,
    Ticket,
    append_quarantine,
    quarantine_record,
)

# Physics fields each workload's config accepts from a request (anything
# else fails the request loudly — a typo'd constant must not silently
# serve default physics).
PHYSICS_FIELDS = {
    "diffusion": ("lam", "cp0"),
    "wave": ("c0", "cfl"),
    "swe": ("H0", "g", "cfl"),
}

# The port's copy of the "serving" row of the JAX package's
# perf/budgets.json: the occupancy floor, the ladder's padded-FLOPs
# tolerance and the continuous drain's occupancy floor the scheduler
# reads, and the traffic tolerances regress validates.
SERVING_BUDGETS = {
    "batch": 2,
    "batch_tolerance": 2.4,
    "hide_tolerance": 5.9,
    "occupancy_floor": 0.5,
    "padded_flops_tolerance": 0.25,
    "occupancy": 0.6,
}


@dataclasses.dataclass
class ServeConfig:
    """Service knobs (docs/SERVING.md "Service driver"); the JAX
    package's, with `device` added."""

    max_width: int = _bins.DEFAULT_MAX_WIDTH
    occupancy_floor: float | None = None  # None -> the budgets row
    batch_dims: int = 1  # logical batch rows
    sessions_dir: str | None = None  # checkpoint multiplex root
    fetch_results: bool | None = None  # None: on one rank, off on several
    policy: object | None = None  # resilience.policy.ElasticPolicy
    # Row budget: how many batch rows the lane axis may spread over.
    # Default: the world size (one rank a card).
    device_budget: Callable[[], int] | None = None
    grow_queue_depth: int = 8
    idle_shrink_drains: int = 3
    max_depth: int | None = None
    retry: RequestRetryPolicy | None = None
    circuit: CircuitPolicy | None = None
    quarantine_path: str | None = None
    pipeline_depth: int = 2
    # Host-side stage callbacks {stage: fn(stage, info)} for
    # {"assemble","dispatch","fetch","resolve"}, called AFTER the stage.
    stage_hooks: dict | None = None
    segments: int = 1
    ladder: bool = False
    ladder_tolerance: float | None = None
    trace_requests: bool = True
    # The device every program runs on ("cuda", "cpu", …; None: the
    # port's default, the GPU). Ranks over several processes take their
    # local device of that type.
    device: object = None

    def resolved_floor(self) -> float:
        if self.occupancy_floor is not None:
            return float(self.occupancy_floor)
        return float(SERVING_BUDGETS["occupancy_floor"])

    def resolved_ladder_tolerance(self) -> float:
        if self.ladder_tolerance is not None:
            return float(self.ladder_tolerance)
        return float(SERVING_BUDGETS["padded_flops_tolerance"])


@dataclasses.dataclass
class ServeReport:
    """One trace/drain session's outcome."""

    served: int = 0
    failed: int = 0
    requeued: int = 0
    rejected: int = 0
    expired: int = 0
    quarantined: int = 0
    preempted: bool = False
    bins: dict = dataclasses.field(default_factory=dict)
    programs: list = dataclasses.field(default_factory=list)
    compiles: dict = dataclasses.field(default_factory=dict)
    elastic: list = dataclasses.field(default_factory=list)
    pipeline: dict = dataclasses.field(default_factory=dict)
    continuous: dict = dataclasses.field(default_factory=dict)

    @property
    def n_bins(self) -> int:
        return len(self.bins)

    @property
    def n_programs(self) -> int:
        return len(self.programs)

    def manifest_doc(self, queue_counters=None) -> dict:
        extra = {
            "served": self.served,
            "failed": self.failed,
            "requeued": self.requeued,
            "rejected": self.rejected,
            "expired": self.expired,
            "quarantined": self.quarantined,
            "preempted": self.preempted,
            "elastic": list(self.elastic),
            "compiles": dict(self.compiles),
            "pipeline": dict(self.pipeline),
        }
        if self.continuous:
            extra["continuous"] = dict(self.continuous)
        return _bins.manifest_doc(self.bins, list(self.programs),
                                  queue_counters=queue_counters, extra=extra)


def _world() -> tuple[int, int]:
    from rocm_mpi_tpu_torch.parallel import distributed

    return distributed.world_size(), distributed.rank()


class _Program:
    """One program class: the batched advance bound to its BatchedGrid,
    the lane-shared aux operands and the standard-IC state leaves on the
    device (this rank's shards), from which lanes are scaled."""

    def __init__(self, advance, bgrid, aux, base, adapter, model, ladder: bool = False):
        self.advance = advance
        self.bgrid = bgrid
        self.aux = tuple(aux)
        self.base = tuple(base)
        self.adapter = adapter
        self.model = model
        self.ladder = bool(ladder)

    @property
    def n_leaves(self) -> int:
        return len(self.base)

    @property
    def lanes(self) -> range:
        """The global lanes this rank holds."""
        return self.bgrid.lane_range()

    def empty_block(self):
        """Fresh `(local lanes, *shard)` leaves for a batch."""
        nb = len(self.lanes)
        return tuple(torch.empty((nb,) + tuple(b.shape), dtype=b.dtype, device=b.device)
                     for b in self.base)


class _Adapter:
    """Per-workload glue: config and model construction, the batched
    advance's calling convention, and the state-leaf layout (a session
    checkpoint holds exactly the leaves)."""

    name: str = ""
    supports_ladder: bool = False

    def make_config(self, key: BinKey, space_dims):
        raise NotImplementedError

    def make_model(self, cfg, grid, device):
        raise NotImplementedError

    def build(self, model, bgrid, variant="shard"):
        """-> (advance, aux, base leaves)."""
        raise NotImplementedError

    def run(self, prog: _Program, leaves, lane_steps, n):
        raise NotImplementedError

    def build_ladder(self, model, bgrid):
        raise NotImplementedError(f"{self.name} has no ladder support")

    def run_ladder(self, prog: _Program, leaves, hold, geom, lane_steps, n):
        raise NotImplementedError(f"{self.name} has no ladder support")

    def ladder_geom(self, model):
        """(dt, spacing) of a lane's original-shape model: the scalars its
        standalone shard step runs with."""
        return model.dt, tuple(model.config.spacing)


class _DiffusionAdapter(_Adapter):
    name = "diffusion"
    supports_ladder = True

    def make_config(self, key, space_dims):
        from rocm_mpi_tpu_torch.config import DiffusionConfig

        phys = dict(key.physics)
        return DiffusionConfig(global_shape=key.shape, lengths=(10.0,) * len(key.shape),
                               dtype=key.dtype, dims=space_dims, wire_mode=key.wire_mode,
                               lam=phys.get("lam", 1.0), cp0=phys.get("cp0", 1.0))

    def make_model(self, cfg, grid, device):
        from rocm_mpi_tpu_torch.models.diffusion import HeatDiffusion

        return HeatDiffusion(cfg, grid=grid, device=device)

    def build(self, model, bgrid, variant="shard"):
        advance, _ = model.batched_advance_fn(bgrid=bgrid, variant=variant)
        T0, Cp = model.init_state()
        return advance, (Cp,), (T0,)

    def run(self, prog, leaves, lane_steps, n):
        return (prog.advance(leaves[0], prog.aux[0], lane_steps, n),)

    def build_ladder(self, model, bgrid):
        advance, _ = model.batched_ladder_advance_fn(bgrid=bgrid)
        T0, Cp = model.init_state()
        return advance, (Cp,), (T0,)

    def run_ladder(self, prog, leaves, hold, geom, lane_steps, n):
        return (prog.advance(leaves[0], prog.aux[0], hold, geom, lane_steps, n),)


class _WaveAdapter(_Adapter):
    name = "wave"
    supports_ladder = True

    def make_config(self, key, space_dims):
        from rocm_mpi_tpu_torch.config import WaveConfig

        phys = dict(key.physics)
        return WaveConfig(global_shape=key.shape, lengths=(10.0,) * len(key.shape),
                          dtype=key.dtype, dims=space_dims, wire_mode=key.wire_mode,
                          c0=phys.get("c0", 1.0), cfl=phys.get("cfl", 0.5))

    def make_model(self, cfg, grid, device):
        from rocm_mpi_tpu_torch.models.wave import AcousticWave

        return AcousticWave(cfg, grid=grid, device=device)

    def build(self, model, bgrid, variant="shard"):
        advance, _ = model.batched_advance_fn(bgrid=bgrid, variant=variant)
        U0, Up0, C2 = model.init_state()
        return advance, (C2,), (U0, Up0)

    def run(self, prog, leaves, lane_steps, n):
        return tuple(prog.advance(leaves[0], leaves[1], prog.aux[0], lane_steps, n))

    def build_ladder(self, model, bgrid):
        advance, _ = model.batched_ladder_advance_fn(bgrid=bgrid)
        U0, Up0, C2 = model.init_state()
        return advance, (C2,), (U0, Up0)

    def run_ladder(self, prog, leaves, hold, geom, lane_steps, n):
        return tuple(prog.advance(leaves[0], leaves[1], prog.aux[0], hold, geom,
                                  lane_steps, n))


class _SWEAdapter(_Adapter):
    name = "swe"

    def make_config(self, key, space_dims):
        from rocm_mpi_tpu_torch.config import SWEConfig

        phys = dict(key.physics)
        return SWEConfig(global_shape=key.shape, lengths=(10.0,) * len(key.shape),
                         dtype=key.dtype, dims=space_dims, wire_mode=key.wire_mode,
                         H0=phys.get("H0", 1.0), g=phys.get("g", 1.0),
                         cfl=phys.get("cfl", 0.5))

    def make_model(self, cfg, grid, device):
        from rocm_mpi_tpu_torch.models.swe import ShallowWater

        return ShallowWater(cfg, grid=grid, device=device)

    def build(self, model, bgrid, variant="shard"):
        advance, _ = model.batched_advance_fn(bgrid=bgrid, variant=variant)
        h0, us0 = model.init_state()
        return advance, tuple(model.face_masks()), (h0,) + tuple(us0)

    def run(self, prog, leaves, lane_steps, n):
        h, us = prog.advance(leaves[0], tuple(leaves[1:]), prog.aux, lane_steps, n)
        return (h,) + tuple(us)


_ADAPTERS = {a.name: a for a in (_DiffusionAdapter(), _WaveAdapter(), _SWEAdapter())}


class _Breaker:
    """One BinKey's circuit state: closed → (K consecutive batch
    failures) → open → (cooldown drains) → half-open probe → closed on
    success, re-open on failure. A function of batch outcomes and drain
    counts alone, so every controller reaches the same state."""

    __slots__ = ("consecutive", "state", "opened_drain")

    def __init__(self):
        self.consecutive = 0
        self.state = "closed"
        self.opened_drain = 0

    def note_failure(self, policy: CircuitPolicy, drain: int) -> bool:
        self.consecutive += 1
        tripped = (policy.enabled and self.state != "open"
                   and (self.state == "half-open" or self.consecutive >= policy.k))
        if tripped:
            self.state = "open"
            self.opened_drain = drain
        return tripped

    def note_success(self) -> bool:
        recovered = self.state == "half-open"
        self.consecutive = 0
        self.state = "closed"
        return recovered

    def admit(self, policy: CircuitPolicy, drain: int, n: int) -> int:
        if not policy.enabled or self.state == "closed":
            return n
        if self.state == "open" and drain - self.opened_drain >= policy.cooldown_drains:
            self.state = "half-open"
        return min(n, 1) if self.state == "half-open" else 0


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unresolved batch (docs/SERVING.md "The
    pipeline"). `anchors` keeps the batch's input and output tensors
    alive until the fetch (module docstring); they are never read after
    dispatch: a retry re-assembles from the request."""

    key: BinKey
    width: int
    split: bool
    seq: int
    prog: _Program
    live: list  # tickets that hold a lane
    starts: list
    lane_steps: object  # numpy (width,) int32
    out: tuple  # advanced leaves (this rank's block, on the device)
    flags: torch.Tensor  # (width,) int32 lane finiteness, computed at dispatch
    host: tuple | None  # their host copies (pinned on a CUDA device)
    event: object  # CUDA event recorded after the copies (None on the CPU)
    fetch: bool
    need_host: bool
    anchors: tuple = ()


class SimulationService:
    """Multi-tenant batched simulation service (module docstring; the CLI
    driver is rocm_mpi_tpu_torch/apps/serve.py)."""

    def __init__(self, queue: RequestQueue | None = None, config: ServeConfig | None = None):
        from rocm_mpi_tpu_torch.utils.backend import resolve_device

        self.config = config if config is not None else ServeConfig()
        self.queue = queue if queue is not None else RequestQueue(
            max_depth=self.config.max_depth)
        self._retry = self.config.retry if self.config.retry is not None \
            else RequestRetryPolicy()
        self._circuit = self.config.circuit if self.config.circuit is not None \
            else CircuitPolicy()
        self._floor = self.config.resolved_floor()
        self._batch_dims = int(self.config.batch_dims)
        self.device = resolve_device(self.config.device)
        world, _ = _world()
        if world > 1 and self.device.type == "cuda":
            from rocm_mpi_tpu_torch.parallel import distributed

            self.device = distributed.local_device("cuda")
            torch.cuda.set_device(self.device)
        self._models: dict = {}
        self._programs: dict[str, _Program] = {}
        self._ladder_tol = self.config.resolved_ladder_tolerance()
        self._continuous = {"batches": 0, "segments_run": 0, "swaps_in": 0,
                            "swaps_out": 0, "occ_num": 0, "occ_den": 0}
        self._drain_swaps = 0
        self._drain_occ = [0, 0]
        self._stats: dict[BinKey, BinStats] = {}
        self._breakers: dict[BinKey, _Breaker] = {}
        self._elastic: list[dict] = []
        self._quarantined: list[dict] = []
        self._drains = 0
        self._idle_drains = 0
        self._last_resize_drain: int | None = None
        self._compiled_this_drain = False
        self._batch_seq = 0
        self.retries_total = 0
        self._admission_sync = {"rejected": 0, "expired": 0}
        self._multi: bool | None = None
        self._pipe = {"batches": 0, "assemble_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0,
                      "resolve_s": 0.0, "busy_s": 0.0, "wall_s": 0.0}
        self._inflight_n = 0
        self._inflight_since: float | None = None
        self.last_bubble: float | None = None

    def _is_multi(self) -> bool:
        """Several ranks? Resolved once; also turns the queue's
        wall-clock SLO decisions off (deadline expiry and retry backoff
        would diverge on rank-local clocks; depth admission stays on)."""
        if self._multi is None:
            self._multi = _world()[0] > 1
            if self._multi:
                self.queue.wall_slo = False
        return self._multi

    # ---- model / program caches ----------------------------------------

    def _space_dims(self, key: BinKey):
        from rocm_mpi_tpu_torch.parallel.mesh import plan_dims

        return plan_dims(key.shape, max(_world()[0] // self._batch_dims, 1))

    def _physical_rows(self, bd: int, space_nprocs: int) -> int:
        """The rank rows a program of `bd` logical rows runs on: the
        largest power of two that divides bd and fits the ranks (module
        docstring)."""
        return _bins.pow2_floor(max(1, min(bd, _world()[0] // space_nprocs)))

    def _model_for(self, key: BinKey):
        mkey = (key.workload, key.shape, key.dtype, key.physics, key.wire_mode,
                self._batch_dims)
        model = self._models.get(mkey)
        if model is None:
            from rocm_mpi_tpu_torch.parallel.mesh import init_batched_grid

            adapter = _ADAPTERS[key.workload]
            unknown = [k for k, _ in key.physics if k not in PHYSICS_FIELDS[key.workload]]
            if unknown:
                raise ValueError(
                    f"unknown physics field(s) {unknown} for workload {key.workload!r} "
                    f"(accepted: {PHYSICS_FIELDS[key.workload]})")
            space_dims = self._space_dims(key)
            cfg = adapter.make_config(key, space_dims)
            rows = max(1, _world()[0] // math.prod(space_dims))
            space = init_batched_grid(rows, *cfg.global_shape, lengths=cfg.lengths,
                                      space_dims=space_dims, batch_dims=rows).space
            model = adapter.make_model(cfg, space, self.device)
            self._models[mkey] = model
        return model

    def program_key(self, key: BinKey, width: int, ladder: bool = False) -> str:
        base = f"{key.key_str()}|w{width}|bd{self._batch_dims}"
        return base + "|ladder" if ladder else base

    def _program_for(self, key: BinKey, width: int, ladder: bool = False) -> _Program:
        pkey = self.program_key(key, width, ladder)
        prog = self._programs.get(pkey)
        if prog is None:
            from rocm_mpi_tpu_torch import telemetry
            from rocm_mpi_tpu_torch.telemetry import compiles

            # A NEW program class is a legitimate build, not a steady-state
            # regression: close the window; the drain re-marks steady once
            # every class it needs exists.
            compiles.unmark_steady()
            self._compiled_this_drain = True
            adapter = _ADAPTERS[key.workload]
            t0 = time.perf_counter()
            with telemetry.span("serve.compile", phase="serve", bin=key.key_str(),
                                width=width):
                model = self._model_for(key)
                bd = _bins.pow2_floor(min(width, self._batch_dims))
                bgrid = model.make_batched_grid(width, self._physical_rows(
                    bd, model.grid.nprocs))
                if ladder:
                    advance, aux, base = adapter.build_ladder(model, bgrid)
                else:
                    advance, aux, base = adapter.build(model, bgrid, variant=key.variant)
            compiles.record_program(f"serve:{pkey}", time.perf_counter() - t0)
            prog = _Program(advance, bgrid, aux, base, adapter, model, ladder=ladder)
            self._programs[pkey] = prog
        return prog

    # ---- the shape-padding ladder (docs/SERVING.md) ---------------------

    def _ladder_eligible(self, req: Request) -> bool:
        """May this request ride a ladder program? The JAX package's
        rule: diffusion and wave (SWE's face masks are domain-derived),
        the 'shard' variant, the lossless 'f32' wire, no sessions, one
        controller."""
        return (bool(self.config.ladder) and _ADAPTERS[req.workload].supports_ladder
                and req.variant == "shard" and req.wire_mode == "f32"
                and not req.session and not req.resume and not self._is_multi())

    def _group_key(self, req: Request) -> tuple[BinKey, bool]:
        if self._ladder_eligible(req):
            return _bins.bin_key(req, ladder_tolerance=self._ladder_tol), True
        return _bins.bin_key(req), False

    def _ladder_model(self, key: BinKey, orig_shape: tuple):
        """The original-shape model of a laddered lane (cached per shape
        class, as the JAX package caches its IC leaves)."""
        okey = dataclasses.replace(key, shape=tuple(orig_shape))
        fresh = (okey.workload, okey.shape, okey.dtype, okey.physics, okey.wire_mode,
                 self._batch_dims) not in self._models
        if fresh:
            from rocm_mpi_tpu_torch import telemetry
            from rocm_mpi_tpu_torch.telemetry import compiles

            compiles.unmark_steady()
            self._compiled_this_drain = True
            with telemetry.span("serve.compile", phase="serve", bin=okey.key_str(), width=0):
                return self._model_for(okey)
        return self._model_for(okey)

    def _ladder_lane(self, req: Request, key: BinKey, prog: _Program, slot: int, leaves,
                     hold):
        """Seat a laddered lane in `slot`: the original-shape IC
        (×ic_scale) embedded at the origin corner of the rung block,
        `hold` True on the original domain's Dirichlet ring and
        everywhere outside it; returns the lane's geometry (dt,
        spacing)."""
        orig = tuple(int(n) for n in req.global_shape)
        omodel = self._ladder_model(key, orig)
        region = (slot,) + tuple(slice(0, n) for n in orig)
        for leaf, b in zip(leaves, _state_leaves(omodel)):
            leaf[slot].zero_()
            torch.mul(b, req.ic_scale, out=leaf[region])
        hold[slot].fill_(True)
        hold[(slot,) + tuple(slice(1, n - 1) for n in orig)] = False
        return prog.adapter.ladder_geom(omodel)

    # ---- lane assembly --------------------------------------------------

    def _session_dir(self, session: str) -> pathlib.Path:
        root = self.config.sessions_dir
        if not root:
            raise ValueError("request carries a session id but the service has no "
                             "sessions_dir configured")
        return pathlib.Path(root) / session

    def _resume_step(self, req: Request, prog: _Program) -> int:
        """The lane's resume point: the session's latest VALID saved step,
        0 when nothing durable exists yet; a session already past the
        requested nt fails loudly."""
        if self._is_multi():
            raise ValueError("session resume is single-controller only")
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        step = ckpt.latest_valid_step(self._session_dir(req.session))
        if step is None:
            return 0
        if int(step) > req.nt:
            raise ValueError(
                f"session {req.session!r} is already at step {step} > requested nt "
                f"{req.nt}; re-submit with nt >= {step}")
        return int(step)

    def _seat(self, req: Request, prog: _Program, start: int, leaves, slot: int) -> None:
        """Write one lane's start state into `slot` of the batch leaves:
        the session's checkpoint at `start` when resuming, else ic_scale ×
        the workload's standard initial condition (on the device)."""
        if req.resume and start > 0:
            from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

            saved = ckpt.restore_state(self._session_dir(req.session), start, like=None,
                                       devices=self.device)
            saved = tuple(saved) if isinstance(saved, (tuple, list)) else (saved,)
            if len(saved) != prog.n_leaves:
                raise ValueError(
                    f"session {req.session}: checkpoint has {len(saved)} leaves, workload "
                    f"{req.workload!r} carries {prog.n_leaves}")
            for leaf, s in zip(leaves, saved):
                leaf[slot].copy_(s)
            return
        for leaf, b in zip(leaves, prog.base):
            torch.mul(b, req.ic_scale, out=leaf[slot])

    def _save_session(self, ticket: Ticket, lane, prog: _Program) -> None:
        """Save the lane's final state under sessions/<id>/ at step nt,
        its manifest meta carrying the request id."""
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        req = ticket.request
        sdir = self._session_dir(req.session)
        state = tuple(torch.from_numpy(np.ascontiguousarray(l)) for l in lane)
        ckpt.save_state(sdir, req.nt, state)
        ckpt.write_manifest(sdir, req.nt, state, extra_meta={"serving": {
            "request_id": req.request_id, "session": req.session}})

    # ---- execution (the drain pipeline, docs/SERVING.md) ----------------

    def _stage_hook(self, stage: str, **info) -> None:
        hooks = self.config.stage_hooks
        if not hooks:
            return
        fn = hooks.get(stage)
        if fn is not None:
            fn(stage, info)

    def _now(self, now: float | None = None) -> float:
        """The service's one clock seam."""
        return time.monotonic() if now is None else now

    def _note_dispatched(self) -> None:
        if self._inflight_n == 0:
            self._inflight_since = self._now()
        self._inflight_n += 1

    def _note_fetched(self) -> None:
        if self._inflight_n > 0:
            self._inflight_n -= 1
            if self._inflight_n == 0 and self._inflight_since is not None:
                self._pipe["busy_s"] += self._now() - self._inflight_since
                self._inflight_since = None

    def _execute_batch(self, key: BinKey, tickets: list[Ticket], width: int,
                       split: bool) -> None:
        """The serial per-batch chokepoint (pipeline_depth 1, and the seam
        the failure drills patch): prepare, then resolve at once."""
        fl = self._prepare_batch(key, tickets, width, split)
        if fl is not None:
            self._resolve_batch(fl)

    def _batch_faults(self) -> int:
        """The batch-granular fault sites, before the flight step bump and
        any collective; returns the batch's ordinal."""
        from rocm_mpi_tpu_torch.resilience import faults
        from rocm_mpi_tpu_torch.telemetry import flight

        self._batch_seq += 1
        seq = self._batch_seq
        faults.fault_point("serve-batch", step=seq)
        if faults.serving_fault("batch-error", step=seq) is not None:
            raise RuntimeError(f"injected batch-error (batch {seq})")
        flight.progress(step_inc=1)
        slow = faults.serving_fault("slow-batch", step=seq)
        if slow is not None:
            time.sleep(slow.delay_s)
        return seq

    def _to_host(self, out):
        """(host copies, event) of a batch's result leaves: on a CUDA
        device, non-blocking copies into pinned memory and the event that
        marks them done; on the CPU copies (the leaves are the program's
        buffers, which the next batch overwrites)."""
        if out[0].device.type != "cuda":
            return tuple(leaf.clone() for leaf in out), None
        host = []
        for leaf in out:
            h = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            h.copy_(leaf, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out[0].device))
        return tuple(host), event

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        """A host tensor as numpy (bf16 has no numpy dtype: its bits are
        kept as float32, exactly)."""
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()

    def _lane_flags(self, out, lanes, width: int) -> torch.Tensor:
        """(width,) int32, enqueued at dispatch right after the advance:
        1 where every element of every leaf of the lane is finite (lanes
        of other ranks 1). It must not wait for the fetch: the result
        leaves may be the program's spare buffer (models/lanes.py), which
        the next batch of the same program overwrites. On the device
        (NCCL reduces it there), on the host over gloo."""
        where = self.device
        if self._is_multi():
            from rocm_mpi_tpu_torch.parallel import distributed

            if distributed.backend() != "nccl":
                where = torch.device("cpu")
        flags = torch.ones(width, dtype=torch.int32, device=where)
        if len(lanes) and out:
            local = None
            for leaf in out:
                f = torch.isfinite(leaf).flatten(1).all(1)
                local = f if local is None else local & f
            flags[lanes.start:lanes.stop] = local.to(where, torch.int32)
        return flags

    def _lane_verdict(self, flags: torch.Tensor) -> np.ndarray:
        """(width,) bool from a batch's lane flags: one rank reads its
        own; several ranks reduce theirs over the world group (MIN), so
        every rank reads the same verdict in the same order."""
        if self._is_multi():
            import torch.distributed as dist

            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        return flags.cpu().numpy().astype(bool)

    def _prepare_batch(self, key: BinKey, tickets: list[Ticket], width: int,
                       split: bool) -> _InFlight | None:
        """Pipeline stages 1+2 — assemble and dispatch: every lane's start
        state written into a fresh lane block on the device, the batched
        advance enqueued, and the non-blocking copy of its result into
        host memory (module docstring). Nothing waits on the device.
        Returns the in-flight record, or None when no lane survived
        assembly."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.resilience import faults
        from rocm_mpi_tpu_torch.telemetry import flight

        seq = self._batch_faults()
        tracing_on = bool(self.config.trace_requests)
        if tracing_on:
            from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

            tnow = self._now()
            for t in tickets:
                t.trace_mark("queue_wait", tnow)
        prog = self._program_for(key, width)
        if tracing_on:
            tnow = self._now()
            for t in tickets:
                t.trace_mark("compile", tnow)
        multi = self._is_multi()
        mine = prog.lanes

        t0 = self._now()
        live: list[Ticket] = []
        starts: list[int] = []
        lane_steps = np.zeros(width, dtype=np.int32)
        with telemetry.span("serve.assemble", phase="serve", bin=key.key_str(), width=width):
            leaves = prog.empty_block()
            for t in tickets:
                j = len(live)
                try:
                    if multi and (t.request.resume or t.request.session):
                        raise ValueError("session checkpoints are single-controller only")
                    start = self._resume_step(t.request, prog) if t.request.resume else 0
                    if j in mine:
                        self._seat(t.request, prog, start, leaves, j - mine.start)
                except ValueError as e:
                    self._fail_ticket(t, str(e))
                    continue
                except Exception as e:  # noqa: BLE001 — tenant isolation
                    self._retry_or_quarantine(t, str(e))
                    continue
                live.append(t)
                starts.append(start)
                lane_steps[j] = t.request.nt - start
                if faults.serving_fault("lane-nan", request=t.ordinal) is not None \
                        and j in mine:
                    for leaf in leaves:
                        leaf[j - mine.start].fill_(float("nan"))
                t.start_step = start
            for j in mine:
                if j >= len(live):  # idle pad lanes: zero state, zero steps
                    for leaf in leaves:
                        leaf[j - mine.start].zero_()
        self._pipe["assemble_s"] += self._now() - t0
        self._stage_hook("assemble", key=key.key_str(), width=width, seq=seq, live=len(live))
        if not live:
            return None
        n = int(lane_steps.max())

        t0 = self._now()
        with telemetry.span("serve.dispatch", phase="serve", bin=key.key_str(), width=width,
                            live=len(live), steps=n):
            local_steps = lane_steps[mine.start:mine.stop]
            out = tuple(prog.adapter.run(prog, leaves, local_steps, n)) if len(mine) else ()
            flags = self._lane_flags(out, mine, width)
            fetch = self.config.fetch_results
            if fetch is None:
                fetch = not multi
            need_host = fetch or any(t.request.session for t in live)
            host, event = (self._to_host(out) if need_host and out else (None, None))
        self._pipe["dispatch_s"] += self._now() - t0
        self._stage_hook("dispatch", key=key.key_str(), width=width, seq=seq, live=len(live))
        fl = _InFlight(key=key, width=width, split=split, seq=seq, prog=prog, live=live,
                       starts=starts, lane_steps=lane_steps, out=out, flags=flags, host=host,
                       event=event, fetch=fetch, need_host=need_host, anchors=(leaves, out))
        if tracing_on:
            members = [{"trace_id": t.trace.trace_id, "lane": j, "span_id": t.trace.span_id,
                        "hop": t.trace.hop}
                       for j, t in enumerate(live) if t.trace is not None]
            _tracing.emit_tspan("trace.batch",
                                next((t.trace for t in live if t.trace is not None), None),
                                seq=seq, bin=key.key_str(), width=width, members=members)
            flight.trace_inflight_add(m["trace_id"] for m in members)
        self._note_dispatched()
        return fl

    def _resolve_batch(self, fl: _InFlight) -> None:
        """Pipeline stages 3+4 — fetch (the one wait on the device a
        batch) and resolve (verdicts, session saves, tickets, accounting)."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        key, width = fl.key, fl.width
        prog, live, starts = fl.prog, fl.live, fl.starts
        lane_steps = fl.lane_steps
        n = int(lane_steps.max())
        mine = prog.lanes
        tracing_on = bool(self.config.trace_requests)
        if tracing_on:
            tnow = self._now()
            for t in live:
                t.trace_mark("device", tnow)
        t0 = self._now()
        try:
            with telemetry.span("serve.fetch", phase="serve", bin=key.key_str(), width=width):
                if fl.event is not None:
                    fl.event.synchronize()
                elif fl.out and fl.out[0].device.type == "cuda":
                    torch.cuda.current_stream(fl.out[0].device).synchronize()
                finite = self._lane_verdict(fl.flags)
                host = None if fl.host is None else tuple(self._numpy(h) for h in fl.host)
        finally:
            fl.anchors = ()
            self._pipe["fetch_s"] += self._now() - t0
            self._note_fetched()
        if tracing_on:
            tnow = self._now()
            for t in live:
                t.trace_mark("fetch", tnow)
            flight.trace_inflight_drop(t.trace.trace_id for t in live if t.trace is not None)
        self._stage_hook("fetch", key=key.key_str(), width=width, seq=fl.seq, live=len(live))

        t0 = self._now()
        done = 0
        with telemetry.span("serve.resolve", phase="serve", bin=key.key_str(), width=width,
                            live=len(live)):
            for j, t in enumerate(live):
                if not bool(finite[j]):
                    telemetry.record_event("serve.lane.nan", request_id=t.request.request_id,
                                           bin=key.key_str(), width=width, lane=j)
                    self._retry_or_quarantine(t, "non-finite state (NaN/Inf) in lane")
                    continue
                try:
                    lane = (tuple(leaf[j - mine.start] for leaf in host)
                            if host is not None and j in mine else None)
                    if t.request.session and lane is not None:
                        self._save_session(t, lane, prog)
                except ValueError as e:
                    self._fail_ticket(t, str(e))
                    continue
                except Exception as e:  # noqa: BLE001 — tenant isolation
                    self._retry_or_quarantine(t, str(e))
                    continue
                t.steps_run = int(lane_steps[j])
                t._resolve(lane if fl.fetch else None)
                done += 1
                if tracing_on:
                    t.trace_mark("resolve", self._now())
                latency = t.age_s()
                telemetry.record_event(
                    "serve.request.done", request_id=t.request.request_id, bin=key.key_str(),
                    width=width, steps=int(lane_steps[j]), start=starts[j],
                    latency_s=round(latency, 6),
                    deadline_miss=bool(t.request.deadline_s is not None
                                       and latency > t.request.deadline_s),
                    **({"hop": t.trace.hop, "decomp": t.decomp_doc()}
                       if tracing_on and t.trace is not None else {}))
            self.queue.note_completed(done)
            flight.progress(serve_completed=done)
            st = self._stats.get(key)
            if st is None:
                st = self._stats[key] = BinStats(key=key)
            st.note_batch(width, [int(s) for s in lane_steps[:len(live)]], n, split=fl.split)
        self._pipe["resolve_s"] += self._now() - t0
        self._pipe["batches"] += 1
        self._stage_hook("resolve", key=key.key_str(), width=width, seq=fl.seq, live=len(live))

    def _run_segmented_batch(self, key: BinKey, tickets: list[Ticket], width: int,
                             ladder: bool) -> int:
        """The continuous drain's batch executor (docs/SERVING.md
        "Continuous batching"): ONE program of `width` lanes runs the
        whole ticket group as step segments (`steps_bucket // segments`
        steps each). Between segments where no lane finishes the output
        chains straight back in on the device; at a boundary where lanes
        finish, one wait resolves them, and their slots re-seat, on the
        device, from the group's backlog and then the queue's matching
        arrivals. Every lane is bitwise equal to its standalone run: the
        advance freezes a lane at its own count, so chained segments ARE
        its one long run. Single-controller (drain_once gates). Returns
        the completed-ticket count."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.resilience import faults
        from rocm_mpi_tpu_torch.telemetry import flight

        seq = self._batch_faults()
        tracing_on = bool(self.config.trace_requests)
        if tracing_on:
            from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

            tnow = self._now()
            for t in tickets:
                t.trace_mark("queue_wait", tnow)
        prog = self._program_for(key, width, ladder=ladder)
        if tracing_on:
            tnow = self._now()
            for t in tickets:
                t.trace_mark("compile", tnow)
        seg_len = max(1, key.steps_bucket // max(1, int(self.config.segments)))
        fetch = self.config.fetch_results
        if fetch is None:
            fetch = True
        gk = (key, ladder)
        kstr = key.key_str()

        backlog = list(tickets)
        lane_t: list = [None] * width
        starts = [0] * width
        remaining = np.zeros(width, dtype=np.int64)
        leaves = prog.empty_block()
        for leaf in leaves:
            leaf.zero_()
        hold = geom = None
        if ladder:
            hold = torch.ones(leaves[0].shape, dtype=torch.bool, device=leaves[0].device)
            zero_geom = prog.adapter.ladder_geom(prog.model)
            geom = [zero_geom] * width
        padded_cells = math.prod(int(n) for n in key.shape)

        done = swaps_in = swaps_out = segs_run = executed = occ_num = 0
        tenant_nts: list[int] = []
        tenant_cells: list[tuple[int, int]] = []

        def seat(j: int, t: Ticket) -> bool:
            try:
                if ladder:
                    geom[j] = self._ladder_lane(t.request, key, prog, j, leaves, hold)
                    start = 0
                else:
                    start = self._resume_step(t.request, prog) if t.request.resume else 0
                    self._seat(t.request, prog, start, leaves, j)
            except ValueError as e:
                self._fail_ticket(t, str(e))
                return False
            except Exception as e:  # noqa: BLE001 — tenant isolation
                self._retry_or_quarantine(t, str(e))
                return False
            if faults.serving_fault("lane-nan", request=t.ordinal) is not None:
                for leaf in leaves:
                    leaf[j].fill_(float("nan"))
            t.start_step = start
            lane_t[j] = t
            starts[j] = start
            remaining[j] = t.request.nt - start
            if tracing_on:
                t.trace_mark("swap_wait", self._now())
            return True

        def fill(allow_queue: bool) -> int:
            n_seated = 0
            for j in range(width):
                if lane_t[j] is not None:
                    continue
                while lane_t[j] is None and backlog:
                    seat(j, backlog.pop(0))
                while lane_t[j] is None and allow_queue:
                    pulled = self.queue.pop_matching(lambda r: self._group_key(r) == gk,
                                                     max_n=1)
                    if not pulled:
                        break
                    flight.progress(serve_submitted=1)
                    if tracing_on:
                        pulled[0].trace_mark("queue_wait", self._now())
                    tickets.append(pulled[0])
                    seat(j, pulled[0])
                if lane_t[j] is not None:
                    n_seated += 1
            return n_seated

        def roster() -> list[dict]:
            return [{"trace_id": lane_t[j].trace.trace_id, "lane": j}
                    for j in range(width)
                    if lane_t[j] is not None and lane_t[j].trace is not None]

        t0 = self._now()
        with telemetry.span("serve.assemble", phase="serve", bin=kstr, width=width):
            fill(allow_queue=False)
        self._pipe["assemble_s"] += self._now() - t0
        self._stage_hook("assemble", key=kstr, width=width, seq=seq,
                         live=sum(1 for t in lane_t if t is not None))
        seated_ids: set = set()
        if tracing_on:
            members = roster()
            _tracing.emit_tspan("trace.batch",
                                next((lane_t[j].trace for j in range(width)
                                      if lane_t[j] is not None
                                      and lane_t[j].trace is not None), None),
                                seq=seq, bin=kstr, width=width, segmented=True,
                                members=members)
            seated_ids = {m["trace_id"] for m in members}
            flight.trace_inflight_add(seated_ids)

        preempted = False
        chained = False
        while any(t is not None for t in lane_t):
            live_j = [j for j in range(width) if lane_t[j] is not None]
            n_seg = max(1, int(min(seg_len, max(int(remaining[j]) for j in live_j))))
            t0 = self._now()
            if not chained:
                self._note_dispatched()
            with telemetry.span("serve.dispatch", phase="serve", bin=kstr, width=width,
                                live=len(live_j), steps=n_seg):
                steps_np = np.clip(remaining, 0, n_seg).astype(np.int32)
                if ladder:
                    out = tuple(prog.adapter.run_ladder(prog, leaves, hold, geom, steps_np,
                                                        n_seg))
                else:
                    out = tuple(prog.adapter.run(prog, leaves, steps_np, n_seg))
            self._pipe["dispatch_s"] += self._now() - t0
            self._stage_hook("dispatch", key=kstr, width=width, seq=seq, live=len(live_j))
            segs_run += 1
            executed += n_seg
            occ_num += sum(min(int(remaining[j]), n_seg) for j in live_j)
            finishing = [j for j in live_j if int(remaining[j]) <= n_seg]
            for j in live_j:
                remaining[j] = max(0, int(remaining[j]) - n_seg)
            leaves = out
            if not finishing:
                chained = True
                continue
            chained = False

            if tracing_on:
                tnow = self._now()
                for j in finishing:
                    lane_t[j].trace_mark("device", tnow)
            t0 = self._now()
            with telemetry.span("serve.fetch", phase="serve", bin=kstr, width=width):
                host = tuple({j: self._numpy(leaf[j].to("cpu", copy=True)) for j in finishing}
                             for leaf in out)
            self._pipe["fetch_s"] += self._now() - t0
            self._note_fetched()
            if tracing_on:
                tnow = self._now()
                for j in finishing:
                    lane_t[j].trace_mark("fetch", tnow)
            self._stage_hook("fetch", key=kstr, width=width, seq=seq, live=len(live_j))

            t0 = self._now()
            done_here = 0
            with telemetry.span("serve.resolve", phase="serve", bin=kstr, width=width,
                                live=len(finishing)):
                for j in finishing:
                    t = lane_t[j]
                    nt_run = int(t.request.nt - starts[j])
                    tenant_nts.append(nt_run)
                    if ladder:
                        tenant_cells.append((math.prod(int(x) for x in t.request.global_shape),
                                             padded_cells))
                    lane_t[j] = None
                    if not all(np.isfinite(h[j]).all() for h in host):
                        telemetry.record_event("serve.lane.nan",
                                               request_id=t.request.request_id, bin=kstr,
                                               width=width, lane=j)
                        self._retry_or_quarantine(t, "non-finite state (NaN/Inf) in lane")
                        continue
                    try:
                        lane = tuple(h[j] for h in host)
                        if ladder:
                            region = tuple(slice(0, nn) for nn in t.request.global_shape)
                            lane = tuple(l[region] for l in lane)
                        if t.request.session:
                            self._save_session(t, lane, prog)
                    except ValueError as e:
                        self._fail_ticket(t, str(e))
                        continue
                    except Exception as e:  # noqa: BLE001
                        self._retry_or_quarantine(t, str(e))
                        continue
                    t.steps_run = nt_run
                    t._resolve(lane if fetch else None)
                    done_here += 1
                    if tracing_on:
                        t.trace_mark("resolve", self._now())
                    latency = t.age_s()
                    telemetry.record_event(
                        "serve.request.done", request_id=t.request.request_id, bin=kstr,
                        width=width, steps=nt_run, start=starts[j],
                        latency_s=round(latency, 6),
                        deadline_miss=bool(t.request.deadline_s is not None
                                           and latency > t.request.deadline_s),
                        **({"hop": t.trace.hop, "decomp": t.decomp_doc()}
                           if tracing_on and t.trace is not None else {}))
                self.queue.note_completed(done_here)
                flight.progress(serve_completed=done_here)
                done += done_here
                # A preemption notice stops swap-ins at this boundary;
                # seated lanes run to completion.
                if self._preempt_requested():
                    preempted = True
                if not preempted:
                    swaps_in += fill(allow_queue=True)
                if any(t is not None for t in lane_t):
                    swaps_out += len(finishing)
            self._pipe["resolve_s"] += self._now() - t0
            self._stage_hook("resolve", key=kstr, width=width, seq=seq, live=len(finishing))
            if tracing_on:
                members = roster()
                _tracing.emit_tspan("trace.segment",
                                    next((lane_t[j].trace for j in range(width)
                                          if lane_t[j] is not None
                                          and lane_t[j].trace is not None), None),
                                    seq=seq, seg=segs_run, bin=kstr, width=width,
                                    members=members)
                ids_now = {m["trace_id"] for m in members}
                flight.trace_inflight_drop(seated_ids - ids_now)
                flight.trace_inflight_add(ids_now - seated_ids)
                seated_ids = ids_now

        if backlog:
            self.queue.requeue(backlog)
            flight.progress(serve_requeued=len(backlog))

        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = BinStats(key=key)
        st.note_continuous(width, tenant_nts, executed, swaps_in, segs_run,
                           lane_cells=tenant_cells if ladder else None)
        self._pipe["batches"] += 1
        c = self._continuous
        c["batches"] += 1
        c["segments_run"] += segs_run
        c["swaps_in"] += swaps_in
        c["swaps_out"] += swaps_out
        c["occ_num"] += occ_num
        c["occ_den"] += width * executed
        self._drain_swaps += swaps_in
        self._drain_occ[0] += occ_num
        self._drain_occ[1] += width * executed
        self._sync_admission_counters()
        return done

    def _batch_failed(self, key: BinKey, batch_ts: list[Ticket], width: int,
                      e: Exception) -> None:
        """The batch-level failure chokepoint (tenant isolation): fail the
        batch's tickets through the retry budget (a ValueError is
        terminal) and feed the class's circuit breaker."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        telemetry.record_event("serve.batch.error", bin=key.key_str(), width=width,
                               error=str(e))
        flight.trace_inflight_drop(t.trace.trace_id for t in batch_ts if t.trace is not None)
        br = self._breakers[key]
        if br.note_failure(self._circuit, self._drains):
            telemetry.record_event("serve.circuit.open", bin=key.key_str(),
                                   consecutive=br.consecutive)
        for t in batch_ts:
            if not t.done() and t.state == "running":
                if isinstance(e, ValueError):
                    self._fail_ticket(t, str(e))
                else:
                    self._retry_or_quarantine(t, str(e))

    def pipeline_stats(self) -> dict:
        """Lifetime pipeline accounting (the manifest's `pipeline` block):
        per-stage host walls, resolved batches and the device bubble, the
        fraction of the drain-execute wall with no batch in flight."""
        p = self._pipe
        wall = p["wall_s"]
        bubble = max(0.0, 1.0 - p["busy_s"] / wall) if wall > 0 else 0.0
        return {
            "depth": max(1, int(self.config.pipeline_depth)),
            "batches": int(p["batches"]),
            "bubble": round(bubble, 4),
            "assemble_s": round(p["assemble_s"], 6),
            "dispatch_s": round(p["dispatch_s"], 6),
            "fetch_s": round(p["fetch_s"], 6),
            "resolve_s": round(p["resolve_s"], 6),
            "busy_s": round(p["busy_s"], 6),
            "wall_s": round(p["wall_s"], 6),
        }

    def _fail_ticket(self, t: Ticket, error: str) -> None:
        from rocm_mpi_tpu_torch.telemetry import flight

        t._fail(error)
        self.queue.note_completed(0, failed=1)
        flight.progress(serve_failed=1)

    def _retry_or_quarantine(self, t: Ticket, error: str) -> None:
        """Requeue with exponential backoff while the retry budget lasts;
        quarantine a request that exhausts it."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        if t.retries < self._retry.budget:
            t.retries += 1
            self.retries_total += 1
            if self.queue.wall_slo:
                backoff = self._retry.backoff_s(t.retries)
                t.not_before = self._now() + backoff
                t.backoff_pending += backoff
            self.queue.requeue([t], wake=False)
            flight.progress(serve_retries=1)
            telemetry.record_event("serve.request.retry", request_id=t.request.request_id,
                                   retries=t.retries, budget=self._retry.budget, error=error)
            return
        self._quarantine_ticket(t, error)

    def _quarantine_ticket(self, t: Ticket, error: str) -> None:
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        record = quarantine_record(t.request, error, t.retries)
        self._quarantined.append(record)
        if self.config.quarantine_path and self._ledger_writer():
            append_quarantine(self.config.quarantine_path, record)
        t._terminal_fail("quarantined", f"{error} (retry budget {self._retry.budget} exhausted)")
        self.queue.note_quarantined(1)
        flight.progress(serve_quarantined=1)
        telemetry.record_event("serve.request.quarantined", request_id=t.request.request_id,
                               retries=t.retries, error=error)

    def _ledger_writer(self) -> bool:
        """One writer per ledger: rank 0 (every rank reaches the same
        quarantine decision)."""
        return not self._is_multi() or _world()[1] == 0

    def _reject_ticket(self, t: Ticket, error: str) -> None:
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        t._terminal_fail("rejected", error)
        self.queue.note_rejected(1)
        flight.progress(serve_rejected=1)
        telemetry.record_event("serve.request.rejected", request_id=t.request.request_id,
                               error=error)

    def _sync_admission_counters(self) -> None:
        """Mirror the queue's own admission outcomes (submit-time
        rejections, pop-time expiries) into flight and the stream."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import flight

        c = self.queue.counters()
        d_rej = self.queue.rejected_at_submit - self._admission_sync["rejected"]
        if d_rej > 0:
            self._admission_sync["rejected"] = self.queue.rejected_at_submit
            flight.progress(serve_rejected=d_rej, serve_submitted=d_rej)
        for t in self.queue.take_expired():
            telemetry.record_event("serve.request.expired", request_id=t.request.request_id,
                                   deadline_s=t.request.deadline_s, error=t.error)
        d_exp = c["expired"] - self._admission_sync["expired"]
        if d_exp > 0:
            self._admission_sync["expired"] = c["expired"]
            flight.progress(serve_expired=d_exp, serve_submitted=d_exp)

    def _preempt_requested(self) -> bool:
        from rocm_mpi_tpu_torch.resilience import preempt

        return preempt.requested()

    def drain_once(self) -> tuple[int, bool]:
        """One drain pass: pop everything pending, pack, execute. Returns
        (served_count, preempted); on preemption the unserved tickets are
        requeued and dispatch stops at the batch boundary."""
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import compiles, flight

        self._drains += 1
        self._is_multi()
        tickets = self.queue.pop_pending()
        self._sync_admission_counters()
        telemetry.gauge("serve.queue_depth", float(len(tickets)))
        if not tickets:
            if self.queue.depth() == 0:
                self._idle_drains += 1
            return 0, False
        self._idle_drains = 0
        flight.progress(serve_submitted=len(tickets))
        self._compiled_this_drain = False
        self._drain_swaps = 0
        self._drain_occ = [0, 0]

        groups: dict[tuple[BinKey, bool], list[Ticket]] = {}
        bad: list[tuple[Ticket, str]] = []
        for t in tickets:
            try:
                groups.setdefault(self._group_key(t.request), []).append(t)
            except ValueError as e:
                bad.append((t, str(e)))
        for t, msg in bad:
            self._fail_ticket(t, msg)

        served = 0
        pending: list[tuple] = []  # (key, tickets, width, split, ladder, segmented)
        multi = self._is_multi()
        for gk in sorted(groups, key=lambda g: (g[0], g[1])):
            key, ladder = gk
            ts = groups[gk]
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = _Breaker()
            admit = br.admit(self._circuit, self._drains, len(ts))
            if admit < len(ts):
                telemetry.record_event("serve.circuit.reject", bin=key.key_str(),
                                       state=br.state, rejected=len(ts) - admit)
                for t in ts[admit:]:
                    self._reject_ticket(t, f"circuit-open ({key.key_str()})")
                ts = ts[:admit]
            if not ts:
                continue
            segmented = (int(self.config.segments) > 1 or ladder) and not multi
            widths = _bins.plan_batches(len(ts), self.config.max_width, self._floor)
            canonical = widths[0]
            if segmented:
                pending.append((key, ts, canonical, False, ladder, True))
                continue
            i = 0
            for w in widths:
                take = min(w, len(ts) - i)
                pending.append((key, ts[i:i + take], w, w != canonical, ladder, False))
                i += take

        preempted = False
        depth = max(1, int(self.config.pipeline_depth))
        inflight: list[tuple] = []
        exec_t0 = self._now()
        busy0 = self._pipe["busy_s"]

        def _finish(entry) -> None:
            nonlocal served
            fkey, fts, fw, fl = entry
            fbr = self._breakers[fkey]
            try:
                self._resolve_batch(fl)
                served += sum(1 for t in fts if t.state == "done")
                if fbr.note_success():
                    telemetry.record_event("serve.circuit.close", bin=fkey.key_str())
            except Exception as e:  # noqa: BLE001 — tenant isolation
                self._batch_failed(fkey, fts, fw, e)

        for bi, (key, batch_ts, w, split, ladder, segmented) in enumerate(pending):
            if self._preempt_requested():
                preempted = True
                rest = [t for entry in pending[bi:] for t in entry[1]]
                self.queue.requeue(rest)
                flight.progress(serve_requeued=len(rest))
                break
            br = self._breakers[key]
            if segmented:
                while inflight:
                    _finish(inflight.pop(0))
                try:
                    served += self._run_segmented_batch(key, batch_ts, w, ladder)
                    if br.note_success():
                        telemetry.record_event("serve.circuit.close", bin=key.key_str())
                except Exception as e:  # noqa: BLE001 — tenant isolation
                    self._batch_failed(key, batch_ts, w, e)
                continue
            if depth == 1:
                try:
                    self._execute_batch(key, batch_ts, w, split)
                    served += sum(1 for t in batch_ts if t.state == "done")
                    if br.note_success():
                        telemetry.record_event("serve.circuit.close", bin=key.key_str())
                except Exception as e:  # noqa: BLE001 — tenant isolation
                    self._batch_failed(key, batch_ts, w, e)
                continue
            if inflight and any(t.request.resume for t in batch_ts):
                # Session read-after-write barrier: a resume lane reads its
                # session dir, which an in-flight batch's resolve may still
                # be about to write.
                while inflight:
                    _finish(inflight.pop(0))
            try:
                fl = self._prepare_batch(key, batch_ts, w, split)
            except Exception as e:  # noqa: BLE001 — tenant isolation
                self._batch_failed(key, batch_ts, w, e)
                continue
            if fl is None:
                if br.note_success():
                    telemetry.record_event("serve.circuit.close", bin=key.key_str())
                continue
            inflight.append((key, batch_ts, w, fl))
            while len(inflight) >= depth:
                _finish(inflight.pop(0))
        for entry in inflight:
            _finish(entry)

        if pending:
            d_wall = self._now() - exec_t0
            self._pipe["wall_s"] += d_wall
            d_busy = self._pipe["busy_s"] - busy0
            bubble = max(0.0, 1.0 - d_busy / d_wall) if d_wall > 0 else 0.0
            self.last_bubble = bubble
            telemetry.gauge("serve.pipeline_depth", float(depth))
            telemetry.gauge("serve.device_bubble", round(bubble, 4))
        if self._drain_occ[1]:
            telemetry.gauge("serve.occupancy", round(self._drain_occ[0] / self._drain_occ[1], 4))
            telemetry.gauge("serve.swap", float(self._drain_swaps))

        if not preempted and not self._compiled_this_drain and self._programs:
            compiles.mark_steady()
        return served, preempted

    # ---- elasticity (the ElasticPolicy consumer) ------------------------

    def maybe_resize(self) -> bool:
        """Queue-driven elasticity: grow the logical batch rows when the
        queue is deep and the policy and the row budget agree; shrink when
        idle. A resize drops every model and program (they are bound to
        the old rows) and reopens the compile window. One controller
        only, as in the JAX package."""
        policy = self.config.policy
        if policy is None or _world()[0] > 1:
            return False
        budget_fn = self.config.device_budget
        budget = int(budget_fn() if budget_fn else _world()[0])
        depth = self.queue.depth()
        bd = self._batch_dims
        target = kind = None
        if depth >= self.config.grow_queue_depth and policy.wants_grow(
                bd, budget, step=self._drains, last_change_step=self._last_resize_drain):
            grown = policy.grow_target(bd, budget, _bins.pow2_floor)
            if grown > bd:
                target, kind = grown, "grow"
        elif (depth == 0 and self._idle_drains >= self.config.idle_shrink_drains
              and bd > max(1, int(getattr(policy, "min_ranks", 1)))):
            target, kind = max(bd // 2, int(getattr(policy, "min_ranks", 1))), "shrink"
        if target is None or target == bd:
            return False
        self._resize(target, kind, depth=depth, budget=budget)
        return True

    def _resize(self, new_bd: int, kind: str, **attrs) -> None:
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import compiles, flight

        old = self._batch_dims
        self._batch_dims = int(new_bd)
        self._models.clear()
        self._programs.clear()
        compiles.unmark_steady()
        self._last_resize_drain = self._drains
        event = {"event": f"serve.{kind}", "old_batch_dims": old,
                 "new_batch_dims": int(new_bd), "drain": self._drains, **attrs}
        self._elastic.append(event)
        telemetry.record_event(f"serve.{kind}", **event)
        flight.progress(serve_resizes=1)

    # ---- drivers --------------------------------------------------------

    def run_trace(self, requests) -> ServeReport:
        """Serve a request list to completion: submit everything, drain
        until the queue is empty (or a preemption notice stops dispatch),
        return the report."""
        tickets = [self.queue.submit(r) for r in requests]
        report = self._drain_all()
        del tickets
        return report

    def _drain_all(self) -> ServeReport:
        report = ServeReport()
        while True:
            self.maybe_resize()
            served, preempted = self.drain_once()
            report.served += served
            if preempted:
                report.preempted = True
                break
            if self.queue.depth() == 0:
                break
            if self._preempt_requested():
                report.preempted = True
                break
            delay = self.queue.next_ready_delay()
            if delay:
                time.sleep(min(delay, 0.25))
        self._finish_report(report)
        self._assert_accounting()
        return report

    def serve_forever(self, poll_s: float = 0.05,
                      idle_exit_s: float | None = None) -> ServeReport:
        """Daemon drain loop: serve until idle for `idle_exit_s` (None:
        only a preemption notice stops it)."""
        report = ServeReport()
        idle_since = None
        while True:
            if self._preempt_requested():
                report.preempted = True
                break
            self.maybe_resize()
            served, preempted = self.drain_once()
            report.served += served
            if preempted:
                report.preempted = True
                break
            if self.queue.depth() == 0:
                now = self._now()
                if idle_since is None:
                    idle_since = now
                elif idle_exit_s is not None and now - idle_since >= idle_exit_s:
                    break
                time.sleep(poll_s)
            else:
                idle_since = None
                delay = self.queue.next_ready_delay()
                if delay:
                    time.sleep(min(delay, poll_s))
        self._finish_report(report)
        self._assert_accounting()
        return report

    def release(self) -> None:
        """Let every program and model go: their lane blocks, spares, the
        grids' slab buffers and the initial-state leaves return to the
        caching allocator once nothing else holds them. No device sync: at
        a drain boundary nothing is in flight (serving/router.py calls
        this on a dead replica). The queue and the accounting stay."""
        self._programs.clear()
        self._models.clear()

    def _assert_accounting(self) -> None:
        """The drain-time terminal-accounting invariant: at a drain
        boundary nothing is in flight, so every submitted ticket is
        terminally accounted or still queued."""
        problems = self.queue.check_accounting(in_flight=0)
        if problems:
            raise RuntimeError("serve accounting invariant violated at drain: "
                               + "; ".join(problems))

    def _finish_report(self, report: ServeReport) -> None:
        from rocm_mpi_tpu_torch import telemetry
        from rocm_mpi_tpu_torch.telemetry import compiles

        counters = self.queue.counters()
        report.failed = counters["failed"]
        report.requeued = counters["requeued"]
        report.rejected = counters["rejected"]
        report.expired = counters["expired"]
        report.quarantined = counters["quarantined"]
        report.bins = dict(self._stats)
        report.programs = sorted(self._programs)
        report.elastic = list(self._elastic)
        report.pipeline = self.pipeline_stats()
        c = self._continuous
        if c["batches"]:
            report.continuous = {
                "segments": max(1, int(self.config.segments)),
                "batches": c["batches"],
                "segments_run": c["segments_run"],
                "swaps_in": c["swaps_in"],
                "swaps_out": c["swaps_out"],
                "occupancy": round(c["occ_num"] / c["occ_den"], 6) if c["occ_den"] else 0.0,
            }
        snap = compiles.snapshot()
        report.compiles = {"total": snap["totals"]["backend_compiles"],
                           "steady_state": snap["steady_recompiles"]}
        if telemetry.enabled():
            telemetry.gauge("serve.bins", float(len(report.bins)))
            telemetry.gauge("serve.programs", float(report.n_programs))
            if report.bins:
                telemetry.gauge(
                    "serve.occupancy",
                    report.continuous["occupancy"] if report.continuous and c["occ_den"]
                    else min(st.occupancy for st in report.bins.values()))
                telemetry.gauge("serve.padding_waste",
                                max(st.padding_waste for st in report.bins.values()))
            compiles.emit_gauges()

    def write_manifest(self, path) -> dict:
        """Bank the bin manifest sidecar (atomic; schema-checked by
        `telemetry regress --check-schema`)."""
        report = ServeReport()
        self._finish_report(report)
        report.served = self.queue.counters()["completed"]
        report.preempted = self._preempt_requested()
        doc = report.manifest_doc(queue_counters=self.queue.counters())
        _bins.write_manifest(path, doc)
        return doc


def _state_leaves(model) -> tuple:
    """The standard-IC state leaves of a model (diffusion T; the wave's
    U, U⁻): what a laddered lane embeds."""
    state = model.init_state()
    return state[:1] if len(state) == 2 else state[:2]
