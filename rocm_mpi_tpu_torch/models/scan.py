"""The scan driver as CUDA graphs — counterpart of the `lax.scan` inside a
`fori_loop` that the JAX package's three `scan_advance_fn`s share
(rocm_mpi_tpu/models/diffusion.py:485, wave.py:497, swe.py:439), and of
their `auto_scan_chunk` seam (diffusion.py:99).

JAX compiles one q-step chunk and runs n // q of them. In eager PyTorch
every step is a Python wrapper call of about 10 µs, which at small fields
is the whole step. Here the chunk is captured into `torch.cuda.CUDAGraph`s
and replayed, so a step costs its kernels' device time:

* The model hands over a step over p state slots that rotate with period
  p: 2 for diffusion (T, spare), 3 for the wave (U, U⁻, spare), 2 for the
  shallow water (the state tuple and a spare tuple). At phase φ the slot
  in role i is `slots[(i − φ) mod p]`; a step reads roles 0 … p − 2,
  writes the new state into role p − 1, and the next phase is φ + 1.
* A graph holds c steps: c is the largest divisor of q at or below
  GRAPH_STEP_CAP. A graph binds pointers, so each starting phase that
  chunks of c steps reach gets its own graph (`graph_plan`): one when p
  divides c, else up to p. All of an advance's graphs share one memory
  pool: no tensor made inside a capture outlives its step (results are
  copied into the slots), so the graphs never hold each other's memory.
* A call advancing n steps replays (n // q)·(q // c) graphs, each chosen
  by the phase, so the floor is JAX's `lax.fori_loop(0, n // q, …)`.
* Capture happens at the first call that replays, after one step on
  scratch copies of the slots (never on the state): that step builds and
  loads the kernels and binds their symbols outside the capture, and on a
  sharded grid sets up NCCL's communicator and point-to-point
  connections and the exchange's persistent buffers. The model's run
  makes that call in its warmup window whenever warmup > 0, where JAX
  compiles. The capture mode is "thread_local": NCCL's watchdog thread
  queries events while a rank captures, which the default global mode
  counts against the capture. A capture that fails raises, naming the
  loop's step and the graph, and nothing falls back to the eager loop.
* LAUNCHES counts kernel executions: the warm-up and the captures leave
  it as it was, and each replay adds the launches its graph recorded.
* Each graph captured is a compile of telemetry.compiles (program
  "graph:<label>", its capture's host seconds); a capture inside a
  steady-state window (a warmup-0 run's timed window) is a recompile.
  The record is made after `capture_end`, on the host alone.

On more than one rank over NCCL the graphs hold each step's halo
exchange too (parallel/halo.py: NCCL point-to-point, ordered on the
stream), and every rank captures and replays the same graphs in the same
order, so each rank's NCCL operations keep the eager loop's order. Ranks
over gloo (several sharing one card, or CPU ranks) wait on the host for
each exchange, which no graph can hold: their chunks run as a plain
eager loop ("scan-loop"). On one CPU rank the same replay schedule runs
eagerly on the same slots, so the tests reach the phase logic
("scan-eager"). `scan_route` decides from the device, the process count
and the backend, before any launch.

Like a donated JAX argument, the state passed in becomes a slot: the
caller must not use it afterwards. A later call that passes back the
state the last call returned runs without a copy; any other state is
copied into the slots.

The multi-step schedules (`sweep_loop`) drive the same loop with a sweep
for a step: one call of the step advances k model steps (a deep-halo
sweep, or one launch of a multi-step kernel), and n, q and c count
sweeps. A slot may carry extra leaves beside the state, the stateful
wire modes' exchange state, which the step reads from its source slot
and writes into its out slot like the state. Such a loop is `exact`: a
call of n sweeps runs all n, JAX's `fori_loop(0, n_steps // k, …)`:
(n // c) graphs of c sweeps, then n mod c graphs of one sweep, each
captured when a call first needs it (after the first capture, no
scratch step). The per-call work (the coefficient's exchange and mask,
the zeroing of the wire state) stays outside the graphs: the model runs
it eagerly into the bound constants and slots before the replays.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Callable

import torch

from rocm_mpi_tpu_torch.ops import kernels
from rocm_mpi_tpu_torch.telemetry import compiles

# The most steps one graph holds. With warmup = 0 the JAX chunk is the
# whole run (q = nt), which would capture nt steps a graph. Capturing
# costs the host about 0.1–0.2 ms a step, a replay about 12 µs. On an
# H100 (scripts/torch_scan_cap.py) the steady ms/step of the 252² and
# 128² paths moved at most 2 % with c from 8 to 250, and 10 % for the
# one-kernel perf step, whose 2 µs steps hide a replay only from c ≈ 25;
# a 1000-step warmup-0 run, whose captures fall in its timed window, read
# 0.0027–0.010 ms/step at c = 10 and 0.008–0.058 at c = 250.
GRAPH_STEP_CAP = 16

# The loops that hold captured graphs. Over NCCL a graph holds work on the
# process group's communicator, and destroy_process_group waits for ever
# while one is alive (four H100 ranks, scripts/torch_twin_scan.py):
# parallel/distributed.finalize releases these first.
_CAPTURED: weakref.WeakSet = weakref.WeakSet()


def release_graphs() -> None:
    """Free the graphs of every live loop (ScanLoop.release)."""
    for loop in list(_CAPTURED):
        loop.release()


def auto_scan_chunk(op: str, grid, dtype, config, device) -> int | None:
    """The scan drivers' `config="auto"` seam, shared by the three models
    (JAX's models/diffusion.py:99-125 auto_scan_chunk): the tuning
    cache's chunk for `op` at this shard and process grid, or None (the
    default whole-window policy) on a miss or a config that is not
    "auto". On a grid of several ranks, rank 0 decides for all
    (tuning/resolve.py), before any capture."""
    from rocm_mpi_tpu_torch.ops.multistep import auto_config

    if not auto_config(config):
        return None
    from rocm_mpi_tpu_torch.tuning import resolve as tuning_resolve

    tuned = tuning_resolve.resolve(op, grid.local_shape, dtype, topology=grid.dims,
                                   grid=grid, device=device)
    if tuned and tuned.get("chunk"):
        return int(tuned["chunk"])
    return None


def scan_chunk(nt: int, warmup: int, chunk: int | None, label: str,
               tuned: int | None = None) -> int:
    """q of a scan driver: effective_block_steps(nt, warmup, the explicit
    chunk, else the tuned one, else nt − warmup), warning when an
    explicit chunk degrades — the JAX package's rule and message. A tuned
    chunk (auto_scan_chunk) is a preference: gcd'd against the windows
    like any chunk, and silent."""
    from rocm_mpi_tpu_torch.models.diffusion import effective_block_steps

    explicit = chunk is not None
    want = chunk if explicit else (nt - warmup) if tuned is None else tuned
    return effective_block_steps(nt, warmup, want, label=label, warn=explicit, stacklevel=4)


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """How a q-step chunk is replayed: `c` steps a graph, one graph for
    each starting phase in `phases` (in the order the chunks reach them)."""

    q: int
    c: int
    period: int
    phases: tuple[int, ...]

    @property
    def graphs(self) -> int:
        return len(self.phases)

    def replays(self, n: int) -> int:
        """Graphs a call of n steps replays: JAX's n // q chunks, q // c
        graphs each."""
        return (int(n) // self.q) * (self.q // self.c)

    def schedule(self, n: int, phase: int = 0) -> list[int]:
        """The starting phase of each replay of a call of n steps from
        `phase`."""
        return [(phase + i * self.c) % self.period for i in range(self.replays(n))]


def graph_plan(q: int, period: int, cap: int | None = None) -> GraphPlan:
    """c = the largest divisor of q at or below `cap` (GRAPH_STEP_CAP by
    default); the phases are the orbit of 0 under + c mod `period`."""
    cap = GRAPH_STEP_CAP if cap is None else cap
    if q < 1 or period < 1 or cap < 1:
        raise ValueError(f"need q, period and cap >= 1, got {q}, {period}, {cap}")
    c = max(d for d in range(1, min(q, cap) + 1) if q % d == 0)
    phases = [0]
    while (nxt := (phases[-1] + c) % period) != 0:
        phases.append(nxt)
    return GraphPlan(q=q, c=c, period=period, phases=tuple(phases))


def roles(slots, phase: int) -> tuple:
    """The slots in role order at `phase`: role i is slots[(i − phase) mod p]."""
    p = len(slots)
    return tuple(slots[(i - phase) % p] for i in range(p))


def _leaves(slot) -> tuple[torch.Tensor, ...]:
    return slot if isinstance(slot, tuple) else (slot,)


def _same(a, b) -> bool:
    return all(x is y for x, y in zip(_leaves(a), _leaves(b)))


def _map(fn, slot):
    return tuple(fn(t) for t in slot) if isinstance(slot, tuple) else fn(slot)


def _write(dst, src) -> None:
    """Copy `src` into the slot `dst`, leaf by leaf, unless a leaf is
    already that buffer."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if not (d.data_ptr() == s.data_ptr() and d.shape == s.shape
                and d.stride() == s.stride()):
            d.copy_(s)


# step(src, out, consts) -> new state: `src` the p − 1 slots a step reads
# (in role order), `out` the slot it may write into, `consts` what the
# advance bound for this call. The result lands in `out` (copied there if
# the step wrote elsewhere).
ScanStep = Callable[..., object]


class ScanLoop:
    """The q-step chunks of one advance over p rotating slots. An `exact`
    loop runs every step a call asks for (see the module docstring)."""

    def __init__(self, step: ScanStep, plan: GraphPlan, route: str, exact: bool = False,
                 label: str = "step"):
        if route not in ("scan-graph", "scan-eager", "scan-loop"):
            raise ValueError(f"unknown scan route {route!r}")
        self.step, self.plan, self.route, self.exact = step, plan, route, exact
        self.label = label
        self.slots = None
        self.consts = None
        self.phase = 0
        # Keyed by (starting phase, steps): the plan's chunks of c steps
        # and, for an exact loop, the one-step graphs of a remainder.
        self.graphs: dict[tuple[int, int], torch.cuda.CUDAGraph] = {}
        self.recorded: dict[tuple[int, int], dict[str, int]] = {}
        self.capture_s = 0.0
        self._pool = None

    # ---- binding --------------------------------------------------------

    def _bind(self, state: tuple, consts) -> None:
        """Make `state` (p − 1 slots) the current roles and `consts` the
        bound constants: adopted at the first call, reused when the caller
        passes back what the last call returned, else copied in."""
        if self.slots is None:
            spare = _map(torch.empty_like, state[0])
            self.slots = (*state, spare)
            self.consts = consts
            return
        for phase in range(self.plan.period):
            if all(_same(s, r) for s, r in zip(state, roles(self.slots, phase))):
                self.phase = phase
                break
        else:
            # Stage through clones: a passed slot may share a buffer with
            # another role.
            staged = [_map(torch.clone, s) for s in state]
            for dst, src in zip(roles(self.slots, self.phase), staged):
                _write(dst, src)
        for dst, src in zip(self.consts, consts):
            if dst is not src and src is not None:
                _write(dst, src)

    def current(self):
        """The slots in the roles a step reads (what the last call
        returned), or None before the first call."""
        return None if self.slots is None else roles(self.slots, self.phase)[:-1]

    # ---- stepping -------------------------------------------------------

    def _step_into(self, slots, phase: int) -> None:
        r = roles(slots, phase)
        _write(r[-1], self.step(r[:-1], r[-1], self.consts))

    def _steps(self, slots, phase: int, count: int) -> None:
        p = len(slots)
        for s in range(count):
            self._step_into(slots, (phase + s) % p)

    def schedule(self, n: int) -> list[tuple[int, int]]:
        """(starting phase, steps) of each replay of a call of n steps from
        the current phase: the plan's floor of chunks, or for an exact
        loop n // c chunks and n mod c single steps."""
        c, p = self.plan.c, self.plan.period
        if self.exact:
            counts = [c] * (int(n) // c) + [1] * (int(n) % c)
        else:
            counts = [c] * self.plan.replays(n)
        out, phase = [], self.phase
        for count in counts:
            out.append((phase, count))
            phase = (phase + count) % p
        return out

    def _capture(self, keys=()) -> None:
        """Capture a graph for each key (phase, steps) not yet held: the
        plan's chunk at each of its phases, and `keys`. The first capture
        runs one step on scratch copies first. All graphs share one pool
        and are captured on a side stream as torch.cuda.graph does
        (without its garbage collection and cache release before every
        capture); LAUNCHES left as it was. `capture_s` adds the host time
        it took."""
        t0 = time.perf_counter()
        launches = kernels.LAUNCHES
        before = dict(launches)
        device = _leaves(self.slots[0])[0].device
        wanted = [(phase, self.plan.c) for phase in self.plan.phases] + list(keys)
        with torch.cuda.device(device):
            if self._pool is None:
                scratch = tuple(_map(torch.clone, s) for s in self.slots)
                self._step_into(scratch, 0)
                del scratch
                torch.cuda.synchronize(device)
                self._pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(torch.cuda.Stream(device)):
                for key in dict.fromkeys(wanted):
                    if key in self.graphs:
                        continue
                    graph = torch.cuda.CUDAGraph()
                    at = dict(launches)
                    t_graph = time.perf_counter()
                    try:
                        graph.capture_begin(pool=self._pool,
                                            capture_error_mode="thread_local")
                        try:
                            self._steps(self.slots, *key)
                        finally:
                            graph.capture_end()
                    except Exception as err:
                        raise RuntimeError(
                            f"CUDA graph capture of {key[1]} x {self.label} (phase "
                            f"{key[0]}) failed; the loop does not fall back to eager "
                            f"steps: {err}") from err
                    self.graphs[key] = graph
                    _CAPTURED.add(self)
                    compiles.record_capture(self.label, time.perf_counter() - t_graph)
                    self.recorded[key] = {k: launches[k] - at[k] for k in launches
                                          if launches[k] != at[k]}
        launches.update(before)
        self.capture_s += time.perf_counter() - t0

    def release(self) -> None:
        """Free the captured graphs and their pool; a later call captures
        anew."""
        self.graphs.clear()
        self.recorded.clear()
        self._pool = None
        _CAPTURED.discard(self)

    def __call__(self, state: tuple, consts: tuple, n: int) -> tuple:
        """Advance `state` (the p − 1 slots a step reads, in role order) by
        (n // q)·q steps, or n for an exact loop; returns the new state in
        the same form."""
        self._bind(tuple(state), tuple(consts))
        schedule = self.schedule(n)
        graphs = self.route == "scan-graph"
        if graphs and any(key not in self.graphs for key in schedule):
            self._capture(schedule)
        launches = kernels.LAUNCHES
        for key in schedule:
            if graphs:
                self.graphs[key].replay()
                for name, k in self.recorded[key].items():
                    launches[name] += k
            else:
                self._steps(self.slots, *key)
        if schedule:
            last, count = schedule[-1]
            self.phase = (last + count) % self.plan.period
        return roles(self.slots, self.phase)[:-1]


def sweep_loop(sweep: ScanStep, sweeps: int, device: torch.device, nprocs: int,
               label: str, period: int = 2) -> ScanLoop:
    """The exact loop of a multi-step schedule: `sweep(src, out, consts)`
    advances k model steps, `sweeps` is q counted in sweeps (the sweeps
    of gcd(warmup, nt − warmup)), and the route is scan_route's. A sweep
    replaces the whole state, so the slots rotate with period 2."""
    from rocm_mpi_tpu_torch.parallel import distributed

    return ScanLoop(sweep, graph_plan(max(1, int(sweeps)), period),
                    scan_route(device, nprocs, distributed.backend()), exact=True,
                    label=label)


def window_sweeps(nt: int, warmup: int, k: int) -> int:
    """q of a schedule's sweep loop, in sweeps of k steps: the sweeps of
    gcd(warmup, nt − warmup), which k divides (effective_block_steps)."""
    return max(1, math.gcd(int(warmup), int(nt) - int(warmup)) // int(k))


def check_sweeps(n_steps, k: int) -> int:
    """The sweeps of a call of `n_steps`, which must be a multiple of k."""
    n_steps = int(n_steps)
    if n_steps % k != 0:
        raise ValueError(f"n_steps {n_steps} must be a multiple of the depth {k}")
    return n_steps // k


def fresh_extras(loop: ScanLoop, lead: int, make: Callable) -> tuple:
    """The extra leaves a call starts from, zero (the stateful wire
    modes' first-sweep contract): `make()` at the loop's first call, then
    the current slot's leaves after its `lead` state leaves, zeroed
    eagerly, before any replay."""
    current = loop.current()
    if current is None:
        return tuple(make())
    extras = tuple(current[0][lead:])
    for t in extras:
        t.zero_()
    return extras


def padded_slot(loop: ScanLoop, state, k: int, init_wire: Callable | None = None) -> tuple:
    """The slot a deep-halo call starts from: the loop's k-padded blocks
    with the fields of `state` placed in their cores (the current slot's
    blocks, ghosts as the last sweep left them, or zero blocks at the
    first call), then, for a stateful wire mode, the zero wire state
    (`fresh_extras` of `init_wire(dtype, device)`)."""
    from rocm_mpi_tpu_torch.parallel.halo import place_core

    current = loop.current()
    if current is None:
        blocks = tuple(torch.zeros(tuple(n + 2 * k for n in t.shape), dtype=t.dtype,
                                   device=t.device) for t in state)
    else:
        blocks = tuple(current[0][:len(state)])
    for t, b in zip(state, blocks):
        place_core(t, k, out=b)
    if init_wire is None:
        return blocks
    like = state[0]
    return (*blocks, *fresh_extras(loop, len(state),
                                   lambda: init_wire(like.dtype, like.device)))


def loop_record(loop: ScanLoop) -> dict:
    """The run-result fields of a sweep or scan loop: its route and the
    host ms its captures took."""
    return {"loop_route": loop.route, "capture_ms": loop.capture_s * 1e3}


def scan_route(device: torch.device, nprocs: int, backend: str | None) -> str:
    """The route of a scan advance, from the device, the process count and
    the process group's backend alone: CUDA graphs ("scan-graph") on one
    CUDA rank and on CUDA ranks over NCCL; the eager loop ("scan-loop") on
    more than one rank otherwise (gloo, whose exchange waits on the host);
    the eager replay schedule ("scan-eager") on one CPU rank."""
    if device.type == "cuda" and (nprocs == 1 or backend == "nccl"):
        return "scan-graph"
    return "scan-loop" if nprocs > 1 else "scan-eager"
