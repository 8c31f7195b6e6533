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
  counts against the capture. No capture error is caught: a capture that
  fails raises, and nothing falls back to the eager loop.
* LAUNCHES counts kernel executions: the warm-up and the captures leave
  it as it was, and each replay adds the launches its graph recorded.

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from rocm_mpi_tpu_torch.ops import kernels

# The most steps one graph holds. With warmup = 0 the JAX chunk is the
# whole run (q = nt), which would capture nt steps a graph. Capturing
# costs the host about 0.1–0.2 ms a step, a replay about 12 µs. On an
# H100 (scripts/torch_scan_cap.py) the steady ms/step of the 252² and
# 128² paths moved at most 2 % with c from 8 to 250, and 10 % for the
# one-kernel perf step, whose 2 µs steps hide a replay only from c ≈ 25;
# a 1000-step warmup-0 run, whose captures fall in its timed window, read
# 0.0027–0.010 ms/step at c = 10 and 0.008–0.058 at c = 250.
GRAPH_STEP_CAP = 16


def scan_chunk(nt: int, warmup: int, chunk: int | None, label: str, config=None) -> int:
    """q of a scan driver: effective_block_steps(nt, warmup, nt − warmup or
    the explicit chunk), warning when an explicit chunk degrades — the JAX
    package's rule and message. With an unset chunk, `config` is None or
    "default"; "auto" needs the tuning cache and raises
    NotImplementedError, anything else ValueError (JAX's auto_scan_chunk
    seam)."""
    from rocm_mpi_tpu_torch.models.diffusion import effective_block_steps
    from rocm_mpi_tpu_torch.ops.multistep import _check_config

    explicit = chunk is not None
    if not explicit:
        # As in JAX, the config is read only for an unset chunk.
        _check_config(config)
    return effective_block_steps(nt, warmup, (nt - warmup) if chunk is None else chunk,
                                 label=label, warn=explicit, stacklevel=4)


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
    """The q-step chunks of one advance over p rotating slots."""

    def __init__(self, step: ScanStep, plan: GraphPlan, route: str):
        if route not in ("scan-graph", "scan-eager", "scan-loop"):
            raise ValueError(f"unknown scan route {route!r}")
        self.step, self.plan, self.route = step, plan, route
        self.slots = None
        self.consts = None
        self.phase = 0
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.recorded: dict[int, dict[str, int]] = {}
        self.capture_s = 0.0

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
        for phase in self.plan.phases:
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

    # ---- stepping -------------------------------------------------------

    def _step_into(self, slots, phase: int) -> None:
        r = roles(slots, phase)
        _write(r[-1], self.step(r[:-1], r[-1], self.consts))

    def _steps(self, slots, phase: int, count: int) -> None:
        p = len(slots)
        for s in range(count):
            self._step_into(slots, (phase + s) % p)

    def _capture(self) -> None:
        """One step on scratch copies, then one graph of c steps per phase
        of the plan, all in one pool, captured on a side stream as
        torch.cuda.graph does (without its garbage collection and cache
        release before every capture); LAUNCHES left as it was.
        `capture_s` is the host time it took."""
        t0 = time.perf_counter()
        launches = kernels.LAUNCHES
        before = dict(launches)
        device = _leaves(self.slots[0])[0].device
        with torch.cuda.device(device):
            scratch = tuple(_map(torch.clone, s) for s in self.slots)
            self._step_into(scratch, 0)
            del scratch
            torch.cuda.synchronize(device)
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(torch.cuda.Stream(device)):
                for phase in self.plan.phases:
                    graph = torch.cuda.CUDAGraph()
                    at = dict(launches)
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        self._steps(self.slots, phase, self.plan.c)
                    finally:
                        graph.capture_end()
                    self.graphs[phase] = graph
                    self.recorded[phase] = {k: launches[k] - at[k] for k in launches
                                            if launches[k] != at[k]}
        launches.update(before)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, state: tuple, consts: tuple, n: int) -> tuple:
        """Advance `state` (the p − 1 slots a step reads, in role order) by
        (n // q)·q steps; returns the new state in the same form."""
        self._bind(tuple(state), tuple(consts))
        schedule = self.plan.schedule(n, self.phase)
        if schedule and self.route == "scan-graph" and not self.graphs:
            self._capture()
        launches = kernels.LAUNCHES
        for phase in schedule:
            if self.route == "scan-graph":
                self.graphs[phase].replay()
                for name, k in self.recorded[phase].items():
                    launches[name] += k
            else:
                self._steps(self.slots, phase, self.plan.c)
        self.phase = (self.phase + len(schedule) * self.plan.c) % self.plan.period
        return roles(self.slots, self.phase)[:-1]


def scan_route(device: torch.device, nprocs: int, backend: str | None) -> str:
    """The route of a scan advance, from the device, the process count and
    the process group's backend alone: CUDA graphs ("scan-graph") on one
    CUDA rank and on CUDA ranks over NCCL; the eager loop ("scan-loop") on
    more than one rank otherwise (gloo, whose exchange waits on the host);
    the eager replay schedule ("scan-eager") on one CPU rank."""
    if device.type == "cuda" and (nprocs == 1 or backend == "nccl"):
        return "scan-graph"
    return "scan-loop" if nprocs > 1 else "scan-eager"
