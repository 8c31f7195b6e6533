"""Phase-attribution probes — counterpart of rocm_mpi_tpu/telemetry/probes.py:
time the halo, interior and checkpoint phases of the sharded diffusion
step, which runs them fused (one face exchange and one face-form
`fused_step_cm` launch, captured together in the scan driver's graphs)
and so exposes no seam to span at run time.

Differential probing, as in the JAX package: each phase runs on its own
over the model's state, under a span, built from the very pieces the
step composes, so the attribution measures the real kernels:

* `halo.probe` — `iters` calls of `parallel/halo.exchange_faces`, the
  exchange the sharded `perf` and `hide` steps run, stamped with this
  rank's true on-wire bytes and `exchange="faces"`;
* `interior.probe` — `iters` launches of the face form of
  `fused_step_cm` with no faces (every face a domain edge): the step's
  own kernel with no communication to hide behind;
* the checkpoint phase — one save and restore through utils/checkpoint,
  whose own `checkpoint.*` spans carry the attribution.

The halo and interior probes run as the probed run's steps ran them:
where its driver ("scan", or "deep") replays CUDA graphs (the
"scan-graph" route: one CUDA rank, or CUDA ranks over NCCL), their
`iters` calls are captured into one graph, as models/scan.py captures
the step, and the span times one replay; otherwise, the step driver or
gloo ranks, the calls run eagerly. Each span says which in `route`
("graph" or "eager").

Each sharded probe starts with every rank of the grid's group at a
barrier, so it times the phase and not the ranks' arrival skew; every
rank records its own spans, so the summary's per-rank walls and
straggler rows show what skew remains. Probes run serially, so their sum
exceeds a step that overlaps them: the `step` phase is the total, the
probes attribute (`attrs["probe"] = True` on every span).

The probes' and the heartbeat's kernel launches are tooling: they are
taken out of ops/kernels.LAUNCHES again and counted in
`TOOLING_LAUNCHES`, so a run's LAUNCHES is its main path's alone.

This module needs torch; the telemetry package does not import it, so
the read side stays torch-free.
"""

from __future__ import annotations

import collections
import contextlib

from rocm_mpi_tpu_torch.telemetry import events
from rocm_mpi_tpu_torch.telemetry.spans import span

# Kernel launches the probes and the heartbeat made, by kernel.
TOOLING_LAUNCHES: collections.Counter = collections.Counter()


@contextlib.contextmanager
def tooling():
    """Count the kernel launches inside the block in TOOLING_LAUNCHES and
    leave ops/kernels.LAUNCHES as it was before the block."""
    from rocm_mpi_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    try:
        yield
    finally:
        for name, n in LAUNCHES.items():
            if n != before.get(name, 0):
                TOOLING_LAUNCHES[name] += n - before.get(name, 0)
        LAUNCHES.update(before)


def _probe_wire(model) -> str:
    """The face exchange's wire mode: the model's, or full precision for
    a stateful mode (the deep schedules' alone)."""
    from rocm_mpi_tpu_torch.parallel import wire

    mode = model.config.wire_mode
    return "f32" if wire.is_stateful(mode) else mode


def _captured(fn, device):
    """`fn`'s launches captured into one CUDA graph, as models/scan.py's
    ScanLoop captures a step (a side stream, in the thread-local mode
    that NCCL's watchdog needs): returns `replay()`, which adds the
    launches the capture recorded to ops/kernels.LAUNCHES at each replay.
    The capture is a compile of telemetry.compiles ("graph:probe")."""
    import time

    import torch

    from rocm_mpi_tpu_torch.ops.kernels import LAUNCHES
    from rocm_mpi_tpu_torch.telemetry import compiles

    before = dict(LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        with torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
    compiles.record_capture("probe", time.perf_counter() - t0)
    recorded = {k: n - before.get(k, 0) for k, n in LAUNCHES.items() if n != before.get(k, 0)}
    LAUNCHES.update(before)

    def replay():
        graph.replay()
        for k, n in recorded.items():
            LAUNCHES[k] += n

    return replay


def run_diffusion_phase_probes(model, iters: int = 10, checkpoint_dir=None,
                               driver: str | None = None) -> None:
    """Time the halo / interior (and, with `checkpoint_dir`, checkpoint)
    phases of a HeatDiffusion model's sharded step, one span each.
    Every rank of the model's grid calls it. Each probe runs once
    untimed first (the exchange's buffers, the kernel's load), then its
    `iters` calls under its span: one replay of them captured (after an
    untimed one) where the `driver` of the probed run replays CUDA
    graphs, else eagerly. `driver` stamps the loop form of the probed
    run on every span, `route` the form the probe ran."""
    if not events.enabled():
        return
    import torch

    from rocm_mpi_tpu_torch.models.scan import scan_route
    from rocm_mpi_tpu_torch.ops.kernels import fused_step_cm_faces
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.halo import exchange_faces, faces_nbytes
    from rocm_mpi_tpu_torch.utils.metrics import settle

    cfg, grid = model.config, model.grid
    sharded = grid.nprocs > 1
    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    wire_mode = _probe_wire(model)
    graphs = (driver in ("scan", "deep")
              and scan_route(T.device, grid.nprocs, distributed.backend()) == "scan-graph")
    stamp = {"route": "graph" if graphs else "eager"}
    if driver is not None:
        stamp["driver"] = driver
    per_exchange = faces_nbytes(grid.local_shape, T.element_size(), grid, wire_mode)
    edges = (None,) * (2 * T.ndim)
    out = torch.empty_like(T)

    def halo(n=iters):
        for _ in range(n):
            exchange_faces(T, grid, wire_mode=wire_mode)

    def interior(n=iters):
        for _ in range(n):
            fused_step_cm_faces(T, edges, Cm, cfg.spacing, out=out)

    def probe(name, fn, x, **attrs):
        fn(1)
        if graphs:
            fn = _captured(fn, T.device)
            fn()
        settle(x, sharded, grid.group)
        with span(name, probe=True, iters=iters, **attrs, **stamp) as sp:
            fn()
            sp.sync(x)

    with tooling():
        probe("halo.probe", halo, T, phase="halo", bytes=per_exchange * iters,
              exchange="faces", wire=wire_mode)
        probe("interior.probe", interior, out, phase="interior")
        settle(out, sharded, grid.group)
    if checkpoint_dir is not None:
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        try:
            # The spans come from checkpoint.py's own instrumentation; the
            # probe drives one save / validate / restore cycle.
            ckpt.save_state(checkpoint_dir, 0, (T,), grid=grid)
            ckpt.restore_state(checkpoint_dir, 0, (T,), grid=grid)
        except Exception as e:  # noqa: BLE001 — a probe must not kill the run
            events.record_event("probe-failed", error=f"checkpoint: {e!r}")


def make_halo_heartbeat(model):
    """The per-window halo heartbeat of the health plane: `beat(x) -> x`
    runs one face exchange of `x` over the model's grid under a
    `halo.heartbeat` span (phase halo, probe, this rank's true on-wire
    bytes), with no barrier before it: its time includes the wait for
    the slowest neighbour, the arrival skew at a window boundary. Call it
    once during warmup, before compiles.mark_steady (the exchange's
    buffers are made at its first call)."""
    from rocm_mpi_tpu_torch.parallel.halo import exchange_faces, faces_nbytes

    grid = model.grid
    wire_mode = _probe_wire(model)
    itemsize = model.config.torch_dtype.itemsize
    nbytes = faces_nbytes(grid.local_shape, itemsize, grid, wire_mode)

    def beat(x):
        with tooling(), span("halo.heartbeat", phase="halo", probe=True, bytes=nbytes,
                             exchange="faces") as sp:
            exchange_faces(x, grid, wire_mode=wire_mode)
            return sp.sync(x)

    return beat
