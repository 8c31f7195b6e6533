"""What the harness's tests share: the cells of BENCHMARK.json cut to a
size the CPU runs in a second, and the timed path broken underneath."""

from __future__ import annotations

import contextlib
import math
from unittest import mock

from stencil_bench import cell as cell_mod
from stencil_bench import registry

PERF = "diff2d-perf-f64-12288"
HIDE = "diff2d-hide-f64-2x2-12288"


def small_cell(workload: str, *, cells: int = 32, nt: int = 40, grid=None, b_width=None,
               root=None):
    """`workload` with `cells`² a rank, runs of `nt` steps, and (a hide
    cell) the process grid `grid` and frame `b_width`."""
    c = registry.cell(workload, root)
    c.traffic = dict(c.traffic, cells_per_gpu=[cells, cells], trace_skip_runs=1,
                     trace_runs=2)
    config = dict(c.config, nt=nt)
    if grid is not None:
        config["process_grid"] = list(grid)
        c.chips = math.prod(grid)
    if b_width is not None:
        config["b_width"] = list(b_width)
    c.config = config
    return c


def small_hide():
    """The hide cell on two gloo ranks (a 2x1 grid of 32² shards)."""
    return small_cell(HIDE, grid=(2, 1), b_width=(4, 4))


FAULTS = ("unchanged", "half_field", "altered", "no_exchange")


def _broken(fault: str, original):
    """A kernel wrapper that runs `original` and then breaks its output
    where it is produced, over the box it wrote."""

    def wrapper(T, *args, box=None, out=None, **kw):
        out = original(T, *args, box=box, out=out, **kw) if box is not None else \
            original(T, *args, out=out, **kw)
        box = box or tuple((0, n) for n in T.shape)
        (lo0, hi0), (lo1, hi1) = box
        if fault == "unchanged":
            out[lo0:hi0, lo1:hi1] = T[lo0:hi0, lo1:hi1]
        elif fault == "half_field":
            start = max(lo0, T.shape[0] // 2)
            if start < hi0:
                out[start:hi0, lo1:hi1] = T[start:hi0, lo1:hi1]
        elif fault == "altered":
            i, j = T.shape[0] // 3, T.shape[1] // 3
            if lo0 <= i < hi0 and lo1 <= j < hi1:
                out[i, j] *= 1.0 + 1e-6
        return out

    return wrapper


@contextlib.contextmanager
def broken_path(fault: str):
    """The timed path with `fault` planted: a step that returns its state
    unchanged, half the field left unstepped, one cell of every step's
    output altered, or the exchange between ranks left out (the faces
    read as zeros, a domain edge's)."""
    from rocm_mpi_tpu_torch.ops import kernels

    with contextlib.ExitStack() as stack:
        if fault == "no_exchange":
            stack.enter_context(mock.patch(
                "rocm_mpi_tpu_torch.parallel.overlap.exchange_faces",
                lambda u, grid, wire_mode="f32": (None,) * (2 * u.ndim)))
            stack.enter_context(mock.patch(
                "rocm_mpi_tpu_torch.models.diffusion.exchange_faces",
                lambda u, grid, wire_mode="f32": (None,) * (2 * u.ndim)))
        else:
            for name in ("masked_step", "fused_step_cm_faces"):
                stack.enter_context(mock.patch.object(
                    kernels, name, _broken(fault, getattr(kernels, name))))
        yield


def faulty_rank(rank: int, spec: dict, fault: str):
    """cell.run_rank with `fault` planted (picklable by name, for the
    spawned ranks)."""
    with broken_path(fault):
        return cell_mod.run_rank(rank, spec)


def control_rank(rank: int, spec: dict):
    """cell.run_rank with the control in the program's place: the plain
    reference, in float32, advancing the state the window hands it."""
    import torch

    from stencil_bench.reference import diffusion as reference

    def scan_advance_fn(model, variant, nt=None, warmup=None, **kw):
        cfg = model.config
        spacing = tuple(l / n for l, n in zip(cfg.lengths, cfg.global_shape))
        dt = reference.time_step(spacing, cfg.cp0, cfg.lam)

        def advance(T, Cp, n):
            R = reference.run(T, Cp, n, cfg.lam, dt, spacing, dtype=torch.float32)
            T.copy_(R)
            return T

        advance.loop = mock.Mock(route="control", capture_s=0.0)
        return advance, int(nt)

    if math.prod(spec["config"]["process_grid"]) != 1:
        raise ValueError("the control stands in for one rank's whole domain")
    with mock.patch("rocm_mpi_tpu_torch.models.diffusion.HeatDiffusion.scan_advance_fn",
                    scan_advance_fn):
        return cell_mod.run_rank(rank, spec)
