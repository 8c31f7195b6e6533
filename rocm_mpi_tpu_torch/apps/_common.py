"""Shared CLI driver of the port's apps — counterpart of apps/_common.py:
init grid, IC, timed loop, T_eff/Gpts printout.

Several GPUs run under torchrun, one rank per GPU:

    torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf

Every rate printed on a GPU carries the card's name and power limit;
a CPU run says that it measured the plain versions on the host.

Every app takes the JAX apps' observability flags: `--telemetry DIR`
(the per-rank telemetry streams, merged into DIR/telemetry-summary.json
and telemetry-trace.json at the end; RMT_TELEMETRY_DIR is the env
spelling), `--health` (the flight recorder's heartbeat sidecars and the
SIGUSR2 post-mortem hook; RMT_HEALTH) and `--profile DIR`
(torch.profiler over the run, a Chrome trace per rank in DIR).

Every app that takes `--checkpoint` takes the JAX apps' resilience flags:
`--retries N` (the checkpointed run under resilience.run_supervised) and
`--inject-fault SPEC` (resilience/faults.py; RMT_INJECT_FAULT is the env
spelling). Setup installs the fault plan before the process group forms
and arms the SIGTERM grace handler when RMT_PREEMPT_GRACE_S is set; an
app leaves through distributed.finalize however it ends, a preemption's
exit 75 included.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import shutil
import subprocess
import sys
import traceback

from rocm_mpi_tpu_torch.parallel.wire import WIRE_MODES

# The apps' pictures land here, as the JAX apps' do (--vis).
OUTPUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "output"


def base_parser(description: str, *, nx: int, ny: int, nt: int, dtype: str,
                vis: bool = False):
    """The options every app of the port shares: grid, steps, dtype,
    process grid, device, the per-step variants' driver and the picture
    (--vis/--no-vis, default `vis`; --vis-shards)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--nx", type=int, default=nx, help="global grid points, x")
    p.add_argument("--ny", type=int, default=ny, help="global grid points, y")
    p.add_argument("--fact", type=int, default=0,
                   help="if set, every grid axis becomes fact*1024 (the reference perf "
                   "app's 'fact' knob; in 3D this includes nz)")
    p.add_argument("--nt", type=int, default=nt, help="time steps")
    p.add_argument("--warmup", type=int, default=10, help="untimed steps")
    p.add_argument("--dtype", default=dtype, choices=["f32", "f64", "bf16"])
    p.add_argument("--dims", default=None,
                   help="process grid, e.g. 2,2 (default: auto near-square)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand kernels; cpu their plain versions")
    p.add_argument("--driver", default="scan", choices=["step", "scan"],
                   help="loop form of the per-step variants (default: scan, the q-step "
                   "chunks replayed as CUDA graphs on one GPU; step: one Python step "
                   "call after another). Bitwise the same result. The schedules "
                   "(--deep, --vmem) do not take it: on a CUDA rank they always run as "
                   "one captured program, CUDA graphs of their sweeps")
    p.add_argument("--wire-mode", default="f32", choices=list(WIRE_MODES),
                   help="on-wire halo slab precision (parallel/wire.py; default f32, the "
                   "exchange as it is; bf16 halves the wire; int8/int8_delta quantize "
                   "with error feedback and need --deep)")
    add_vis_flags(p, vis)
    add_telemetry_flag(p)
    add_health_flag(p)
    add_profile_flag(p)
    return p


# ---------------------------------------------------------------------------
# The picture: --vis, --no-vis, --vis-shards (the JAX apps' flags)
# ---------------------------------------------------------------------------


def add_vis_flags(p, default: bool) -> None:
    vis = p.add_mutually_exclusive_group()
    vis.add_argument("--vis", dest="do_vis", action="store_true", default=default,
                     help="render the gathered final field as a heatmap PNG into output/ "
                     "(Temp_<variant>_<nprocs>_<nx>_<ny>.png; 3D: its mid-z slice; needs "
                     f"matplotlib; default {'on' if default else 'off'})")
    vis.add_argument("--no-vis", dest="do_vis", action="store_false",
                     help="no heatmap (what a machine without matplotlib needs)")
    p.add_argument("--vis-shards", action="store_true",
                   help="also render one panel per rank's shard (the reference's "
                   "poc_rocmaware.png-style halo-exchange proof; 2D + --vis only)")


def check_vis(args) -> None:
    """Before the run: an app whose picture is on refuses (exit 2) where
    matplotlib is missing, rather than skip the picture in silence."""
    from rocm_mpi_tpu_torch.utils import viz

    if getattr(args, "do_vis", False) and not viz.available():
        print("--vis needs matplotlib, which this Python lacks: pass --no-vis to run "
              "without the picture", file=sys.stderr, flush=True)
        raise SystemExit(2)


def finish_field(args, field, grid, label: str, log0, signed: bool = False) -> None:
    """The end of a run's field: gather it to rank 0 once (every rank takes
    part) when --save-field or --vis wants it, np.save it there, and render
    its heatmap (and with --vis-shards the per-shard panels; `signed` for
    fields that oscillate about 0) into OUTPUT_DIR."""
    if not (args.save_field or args.do_vis):
        return
    import numpy as np

    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    full = gather_to_host0(field, grid)
    if full is None:
        return
    if args.save_field:
        out = pathlib.Path(args.save_field)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, full)
        log0(f"wrote {args.save_field}")
    if args.do_vis:
        from rocm_mpi_tpu_torch.utils import viz

        path = OUTPUT_DIR / viz.artifact_name(label, grid.nprocs, grid.global_shape)
        viz.save_heatmap(full, path, title=f"{label} nt={args.nt} mesh={grid.dims}")
        log0(f"wrote {path}")
        if args.vis_shards and grid.ndim == 2:
            log0(f"wrote {viz.save_shard_panels_artifact(full, grid, label, OUTPUT_DIR, signed)}")


# ---------------------------------------------------------------------------
# Observability: --telemetry, --health, --profile (the JAX apps' flags)
# ---------------------------------------------------------------------------


def add_telemetry_flag(p) -> None:
    p.add_argument("--telemetry", default=None, metavar="DIR",
                   help="collect structured telemetry (spans/counters/events) into DIR as "
                   "telemetry-rank{k}.jsonl, merged at the end into telemetry-summary.json "
                   "and telemetry-trace.json; inspect with `python -m "
                   "rocm_mpi_tpu_torch.telemetry summarize DIR` (RMT_TELEMETRY_DIR is the "
                   "env spelling the launcher forwards)")


def add_profile_flag(p) -> None:
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the run with torch.profiler into DIR/trace-rank<r>.json "
                   "(Chrome trace; on the card it fails when the profiler saw no CUDA "
                   "activity)")


def add_health_flag(p) -> None:
    p.add_argument("--health", action="store_true",
                   help="run the per-rank flight recorder: progress counters and a "
                   "heartbeat-rank{k}.json sidecar, and a SIGUSR2 faulthandler "
                   "post-mortem hook; needs a telemetry directory (--telemetry DIR or the "
                   "launcher env) for the sidecars (RMT_HEALTH=1 is the env spelling)")


def setup_observability(args, rank: int) -> None:
    """The JAX apps' setup_telemetry and setup_health, after the
    process group is up (the rank stamp is the real rank): --telemetry
    DIR configures collection (env-configured ranks need no call), and
    --health or RMT_HEALTH arms the flight recorder and the SIGUSR2
    post-mortem hook. A run with telemetry on counts its compiles
    (telemetry.compiles)."""
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.telemetry import compiles, flight

    if args.telemetry:
        telemetry.configure(directory=args.telemetry, enabled=True, rank=rank)
    try:
        if args.health:
            flight.enable(rank=rank)
            armed = True
        else:
            armed = flight.enable_from_env()
    except ValueError as e:
        # Both spellings fail the same clean way without a sidecar directory.
        raise SystemExit(f"--health / RMT_HEALTH: {e}") from None
    if armed:
        flight.install_postmortem_handler()
    if telemetry.enabled():
        compiles.install()


def emit_run_gauges(result, variant: str, driver: str | None = None,
                    wire: str | None = None) -> None:
    """Bank the run's headline rates (`run.gpts`, `run.t_eff_gbs`),
    stamped with the variant, the loop form and the wire mode, as the
    JAX apps do; nothing when collection is off or no step was timed."""
    from rocm_mpi_tpu_torch import telemetry

    if not telemetry.enabled() or not result.nt or not result.wtime:
        return
    attrs = {"variant": variant}
    if driver is not None:
        attrs["driver"] = driver
    if wire is not None:
        attrs["wire"] = wire
    telemetry.gauge("run.gpts", result.gpts, **attrs)
    telemetry.gauge("run.t_eff_gbs", result.t_eff, **attrs)


def finish_observability(log0) -> dict | None:
    """End of an app: bank the compile gauges, flush the heartbeat, and
    (rank 0, after every rank is past its last record) merge the
    telemetry directory's streams into telemetry-summary.json and
    telemetry-trace.json. Returns the summary on rank 0."""
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.telemetry import compiles, events, flight

    if not telemetry.enabled():
        return None
    compiles.emit_gauges()
    flight.flush()
    directory = events.directory()
    if directory is None:
        return None
    distributed.barrier()
    if distributed.rank() != 0:
        return None
    from rocm_mpi_tpu_torch.parallel.launcher import merge_telemetry

    summary = merge_telemetry(directory)
    log0(f"telemetry: merged ranks {summary['ranks']} ({summary['records']} records) into "
         f"{directory}/telemetry-summary.json and telemetry-trace.json")
    return summary


class _Profile:
    """torch.profiler over a window, exported as a Chrome trace to
    DIR/trace-rank<r>.json. On a CUDA device the window must show CUDA
    activity: a trace without it raises and is not written."""

    def __init__(self, directory, device, rank: int):
        self.path = pathlib.Path(directory) / f"trace-rank{rank}.json"
        self.cuda = device.type == "cuda"
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        if self.cuda and not device_events(self.prof):
            raise RuntimeError(f"--profile: torch.profiler recorded no CUDA activity on the "
                               f"card; no trace written to {self.path}")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        return False


def device_events(prof) -> list:
    """The device-side events of a finished torch.profiler run
    (kernels, copies, NCCL) with their device time, from key_averages()."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and not e.is_user_annotation
            and e.self_device_time_total > 0]


def profile_context(args, device, rank: int):
    """The one --profile idiom: torch.profiler over the run when
    --profile DIR was given, a no-op otherwise."""
    import contextlib

    if args.profile:
        return _Profile(args.profile, device, rank)
    return contextlib.nullcontext()


def positive_int(v):
    """argparse type: int >= 1."""
    i = int(v)
    if i < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return i


def nonneg_int(v):
    """argparse type: int >= 0."""
    i = int(v)
    if i < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {v}")
    return i


def grid_shape(args, ndim: int = 2) -> tuple[int, ...]:
    """The global shape the options ask for: (nx, ny[, nz]), or fact·1024
    on every axis when --fact is set. Pass the ndim the options imply
    (3 when --nz is set): the default keeps (nx, ny)."""
    shape = (args.nx, args.ny, getattr(args, "nz", 0))[:ndim]
    return tuple(args.fact * 1024 for _ in shape) if args.fact else shape


def schedule_note(result) -> str:
    """A schedule's routes for its result line: the local route, and the
    loop that ran its sweeps with its captures' host ms."""
    return (f"route {result.route}, loop route {result.loop_route} (capture "
            f"{result.capture_ms:.1f} ms)")


def driver_note(args, result) -> str:
    """The driver a per-step run took, for its result line: the step
    driver, or the scan driver with its route and q."""
    if args.driver == "step":
        return "driver step"
    return f"driver scan (route {result.route}, q {result.k})"


def make_parser(variant: str, *, nx: int, ny: int, nt: int, dtype: str, nz: int = 0,
                vis: bool = False):
    p = base_parser(f"{'3D' if nz else '2D'} heat diffusion — {variant} variant", nx=nx,
                    ny=ny, nt=nt, dtype=dtype, vis=vis)
    p.add_argument("--nz", type=int, default=nz, help="global grid points, z (0 = 2D)")
    p.add_argument("--deep", type=int, default=0, metavar="K",
                   help="use deep-halo sweeps: exchange width-K ghosts every K steps "
                   "instead of width-1 every step (parallel.deep_halo); K must divide "
                   "both --warmup and nt - warmup, or it degrades to their gcd")
    p.add_argument("--transport", default=None, choices=["ici", "host"],
                   help="halo transport: the device exchange, or host staging (the "
                   "reference's IGG_ROCMAWARE_MPI=1/0; only variant 'shard' runs the "
                   "host-staged oracle, the others warn). Default: $RMT_HALO_TRANSPORT "
                   "or ici")
    if variant == "hide":
        p.add_argument("--b-width", default="32,4",
                       help="boundary frame width, e.g. 32,4 (hide.jl:42; clamped to "
                       "half the shard)")
    add_save_field_flag(p)
    add_checkpoint_flags(p)
    return p


def add_save_field_flag(p) -> None:
    p.add_argument("--save-field", default=None, metavar="PATH.npy",
                   help="gather the final field to rank 0 and save it as .npy (bf16 as "
                   "float32), to compare the fields of two apps or runs")


# ---------------------------------------------------------------------------
# Checkpoint mode and the resilience plane (counterpart of apps/_common.py)
# ---------------------------------------------------------------------------


def add_checkpoint_flags(p) -> None:
    """The shared --checkpoint/--ckpt-every/--resume/--retries/
    --inject-fault block (utils/checkpoint.py and resilience/)."""
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="checkpoint the run state into DIR every --ckpt-every steps "
                   "(each rank saves its shards; utils/checkpoint.py)")
    p.add_argument("--ckpt-every", type=positive_int, default=None, metavar="N",
                   help="checkpoint interval in steps (default: nt/4; rounded up to a "
                   "multiple of --deep's k)")
    p.add_argument("--resume", action="store_true",
                   help="with --checkpoint: continue from the latest VALID saved step in "
                   "DIR (corrupt or truncated checkpoints are skipped) instead of the "
                   "initial condition")
    p.add_argument("--retries", type=nonneg_int, default=0, metavar="N",
                   help="with --checkpoint: supervise the run — on a crash or a CUDA or "
                   "storage error, restore the latest valid checkpoint and retry with "
                   "exponential backoff, up to N restarts (resilience.run_supervised)")
    p.add_argument("--inject-fault", default=None, metavar="SPEC",
                   help="deterministic fault injection for drills and tests, e.g. "
                   "'crash@step=12' or 'truncate-latest@segment=2' "
                   "(rocm_mpi_tpu_torch/resilience/faults.py has the grammar; "
                   "RMT_INJECT_FAULT is the env spelling the launcher forwards)")


def setup_resilience(args) -> None:
    """Before the process group forms: install --inject-fault's plan (the
    "init" site fires while the group forms), and arm the SIGTERM
    grace-deadline handler when the launcher says so
    (RMT_PREEMPT_GRACE_S; resilience/preempt.py)."""
    from rocm_mpi_tpu_torch.resilience import faults, preempt

    if getattr(args, "inject_fault", None):
        faults.install(args.inject_fault)
    preempt.install_from_env()


@contextlib.contextmanager
def finalized():
    """Run an app's body so that a SystemExit out of it (a preemption's
    code 75, which every rank of the grid takes at the same boundary)
    leaves through distributed.finalize, which releases the captured
    graphs before the process group (a group destroyed under live graphs
    that hold NCCL work waits for ever).

    Any other exception (a crash after the retries ran out) may strike
    one rank while its peers wait on it in NCCL, and there finalize
    never returns: a crash drill on four H100s held the crashed rank in
    it until its launch was cut, with no first failure for the launcher
    to act on. A rank of several over NCCL therefore prints the
    traceback and exits 1 at once, without tearing anything down, as a
    killed rank would; the launcher's first failure and peer-grace kill
    take it from there. Elsewhere (one rank, gloo) the exception leaves
    through finalize too."""
    from rocm_mpi_tpu_torch.parallel import distributed

    try:
        yield
    except SystemExit:
        distributed.finalize()
        raise
    except BaseException:
        if distributed.world_size() > 1 and distributed.backend() == "nccl":
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        distributed.finalize()
        raise


def checkpoint_interval(args, quantum: int = 1, log0=None) -> int:
    """--ckpt-every (default nt/4) rounded up to a multiple of the
    schedule's step quantum, saying so through `log0`."""
    every = args.ckpt_every or max(args.nt // 4, 1)
    if every % quantum:
        rounded = (every // quantum + 1) * quantum
        if log0 is not None:
            log0(f"--ckpt-every {every} rounded to {rounded} (the schedule advances "
                 f"{quantum} steps at a time)")
        every = rounded
    return every


def per_step_checkpoint_advance(args, model, variant: str):
    """Checkpoint mode's per-step advance, which must run exactly the
    steps of every segment: under --driver scan the scan driver with
    exact counts, its graphs planned for one segment (q = the interval)
    and captured once for the whole run; under --driver step the step
    loop."""
    if args.driver == "scan":
        advance, _ = model.scan_advance_fn(variant, nt=checkpoint_interval(args), warmup=0,
                                           exact=True)
        return advance
    return model.advance_fn(variant)


def checkpoint_schedule(args, model, make_per_step):
    """The one chooser of checkpoint mode's schedule: (make_advance,
    quantum). With --deep the model's deep advance over the whole run
    (warmup 0), whose executed k is the quantum; otherwise the per-step
    advance with quantum 1."""
    if getattr(args, "deep", 0):
        advance, k = model.deep_advance_fn(block_steps=args.deep, nt=args.nt, warmup=0)
        return (lambda: advance), k
    return make_per_step, 1


def checkpointed_run(args, advance, init_state, log0, quantum: int = 1, grid=None):
    """--checkpoint mode: the segmented advance with saves between
    segments (utils/checkpoint.run_segmented); --resume restores the
    latest valid step first. `advance(state, n) -> state` runs exactly
    n steps; its `loop` attribute, when set, is the loop whose graphs the
    run captured. Returns (final state, steps run here, wall seconds of
    the segmented loop, saves included).

    `--retries N` > 0 runs the segmented loop under
    resilience.run_supervised: it owns the restore (a checkpoint saved on
    another process grid included), the nothing-to-run case and the
    restarts; the app resolves the start step only for the quantum check
    and the count of steps run."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt
    from rocm_mpi_tpu_torch.utils.metrics import Timer

    every = checkpoint_interval(args, quantum, log0)
    supervised = getattr(args, "retries", 0) > 0
    start = 0
    state = init_state
    if args.resume:
        latest = ckpt.latest_valid_step(args.checkpoint, log=log0, grid=grid)
        if latest is not None:
            start = latest
            if not supervised:
                log0(f"--resume: restoring step {latest} from {args.checkpoint}")
                state = ckpt.restore_state(args.checkpoint, latest, init_state, grid=grid,
                                           log=log0)
        else:
            log0(f"--resume: no checkpoint under {args.checkpoint}; starting from the "
                 "initial condition")
    if start % quantum or (args.nt - start) % quantum:
        log0(f"--resume: checkpoint step {start} / window {args.nt - start} is not a "
             f"multiple of the schedule's step quantum {quantum} (was this checkpoint "
             "written by a different schedule or nt?); resume with the schedule that "
             "wrote it or adjust --nt")
        raise SystemExit(2)
    if start >= args.nt and not supervised:
        log0(f"--resume: checkpoint already at step {start} >= nt={args.nt}; nothing to run")
        return state, 0, 0.0
    lead = ckpt.tree_leaves(state)[0]
    timer = Timer()
    timer.tic(lead)
    if supervised:
        from rocm_mpi_tpu_torch.resilience import run_supervised

        log0(f"supervised run: up to {args.retries} restart(s), "
             f"resume={'on' if args.resume else 'off'}")
        state = run_supervised(advance, init_state, args.nt, args.checkpoint, every,
                               max_retries=args.retries, resume=args.resume, log=log0,
                               grid=grid)
    else:
        state = ckpt.run_segmented(advance, state, args.nt, args.checkpoint, every,
                                   start_step=start, grid=grid, log=log0)
    wtime = timer.toc(ckpt.tree_leaves(state)[0])
    if start >= args.nt:
        log0(f"--resume: checkpoint already at step {start} >= nt={args.nt}; nothing to run")
        return state, 0, 0.0
    log0(f"checkpointed {start}→{args.nt} every {every} steps into {args.checkpoint}")
    loop = getattr(advance, "loop", None)
    if loop is not None:
        log0(f"checkpoint mode: loop route {loop.route}, {len(loop.graphs)} graph(s) "
             "captured for the whole run")
    return state, args.nt - start, wtime


def make_checkpoint_runner(args, log0, advance_state, make_result, quantum: int = 1,
                           grid=None):
    """The checkpoint-mode runner the apps share: `advance_state() ->
    (advance, init_state)` builds the segmented advance and
    `make_result(state, ran, wtime)` the workload's run result with
    nt=ran, warmup=0 (nt 0: the resume was already complete)."""

    def runner():
        adv, init_state = advance_state()
        state, ran, wtime = checkpointed_run(args, adv, init_state, log0, quantum=quantum,
                                             grid=grid)
        return make_result(state, ran, wtime)

    return runner


def report_checkpointed_line(result, args, log0, where: str = "") -> None:
    """The checkpoint-mode 'Executed …' line: rates only when steps ran."""
    if result.nt == 0:
        log0("0 steps run (checkpoint already complete); state restored")
        return
    on = f" on {where}" if where else ""
    log0(f"Executed {result.nt} steps in = {result.wtime:.3e} sec (@ T_eff = "
         f"{result.t_eff:.2f} GB/s aggregate, {result.gpts:.4f} Gpts/s){on}")
    log0("(durability mode: wall time includes checkpoint saves — not the benchmark "
         "protocol)")


def parse_ints(text: str | None) -> tuple[int, ...] | None:
    """"2,2" -> (2, 2); None stays None."""
    return tuple(int(d) for d in text.split(",")) if text else None


def where_line(device) -> str:
    """The device a run measured: the card with nvidia-smi's name and power
    limit, or the host CPU (plain versions, never a GPU measurement)."""
    import torch

    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {card_line()})"
    return "the host CPU (plain PyTorch versions, not a GPU measurement)"


def global_max(x) -> float:
    """max over every rank's shard of `x`, on every rank."""
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed

    peak = x.float().max().reshape(1)
    if distributed.is_distributed():
        if distributed.staged(peak):
            peak = peak.cpu()  # gloo carries CPU tensors only
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return float(peak)


def global_sum(x) -> float:
    """Σ over every rank's shard of `x`, taken in f64, on every rank."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed

    total = x.sum(dtype=torch.float64).reshape(1)
    if distributed.is_distributed():
        if distributed.staged(total):
            total = total.cpu()  # gloo carries CPU tensors only
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return float(total)


def card_line() -> str | None:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_app(variant: str, args) -> int:
    """The diffusion apps' main: the resilience plane set up first, then
    the run, which leaves through distributed.finalize however it ends."""
    check_vis(args)
    setup_resilience(args)
    with finalized():
        return _run_app(variant, args)


def _run_app(variant: str, args) -> int:
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.models.diffusion import RunResult
    from rocm_mpi_tpu_torch.parallel import distributed

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me = distributed.rank()
    setup_observability(args, me)

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    kwargs = {"b_width": parse_ints(args.b_width)} if variant == "hide" else {}
    if args.transport:
        kwargs["halo_transport"] = args.transport
    shape = grid_shape(args, 3 if args.nz else 2)
    cfg = DiffusionConfig(
        global_shape=shape, lengths=(10.0,) * len(shape), nt=args.nt,
        warmup=args.warmup, dtype=args.dtype, dims=parse_ints(args.dims),
        wire_mode=args.wire_mode, **kwargs,
    )
    model = HeatDiffusion(cfg, device=device)
    grid = model.grid
    where = where_line(device)
    log0(f"grid {grid.global_shape} {cfg.dtype} over process grid {grid.dims} "
         f"({grid.nprocs} rank(s)) on {where}")
    ckpt_mode = bool(args.checkpoint)
    if variant == "hide" and not args.deep:
        log0(hide_note(grid, cfg.b_width))
    note = ""
    if args.deep:
        # Label the run with the depth that will execute (run_deep degrades
        # k to gcd(warmup, nt - warmup, K); checkpoint mode has no warmup
        # window, so its k is gcd'd against nt alone).
        k_eff = model.effective_deep_depth(warmup=0 if ckpt_mode else None,
                                           block_steps=args.deep, warn=False)
        variant = f"deep{k_eff}"
        log0(f"--deep: running deep-halo sweeps (k={k_eff}"
             + (f", degraded from {args.deep}" if k_eff != args.deep else "")
             + ") instead of the per-step variant")
    if ckpt_mode:
        make_advance, quantum = checkpoint_schedule(
            args, model, lambda: per_step_checkpoint_advance(args, model, variant))

        def advance_state():
            advance = make_advance()
            T, Cp = model.init_state()

            def seg(s, n):
                return (advance(s[0], Cp, n),)

            seg.loop = getattr(advance, "loop", None)
            return seg, (T,)

        runner = make_checkpoint_runner(
            args, log0, advance_state,
            lambda s, ran, wtime: RunResult(T=s[0], wtime=wtime, nt=ran, warmup=0,
                                            config=cfg),
            quantum=quantum, grid=grid)
        with profile_context(args, device, me):
            result = runner()
        report_checkpointed_line(result, args, log0, where)
        emit_run_gauges(result, variant, wire=args.wire_mode)
    else:
        driver = "deep" if args.deep else args.driver
        with profile_context(args, device, me):
            if args.deep:
                result = model.run_deep(block_steps=args.deep)
            else:
                result = model.run(variant, driver=args.driver)
        if args.deep:
            log0(f"{variant}: local {schedule_note(result)}, one width-{result.k} exchange "
                 f"per {result.k} steps; T_eff counts 3 passes per step, so it is an "
                 "effective rate and may exceed the card's memory rate")
        else:
            note = f"; {driver_note(args, result)}"
        emit_run_gauges(result, variant, driver=driver, wire=args.wire_mode)
        log0(
            f"Executed {result.nt} steps ({result.warmup} warmup) in = "
            f"{result.wtime:.3e} sec (@ T_eff = {result.t_eff:.2f} GB/s aggregate, "
            f"{result.gpts:.4f} Gpts/s) on {where}{note}"
        )
    log0(f"maximum(T) = {global_max(result.T)}")
    finish_field(args, result.T, grid, variant, log0)
    finish_observability(log0)
    distributed.finalize()
    return 0


def hide_note(grid, b_width) -> str:
    """The hide decomposition of this rank's shard: the frame width as
    asked and as clamped (to half the shard), and its interior (ghost-free)
    and slab boxes."""
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, ghost_free, region_boxes

    local = grid.local_shape
    bw = effective_b_width(local, b_width)
    boxes = region_boxes(local, bw)
    inner = sum(ghost_free(b, local) for b in boxes)
    one = "; one rank has nothing to hide and runs the perf step" if grid.nprocs == 1 else ""
    return (f"hide: b_width {tuple(b_width)} clamped to {bw} on the {local} shard: "
            f"{inner} interior box(es), {len(boxes) - inner} slab box(es){one}")
