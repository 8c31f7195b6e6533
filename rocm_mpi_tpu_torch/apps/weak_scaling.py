"""Weak-scaling harness — the north-star measurement; counterpart of
apps/weak_scaling.py.

Holds the shard size fixed (`--local` cells a side per rank), grows the
global grid with the rank count (`--counts`), and reports per-device
Gpts/s and the efficiency against the smallest count run (the BASELINE.md
target: `hide` at 252² a device at ≥ 90 % against one card). One rank
per GPU under torchrun; with `--device cpu` the ranks are gloo processes
and every row is marked `mechanics_only`, as are the rows of gloo ranks
sharing one card.

For each count n every rank joins the process subgroup of ranks 0 … n − 1
(`dist.new_group` is collective), ranks below n build the n-rank grid
(`suggest_dims(n, 2)`, `local · dims` cells, lengths `10 · dims`) and
run the model under the subgroup's barriers, and the others sit the rung
out; every rank then meets at one barrier before the next rung. Over NCCL
the per-step variants run the scan driver's CUDA graphs, halo exchange
included (`--driver scan`, the default); `--variant deep` runs the
deep-halo sweeps, as CUDA graphs of sweeps on CUDA ranks (their rows
record the loop route, `loop_route`).

Telemetry, as in the JAX app: with `--telemetry DIR` (or the launcher's
RMT_TELEMETRY_DIR) each diffusion rung's timed loop is split into
`--telemetry-windows` spanned windows (per-step percentiles need more
than one sample): the model's own run through metrics.timed_window's
`windows`, each window between a sync and a barrier, which the rates
then include, so a windowed ladder's rows compare with each other and
not with an unwindowed ladder's (their lines and rows say how many
windows). The rates are banked as
`run.gpts`/`run.gpts_per_device`/`run.efficiency` gauges, the compile
accounting follows the ladder, and then, unless `--no-probes`, the phase
probes (telemetry/probes.py) time the last rung's halo, interior and
checkpoint phases. `--health` adds the flight recorder, and a halo
heartbeat (one face exchange) at every window boundary. Each window
boundary is also the "window" fault site (RMT_INJECT_FAULT, e.g.
`crash@step=K,at=window`; step: the steps run before the window).
`--autotune` runs every rung with config="auto", as the JAX app does: the scan chunk
of every workload, and for diffusion run_deep's depth and wire mode, come
from the tuning cache (rocm_mpi_tpu_torch/tuning; rank 0 of each rung
decides for its ranks), and with telemetry on the resolve outcomes are
banked as `tune.hits`/`tune.misses` after the compile gauges.

  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.weak_scaling --json --local 252
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.weak_scaling --device cpu --local 16 --json
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.weak_scaling --device cpu --local 16 --telemetry /tmp/tel --health
  python -m rocm_mpi_tpu_torch.apps.weak_scaling --local 252       # one GPU: the n = 1 row

Under torchrun, put another flag before `--local`: torchrun reads a
leading `--local` as an abbreviation of its own options and stops. The
torchrun of the GPU machine's PyTorch refuses `--local` anywhere on the
line (ambiguous with its --local-addr and --local-ranks-filter); there
run main() on spawned ranks (parallel/launcher.spawn_ranks), as
chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from rocm_mpi_tpu_torch.apps._common import (
    add_health_flag,
    add_profile_flag,
    add_telemetry_flag,
    driver_note,
    finish_observability,
    profile_context,
    setup_observability,
    where_line,
)

VARIANTS = ("ap", "fused", "shard", "perf", "kp", "hide", "deep")
# The variants of the wave and the shallow water (the JAX app's refusal).
WORKLOAD_VARIANTS = ("ap", "perf", "hide", "deep")


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--local", type=int, default=252,
                   help="per-rank shard edge (target geometry: 252)")
    p.add_argument("--nt", type=int, default=2000)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--variant", default="hide", choices=list(VARIANTS),
                   help="step schedule; 'deep' = deep-halo sweeps (run_deep)")
    p.add_argument("--workload", default="diffusion", choices=["diffusion", "wave", "swe"],
                   help="physics model (the wave and the shallow water take the variants "
                   "ap/perf/hide/deep)")
    p.add_argument("--deep-k", type=int, default=None, metavar="K",
                   help="deep-halo sweep depth (default: run_deep's own)")
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"])
    p.add_argument("--counts", default=None,
                   help="comma-separated rank counts (default: powers of 2 up to the "
                   "world size)")
    p.add_argument("--json", action="store_true", help="emit one JSON line per count as well")
    p.add_argument("--driver", default="scan", choices=["step", "scan"],
                   help="loop form of the per-step variants (default: scan, CUDA graphs "
                   "with the exchange captured over NCCL); --variant deep does not take "
                   "it: its sweeps always run as CUDA graphs on CUDA ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: one GPU a rank, NCCL; cpu: the plain versions, gloo")
    add_telemetry_flag(p)
    add_health_flag(p)
    add_profile_flag(p)
    p.add_argument("--telemetry-windows", type=int, default=8, metavar="W",
                   help="with --telemetry: split each diffusion rung's timed loop into W "
                   "spanned windows (per-step percentiles need more than one sample; "
                   "default %(default)s)")
    p.add_argument("--no-probes", dest="probes", action="store_false", default=True,
                   help="with --telemetry: skip the halo/interior/checkpoint "
                   "phase-attribution probes (telemetry/probes.py)")
    p.add_argument("--autotune", action="store_true",
                   help="config='auto': the scan chunk (every workload) and run_deep's "
                   "depth and wire mode (diffusion) from the tuning cache")
    return p


def parse_counts(text: str | None, world: int) -> list[int]:
    """Ascending, deduplicated counts (the first row run is the efficiency
    baseline); by default the powers of 2 up to `world`."""
    if text:
        return sorted({int(c) for c in text.split(",")})
    counts, c = [], 1
    while c <= world:
        counts.append(c)
        c *= 2
    return counts


def rung_groups(counts, world: int) -> dict:
    """count -> the barrier group of its ranks 0 … n − 1: a new subgroup
    for 1 < n < world (every rank makes each, as `dist.new_group` is
    collective), the default group (None) for n = world, none needed for
    one rank."""
    import torch.distributed as dist

    return {n: dist.new_group(list(range(n))) if 1 < n < world else None
            for n in counts if n <= world}


@dataclasses.dataclass
class Rung:
    """One count's run on this rank."""

    n: int
    dims: tuple[int, ...]
    shape: tuple[int, ...]
    model: object
    result: object


def rung_windows(args) -> int:
    """The timed windows of a rung: --telemetry-windows for a diffusion
    per-step rung with telemetry on (a windowed rung, as in the JAX app),
    else 0 (the model's run, unwindowed)."""
    from rocm_mpi_tpu_torch import telemetry

    windowed = (telemetry.enabled() and args.workload == "diffusion"
                and args.variant != "deep")
    return args.telemetry_windows if windowed else 0


def window_boundary(model):
    """A windowed rung's hook at its window boundaries (metrics.timed_window's
    `on_boundary(T, step)`), in the JAX app's order: the halo heartbeat
    when the flight recorder is on, then, at each window (`step`: the
    steps run before it), the "window" fault site; both come before the
    window's progress bump, so a rank held there lags its peers' step."""
    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.telemetry import flight, probes

    beat = probes.make_halo_heartbeat(model) if flight.enabled() else None

    def boundary(T, step):
        if beat is not None:
            T = beat(T)
        if step is not None:
            faults.fault_point("window", step=step)
        return T

    return boundary


def run_rung(args, n: int, group, device) -> Rung | None:
    """The n-rank rung of `args` on this rank: None when this rank sits it
    out, else the model and its run's result: model.run, its timed steps
    in `rung_windows(args)` windows (`window_boundary` at the start of
    each)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid, suggest_dims

    rank = distributed.rank()
    if rank >= n:
        return None
    dims = suggest_dims(n, 2)
    shape = (args.local * dims[0], args.local * dims[1])
    lengths = (10.0 * dims[0], 10.0 * dims[1])
    model_cls, cfg_cls = {"diffusion": (HeatDiffusion, DiffusionConfig),
                          "wave": (AcousticWave, WaveConfig),
                          "swe": (ShallowWater, SWEConfig)}[args.workload]
    cfg = cfg_cls(global_shape=shape, lengths=lengths, nt=args.nt, warmup=args.warmup,
                  dtype=args.dtype, dims=dims)
    grid = init_global_grid(*shape, lengths=lengths, dims=dims, nprocs=n, rank=rank,
                            group=group)
    model = model_cls(cfg, grid=grid, device=device)
    run_config = "auto" if args.autotune else None
    if args.variant == "deep":
        # Only diffusion's depth is tunable (the JAX app's rule); the wave
        # and the shallow water keep their own depth policies.
        extra = {"config": run_config} if args.workload == "diffusion" else {}
        result = model.run_deep(block_steps=args.deep_k, **extra)
    elif windows := rung_windows(args):
        result = model.run(args.variant, driver=args.driver, windows=windows,
                           on_boundary=window_boundary(model), config=run_config)
    else:
        result = model.run(args.variant, driver=args.driver, config=run_config)
    return Rung(n=n, dims=dims, shape=shape, model=model, result=result)


def mechanics_only(device) -> bool:
    """True when the rates are not a multi-GPU measurement: the CPU, or
    gloo ranks sharing a card."""
    from rocm_mpi_tpu_torch.parallel import distributed

    return device.type == "cpu" or distributed.backend() == "gloo"


def ladder(args, device, log=print) -> list[tuple[dict, Rung]]:
    """Every count of `args` on this rank: (the JSON row, the rung) of each
    rung this rank ran, the row with the JAX app's keys. `log` takes the
    JAX app's line of each row, and with `--json` the row. With telemetry
    on, each row's rates are banked as the JAX app's gauges, stamped with
    the rank count and the loop form."""
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.telemetry import flight

    world = distributed.world_size()
    counts = parse_counts(args.counts, world)
    groups = rung_groups(counts, world) if distributed.is_distributed() else {}
    base = None
    out = []
    run_driver = "deep" if args.variant == "deep" else args.driver
    windows = rung_windows(args)
    for n in counts:
        if n > world:
            log(f"n={n}: skipped (only {world} ranks)")
            continue
        rung = run_rung(args, n, groups.get(n), device)
        if rung is None:
            # The flight recorder's step counter is global: a rung sat out
            # banks its nt too, so the ranks' counters stay comparable.
            flight.progress(step_inc=args.nt)
        # The sitting-out ranks wait here, so no rank's next set-up shares
        # the host with a timed window.
        distributed.barrier()
        if rung is None:
            continue
        r = rung.result
        per_dev = r.gpts / n
        if base is None:
            base = (per_dev, n)
        eff = per_dev / base[0]
        if telemetry.enabled():
            telemetry.gauge("run.gpts", round(r.gpts, 6), devices=n, variant=args.variant,
                            workload=args.workload, driver=run_driver)
            telemetry.gauge("run.gpts_per_device", round(per_dev, 6), devices=n,
                            driver=run_driver)
            telemetry.gauge("run.efficiency", round(eff, 6), devices=n, driver=run_driver)
        note = f"; {driver_note(args, r)}" if args.variant != "deep" else (
            f"; deep (route {r.route}, loop route {r.loop_route}, k {r.k})")
        if windows > 1:
            note += (f"; {windows} telemetry windows, a sync and barrier each: compare "
                     "with windowed rows only")
        log(f"n={n:4d} mesh={rung.dims} global={rung.shape}: "
            f"{r.wtime_it * 1e6:9.3f} us/step  {r.gpts:9.4f} Gpts/s "
            f"({per_dev:7.4f}/dev)  efficiency={eff:6.1%} vs n={base[1]}{note}")
        wl = "" if args.workload == "diffusion" else f"{args.workload} "
        row = {"metric": f"weak-scaling {wl}{args.variant} {args.local}²/dev",
               "devices": n, "dims": list(rung.dims), "gpts": round(r.gpts, 4),
               "gpts_per_device": round(per_dev, 4), "efficiency": round(eff, 4)}
        if args.variant == "deep":
            # Beside the JAX app's keys: the loop the sweeps ran in
            # ("scan-graph" on CUDA ranks, over NCCL too).
            row["loop_route"] = r.loop_route
        if windows > 1:
            # Beside the JAX app's keys: the rates carry a sync and a
            # barrier a window.
            row["windows"] = windows
        if mechanics_only(device):
            row["mechanics_only"] = True
        if args.json:
            log(json.dumps(row))
        out.append((row, rung))
    return out


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    from rocm_mpi_tpu_torch.parallel import distributed

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me = distributed.rank()
    setup_observability(args, me)

    def log0(msg):
        if me == 0:
            print(msg, flush=True)

    if args.workload != "diffusion" and args.variant not in WORKLOAD_VARIANTS:
        log0(f"--workload {args.workload} supports variants ap/perf/hide/deep, "
             f"not {args.variant!r}")
        distributed.finalize()
        return 2
    log0(f"weak scaling: variant={args.variant}, {args.local}²/device, nt={args.nt}, "
         f"dtype={args.dtype}, {distributed.world_size()} rank(s) available")
    log0(f"on {where_line(device)}" + (
        "; mechanics only: the rates are not a multi-GPU measurement"
        if mechanics_only(device) else ""))
    with profile_context(args, device, me):
        rows = ladder(args, device, log=log0)
    observe_ladder(args, rows, log0)
    finish_observability(log0)
    distributed.finalize()
    return 0


def observe_ladder(args, rows, log0) -> None:
    """After the ladder, with telemetry on: bank the compile accounting
    (before the probes, whose first calls are tooling, not recompiles) and
    the tuning resolves (`tune.hits`/`tune.misses`: a tuned ladder and a
    default one are different measurements), then, for diffusion and
    unless --no-probes, the phase probes on this
    rank's last rung, which every rank of that rung runs (the largest
    count: the same rung on every rank that ran one), with one
    checkpoint save/restore into the telemetry directory's ckpt-probe/."""
    import pathlib

    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.telemetry import compiles, events, probes
    from rocm_mpi_tpu_torch.tuning import resolve as tuning_resolve

    if not telemetry.enabled():
        return
    compiles.emit_gauges()
    tuning_resolve.emit_gauges()
    if not (args.probes and rows and args.workload == "diffusion"):
        return
    model = rows[-1][1].model
    tel_dir = events.directory()
    ckpt_dir = pathlib.Path(tel_dir) / "ckpt-probe" if tel_dir else None
    log0("telemetry: running halo/interior" + ("/checkpoint" if ckpt_dir else "")
         + " phase probes")
    probes.run_diffusion_phase_probes(
        model, checkpoint_dir=ckpt_dir,
        driver="deep" if args.variant == "deep" else args.driver)


if __name__ == "__main__":
    sys.exit(main())
