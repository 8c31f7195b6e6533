"""Run one cell of the benchmark once and print its result line.

    python3 -m stencil_bench.run --workload diff2d-perf-f64-12288 --seed 7 \\
        --seconds 15 --trace 0

from the root of a checkout that holds BENCHMARK.json, stencil_bench/ and
the program, rocm_mpi_tpu_torch/. The cell, its configuration, its
traffic mix and its metrics are found by name (stencil_bench/registry.py).
A cell on one chip runs in this process; a sharded cell on one process a
chip, started by the program's launcher (parallel/launcher.spawn_ranks,
NCCL). `--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a traced slice of the window, and the breakdown.

The last line of standard output is the result's JSON; the last lines of
standard error are the numbers compared with their limits. Without CUDA,
with fewer cards than the cell asks for, or when JAX or the JAX package
(`rocm_mpi_tpu`) is loaded once the window has closed, it prints no
result and exits 1.
"""

from __future__ import annotations

import time

T_START = time.time()  # before any import that takes time: the set-up's start

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from stencil_bench import cell as cell_mod  # noqa: E402
from stencil_bench import guard, registry, report  # noqa: E402

# How long the ranks of a sharded cell may take, set-up (a cold build
# included), window and check together.
RANK_TIMEOUT_S = 1100.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="makes the inputs")
    p.add_argument("--seconds", type=float, required=True, help="the window's length")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from a traced slice of the window")
    p.add_argument("--trace-dir", default=None,
                   help="keep the traced slice's Chrome trace in this directory (by "
                   "default it is written to the temporary directory and removed once read)")
    return p.parse_args(argv)


def adopt_orphans() -> None:
    """Make this process the subreaper of what it starts, so that a
    process a rank leaves behind comes back here to be stopped."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def _children() -> list[int]:
    me, pids = os.getpid(), []
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            pids.append(int(entry.name))
    return pids


def stop_children(grace: float = 10.0) -> None:
    """Join the ranks, stop multiprocessing's resource tracker (which the
    spawned ranks start), then stop and reap anything left, naming it."""
    import multiprocessing
    from multiprocessing import resource_tracker

    for p in multiprocessing.active_children():
        p.join(timeout=grace)
        if p.is_alive():
            p.kill()
            p.join()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    left = _children()
    for pid in left:
        print(f"stencil_bench: stopping leftover process {pid}", file=sys.stderr, flush=True)
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + grace
    while left and time.monotonic() < deadline:
        alive = []
        for pid in left:
            try:
                if os.waitpid(pid, os.WNOHANG) == (0, 0):
                    alive.append(pid)
            except ChildProcessError:
                pass
        left = alive
        if left:
            time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


def launch(cell, spec: dict, rank_fn=None) -> list[dict]:
    """Every rank's facts, `rank_fn(rank, spec)` (cell.run_rank) on each:
    this process alone for one chip, else one spawned process a rank
    (NCCL on the card, gloo on the CPU)."""
    rank_fn = rank_fn or cell_mod.run_rank
    if cell.chips == 1:
        return [rank_fn(0, spec)]
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    adopt_orphans()
    backend = "nccl" if spec["device"] == "cuda" else "gloo"
    try:
        return spawn_ranks(cell.chips, rank_fn, (spec,), backend=backend,
                           timeout=RANK_TIMEOUT_S)
    finally:
        stop_children()


def execute(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            t_start: float | None = None, trace_dir=None, rank_fn=None):
    """Run `cell` once on `device` ("cuda", or "cpu" for the CPU tests,
    which skip the look for a card; `rank_fn` stands in for
    cell.run_rank where a test breaks the timed path); returns (ranks'
    facts, line)."""
    spec = {"workload": cell.name, "config": cell.config, "traffic": cell.traffic,
            "seed": int(seed), "seconds": float(seconds), "trace": bool(traced),
            "device": device, "t_start": T_START if t_start is None else t_start,
            "trace_dir": trace_dir, "root": str(cell.root)}
    ranks = launch(cell, spec, rank_fn)
    kind = "cpu"
    if device == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
    return ranks, report.build(cell, ranks, traced, kind=kind, on_device=device == "cuda")


def card_line() -> str | None:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def notes(ranks: list[dict]) -> list[str]:
    """What each rank ran, for standard error."""
    out = []
    for r in ranks:
        out.append(f"rank {r['rank']}: route {r['route']} q {r['q']}, {r['runs']} runs of "
                   f"{r['steps_per_run']} steps in {r['window_s']:.4f} s, set-up "
                   f"{r['setup_s']:.3f} s, capture {r['capture_s'] * 1e3:.1f} ms, launches "
                   f"{r['launches']}, peak {r['peak_bytes']} B, device s a run "
                   f"{r['run_device_s']}, readings {r['readings']} "
                   f"(check {r['check_s']:.2f} s)")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("stencil_bench: no CUDA device; the benchmark measures the card only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"stencil_bench: {args.workload} asks for {cell.chips} card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    ranks, line = execute(cell, args.seed, args.seconds, bool(args.trace),
                          trace_dir=args.trace_dir)
    found = sorted(set(guard.forbidden_loaded()).union(*(r["forbidden"] for r in ranks)))
    if found:
        print(f"stencil_bench: loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return 1
    card = card_line()
    checks = line.pop("checks")
    line["card"] = card
    line["checks"] = checks
    for text in notes(ranks) + [f"card: {card}"] + report.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
