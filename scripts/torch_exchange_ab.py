"""Time two checkouts of the PyTorch/CUDA port's halo exchange and sharded
steps side by side on four CUDA cards over NCCL.

    python scripts/torch_exchange_ab.py --roots OLD NEW NEW OLD [--json PATH]

Each root is a directory that holds a `rocm_mpi_tpu_torch/` package (a
checkout, or an unpacked `git archive` of one). Every root runs as 4 ranks
of its own under torchrun, in the order given, one rank a card, with its
own kernels built from its own sources; list each root twice, in the
order old, new, new, old, so that a drift of the cards shows. On the 2×2
grid of 12288² f32 (6144² shards) each root measures:

- the width-1 exchange alone (`halo.exchange_halo` into a reused padded
  buffer) with the f32 and the bf16 wire: ms a call, the host clock
  around `CALLS` calls between two synchronised barriers, rank 0;
- the diffusion `perf` and `hide` steps under the step driver
  (`run(variant)`, the eager exchange every step), and under the scan
  driver (`run(variant, driver="scan")`: CUDA graphs where the root
  captures the exchange, its eager loop where it does not), nt 1010
  after 10: ms/step of rank 0, and the scan run's route.

The card's name and power limit (nvidia-smi) head the output; one JSON
object per root follows, and `--json` writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPE, DIMS = (12288, 12288), (2, 2)
CALLS = 100
NT, WARMUP = 1010, 10


def child(root: str) -> None:
    """One rank of one root, started by torchrun: measure, and print rank
    0's JSON line."""
    sys.path.insert(0, root)
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    distributed.maybe_initialize_distributed("cuda")
    device = distributed.local_device("cuda")
    out = {"root": root}
    model = HeatDiffusion(DiffusionConfig(global_shape=SHAPE, nt=NT, warmup=WARMUP,
                                          dtype="f32", dims=DIMS), device=device)
    T, _ = model.init_state()
    pad = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=device)
    for mode in ("f32", "bf16"):
        exchange_halo(T, model.grid, out=pad, wire_mode=mode)
        torch.cuda.synchronize()
        distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            exchange_halo(T, model.grid, out=pad, wire_mode=mode)
        torch.cuda.synchronize()
        distributed.barrier()
        out[f"exchange_{mode}_ms"] = (time.perf_counter() - t0) / CALLS * 1e3
    for variant in ("perf", "hide"):
        for driver in ("step", "scan"):
            res = model.run(variant, driver=driver)
            out[f"{variant}_{driver}_ms"] = res.wtime_it * 1e3
            if driver == "scan":
                out[f"{variant}_scan_route"] = res.route
    if distributed.rank() == 0:
        print("AB " + json.dumps(out), flush=True)
    distributed.finalize()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs="+", required=True)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"cards: {' | '.join(smi.stdout.strip().splitlines())}", flush=True)
    # Build each root's stencil kernels first, all at once: the ranks then
    # load them instead of compiling in every rank.
    builds = [subprocess.Popen([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {os.path.abspath(r)!r}); "
        "from rocm_mpi_tpu_torch.ops import _build; _build.build(['stencil'])")])
        for r in dict.fromkeys(args.roots)]
    if any(b.wait() for b in builds):
        raise SystemExit("a root's kernels failed to build")
    rows = []
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
             os.path.abspath(__file__), "child", root],
            capture_output=True, text=True, timeout=900)
        lines = [ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"root {root} failed (rc {proc.returncode})")
        row = json.loads(lines[0])
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        sys.exit(main())
