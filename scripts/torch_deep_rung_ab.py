"""Run the weak-scaling app's `deep` rungs from two checkouts of the
PyTorch/CUDA port side by side on one host with four CUDA cards.

    python scripts/torch_deep_rung_ab.py --roots OLD NEW NEW OLD [--counts 1,4] [--json PATH]

Each root is a directory that holds a `rocm_mpi_tpu_torch/` package (a
checkout, or an unpacked `git archive` of one). The roots' kernels are
built first, every root at once. Then each root, in the order given,
runs `apps/weak_scaling.py --variant deep --local 252 --counts C --json`
(the app's 2000 steps after 200, f32) as main() on four ranks of one
NCCL group (parallel/launcher.spawn_ranks; the card's torchrun reads
`--local` as one of its own options), in a process of its own that
imports that root's package. List each root twice, old, new, new, old,
so that a drift of the cards shows. The card's name and power limit head
the output; one line a run follows with each rung's µs a step.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import subprocess
import sys


def app_rank(rank: int, argv: list) -> tuple:
    """One rank of weak_scaling.main(argv) on card `rank`; its exit code
    and stdout."""
    import torch

    from rocm_mpi_tpu_torch.apps import weak_scaling

    torch.cuda.set_device(torch.device("cuda", rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = weak_scaling.main(argv)
    return rc, out.getvalue()


def run_root(counts: str) -> int:
    """The body of one root's process (cwd and sys.path[0]: the root)."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    argv = ["--json", "--variant", "deep", "--local", "252", "--counts", counts]
    ranks = spawn_ranks(4, app_rank, (argv,), backend="nccl", timeout=600)
    rc, out = ranks[0]
    print(out, flush=True)
    return max(r for r, _ in ranks)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs="+", required=True)
    p.add_argument("--counts", default="1,4")
    p.add_argument("--json", default=None, metavar="PATH")
    p.add_argument("--run-root", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.run_root:
        sys.path.insert(0, args.run_root)
        return run_root(args.counts)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout.strip() else "no nvidia-smi",
          flush=True)
    roots = [str(pathlib.Path(r).resolve()) for r in args.roots]
    build = ("from rocm_mpi_tpu_torch.ops import _build; "
             "_build.build(sorted(p.stem for p in _build.CSRC.glob('*.cu')))")
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=r)
              for r in dict.fromkeys(roots)]
    if any(b.wait() for b in builds):
        print("a root's kernels did not build", flush=True)
        return 1
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--run-root", root,
                               "--counts", args.counts, "--roots", root],
                              cwd=root, capture_output=True, text=True, timeout=900)
        got = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not got:
            print(f"{root}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}",
                  flush=True)
            return 1
        us = {r["devices"]: round(1e6 * r["devices"] * 252 * 252 / (r["gpts"] * 1e9), 4)
              for r in got}
        rows.append({"root": root, "us_per_step": us, "rows": got})
        print(f"[deep-ab] {root}: us/step by count {us}", flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
