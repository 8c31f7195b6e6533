"""Sets of runs of one cell, and the spread of each metric: what a
bound is set from.

    python3 -m stencil_bench.sets --workload diff2d-perf-f64-252 --seconds 10 \\
        --seeds 1 2 3 4 5 6 --sets 2 [--trace-seeds 7 8 9] --out sets.jsonl

Each run is `python3 -m stencil_bench.run` in a process of its own, one
after another (one process a chip); every set takes the same seeds in
the same order. The result lines go to `--out` one a line, with each
run's exit code, wall seconds and the end of its standard error. The
summary printed last gives, for each metric and set, the median and the
spread: the distance between the first and third quartiles
(statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "stencil_bench.run", "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        line = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t, "line": line, "stderr": proc.stderr[-3000:]}


def summary(records: list[dict], sets: int) -> dict:
    out = {}
    per_set = [[r for r in records if r["set"] == s and r["line"]] for s in range(sets)]
    names = sorted({m for rs in per_set for r in rs for m in r["line"]["metrics"]})
    for name in names:
        rows = []
        for rs in per_set:
            values = [r["line"]["metrics"][name]["value"] for r in rs
                      if name in r["line"]["metrics"]]
            rows.append({"n": len(values), "median": statistics.median(values) if values
                         else None, "spread": spread(values), "values": values})
        out[name] = rows
    out["correct"] = [sum(1 for r in rs if r["line"]["correct"]) for rs in per_set]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records = []
    with out.open("a", encoding="utf-8") as f:
        for s in range(args.sets):
            for seed in args.seeds:
                rec = one_run(args.workload, seed, args.seconds, 0) | {"set": s}
                records.append(rec)
                f.write(json.dumps(rec) + "\n")
                f.flush()
        for seed in args.trace_seeds:
            rec = one_run(args.workload, seed, args.seconds, 1) | {"set": -1}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            line = rec["line"]
            print(json.dumps({"trace_seed": seed, "rc": rec["rc"], "wall_s": rec["wall_s"],
                              "line": line}), flush=True)
            if rec["rc"]:
                print(rec["stderr"], file=sys.stderr)
    for rec in records:
        if rec["rc"]:
            print(f"seed {rec['seed']} set {rec['set']}: rc {rec['rc']}\n{rec['stderr']}",
                  file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seconds": args.seconds,
                      "runs": [[r["seed"], r["set"], r["rc"], round(r["wall_s"], 1)]
                               for r in records],
                      "summary": summary(records, args.sets)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
