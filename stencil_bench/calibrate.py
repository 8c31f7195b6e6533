"""The readings a cell's limit is set from (PERF.md gives them beside it).

    python3 -m stencil_bench.calibrate --workload diff2d-perf-f64-12288 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--json PATH]

In one process a rank (a sharded cell's ranks as the benchmark starts
them), for each seed: the seed's inputs, one run of the timed path (the
program adapter's run, at the cell's size), and the compared numbers
against the reference: the program's readings. For each control seed
also the control (the adapter's `control_output`: the reference in the
precision below the configuration's) put in the program's place. A
sound limit lies above every program reading and below every control
reading. The benchmark's own runs never run the control. It
prints one JSON object: the readings per seed, and the seconds each
reference run took (what the check costs every run).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def calibrate_rank(rank: int, spec: dict) -> dict:
    from stencil_bench.cell import build

    me, prog = build(rank, spec)
    out = {"program": {}, "control": {}, "reference_s": [], "run_s": []}
    for seed in spec["seeds"]:
        prog.set_seed(seed)
        me.barrier()
        t = time.perf_counter()
        prog.run()
        me.barrier()
        out["run_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        out["program"][seed] = prog.readings(prog.output())
        me.sync()
        out["reference_s"].append(time.perf_counter() - t)
        if seed in spec["control_seeds"]:
            out["control"][seed] = prog.readings(prog.control_output())
    prog.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--json", default=None, help="also write the result here")
    args = p.parse_args(argv)

    from stencil_bench import registry, run

    cell = registry.cell(args.workload)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    spec = {"workload": cell.name, "config": cell.config, "traffic": cell.traffic,
            "device": args.device, "seeds": seeds, "control_seeds": args.control_seeds,
            "root": str(cell.root)}
    checks = cell.program().checks
    ranks = run.launch(cell, spec, calibrate_rank)
    result = {"workload": cell.name, "card": run.card_line(),
              "program": {s: checks(cell.config, [r["program"][s] for r in ranks])
                          for s in seeds},
              "control": {s: checks(cell.config, [r["control"][s] for r in ranks])
                          for s in args.control_seeds},
              "reference_s": [max(r["reference_s"][i] for r in ranks)
                              for i in range(len(seeds))],
              "run_s": ranks[0]["run_s"],
              "raw": [{k: r[k] for k in ("program", "control")} for r in ranks]}
    text = json.dumps(result)
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
