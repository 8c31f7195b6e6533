"""Sweep the scan driver's graph-length cap (models/scan.GRAPH_STEP_CAP)
on one CUDA card.

    python scripts/torch_scan_cap.py [--caps 8 16 32 64 128 256] [--json PATH]

Run from the repository root. For each cap, each of the small main paths
— diffusion `perf` 252² f32, `kp` 128² f64, wave `perf` 252² f32 and SWE
`perf` 252² f64 — runs `run(driver="scan")` three times at two windows:
nt 2000 after a warmup of 1000 (q = 1000, so c is the cap's largest
divisor of 1000; the captures fall in the warmup) and nt 1000 with no
warmup (the captures fall in the timed window). Printed per row: c, the
graph count, the host ms of one more advance's captures, and the median
ms/step of the three windows with the card's name and power limit. A cap
buys a cheaper capture with a smaller c, and pays one graph replay's host
time (about 12 µs) every c steps.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--caps", type=int, nargs="+", default=[8, 16, 32, 64, 128, 256])
    parser.add_argument("--json", default=None, metavar="PATH")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_scan_cap: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rocm_mpi_tpu_torch.apps._common import card_line
    from rocm_mpi_tpu_torch.models import scan
    from rocm_mpi_tpu_torch.ops import _build

    card = card_line()
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    makers = {"diffusion": cs._kp_model, "wave": cs._wave_model, "swe": cs._swe_model}
    cases = [("diffusion", "perf", cs.SMALL, "f32"), ("diffusion", "kp", cs.KP_SMALL, "f64"),
             ("wave", "perf", cs.SMALL, "f32"), ("swe", "perf", cs.SMALL, "f64")]
    rows = []
    for cap in args.caps:
        scan.GRAPH_STEP_CAP = cap
        for name, variant, shape, dtype in cases:
            for nt, warmup in ((2000, 1000), (1000, 0)):
                model = makers[name](shape, nt, warmup, dtype)
                times = []
                for _ in range(3):
                    res = model.run(variant, driver="scan")
                    torch.cuda.synchronize()
                    times.append(res.wtime_it * 1e3)
                loop = cs._scan_loop(torch, name, model, variant)
                row = dict(cap=cap, model=name, variant=variant, shape=list(shape),
                           dtype=dtype, nt=nt, warmup=warmup, c=loop.plan.c,
                           graphs=len(loop.graphs), capture_ms=loop.capture_s * 1e3,
                           ms_per_step=statistics.median(times), windows=times)
                rows.append(row)
                print(f"[cap {cap}] {name} {variant} {shape[0]}x{shape[1]} {dtype}, nt {nt} "
                      f"warmup {warmup}: c {row['c']}, {row['graphs']} graph(s), capture "
                      f"{row['capture_ms']:.2f} ms, {row['ms_per_step']:.6f} ms/step on {card}",
                      flush=True)
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
