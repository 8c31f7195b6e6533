"""The longest idle gaps of a benchmark's kept traced slice, each with
the program span that held it or "harness".

    python3 scripts/trace_gaps.py TRACE.json [--top 10]

TRACE.json is a Chrome trace kept by `python3 -m stencil_bench.run ...
--trace 1 --trace-dir DIR` (one a rank). A gap is a stretch of the slice
with no kernel, copy or set on the device. For each of the `top` longest:
its length and start in ms (from the slice's first device event), the
name the result line's breakdown gives it (the innermost host event at
its middle, stencil_bench/trace.py), the program's spans that hold its
middle (rocm_mpi_tpu_torch/telemetry/spans.py ranges, outermost first)
or "harness" where none does, and the host events that overlap it
longest (operators and runtime calls). Then, for each program span, its
calls in the slice and their mean host ms, beside the device's busy ms a
call of `diffusion.advance`.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAM = ("diffusion.", "scan.")


def _program(e) -> bool:
    return e.cat == "user_annotation" and e.name.startswith(PROGRAM)


def rows(data, top: int) -> list[dict]:
    """The `top` longest gaps of `data` (stencil_bench.trace.TraceData)."""
    from stencil_bench import trace

    out = []
    for a, b in sorted(data.gaps(), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        held = sorted((e for e in data.host if _program(e) and e.start <= mid < e.end),
                      key=lambda e: e.start)
        overlap = []
        for e in data.host:
            if e.name == trace.SLICE_NAME or _program(e):
                continue
            cut = min(e.end, b) - max(e.start, a)
            if cut > 0:
                overlap.append((cut, e.name))
        overlap.sort(reverse=True)
        out.append({"ms": (b - a) * 1e3, "at_ms": (a - data.t0) * 1e3,
                    "breakdown": data.host_at(mid),
                    "spans": [e.name for e in held] or ["harness"],
                    "host": [(name, cut * 1e3) for cut, name in overlap[:3]]})
    return out


def spans(data) -> dict:
    """Calls and mean host ms of each program span in the slice."""
    out: dict[str, list[float]] = {}
    for e in data.host:
        if _program(e):
            out.setdefault(e.name, []).append((e.end - e.start) * 1e3)
    return {name: (len(v), sum(v) / len(v)) for name, v in sorted(out.items())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace")
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from stencil_bench import trace

    data = trace.parse(args.trace)
    print(f"slice {data.window_s * 1e3:.4f} ms, device busy {data.busy_s() * 1e3:.4f} ms, "
          f"{data.kernels()} kernels")
    for k, row in enumerate(rows(data, args.top)):
        host = "; ".join(f"{name} {ms:.4f}" for name, ms in row["host"])
        print(f"gap {k}: {row['ms']:.4f} ms at {row['at_ms']:.4f} ms, breakdown "
              f"{row['breakdown']!r}, in {' > '.join(row['spans'])}; host: {host}")
    calls = spans(data)
    for name, (n, ms) in calls.items():
        print(f"span {name}: {n} calls, mean {ms:.4f} ms")
    if "diffusion.advance" in calls:
        n = calls["diffusion.advance"][0]
        print(f"device busy a call: {data.busy_s() * 1e3 / n:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
