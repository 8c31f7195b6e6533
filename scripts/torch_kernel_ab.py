"""Time two checkouts of the PyTorch/CUDA port's tb_sweep and kp_update
side by side on one CUDA card.

    python scripts/torch_kernel_ab.py --roots OLD NEW NEW OLD [--json PATH]

Each root is a directory that holds a `rocm_mpi_tpu_torch/` package (a
checkout, or an unpacked `git archive` of one). Every root runs in a
process of its own, in the order given, so the kernels of each are built
from its own sources into its own `_build/`; list each root twice, in the
order old, new, new, old, so that a drift of the card's clocks shows.
Each process:

- times `multistep.tb_sweep` (2D, f32/f64/bf16) at 12304² and 6160²,
  k = 8, and at 12320², k = 16: the median of CUDA-event-timed launches,
  each launch held bitwise against `tb_sweep_plain` first;
- times the host path of `kp.kp_update` at 128² f32: calls back to back,
  no sync between them, µs a call (median of repeats). Where the root has
  plain comparisons in front of the checks that name a fault (the shared
  `kernels._operands_ok`, or a wrapper's own `kp._update_operands_ok`),
  the wrapper is also timed with those comparisons made to refuse every
  call, so that the checks behind them run each time.

The card's name and power limit (nvidia-smi) head the output; one JSON
object per process follows, and `--json` writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TB_CASES = (((12304, 12304), 8), ((6160, 6160), 8), ((12320, 12320), 16))
DTYPES = ("f32", "f64", "bf16")
KP_SHAPE = (128, 128)
HOST_CALLS = 2000
HOST_REPEATS = 7
SEED = 1234


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` launches of fn, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(torch, fn) -> float:
    """Host µs a call of fn, HOST_CALLS calls back to back (median of
    HOST_REPEATS repeats)."""
    fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(HOST_REPEATS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        reads.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(reads)


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from rocm_mpi_tpu_torch.ops import kernels, kp, multistep

    assert os.path.abspath(multistep.__file__).startswith(os.path.abspath(root))
    dev = torch.device("cuda", 0)
    tdts = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
    result = {"root": root, "tb_sweep": [], "kp_update_host_us": {}}
    inv_d2 = (1.0, 1.0)
    for shape, k in TB_CASES:
        for name in DTYPES:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            T = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(tdts[name])
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 0.2).to(tdts[name])
            out = torch.empty_like(T)
            got = multistep.tb_sweep(T, Cm, inv_d2, k, out=out)
            want = multistep.tb_sweep_plain(T, Cm, inv_d2, k)
            equal = bool(torch.equal(got, want))
            del want
            ms = time_ms(torch, lambda: multistep.tb_sweep(T, Cm, inv_d2, k, out=out), 20)
            row = {"shape": list(shape), "k": k, "dtype": name, "ms": ms, "bitwise": equal}
            result["tb_sweep"].append(row)
            print(f"[ab] {root} tb_sweep {shape[0]}x{shape[1]} k={k} {name}: {ms:.4f} ms, "
                  f"bitwise {equal}", flush=True)
            del T, Cm, out, got
            torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lx, ly = KP_SHAPE
    Tp = torch.rand((lx + 2, ly + 2), generator=gen, device=dev)
    dTdt = torch.rand((lx, ly), generator=gen, device=dev)
    out = torch.empty((lx, ly), device=dev)
    result["kp_update_host_us"]["wrapper"] = host_us(
        torch, lambda: kp.kp_update(Tp, dTdt, 1e-3, out=out))
    for module, name in ((kp, "_update_operands_ok"), (kernels, "_operands_ok")):
        if hasattr(module, name):
            setattr(module, name, lambda *args: False)
            result["kp_update_host_us"][f"without {name}"] = host_us(
                torch, lambda: kp.kp_update(Tp, dTdt, 1e-3, out=out))
    print(f"[ab] {root} kp_update 128² f32 host µs a call: {result['kp_update_host_us']}",
          flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", help="checkouts to time, in order")
    parser.add_argument("--json", help="write the results here")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print("AB_RESULT " + json.dumps(worker(args.worker)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ab] card: {card}", flush=True)
    results = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            print(f"[ab] {root}: worker failed (rc {proc.returncode})", flush=True)
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT ")][-1]
        results.append(json.loads(line[len("AB_RESULT "):]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)
    ok = all(r["bitwise"] for run in results for r in run["tb_sweep"])
    print(f"[ab] every tb_sweep launch bitwise equal to its plain version: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
