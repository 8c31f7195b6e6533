"""Host cost of the port's telemetry spans (telemetry/spans.py), and of
one scan-driver advance call at 252² f64, with and without the profiler.

    python3 scripts/torch_span_cost.py [--json PATH] [--device cpu]

Run from the repository root. Printed, in µs a span (an empty `with
span(...)` block, the median of 5 batches):

  off        telemetry off, no profiler: the no-op singleton (and
             `off_call`: the `span(...)` call alone, without the block);
  profiler   a torch.profiler session recording (CPU, and CUDA on a
             card): the span a record_function range, no record;
  telemetry  telemetry on (a JSONL record appended to a file in a
             temporary directory), no profiler;
  both       telemetry on under the profiler.

Then the program's advance as the benchmark's diff2d-perf-f64-252 cell
runs it (`HeatDiffusion.scan_advance_fn("perf")`, 252², f64, nt = 1000:
a graph of 10 steps replayed 100 times a call), 200 calls with three
queued behind the one the device runs: the host ms a call (the clock
around the call, which returns before its device work ends) and, on a
card, the device ms a call by CUDA events, plain, under the profiler and
with telemetry on; and from the telemetry-on calls' own records (no
profiler), the median host ms of each of the four spans and the host µs
a replay (`scan.replay` over its replays). Every number carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _per_span_us(n: int) -> float:
    from rocm_mpi_tpu_torch.telemetry.spans import span

    batches = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("scan.replay", phase="replay"):
                pass
        batches.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(batches)


def _call_us(n: int) -> float:
    from rocm_mpi_tpu_torch.telemetry.spans import span

    batches = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            span("scan.replay", phase="replay")
        batches.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(batches)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _advance_calls(device, calls: int = 200, queued: int = 3) -> dict:
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models.diffusion import HeatDiffusion

    cfg = DiffusionConfig(global_shape=(252, 252), lengths=(10.0, 10.0), lam=1.0, cp0=1.0,
                          nt=1000, warmup=0, dtype="f64", dims=(1, 1))
    model = HeatDiffusion(cfg, device=device)
    advance, _ = model.scan_advance_fn("perf", nt=1000, warmup=0)
    T, Cp = model.init_state()
    T = advance(T, Cp, 1000)  # builds, loads and captures
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    host, marks = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        T = advance(T, Cp, 1000)
        host.append(time.perf_counter() - t0)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            if len(marks) > queued:
                marks[-1 - queued].synchronize()
    out = {"host_ms_a_call": statistics.median(host) * 1e3}
    if cuda:
        torch.cuda.synchronize(device)
        dev = [marks[k - 1].elapsed_time(marks[k]) for k in range(1, len(marks))]
        out["device_ms_a_call"] = statistics.median(dev)
    advance.loop.release()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, metavar="PATH")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT))
    from rocm_mpi_tpu_torch.telemetry import events

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_span_cost: no CUDA card (pass --device cpu)", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        from rocm_mpi_tpu_torch.apps._common import card_line

        card = card_line()
    row = {"card": card, "torch": torch.__version__, "python": sys.version.split()[0]}
    with tempfile.TemporaryDirectory() as tmp:
        row["off_us"] = _per_span_us(200_000)
        row["off_call_us"] = _call_us(200_000)
        with _profiler(device):
            row["profiler_us"] = _per_span_us(10_000)
        events.configure(directory=tmp, rank=0)
        row["telemetry_us"] = _per_span_us(10_000)
        with _profiler(device):
            row["both_us"] = _per_span_us(5_000)
        stream = pathlib.Path(events.stream_path())
        row["record_bytes"] = len(stream.read_text().splitlines()[-1]) + 1
        events.configure(enabled=False)
        events.clear()
        row["advance"] = {"plain": _advance_calls(device)}
        with _profiler(device):
            row["advance"]["profiler"] = _advance_calls(device)
        events.clear()
        events.configure(enabled=True)
        row["advance"]["telemetry"] = _advance_calls(device)
        events.configure(enabled=False)
        recs = events.records("span")
        row["span_ms"] = {name: statistics.median(r["dur_s"] for r in recs
                                                  if r["name"] == name) * 1e3
                          for name in sorted({r["name"] for r in recs})}
        row["replay_us"] = statistics.median(r["dur_s"] / r["attrs"]["replays"] for r in recs
                                             if r["name"] == "scan.replay") * 1e6
        events.clear()
    for key in ("off_us", "off_call_us", "profiler_us", "telemetry_us", "both_us"):
        print(f"span {key[:-3]:10s} {row[key]:.4f} us ({card})")
    print(f"span record {row['record_bytes']} bytes")
    for mode, got in row["advance"].items():
        dev = got.get("device_ms_a_call")
        print(f"advance 252^2 f64 {mode:10s} host {got['host_ms_a_call']:.4f} ms a call"
              + (f", device {dev:.4f} ms a call" if dev is not None else "") + f" ({card})")
    for name, ms in row["span_ms"].items():
        print(f"span {name} {ms:.4f} ms a call, telemetry on ({card})")
    print(f"scan.replay {row['replay_us']:.4f} us a replay, telemetry on ({card})")
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(row, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
