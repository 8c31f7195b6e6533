"""The traced slice of a `--trace 1` run: torch.profiler (CPU and CUDA
activity) over a few whole runs in the steady part of the window, read
back from its Chrome trace into plain intervals that the per-layer
readers (stencil_bench/metrics/) reduce.

The slice is bounded by a synchronize at each end and marked by a
`stencil_bench.slice` annotation; it runs from the first device event
inside the annotation to the last one's end (the profiler's start-up and
the closing synchronize are the tool's, not the program's). Device
events are the trace's kernels, copies and sets (`cat` kernel,
gpu_memcpy, gpu_memset); host events its operators and runtime calls.
The trace file goes to the run's TMPDIR and is removed once read, or to
a directory the caller names, where it stays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

SLICE_NAME = "stencil_bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    start: float  # seconds on the trace's clock
    end: float


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint union of (start, end) intervals, sorted."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def measure(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def intersect(xs, ys) -> float:
    """Seconds covered by both unions."""
    xs, ys = union(xs), union(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclasses.dataclass
class TraceData:
    """One rank's slice: its bounds, device and host events, and the
    model steps it holds."""

    t0: float
    t1: float
    steps: int
    device: list[Event]
    host: list[Event]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def spans(self, match=None, cats=DEVICE_CATS, exclude=None) -> list[tuple[float, float]]:
        """Device intervals clipped to the slice; `match`/`exclude`:
        lower-case fragments of the name to keep or drop."""
        out = []
        for e in self.device:
            if e.cat not in cats:
                continue
            name = e.name.lower()
            if match is not None and match not in name:
                continue
            if exclude is not None and exclude in name:
                continue
            a, b = max(e.start, self.t0), min(e.end, self.t1)
            if b > a:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return measure(self.spans())

    def kernels(self, match=None) -> int:
        """The kernels that start in the slice; `match`: a lower-case
        fragment of the name to keep."""
        return sum(1 for e in self.device
                   if e.cat == "kernel" and self.t0 <= e.start < self.t1
                   and (match is None or match in e.name.lower()))

    def gaps(self) -> list[tuple[float, float]]:
        """The slice's idle periods: no device event running."""
        out, at = [], self.t0
        for a, b in union(self.spans()):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host event running at `t`, or "host: untraced"."""
        best = None
        for e in self.host:
            if e.start <= t < e.end and e.name != SLICE_NAME:
                if best is None or e.end - e.start < best.end - best.start:
                    best = e
        return best.name if best is not None else "host: untraced"


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].strip()
    return (name[5:] if name.startswith("void ") else name)[:120]


def parse(path) -> TraceData:
    """TraceData of a Chrome trace holding one slice annotation."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, host, bounds = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"]) * 1e-6
        item = Event(name=str(ev.get("name", "")), cat=str(ev.get("cat", "")), start=start,
                     end=start + float(ev["dur"]) * 1e-6)
        if item.cat in DEVICE_CATS:
            device.append(item)
        elif item.cat in HOST_CATS:
            host.append(item)
            if item.cat == "user_annotation" and item.name == SLICE_NAME:
                bounds = (item.start, item.end)
    if bounds is None:
        raise RuntimeError(f"{path}: no {SLICE_NAME} annotation in the trace")
    inside = [e for e in device if bounds[0] <= e.start < bounds[1]]
    if inside:
        bounds = (min(e.start for e in inside), max(e.end for e in inside))
    return TraceData(t0=bounds[0], t1=bounds[1], steps=0, device=device, host=host)


class Slice:
    """torch.profiler around a stretch of a rank's window."""

    def __init__(self, device, directory, label: str, keep: bool = False):
        self.device = device
        self.path = pathlib.Path(directory) / f"{label}.trace.json"
        self.keep = keep
        self.prof = None
        self.mark = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(SLICE_NAME)
        self.mark.__enter__()

    def stop(self) -> None:
        self._sync()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self, steps: int) -> TraceData:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            data = parse(self.path)
        finally:
            if not self.keep:
                os.unlink(self.path)
        data.steps = int(steps)
        return data


def warm_profiler(device) -> None:
    """One throwaway profiler session, so that the slice's own does not
    pay the profiler's start-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        torch.ones(1024, device=device).sum()
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def breakdown(per_rank: list[TraceData], top: int = 10) -> dict:
    """The line's breakdown: the device operations that took most time
    (seconds a chip, the mean over ranks) and the longest idle gaps,
    each named by what the host was doing in its middle."""
    totals: dict[str, float] = {}
    for data in per_rank:
        for e in data.device:
            a, b = max(e.start, data.t0), min(e.end, data.t1)
            if b > a:
                key = short_name(e.name)
                totals[key] = totals.get(key, 0.0) + (b - a) / len(per_rank)
    gaps = [(b - a, data, (a + b) / 2) for data in per_rank for a, b in data.gaps()]
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[data.host_at(mid), s] for s, data, mid in gaps[:top]]}
