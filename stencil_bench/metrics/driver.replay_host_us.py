"""driver.replay_host_us [us]: the host time of one CUDA graph replay in
the scan driver (models/scan.py ScanLoop.__call__): in each rank's traced
slice, the seconds covered by the program's `scan.replay` spans over the
cudaGraphLaunch runtime calls that start inside them; the mean over
ranks. The span holds the replay loop alone (each replay's launch and
the launch counts' bookkeeping), once a call, so this is what a replay
costs the host, the margin by which the host stays ahead of 252²'s
2 µs graph nodes.

The program opens its spans as torch.profiler ranges while a profiler
session records (rocm_mpi_tpu_torch/telemetry/spans.py), so they lie on
the trace's clock as `user_annotation` host events. The slice here is the
harness's `stencil_bench.slice` annotation (trace.py), which holds every
traced run whole. Nothing where a rank's slice holds no such span or no
launch inside one: a program without the spans, or a route that replays
no graph (the CPU's)."""

from stencil_bench import trace

SPAN = "scan.replay"


def _bounds(t):
    marks = [e for e in t.host if e.cat == "user_annotation" and e.name == trace.SLICE_NAME]
    return (marks[0].start, marks[0].end) if marks else (t.t0, t.t1)


def read(ctx):
    values = []
    for t in ctx.traces:
        lo, hi = _bounds(t)
        spans = trace.union((max(e.start, lo), min(e.end, hi)) for e in t.host
                            if e.cat == "user_annotation" and e.name == SPAN
                            and e.end > lo and e.start < hi)
        launches = sum(1 for e in t.host
                       if e.cat == "cuda_runtime" and "graphlaunch" in e.name.lower()
                       and any(a <= e.start < b for a, b in spans))
        if not spans or not launches:
            return None
        values.append(trace.measure(spans) / launches * 1e6)
    return sum(values) / len(values) if values else None
