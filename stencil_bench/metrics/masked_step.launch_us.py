"""masked_step.launch_us [us]: the device time of one masked_step launch,
the union of the kernel's intervals in the traced slice over its
launches there; the mean over ranks. Where a step's bytes are few (252²:
1.5 MB, 0.45 us at 3.35 TB/s), this is the kernel's fixed cost, which
sets the pace of the step. It reads the kernel's own intervals, so the
spacing that the profiler puts between a graph's nodes (device.idle_pct.py)
does not enter it."""

from stencil_bench import trace


def read(ctx):
    values = []
    for t in ctx.traces:
        spans = t.spans(match="masked_step", cats=("kernel",))
        launches = t.kernels(match="masked_step")
        if not spans or not launches:
            return None
        values.append(trace.measure(spans) / launches * 1e6)
    return sum(values) / len(values) if values else None
