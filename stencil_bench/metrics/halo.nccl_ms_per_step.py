"""halo.nccl_ms_per_step [ms]: the union of the NCCL kernels' intervals
(the face exchange of parallel/halo.py exchange_faces, captured in the
graphs) a step in the traced slice, on the rank where it is largest.
Nothing where no NCCL kernel ran."""

from stencil_bench import trace


def read(ctx):
    values = []
    for t in ctx.traces:
        spans = t.spans(match="nccl", cats=("kernel",))
        if not spans or not t.steps:
            return None
        values.append(trace.measure(spans) / t.steps * 1e3)
    return max(values) if values else None
