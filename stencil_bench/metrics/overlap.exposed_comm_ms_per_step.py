"""overlap.exposed_comm_ms_per_step [ms]: the time a step in which an
NCCL kernel runs and no other kernel does (what parallel/overlap.py's
interior box leaves uncovered), on the rank where it is largest.
Nothing where no NCCL kernel ran."""

from stencil_bench import trace


def read(ctx):
    values = []
    for t in ctx.traces:
        comm = t.spans(match="nccl", cats=("kernel",))
        compute = t.spans(cats=("kernel",), exclude="nccl")
        if not comm or not t.steps:
            return None
        exposed = trace.measure(comm) - trace.intersect(comm, compute)
        values.append(exposed / t.steps * 1e3)
    return max(values) if values else None
