"""entry.advance_host_ms [ms]: the host time of one call of the program's
advance (`HeatDiffusion.scan_advance_fn`'s advance: the coefficient, the
scan driver's bind, any capture and the replays), the mean duration of
the `diffusion.advance` spans that lie wholly in a rank's traced slice,
on the rank where it is largest. Set beside a run's device time (252²:
1.93 ms untraced), it says how close the host is to setting the pace: a
call that takes the host as long as the device takes for its work leaves
the device waiting on the host.

The program opens the span as a torch.profiler range while a profiler
session records (rocm_mpi_tpu_torch/telemetry/spans.py), on the trace's
clock; the profiler's own cost a host call is in it. The slice here is
the harness's `stencil_bench.slice` annotation (trace.py), which holds
every traced run whole. Nothing where a rank's slice holds no such span
(a program without it)."""

from stencil_bench import trace

SPAN = "diffusion.advance"


def _bounds(t):
    marks = [e for e in t.host if e.cat == "user_annotation" and e.name == trace.SLICE_NAME]
    return (marks[0].start, marks[0].end) if marks else (t.t0, t.t1)


def read(ctx):
    values = []
    for t in ctx.traces:
        lo, hi = _bounds(t)
        calls = [e.end - e.start for e in t.host
                 if e.cat == "user_annotation" and e.name == SPAN
                 and lo <= e.start and e.end <= hi]
        if not calls:
            return None
        values.append(sum(calls) / len(calls) * 1e3)
    return max(values) if values else None
