"""masked_step_roofline [%]: the bytes one masked_step launch must move
(stencil_bench/roofline/masked_step.py: T and Cm read once, the new T
written once) at the card's published 3.35 TB/s, as a share of the
union of the kernel's intervals a step in the traced slice; the mean
over ranks. Read by the device trace."""

from stencil_bench import trace
from stencil_bench.roofline import masked_step, peaks


def read(ctx):
    shares = []
    for r in ctx.ranks:
        data = r.get("trace")
        spans = data.spans(match="masked_step", cats=("kernel",)) if data else []
        if not spans or not data.steps:
            return None
        per_step = trace.measure(spans) / data.steps
        need = masked_step.bytes_per_launch(r["local_shape"], r["itemsize"])
        shares.append(100.0 * need / peaks.HBM_BYTES_PER_S / per_step)
    return sum(shares) / len(shares)
