"""fused_step_cm_roofline [%]: the bytes a step of fused_step_cm must
move over a rank's shard (stencil_bench/roofline/fused_step_cm.py: the
shard's T and Cm and the received faces read once, the new T written
once) at the card's published 3.35 TB/s, as a share of the union of the
intervals of the step's launches (the `hide` step's five boxes, on two
streams) a step in the traced slice; the mean over ranks."""

from stencil_bench import trace
from stencil_bench.roofline import fused_step_cm, peaks


def read(ctx):
    shares = []
    for r in ctx.ranks:
        data = r.get("trace")
        spans = data.spans(match="fused_step_cm", cats=("kernel",)) if data else []
        if not spans or not data.steps:
            return None
        per_step = trace.measure(spans) / data.steps
        need = fused_step_cm.bytes_per_step(r["local_shape"], r["itemsize"], r["coords"],
                                            r["dims"])
        shares.append(100.0 * need / peaks.HBM_BYTES_PER_S / per_step)
    return sum(shares) / len(shares)
