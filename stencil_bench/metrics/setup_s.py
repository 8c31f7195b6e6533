"""setup_s [s]: from the start of the benchmark's process to the
window's first step, on the last rank to get there: imports, CUDA and
NCCL initialisation, the ranks' start, the inputs, the kernels' build
(a cold checkout) or load, the graphs' capture and one warm-up run."""


def read(ctx):
    return max(r["setup_s"] for r in ctx.ranks)
