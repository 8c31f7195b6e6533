"""driver.capture_ms [ms]: the host time the scan driver spent capturing
its CUDA graphs in set-up (ScanLoop.capture_s, the program's own clock
around its captures), on the rank where it is largest. Nothing where the
driver captured no graph (the CPU)."""


def read(ctx):
    if not ctx.on_device:
        return None
    return max(r["capture_s"] for r in ctx.ranks) * 1e3
