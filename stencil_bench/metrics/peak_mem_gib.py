"""peak_mem_gib [GiB]: torch.cuda.max_memory_allocated over the program's
set-up and the window, on the fullest rank; the statistics are reset once
the inputs are made. Nothing on the CPU, which has no device memory."""


def read(ctx):
    peaks = [r["peak_bytes"] for r in ctx.ranks if r["peak_bytes"] is not None]
    return max(peaks) / 2 ** 30 if ctx.on_device and peaks else None
