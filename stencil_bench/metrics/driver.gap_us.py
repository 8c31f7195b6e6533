"""driver.gap_us [us]: the device time a run in which nothing ran, over
the kernels a run launches (graph nodes included): the gap the scan
driver (models/scan.py ScanLoop) leaves between kernels; the mean over
ranks. A run's device time is the median untraced run's, by CUDA events;
its busy time and kernels are the traced slice's, a run's share (see
device.idle_pct.py for why the slice's own gaps are not used, and why
the difference of two runs' readings can fall below 0 where the device
is never idle)."""


def read(ctx):
    values = []
    for r in ctx.ranks:
        t = r.get("trace")
        if t is None or not t.steps or not ctx.on_device or not r.get("run_device_s"):
            return None
        runs = t.steps / r["steps_per_run"]
        kernels = t.kernels() / runs
        if not kernels:
            return None
        values.append((r["run_device_s"] - t.busy_s() / runs) / kernels * 1e6)
    return sum(values) / len(values) if values else None
