"""device.idle_pct [%]: the share of a run's device time in which no
kernel, copy or set ran on any stream of the rank's device; the mean
over ranks. The device time of a run is taken by CUDA events around the
window's untraced runs (the median run); the busy time of a run is the
union of the device events of the traced slice, a run's share. The
slice's own spacing is not the program's: with the profiler on, a
graph's nodes at 252^2 run 2.5 us apart against 1.94 us without it.

The two readings come from different runs of one process, so the share
reads below 0 where the traced kernels take longer than the untraced
runs' whole device time: at 12288^2, where the device is never idle, it
read -0.16 to -0.07 (H100 80GB HBM3, 700 W), the profiler adding about
0.1 % to masked_step. So a change of less than 0.2 points is not
resolved, and a reading below 0 says the device had no idle time to
find, not that less idle time can be bought."""


def read(ctx):
    values = []
    for r in ctx.ranks:
        t = r.get("trace")
        if t is None or not t.steps or not ctx.on_device or not r.get("run_device_s"):
            return None
        busy_run = t.busy_s() * r["steps_per_run"] / t.steps
        values.append(100.0 * (1.0 - busy_run / r["run_device_s"]))
    return sum(values) / len(values) if values else None
