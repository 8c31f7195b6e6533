"""gcells_per_s [Gcells/s]: global cells times the steps the window
completed, over the window's seconds. Host clock; the device synchronised
and every rank barriered at both ends; the slowest rank's window. All the
work over all the time: the per-run initial field and the advance's
per-call coefficient included."""

from stencil_bench import units


def read(ctx):
    first = ctx.ranks[0]
    steps = first["runs"] * first["steps_per_run"]
    window = max(r["window_s"] for r in ctx.ranks)
    return units.gpts_per_s(first["global_shape"], units.wtime_per_it(window, steps, 0))
