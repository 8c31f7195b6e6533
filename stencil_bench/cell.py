"""One rank of a cell: set-up, the timed window, the traced slice, the check.

The program is the configuration's adapter (stencil_bench/programs/
<program>.py, found by name). Set-up builds it, makes the seed's inputs,
and makes one run: that run builds or loads the kernels and captures the
graphs, so that nothing compiles or captures inside the window.

The window runs whole runs back to back, with the traffic's
`queued_runs` runs queued behind the one the device executes, until
`seconds` have passed; the ranks of a sharded cell agree on the last run
over a host-side (gloo) group. Python's collector is off inside the
window (the reference's hide app turns Julia's off around its loop).

The check: once the window has closed, the last run's result is kept,
the program's state freed, and the plain reference run and held against
it.
"""

from __future__ import annotations

import gc
import math
import statistics
import tempfile
import time

class Ranks:
    """This rank's device and the host-side group of a sharded cell."""

    def __init__(self, rank: int, config: dict, device: str):
        import torch
        import torch.distributed as dist

        if device == "cuda":
            self.device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        self.group = None
        if math.prod(int(d) for d in config["process_grid"]) > 1:
            dist.barrier()
            self.group = dist.new_group(backend="gloo")

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        import torch.distributed as dist

        self.sync()
        if self.group is not None:
            dist.barrier(group=self.group)

    def agree(self, flag: bool) -> bool:
        """True on every rank when it is on any."""
        import torch
        import torch.distributed as dist

        if self.group is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def build(rank: int, spec: dict):
    """(Ranks, Program) of this rank for the spec's cell."""
    from stencil_bench import registry

    config = spec["config"]
    me = Ranks(rank, config, spec["device"])
    adapter = registry.program(config["program"], spec.get("root"))
    return me, adapter.Program(rank, config, spec["traffic"], me.device)


def run_rank(rank: int, spec: dict) -> dict:
    """Run the cell on this rank; returns the facts the line is made of."""
    import torch

    from stencil_bench import guard, trace

    traffic = spec["traffic"]
    me, prog = build(rank, spec)
    device = me.device
    prog.set_seed(spec["seed"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog.run()
    plan = None
    if spec["trace"]:
        trace.warm_profiler(device)
        plan = (int(traffic["trace_skip_runs"]), int(traffic["trace_runs"]))
        keep = spec.get("trace_dir") is not None
        tslice = trace.Slice(device, spec["trace_dir"] if keep else tempfile.gettempdir(),
                             f"{spec['workload']}-seed{spec['seed']}-rank{rank}", keep=keep)
    launches = prog.loop_facts()["launches"]
    me.barrier()

    # ---- the window -------------------------------------------------------
    queued = int(traffic["queued_runs"])
    gc.collect()
    gc.disable()  # no collector pause inside the window
    window_wall = time.time()
    t0 = time.perf_counter()
    runs, events = 0, []
    while True:
        if plan and runs == plan[0]:
            tslice.start()
        prog.run()
        runs += 1
        if plan and runs == plan[0] + plan[1]:
            tslice.stop()
        if device.type == "cuda":
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            if len(events) > queued:
                events[-1 - queued].synchronize()
        done = time.perf_counter() - t0 >= float(spec["seconds"])
        if plan:
            done = done and runs >= plan[0] + plan[1]
        if me.agree(done):
            break
    me.barrier()
    window_s = time.perf_counter() - t0
    gc.enable()
    # The device seconds of each untraced run (from the end of the run
    # before it to its own end, by CUDA events), away from the slice.
    traced = range(plan[0], plan[0] + plan[1] + 1) if plan else range(0)
    run_device = [events[k - 1].elapsed_time(events[k]) * 1e-3
                  for k in range(1, len(events)) if k not in traced]
    loop = prog.loop_facts()
    launched = {k: v - launches.get(k, 0) for k, v in loop["launches"].items()
                if v != launches.get(k, 0)}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    facts = dict(prog.facts)
    facts.update({
        "rank": rank, "setup_s": window_wall - float(spec["t_start"]), "window_s": window_s,
        "runs": runs, "q": loop["q"], "route": loop["route"], "capture_s": loop["capture_s"],
        "launches": launched, "peak_bytes": peak, "forbidden": guard.forbidden_loaded(),
        "run_device_s": statistics.median(run_device) if run_device else None,
    })
    if plan:
        facts["trace"] = tslice.read(plan[1] * facts["steps_per_run"])

    # ---- the check: the program's state freed, then the reference --------
    output = prog.output()
    prog.release()
    t = time.perf_counter()
    facts["readings"] = prog.readings(output)
    facts["check_s"] = time.perf_counter() - t
    return facts
