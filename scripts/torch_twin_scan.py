"""Run the profiling twin's loop (apps/diffusion_2d_perf_hide_prof.py:
`hide` under the scan driver, 2×2 of 8192², 300 steps after 12, b_width
(32, 8), f32) on four CUDA ranks under several profiler setups and with the
process group destroyed before or after its graphs end, each under a
time limit and with every rank's Python stacks dumped by faulthandler
before that limit, to find where a run that does not end waits.

    python scripts/torch_twin_scan.py [--cases A,B,...] [--limit S] [--out DIR]
    python scripts/torch_twin_scan.py --device cpu --shape 64 --limit 120   # rehearsal: gloo ranks

Cases (each one launch of 4 ranks over NCCL, in the order given):

- `none`: no profiler (spawn_ranks);
- `none-torchrun`: the same under torchrun (RANK etc. from the environment);
- `cuda-after`: torch.profiler with CUDA activity only, entered after the
  warmup (which captured the graphs), as the twin enters it;
- `both-after`: CPU and CUDA activity, entered after the warmup (the twin);
- `both-active-before`: CPU and CUDA activity through a schedule with one
  warmup stage: CUPTI collects (and drops) through the warmup and its
  captures, and records from the profiler's next step on;
- `<case>-keepalive`: the case with the process group destroyed while
  the advance, and so its CUDA graphs, are alive, as the twin's main()
  did (every other case's graphs end with the rank's function, before
  the launcher destroys the group).

Each case runs in a process group of its own, killed whole at the limit.
Each rank writes `DIR/<case>-rank<r>.txt` (faulthandler's stacks, if the
limit's dump fired, and a closing line); the parent prints one line a
case: ended or not, the seconds, each rank's ms a step and whether its
trace names rmt_fused_step_cm. Exits 0 when every case ends.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = ("none", "both-after", "none-keepalive", "both-after-keepalive", "none-torchrun",
         "cuda-after", "both-active-before")
NT, WARMUP = 300, 12


def _profiler(case: str, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if case.startswith("cuda") else [ProfilerActivity.CPU]
    if cuda and case.startswith("both"):
        acts.append(ProfilerActivity.CUDA)
    if case.endswith("active-before"):
        return profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1))
    return profile(activities=acts)


def case_rank(rank: int, case: str, out_dir: str, dump_s: float, device_type: str,
              edge: int) -> dict:
    import faulthandler

    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.utils import metrics

    log = open(pathlib.Path(out_dir) / f"{case}-rank{rank}.txt", "w")  # noqa: SIM115
    faulthandler.dump_traceback_later(dump_s, exit=False, file=log)
    keepalive = case.endswith("-keepalive")
    case = case.removesuffix("-keepalive")
    try:
        distributed.maybe_initialize_distributed(device_type)
        device = distributed.local_device(device_type)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.set_device(device)
        cfg = DiffusionConfig(global_shape=(edge, edge), lengths=(10.0, 10.0), nt=NT, warmup=WARMUP,
                              dtype="f32", dims=(2, 2), b_width=(32, 8))
        model = HeatDiffusion(cfg, device=device)
        T, Cp = model.init_state()
        advance, q = model.scan_advance_fn("hide", nt=NT, warmup=WARMUP)
        prof = _profiler(case, cuda) if case not in ("none", "none-torchrun") else None
        early = case.endswith("active-before")
        if early:
            prof.start()
        T = advance(T, Cp, WARMUP)
        metrics.settle(T, True, model.grid.group)
        print(f"rank {rank}: warmup done (q {q}, route {advance.loop.route}, graphs "
              f"{len(advance.loop.graphs)})",
              file=log, flush=True)
        if prof is not None and not early:
            prof.start()
        elif early:
            prof.step()
        t0 = time.perf_counter()
        T = advance(T, Cp, NT - WARMUP)
        metrics.settle(T, True, model.grid.group)
        wtime = time.perf_counter() - t0
        print(f"rank {rank}: timed run done in {wtime:.4f} s", file=log, flush=True)
        names = False
        if prof is not None:
            metrics.force(T)
            prof.stop()
            print(f"rank {rank}: profiler stopped", file=log, flush=True)
            names = any("rmt_fused_step_cm" in e.key for e in prof.key_averages())
            trace = pathlib.Path(out_dir) / f"{case}-{int(keepalive)}-trace{rank}.json"
            prof.export_chrome_trace(str(trace))
        if keepalive:
            print(f"rank {rank}: destroying the process group, graphs alive", file=log,
                  flush=True)
            distributed.finalize()
        print(f"rank {rank}: ended", file=log, flush=True)
        return {"ms_step": wtime * 1e3 / (NT - WARMUP), "trace_names_kernel": names}
    finally:
        faulthandler.cancel_dump_traceback_later()
        log.close()


def _torchrun_rank() -> int:
    """The rank body under torchrun (`--rank-case CASE`)."""
    args = _parse()
    r = case_rank(int(os.environ["RANK"]), args.rank_case, args.out, args.limit - 20,
                  args.device, args.shape)
    from rocm_mpi_tpu_torch.parallel import distributed

    if distributed.rank() == 0:
        print("RESULT " + json.dumps(r), flush=True)
    if distributed.is_distributed():
        distributed.finalize()
    return 0


def _spawn_case(args) -> int:
    """The body of one case's process (`--spawn-case CASE`): 4 ranks on
    spawn_ranks; prints each rank's result."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    backend = "nccl" if args.device == "cuda" else "gloo"
    ranks = spawn_ranks(4, case_rank, (args.spawn_case, args.out, args.limit - 20, args.device,
                                       args.shape), backend=backend, timeout=args.limit)
    for r in ranks:
        print("RESULT " + json.dumps(r), flush=True)
    return 0


def run_case(case: str, args) -> dict:
    """One case in a process group of its own, killed whole at the limit."""
    import signal

    common = ["--out", args.out, "--limit", str(args.limit), "--device", args.device,
              "--shape", str(args.shape)]
    if case == "none-torchrun":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", __file__, "--rank-case", case, *common]
    else:
        cmd = [sys.executable, __file__, "--spawn-case", case, *common]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=args.limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return {"case": case, "ended": False, "s": round(time.perf_counter() - t0, 1),
                "err": err[-1500:]}
    res = [json.loads(ln[7:]) for ln in out.splitlines() if ln.startswith("RESULT ")]
    return {"case": case, "ended": proc.returncode == 0, "rc": proc.returncode,
            "s": round(time.perf_counter() - t0, 1), "ranks": res,
            "err": err[-1500:] if proc.returncode else ""}


def _parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--limit", type=float, default=100.0,
                   help="seconds a case may take; the stacks are dumped 20 s before")
    p.add_argument("--out", default=str(ROOT / "output" / "twin_scan"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--shape", type=int, default=8192, help="the global field's edge")
    p.add_argument("--rank-case", default=None, help=argparse.SUPPRESS)
    p.add_argument("--spawn-case", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main() -> int:
    args = _parse()
    if args.rank_case:
        return _torchrun_rank()
    if args.spawn_case:
        return _spawn_case(args)
    import torch

    from rocm_mpi_tpu_torch.apps._common import card_line

    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    if args.device == "cuda":
        print(f"{card_line()} x{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}",
              flush=True)
    ok = True
    for case in args.cases.split(","):
        r = run_case(case, args)
        ok &= r["ended"]
        print(f"[twin-scan] {json.dumps(r)}", flush=True)
        for f in sorted(pathlib.Path(args.out).glob(f"{case}-rank*.txt")):
            text = f.read_text()
            if "Thread" in text:  # faulthandler fired: the stacks of a rank that waited
                print(f"--- {f.name}\n{text[-3000:]}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
