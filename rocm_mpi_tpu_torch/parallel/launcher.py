"""Minimal multi-rank launcher — counterpart of
rocm_mpi_tpu/parallel/launcher.py, enough for tests and one-host checks.

`spawn_ranks(n, fn, args)` starts n fresh processes (spawn start method),
joins them into one process group whose key-value store the launcher
serves on localhost, runs `fn(rank, *args)` in each and returns the n
results in rank order. `fn` and its arguments must be picklable (a
module-level function). A rank that raises or dies fails the whole
launch with its traceback; every process is joined or killed before this
returns.

The launcher binds the store itself, on a port the system picks, and
hands the ranks that port: a port found free and released for a rank to
bind later can be taken by any other socket in between (EADDRINUSE).
"""

from __future__ import annotations

import queue as queue_mod
import time
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world_size, port, backend, fn, args, results):
    import os

    from rocm_mpi_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    try:
        distributed.init_distributed(rank, world_size, port, backend)
        try:
            out = fn(rank, *args)
        finally:
            distributed.finalize()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, then exits
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(n: int, fn, args=(), backend: str = "gloo",
                timeout: float = 300.0) -> list:
    """Run `fn(rank, *args)` on `n` ranks of one process group; returns
    the per-rank results in rank order. Raises RuntimeError naming the
    first failed rank, or TimeoutError if the ranks do not all report
    within `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore("localhost", 0, n, is_master=True, wait_for_workers=False)
    port = store.port
    procs = [
        ctx.Process(target=_rank_main,
                    args=(r, n, port, backend, fn, tuple(args), results))
        for r in range(n)
    ]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} without reporting")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n - len(got)} of {n} ranks did not report within "
                        f"{timeout} s"
                    ) from None
                continue
            if ok:
                got[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=30 if failure is None else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(n)]
