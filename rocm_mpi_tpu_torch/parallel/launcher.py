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

Telemetry, the JAX launcher's environment contract: every rank gets
RMT_PROCESS_ID; `telemetry_dir` sets RMT_TELEMETRY=1 and
RMT_TELEMETRY_DIR in each rank (its stream `telemetry-rank<r>.jsonl`),
`health_dir` RMT_HEALTH=1 and RMT_HEALTH_DIR (the heartbeat sidecars,
which an app's setup_health arms; stale sidecars of an earlier launch in
the directory are removed first). After every rank is joined the
launcher merges the streams into `telemetry-summary.json` and
`telemetry-trace.json` beside them. The watchdog and supervised restarts
belong to the resilience plane (not ported).
"""

from __future__ import annotations

import os
import pathlib
import queue as queue_mod
import time
import traceback
import warnings

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world_size, port, backend, fn, args, results, env):
    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.telemetry import events

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["RMT_PROCESS_ID"] = str(rank)
    os.environ.update(env)
    events.configure_from_env()
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


def _rank_env(telemetry_dir, health_dir) -> dict:
    """The telemetry and health variables every rank gets."""
    env = {}
    if telemetry_dir:
        os.makedirs(telemetry_dir, exist_ok=True)
        env.update(RMT_TELEMETRY="1", RMT_TELEMETRY_DIR=str(telemetry_dir))
    if health_dir:
        os.makedirs(health_dir, exist_ok=True)
        # The sidecars are this launch's state: an earlier run's heartbeats
        # in a reused directory would read as this run's progress.
        for pattern in ("heartbeat-rank*.json", "postmortem-rank*.json",
                        "postmortem-rank*.traceback"):
            for stale in pathlib.Path(health_dir).glob(pattern):
                stale.unlink(missing_ok=True)
        env.update(RMT_HEALTH="1", RMT_HEALTH_DIR=str(health_dir))
    return env


def merge_telemetry(telemetry_dir) -> dict | None:
    """Merge `telemetry_dir`'s rank streams into telemetry-summary.json
    and telemetry-trace.json there (heartbeat sidecars in the directory
    ride in as progress tracks); returns the summary, None when there is
    no stream."""
    from rocm_mpi_tpu_torch.telemetry import aggregate, health, trace

    streams, skipped = aggregate.load_rank_streams(telemetry_dir)
    if not streams:
        return None
    summary = aggregate.summarize(streams, skipped)
    aggregate.write_json_atomic(pathlib.Path(telemetry_dir) / "telemetry-summary.json", summary)
    beats, _ = health.load_heartbeats(telemetry_dir)
    trace.write_chrome_trace(streams, pathlib.Path(telemetry_dir) / "telemetry-trace.json",
                             heartbeats=beats or None)
    return summary


def spawn_ranks(n: int, fn, args=(), backend: str = "gloo",
                timeout: float = 300.0, telemetry_dir=None, health_dir=None) -> list:
    """Run `fn(rank, *args)` on `n` ranks of one process group; returns
    the per-rank results in rank order. Raises RuntimeError naming the
    first failed rank, or TimeoutError if the ranks do not all report
    within `timeout` seconds. `telemetry_dir` and `health_dir` set the
    telemetry environment in each rank (module docstring); the streams
    are merged once every rank is joined, whatever the ranks' outcome."""
    env = _rank_env(telemetry_dir, health_dir)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore("localhost", 0, n, is_master=True, wait_for_workers=False)
    port = store.port
    procs = [
        ctx.Process(target=_rank_main,
                    args=(r, n, port, backend, fn, tuple(args), results, env))
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
        if telemetry_dir:
            # After every rank is joined: the append-only streams are
            # complete (or cleanly torn). Observability never fails a launch.
            try:
                merge_telemetry(telemetry_dir)
            except Exception as exc:  # noqa: BLE001
                warnings.warn(f"telemetry merge of {telemetry_dir} failed: {exc!r}",
                              stacklevel=2)
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(n)]
