"""Multi-rank launchers — counterpart of rocm_mpi_tpu/parallel/launcher.py.

Two launchers, one for functions and one for programs.

`spawn_ranks(n, fn, args)` starts n fresh processes (spawn start method),
joins them into one process group whose key-value store the launcher
serves on localhost, runs `fn(rank, *args)` in each and returns the n
results in rank order. `fn` and its arguments must be picklable (a
module-level function). A rank that raises or dies fails the whole
launch with its traceback; every process is joined or killed before this
returns.

`spawn_app_ranks(argv, nprocs, …)` runs `[sys.executable] + argv` (an app,
`-m rocm_mpi_tpu_torch.apps.…`, or a script) on nprocs ranks under
supervision, the JAX launcher's role, and returns RankResults: the
(Popen, (stdout, stderr)) of each rank, with `.report` (a LaunchReport)
saying who failed first, which hung peers it killed, the watchdog's
verdicts and a vanished rank. The environment contract of each rank:

  * torchrun's RANK, LOCAL_RANK (= RANK: one host), WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT, with TORCHELASTIC_USE_AGENT_STORE=True:
    the launcher hosts the TCPStore itself, on a port the system picks,
    and every rank joins it as a client through torch's env rendezvous
    (`distributed.maybe_initialize_distributed`, which binds
    cuda:LOCAL_RANK first), so no port is found free and released;
  * RMT_PROCESS_ID (the rank, for telemetry and fault scoping before the
    group forms);
  * RMT_INJECT_FAULT (`inject_fault`, resilience/faults.py),
    RMT_PREEMPT_GRACE_S (`preempt_grace_s`, resilience/preempt.py),
    RMT_INIT_TIMEOUT_S (`init_timeout_s`, the process group's timeout);
  * RMT_TELEMETRY=1 and RMT_TELEMETRY_DIR (`telemetry_dir`: each rank's
    stream, merged into telemetry-summary.json and telemetry-trace.json
    once every rank has exited), RMT_HEALTH=1 and RMT_HEALTH_DIR
    (`health_dir`: the heartbeat sidecars, stale ones removed first).

Supervision, a thread beside the ranks' pipe readers: the first nonzero
exit is recorded (rank, rc, time) and, `peer_grace_s` later, the peers
still running — wedged in a collective the dead rank abandoned — are
killed with SIGKILL (a rank inside a CUDA-graph replay waiting on NCCL
runs no Python signal handler, and NCCL's own watchdog takes minutes).
With `health_dir` the thread is also the progress watchdog
(`watchdog_tick`, telemetry/health.ProgressWatch): a rank whose step
counter stalls while the cross-rank median advances gets SIGUSR2 (its
all-thread traceback), a post-mortem, and the kill; the post-mortem
bundle is written at the end. `vanish_grace_s` reclassifies a clean exit
that leaves peers running past the grace as a death (fault kind `die`).
`forward_preempt` relays a SIGTERM sent to the launcher to every live
rank; `on_spawn(procs)` is called once all ranks have started. Every
rank is killed on any exit path.

Both launchers bind the rendezvous store themselves, on a port the
system picks, and hand the ranks that port: a port found free and
released for a rank to bind later can be taken by any other socket in
between (EADDRINUSE). Both launchers' telemetry: `telemetry_dir` and
`health_dir` set the variables above in each rank; after every rank is
joined the launcher merges the streams (`merge_telemetry`).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import queue as queue_mod
import shutil
import signal
import subprocess
import sys
import threading
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
        _clear_sidecars(health_dir)
        env.update(RMT_HEALTH="1", RMT_HEALTH_DIR=str(health_dir))
    return env


def _clear_sidecars(health_dir) -> None:
    """The sidecars are a launch's own state: an earlier run's heartbeats
    in a reused directory would read as this run's progress (and feed the
    watchdog old counters), its post-mortems as this run's incident."""
    os.makedirs(health_dir, exist_ok=True)
    for pattern in ("heartbeat-rank*.json", "postmortem-rank*.json",
                    "postmortem-rank*.traceback"):
        for stale in pathlib.Path(health_dir).glob(pattern):
            stale.unlink(missing_ok=True)


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


# ---------------------------------------------------------------------------
# The argv launcher: supervised ranks of a program
# ---------------------------------------------------------------------------

_ROOT = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class LaunchReport:
    """What the supervision thread observed: who failed first, when, and
    which hung peers it put down."""

    first_failure: tuple[int, int, float] | None = None  # (rank, rc, t_s)
    killed_after_failure: list[int] = dataclasses.field(default_factory=list)
    events: list[str] = dataclasses.field(default_factory=list)
    # Progress-watchdog verdicts (health_dir runs): one dict per flagged
    # rank — rank, step, median_step, stalled_for_s, last phase, t.
    watchdog_verdicts: list[dict] = dataclasses.field(default_factory=list)
    # Vanish detection (vanish_grace_s runs): the rank that exited rc 0
    # while its peers ran on past the grace; first_failure is set with rc 0.
    vanished: int | None = None

    def note(self, msg: str) -> None:
        self.events.append(msg)
        if os.environ.get("RMT_LAUNCH_VERBOSE"):
            print(f"[launcher] {msg}", file=sys.stderr, flush=True)


class RankResults(list):
    """`[(proc, (stdout, stderr)), ...]` in rank order, with the
    supervision report attached as `.report`."""

    report: LaunchReport


def _app_rank_env(base: dict, rank: int, nprocs: int, port: int, *, inject_fault,
                  preempt_grace_s, init_timeout_s, telemetry_dir, health_dir) -> dict:
    """The environment of rank `rank` (module docstring)."""
    env = dict(
        base,
        RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
        LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
        TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0",
        RMT_PROCESS_ID=str(rank),
        # The child gets the script's directory on sys.path only: prepend
        # the repository, keep what was there.
        PYTHONPATH=os.pathsep.join([str(_ROOT)] + ([base["PYTHONPATH"]]
                                                   if base.get("PYTHONPATH") else [])),
    )
    if inject_fault:
        env["RMT_INJECT_FAULT"] = inject_fault
    if preempt_grace_s is not None:
        env["RMT_PREEMPT_GRACE_S"] = str(preempt_grace_s)
    if init_timeout_s is not None:
        env["RMT_INIT_TIMEOUT_S"] = str(init_timeout_s)
    env.update(_rank_env(telemetry_dir, None))
    if health_dir:
        env.update(RMT_HEALTH="1", RMT_HEALTH_DIR=str(health_dir))
    return env


def spawn_app_ranks(
    argv,
    nprocs: int = 2,
    timeout: float = 240,
    init_timeout_s: float | None = None,
    inject_fault: str | None = None,
    heartbeat_s: float = 10.0,
    peer_grace_s: float = 20.0,
    telemetry_dir=None,
    health_dir=None,
    stall_grace_s: float = 6.0,
    postmortem_grace_s: float = 1.5,
    vanish_grace_s: float | None = None,
    preempt_grace_s: float | None = None,
    forward_preempt: bool = False,
    on_spawn=None,
):
    """Run `[sys.executable] + argv` on `nprocs` supervised ranks; return
    RankResults of (proc, (stdout, stderr)) in rank order with `.report`
    (module docstring). Callers judge the returncodes: a rank killed at
    `timeout` or after a peer's failure reports its signal's code with
    whatever it flushed. `init_timeout_s` (default: torch's) becomes the
    process group's timeout in each rank. `heartbeat_s` spaces the
    report's liveness notes; `stall_grace_s` is the watchdog's grace (no
    progress while the cross-rank median is ahead) and
    `postmortem_grace_s` the wait between SIGUSR2 and the kill.
    `vanish_grace_s` (default off) arms vanish detection: a clean exit
    is a death when peers run on past the grace (with the health plane
    on, their progress must also be that old, so a slow but progressing
    rank is never reclassified) or when a peer fails within the grace
    after it (a gloo peer orphaned mid-collective fails at once)."""
    import torch.distributed as dist

    base = os.environ.copy()
    if health_dir:
        _clear_sidecars(health_dir)
        # And an earlier launch's bundle: a clean launch leaves none.
        shutil.rmtree(pathlib.Path(health_dir) / "postmortem", ignore_errors=True)
    # The rendezvous store lives here, for the launch: every rank is a client.
    store = dist.TCPStore("127.0.0.1", 0, nprocs, is_master=True, wait_for_workers=False)
    procs = []
    for rank in range(nprocs):
        env = _app_rank_env(base, rank, nprocs, store.port, inject_fault=inject_fault,
                            preempt_grace_s=preempt_grace_s, init_timeout_s=init_timeout_s,
                            telemetry_dir=telemetry_dir, health_dir=health_dir)
        procs.append(subprocess.Popen([sys.executable] + [str(a) for a in argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=_ROOT))
    outs: list = [None] * nprocs
    exit_t: dict[int, float] = {}  # monotonic time each rank's pipes closed
    report = LaunchReport()
    done = threading.Event()
    if on_spawn is not None:
        try:
            on_spawn(list(procs))
        except Exception as exc:  # noqa: BLE001 — a probe must not kill a launch
            report.note(f"on_spawn callback failed: {exc!r}")
    restore_forwarder = None
    if forward_preempt:
        from rocm_mpi_tpu_torch.resilience import preempt

        restore_forwarder = preempt.install_forwarder(procs)

    def drain(i: int, p) -> None:
        # Every path records something in outs[i], so a caller unpacking
        # (stdout, stderr) never meets None; the post-kill communicate has
        # its own timeout (a grandchild may hold the pipes open).
        try:
            outs[i] = p.communicate(timeout=timeout)
            exit_t[i] = time.monotonic()
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                outs[i] = p.communicate(timeout=30)
            except Exception as exc:  # noqa: BLE001
                outs[i] = ("", f"rank {i} drain failed post-kill: {exc!r}")
        except Exception as exc:  # noqa: BLE001
            p.kill()
            outs[i] = ("", f"rank {i} drain failed: {exc!r}")

    watch = None
    if health_dir:
        from rocm_mpi_tpu_torch.telemetry import health

        watch = health.ProgressWatch(stall_grace_s=stall_grace_s)

    def watchdog_tick(now: float) -> None:
        """One progress-watchdog poll: tail the sidecars and, on the first
        stalled-collective verdict, SIGUSR2, post-mortem and kill the
        flagged rank. Its kill is a nonzero exit, which the first-failure
        path then handles (the peer-grace kill of the wedged survivors)."""
        from rocm_mpi_tpu_torch.telemetry import health

        beats, _ = health.load_heartbeats(health_dir)
        watch.observe(beats, now)
        if report.watchdog_verdicts:
            return  # one verdict round a launch: the rest is cleanup
        for verdict in watch.verdicts(now):
            rank = verdict["rank"]
            if rank >= nprocs or procs[rank].poll() is not None:
                continue  # already dead: the exit path reports it
            report.note(
                f"watchdog: rank {rank} stalled at step {verdict['step']} (cross-rank median "
                f"{verdict['median_step']}, no progress for {verdict['stalled_for_s']}s, last "
                f"phase {verdict['last_phase']!r}) — SIGUSR2 then kill")
            try:
                procs[rank].send_signal(signal.SIGUSR2)
                # The rank's faulthandler writes its dump meanwhile.
                done.wait(postmortem_grace_s)
            except (OSError, ValueError):
                pass
            try:
                path = health.write_postmortem(health_dir, rank, verdict)
                report.note(f"watchdog: wrote {path}")
            except Exception as exc:  # noqa: BLE001 — never wedge the kill
                report.note(f"watchdog: post-mortem failed: {exc!r}")
            report.watchdog_verdicts.append(verdict)
            if procs[rank].poll() is None:
                procs[rank].kill()

    failure_t: list[float] = []  # when the supervision saw the first failure

    def exits() -> list[tuple[float, int, int]]:
        """(time, rank, rc) of the ranks that have exited, in exit order
        (each rank's pipes closing)."""
        return sorted((exit_t[i], i, procs[i].returncode) for i in list(exit_t))

    def classify(now: float, t0: float) -> None:
        """Record the first failure, once: the first nonzero exit; with
        vanish_grace_s, a clean exit that a peer's failure followed within
        the grace is the failure (over gloo an orphaned peer fails at once,
        the connection closing, instead of hanging: its failure is the
        vanish's symptom, not the cause)."""
        if report.first_failure is not None:
            return
        done_ = exits()
        failed = [(t, i, rc) for t, i, rc in done_ if rc != 0]
        if not failed:
            return
        clean = [(t, i) for t, i, rc in done_ if rc == 0]
        failure_t.append(now)
        if vanish_grace_s is not None and clean \
                and clean[0][0] < failed[0][0] <= clean[0][0] + vanish_grace_s:
            t, rank = clean[0]
            report.vanished = rank
            report.first_failure = (rank, 0, t - t0)
            report.note(f"vanish: rank {rank} exited rc=0 at {t - t0:.1f}s and rank "
                        f"{failed[0][1]} failed {failed[0][0] - t:.1f}s later "
                        f"(rc={failed[0][2]}) — treating the exit as a death; peers get "
                        f"{peer_grace_s}s grace")
            return
        t, i, rc = failed[0]
        report.first_failure = (i, rc, t - t0)
        report.note(f"first failure: rank {i} rc={rc} at {t - t0:.1f}s; peers get "
                    f"{peer_grace_s}s grace")

    t_start = time.monotonic()

    def supervise() -> None:
        """Rank liveness: on the first failure (`classify`), give the
        peers `peer_grace_s` to finish on their own, then kill them; with
        vanish_grace_s, reclassify a clean exit that leaves its peers
        running; with the health plane, run the watchdog every pass."""
        next_beat = t_start + heartbeat_s
        first_clean_exit = None  # (rank, t)
        while not done.is_set():
            now = time.monotonic()
            alive = [i for i, p in enumerate(procs) if p.poll() is None]
            if watch is not None and alive:
                try:
                    watchdog_tick(now)
                except Exception as exc:  # noqa: BLE001
                    report.note(f"watchdog: tick failed: {exc!r}")
            classify(now, t_start)
            if not alive:
                return
            if vanish_grace_s is not None and report.first_failure is None:
                if first_clean_exit is None:
                    done_ = exits()
                    if done_:
                        first_clean_exit = (done_[0][1], done_[0][0])
                elif now - first_clean_exit[1] >= vanish_grace_s and (
                        watch is None or all(age >= vanish_grace_s
                                             for rk, age in watch.ages(now).items()
                                             if rk in alive)):
                    # The survivors run on this long after a clean exit, and
                    # (with the health plane) have made no progress in as
                    # long: the exited rank abandoned a collective.
                    rank, t_exit = first_clean_exit
                    report.vanished = rank
                    report.first_failure = (rank, 0, t_exit - t_start)
                    report.note(f"vanish: rank {rank} exited rc=0 at {t_exit - t_start:.1f}s "
                                f"but ranks {alive} are still running {vanish_grace_s}s later "
                                "— treating the exit as a death and killing the orphaned "
                                "peers")
                    for i in alive:
                        if procs[i].poll() is None:
                            procs[i].kill()
                            report.killed_after_failure.append(i)
                    return
            elif failure_t and now - failure_t[0] >= peer_grace_s:
                for i in alive:
                    if procs[i].poll() is None:
                        procs[i].kill()
                        report.killed_after_failure.append(i)
                report.note(f"killed hung peer rank(s) {report.killed_after_failure} "
                            f"{peer_grace_s}s after rank {report.first_failure[0]} failed")
                return
            if heartbeat_s and now >= next_beat:
                if watch is None:
                    report.note(f"heartbeat at {now - t_start:.1f}s: ranks {alive} alive")
                else:
                    ages = watch.ages(now)
                    detail = ", ".join(f"rank{rk} {ages[rk]:.1f}s"
                                       for rk in sorted(ages)) or "no sidecars yet"
                    report.note(f"heartbeat at {now - t_start:.1f}s: ranks {alive} alive; "
                                f"last progress age: {detail}")
                next_beat = now + heartbeat_s
            done.wait(0.25)

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    monitor = threading.Thread(target=supervise, daemon=True)
    try:
        for t in threads:
            t.start()
        monitor.start()
        for t in threads:
            t.join()
    finally:
        done.set()
        if restore_forwarder is not None:
            restore_forwarder()
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        monitor.join(timeout=5)
        del store
    # Every rank has exited: the exits the last pass did not see yet.
    classify(time.monotonic(), t_start)
    if telemetry_dir:
        # After every rank is dead: the append-only streams are complete or
        # cleanly torn. Observability never fails a launch.
        try:
            summary = merge_telemetry(telemetry_dir)
            if summary is not None:
                report.note(f"telemetry: merged rank streams {summary['ranks']} "
                            f"({summary['records']} records) into {telemetry_dir}")
        except Exception as exc:  # noqa: BLE001
            report.note(f"telemetry merge failed: {exc!r}")
    if health_dir and report.watchdog_verdicts:
        # The post-mortem bundle; a clean launch leaves none.
        try:
            from rocm_mpi_tpu_torch.telemetry import health

            bundle = health.bundle_postmortem(health_dir, report.watchdog_verdicts)
            report.note(f"watchdog: bundled post-mortem for rank(s) "
                        f"{[v['rank'] for v in report.watchdog_verdicts]} into {bundle}")
        except Exception as exc:  # noqa: BLE001
            report.note(f"watchdog: bundling failed: {exc!r}")
    results = RankResults(zip(procs, outs))
    results.report = report
    return results
