"""The port's fleet (rocm_mpi_tpu_torch/serving/journal.py, router.py,
apps/fleet.py, telemetry/regress' fleet checks) against the JAX package's,
on the CPU.

Each test is the counterpart of one of tests/test_fleet.py's (and of
test_serving_hammer.py's two journal tests): the same trace goes through
both packages' routers — the JAX services on the conftest's 8 CPU
devices, the port's on one rank; routing does not depend on the devices —
and each check compares the two: the replica map, the journal's record
stream (the records carry no time stamp, so the streams are equal record
for record), the merged counters, the accounting verdict, the validators'
problems on the same good and doctored documents, and each package's
replay of the other's journal. The kill drill's lanes are bitwise the
port's standalone twin and, from JAX's initial state an ulp away (the
Gaussian's `exp`), within the serving tests' f64 tolerances of JAX's.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rocm_mpi_tpu.serving import journal as jjournal
from rocm_mpi_tpu.serving import queue as jqueue
from rocm_mpi_tpu.serving import router as jrouter
from rocm_mpi_tpu.serving import service as jservice
from rocm_mpi_tpu.telemetry import compiles as jcompiles
from rocm_mpi_tpu.telemetry import health as jhealth
from rocm_mpi_tpu.telemetry import regress as jregress
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.resilience import faults
from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy
from rocm_mpi_tpu_torch.serving import journal, queue
from rocm_mpi_tpu_torch.serving.queue import Request
from rocm_mpi_tpu_torch.serving.router import FleetRouter
from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
from rocm_mpi_tpu_torch.telemetry import compiles, health, regress

import test_torch_serving_worker as worker

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL64 = dict(rtol=1e-12, atol=1e-14)


def _req(rid, shape=(16, 16), nt=4, make=Request, **kw):
    return make(request_id=rid, workload="diffusion", global_shape=shape, nt=nt, **kw)


def _mixed_trace(tag, n=9, make=Request, dtype="f32"):
    """test_fleet.py's mix: three bins over two shapes."""
    return [_req(f"{tag}-{i:02d}", shape=(16, 16) if i % 3 else (24, 24), nt=3 + (i % 3),
                 make=make, dtype=dtype, ic_scale=1.0 + 0.015 * i)
            for i in range(n)]


def _routers(tmp_path, n=3, **kw):
    """(port router, port journal), (JAX router, JAX journal) of `n`
    replicas at max_width 2, each on its own journal file."""
    pj = journal.TicketJournal(tmp_path / "port" / "fleet-journal.jsonl")
    port = FleetRouter(lambda rid: SimulationService(config=ServeConfig(max_width=2,
                                                                        device="cpu")),
                       n, journal=pj, **kw)
    jj = jjournal.TicketJournal(tmp_path / "jax" / "fleet-journal.jsonl")
    jax = jrouter.FleetRouter(
        lambda rid: jservice.SimulationService(config=jservice.ServeConfig(max_width=2)), n,
        journal=jj, **kw)
    return (port, pj), (jax, jj)


def _records(j):
    return [json.loads(line) for line in j.path.read_text().splitlines()]


def _both(fn, port, jax):
    """fn(router, make) on both routers; (port result, JAX result)."""
    return fn(port, Request), fn(jax, jqueue.Request)


@pytest.fixture
def jfaults():
    from rocm_mpi_tpu.resilience import faults as jf

    yield jf
    jf.install(None)
    faults.install(None)


# ---------------------------------------------------------------------------
# The ticket journal
# ---------------------------------------------------------------------------

GOOD = {"schema": journal.JOURNAL_SCHEMA, "v": journal.JOURNAL_VERSION, "kind": "route",
        "seq": 3, "request_id": "r1", "replica": 0}
DOCTORED = [
    {}, dict(GOOD, kind="nope"), dict(GOOD, replica=None), dict(GOOD, seq=-1),
    dict(GOOD, seq=True), dict(GOOD, request_id=""), dict(GOOD, schema="x"),
    {"schema": journal.JOURNAL_SCHEMA, "v": 1, "kind": "terminal", "seq": 4,
     "request_id": "r1", "state": "vaporized"},
]


@pytest.mark.parametrize("doc", [GOOD] + DOCTORED)
def test_journal_record_validation(doc):
    got = journal.validate_journal_record(doc)
    assert got == jjournal.validate_journal_record(doc)
    assert (got == []) == (doc is GOOD)


def _append_script(j):
    j.record_submit("a", bin_key="bin-a")
    j.record_route("a", 0)
    j.record_terminal("a", "done", replica=0)
    j.record_submit("b", session="sess-b", bin_key="bin-b")
    j.record_route("b", 1)


def test_journal_append_replay_and_seq_resume(tmp_path):
    for mod, name in ((journal, "port.jsonl"), (jjournal, "jax.jsonl")):
        j = mod.TicketJournal(tmp_path / name)
        _append_script(j)
        j.close()
        # A reopened journal resumes the seq counter past what is on disk.
        j2 = mod.TicketJournal(tmp_path / name)
        j2.record_terminal("b", "done", replica=1)
        j2.close()
    port, jax = (tmp_path / "port.jsonl").read_text(), (tmp_path / "jax.jsonl").read_text()
    assert port == jax
    seqs = [json.loads(line)["seq"] for line in port.splitlines()]
    assert seqs == list(range(6))
    for replay in (journal.replay, jjournal.replay):
        state = replay([tmp_path / "port.jsonl"])
        assert state.counts() == jjournal.replay([tmp_path / "jax.jsonl"]).counts()
        assert state.counts()["open"] == 0 and state.tickets["b"]["session"] == "sess-b"


def test_journal_replay_is_idempotent_and_tolerates_torn_tail(tmp_path):
    path = tmp_path / "fleet-journal.jsonl"
    j = journal.TicketJournal(path)
    for i in range(4):
        j.record_submit(f"r{i}")
        j.record_route(f"r{i}", i % 2)
        j.record_terminal(f"r{i}", "done", replica=i % 2)
    j.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"torn')
    first, again, jax = journal.replay([path]), journal.replay([path]), jjournal.replay([path])
    assert first.counts() == again.counts() == jax.counts()
    assert first.counts()["torn_lines"] == 1 and first.counts()["terminal"]["done"] == 4
    assert journal.exactly_one_terminal(first) == jjournal.exactly_one_terminal(jax) == []


def test_journal_segments_seal_atomically(tmp_path):
    out = {}
    for mod, sub in ((journal, "port"), (jjournal, "jax")):
        path = tmp_path / sub / "fleet-journal.jsonl"
        j = mod.TicketJournal(path)
        j.record_submit("a")
        sealed = j.seal_segment()
        assert sealed is not None and sealed.exists()
        assert not list(path.parent.glob("*.tmp"))
        j.record_submit("b")
        j.record_route("a", 0)
        segs = j.segments()
        assert segs[-1] == path and sealed in segs
        state = mod.replay(segs)
        j.seal_segment()
        assert j.seal_segment() is None
        j.close()
        out[sub] = ([s.name for s in j.segments()], state.counts(), state.open_on(0),
                    [p.read_text() for p in j.segments()])
    assert out["port"] == out["jax"]
    assert out["port"][1]["tickets"] == 2 and out["port"][2] == ["a"]


def test_exactly_one_terminal_names_the_violations():
    verdicts = []
    for mod in (journal, jjournal):
        state = mod.JournalState()

        def rec(kind, seq, rid, **kw):
            state.apply({"schema": mod.JOURNAL_SCHEMA, "v": mod.JOURNAL_VERSION,
                         "kind": kind, "seq": seq, "request_id": rid, **kw})

        rec("submit", 0, "lost")
        rec("route", 1, "lost", replica=0)
        rec("submit", 2, "double")
        rec("route", 3, "double", replica=1)
        rec("terminal", 4, "double", state="done", replica=1)
        rec("terminal", 5, "double", state="expired", replica=1)
        rec("terminal", 6, "ghost", state="done", replica=0)
        rec("route", 7, "bad", replica=None)
        verdicts.append(mod.exactly_one_terminal(state))
    assert verdicts[0] == verdicts[1]
    problems = verdicts[0]
    assert any("lost" in p and "no terminal" in p for p in problems)
    assert any("double" in p and "2 terminal" in p for p in problems)
    assert any("ghost" in p for p in problems)
    assert any("malformed" in p for p in problems)


def test_journal_concurrent_append_and_replay(tmp_path):
    """test_serving_hammer's writer/reader race on the port's journal: a
    replay mid-append never raises, the observed ticket count is monotone,
    and the drained journal balances — by both packages' replay."""
    path = tmp_path / "ticket-journal.jsonl"
    j = journal.TicketJournal(path)
    n = 200
    stop = threading.Event()
    barrier = threading.Barrier(2)
    errors: list = []
    observed: list = []

    def writer():
        try:
            barrier.wait()
            for i in range(n):
                rid = f"t{i:04d}"
                j.record_submit(rid, bin_key="hammer")
                j.record_route(rid, replica=i % 3)
                j.record_terminal(rid, "done" if i % 7 else "failed", replica=i % 3)
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)
        finally:
            stop.set()

    def reader():
        try:
            barrier.wait()
            while not stop.is_set():
                observed.append(len(journal.replay([path]).tickets))
                time.sleep(0.001)
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive(), "journal hammer stalled"
    assert errors == []
    j.close()
    assert observed == sorted(observed)
    for replay, one in ((journal.replay, journal.exactly_one_terminal),
                        (jjournal.replay, jjournal.exactly_one_terminal)):
        state = replay([path])
        assert len(state.tickets) == n and state.torn_lines == 0 and one(state) == []
        assert state.terminal_counts()["failed"] == sum(1 for i in range(n) if i % 7 == 0)


def test_journal_torn_tail_replay(tmp_path):
    path = tmp_path / "ticket-journal.jsonl"
    j = journal.TicketJournal(path)
    for i in range(5):
        j.record_submit(f"t{i}")
        j.record_terminal(f"t{i}", "done")
    j.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"kind": "terminal", "seq": 9')
    state = journal.replay([path])
    assert state.torn_lines == 1 and len(state.tickets) == 5
    assert journal.exactly_one_terminal(state) == []
    assert jjournal.replay([path]).counts() == state.counts()
    resumed = journal.TicketJournal(path)
    assert resumed._seq == state.seq_max + 1 == jjournal.TicketJournal(path)._seq
    resumed.close()


# ---------------------------------------------------------------------------
# The merged fleet report, its schema and the FLEET badge
# ---------------------------------------------------------------------------


def _report_doc(mod=journal, **over):
    slo = {"submitted": 2, "done": 2, "failed": 0, "rejected": 0, "expired": 0,
           "quarantined": 0, "retries": 0}
    counts = {"tickets": 2, "open": 0, "rerouted": 1, "torn_lines": 0,
              "terminal": {"done": 2, "failed": 0, "rejected": 0, "expired": 0,
                           "quarantined": 0}}
    doc = mod.fleet_report_doc(
        [{"id": 0, "alive": True, "steady_state": 0}, {"id": 1, "alive": False,
                                                        "steady_state": 0}],
        slo, counts, accounting_ok=True, autoscale=[{"event": "fleet.grow", "replica": 2}])
    doc.update(over)
    return doc


def test_fleet_report_roundtrip_and_gate(tmp_path):
    doc, jdoc = _report_doc(), _report_doc(jjournal)
    assert {k: v for k, v in doc.items() if k != "t"} == \
        {k: v for k, v in jdoc.items() if k != "t"}
    assert journal.validate_fleet_report(doc) == jjournal.validate_fleet_report(doc) == []
    path = tmp_path / "fleet-report.json"
    journal.write_fleet_report(path, doc)
    assert path.is_file() and not list(tmp_path.glob("*.tmp"))
    assert regress.check_schema([path]) == jregress.check_schema([path]) == []
    bad = _report_doc(replicas=[])
    assert journal.validate_fleet_report(bad) == jjournal.validate_fleet_report(bad) != []
    with pytest.raises(ValueError):
        journal.write_fleet_report(tmp_path / "never.json", bad)
    bad2 = _report_doc()
    del bad2["journal"]["terminal"]["expired"]
    bad2["replicas"][1]["steady_state"] = True
    bad2["slo"]["done"] = -1
    bad2_path = tmp_path / "bad-fleet-report.json"
    bad2_path.write_text(json.dumps(bad2))
    got = regress.check_schema([bad2_path])
    assert got == jregress.check_schema([bad2_path]) and len(got) == 3
    assert any("terminal" in p for p in got)


def test_fleet_schema_spellings_pinned_against_regress():
    assert (journal.JOURNAL_SCHEMA, journal.JOURNAL_VERSION, journal.JOURNAL_KINDS,
            journal.FLEET_REPORT_SCHEMA, journal.FLEET_REPORT_VERSION) == (
        jjournal.JOURNAL_SCHEMA, jjournal.JOURNAL_VERSION, jjournal.JOURNAL_KINDS,
        jjournal.FLEET_REPORT_SCHEMA, jjournal.FLEET_REPORT_VERSION)
    assert regress._FLEET_JOURNAL_SCHEMA == journal.JOURNAL_SCHEMA
    assert regress._FLEET_REPORT_SCHEMA == journal.FLEET_REPORT_SCHEMA
    assert journal.TERMINAL_STATES == queue.TERMINAL_STATES == jqueue.TERMINAL_STATES
    assert "fleet report" not in regress.DEEP_CHECKED_ELSEWHERE


def test_fleet_journal_lines_pass_regress_check_schema(tmp_path):
    path = tmp_path / "fleet-journal.jsonl"
    j = journal.TicketJournal(path)
    j.record_submit("a", session="s", bin_key="b")
    j.record_route("a", 0)
    j.record_terminal("a", "done", replica=0)
    j.close()
    notes: list = []
    assert regress.check_schema([path], notes=notes) == jregress.check_schema([path]) == []
    assert notes == []  # deep-checked, not merely recognized
    doc = json.loads(path.read_text().splitlines()[-1])
    doc["state"] = "vaporized"
    bad = tmp_path / "bad-fleet-journal.jsonl"
    bad.write_text(json.dumps(doc) + "\n")
    got = regress.check_schema([bad])
    assert got == jregress.check_schema([bad]) and any("state" in p for p in got)


def test_fleet_badge():
    assert health.fleet_status(None) is None
    assert health.fleet_status({"schema": "rmt-soak-report"}) is None
    doc = _report_doc()
    st = health.fleet_status(doc)
    assert st == jhealth.fleet_status(doc)
    assert st["live"] == 1 and st["total"] == 2 and st["done"] == 2 and st["rerouted"] == 1
    line = health.format_fleet_status(st)
    assert line == jhealth.format_fleet_status(st) == \
        "fleet idle (1/2 up — 2 done, 1 rerouted)"
    busy = dict(st, depth=3, accounting_ok=False)
    assert health.format_fleet_status(busy) == jhealth.format_fleet_status(busy)
    assert "ACCOUNTING BROKEN" in health.format_fleet_status(busy)


# ---------------------------------------------------------------------------
# Router policy (routing is pre-drain state)
# ---------------------------------------------------------------------------


def test_affinity_determinism_same_trace_same_map(tmp_path):
    (port, pj), (jax, jj) = _routers(tmp_path)
    for r, jr in zip(_mixed_trace("det"), _mixed_trace("det", make=jqueue.Request)):
        port.submit(r)
        jax.submit(jr)
    assert port.replica_map() == jax.replica_map()
    assert len(set(port.replica_map().values())) == 3
    assert _records(pj) == _records(jj)
    assert {k: v["routes"] for k, v in port.journal_state().tickets.items()} == \
        {k: v["routes"] for k, v in jax.journal_state().tickets.items()}


def test_spillover_ordering_under_saturated_replica(tmp_path):
    (port, pj), (jax, jj) = _routers(tmp_path, max_depth_per_replica=2)

    def drill(router, make):
        tickets = [router.submit(_req(f"sat-{i}", nt=3, make=make, ic_scale=1.0 + 0.1 * i))
                   for i in range(4)]
        (bkey, rid0), = router.replica_map().items()
        return (router.replica_map(), [router._tickets[f"sat-{i}"].replica for i in range(4)],
                [t.state for t in tickets], rid0)

    got, want = _both(drill, port, jax)
    assert got == want
    rmap, rids, states, rid0 = got
    assert rids[:2] == [rid0, rid0] and rids[2:] == sorted(r for r in range(3) if r != rid0)
    assert states == ["queued"] * 4
    assert _records(pj) == _records(jj)


def test_fleet_full_fast_reject_carries_merged_hint(tmp_path):
    (port, pj), (jax, jj) = _routers(tmp_path, n=2, max_depth_per_replica=1)

    def drill(router, make):
        for i in range(2):
            router.submit(_req(f"full-{i}", nt=3, make=make, ic_scale=1.0 + 0.1 * i))
        t = router.submit(_req("full-2", nt=3, make=make, ic_scale=1.2))
        return (t.state, t.error, router.router_rejected, router.retry_after_hint(),
                router.journal_state().tickets["full-2"]["terminals"])

    got, want = _both(drill, port, jax)
    assert got == want
    assert got[0] == "rejected" and "fleet-full" in got[1] and "retry-after" in got[1]
    assert got[3] == queue.DEFAULT_RETRY_AFTER_S and got[4] == [("rejected", None)]
    assert _records(pj) == _records(jj)


def test_session_affinity_sticks_and_survives_kill(tmp_path):
    (port, pj), (jax, jj) = _routers(tmp_path)

    def drill(router, make):
        t = router.submit(_req("sess-0", nt=3, make=make, session="tenant-a"))
        pinned = router._tickets["sess-0"].replica
        router.submit(_req("other-0", nt=4, make=make, ic_scale=1.2))
        t2 = router.submit(_req("sess-1", nt=3, make=make, ic_scale=1.1, session="tenant-a"))
        stuck = router._tickets["sess-1"].replica == pinned
        router.kill_replica(pinned, verdict="test-kill")
        home = router._tickets["sess-0"].replica
        t3 = router.submit(_req("sess-2", nt=3, make=make, ic_scale=1.3, session="tenant-a"))
        return (pinned, stuck, home, router._tickets["sess-1"].replica,
                router._tickets["sess-2"].replica, router._sessions["tenant-a"],
                [x.state for x in (t, t2, t3)])

    got, want = _both(drill, port, jax)
    assert got == want
    pinned, stuck, home, s1, s2, pin, states = got
    assert stuck and home != pinned and s1 == s2 == pin == home
    assert states == ["queued"] * 3
    assert _records(pj) == _records(jj)
    assert port.replica(pinned).svc._programs == {}  # let go (nothing was built)


def test_router_reconcile_is_idempotent(tmp_path):
    (port, pj), (jax, jj) = _routers(tmp_path)

    def drill(router, make):
        for r in _mixed_trace("rec", n=6, make=make):
            router.submit(r)
        before = {k: v.replica for k, v in router._tickets.items()}
        router.kill_replica(1, verdict="test")
        moved = {k: v.replica for k, v in router._tickets.items()}
        rerouted = router.journal_state().counts()["rerouted"]
        router._reconcile(1)
        return (before, moved, rerouted, {k: v.replica for k, v in router._tickets.items()},
                router.journal_state().counts()["rerouted"])

    got, want = _both(drill, port, jax)
    assert got == want
    before, moved, rerouted, again, rerouted2 = got
    assert any(v == 1 for v in before.values()) and all(v != 1 for v in moved.values())
    assert rerouted >= 1 and again == moved and rerouted2 == rerouted
    assert _records(pj) == _records(jj)


# ---------------------------------------------------------------------------
# The autoscaler
# ---------------------------------------------------------------------------


def test_autoscaler_grows_and_retires_whole_replicas(tmp_path):
    from rocm_mpi_tpu.resilience.policy import ElasticPolicy as JElasticPolicy

    kw = dict(max_replicas=2, grow_queue_depth=2, idle_retire_ticks=2)
    pj = journal.TicketJournal(tmp_path / "port.jsonl")
    port = FleetRouter(lambda rid: SimulationService(config=ServeConfig(max_width=2,
                                                                        device="cpu")),
                       1, journal=pj, policy=ElasticPolicy(min_grow_interval_steps=0), **kw)
    jj = jjournal.TicketJournal(tmp_path / "jax.jsonl")
    jax = jrouter.FleetRouter(
        lambda rid: jservice.SimulationService(config=jservice.ServeConfig(max_width=2)), 1,
        journal=jj, policy=JElasticPolicy(min_grow_interval_steps=0), **kw)

    def drill(router, make):
        for i in range(4):
            router.submit(_req(f"scale-{i}", nt=2, make=make, ic_scale=1.0 + 0.1 * i))
        router._tick += 1
        grew = router.maybe_scale()
        router._tick += 1
        again = router.maybe_scale()
        router.drive()
        for _ in range(4):
            router.drive_once()
            if len(router.healthy_replicas()) == 1:
                break
        return (grew, again, router.autoscale_events, router.check_accounting(),
                [(r.id, r.alive, r.verdict) for r in router.replicas])

    got, want = _both(drill, port, jax)
    assert got == want
    grew, again, events, problems, reps = got
    assert grew and not again and events[0]["event"] == "fleet.grow"
    retire = [e for e in events if e["event"] == "fleet.retire"]
    assert retire and retire[0]["replica"] == 1 and retire[0]["signal"] == "rc-75"
    assert problems == [] and reps[1] == (1, False, "retired")
    assert _records(pj) == _records(jj)
    assert port.replica(1).svc._programs == {}
    assert [r["programs"] for r in port.report_doc()["replicas"]] == \
        [r["programs"] for r in jax.report_doc()["replicas"]]


# ---------------------------------------------------------------------------
# The kill drill and the stall
# ---------------------------------------------------------------------------


def _standalone_lanes(trace):
    twin = SimulationService(config=ServeConfig(max_width=2, device="cpu"))
    tickets = [twin.queue.submit(r) for r in trace]
    while twin.queue.depth():
        twin.drain_once()
    return [t.result(timeout=5) for t in tickets]


def test_fleet_kill_drill_three_replicas(tmp_path, jfaults):
    """Replica 1 of 3 killed mid-traffic by the fault grammar, through both
    packages' routers: the same map, journal, counters and verdict; every
    ticket done exactly once; every lane bitwise the port's standalone twin
    and near JAX's; steady_state 0 in every row, as JAX's rows say; the
    dead replica let its programs go."""
    compiles.install()
    compiles.reset()
    jcompiles.install()
    jcompiles.reset()
    (port, pj), (jax, jj) = _routers(tmp_path)
    faults.install("replica-kill@step=2,rank=1")
    jfaults.install("replica-kill@step=2,rank=1")

    def drill(router, make):
        reqs = _mixed_trace("drill", make=make, dtype="f64")
        tickets = []
        for i in range(0, len(reqs), 3):
            tickets += [router.submit(r) for r in reqs[i:i + 3]]
            router.drive_once()
        router.drive()
        return tickets

    tickets, jtickets = _both(drill, port, jax)
    assert [(r.id, r.alive, r.verdict) for r in port.replicas] == \
        [(r.id, r.alive, r.verdict) for r in jax.replicas] == \
        [(0, True, None), (1, False, "injected-kill"), (2, True, None)]
    assert port.replica_map() == jax.replica_map()
    assert _records(pj) == _records(jj)
    assert port.check_accounting() == jax.check_accounting() == []
    assert port.merged_counters() == jax.merged_counters()
    counts = port.journal_state().counts()
    assert counts == jax.journal_state().counts()
    assert counts["open"] == 0 and counts["rerouted"] >= 1
    # JAX's replay of the port's journal gives the port's counts, and back.
    assert jjournal.replay(pj.segments()).counts() == counts == \
        journal.replay(jj.segments()).counts()
    twin = _standalone_lanes(_mixed_trace("drill", dtype="f64"))
    for t, jt, ref in zip(tickets, jtickets, twin):
        assert t.state == jt.state == "done", (t.request.request_id, t.error)
        for g, w, j in zip(t.result(timeout=5), ref, jt.result(timeout=5)):
            assert np.array_equal(g, w), t.request.request_id
            np.testing.assert_allclose(g, np.asarray(j), **TOL64)
    doc, jdoc = port.report_doc(), jax.report_doc()
    assert journal.validate_fleet_report(doc) == jjournal.validate_fleet_report(doc) == []
    assert doc["accounting_ok"] is jdoc["accounting_ok"] is True
    assert [r["steady_state"] for r in doc["replicas"]] == \
        [r["steady_state"] for r in jdoc["replicas"]] == [0, 0, 0]
    for key in ("journal", "autoscale"):
        assert doc[key] == jdoc[key]
    assert {k: v for k, v in doc["slo"].items() if k != "latency_s"} == \
        {k: v for k, v in jdoc["slo"].items() if k != "latency_s"}
    keep = ("id", "alive", "demoted", "verdict", "counters", "retries", "programs", "bins")
    assert [{k: r[k] for k in keep} for r in doc["replicas"]] == \
        [{k: r[k] for k in keep} for r in jdoc["replicas"]]
    assert port.replica(1).svc._programs == {} and port.replica(1).svc._models == {}


def test_fleet_stall_demotion_reroutes(tmp_path, jfaults):
    (port, pj), (jax, jj) = _routers(tmp_path, n=2)
    faults.install("replica-stall@step=1,rank=0")
    jfaults.install("replica-stall@step=1,rank=0")

    def drill(router, make):
        tickets = [router.submit(r) for r in _mixed_trace("stall", n=6, make=make)]
        router.drive()
        rep = router.replica(0)
        return ((rep.alive, rep.demoted, rep.verdict), router.check_accounting(),
                [t.state for t in tickets], {k: v.replica for k, v in router._tickets.items()})

    got, want = _both(drill, port, jax)
    assert got == want
    assert got[0] == (True, True, "injected-stall") and got[1] == []
    assert got[2] == ["done"] * 6 and set(got[3].values()) == {1}
    assert _records(pj) == _records(jj)


def test_router_expiry_uses_the_routers_clock_as_jax(tmp_path):
    """Deadlines are the router's: the replica queues run wall_slo off and
    the router expires overdue tickets before each drain, in both packages
    alike (same journal, same terminal states)."""
    (port, pj), (jax, jj) = _routers(tmp_path, n=2)

    def drill(router, make):
        tickets = [router.submit(_req(f"ttl-{i}", nt=3, make=make, ic_scale=1.0 + 0.1 * i,
                                      deadline_s=1e-9 if i % 2 else None))
                   for i in range(4)]
        router.drive()
        return [t.state for t in tickets], [r.svc.queue.wall_slo for r in router.replicas]

    got, want = _both(drill, port, jax)
    assert got == want == (["done", "expired"] * 2, [False, False])
    assert _records(pj) == _records(jj)
    assert port.merged_counters() == jax.merged_counters()


# ---------------------------------------------------------------------------
# Several ranks, and the fleet app
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [{}, {"fault": "replica-kill@step=1,rank=1",
                                       "deadline": True}], ids=["clean", "kill+deadline"])
def test_fleet_gloo_two_rank_smoke(spec, tmp_path, jfaults):
    """Two gloo ranks each run the same two-replica router over the same
    trace (each replica's service spans both ranks): both ranks end with
    the same replica map, journal and states, those the JAX router reaches
    on the same trace and fault plan in one process, and rank 0's clock
    decides the deadline for both (spawn_ranks' own timeout bounds the
    ranks: 240 s)."""
    import dataclasses

    got = spawn_ranks(2, worker.run_fleet_rank, (spec,), timeout=240)
    assert got[0] == got[1]
    res = got[0]
    assert res["accounting"] == []
    want = {r: "done" for r in res["states"]}
    if spec:
        want["fleet-000"] = "expired"
        assert res["dead"] == [1]
    assert res["states"] == want
    jj = jjournal.TicketJournal(tmp_path / "jax.jsonl")
    jax = jrouter.FleetRouter(
        lambda rid: jservice.SimulationService(config=jservice.ServeConfig(max_width=4)), 2,
        journal=jj)
    trace = worker.serve_trace("fleet")
    if spec:
        trace[0] = dataclasses.replace(trace[0], deadline_s=1e-9)
        jfaults.install(spec["fault"])
    for r in trace:
        jax.submit(jqueue.Request(**{k: getattr(r, k) for k in (
            "request_id", "workload", "global_shape", "dtype", "nt", "ic_scale",
            "deadline_s")}))
    jax.drive()
    assert res["map"] == jax.replica_map()
    assert res["records"] == _records(jj)
    assert res["merged"] == jax.merged_counters()


def _fleet_app(args, cwd=REPO, timeout=300):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "rocm_mpi_tpu_torch.apps.fleet",
                           "--device", "cpu", *args], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=timeout)


def test_fleet_app_kill_drill_banks_valid_sidecars(tmp_path):
    """The fleet app as a child, replica 1 killed at tick 2 of the paced
    trace: exit 0, both sidecars valid under both packages' check_schema,
    and the journal stream the JAX router writes on the app's trace paced
    the same way."""
    out = tmp_path / "out"
    proc = _fleet_app(["--synthetic", "12", "--nt-max", "16", "--inject-fault",
                       "replica-kill@step=2,rank=1", "--out", str(out)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 rerouted" in proc.stdout and "fleet idle (2/3 up" in proc.stdout
    sidecars = [out / "fleet-journal.jsonl", out / "fleet-report.json"]
    assert regress.check_schema(sidecars) == jregress.check_schema(sidecars) == []
    doc = json.loads(sidecars[1].read_text())
    assert doc["accounting_ok"] and [r["alive"] for r in doc["replicas"]] == [True, False, True]
    assert all(r["steady_state"] == 0 for r in doc["replicas"])

    from apps.serve import synthetic_trace as jax_synthetic
    from rocm_mpi_tpu.resilience import faults as jf

    jj = jjournal.TicketJournal(tmp_path / "jax.jsonl")
    jax = jrouter.FleetRouter(
        lambda rid: jservice.SimulationService(config=jservice.ServeConfig(max_width=8)), 3,
        journal=jj)
    jf.install("replica-kill@step=2,rank=1")
    try:
        reqs = jax_synthetic(12, 1, nt_max=16)
        for i in range(0, 12, 3):
            for r in reqs[i:i + 3]:
                jax.submit(r)
            if i + 3 < 12:
                jax.drive_once()
        jax.drive()
    finally:
        jf.install(None)
    assert [json.loads(line) for line in sidecars[0].read_text().splitlines()] == _records(jj)
    assert doc["journal"] == jax.report_doc()["journal"]


def test_fleet_app_usage_and_failure_exit_codes(tmp_path):
    from rocm_mpi_tpu_torch.apps import fleet

    with pytest.raises(SystemExit) as e:
        fleet.main(["--device", "cpu", "--cpu-devices", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        fleet.main(["--device", "cpu", "--replicas", "0"])
    assert e.value.code == 2
    # a lane poisoned on every attempt (each replica's first request)
    # exhausts its retries and is quarantined: exit 1, the books balanced
    out = tmp_path / "q"
    proc = _fleet_app(["--synthetic", "4", "--nt-max", "8", "--inject-fault",
                       "lane-nan@request=1,times=9", "--out", str(out)])
    assert proc.returncode == 1, proc.stdout[-2000:]
    doc = json.loads((out / "fleet-report.json").read_text())
    assert doc["slo"]["quarantined"] == 3 and doc["slo"]["done"] == 1
    assert doc["slo"]["retries"] == 6 and doc["accounting_ok"] is True
