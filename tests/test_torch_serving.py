"""The port's serving core (rocm_mpi_tpu_torch/serving/, apps/serve.py,
telemetry/tracing's write side, telemetry/regress' serving checks) against
the JAX package's serving plane, on the CPU.

The JAX service runs on its conftest's 8 CPU devices and the port's on one
rank; the program keys name the batch rows, not the devices, so both must
plan the same bins and programs and reach the same terminal outcomes on
the same trace. Lanes are held bitwise against the port's standalone runs
and, from JAX's initial state where the packages differ by an ulp (the
Gaussian's `exp`), within the model tests' tolerances: f64 rtol 1e-12 /
atol 1e-14.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rocm_mpi_tpu.serving import bins as jbins
from rocm_mpi_tpu.serving import queue as jqueue
from rocm_mpi_tpu.serving import service as jservice
from rocm_mpi_tpu.telemetry import compiles as jcompiles
from rocm_mpi_tpu.telemetry import regress as jregress
from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.models.swe import ShallowWater
from rocm_mpi_tpu_torch.models.wave import AcousticWave
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.resilience.policy import CircuitPolicy, ElasticPolicy, RequestRetryPolicy
from rocm_mpi_tpu_torch.serving import bins, queue, service, slo
from rocm_mpi_tpu_torch.serving.queue import Request, RequestQueue
from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
from rocm_mpi_tpu_torch.telemetry import compiles, regress, tracing

import test_torch_serving_worker as worker

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL64 = dict(rtol=1e-12, atol=1e-14)


def _rec(r):
    """A request's record without its stamp time."""
    rec = (queue if isinstance(r, Request) else jqueue).request_to_record(r)
    rec.pop("t", None)
    return rec


def _svc(**kw):
    kw.setdefault("device", "cpu")
    return SimulationService(config=ServeConfig(**kw))


def _mixed(tag, make=Request, scale0=1.0):
    mix = [("diffusion", (16, 16), 5), ("diffusion", (16, 16), 7),
           ("diffusion", (24, 24), 6), ("wave", (16, 16), 5),
           ("swe", (16, 16), 4), ("diffusion", (16, 16), 3)]
    return [make(request_id=f"{tag}-{i}", workload=wl, global_shape=sh, dtype="f64", nt=nt,
                 ic_scale=scale0 + 0.05 * i)
            for i, (wl, sh, nt) in enumerate(mix)]


def _standalone(req):
    """The port's standalone run of a request: its state leaves."""
    kw = dict(global_shape=tuple(req.global_shape), dtype=req.dtype)
    if req.workload == "diffusion":
        m = HeatDiffusion(DiffusionConfig(**kw, **dict(req.physics)), device="cpu")
        T0, Cp = m.init_state()
        return (m.lane_advance_fn(req.variant)(T0 * req.ic_scale, Cp, req.nt),)
    if req.workload == "wave":
        w = AcousticWave(WaveConfig(**kw, **dict(req.physics)), device="cpu")
        U0, _, C2 = w.init_state()
        return w.advance_fn(req.variant)(U0 * req.ic_scale, U0 * req.ic_scale, C2, req.nt)
    s = ShallowWater(SWEConfig(**kw, **dict(req.physics)), device="cpu")
    h0, us0 = s.init_state()
    h, us = s.advance_fn(req.variant)(h0 * req.ic_scale, tuple(torch.zeros_like(h0)
                                                               for _ in us0),
                                      s.face_masks(), req.nt)
    return (h, *us)


def _assert_standalone(ticket):
    got = ticket.result(timeout=5)
    want = _standalone(ticket.request)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # bf16 results come back as float32 (numpy has no bfloat16), exactly
        assert np.array_equal(g, w.float().numpy() if w.dtype == torch.bfloat16
                              else w.numpy()), ticket.request.request_id


@pytest.fixture(scope="module")
def jax_served():
    """The JAX service on the mixed trace, then a repeat trace, then its
    manifest: (tickets, report, manifest doc)."""
    jcompiles.install()
    svc = jservice.SimulationService(config=jservice.ServeConfig(max_width=4))
    trace = _mixed("e2e", make=jqueue.Request)
    tickets = [svc.queue.submit(r) for r in trace]
    report = svc._drain_all()
    return tickets, report


@pytest.fixture(scope="module")
def port_served():
    compiles.install()
    svc = _svc(max_width=4)
    trace = _mixed("e2e")
    tickets = [svc.queue.submit(r) for r in trace]
    report = svc._drain_all()
    stats = {k.key_str(): (st.widths, st.batches, st.requests, st.occupancy)
             for k, st in report.bins.items()}
    before = compiles.snapshot()["totals"]["backend_compiles"]
    report2 = svc.run_trace(_mixed("e2e2"))
    rebuilt = compiles.snapshot()["totals"]["backend_compiles"] - before
    return svc, tickets, report, report2, rebuilt, stats


# ---------------------------------------------------------------------------
# Budgets, bin keys, buckets, packing: equal to the JAX package's
# ---------------------------------------------------------------------------


def test_serving_budgets_row_is_the_jax_row():
    doc = json.loads((REPO / "rocm_mpi_tpu" / "perf" / "budgets.json").read_text())
    assert service.SERVING_BUDGETS == doc["serving"]
    assert regress._validate_perf_budgets({"budgets": {}, "serving": service.SERVING_BUDGETS}) \
        == []


REQS = [
    dict(request_id="r1", workload="swe", global_shape=(24, 48), dtype="f32", nt=37,
         physics=(("g", 9.81), ("H0", 2.0)), wire_mode="bf16"),
    dict(request_id="r2", workload="diffusion", global_shape=(16, 16), dtype="f64", nt=8,
         physics=(("lam", 2.0), ("cp0", 3.0)), variant="hide"),
    dict(request_id="r3", workload="wave", global_shape=(30, 30), dtype="bf16", nt=65),
]


@pytest.mark.parametrize("kw", REQS, ids=lambda k: k["request_id"])
def test_bin_key_and_key_str_equal_jax(kw):
    key, jkey = bins.bin_key(Request(**kw)), jbins.bin_key(jqueue.Request(**kw))
    assert key.key_str() == jkey.key_str()
    assert bins.BinKey.parse(key.key_str()) == key
    assert key.key_str() == bins.BinKey.parse(jkey.key_str()).key_str()
    for tol in (0.25, 0.0):
        assert bins.bin_key(Request(**kw), ladder_tolerance=tol).key_str() == \
            jbins.bin_key(jqueue.Request(**kw), ladder_tolerance=tol).key_str()


def test_physics_order_cannot_split_a_bin():
    a = Request(request_id="a", physics=(("lam", 2.0), ("cp0", 3.0)))
    b = Request(request_id="b", physics=(("cp0", 3.0), ("lam", 2.0)))
    assert bins.bin_key(a) == bins.bin_key(b)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 64, 65, 100, 512, 513])
def test_steps_bucket_equal_jax(n):
    assert bins.steps_bucket(n) == jbins.steps_bucket(n)


def test_steps_bucket_refuses_zero_as_jax():
    for mod in (bins, jbins):
        with pytest.raises(ValueError):
            mod.steps_bucket(0)


@pytest.mark.parametrize("n,max_w,floor", [
    (1, 8, 0.5), (2, 8, 0.5), (3, 8, 0.5), (5, 8, 0.5), (9, 8, 0.5), (5, 8, 0.8),
    (13, 4, 0.5), (48, 8, 0.5), (4, 8, 0.5), (7, 2, 0.9)])
def test_plan_batches_equal_jax(n, max_w, floor):
    assert bins.plan_batches(n, max_w, floor) == jbins.plan_batches(n, max_w, floor)


@pytest.mark.parametrize("shape", [(1000, 1000), (30, 30), (16, 16), (250, 1020), (4096, 4096)])
def test_ladder_rung_and_shape_equal_jax(shape):
    assert bins.ladder_shape(shape, 0.25) == jbins.ladder_shape(shape, 0.25)
    assert [bins.ladder_rung(n) for n in shape] == [jbins.ladder_rung(n) for n in shape]


def test_bin_stats_equal_jax():
    rows = []
    for mod, make in ((bins, Request), (jbins, jqueue.Request)):
        st = mod.BinStats(key=mod.bin_key(make(request_id="x")))
        st.note_batch(4, [6, 3, 6], 6)
        st.note_batch(1, [6], 6, split=True)
        st.note_continuous(4, [5, 2, 7], 8, 2, 3)
        rows.append((st.occupancy, st.padding_waste, st.splits, st.batches, st.requests))
    assert rows[0] == rows[1]


# ---------------------------------------------------------------------------
# Request records and the queue
# ---------------------------------------------------------------------------


def test_request_records_cross_read(tmp_path):
    req = Request(request_id="rt-1", workload="wave", global_shape=(16, 16), dtype="f64",
                  nt=9, physics=(("c0", 2.0),), ic_scale=1.25, session="s1", deadline_s=5.0)
    rec = queue.request_to_record(req)
    jrec = jqueue.request_to_record(jqueue.Request(**{
        f: getattr(req, f) for f in ("request_id", "workload", "global_shape", "dtype", "nt",
                                     "physics", "ic_scale", "session", "deadline_s")}))
    assert {k: v for k, v in rec.items() if k != "t"} == \
        {k: v for k, v in jrec.items() if k != "t"}
    assert jqueue.validate_request_record(rec) == queue.validate_request_record(rec) == []
    path = tmp_path / "trace.jsonl"
    path.write_text(json.dumps(rec) + "\n\n" + json.dumps(rec) + "\n")
    rec.pop("t")
    assert [_rec(r) for r in jqueue.load_trace(path)] == [rec, rec]
    jpath = tmp_path / "jax.jsonl"
    jpath.write_text("".join(json.dumps(jqueue.request_to_record(jqueue.Request(**kw))) + "\n"
                             for kw in REQS))
    assert [_rec(r) for r in queue.load_trace(jpath)] == \
        [_rec(jqueue.Request(**kw)) for kw in REQS]


def test_request_validation():
    with pytest.raises(ValueError, match="workload"):
        Request(request_id="x", workload="plasma")
    with pytest.raises(ValueError, match="nt"):
        Request(request_id="x", nt=0)
    with pytest.raises(ValueError, match="session"):
        Request(request_id="x", resume=True)
    bad = queue.request_to_record(Request(request_id="ok"))
    bad["nt"] = -2
    assert queue.validate_request_record(bad) == jqueue.validate_request_record(bad) != []


def test_queue_fifo_requeue_front_and_relative_order():
    q = RequestQueue()
    ts = [q.submit(Request(request_id=c)) for c in "abcd"]
    assert [t.request.request_id for t in q.pop_pending()] == list("abcd")
    q.requeue([ts[2], ts[0]])
    q.submit(Request(request_id="e"))
    assert [t.request.request_id for t in q.pop_pending()] == ["a", "c", "e"]
    assert q.counters()["requeued"] == 2


def test_queue_deadline_expires_pending_at_pop():
    q = RequestQueue()
    stale = q.submit(Request(request_id="stale", deadline_s=1e-6))
    q.submit(Request(request_id="fresh", deadline_s=3600.0))
    time.sleep(0.01)
    assert [t.request.request_id for t in q.pop_pending()] == ["fresh"]
    assert stale.state == "expired"
    with pytest.raises(RuntimeError, match="deadline-exceeded"):
        stale.result(timeout=5)
    assert [t.request.request_id for t in q.take_expired()] == ["stale"]
    assert q.check_accounting(in_flight=1) == []


def test_queue_full_rejects_fast_with_bounded_retry_after():
    q = RequestQueue(max_depth=2)
    q.submit(Request(request_id="a"))
    q.submit(Request(request_id="b"))
    t = q.submit(Request(request_id="c"))
    assert t.state == "rejected" and q.rejected_at_submit == 1
    assert 0 < q.retry_after_hint() <= queue.MAX_RETRY_AFTER_S
    with pytest.raises(RuntimeError, match="queue-full"):
        t.result(timeout=1)


def test_queue_requeued_ticket_result_returns_none_promptly():
    q = RequestQueue()
    t = q.submit(Request(request_id="r"))
    q.pop_pending()
    q.requeue([t])
    assert t.result(timeout=5) is None and t.state == "requeued"
    q.pop_pending()
    assert t.state == "running" and not t.done()


def test_trace_context_wire_round_trip_equals_jax():
    from rocm_mpi_tpu.telemetry import tracing as jtracing

    ctx = tracing.mint("req-1")
    hop = tracing.next_hop(tracing.child(ctx))
    doc = tracing.to_wire(hop)
    assert tracing.validate_wire(doc) == jtracing.validate_wire(doc) == []
    assert tracing.from_wire(doc) == hop
    assert jtracing.to_wire(jtracing.from_wire(doc)) == doc
    assert hop.hop == 1 and hop.parent_id is not None and hop.trace_id == "req-1"


# ---------------------------------------------------------------------------
# The service against the JAX package's, and its contracts
# ---------------------------------------------------------------------------


def test_service_bins_programs_and_outcomes_equal_jax(port_served, jax_served):
    svc, tickets, report, _, _, stats = port_served
    jtickets, jreport = jax_served
    assert report.served == jreport.served == 6 and report.failed == jreport.failed == 0
    assert report.programs == jreport.programs
    assert sorted(k.key_str() for k in report.bins) == \
        sorted(k.key_str() for k in jreport.bins)
    assert [t.state for t in tickets] == [t.state for t in jtickets]
    assert stats == {k.key_str(): (st.widths, st.batches, st.requests, st.occupancy)
                     for k, st in jreport.bins.items()}


def test_service_repeat_trace_builds_nothing(port_served):
    svc, tickets, report, report2, rebuilt, _ = port_served
    assert report.n_programs == report.n_bins + sum(
        max(len(st.widths) - 1, 0) for st in report.bins.values())
    assert report.compiles["steady_state"] == report2.compiles["steady_state"] == 0
    assert rebuilt == 0 and report2.served == 6
    assert svc.queue.check_accounting() == []


def test_service_lanes_bitwise_to_standalone_and_near_jax(port_served, jax_served):
    _, tickets, _, _, _, _ = port_served
    jtickets, _ = jax_served
    for t in tickets:
        _assert_standalone(t)
    # JAX's lanes start from its own Gaussian (an ulp from the port's)
    for t, jt in zip(tickets, jtickets):
        for g, w in zip(t.result(timeout=5), jt.result(timeout=5)):
            np.testing.assert_allclose(g, np.asarray(w), **TOL64)


def test_service_hide_and_bf16_f32_lanes_bitwise():
    svc = _svc(max_width=4)
    reqs = [Request(request_id=f"h{i}", workload="diffusion", global_shape=(16, 16),
                    dtype=dt, nt=3 + i, variant=var, ic_scale=1.0 + 0.1 * i)
            for i, (dt, var) in enumerate([("f64", "hide"), ("f64", "hide"), ("f32", "hide"),
                                           ("bf16", "shard"), ("f32", "shard")])]
    tickets = [svc.queue.submit(r) for r in reqs]
    report = svc._drain_all()
    assert report.served == 5
    assert any("|hide|" in p for p in report.programs)
    for t in tickets:
        _assert_standalone(t)


def test_pipelined_depth_two_equals_serial_depth_one():
    got = {}
    for depth in (1, 2):
        svc = _svc(max_width=2, pipeline_depth=depth)
        tickets = [svc.queue.submit(r) for r in _mixed("pipe")]
        report = svc._drain_all()
        assert report.pipeline["depth"] == depth and report.pipeline["batches"] >= 4
        assert 0.0 <= report.pipeline["bubble"] <= 1.0
        got[depth] = [t.result(timeout=5) for t in tickets]
    for a, b in zip(got[1], got[2]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_segments_with_swaps_bitwise_for_every_workload():
    svc = _svc(max_width=2, segments=4)
    reqs = [Request(request_id=f"s{i}", workload=wl, global_shape=(16, 16), dtype="f64",
                    nt=nt, ic_scale=1.0 + 0.05 * i)
            for i, (wl, nt) in enumerate([("diffusion", 16), ("diffusion", 3), ("diffusion", 9),
                                          ("diffusion", 12), ("wave", 7), ("wave", 2),
                                          ("wave", 5), ("swe", 6), ("swe", 1), ("swe", 4)])]
    tickets = [svc.queue.submit(r) for r in reqs]
    report = svc._drain_all()
    assert report.served == len(reqs)
    assert report.continuous["swaps_in"] > 0 and report.continuous["segments_run"] > 3
    assert report.compiles["steady_state"] == 0
    for t in tickets:
        _assert_standalone(t)


def test_ladder_consolidates_classes_and_stays_bitwise():
    svc = _svc(max_width=4, ladder=True)
    reqs = [Request(request_id=f"l{i}", workload=wl, global_shape=sh, dtype="f64", nt=nt,
                    ic_scale=1.0 + 0.1 * i)
            for i, (wl, sh, nt) in enumerate([("diffusion", (30, 30), 5),
                                              ("diffusion", (32, 32), 6),
                                              ("wave", (30, 30), 5), ("wave", (32, 32), 7),
                                              ("swe", (30, 30), 3)])]
    tickets = [svc.queue.submit(r) for r in reqs]
    report = svc._drain_all()
    assert report.served == 5
    assert sum(p.endswith("|ladder") for p in report.programs) == 2
    for t in tickets:
        _assert_standalone(t)


def test_sessions_resume_bitwise_and_past_nt_fails_that_lane_only(tmp_path):
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    svc = _svc(max_width=2, sessions_dir=str(tmp_path / "sessions"))
    t1 = svc.queue.submit(Request(request_id="leg1", workload="diffusion",
                                  global_shape=(16, 16), dtype="f64", nt=4, ic_scale=1.1,
                                  session="sess-a"))
    svc._drain_all()
    assert t1.result(timeout=5) is not None
    sdir = tmp_path / "sessions" / "sess-a"
    assert ckpt.latest_valid_step(sdir) == 4
    assert ckpt.read_manifest(sdir, 4)["meta"]["extra"]["serving"]["request_id"] == "leg1"
    leg2 = Request(request_id="leg2", workload="diffusion", global_shape=(16, 16),
                   dtype="f64", nt=9, ic_scale=1.1, session="sess-a", resume=True)
    t2 = svc.queue.submit(leg2)
    bad = svc.queue.submit(Request(request_id="past", workload="diffusion",
                                   global_shape=(16, 16), dtype="f64", nt=2,
                                   session="sess-a", resume=True))
    good = svc.queue.submit(Request(request_id="fresh", workload="diffusion",
                                    global_shape=(16, 16), dtype="f64", nt=2))
    report = svc._drain_all()
    assert report.failed == 1
    with pytest.raises(RuntimeError, match="already at step"):
        bad.result(timeout=5)
    assert good.result(timeout=5) is not None
    assert t2.start_step == 4 and t2.steps_run == 5
    m = HeatDiffusion(DiffusionConfig(global_shape=(16, 16), dtype="f64"), device="cpu")
    T0, Cp = m.init_state()
    assert np.array_equal(t2.result(timeout=5)[0],
                          m.advance_fn("shard")(T0 * 1.1, Cp, 9).numpy())


def test_preemption_requeues_and_reports(monkeypatch):
    svc = _svc(max_width=1)
    calls = {"n": 0}

    def notice_after_first():
        calls["n"] += 1
        return calls["n"] > 1

    monkeypatch.setattr(svc, "_preempt_requested", notice_after_first)
    report = svc.run_trace([Request(request_id=f"p{i}", workload="diffusion",
                                    global_shape=(16, 16), dtype="f64", nt=2 + i)
                            for i in range(3)])
    assert report.preempted and report.served == 1 and report.requeued == 2
    assert svc.queue.depth() == 2


def _elastic_run(mod_service, make, policy, **kw):
    svc = mod_service.SimulationService(config=mod_service.ServeConfig(
        max_width=4, policy=policy(min_grow_interval_steps=0), device_budget=lambda: 2,
        grow_queue_depth=4, idle_shrink_drains=2, **kw))
    tickets = [svc.queue.submit(make(request_id=f"g{i}", workload="diffusion",
                                     global_shape=(16, 16), dtype="f64", nt=3,
                                     ic_scale=1.0 + 0.1 * i)) for i in range(4)]
    grew = svc.maybe_resize()
    report = svc._drain_all()
    svc.drain_once()
    svc.drain_once()
    shrank = svc.maybe_resize()
    events = [(e["event"], e["old_batch_dims"], e["new_batch_dims"]) for e in svc._elastic]
    return grew, shrank, report, events, svc._batch_dims, tickets


def test_elastic_grow_and_shrink_match_jax():
    from rocm_mpi_tpu.resilience.policy import ElasticPolicy as JElasticPolicy

    got = _elastic_run(service, Request, ElasticPolicy, device="cpu")
    want = _elastic_run(jservice, jqueue.Request, JElasticPolicy)
    assert got[0] and got[1] and (got[0], got[1]) == (want[0], want[1])
    assert got[3] == want[3] == [("serve.grow", 1, 2), ("serve.shrink", 2, 1)]
    assert got[4] == want[4] == 1
    assert got[2].programs == want[2].programs and all(p.endswith("|bd2")
                                                       for p in got[2].programs)
    for t, jt in zip(got[5], want[5]):
        _assert_standalone(t)
        np.testing.assert_allclose(t.result(timeout=5)[0], np.asarray(jt.result(timeout=5)[0]),
                                   **TOL64)


def test_non_pow2_batch_dims_rounds_down():
    svc = _svc(max_width=4, batch_dims=3)
    report = svc.run_trace([Request(request_id=f"bd{i}", workload="diffusion",
                                    global_shape=(16, 16), dtype="f64", nt=3)
                            for i in range(4)])
    assert report.served == 4 and all(p.endswith("|bd3") for p in report.programs)


def test_retry_budget_exhausted_quarantines(tmp_path, monkeypatch):
    qpath = tmp_path / "quarantine.jsonl"
    svc = _svc(max_width=1, retry=RequestRetryPolicy(budget=2, backoff_base_s=0.0),
               circuit=CircuitPolicy(k=0), quarantine_path=str(qpath), pipeline_depth=1)

    def always_broken(key, tickets, width, split):
        raise RuntimeError("poison program class")

    monkeypatch.setattr(svc, "_execute_batch", always_broken)
    t = svc.queue.submit(Request(request_id="poison-1", workload="diffusion",
                                 global_shape=(16, 16), dtype="f64", nt=2, ic_scale=1.5))
    report = svc._drain_all()
    assert report.quarantined == 1 and report.failed == 0
    assert t.state == "quarantined" and t.retries == 2
    assert svc.queue.check_accounting() == []
    records = queue.load_quarantine(qpath)
    assert len(records) == 1 and queue.validate_quarantine_record(records[0]) == []
    assert regress.check_schema([qpath]) == jregress.check_schema([qpath]) == []


def test_circuit_breaker_opens_and_half_open_recovers(monkeypatch):
    svc = _svc(max_width=1, retry=RequestRetryPolicy(budget=0),
               circuit=CircuitPolicy(k=2, cooldown_drains=2), pipeline_depth=1)
    real = svc._execute_batch
    broken = {"on": True}

    def flaky(key, tickets, width, split):
        if broken["on"]:
            raise RuntimeError("device fault")
        return real(key, tickets, width, split)

    monkeypatch.setattr(svc, "_execute_batch", flaky)
    req = dict(workload="diffusion", global_shape=(16, 16), dtype="f64", nt=2)
    for i in range(2):
        svc.queue.submit(Request(request_id=f"f{i}", **req))
    svc.drain_once()
    key = bins.bin_key(Request(request_id="k", **req))
    assert svc._breakers[key].state == "open"
    t = svc.queue.submit(Request(request_id="rej", **req))
    svc.drain_once()
    assert t.state == "rejected"
    broken["on"] = False
    ok = svc.queue.submit(Request(request_id="probe", **req))
    svc.drain_once()
    assert ok.state == "done" and svc._breakers[key].state == "closed"


def test_manifest_accepted_by_both_regress_gates(port_served, tmp_path):
    svc = port_served[0]
    path = tmp_path / "serve-manifest.json"
    doc = svc.write_manifest(path)
    assert bins.validate_manifest_doc(doc) == jbins.validate_manifest_doc(doc) == []
    trace_path = tmp_path / "serve-requests.jsonl"
    trace_path.write_text("".join(json.dumps(queue.request_to_record(r)) + "\n"
                                  for r in _mixed("man")))
    notes: list = []
    assert regress.check_schema([path, trace_path], notes=notes) == []
    assert notes == []
    assert jregress.check_schema([path, trace_path]) == []
    doc["bins"][0]["occupancy"] = 1.7
    bad = tmp_path / "bad-manifest.json"
    bad.write_text(json.dumps(doc))
    assert any("occupancy" in p for p in regress.check_schema([bad]))


def test_soak_report_validator_is_the_jax_one():
    from rocm_mpi_tpu.serving import slo as jslo

    assert slo.SOAK_SCHEMA == jslo.SOAK_SCHEMA
    for doc in ({"schema": slo.SOAK_SCHEMA, "v": 1}, {}, {"schema": "x"}):
        assert slo.validate_soak_report(doc) == jslo.validate_soak_report(doc)


# ---------------------------------------------------------------------------
# The serve app, and several ranks
# ---------------------------------------------------------------------------


def _app(args, **kw):
    env = {**os.environ, "OMP_NUM_THREADS": "2", **kw.pop("env", {})}
    return [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.serve", "--device", "cpu",
            *args], dict(cwd=REPO, env=env, **kw)


def test_serve_app_50_request_acceptance(tmp_path):
    out = tmp_path / "out"
    cmd, kw = _app(["--synthetic", "50", "--seed", "3", "--nt-max", "16", "--max-width", "4",
                    "--out", str(out)])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kw)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "compiles.steady_state=0" in proc.stdout
    doc = json.loads((out / "serve-manifest.json").read_text())
    assert bins.validate_manifest_doc(doc) == []
    assert doc["served"] == 50 and doc["preempted"] is False
    assert doc["compiles"]["steady_state"] == 0
    assert len(doc["programs"]) == sum(len(row["widths"]) for row in doc["bins"])
    assert len({row["key"].split("|")[1] for row in doc["bins"]}) >= 3
    # the same trace the JAX app generates, record for record
    from apps.serve import synthetic_trace as jax_synthetic
    from rocm_mpi_tpu_torch.apps.serve import synthetic_trace

    assert [_rec(r) for r in synthetic_trace(50, 3, nt_max=16)] == \
        [_rec(r) for r in jax_synthetic(50, 3, nt_max=16)]
    assert regress.check_schema([out / "serve-manifest.json",
                                 out / "serve-requests.jsonl"]) == []


def test_heavy_tailed_trace_is_the_jax_trace():
    from apps.serve import heavy_tailed_trace as jax_heavy
    from rocm_mpi_tpu_torch.apps.serve import heavy_tailed_trace

    assert [_rec(r) for r in heavy_tailed_trace(40, 5, nt_max=32)] == \
        [_rec(r) for r in jax_heavy(40, 5, nt_max=32)]


def test_serve_app_bad_flags_exit_2():
    from rocm_mpi_tpu_torch.apps import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", "--cpu-devices", "4"])
    assert e.value.code == 2
    assert serve.main(["--device", "cpu", "--synthetic", "2", "--synthetic-sessions"]) == 2


def test_serve_daemon_sigterm_while_idle_exits_75(tmp_path):
    out, tele = tmp_path / "out", tmp_path / "tele"
    cmd, kw = _app(["--serve", "--idle-exit-s", "300", "--synthetic", "3", "--seed", "7",
                    "--nt-max", "3", "--max-width", "4", "--telemetry", str(tele),
                    "--out", str(out)], env={"RMT_PREEMPT_GRACE_S": "30"})
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            **kw)
    try:
        stream = tele / "telemetry-rank0.jsonl"
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if stream.is_file() and \
                    stream.read_text(errors="replace").count("serve.request.done") >= 3:
                break
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.2)
        else:
            raise AssertionError("daemon never drained its trace")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, (stdout[-2000:], stderr[-2000:])
    assert "rc 75" in stdout and "0 requeued" in stdout
    doc = json.loads((out / "serve-manifest.json").read_text())
    assert doc["preempted"] is True and doc["served"] == 3


@pytest.mark.parametrize("nranks,batch_dims", [(2, 1), (4, 2)])
def test_serving_gloo_ranks_drill(nranks, batch_dims):
    """Several gloo ranks serve one trace: every rank plans the same
    programs, builds nothing on a repeat trace, turns the wall-clock
    SLOs off, and each lane's shards are bitwise the one-rank service's
    lanes (spawn_ranks' own timeout bounds the ranks: 200 s)."""
    got = spawn_ranks(nranks, worker.run_serve_rank, ({"batch_dims": batch_dims},),
                      timeout=200)
    one = _svc(max_width=4, fetch_results=True)
    tickets = {t.request.request_id: t for t in
               [one.queue.submit(r) for r in worker.serve_trace("a")]}
    one_report = one._drain_all()
    for rank, res in enumerate(got):
        assert res["served"] == 6 and res["failed"] == 0, rank
        assert res["steady"] == (0, 0) and res["rebuilt"] == 0, rank
        assert res["wall_slo"] is False
        assert res["programs"] == [p.replace("|bd1", f"|bd{batch_dims}")
                                   for p in one_report.programs]
    seen = set()
    for res in got:
        for rid, (slices, leaves) in res["shards"].items():
            seen.add(rid)
            for g, w in zip(leaves, tickets[rid].result(timeout=5)):
                assert np.array_equal(g, w[tuple(slices)]), rid
    assert seen == set(tickets)


def test_serving_gloo_depth_two_verdict_reads_its_own_batch():
    """Two gloo ranks at pipeline depth 2: two batches of one program
    run back to back with an odd step count, and the second batch's lane
    4 is poisoned. The first batch's verdict is taken from its own
    result, not from the spare buffer the second batch overwrote: its 8
    lanes are served at once, and only the poisoned request is retried
    (spawn_ranks' own timeout bounds the ranks: 200 s)."""
    got = spawn_ranks(2, worker.run_nan_rank, (), timeout=200)
    for rank, states in enumerate(got):
        assert all(st == "done" for st, _ in states.values()), (rank, states)
        retried = sorted(rid for rid, (_, n) in states.items() if n)
        assert retried == ["n-11"], (rank, states)
