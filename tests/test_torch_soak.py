"""The port's chaos soak (rocm_mpi_tpu_torch/apps/soak.py, serving/slo.py)
against the JAX package's, on the CPU: the counterparts of
tests/test_soak.py's five tests.

The SLO aggregation and the soak report's schema are held equal to the
JAX package's on the same inputs; the bounded soak runs as a child with
`--device cpu` (its `evict` episode sends SIGTERM to its own process) and
must meet test_soak.py's acceptance: exit 0, the nine episodes `ok`, a
report valid under both packages' check_schema whose SLO block is
populated from real telemetry, the fleet episode's sidecars and two-hop
trace report valid, and every fault plane composed.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from rocm_mpi_tpu.serving import slo as jslo
from rocm_mpi_tpu.telemetry import regress as jregress
from rocm_mpi_tpu_torch.serving import queue, slo
from rocm_mpi_tpu_torch.telemetry import regress

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("values,q", [([], 50), ([3.0], 99), ([1.0, 2.0, 3.0, 4.0], 50),
                                      ([1.0, 2.0, 3.0, 4.0], 100), ([1.0, 2.0, 3.0, 4.0], 0),
                                      ([0.5, 0.1, 0.9, 0.3, 0.7], 99)])
def test_percentile_interpolates(values, q):
    assert slo.percentile(values, q) == jslo.percentile(values, q)
    assert slo.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def _event_line(rid, latency, miss=False):
    return json.dumps({"kind": "event", "v": 2, "name": "serve.request.done", "t": 1.0,
                       "request_id": rid, "latency_s": latency, "deadline_miss": miss})


def test_latencies_dedupe_across_rank_streams(tmp_path):
    """Every rank of a multi-controller service emits the same done event:
    one request is ONE observation, and a torn tail is tolerated."""
    r0, r1 = tmp_path / "telemetry-rank0.jsonl", tmp_path / "telemetry-rank1.jsonl"
    r0.write_text(_event_line("a", 0.5) + "\n" + _event_line("b", 1.5, miss=True) + "\n")
    r1.write_text(_event_line("a", 0.5) + "\n" + _event_line("b", 1.5, miss=True) + "\n"
                  + '{"torn')
    facts = slo.latencies_from_streams([r0, r1])
    assert facts == jslo.latencies_from_streams([r0, r1])
    assert facts["latencies"] == {"a": 0.5, "b": 1.5}
    assert facts["deadline_missed_done"] == ["b"]
    counters = {"submitted": 4, "completed": 2, "failed": 0, "rejected": 1, "expired": 1,
                "quarantined": 0, "retries": 0}
    block = slo.slo_block(counters, [r0, r1])
    assert block == jslo.slo_block(counters, [r0, r1])
    assert block["latency_s"]["n"] == 2 and block["latency_s"]["p50"] == 1.0
    assert block["deadline_misses"] == 2 and block["deadline_miss_rate"] == 0.5


def _valid_doc(tmp_path, mod=slo):
    streams = tmp_path / "telemetry-rank0.jsonl"
    streams.write_text(_event_line("a", 0.25) + "\n")
    block = mod.slo_block({"submitted": 1, "completed": 1, "failed": 0, "rejected": 0,
                           "expired": 0, "quarantined": 0, "retries": 0}, [streams])
    return mod.soak_report_doc([{"name": "serve-chaos", "mode": "in-process", "ok": True}],
                               block, bounded=True, accounting_ok=True,
                               fault_kinds=["lane-nan", "kill"])


def test_soak_report_roundtrip_and_gate(tmp_path):
    doc = _valid_doc(tmp_path)
    assert {k: v for k, v in doc.items() if k != "t"} == \
        {k: v for k, v in _valid_doc(tmp_path, jslo).items() if k != "t"}
    assert slo.validate_soak_report(doc) == []
    path = tmp_path / "soak-report.json"
    slo.write_soak_report(path, doc)
    assert path.is_file() and not (tmp_path / "soak-report.json.tmp").exists()
    assert regress.check_schema([path]) == jregress.check_schema([path]) == []
    empty = _valid_doc(tmp_path)
    empty["slo"]["latency_s"] = {"n": 0, "p50": None, "p99": None}
    got = slo.validate_soak_report(empty)
    assert got == jslo.validate_soak_report(empty) and any("populated" in p for p in got)
    with pytest.raises(ValueError, match="populated"):
        slo.write_soak_report(tmp_path / "never.json", empty)
    bad = _valid_doc(tmp_path)
    bad["slo"]["deadline_miss_rate"] = 1.7
    bad2 = _valid_doc(tmp_path)
    del bad2["episodes"][0]["ok"]
    for name, doctored, word in (("bad", bad, "deadline_miss_rate"), ("bad2", bad2, "ok")):
        p = tmp_path / f"{name}-soak-report.json"
        p.write_text(json.dumps(doctored))
        got = regress.check_schema([p])
        assert got == jregress.check_schema([p]) and any(word in x for x in got)


def test_slo_fields_pinned_against_queue_terminals():
    assert slo.SLO_COUNT_FIELDS == jslo.SLO_COUNT_FIELDS
    assert set(slo.SLO_COUNT_FIELDS) == {"submitted", "retries", "done", "failed",
                                         "rejected", "expired", "quarantined"}
    assert set(queue.TERMINAL_STATES) == {"done", "failed", "rejected", "expired",
                                          "quarantined"}


def test_bounded_soak_acceptance(tmp_path):
    """The bounded port soak as a child on the CPU: the rolling fault
    schedule composing the queue plane (flood, deadline expiry, NaN
    quarantine, breaker recovery), the storage plane, a real SIGTERM
    eviction, the fleet's replica kill and the two-rank serve and kill
    episodes exits 0 with a report valid under both packages' gates, the
    JAX soak's episode set and its SLO block populated from real
    telemetry."""
    out = tmp_path / "soak"
    proc = subprocess.run(
        [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.soak", "--bounded", "--device",
         "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    doc = json.loads((out / "soak-report.json").read_text())
    assert slo.validate_soak_report(doc) == jslo.validate_soak_report(doc) == []
    sidecars = [out / "soak-report.json", out / "quarantine.jsonl",
                out / "fleet-report.json", out / "fleet-journal.jsonl"]
    assert regress.check_schema(sidecars) == jregress.check_schema(sidecars) == []

    names = {ep["name"]: ep for ep in doc["episodes"]}
    assert set(names) == {"serve-chaos", "pipeline", "swap", "breaker", "storage", "evict",
                          "fleet", "gloo-serve", "gloo-kill"}
    assert all(ep["ok"] for ep in doc["episodes"]), doc["episodes"]
    assert names["gloo-kill"]["first_failure"] == [1, 43]
    assert names["swap"]["swaps_in"] >= 1 and names["swap"]["counters"]["quarantined"] == 1
    assert "bubble" in names["pipeline"]
    assert names["fleet"]["killed"] == [1] and names["fleet"]["rerouted"] >= 1
    assert doc["accounting_ok"] is True

    trace_reports = sorted(out.glob("trace-report-*.json"))
    assert trace_reports
    assert regress.check_schema(trace_reports) == jregress.check_schema(trace_reports) == []
    tr = json.loads(trace_reports[0].read_text())
    assert tr["hops"] == [0, 1] and tr["terminal"] == "done", tr
    dec = doc["slo"]["decomposition"]
    assert dec["n"] >= 8 and dec["hops"]["rerouted"] >= 1, dec
    assert {"queue_wait", "device"} <= set(dec["stages"]), dec

    s = doc["slo"]
    assert s["latency_s"]["n"] >= 8 and s["latency_s"]["p50"] > 0
    assert s["quarantined"] >= 1 and s["rejected"] >= 2 and s["expired"] >= 2
    assert s["retries"] >= 1 and 0.0 < s["deadline_miss_rate"] < 1.0
    assert {"lane-nan", "batch-error", "slow-batch", "queue-flood", "io-error", "io-slow",
            "enospc", "sigterm", "kill", "replica-kill"} <= set(doc["fault_kinds"])

    records = queue.load_quarantine(out / "quarantine.jsonl")
    assert records and queue.request_from_record(records[0]["request"]).workload
