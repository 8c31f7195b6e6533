"""The long-horizon chaos soak — counterpart of apps/soak.py
(docs/RESILIENCE.md §8 "The soak").

The fault machinery of the resilience and serving planes composes here:
a live serving session runs under a deterministic rolling fault schedule
that strikes all three layers —

  * the queue (queue-flood admission storms, deadline expiry),
  * the lanes (lane-nan numerical poison, batch-error/slow-batch, the
    per-BinKey circuit breaker's open → half-open → recover arc),
  * the infrastructure (SIGTERM eviction, injected storage outages
    through the session-save path, a fleet replica killed mid-traffic,
    and ≥2-rank serve-app episodes where a rank is killed / vanishes /
    stalls mid-batch and the argv launcher's supervision — peer-grace
    kill, vanish detection, the progress watchdog — must name the
    victim),

with SLO accounting (request latency p50/p99 from real telemetry events,
deadline-miss rate, rejected/expired/quarantined totals) banked in a
schema-versioned, atomically-written `soak-report.json`
(serving/slo.py) plus the append-only `quarantine.jsonl` poison ledger.

`--bounded` is the short edition (minutes, not hours): one episode per
fault family, the rank-kill drill included. The full schedule adds the
die (vanish) and stall (watchdog) episodes. Exit 0 iff every episode met
its expectation AND the terminal accounting invariant held everywhere —
a soak that "mostly worked" is a failed soak.

Where the port differs from the JAX app: `--device {cuda,cpu}` replaces
`--cpu-devices` (the in-process episodes' services and the rank
episodes' serve apps run there); the rank episodes drive the port's
serve app (`python -m rocm_mpi_tpu_torch.apps.serve`) through the argv
launcher `parallel/launcher.spawn_app_ranks`. On the CPU their ranks
join over gloo; ranks that share one card also join over gloo (staged
through host memory); with a card a rank they join over NCCL, and the
episodes keep their `gloo-*` names (the report's episode set is the
contract). `serve-chaos`'s device budget is the world size (1: this
process). `evict` sends SIGTERM to its own process, so a caller runs the
soak as a child process.

    python -m rocm_mpi_tpu_torch.apps.soak --bounded --device cpu --out output/soak_torch
    python -m rocm_mpi_tpu_torch.apps.soak --device cuda --ranks 4 --out /tmp/soak   # 4 cards
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import sys
import time

from rocm_mpi_tpu_torch.apps._common import positive_int

# Shapes small enough that every episode compiles in seconds on any
# backend; two classes so the bin scheduler has real work.
SHAPE_A = (16, 16)
SHAPE_B = (24, 24)


def _req(rid, shape=SHAPE_A, nt=4, workload="diffusion", dtype="f32",
         **kw):
    from rocm_mpi_tpu_torch.serving.queue import Request

    return Request(request_id=rid, workload=workload,
                   global_shape=shape, dtype=dtype, nt=nt, **kw)


def _drive(svc, flood_shape=SHAPE_A, max_drains=200):
    """Drain the service to empty, consulting the `queue-flood` fault
    at each drain boundary (the driver owns submission, so the flood
    lives here, not in the service). Returns the number of flooded
    submissions."""
    from rocm_mpi_tpu_torch.resilience import faults

    flooded = 0
    drain = 0
    while True:
        drain += 1
        clause = faults.serving_fault("queue-flood", step=drain)
        if clause is not None:
            n = max(int(clause.delay_s), 1)
            for i in range(n):
                svc.queue.submit(_req(
                    f"flood-{drain}-{i:03d}", shape=flood_shape, nt=2,
                    ic_scale=1.0 + 0.001 * i,
                ))
            flooded += n
        svc.maybe_resize()
        _, preempted = svc.drain_once()
        if preempted or svc.queue.depth() == 0:
            return flooded, preempted
        delay = svc.queue.next_ready_delay()
        if delay:
            time.sleep(min(delay, 0.25))
        if drain >= max_drains:
            raise RuntimeError(
                f"soak drive did not drain in {max_drains} drains "
                f"(depth {svc.queue.depth()})"
            )


def _episode(name, mode, fault_spec, fn):
    """Run one episode; never let an exception escape the schedule —
    a failed episode is a row with ok=False and the error, and the
    soak exits 1 (a crashed soak banks no report at all)."""
    from rocm_mpi_tpu_torch.resilience import faults

    t0 = time.monotonic()
    row = {"name": name, "mode": mode, "faults": fault_spec or ""}
    print(f"[soak] episode {name} ({mode})", flush=True)
    try:
        faults.install(fault_spec)
        details = fn()
        row.update(ok=True, **(details or {}))
    except Exception as e:  # noqa: BLE001 — the report is the verdict
        row.update(ok=False, error=f"{type(e).__name__}: {e}")
    finally:
        faults.install(None)
    row["wall_s"] = round(time.monotonic() - t0, 3)
    status = "ok" if row["ok"] else f"FAILED ({row.get('error')})"
    print(f"[soak] episode {name}: {status} in {row['wall_s']}s",
          flush=True)
    return row


class Soak:
    def __init__(self, out: pathlib.Path, ranks: int, seed: int, device: str = "cuda"):
        self.out = out
        self.ranks = ranks
        self.seed = seed
        self.device = device
        self.quarantine = out / "quarantine.jsonl"
        self.counters: dict[str, int] = {}
        self.stream_dirs = [out / "telemetry"]

    # ---- shared plumbing ------------------------------------------------

    def _service(self, **cfg):
        from rocm_mpi_tpu_torch.resilience.policy import RequestRetryPolicy
        from rocm_mpi_tpu_torch.serving.service import (
            ServeConfig,
            SimulationService,
        )

        cfg.setdefault("max_width", 4)
        cfg.setdefault("device", self.device)
        cfg.setdefault("quarantine_path", str(self.quarantine))
        cfg.setdefault(
            "retry", RequestRetryPolicy(budget=2, backoff_base_s=0.01)
        )
        return SimulationService(config=ServeConfig(**cfg))

    def _bank(self, svc, name: str) -> dict:
        """Close one in-process episode: accounting invariant asserted,
        counters folded into the soak totals, manifest banked."""
        svc._assert_accounting()
        c = svc.queue.counters()
        for k, v in c.items():
            if k != "depth":
                self.counters[k] = self.counters.get(k, 0) + int(v)
        self.counters["retries"] = (
            self.counters.get("retries", 0) + svc.retries_total
        )
        svc.write_manifest(self.out / f"serve-manifest-{name}.json")
        return c

    # ---- in-process episodes -------------------------------------------

    def ep_serve_chaos(self):
        """The request-plane storm: flood + deadline expiry + NaN
        poison + a transient batch error + a slow batch, on an elastic
        service — admission rejects the overflow fast, the poison lane
        ends quarantined, everything else serves."""
        from rocm_mpi_tpu_torch.parallel import distributed
        from rocm_mpi_tpu_torch.resilience.policy import ElasticPolicy

        svc = self._service(
            max_depth=8,
            policy=ElasticPolicy(min_grow_interval_steps=0),
            device_budget=distributed.world_size,
            grow_queue_depth=6,
            idle_shrink_drains=2,
        )
        for i in range(8):
            svc.queue.submit(_req(
                f"chaos-{i:03d}",
                shape=SHAPE_A if i % 3 else SHAPE_B,
                nt=3 + (i % 4),
                ic_scale=1.0 + 0.02 * i,
                # Two tickets with an already-hopeless TTL: pinned
                # deterministic deadline-exceeded at pop time.
                deadline_s=1e-6 if i in (5, 6) else None,
            ))
        flooded, _ = _drive(svc)
        c = self._bank(svc, "serve-chaos")
        assert c["quarantined"] >= 1, f"no quarantine: {c}"
        assert c["rejected"] >= 2, f"flood not rejected: {c}"
        assert c["expired"] >= 2, f"deadlines not expired: {c}"
        return {"counters": c, "flooded": flooded,
                "grew": bool(svc._elastic)}

    def ep_pipeline(self):
        """The pipelined drain under a slow-batch fault
        (docs/SERVING.md "The pipeline"): the SAME trace through the
        double-buffered drain and its serial twin — the overlapped
        fetch/resolve stage must not reorder terminal accounting
        (identical queue counters, invariant asserted on both) and
        every co-served result stays bitwise-equal across modes."""
        import numpy as np

        def trace():
            return [
                _req(
                    f"pipe-{i:02d}",
                    shape=SHAPE_A if i % 3 else SHAPE_B,
                    nt=3 + (i % 3),
                    ic_scale=1.0 + 0.015 * i,
                )
                for i in range(8)
            ]

        outs = {}
        counters = {}
        for depth in (2, 1):
            svc = self._service(max_width=2, pipeline_depth=depth)
            tickets = [svc.queue.submit(r) for r in trace()]
            _drive(svc)
            svc._assert_accounting()
            counters[depth] = {
                k: v for k, v in svc.queue.counters().items()
                if k != "depth"
            }
            outs[depth] = [t.result(timeout=5) for t in tickets]
            if depth == 2:
                pipe = svc.pipeline_stats()
                assert pipe["depth"] == 2 and pipe["batches"] >= 1, pipe
                self._bank(svc, "pipeline")
        assert counters[2] == counters[1], (
            "pipelined drain reordered terminal accounting: "
            f"{counters[2]} != {counters[1]}"
        )
        for i, (a, b) in enumerate(zip(outs[2], outs[1])):
            for la, lb in zip(a, b):
                assert np.array_equal(np.asarray(la), np.asarray(lb)), (
                    f"request {i}: pipelined != serial"
                )
        return {"counters": counters[2], "bubble": pipe["bubble"]}

    def ep_swap(self):
        """The continuous-batching swap drill (docs/SERVING.md
        "Continuous batching"): a same-class backlog deeper than the
        batch width runs through the step-segmented drain, so resolved
        lanes swap out at segment boundaries and queued tenants swap
        into their slots — and the swapped-in poison lane (lane-nan on
        every attempt) exhausts its retry budget mid-trace. The
        exactly-one-terminal invariant must hold across the swap churn,
        and every surviving co-batched tenant stays bitwise-equal to
        its standalone batch-synchronous twin."""
        import numpy as np

        def trace(tag):
            # One bin class: nts 4/3 share the 4-step bucket, so the
            # 2-step segments see both mid-flight freezes and
            # finishers whose slots the backlog refills.
            return [
                _req(f"{tag}-{i:02d}", shape=SHAPE_A,
                     nt=4 if i % 2 == 0 else 3,
                     ic_scale=1.0 + 0.02 * i)
                for i in range(6)
            ]

        svc = self._service(max_width=2, segments=2)
        tickets = [svc.queue.submit(r) for r in trace("swap")]
        _drive(svc)
        cont = svc._continuous
        assert cont["batches"] >= 1, cont
        assert cont["swaps_in"] >= 1, (
            f"segmented drain never swapped a lane in: {cont}"
        )
        # The poisoned swap-in (ordinal 3) burned its whole retry
        # budget; everyone else reached done — exactly one terminal
        # state each, certified by _bank's accounting assert.
        bad = tickets[2]
        assert bad.state == "quarantined", (bad.state, bad.error)
        for t in tickets:
            if t is not bad:
                assert t.state == "done", (
                    t.request.request_id, t.state, t.error
                )
        c = self._bank(svc, "swap")
        assert c["completed"] == 5 and c["quarantined"] == 1, c
        # Bitwise pin: each survivor against a solo batch-synchronous
        # run (the injected lane-nan clause is exhausted by now).
        twin = self._service(max_width=1)
        twin_tickets = [twin.queue.submit(r) for r in trace("swap")]
        _drive(twin)
        for i, (t, ref) in enumerate(zip(tickets, twin_tickets)):
            if t is bad:
                continue
            for a, b in zip(t.result(timeout=5), ref.result(timeout=5)):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (
                    f"request {i}: swapped lane != standalone twin"
                )
        return {"counters": c, "swaps_in": cont["swaps_in"],
                "segments_run": cont["segments_run"]}

    def ep_breaker(self):
        """The circuit-breaker arc: three consecutive injected batch
        errors open SHAPE_A's class (its pending requests reject fast
        with circuit-open while SHAPE_B keeps serving), the cooled-down
        breaker re-admits one half-open probe, and recovery closes it."""
        from rocm_mpi_tpu_torch.resilience.policy import (
            CircuitPolicy,
            RequestRetryPolicy,
        )

        svc = self._service(
            max_width=2,
            retry=RequestRetryPolicy(budget=1, backoff_base_s=0.0),
            circuit=CircuitPolicy(k=3, cooldown_drains=2),
        )
        from rocm_mpi_tpu_torch.resilience import faults

        # Drain 1 executes SHAPE_A's three width-2 batches first
        # (sorted bin keys), then SHAPE_B's: the three errors strike
        # exactly class A.
        faults.install(
            "batch-error@step=1;batch-error@step=2;batch-error@step=3"
        )
        healthy = []
        for i in range(6):
            svc.queue.submit(_req(f"brk-a-{i}", shape=SHAPE_A, nt=3))
        for i in range(2):
            healthy.append(svc.queue.submit(
                _req(f"brk-b-{i}", shape=SHAPE_B, nt=3)
            ))
        _drive(svc)
        from rocm_mpi_tpu_torch.serving.bins import bin_key

        key_a = bin_key(_req("probe0", shape=SHAPE_A, nt=3))
        br = svc._breakers[key_a]
        assert br.state == "open", f"breaker never opened ({br.state})"
        for t in healthy:
            assert t.state == "done", (
                "an open class starved a healthy tenant: "
                f"{t.request.request_id} {t.state}"
            )
        # Cool down (empty drains), then the half-open probe recovers
        # (the injected errors are exhausted by now).
        svc.drain_once()
        svc.drain_once()
        probe = svc.queue.submit(_req("probe-recover", shape=SHAPE_A,
                                      nt=3))
        _drive(svc)
        assert probe.state == "done", f"probe {probe.state}: {probe.error}"
        assert br.state == "closed", f"breaker stuck {br.state}"
        c = self._bank(svc, "breaker")
        assert c["rejected"] >= 1, f"open breaker rejected nothing: {c}"
        return {"counters": c}

    def ep_storage(self):
        """Storage outages strike the session-save path: an io-error
        burst outlasting the checkpoint retry ladder fails the lane,
        the request-plane retry re-runs it to a clean save; enospc and
        io-slow are absorbed by the StoragePolicy ladder itself."""
        sessions = self.out / "sessions"
        svc = self._service(sessions_dir=str(sessions))
        from rocm_mpi_tpu_torch.resilience import faults

        faults.install(
            "io-error@step=6,times=3;io-slow=0.1@step=8;"
            "enospc@step=10"
        )
        a = svc.queue.submit(_req("store-a", nt=6, session="soak-a"))
        b = svc.queue.submit(_req("store-b", nt=8, session="soak-b"))
        d = svc.queue.submit(_req("store-c", nt=10, session="soak-c"))
        _drive(svc)
        for t in (a, b, d):
            assert t.state == "done", (t.request.request_id, t.error)
        assert a.retries >= 1, "outage never forced a request retry"
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        for sid, nt in (("soak-a", 6), ("soak-b", 8), ("soak-c", 10)):
            step = ckpt.latest_valid_step(sessions / sid)
            assert step == nt, f"session {sid}: {step} != {nt}"
        c = self._bank(svc, "storage")
        return {"counters": c, "request_retries": a.retries}

    def ep_evict(self):
        """A real SIGTERM eviction mid-trace: the notice stops dispatch
        at the batch boundary, every unserved ticket is requeued (the
        rc-75 contract), and the relaunched drain serves them all."""
        from rocm_mpi_tpu_torch.resilience import preempt

        preempt.install(grace_s=30.0)
        svc = self._service(max_width=1)
        for i in range(6):
            svc.queue.submit(_req(f"evict-{i}", nt=3,
                                  ic_scale=1.0 + 0.01 * i))
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not preempt.requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert preempt.requested(), "SIGTERM notice never landed"
        report = svc._drain_all()
        assert report.preempted, "drain ignored the eviction notice"
        requeued = svc.queue.depth()
        assert requeued >= 1, "nothing requeued at the eviction"
        # The next service instance (same queue here) drains the parked
        # work after the eviction passes.
        preempt.reset()
        report2 = svc._drain_all()
        assert not report2.preempted
        assert svc.queue.depth() == 0
        c = self._bank(svc, "evict")
        assert c["completed"] == 6, c
        return {"counters": c, "requeued_at_eviction": requeued}

    def ep_fleet(self):
        """The fleet kill drill (docs/SERVING.md "The fleet"): three
        in-process replicas behind the router + ticket journal,
        replica 1 killed MID-traffic by the fault grammar at fleet
        tick 2 — every journaled ticket reaches exactly one terminal
        state fleet-wide (journal replay is idempotent and balances),
        the surviving tenants' results stay bitwise-equal to a
        standalone twin, and the merged fleet report banks
        schema-valid with compiles.steady_state 0 per replica."""
        import numpy as np

        from rocm_mpi_tpu_torch.serving import journal as fleet_journal
        from rocm_mpi_tpu_torch.serving.router import FleetRouter
        from rocm_mpi_tpu_torch.telemetry import compiles

        # The report rows carry the process-global steady-recompile
        # count; isolate this episode's window from earlier episodes'
        # compile traffic (the installed tap stays).
        compiles.reset()

        def trace(prefix="fleet"):
            # Three bins over two shapes: wave pacing below guarantees
            # at least one ticket is OPEN on replica 1 at the tick-2
            # kill (bin affinity spreads the three bins one per
            # replica on first route).
            return [
                _req(
                    f"{prefix}-{i:02d}",
                    shape=SHAPE_A if i % 3 else SHAPE_B,
                    nt=3 + (i % 3),
                    ic_scale=1.0 + 0.015 * i,
                )
                for i in range(9)
            ]

        jpath = self.out / "fleet-journal.jsonl"
        if jpath.exists():
            jpath.unlink()
        journal = fleet_journal.TicketJournal(jpath)
        router = FleetRouter(
            lambda rid: self._service(max_width=2), 3, journal=journal,
        )
        reqs = trace()
        tickets = []
        for i in range(0, len(reqs), 3):
            tickets += [router.submit(r) for r in reqs[i:i + 3]]
            router.drive_once()
        router.drive()
        problems = router.check_accounting()
        assert not problems, problems
        dead = [r for r in router.replicas if not r.alive]
        assert [r.id for r in dead] == [1], (
            f"replica-kill@step=2,rank=1 did not kill replica 1: "
            f"{[(r.id, r.alive, r.verdict) for r in router.replicas]}"
        )
        state = router.journal_state()
        counts = state.counts()
        assert counts["open"] == 0 and counts["rerouted"] >= 1, counts
        # Replay idempotence: the journal is a pure fold — replaying
        # the complete journal changes no counter.
        assert fleet_journal.replay(journal.segments()).counts() \
            == counts, "journal replay is not idempotent"
        # Bitwise twin: the same trace through ONE standalone service.
        # Distinct twin ids: the twin's done events land in the SAME
        # rank stream, and the trace-continuity check below pins "one
        # terminal span per fleet request" — identical ids would read
        # as duplicate terminals (results only depend on shape/nt/
        # ic_scale, so renaming changes nothing bitwise).
        twin = self._service(max_width=2)
        twin_tickets = [twin.queue.submit(r) for r in trace("twin")]
        _drive(twin)
        for t, ref in zip(tickets, twin_tickets):
            assert t.state == "done", (t.request.request_id, t.error)
            for a, b in zip(t.result(timeout=5),
                            ref.result(timeout=5)):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (
                    f"{t.request.request_id}: fleet != standalone twin"
                )
        streams = sorted(
            pathlib.Path(self.stream_dirs[0]).glob(
                "telemetry-rank*.jsonl"
            )
        )
        doc = router.report_doc(stream_paths=streams)
        assert doc["accounting_ok"], doc
        for row in doc["replicas"]:
            assert row["steady_state"] == 0, row
        fleet_journal.write_fleet_report(
            self.out / "fleet-report.json", doc
        )
        # Trace continuity across the failover (docs/TELEMETRY.md
        # "Request tracing"): every ticket's causal timeline must end
        # in exactly ONE terminal span, the journal-recovered tickets
        # must show BOTH hops (minted at the front door, hop+1 at
        # reconcile), and the done event's latency decomposition must
        # telescope — stages summing to the measured latency — under a
        # real mid-batch kill, not a unit fixture.
        from rocm_mpi_tpu_torch.telemetry import aggregate, tracing

        loaded, _ = aggregate.load_rank_streams(self.stream_dirs[0])
        rerouted_ids = []
        for t in tickets:
            rid = t.request.request_id
            tl = tracing.request_timeline(loaded, rid)
            assert tl is not None, f"{rid}: no trace in rank streams"
            assert not tl["warnings"], (rid, tl["warnings"])
            terms = [r for r in tl["events"]
                     if r["name"].startswith("serve.request.")
                     and r["name"].split(".")[-1] in
                     ("done", "quarantined", "rejected", "expired")]
            assert len(terms) == 1 and tl["terminal"] == "done", (
                f"{rid}: expected one terminal done span, got "
                f"{[(r['name'], r['rank']) for r in terms]}"
            )
            decomp = tl["decomposition"]
            assert decomp is not None \
                and not tracing.validate_decomposition(decomp), (
                    rid, decomp,
                    tracing.validate_decomposition(decomp or {}),
                )
            assert abs(sum(decomp.values()) - tl["latency_s"]) < 0.05, (
                f"{rid}: decomposition {decomp} does not sum to "
                f"latency {tl['latency_s']}"
            )
            if max(tl["hops"], default=0) >= 1:
                assert tl["hops"] == [0, 1], (rid, tl["hops"])
                rerouted_ids.append(rid)
                tracing.write_trace_report(
                    self.out / f"trace-report-{rid}.json",
                    tracing.trace_report_doc(tl),
                )
        assert len(rerouted_ids) >= 1, (
            "replica kill produced no two-hop trace "
            f"(journal rerouted={counts['rerouted']})"
        )
        journal.close()
        merged = router.merged_counters()
        for k, v in merged.items():
            self.counters[k] = self.counters.get(k, 0) + int(v)
        return {"counters": merged, "rerouted": counts["rerouted"],
                "killed": [r.id for r in dead]}

    # ---- multi-rank episodes (the serve app on spawned ranks) ----------

    def _serve_argv(self, n: int, extra=()):
        return [
            "-m", "rocm_mpi_tpu_torch.apps.serve", "--device", self.device,
            "--synthetic", str(n), "--seed", str(self.seed),
            "--nt-max", "16", "--max-width", "4",
            *extra,
        ]

    @property
    def rank_mode(self) -> str:
        """The backend the rank episodes' serve apps join over
        (parallel/distributed.default_backend)."""
        from rocm_mpi_tpu_torch.parallel import distributed

        return distributed.default_backend(self.device, self.ranks)

    def ep_gloo_serve(self):
        """The clean ≥2-rank serving session: the serve app's space grid
        over the ranks, every request served, per-request latency
        telemetry banked (the SLO block's primary real-telemetry
        source)."""
        from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks

        tdir = self.out / "telemetry-gloo"
        out_dir = self.out / "gloo-serve"
        results = spawn_app_ranks(
            self._serve_argv(8, extra=["--out", str(out_dir)]),
            nprocs=self.ranks, timeout=300, telemetry_dir=tdir,
        )
        self.stream_dirs.append(tdir)
        for rank, (proc, (out, err)) in enumerate(results):
            assert proc.returncode == 0, (
                rank, out[-500:], err[-2000:]
            )
        manifest = json.loads(
            (out_dir / "serve-manifest.json").read_text()
        )
        for k, v in manifest.get("queue", {}).items():
            if k != "depth":
                self.counters[k] = self.counters.get(k, 0) + int(v)
        assert manifest["queue"]["completed"] == 8, manifest["queue"]
        return {"ranks": self.ranks,
                "programs": len(manifest["programs"])}

    def ep_gloo_kill(self):
        """Infrastructure kill mid-batch on a multi-rank serving session:
        rank 1 exits rc 43 at the serve-batch fault site; the
        launcher's first-failure scan names it and the peer-grace kill
        reaps the wedged survivor."""
        from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks
        from rocm_mpi_tpu_torch.resilience.faults import RC_INJECTED_KILL

        results = spawn_app_ranks(
            self._serve_argv(8),
            nprocs=self.ranks, timeout=240, peer_grace_s=5,
            inject_fault="kill@step=2,rank=1,at=serve-batch",
        )
        ff = results.report.first_failure
        assert ff is not None, "launcher saw no failure"
        assert ff[0] == 1 and ff[1] == RC_INJECTED_KILL, ff
        return {"first_failure": list(ff[:2])}

    def ep_gloo_die(self):
        """The vanished rank: rank 1 exits CLEAN (rc 0) mid-batch; only
        vanish detection can tell the death from completion skew."""
        from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks

        results = spawn_app_ranks(
            self._serve_argv(8),
            nprocs=self.ranks, timeout=240, peer_grace_s=5,
            vanish_grace_s=4.0,
            inject_fault="die@step=2,rank=1,at=serve-batch",
        )
        report = results.report
        assert report.vanished == 1, (report.vanished, report.events)
        return {"vanished": report.vanished}

    def ep_gloo_stall(self):
        """The wedged rank: rank 1 busy-waits forever BEFORE its batch
        progress bump; its peer bumps past it into the batch collective
        and the progress watchdog names the victim BY PROGRESS."""
        from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks

        hdir = self.out / "health-stall"
        results = spawn_app_ranks(
            self._serve_argv(12),
            nprocs=self.ranks, timeout=300, peer_grace_s=5,
            health_dir=hdir, stall_grace_s=5.0,
            inject_fault="stall@step=3,rank=1,at=serve-batch",
        )
        verdicts = results.report.watchdog_verdicts
        assert verdicts and verdicts[0]["rank"] == 1, (
            verdicts, results.report.events
        )
        return {"watchdog_rank": verdicts[0]["rank"]}

    # ---- the schedule ---------------------------------------------------

    def schedule(self, bounded: bool, gloo: bool):
        mode = self.rank_mode if gloo else None
        eps = [
            ("serve-chaos", "in-process",
             "queue-flood=10@step=2;lane-nan@request=3,times=9;"
             "slow-batch=0.05@step=3;batch-error@step=4",
             self.ep_serve_chaos),
            # times=2: the pipelined run and its serial twin each
            # consume one firing of every slow-batch clause.
            ("pipeline", "in-process",
             "slow-batch=0.05@step=2,times=2;"
             "slow-batch=0.05@step=4,times=2",
             self.ep_pipeline),
            # times=3: the swapped-in poison lane burns its full retry
            # budget (attempt + 2 retries), then the clause is spent so
            # the bitwise twin runs clean.
            ("swap", "in-process", "lane-nan@request=3,times=3",
             self.ep_swap),
            # breaker/storage install their own specs (multiple phases).
            ("breaker", "in-process", None, self.ep_breaker),
            ("storage", "in-process", None, self.ep_storage),
            ("evict", "in-process", None, self.ep_evict),
            ("fleet", "in-process", "replica-kill@step=2,rank=1",
             self.ep_fleet),
        ]
        if gloo:
            eps += [
                ("gloo-serve", mode, None, self.ep_gloo_serve),
                ("gloo-kill", mode,
                 "kill@step=2,rank=1,at=serve-batch", self.ep_gloo_kill),
            ]
            if not bounded:
                eps += [
                    ("gloo-die", mode,
                     "die@step=2,rank=1,at=serve-batch",
                     self.ep_gloo_die),
                    ("gloo-stall", mode,
                     "stall@step=3,rank=1,at=serve-batch",
                     self.ep_gloo_stall),
                ]
        return eps


def fault_kinds_in(episodes) -> list[str]:
    """The fault kinds this soak actually composed (report evidence)."""
    kinds = set()
    for ep in episodes:
        for clause in (ep.get("faults") or "").split(";"):
            head = clause.split("@")[0].split("=")[0].strip()
            if head:
                kinds.add(head)
    # Episodes that install specs internally (breaker/storage) + the
    # eviction's real SIGTERM:
    names = {ep["name"] for ep in episodes}
    if "breaker" in names:
        kinds.add("batch-error")
    if "storage" in names:
        kinds.update({"io-error", "io-slow", "enospc"})
    if "evict" in names:
        kinds.add("sigterm")
    return sorted(kinds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="long-horizon chaos soak (docs/RESILIENCE.md §8)"
    )
    p.add_argument("--bounded", action="store_true",
                   help="the short edition: one episode per fault family, "
                   "minutes not hours")
    p.add_argument("--out", default="output/soak_torch", metavar="DIR")
    p.add_argument("--ranks", type=positive_int, default=2,
                   help="ranks for the multi-rank (gloo-*) episodes")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the services and the rank episodes' serve apps run "
                   "(cuda: the GPU, one card a rank when there are enough, else "
                   "shared over gloo; cpu: the plain versions over gloo)")
    p.add_argument("--no-gloo", action="store_true",
                   help="skip the multi-rank episodes (debug only — "
                   "the acceptance soak runs them)")
    args = p.parse_args(argv)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # A fresh soak owns its ledger: stale quarantine lines from a
    # previous run must not inflate this run's poison count.
    q = out / "quarantine.jsonl"
    if q.exists():
        q.unlink()

    from rocm_mpi_tpu_torch.utils.backend import resolve_device

    resolve_device(args.device)  # fail here without a card, before any episode
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.serving import slo
    from rocm_mpi_tpu_torch.telemetry import compiles

    tdir = out / "telemetry"
    telemetry.configure(enabled=True, directory=str(tdir))
    compiles.install()

    soak = Soak(out, ranks=args.ranks, seed=args.seed, device=args.device)
    episodes = []
    for name, mode, spec, fn in soak.schedule(
        bounded=args.bounded, gloo=not args.no_gloo
    ):
        episodes.append(_episode(name, mode, spec, fn))

    # SLO block from REAL telemetry: every serve.request.done event's
    # latency across the in-process stream and the gloo rank streams.
    streams = []
    for d in soak.stream_dirs:
        streams += sorted(pathlib.Path(d).glob("telemetry-rank*.jsonl"))
    counters = dict(soak.counters)
    counters.setdefault("retries", 0)
    # accounting_ok certifies ONLY the terminal-accounting invariant
    # (every episode banks through _bank's _assert_accounting, whose
    # violation surfaces in the episode error) — a failed SLO
    # expectation must not read as a phantom ticket leak.
    accounting_ok = not any(
        "accounting invariant" in (ep.get("error") or "")
        for ep in episodes
    )
    doc = slo.soak_report_doc(
        episodes,
        slo.slo_block(counters, streams),
        bounded=args.bounded,
        accounting_ok=accounting_ok,
        fault_kinds=fault_kinds_in(episodes),
    )
    report_path = out / "soak-report.json"
    try:
        slo.write_soak_report(report_path, doc)
    except ValueError as e:
        # A soak whose serving episodes banked no telemetry cannot
        # produce a valid (populated) report — say so and fail, don't
        # crash without a verdict.
        print(f"[soak] report not bankable: {e}", file=sys.stderr,
              flush=True)
        return 1
    ok = all(ep["ok"] for ep in episodes)
    print(
        f"[soak] {'OK' if ok else 'FAILED'}: "
        f"{sum(ep['ok'] for ep in episodes)}/{len(episodes)} episodes, "
        f"slo p50={doc['slo']['latency_s']['p50']} "
        f"p99={doc['slo']['latency_s']['p99']} "
        f"miss_rate={doc['slo']['deadline_miss_rate']} "
        f"quarantined={doc['slo']['quarantined']} — {report_path}",
        flush=True,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
