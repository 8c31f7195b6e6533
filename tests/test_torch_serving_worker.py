"""Ranks of tests/test_torch_batched.py, tests/test_torch_serving.py and
tests/test_torch_fleet.py (gloo), started by
rocm_mpi_tpu_torch.parallel.launcher.spawn_ranks; it holds no tests
itself. Imports torch and the port only, so a spawned rank starts fast."""

from __future__ import annotations

import numpy as np
import torch

SHAPE = (16, 16)
LANE_STEPS = [5, 3, 5, 1]
SCALES = [1.0 + 0.1 * i for i in range(4)]
LAYOUTS = {"rows": (2, (1, 2)), "square": (1, (2, 2))}


def _models(grid):
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.models.swe import ShallowWater
    from rocm_mpi_tpu_torch.models.wave import AcousticWave

    kw = dict(global_shape=SHAPE, dtype="f64", nt=8, warmup=0, b_width=(2, 2))
    return (HeatDiffusion(DiffusionConfig(**kw), grid=grid, device="cpu"),
            AcousticWave(WaveConfig(**{k: v for k, v in kw.items() if k != "b_width"}),
                         grid=grid, device="cpu"),
            ShallowWater(SWEConfig(**{k: v for k, v in kw.items() if k != "b_width"}),
                         grid=grid, device="cpu"))


def _lanes_of(bgrid, models):
    """{variant: this rank's advanced lane block} of every batched path."""
    m, w, s = models
    nb = len(bgrid.lane_range())
    steps = [LANE_STEPS[j] for j in bgrid.lane_range()]
    scales = [SCALES[j] for j in bgrid.lane_range()]
    out = {}
    T0, Cp = m.init_state()
    for variant in ("shard", "hide"):
        adv, _ = m.batched_advance_fn(bgrid=bgrid, variant=variant)
        out["diffusion-" + variant] = adv(torch.stack([T0 * x for x in scales]), Cp, steps,
                                          max(LANE_STEPS)).numpy()
    U0, _, C2 = w.init_state()
    adv, _ = w.batched_advance_fn(bgrid=bgrid)
    ub = torch.stack([U0 * x for x in scales])
    out["wave"] = np.stack([t.numpy() for t in adv(ub, ub.clone(), C2, steps,
                                                  max(LANE_STEPS))], 1)
    h0, _ = s.init_state()
    adv, _ = s.batched_advance_fn(bgrid=bgrid)
    z = torch.zeros((nb,) + tuple(h0.shape), dtype=h0.dtype)
    h, us = adv(torch.stack([h0 * x for x in scales]), (z, z.clone()), s.face_masks(), steps,
                max(LANE_STEPS))
    out["swe"] = np.stack([h.numpy()] + [u.numpy() for u in us], 1)
    return out


def run_lanes_rank(rank):
    """One of 4 ranks: exchange_halo_batched against one exchange_halo per
    lane (random lanes, every wire mode it serves), then the batched
    advances on 2 rows of 1×2 ("rows") and 1 row of 2×2 ("square").
    Returns the checks and, per layout, this rank's lanes, their global
    indices and its shard's slices."""
    from rocm_mpi_tpu_torch.parallel import halo, mesh

    torch.set_num_threads(1)
    checks = []
    for batch_dims, space_dims in LAYOUTS.values():
        bg = mesh.init_batched_grid(4, *SHAPE, space_dims=space_dims, batch_dims=batch_dims)
        rng = np.random.default_rng(rank)
        ub = torch.from_numpy(rng.random(bg.local_shape))
        for wm in ("f32", "bf16"):
            got = halo.exchange_halo_batched(ub, bg, width=2, wire_mode=wm)
            for j in range(ub.shape[0]):
                want = halo.exchange_halo(ub[j].contiguous(), bg.space, width=2, wire_mode=wm)
                checks.append(bool(torch.equal(got[j], want)))
            faces = halo.exchange_faces_batched(ub, bg, wire_mode=wm)
            for j in range(ub.shape[0]):
                one = halo.exchange_faces(ub[j].contiguous(), bg.space, wire_mode=wm)
                checks.append(all((a is None and b is None) or torch.equal(a[j], b)
                                  for a, b in zip(faces, one)))
    res = {"exchange": checks}
    for name, (batch_dims, space_dims) in LAYOUTS.items():
        bg = mesh.init_batched_grid(4, *SHAPE, space_dims=space_dims, batch_dims=batch_dims)
        res[name] = {"lanes": list(bg.lane_range()), "slices": bg.space.shard_slices(),
                     "fields": _lanes_of(bg, _models(bg.space))}
    return res


def one_rank_lanes():
    """{variant: [lane 0 … 3 full fields]} of the same runs on one rank."""
    from rocm_mpi_tpu_torch.parallel import mesh

    bg = mesh.init_batched_grid(4, *SHAPE, space_dims=(1, 1), nprocs=1, rank=0)
    return {k: list(v) for k, v in _lanes_of(bg, _models(bg.space)).items()}


def gather_lanes(results):
    """{layout: {variant: [full lane fields]}} assembled from every
    rank's blocks."""
    out = {}
    for name in LAYOUTS:
        fields = {}
        for res in results:
            part = res[name]
            for variant, block in part["fields"].items():
                full = fields.setdefault(variant, [None] * 4)
                for i, j in enumerate(part["lanes"]):
                    lane = block[i]
                    if full[j] is None:
                        full[j] = np.zeros(lane.shape[:lane.ndim - 2] + SHAPE, lane.dtype)
                    full[j][(Ellipsis,) + tuple(part["slices"])] = lane
        out[name] = fields
    return out


def serve_trace(tag: str):
    from rocm_mpi_tpu_torch.serving.queue import Request

    mix = [("diffusion", (16, 16), 5), ("diffusion", (16, 16), 7),
           ("diffusion", (24, 24), 6), ("wave", (16, 16), 5),
           ("diffusion", (16, 16), 3), ("wave", (16, 16), 6)]
    return [Request(request_id=f"{tag}-{i:03d}", workload=wl, global_shape=shape, dtype="f64",
                    nt=nt, ic_scale=1.0 + 0.05 * i)
            for i, (wl, shape, nt) in enumerate(mix)]


def run_serve_rank(rank, spec):
    """One rank of the serving drill: every rank serves the SAME trace
    through SimulationService (device CPU, `spec["batch_dims"]` rows,
    results fetched); a repeat trace must build nothing. Returns the
    report's programs, compiles and counts, and this rank's lane shards
    keyed by request id with the shard's slices."""
    from rocm_mpi_tpu_torch.serving.bins import bin_key
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
    from rocm_mpi_tpu_torch.telemetry import compiles

    torch.set_num_threads(1)
    compiles.install()
    svc = SimulationService(config=ServeConfig(max_width=4, device="cpu", fetch_results=True,
                                               batch_dims=spec["batch_dims"]))
    tickets = [svc.queue.submit(r) for r in serve_trace("a")]
    report = svc._drain_all()
    before = compiles.snapshot()["totals"]["backend_compiles"]
    again = svc.run_trace(serve_trace("b"))
    after = compiles.snapshot()["totals"]["backend_compiles"]
    shards = {}
    for t in tickets:
        got = t.result(timeout=5)
        if got is not None:
            space = svc._model_for(bin_key(t.request)).grid
            shards[t.request.request_id] = (space.shard_slices(), [np.asarray(x) for x in got])
    return {"programs": report.programs, "served": report.served, "failed": report.failed,
            "steady": (report.compiles["steady_state"], again.compiles["steady_state"]),
            "rebuilt": after - before, "wall_slo": svc.queue.wall_slo, "shards": shards}


def run_nan_rank(rank):
    """One rank of the depth-2 verdict drill: 16 requests of one bin at
    max_width 8 (two batches of one program back to back), an odd step
    count (each batch's result is the program's spare buffer, which the
    second batch overwrites), lane-nan on the second batch's 12th
    request. Returns {request id: (state, retries)}."""
    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.serving.queue import Request
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService

    torch.set_num_threads(1)
    faults.install("lane-nan@request=12")
    svc = SimulationService(config=ServeConfig(max_width=8, device="cpu", fetch_results=True,
                                               pipeline_depth=2))
    tickets = [svc.queue.submit(Request(request_id=f"n-{i:02d}", workload="diffusion",
                                        global_shape=SHAPE, dtype="f64", nt=3,
                                        ic_scale=1.0 + 0.05 * i))
               for i in range(16)]
    svc._drain_all()
    return {t.request.request_id: (t.state, t.retries) for t in tickets}


def run_fleet_rank(rank, spec):
    """One rank of the two-rank fleet smoke: every rank runs the SAME
    two-replica router over the SAME trace (routing is a pure fold, so the
    replicas' batched collectives line up on every rank). `spec["fault"]`
    installs a fault plan, `spec["deadline"]` stamps request 0 with an
    already-hopeless TTL (expired by rank 0's clock on every rank). Returns
    the replica map, the journal's records, each ticket's state and the
    dead replicas."""
    import json
    import tempfile

    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.serving import journal as fleet_journal
    from rocm_mpi_tpu_torch.serving.router import FleetRouter
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService

    torch.set_num_threads(1)
    faults.install(spec.get("fault"))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/fleet-journal.jsonl"
        journal = fleet_journal.TicketJournal(path)
        router = FleetRouter(
            lambda rid: SimulationService(config=ServeConfig(max_width=4, device="cpu")), 2,
            journal=journal)
        trace = serve_trace("fleet")
        if spec.get("deadline"):
            import dataclasses

            trace[0] = dataclasses.replace(trace[0], deadline_s=1e-9)
        tickets = [router.submit(r) for r in trace]
        router.drive()
        out = {"map": router.replica_map(),
               "states": {t.request.request_id: t.state for t in tickets},
               "accounting": router.check_accounting(), "merged": router.merged_counters(),
               "dead": [r.id for r in router.replicas if not r.alive]}
        journal.close()
        out["records"] = [json.loads(line) for line in open(path, encoding="utf-8")]
    faults.install(None)
    return out
