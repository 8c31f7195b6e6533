"""The autotuner's search driver — counterpart of
rocm_mpi_tpu/tuning/search.py: measure the legal space, gate the winner,
persist it.

Per tuning key the search enumerates the admitted candidates
(tuning/space.py) and **gates each through the traffic model first**
(tuning/gate.py: closed form and free, where a measurement costs builds,
captures and card time): a config over its byte budget is never timed.
The others are measured by the port's models at `dims=(1,)*ndim` on the
device the search runs on, each timed by its own `RunResult.wtime_it`
(warmup excluded; the warmup captures the CUDA graphs), the median of
`repeats` runs. The build and capture wall (telemetry/compiles.py
snapshot) is attributed apart as `compile_s`. The fastest admitted
candidate persists into the cache (tuning/cache.py) with the torch and
backend fingerprint of the measuring process; a tie goes to the earlier
candidate.

Measurable ops, the JAX package's: the three VMEM-resident loops and the
diffusion deep-halo depth. The masked_step run length and the scan
chunks are consumable (resolve) and validatable (gate); chip_smoke.py
times masked_step's run lengths directly.
"""

from __future__ import annotations

import statistics

from rocm_mpi_tpu_torch.tuning import cache as _cache
from rocm_mpi_tpu_torch.tuning import gate as _gate
from rocm_mpi_tpu_torch.tuning import space as _space
from rocm_mpi_tpu_torch.tuning.keys import fingerprint, tuning_key

MEASURABLE_OPS = (
    "diffusion.vmem_loop",
    "wave.vmem_loop",
    "swe.vmem_loop",
    "diffusion.deep",
)


def _compile_wall_s() -> float:
    from rocm_mpi_tpu_torch.telemetry import compiles

    return sum(row["wall_s"] for row in compiles.snapshot()["programs"].values())


def _make_runner(op: str, shape, dtype: str, device):
    """run(config) -> seconds a step of one candidate run (warmup excluded,
    the models' own protocol). Each run's windows are sized off the
    candidate (its chunk or k divides both), so a 256-chunk candidate is
    measured as a 256-chunk loop."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    ndim = len(shape)
    common = dict(global_shape=tuple(shape), lengths=(10.0,) * ndim, dtype=dtype,
                  dims=(1,) * ndim)

    if op == "diffusion.vmem_loop":

        def run(config):
            c = int(config["chunk"])
            model = HeatDiffusion(DiffusionConfig(nt=2 * c, warmup=c, **common), device=device)
            return model.run_vmem_resident(chunk=c, body_form=config["body_form"],
                                           pad_pow2=config["pad_pow2"]).wtime_it

    elif op == "wave.vmem_loop":

        def run(config):
            c = int(config["chunk"])
            model = AcousticWave(WaveConfig(nt=2 * c, warmup=c, **common), device=device)
            return model.run_vmem_resident(chunk=c).wtime_it

    elif op == "swe.vmem_loop":

        def run(config):
            c = int(config["chunk"])
            model = ShallowWater(SWEConfig(nt=2 * c, warmup=c, **common), device=device)
            return model.run_vmem_resident(chunk=c).wtime_it

    elif op == "diffusion.deep":

        def run(config):
            k = int(config["k"])
            model = HeatDiffusion(DiffusionConfig(nt=2 * k, warmup=k, **common), device=device)
            # A candidate IS its (k, wire_mode) pair: a bf16 candidate is
            # measured through the bf16 exchange.
            return model.run_deep(block_steps=k, wire_mode=config.get("wire_mode")).wtime_it

    else:
        raise ValueError(
            f"op {op!r} has no single-process measurement runner "
            f"(measurable: {MEASURABLE_OPS})"
        )
    return run


def search_op(op: str, shape, dtype: str = "f32", repeats: int = 3, cache_path=None,
              force: bool = False, log=None, candidates=None, device=None) -> dict:
    """Search one key on `device` (None: the card; "cpu" runs the plain
    versions); returns a status dict:

        {"key": TuningKey, "status": "hit"|"empty"|"tuned"|"all-rejected",
         "entry": {...} | None, "rejected": [(config, reason), ...],
         "measured": [(config, median_s, compile_s), ...]}

    "hit": a fingerprint-valid entry already exists, and nothing is
    measured (the warm-cache contract); `force` measures anyway.
    """
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.telemetry import compiles
    from rocm_mpi_tpu_torch.utils.backend import resolve_device

    log = log or (lambda *_: None)
    device = resolve_device(device)  # raises when the card is asked for and absent
    key = tuning_key(op, shape, dtype, backend=device)
    path = cache_path or _cache.default_cache_path()
    if not force:
        existing = _cache.lookup(_cache.load(path), key, fingerprint(key.backend))
        if existing is not None:
            log(f"tune: {op} {key.shape_class} {key.dtype} — cache hit, config {existing}")
            return {"key": key, "status": "hit", "entry": {"config": existing},
                    "rejected": [], "measured": []}

    if candidates is None:
        candidates = _space.enumerate_space(op, shape, dtype, backend=key.backend)
    if not candidates:
        log(f"tune: {op} {key.shape_class} — nothing tunable (empty admitted space)")
        return {"key": key, "status": "empty", "entry": None, "rejected": [],
                "measured": []}

    # Gate first: a config the gate refuses is never worth timing. Each
    # rejection is logged and annotated.
    rejected = []
    admitted = []  # (index, config, GateResult)
    for i, config in enumerate(candidates):
        g = _gate.validate_config(op, shape, dtype, config)
        if g.ok:
            admitted.append((i, config, g))
            continue
        rejected.append((config, g.reason))
        log(f"tune: {op} REJECTED {config}: {g.reason}")
        if telemetry.enabled():
            telemetry.annotate("tune.gate_reject", op=op, config=str(sorted(config.items())),
                               ratio=round(g.ratio, 4))
    if not admitted:
        log(f"tune: {op} — every candidate over the traffic budget; nothing cached")
        return {"key": key, "status": "all-rejected", "entry": None, "rejected": rejected,
                "measured": []}

    compiles.install()
    run = _make_runner(op, shape, dtype, device)
    measured = []  # (median_s, index, config, compile_s, gate)
    for i, config, g in admitted:
        wall0 = _compile_wall_s()
        with telemetry.span("tune.measure", op=op, candidate=i):
            times = [run(config) for _ in range(max(1, repeats))]
        compile_s = _compile_wall_s() - wall0
        med = statistics.median(times)
        measured.append((med, i, config, compile_s, g))
        log(f"tune: {op} {config}: {med * 1e6:.3f} us/step "
            f"(median of {max(1, repeats)}, compile {compile_s:.1f} s)")

    med, _i, config, compile_s, g = min(measured, key=lambda t: (t[0], t[1]))
    entry = {
        "config": config,
        "median_us": round(med * 1e6, 4),
        "compile_s": round(compile_s, 3),
        "gate_ratio": round(g.ratio, 4),
        "fingerprint": fingerprint(key.backend),
    }
    _cache.store(path, key, entry)
    log(f"tune: {op} winner {config} ({med * 1e6:.3f} us/step, gate {g.ratio:.2f}x) -> {path}")
    return {"key": key, "status": "tuned", "entry": entry, "rejected": rejected,
            "measured": [(c, m, cs) for m, _, c, cs, _ in measured]}
