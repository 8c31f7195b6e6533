"""The tuning traffic gate — counterpart of rocm_mpi_tpu/tuning/gate.py: a
"fast" config that blows the A_eff byte budget is rejected, whatever it
measured.

A timing on a loaded host can crown a winner whose speed is an artifact
while its program moves more bytes a step than the schedule needs. The
tuned knobs change traffic analytically, so the gate models each
config's bytes a step in closed form against the (2+1)-traversal ideal
and holds the ratio to a per-family budget. No card and no build: the
validate CLI runs it over a cache file from the keys alone.

Budgets (modeled/ideal ceilings per family), the JAX package's:

* vmem_loop 1.5 — pad_pow2 inflates every pass by (prod padded)/(prod
  shape): 252²→256² is 1.03×; a doctored 140²→256² (3.3×) fails.
* masked_step 1.5 — the port kernel's model (csrc/stencil.cu): a warp
  walking r rows reads T's rows (r+2)/r times over, Cm once, and writes
  out once, so the ratio is (2 + (r+2)/r)/3: r = 1 models 1.67 and is
  rejected (as the JAX gate rejects tm = 8); r = 2 models 1.33, r = 4
  1.17.
* deep 6.0 — per sweep analytic (perf/traffic.ideal_deep_sweep_bytes)
  against k·(2+1)·N: deep sweeps pay padded-block passes.
* scan 1.05 — the scan chunk moves no bytes.

A `wire_mode` field is gated twice: its wire bytes against the ladder
row (parallel/wire.DEFAULT_LADDER, the port's copy of the JAX package's
committed ladder), then the mode against the f64 host-staged oracle
(parallel/wire.certify).
"""

from __future__ import annotations

from typing import NamedTuple

from rocm_mpi_tpu_torch.tuning import space as _space
from rocm_mpi_tpu_torch.tuning.keys import TuningKey, parse_dims

BUDGETS = {
    "vmem_loop": 1.5,
    "masked_step": 1.5,
    "deep": 6.0,
    "scan": 1.05,
}


class GateResult(NamedTuple):
    ok: bool
    ratio: float
    measured_bytes: int  # modeled bytes per step (per shard)
    ideal_bytes: int  # (2+1)-traversal bound per step
    budget: float
    reason: str  # "" when ok


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _positive_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def _validate_wire_mode(family: str, shape, config: dict, budget: float,
                        ideal: int) -> GateResult | None:
    """The double gate on a config's `wire_mode` (None: no wire field or
    the full-precision wire, nothing to reject)."""
    wm = config.get("wire_mode")
    if wm is None:
        return None
    from rocm_mpi_tpu_torch.parallel import wire as _wire

    def bad(reason):
        return GateResult(False, float("inf"), 0, ideal, budget, reason)

    if wm not in _wire.WIRE_MODES:
        return bad(f"wire_mode={wm!r} is not one of {_wire.WIRE_MODES}")
    if family not in ("deep", "scan"):
        return bad(
            f"wire_mode is not a knob for op family {family!r} (the "
            "exchangeful families are deep/scan)"
        )
    if _wire.is_stateful(wm) and family != "deep":
        return bad(
            f"wire_mode={wm!r} carries error-feedback state; only the "
            "deep-halo schedule threads it (per-step programs are "
            "stateless)"
        )
    if wm == "f32":
        return None
    width = int(config.get("k", 1) or 1) if family == "deep" else 1
    frac = _wire.ladder_fraction(shape, width, wm)
    row = _wire.DEFAULT_LADDER.get(wm)
    if row is not None and frac > row:
        return bad(
            f"wire_mode={wm} models {frac:.3f} of the full-precision "
            f"wire vs its ladder row {row:.2f} (parallel/wire.DEFAULT_LADDER) — "
            "over the wire-bytes ladder, rejected"
        )
    cert = _wire.certify(wm)
    if not cert.ok:
        return bad(
            f"wire_mode={wm} fails the tolerance contract vs the f64 "
            f"host-staged oracle (rel err {cert.rel_err:.2e} > bound "
            f"{cert.bound:.2e} over {cert.steps} steps) — fast-but-"
            "out-of-tolerance, rejected"
        )
    return None


def validate_config(op: str, shape, dtype: str, config: dict,
                    budget: float | None = None) -> GateResult:
    """Model one config's bytes a step at per-shard `shape` and storage
    dtype name `dtype` against the A_eff ideal, and gate the ratio."""
    family = op.split(".", 1)[1] if "." in op else op
    if budget is None:
        budget = BUDGETS[family]
    shape = tuple(int(n) for n in shape)
    itemsize = _space.compute_itemsize(dtype)
    n = _prod(shape) * itemsize
    ideal = 3 * n  # the (2+1)-traversal bound per step

    def bad(reason):
        return GateResult(False, float("inf"), 0, ideal, budget, reason)

    wire_verdict = _validate_wire_mode(family, shape, config, budget, ideal)
    if wire_verdict is not None:
        return wire_verdict

    if family == "vmem_loop":
        # Knob validity is the gate's loud half of what resolve's
        # sanitizer drops silently: an entry whose knobs would never steer
        # anything is a broken entry.
        c = config.get("chunk")
        if c is not None and not (_positive_int(c) and c >= 4 and (c & (c - 1)) == 0):
            return bad(f"chunk={c!r} is not a power of two >= 4 "
                       "(below 4 the kernel switches body form)")
        bf = config.get("body_form")
        if bf is not None and bf not in ("eqc", "conly"):
            return bad(f"body_form={bf!r} is not eqc/conly")
        if not isinstance(config.get("pad_pow2", False), bool):
            return bad("pad_pow2 is not a bool")
        # Per chunk launch: read state (+coefficients), write state, each
        # pass over the padded layout when pad_pow2 is on.
        if config.get("pad_pow2"):
            np_ = _prod(_space.next_pow2_shape(shape)) * itemsize
        else:
            np_ = n
        measured = 3 * np_
    elif family == "masked_step":
        r = config.get("run_rows")
        if not _positive_int(r):
            return bad(f"run_rows={r!r} is not a positive int")
        # Per step: T's rows read (r+2)/r times over, Cm read, out written.
        measured = int(n * (r + 2) / r) + 2 * n
    elif family == "deep":
        from rocm_mpi_tpu_torch.perf.traffic import ideal_deep_sweep_bytes

        k = int(config.get("k", 0) or 0)
        if k < 1 or k > min(shape):
            return bad(f"k={config.get('k')!r} outside [1, {min(shape)}]")
        measured = ideal_deep_sweep_bytes(shape, itemsize, k) // k
    elif family == "scan":
        measured = 3 * n
    else:
        return bad(f"no traffic model for op {op!r}")

    ratio = measured / ideal
    ok = ratio <= budget
    reason = "" if ok else (
        f"{op} config {config} models {ratio:.2f}x the A_eff ideal "
        f"(budget {budget:.2f}) — fast-but-wasteful, rejected"
    )
    return GateResult(ok, ratio, int(measured), int(ideal), budget, reason)


def validate_entry(key: TuningKey, entry: dict) -> GateResult:
    """Gate one cache entry from its key alone."""
    return validate_config(
        key.op, parse_dims(key.shape_class), key.dtype, entry.get("config", {}),
    )
