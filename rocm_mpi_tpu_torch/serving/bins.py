"""The bin scheduler: pack heterogeneous requests onto shared compiled
(The port's copy of rocm_mpi_tpu/serving/bins.py: the same records, byte
for byte, and no import of the JAX package.)
programs (docs/SERVING.md "Bins").

Since the persistent compile cache is unsound on this stack, bin-packed
program reuse is the ONLY compile amortizer: a compiled batched advance
is specialized on everything in the `BinKey` — workload, exact space
shape class, dtype, physics constants, step variant, wire mode — plus
the lane width W. Requests that agree on the key share programs;
heterogeneity INSIDE a bin rides traced data instead of trace identity:

  * per-lane step counts — the batch executes max(nt_i) steps and each
    lane freezes bitwise at its own count (`lane_steps`, a traced
    operand; models.*.batched_advance_fn), so mixed step counts never
    split a program. The `steps_bucket` key field (next power of two)
    only bounds the WASTE of that padding — lanes in one bucket differ
    by at most 2× in length;
  * lane-width padding — arrivals rarely match a power-of-two width, so
    `plan_batches` packs pending requests into pow2 widths and pads the
    tail batch with idle lanes (steps 0: frozen from step 0, pure
    machine padding). The `occupancy_floor` (perf/budgets.json
    "serving") is the traffic-gate feed: a batch whose idle-lane
    padding would inflate bytes/useful-lane past budget is SPLIT into a
    narrower width class (its own program) instead of shipped padded.

Stdlib-at-import (the schema gate reads the bin-manifest format without
torch). Everything here is deterministic — in a multi-controller service
every rank must plan the identical batches, or the batched collectives
diverge (graftlint GL08's whole hazard class).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from rocm_mpi_tpu_torch.serving.queue import Request

BIN_MANIFEST_SCHEMA = "rmt-bin-manifest"
BIN_MANIFEST_VERSION = 1

DEFAULT_MAX_WIDTH = 8
DEFAULT_OCCUPANCY_FLOOR = 0.5
# The shape-padding ladder (docs/SERVING.md "Continuous batching"):
# rung quantum = pow2_floor(n) / LADDER_QUANTUM_FRACTION per axis (min
# LADDER_MIN_QUANTUM cells), so rungs get coarser as shapes grow — the
# space edition of steps_bucket's pow2 coarsening, but with a bounded
# per-axis inflation of at most one quantum. The committed FLOPs bound
# lives in perf/budgets.json "serving"/"padded_flops_tolerance".
LADDER_QUANTUM_FRACTION = 4
LADDER_MIN_QUANTUM = 4
DEFAULT_LADDER_TOLERANCE = 0.25


def steps_bucket(nt: int) -> int:
    """Canonical step bucket: the next power of two >= nt. Lanes in one
    bucket differ by at most 2x in length, bounding the padded-steps
    waste of the batch's max(nt) execution."""
    if nt < 1:
        raise ValueError(f"nt must be >= 1, got {nt}")
    b = 1
    while b < nt:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True, order=True)
class BinKey:
    """Compile identity of a batched program, minus the lane width
    (docs/SERVING.md has the field table). `key_str` round-trips
    through `parse` — the spelling the manifest and telemetry use."""

    workload: str
    shape: tuple[int, ...]
    dtype: str
    physics: tuple[tuple[str, float], ...]
    variant: str
    wire_mode: str
    steps_bucket: int

    def key_str(self) -> str:
        shape = "x".join(str(n) for n in self.shape)
        phys = ",".join(f"{k}={v!r}" for k, v in self.physics) or "-"
        return (
            f"{self.workload}|{shape}|{self.dtype}|{phys}|"
            f"{self.variant}|{self.wire_mode}|{self.steps_bucket}"
        )

    @classmethod
    def parse(cls, s: str) -> "BinKey":
        parts = s.split("|")
        if len(parts) != 7:
            raise ValueError(f"bad bin key {s!r} (want 7 '|' fields)")
        wl, shape_s, dtype, phys_s, variant, wire, bucket = parts
        shape = tuple(int(n) for n in shape_s.split("x"))
        phys: tuple = ()
        if phys_s != "-":
            pairs = []
            for item in phys_s.split(","):
                k, _, v = item.partition("=")
                if not _ or not k:
                    raise ValueError(f"bad physics field {item!r} in {s!r}")
                pairs.append((k, float(v)))
            phys = tuple(pairs)
        return cls(
            workload=wl, shape=shape, dtype=dtype, physics=phys,
            variant=variant, wire_mode=wire, steps_bucket=int(bucket),
        )


def bin_key(req: Request,
            ladder_tolerance: float | None = None) -> BinKey:
    """The request's bin: every trace-identity field, physics sorted so
    spelling order can't split a bin. With `ladder_tolerance` set, the
    shape field is laddered up a rung (`ladder_shape`) so near-rung
    shape classes MERGE into one program class — the caller (the
    service) decides eligibility; this stays the pure shape mapper."""
    key = BinKey(
        workload=req.workload,
        shape=tuple(req.global_shape),
        dtype=req.dtype,
        physics=tuple(sorted(req.physics)),
        variant=req.variant,
        wire_mode=req.wire_mode,
        steps_bucket=steps_bucket(req.nt),
    )
    if ladder_tolerance is not None:
        padded = ladder_shape(key.shape, ladder_tolerance)
        if padded != key.shape:
            key = dataclasses.replace(key, shape=padded)
    return key


def ladder_rung(n: int) -> int:
    """The smallest ladder rung >= n: the next multiple of the rung
    quantum `max(LADDER_MIN_QUANTUM, pow2_floor(n) //
    LADDER_QUANTUM_FRACTION)`. Like `steps_bucket`, rungs coarsen with
    size, but the per-axis inflation is bounded by ONE quantum (at most
    ~1/LADDER_QUANTUM_FRACTION of the axis), so the FLOPs cost of a
    merge stays small enough for the tolerance gate to accept most of
    the traffic it consolidates."""
    if n < 1:
        raise ValueError(f"axis size must be >= 1, got {n}")
    q = max(LADDER_MIN_QUANTUM, pow2_floor(n) // LADDER_QUANTUM_FRACTION)
    return ((n + q - 1) // q) * q


def ladder_inflation(shape, padded) -> float:
    """Fractional padded-FLOPs cost of serving `shape` embedded in
    `padded`: cells(padded)/cells(shape) - 1 (a per-step stencil's work
    is proportional to cells)."""
    orig = 1
    pad = 1
    for a, b in zip(shape, padded):
        orig *= int(a)
        pad *= int(b)
    return pad / orig - 1.0


def ladder_shape(shape, tolerance: float = DEFAULT_LADDER_TOLERANCE,
                 ) -> tuple[int, ...]:
    """Pad every space axis up to its ladder rung — IF the total
    padded-FLOPs inflation stays within `tolerance`; otherwise return
    the shape unchanged (the bin keeps its exact shape class: the
    split-instead-of-pad rule, the shape edition of the occupancy
    floor's split). Deterministic — every controller maps a shape to
    the same rung."""
    if tolerance < 0.0:
        raise ValueError(
            f"padded_flops_tolerance must be >= 0, got {tolerance}"
        )
    padded = tuple(ladder_rung(int(n)) for n in shape)
    if padded == tuple(int(n) for n in shape):
        return tuple(int(n) for n in shape)
    if ladder_inflation(shape, padded) > tolerance:
        return tuple(int(n) for n in shape)
    return padded


def pow2_width(n: int, max_width: int) -> int:
    """Smallest power of two >= n, capped at max_width."""
    w = 1
    while w < n and w < max_width:
        w *= 2
    return min(w, max_width)


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1) — the shared rounding the
    width planner and the service's grow target both use."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_batches(n_pending: int, max_width: int = DEFAULT_MAX_WIDTH,
                 occupancy_floor: float = DEFAULT_OCCUPANCY_FLOOR,
                 ) -> list[int]:
    """Deterministic width plan for `n_pending` same-key requests: a
    list of batch widths (each a power of two <= max_width) covering all
    requests in FIFO order. Greedy: take the widest batch whose
    occupancy (live/width) clears the floor; the split rule is built in
    — a remainder that would ride a wide batch under-occupied gets a
    narrower width class of its own (its own program) instead
    (docs/SERVING.md "Padding policy")."""
    if max_width < 1:
        raise ValueError(f"max_width must be >= 1, got {max_width}")
    if not 0.0 < occupancy_floor <= 1.0:
        raise ValueError(
            f"occupancy_floor must be in (0, 1], got {occupancy_floor}"
        )
    cap = pow2_floor(max_width)
    out: list[int] = []
    n = int(n_pending)
    while n > 0:
        # The narrowest pow2 covering what's left (programs are the
        # scarce resource — one wide batch beats two narrow ones), then
        # the split rule: shrink while the batch would ride under the
        # occupancy floor.
        w = pow2_width(n, cap)
        while w > 1 and (min(n, w) / w) < occupancy_floor:
            w //= 2
        out.append(w)
        n -= min(n, w)
    return out


@dataclasses.dataclass
class BinStats:
    """One bin's serving accounting (the occupancy / padding-waste
    gauges, docs/TELEMETRY.md "Serving"). `lanes` counts compiled lane
    slots across executed batches; `live_lanes` the slots that carried a
    request; `useful_steps` the sum of per-lane requested steps;
    `machine_steps` width x executed-steps summed over batches — the
    denominator padding waste is measured against."""

    key: BinKey
    requests: int = 0
    batches: int = 0
    widths: tuple[int, ...] = ()
    lanes: int = 0
    live_lanes: int = 0
    useful_steps: int = 0
    machine_steps: int = 0
    splits: int = 0
    # Continuous-drain extras (docs/SERVING.md "Continuous batching"):
    # lanes swapped in at segment boundaries, segments executed, and the
    # ladder's cell accounting — cells are steps-weighted so a short
    # laddered lane can't dominate the waste of a long exact one.
    swaps_in: int = 0
    segments: int = 0
    cells_useful: int = 0
    cells_machine: int = 0

    @property
    def occupancy(self) -> float:
        return self.live_lanes / self.lanes if self.lanes else 0.0

    @property
    def padding_waste(self) -> float:
        """1 − useful/machine steps: the fraction of executed lane-steps
        that served no request (idle lanes + frozen tail steps)."""
        if not self.machine_steps:
            return 0.0
        return 1.0 - self.useful_steps / self.machine_steps

    @property
    def ladder_waste(self) -> float:
        """1 − useful/machine CELLS (steps-weighted): the fraction of
        executed stencil work spent on ladder shape padding. Distinct
        from `padding_waste`, which counts idle-lane and frozen-tail
        STEP padding — a bin can have ladder waste with zero width
        waste and vice versa."""
        if not self.cells_machine:
            return 0.0
        return 1.0 - self.cells_useful / self.cells_machine

    def _note_cells(self, lane_nts, lane_cells) -> None:
        for nt, (orig_cells, padded_cells) in zip(lane_nts, lane_cells):
            self.cells_useful += int(orig_cells) * int(nt)
            self.cells_machine += int(padded_cells) * int(nt)

    def note_batch(self, width: int, lane_nts: list[int],
                   executed_steps: int, split: bool = False,
                   lane_cells: list[tuple[int, int]] | None = None,
                   ) -> None:
        self.batches += 1
        self.widths = tuple(sorted(set(self.widths) | {width}))
        self.lanes += width
        self.live_lanes += len(lane_nts)
        self.requests += len(lane_nts)
        self.useful_steps += sum(lane_nts)
        self.machine_steps += width * executed_steps
        if split:
            self.splits += 1
        if lane_cells is not None:
            self._note_cells(lane_nts, lane_cells)

    def note_continuous(self, width: int, lane_nts: list[int],
                        executed_steps: int, swaps_in: int,
                        segments: int, split: bool = False,
                        lane_cells: list[tuple[int, int]] | None = None,
                        ) -> None:
        """Accounting for one segmented (continuous) batch: `lane_nts`
        lists every tenant that rode the batch — possibly MORE than
        `width`, since slots are re-seated at segment boundaries — so
        slot occupancy caps `live_lanes` at the compiled width (the
        manifest bounds occupancy to [0, 1]); the machine denominator
        is still width x executed machine steps."""
        self.batches += 1
        self.widths = tuple(sorted(set(self.widths) | {width}))
        self.lanes += width
        self.live_lanes += min(len(lane_nts), width)
        self.requests += len(lane_nts)
        self.useful_steps += sum(lane_nts)
        self.machine_steps += width * executed_steps
        self.swaps_in += int(swaps_in)
        self.segments += int(segments)
        if split:
            self.splits += 1
        if lane_cells is not None:
            self._note_cells(lane_nts, lane_cells)


def manifest_doc(stats: dict, programs: list[str],
                 queue_counters: dict | None = None,
                 extra: dict | None = None) -> dict:
    """The bin manifest (`serve-manifest.json`, schema-checked by
    `telemetry regress --check-schema`): one row per bin with its
    occupancy/padding-waste accounting, plus the compiled program
    classes — `len(programs)` IS the trace's compile count under the
    steady-state contract."""
    rows = []
    for key, st in sorted(stats.items(), key=lambda kv: kv[0]):
        row = {
            "key": key.key_str() if isinstance(key, BinKey) else str(key),
            "requests": st.requests,
            "batches": st.batches,
            "widths": list(st.widths),
            "occupancy": round(st.occupancy, 4),
            "padding_waste": round(st.padding_waste, 4),
            "splits": st.splits,
        }
        if st.swaps_in or st.segments:
            row["swaps_in"] = st.swaps_in
            row["segments"] = st.segments
        if st.cells_machine:
            row["ladder_waste"] = round(st.ladder_waste, 4)
        rows.append(row)
    doc = {
        "schema": BIN_MANIFEST_SCHEMA,
        "v": BIN_MANIFEST_VERSION,
        # Record wall STAMP (the `t` field every telemetry record
        # carries), not an interval measurement — nothing to sync.
        # graftlint: disable-next=GL06
        "t": time.time(),
        "bins": rows,
        "programs": sorted(programs),
    }
    if queue_counters:
        doc["queue"] = dict(queue_counters)
    if extra:
        doc.update(extra)
    return doc


def validate_manifest_doc(doc: dict) -> list[str]:
    """Problem strings for a bin manifest (stdlib; shared with
    telemetry.regress --check-schema)."""
    problems: list[str] = []
    if doc.get("schema") != BIN_MANIFEST_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {BIN_MANIFEST_SCHEMA}"
        )
    if not isinstance(doc.get("v"), int):
        problems.append("missing int v")
    bins = doc.get("bins")
    if not isinstance(bins, list):
        return problems + ["missing bins list"]
    for i, row in enumerate(bins):
        if not isinstance(row, dict):
            problems.append(f"bins[{i}] not an object")
            continue
        key = row.get("key")
        if not isinstance(key, str):
            problems.append(f"bins[{i}] missing key")
        else:
            try:
                BinKey.parse(key)
            except ValueError as e:
                problems.append(f"bins[{i}].key: {e}")
        for field in ("requests", "batches"):
            if not isinstance(row.get(field), int) or row.get(field) < 0:
                problems.append(f"bins[{i}].{field} not a count")
        for field in ("occupancy", "padding_waste"):
            v = row.get(field)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not 0.0 <= v <= 1.0:
                problems.append(f"bins[{i}].{field} outside [0, 1]")
        # Continuous/ladder row extras are optional (archived manifests
        # predate them) but must be well-formed when present.
        for field in ("swaps_in", "segments"):
            v = row.get(field)
            if v is not None and (
                not isinstance(v, int) or isinstance(v, bool) or v < 0
            ):
                problems.append(f"bins[{i}].{field} not a count")
        lw = row.get("ladder_waste")
        if lw is not None and (
            not isinstance(lw, (int, float)) or isinstance(lw, bool)
            or not 0.0 <= lw <= 1.0
        ):
            problems.append(f"bins[{i}].ladder_waste outside [0, 1]")
    progs = doc.get("programs")
    if not isinstance(progs, list) or not all(
        isinstance(p, str) for p in progs
    ):
        problems.append("missing programs list")
    pipe = doc.get("pipeline")
    if pipe is not None and pipe != {}:
        # The drain-pipeline block (docs/SERVING.md "The pipeline"):
        # depth, resolved batches, the device-bubble fraction, and the
        # per-stage host walls — a hand-edited bubble outside [0, 1]
        # or a non-count depth must fail here, not silently corrupt
        # the next pipeline-efficiency audit of an archived manifest.
        if not isinstance(pipe, dict):
            problems.append("'pipeline' block is not an object")
        else:
            depth = pipe.get("depth")
            if not isinstance(depth, int) or isinstance(depth, bool) \
                    or depth < 1:
                problems.append(f"pipeline.depth {depth!r} not >= 1")
            batches = pipe.get("batches")
            if not isinstance(batches, int) or isinstance(batches, bool) \
                    or batches < 0:
                problems.append(
                    f"pipeline.batches {batches!r} not a count"
                )
            bubble = pipe.get("bubble")
            if not isinstance(bubble, (int, float)) \
                    or isinstance(bubble, bool) \
                    or not 0.0 <= bubble <= 1.0:
                problems.append(
                    f"pipeline.bubble {bubble!r} outside [0, 1]"
                )
            for field in ("assemble_s", "dispatch_s", "fetch_s",
                          "resolve_s", "busy_s", "wall_s"):
                v = pipe.get(field)
                if v is not None and (
                    not isinstance(v, (int, float))
                    or isinstance(v, bool) or v < 0
                ):
                    problems.append(
                        f"pipeline.{field} {v!r} not a non-negative "
                        "wall"
                    )
    cont = doc.get("continuous")
    if cont is not None:
        # The continuous-drain block (docs/SERVING.md "Continuous
        # batching"): segment count knob, executed segments, the swap
        # counters, and the step-weighted occupancy the regress gate
        # floors — a doctored occupancy outside [0, 1] or a zero
        # segments knob must fail the schema check.
        if not isinstance(cont, dict):
            problems.append("'continuous' block is not an object")
        else:
            segs = cont.get("segments")
            if not isinstance(segs, int) or isinstance(segs, bool) \
                    or segs < 1:
                problems.append(
                    f"continuous.segments {segs!r} not >= 1"
                )
            for field in ("batches", "segments_run", "swaps_in",
                          "swaps_out"):
                v = cont.get(field)
                if not isinstance(v, int) or isinstance(v, bool) \
                        or v < 0:
                    problems.append(
                        f"continuous.{field} {v!r} not a count"
                    )
            occ = cont.get("occupancy")
            if not isinstance(occ, (int, float)) \
                    or isinstance(occ, bool) or not 0.0 <= occ <= 1.0:
                problems.append(
                    f"continuous.occupancy {occ!r} outside [0, 1]"
                )
    queue = doc.get("queue")
    if queue is not None:
        if not isinstance(queue, dict):
            problems.append("'queue' block is not an object")
        else:
            for field, v in queue.items():
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    problems.append(
                        f"queue.{field} {v!r} is not a count"
                    )
            # The terminal accounting invariant (docs/SERVING.md "SLOs
            # and admission"), enforced on the ARCHIVED manifest too:
            # manifests are written at drain boundaries (nothing in
            # flight), so every submitted ticket must be terminally
            # accounted or still queued — requeued is a cumulative
            # event count, not an outcome, and stays out of the sum.
            terminal = ("completed", "failed", "rejected", "expired",
                        "quarantined", "depth")
            if "submitted" in queue and all(
                isinstance(queue.get(k), int) for k in terminal
            ):
                total = sum(queue[k] for k in terminal)
                if total != queue["submitted"]:
                    problems.append(
                        f"queue counters do not sum to submissions "
                        f"({total} != {queue['submitted']}): every "
                        f"submitted ticket must end done/failed/"
                        f"rejected/expired/quarantined or still queued"
                    )
    return problems


def write_manifest(path, doc: dict) -> None:
    """Atomic tmp+rename write (GL09: this is a schema-versioned
    sidecar; a torn manifest must never be readable)."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
