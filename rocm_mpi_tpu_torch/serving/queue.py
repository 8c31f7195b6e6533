"""The serving request plane: requests, tickets, and the async queue
(The port's copy of rocm_mpi_tpu/serving/queue.py: the same records, byte
for byte, and no import of the JAX package.)
(docs/SERVING.md "Request schema" and "SLOs and admission").

Stdlib-at-import by design: the telemetry schema gate
(`telemetry regress --check-schema`) validates archived request and
quarantine sidecars through `validate_request_record` /
`validate_quarantine_record` without importing torch, exactly as
`parallel/wire.py` keeps its mode registry importable for the read side.

A `Request` is everything needed to reproduce one simulation
standalone — workload, exact space shape, dtype, physics constants,
step count, variant/wire knobs — plus the serving-only fields: a
request id, an IC scale (the per-lane variation knob: lane state is
``ic_scale ×`` the workload's standard initial condition), an
optional `session` id for checkpoint multiplexing (the service saves
the final state under ``sessions/<session>/`` through the PR-6 manifest
machinery; a later request with `resume=True` continues from the latest
valid saved step), and an optional `deadline_s` TTL (v2): a PENDING
ticket older than its deadline fails with `deadline-exceeded` at pop
time instead of occupying a lane — an in-flight lane always finishes
its batch. Everything that affects the COMPILED program is a bin-key
field (serving/bins.py); everything per-lane is traced data.

Admission control (docs/SERVING.md "SLOs and admission"): a
`RequestQueue(max_depth=)` rejects over-depth submits FAST — the
returned ticket is terminally `rejected` with a retry-after hint
derived from the observed batch throughput — never silently dropped.
Terminal accounting is an invariant: every submitted ticket ends in
exactly one of {done, failed, rejected, expired, quarantined}
(`check_accounting`; the service asserts it at drain time).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time

from rocm_mpi_tpu_torch.telemetry import tracing as _tracing

REQUEST_SCHEMA = "rmt-serve-request"
# v2: the optional `deadline_s` TTL joined the schema (v1 records
# without it stay valid — the field is optional by construction).
# v3: the optional `trace` context dict joined (telemetry/tracing.py
# wire shape) so a request's trace survives the journal and a fleet
# re-route; v1/v2 records without it stay valid.
REQUEST_VERSION = 3

QUARANTINE_SCHEMA = "rmt-serve-quarantine"
QUARANTINE_VERSION = 1

WORKLOADS = ("diffusion", "wave", "swe")
REQUEST_DTYPES = ("f32", "f64", "bf16")

# Queued -> running -> one of the TERMINAL_STATES; requeued is the
# non-terminal park (preemption, or a retry-budget requeue) — the
# ticket re-enters the queue and is popped again (docs/SERVING.md
# "Preemption" and "SLOs and admission"). Terminal outcomes:
#   done         served; result available
#   failed       a per-request error (bad physics, bad session) — never
#                retried: the request itself is wrong
#   rejected     admission control said no (queue-full, circuit-open) —
#                the submitter retries later
#   expired      the deadline passed while the ticket was still pending
#   quarantined  the retry budget is exhausted (poison request): the
#                full record is banked to quarantine.jsonl and the
#                ticket is never requeued again
TICKET_STATES = ("queued", "running", "done", "failed", "requeued",
                 "rejected", "expired", "quarantined")
TERMINAL_STATES = ("done", "failed", "rejected", "expired", "quarantined")

# Retry-after fallback when no batch has completed yet (no throughput
# observation to derive a hint from).
DEFAULT_RETRY_AFTER_S = 1.0
# Retry-after ceiling: the backlog÷rate derivation over a sparse or
# long-spanning completion window can extrapolate to near-infinity
# ("come back in 4 hours" is a lie about a queue that drains in
# seconds once live) — every hint is clamped here.
MAX_RETRY_AFTER_S = 60.0
# Throughput-window staleness horizon: completion marks older than
# this say nothing about CURRENT throughput (the post-flood idle
# edge) — a stale window falls back to the default, never
# extrapolates.
RETRY_WINDOW_STALE_S = 60.0


@dataclasses.dataclass(frozen=True)
class Request:
    """One simulation request (docs/SERVING.md has the field table)."""

    request_id: str
    workload: str = "diffusion"
    global_shape: tuple[int, ...] = (64, 64)
    dtype: str = "f32"
    nt: int = 64
    physics: tuple[tuple[str, float], ...] = ()
    variant: str = "shard"
    wire_mode: str = "f32"
    ic_scale: float = 1.0
    session: str | None = None
    resume: bool = False
    deadline_s: float | None = None
    # Request-scoped trace context (telemetry/tracing.py wire shape,
    # v3): None = mint a fresh root at submit; a dict = the request is
    # continuing an existing trace (a fleet re-route carries the dead
    # hop's context forward with hop+1).
    trace: dict | None = None

    def __post_init__(self):
        if not self.request_id or not isinstance(self.request_id, str):
            raise ValueError("request_id must be a non-empty string")
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"workload must be one of {WORKLOADS}, got {self.workload!r}"
            )
        shape = tuple(int(n) for n in self.global_shape)
        if len(shape) < 1 or any(n < 4 for n in shape):
            raise ValueError(
                f"global_shape must have every axis >= 4, got {shape}"
            )
        object.__setattr__(self, "global_shape", shape)
        if self.dtype not in REQUEST_DTYPES:
            raise ValueError(
                f"dtype must be one of {REQUEST_DTYPES}, got {self.dtype!r}"
            )
        if int(self.nt) < 1:
            raise ValueError(f"nt must be >= 1, got {self.nt}")
        object.__setattr__(self, "nt", int(self.nt))
        phys = tuple(
            (str(k), float(v)) for k, v in tuple(self.physics)
        )
        object.__setattr__(self, "physics", phys)
        if self.resume and not self.session:
            raise ValueError("resume=True needs a session id")
        if self.deadline_s is not None:
            d = float(self.deadline_s)
            if not math.isfinite(d) or d <= 0:
                raise ValueError(
                    f"deadline_s must be a finite positive number of "
                    f"seconds, got {self.deadline_s!r}"
                )
            object.__setattr__(self, "deadline_s", d)
        if self.trace is not None:
            problems = _tracing.validate_wire(self.trace)
            if problems:
                raise ValueError(
                    "bad trace context: " + "; ".join(problems)
                )
            object.__setattr__(self, "trace", dict(self.trace))

    @property
    def physics_dict(self) -> dict:
        return dict(self.physics)


def request_to_record(req: Request) -> dict:
    """The sidecar line (`serve-requests.jsonl`): schema-stamped, every
    field JSON-plain — `telemetry regress --check-schema` validates the
    archived trace with `validate_request_record`."""
    return {
        "schema": REQUEST_SCHEMA,
        "kind": "serve-request",
        "v": REQUEST_VERSION,
        # Record wall STAMP (the `t` field every telemetry record
        # carries), not an interval measurement — nothing to sync.
        # graftlint: disable-next=GL06
        "t": time.time(),
        "request_id": req.request_id,
        "workload": req.workload,
        "global_shape": list(req.global_shape),
        "dtype": req.dtype,
        "nt": req.nt,
        "physics": {k: v for k, v in req.physics},
        "variant": req.variant,
        "wire_mode": req.wire_mode,
        "ic_scale": req.ic_scale,
        "session": req.session,
        "resume": bool(req.resume),
        "deadline_s": req.deadline_s,
        **({"trace": dict(req.trace)} if req.trace is not None else {}),
    }


def request_from_record(doc: dict) -> Request:
    problems = validate_request_record(doc)
    if problems:
        raise ValueError(
            "bad serve-request record: " + "; ".join(problems)
        )
    return Request(
        request_id=doc["request_id"],
        workload=doc["workload"],
        global_shape=tuple(doc["global_shape"]),
        dtype=doc["dtype"],
        nt=doc["nt"],
        physics=tuple(sorted(doc.get("physics", {}).items())),
        variant=doc.get("variant", "shard"),
        wire_mode=doc.get("wire_mode", "f32"),
        ic_scale=float(doc.get("ic_scale", 1.0)),
        session=doc.get("session"),
        resume=bool(doc.get("resume", False)),
        deadline_s=doc.get("deadline_s"),
        trace=doc.get("trace"),
    )


def validate_request_record(doc: dict) -> list[str]:
    """Problem strings for a serve-request sidecar record (stdlib —
    shared with telemetry.regress `--check-schema`)."""
    problems: list[str] = []
    if doc.get("schema") != REQUEST_SCHEMA:
        problems.append(f"schema {doc.get('schema')!r} != {REQUEST_SCHEMA}")
    if not isinstance(doc.get("request_id"), str) or not doc.get("request_id"):
        problems.append("missing request_id")
    if doc.get("workload") not in WORKLOADS:
        problems.append(f"unknown workload {doc.get('workload')!r}")
    shape = doc.get("global_shape")
    if not isinstance(shape, list) or not shape or not all(
        isinstance(n, int) and n >= 4 for n in shape
    ):
        problems.append(f"bad global_shape {shape!r}")
    if doc.get("dtype") not in REQUEST_DTYPES:
        problems.append(f"unknown dtype {doc.get('dtype')!r}")
    nt = doc.get("nt")
    if not isinstance(nt, int) or nt < 1:
        problems.append(f"bad nt {nt!r}")
    phys = doc.get("physics", {})
    if not isinstance(phys, dict) or not all(
        isinstance(k, str) and isinstance(v, (int, float))
        and not isinstance(v, bool) for k, v in phys.items()
    ):
        problems.append("physics must be {name: number}")
    if doc.get("resume") and not doc.get("session"):
        problems.append("resume without a session id")
    ddl = doc.get("deadline_s")
    if ddl is not None and (
        not isinstance(ddl, (int, float)) or isinstance(ddl, bool)
        or not math.isfinite(ddl) or ddl <= 0
    ):
        problems.append(f"bad deadline_s {ddl!r} (want a positive number)")
    if doc.get("trace") is not None:
        problems += _tracing.validate_wire(doc["trace"])
    return problems


def load_trace(path) -> list[Request]:
    """Parse a serve-requests.jsonl trace file into Requests (blank
    lines skipped; a malformed line raises — a trace is an input, not a
    telemetry stream tolerating torn tails)."""
    out: list[Request] = []
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{i}: bad JSON ({e})") from None
            out.append(request_from_record(doc))
    return out


# ---------------------------------------------------------------------------
# Quarantine sidecar (docs/SERVING.md "SLOs and admission")
# ---------------------------------------------------------------------------


def quarantine_record(req: Request, error: str, retries: int) -> dict:
    """One quarantine.jsonl line: the FULL request record rides inside
    so the poison request can be reproduced offline exactly as
    submitted, plus the failure it kept hitting and the retries it
    burned. Schema-checked by `telemetry regress --check-schema`."""
    return {
        "schema": QUARANTINE_SCHEMA,
        "kind": "quarantine",
        "v": QUARANTINE_VERSION,
        # Record wall STAMP (the `t` field every telemetry record
        # carries), not an interval measurement — nothing to sync.
        # graftlint: disable-next=GL06
        "t": time.time(),
        "request_id": req.request_id,
        "error": str(error),
        "retries": int(retries),
        "request": request_to_record(req),
    }


def validate_quarantine_record(doc: dict) -> list[str]:
    """Problem strings for a quarantine.jsonl record (stdlib; shared
    with telemetry.regress --check-schema)."""
    problems: list[str] = []
    if doc.get("schema") != QUARANTINE_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {QUARANTINE_SCHEMA}"
        )
    if not isinstance(doc.get("error"), str) or not doc.get("error"):
        problems.append("quarantine record missing error")
    retries = doc.get("retries")
    if not isinstance(retries, int) or retries < 0:
        problems.append(f"bad retries {retries!r}")
    req = doc.get("request")
    if not isinstance(req, dict):
        problems.append("quarantine record missing the full request")
    else:
        problems += [f"request.{p}" for p in validate_request_record(req)]
    return problems


def append_quarantine(path, doc: dict) -> None:
    """Append one quarantine record. APPEND-ONLY on purpose (GL09's
    other blessed discipline): the sidecar is an incident ledger an
    out-of-process reader may tail while the service is live — every
    complete line is valid, a torn final line is droppable, and nothing
    already banked is ever rewritten."""
    problems = validate_quarantine_record(doc)
    if problems:
        raise ValueError("bad quarantine record: " + "; ".join(problems))
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(doc, sort_keys=True) + "\n")


def load_quarantine(path) -> list[dict]:
    """Read a quarantine.jsonl ledger (torn final line tolerated — it
    is a live-appended telemetry stream, unlike a request trace)."""
    out: list[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail
    return out


# ---------------------------------------------------------------------------
# Tickets
# ---------------------------------------------------------------------------


class Ticket:
    """One queued request's handle: thread-safe state + a waitable
    result. The service resolves it (`_resolve`/`_fail`/...) when the
    request's batch completes; `result(timeout)` blocks the submitter.

    Serving-plane bookkeeping (docs/SERVING.md "SLOs and admission"):
    `ordinal` is the 1-based submission number (the fault grammar's
    `lane-nan@request=N` key), `submitted_mono` anchors the deadline
    and the latency SLO, `retries`/`not_before` drive the bounded
    exponential-backoff retry budget."""

    def __init__(self, request: Request):
        self.request = request
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._state = "queued"
        self._result = None
        self._error: str | None = None
        self.steps_run = 0  # actually-advanced steps (resume-aware)
        self.start_step = 0  # resume start (session restore)
        self.ordinal = 0  # 1-based submission number (queue-assigned)
        self.submitted_mono = time.monotonic()
        self.retries = 0  # batch-level/numerical retry count
        self.not_before = 0.0  # backoff eligibility (monotonic)
        # True while parked by a RETRY requeue (wake=False): the live
        # service still owns the ticket, so result() must keep the
        # submitter waiting — None is the PREEMPTION contract only.
        self._retry_park = False
        # Request-scoped tracing (telemetry/tracing.py): the context
        # this ticket runs under (adopted from Request.trace or minted
        # at submit) and the telescoping latency-decomposition state —
        # `decomp` accumulates per-stage seconds, `_t_mark` is the last
        # charged instant, `backoff_pending` is scheduled retry delay
        # not yet charged (split out of the next queue_wait interval).
        self.trace: _tracing.TraceContext | None = None
        self.decomp: dict[str, float] = {}
        self.backoff_pending = 0.0
        self._t_mark = self.submitted_mono

    def trace_mark(self, stage: str, now: float) -> None:
        """Charge the interval since the previous mark to `stage`
        (telemetry/tracing.py DECOMP_STAGES). The marks telescope —
        every interval of the ticket's life is charged to exactly one
        stage — so the stages sum to the terminal latency by
        construction, across any number of retries. A queue_wait
        interval is split against scheduled retry backoff first: the
        backoff window is deliberate delay, not queue pressure."""
        d = now - self._t_mark
        if d < 0.0:
            d = 0.0
        if stage == "queue_wait" and self.backoff_pending > 0.0:
            b = min(d, self.backoff_pending)
            self.decomp["backoff"] = self.decomp.get("backoff", 0.0) + b
            self.backoff_pending = 0.0
            d -= b
        self.decomp[stage] = self.decomp.get(stage, 0.0) + d
        self._t_mark = now

    def decomp_doc(self) -> dict:
        """The per-request decomposition block the done event carries
        (rounded like latency_s; validated by
        tracing.validate_decomposition)."""
        return {k: round(v, 6) for k, v in self.decomp.items()}

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _mark(self, state: str, wake: bool = True) -> None:
        if state not in TICKET_STATES:
            raise ValueError(f"unknown ticket state {state!r}")
        with self._lock:
            self._state = state
        if state == "requeued":
            # Wake waiters promptly on a PREEMPTION requeue: the
            # request must not block its submitter until timeout
            # (result() returns None). A retry-budget requeue parks
            # with wake=False — the submitter keeps waiting for the
            # retried batch's real resolution.
            self._retry_park = not wake
            if wake:
                self._event.set()
        elif state == "running":
            # A requeued ticket re-popped by the next drain is live
            # again — re-arm the wait for its real resolution.
            self._retry_park = False
            self._event.clear()

    def _resolve(self, result) -> None:
        with self._lock:
            self._state = "done"
            self._result = result
        self._event.set()

    def _terminal_fail(self, state: str, error: str) -> None:
        if state not in TERMINAL_STATES or state == "done":
            raise ValueError(f"not a failure terminal state: {state!r}")
        with self._lock:
            self._state = state
            self._error = error
        self._event.set()

    def _fail(self, error: str) -> None:
        self._terminal_fail("failed", error)

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> str | None:
        with self._lock:
            return self._error

    def age_s(self, now: float | None = None) -> float:
        """Seconds since submission (monotonic)."""
        return (time.monotonic() if now is None else now) \
            - self.submitted_mono

    def result(self, timeout: float | None = None):
        """Block until resolved; raises RuntimeError on any failure
        terminal state (failed / rejected / expired / quarantined —
        `state` and `error` say which), TimeoutError when the wait
        expires, and returns None promptly for a requeued (preempted)
        request — the caller re-submits (or waits for the next service
        to drain it). A RETRY-parked ticket is still owned by the live
        service: a timeout during its backoff window raises
        TimeoutError like any other in-progress wait — returning the
        preemption None here would invite a duplicate re-submit of a
        request that is about to be retried."""
        if not self._event.wait(timeout):
            if self.state == "requeued" and not self._retry_park:
                return None
            raise TimeoutError(
                f"request {self.request.request_id} not served in "
                f"{timeout}s (state {self.state})"
            )
        with self._lock:
            if self._state in TERMINAL_STATES and self._state != "done":
                raise RuntimeError(
                    f"request {self.request.request_id} "
                    f"{self._state}: {self._error}"
                )
            if self._state == "requeued":
                return None
            return self._result


class RequestQueue:
    """Thread-safe FIFO of tickets with counters for the telemetry
    plane (submitted/completed/… feed the monitor's SERVE badge,
    docs/TELEMETRY.md). `submit` is the producer side; the service's
    drain loop is the consumer (`pop_pending`); `requeue` parks tickets
    back at the FRONT (preempted/retried work outranks new arrivals),
    order-pinned by submission ordinal so any sequence of requeues
    preserves the tickets' original relative order.

    `max_depth` is the admission bound (docs/SERVING.md "SLOs and
    admission"): an over-depth submit is rejected FAST — the returned
    ticket is terminally `rejected` with a retry-after hint derived
    from the observed batch throughput — never silently dropped.

    `wall_slo` gates the wall-clock-dependent decisions (deadline
    expiry, retry backoff). A multi-controller service turns it off:
    rank-local clocks diverge, and a ticket expiring on one rank but
    not another would plan divergent batches — exactly the GL08
    collective-divergence hazard. Depth-based admission stays on
    everywhere (depth is deterministic)."""

    def __init__(self, max_depth: int | None = None):
        if max_depth is not None and int(max_depth) < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self._lock = threading.Lock()
        self._front: list[Ticket] = []  # requeued; popped before _pending
        self._pending: list[Ticket] = []
        self._closed = False
        self.max_depth = int(max_depth) if max_depth is not None else None
        self.wall_slo = True
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.requeued = 0
        self.rejected = 0
        # Submit-time slice of `rejected` (queue-full): the service's
        # flight-counter sync reads it apart from the circuit-open
        # rejections it already counted itself.
        self.rejected_at_submit = 0
        self.expired = 0
        self.quarantined = 0
        # Completion history (monotonic stamp, count) — the retry-after
        # hint's throughput observation window.
        self._done_marks: list[tuple[float, int]] = []
        self._expired_log: list[Ticket] = []

    def submit(self, request: Request) -> Ticket:
        t = Ticket(request)
        # Adopt the request's wire context (a fleet re-route continues
        # the dead hop's trace) or mint a fresh root: trace_id IS the
        # request_id, so a trace needs no id-mapping layer.
        ctx = _tracing.from_wire(request.trace)
        t.trace = ctx if ctx is not None \
            else _tracing.mint(request.request_id)
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            self.submitted += 1
            t.ordinal = self.submitted
            depth = len(self._front) + len(self._pending)
            if self.max_depth is not None and depth >= self.max_depth:
                self.rejected += 1
                self.rejected_at_submit += 1
                hint = self._retry_after_locked(depth)
                error = (
                    f"queue-full (depth {depth} >= max_depth "
                    f"{self.max_depth}); retry-after ~{hint:.2f}s"
                )
            else:
                error = None
                self._pending.append(t)
        if error is not None:
            t._terminal_fail("rejected", error)
        _tracing.emit_tspan("trace.submit", t.trace,
                            ordinal=t.ordinal, state=t.state)
        return t

    def _retry_after_locked(self, depth: int) -> float:
        """Retry-after hint: backlog ÷ observed completion throughput
        over the recent history window. Every edge is BOUNDED into
        [0.01, MAX_RETRY_AFTER_S]: zero/one completion marks (cold
        start) fall back to the default constant; a window whose
        newest mark is RETRY_WINDOW_STALE_S old (post-flood idle)
        falls back too, because extrapolating a dead window produces
        a near-infinite hint; a same-instant burst (span 0) likewise.
        A hint, not a promise."""
        marks = self._done_marks
        if len(marks) >= 2:
            span = marks[-1][0] - marks[0][0]
            n = sum(c for _, c in marks)
            stale = (
                time.monotonic() - marks[-1][0] > RETRY_WINDOW_STALE_S
            )
            if span > 0 and n > 0 and not stale:
                return min(
                    max(depth * span / n, 0.01), MAX_RETRY_AFTER_S
                )
        return DEFAULT_RETRY_AFTER_S

    def retry_after_hint(self) -> float:
        with self._lock:
            return self._retry_after_locked(
                len(self._front) + len(self._pending)
            )

    def depth(self) -> int:
        with self._lock:
            return len(self._front) + len(self._pending)

    def pop_pending(self, max_n: int | None = None) -> list[Ticket]:
        """Pop the eligible pending tickets (requeued front first, both
        halves in submission order). Pop time is where SLO decisions
        land: a ticket past its deadline fails with `deadline-exceeded`
        HERE — it never occupies a lane — and a retry-backoff ticket
        whose `not_before` hasn't arrived stays parked in place. With
        `wall_slo` off both checks are skipped (multi-controller
        determinism; class docstring)."""
        now = time.monotonic()
        expired: list[Ticket] = []
        popped: list[Ticket] = []
        with self._lock:
            # Order pin: the requeued block replays in original
            # submission order no matter how many requeue calls built it.
            self._front.sort(key=lambda t: t.ordinal)
            budget = (len(self._front) + len(self._pending)) \
                if max_n is None else int(max_n)
            for lst in (self._front, self._pending):
                keep: list[Ticket] = []
                for t in lst:
                    d = t.request.deadline_s
                    if self.wall_slo and d is not None \
                            and now - t.submitted_mono >= d:
                        expired.append(t)
                    elif len(popped) < budget and (
                        not self.wall_slo or t.not_before <= now
                    ):
                        popped.append(t)
                    else:
                        keep.append(t)
                lst[:] = keep
            self.expired += len(expired)
            self._expired_log.extend(expired)
        for t in expired:
            t._terminal_fail(
                "expired",
                f"deadline-exceeded: pending {t.age_s(now):.2f}s > "
                f"deadline_s {t.request.deadline_s}",
            )
        for t in popped:
            t._mark("running")
        return popped

    def pop_matching(self, pred, max_n: int | None = None,
                     ) -> list[Ticket]:
        """Pop up to `max_n` eligible pending tickets whose REQUEST
        satisfies `pred` — the continuous drain's swap-in feed
        (docs/SERVING.md "Continuous batching"): at a segment boundary
        the service pulls queued requests of the batch's own program
        class into freed lanes, leaving everything else parked in
        place. Same SLO semantics as `pop_pending` (deadline expiry and
        retry backoff land here, skipped with `wall_slo` off), same
        order pin (requeued front first, submission order), and popped
        tickets are marked running."""
        now = time.monotonic()
        expired: list[Ticket] = []
        popped: list[Ticket] = []
        with self._lock:
            self._front.sort(key=lambda t: t.ordinal)
            budget = (len(self._front) + len(self._pending)) \
                if max_n is None else int(max_n)
            for lst in (self._front, self._pending):
                keep: list[Ticket] = []
                for t in lst:
                    d = t.request.deadline_s
                    if self.wall_slo and d is not None \
                            and now - t.submitted_mono >= d:
                        expired.append(t)
                    elif len(popped) < budget and pred(t.request) and (
                        not self.wall_slo or t.not_before <= now
                    ):
                        popped.append(t)
                    else:
                        keep.append(t)
                lst[:] = keep
            self.expired += len(expired)
            self._expired_log.extend(expired)
        for t in expired:
            t._terminal_fail(
                "expired",
                f"deadline-exceeded: pending {t.age_s(now):.2f}s > "
                f"deadline_s {t.request.deadline_s}",
            )
        for t in popped:
            t._mark("running")
        return popped

    def take_expired(self) -> list[Ticket]:
        """Drain the newly-expired tickets (the service emits their
        telemetry events and flight counters from here)."""
        with self._lock:
            out, self._expired_log = self._expired_log, []
        return out

    def overdue_ids(self, now: float) -> list[str]:
        """Request ids of the pending tickets past their deadline at
        `now`, in queue order (read only: the verdict `expire_overdue`
        acts on)."""
        with self._lock:
            return [t.request.request_id for lst in (self._front, self._pending) for t in lst
                    if t.request.deadline_s is not None
                    and now - t.submitted_mono >= t.request.deadline_s]

    def has_deadlines(self) -> bool:
        """Does any pending ticket carry a deadline? (A function of the
        submitted requests alone, the same on every rank.)"""
        with self._lock:
            return any(t.request.deadline_s is not None
                       for lst in (self._front, self._pending) for t in lst)

    def expire_overdue(self, now: float | None = None, ids=None) -> list[Ticket]:
        """Expire pending tickets past their deadline with the
        CALLER'S clock — the fleet router's single-writer wall-clock
        authority (docs/SERVING.md "The fleet"): replica queues run
        with `wall_slo` off, so no replica-local clock ever makes an
        SLO decision; the router makes every one of them through this
        hook before draining a replica. `ids` (several ranks) expires
        exactly those pending tickets, the verdict rank 0's clock
        reached (`overdue_ids`), whatever this rank's clock says.
        Returns the tickets after terminally failing them;
        `take_expired` still feeds their telemetry as usual."""
        now = time.monotonic() if now is None else now
        verdict = set(self.overdue_ids(now) if ids is None else ids)
        expired: list[Ticket] = []
        with self._lock:
            for lst in (self._front, self._pending):
                keep: list[Ticket] = []
                for t in lst:
                    if t.request.request_id in verdict:
                        expired.append(t)
                    else:
                        keep.append(t)
                lst[:] = keep
            self.expired += len(expired)
            self._expired_log.extend(expired)
        for t in expired:
            t._terminal_fail(
                "expired",
                f"deadline-exceeded: pending {t.age_s(now):.2f}s > "
                f"deadline_s {t.request.deadline_s} (router clock)",
            )
        return expired

    def next_ready_delay(self) -> float | None:
        """Seconds until the earliest backoff-parked ticket becomes
        eligible; 0.0 when something is already eligible; None when the
        queue is empty."""
        now = time.monotonic()
        with self._lock:
            tickets = self._front + self._pending
            if not tickets:
                return None
            if not self.wall_slo:
                return 0.0
            return max(min(t.not_before for t in tickets) - now, 0.0)

    def requeue(self, tickets, wake: bool = True) -> None:
        """Park tickets back at the front. `wake=True` (preemption) lets
        blocked submitters observe the park promptly; `wake=False`
        (a retry-budget requeue) keeps them waiting for the retried
        batch's real resolution."""
        ts = list(tickets)
        for t in ts:
            t._mark("requeued", wake=wake)
        with self._lock:
            self._front.extend(ts)
            self.requeued += len(ts)

    def note_completed(self, n: int = 1, failed: int = 0) -> None:
        with self._lock:
            self.completed += n
            self.failed += failed
            if n:
                self._done_marks.append((time.monotonic(), n))
                del self._done_marks[:-32]

    def note_rejected(self, n: int = 1) -> None:
        """Admission rejections decided OUTSIDE submit (the service's
        circuit breaker rejects popped tickets of an open class)."""
        with self._lock:
            self.rejected += n

    def note_quarantined(self, n: int = 1) -> None:
        with self._lock:
            self.quarantined += n

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def counters(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "requeued": self.requeued,
                "rejected": self.rejected,
                "expired": self.expired,
                "quarantined": self.quarantined,
                "depth": len(self._front) + len(self._pending),
            }

    def check_accounting(self, in_flight: int = 0) -> list[str]:
        """The terminal accounting invariant (docs/SERVING.md "SLOs and
        admission"): every submitted ticket is terminally accounted —
        done + failed + rejected + expired + quarantined + still-queued
        (+ `in_flight` popped-but-unresolved) == submitted. The service
        asserts this at drain time with in_flight=0; problem strings
        returned, [] when the books balance."""
        c = self.counters()
        accounted = (
            c["completed"] + c["failed"] + c["rejected"] + c["expired"]
            + c["quarantined"] + c["depth"] + int(in_flight)
        )
        if accounted != c["submitted"]:
            return [
                f"terminal accounting violated: done {c['completed']} + "
                f"failed {c['failed']} + rejected {c['rejected']} + "
                f"expired {c['expired']} + quarantined "
                f"{c['quarantined']} + depth {c['depth']} + in-flight "
                f"{in_flight} = {accounted} != submitted "
                f"{c['submitted']}"
            ]
        return []
