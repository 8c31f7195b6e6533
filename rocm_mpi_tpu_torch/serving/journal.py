"""The durable fleet ticket journal — counterpart of
rocm_mpi_tpu/serving/journal.py (docs/SERVING.md "The fleet").

A fleet router (serving/router.py) owns tickets that outlive any one
replica: a `SimulationService` killed mid-traffic (SIGKILL, rc-75
preemption, or a watchdog verdict) takes its queue counters with it, so
the fleet-wide terminal-accounting invariant — every submitted ticket
reaches EXACTLY ONE terminal state — needs a source of truth that
survives the replica. That is this journal: an append-only JSONL ledger
(`rmt-fleet-journal` v1) recording every ticket's submit → route →
terminal transitions, written by exactly one router (replicas never
write it; the router also owns every wall-clock decision).

Durability: the live segment is append-only — every completed line is a
valid record, and a torn tail (the router died mid-write) is tolerated
by replay, never parsed as data. Sealed segments move out of the live
path via an atomic rename (`TicketJournal.seal_segment`), so a reader
never observes a half-sealed file.

Replay (`replay`) is a pure fold from record lines to per-ticket state:
running it twice — or re-running it over an already-reconciled fleet —
changes nothing (the reconciliation idempotence the replica-kill drill
pins). `exactly_one_terminal` turns the folded state into the fleet
accounting verdict.

The records and the merged report are the JAX package's, field for
field (only the report's `t` stamp differs between two runs), so each
package's validators and replay read the other's files. Stdlib at
import: `telemetry regress --check-schema` validates archived
`fleet-journal*.jsonl` / `fleet-report*.json` sidecars through the
validators here without importing torch.
"""

from __future__ import annotations

import json
import os
import pathlib
import time

JOURNAL_SCHEMA = "rmt-fleet-journal"
JOURNAL_VERSION = 1
JOURNAL_KINDS = ("submit", "route", "terminal")

FLEET_REPORT_SCHEMA = "rmt-fleet-report"
FLEET_REPORT_VERSION = 1

# serving/queue.py TERMINAL_STATES, spelled flat for the stdlib read
# side (tests/test_torch_fleet.py pins the spellings against the queue).
TERMINAL_STATES = ("done", "failed", "rejected", "expired", "quarantined")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def _base_record(kind: str, seq: int, request_id: str) -> dict:
    return {
        "schema": JOURNAL_SCHEMA,
        "v": JOURNAL_VERSION,
        "kind": kind,
        "seq": int(seq),
        "request_id": request_id,
    }


def validate_journal_record(doc: dict) -> list[str]:
    """Problem strings for one fleet-journal line (stdlib; shared with
    `telemetry regress --check-schema`)."""
    problems: list[str] = []
    if doc.get("schema") != JOURNAL_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {JOURNAL_SCHEMA}"
        )
    if not isinstance(doc.get("v"), int):
        problems.append("missing int v")
    kind = doc.get("kind")
    if kind not in JOURNAL_KINDS:
        problems.append(
            f"kind {kind!r} not one of {list(JOURNAL_KINDS)}"
        )
    seq = doc.get("seq")
    if not isinstance(seq, int) or isinstance(seq, bool) or seq < 0:
        problems.append(f"seq {seq!r} is not a non-negative int")
    rid = doc.get("request_id")
    if not isinstance(rid, str) or not rid:
        problems.append("missing request_id")
    if kind == "route":
        rep = doc.get("replica")
        if not isinstance(rep, int) or isinstance(rep, bool) or rep < 0:
            problems.append(f"route record replica {rep!r} is not an id")
    if kind == "terminal":
        state = doc.get("state")
        if state not in TERMINAL_STATES:
            problems.append(
                f"terminal state {state!r} not one of "
                f"{list(TERMINAL_STATES)}"
            )
    return problems


# ---------------------------------------------------------------------------
# the single-writer journal
# ---------------------------------------------------------------------------


class TicketJournal:
    """Append-only single-writer journal. One instance per router; the
    live segment is `<path>`, sealed segments are
    `<stem>-segNNN<suffix>` siblings (atomic rename — see
    `seal_segment`). Every append is flushed line-atomically, so a
    replica kill between appends never tears a record."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._seq = 0
        self._sealed = 0
        # Resume the seq counter over an existing live segment (a
        # router restart keeps appending to the same ledger).
        if self.path.is_file():
            state = replay([self.path])
            self._seq = state.seq_max + 1
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- writers ----------------------------------------------------------

    def _append(self, doc: dict) -> dict:
        self._fh.write(json.dumps(doc, sort_keys=True) + "\n")
        self._fh.flush()
        self._seq += 1
        return doc

    def record_submit(self, request_id: str, *, session=None,
                      bin_key=None) -> dict:
        doc = _base_record("submit", self._seq, request_id)
        doc["session"] = session
        doc["bin"] = bin_key
        return self._append(doc)

    def record_route(self, request_id: str, replica: int, *,
                     reroute: bool = False) -> dict:
        doc = _base_record("route", self._seq, request_id)
        doc["replica"] = int(replica)
        doc["reroute"] = bool(reroute)
        return self._append(doc)

    def record_terminal(self, request_id: str, state: str, *,
                        replica=None) -> dict:
        if state not in TERMINAL_STATES:
            raise ValueError(
                f"terminal state must be one of {TERMINAL_STATES}, "
                f"got {state!r}"
            )
        doc = _base_record("terminal", self._seq, request_id)
        doc["state"] = state
        doc["replica"] = replica
        return self._append(doc)

    # -- segments ---------------------------------------------------------

    def seal_segment(self) -> pathlib.Path | None:
        """Atomically move the live segment aside (`os.replace` — a
        reader sees either the live file or the sealed one, never a
        torn copy) and start a fresh live segment. Returns the sealed
        path, or None when the live segment is empty."""
        self._fh.close()
        sealed = None
        if self.path.is_file() and self.path.stat().st_size > 0:
            sealed = self.path.with_name(
                f"{self.path.stem}-seg{self._sealed:03d}"
                f"{self.path.suffix}"
            )
            os.replace(self.path, sealed)
            self._sealed += 1
        self._fh = open(self.path, "a", encoding="utf-8")
        return sealed

    def segments(self) -> list[pathlib.Path]:
        """Every segment in replay order: sealed (oldest first) then
        the live tail."""
        sealed = sorted(
            self.path.parent.glob(
                f"{self.path.stem}-seg*{self.path.suffix}"
            )
        )
        live = [self.path] if self.path.is_file() else []
        return sealed + live

    def close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# replay: the pure fold
# ---------------------------------------------------------------------------


class JournalState:
    """Folded per-ticket view of a journal replay. `tickets` maps
    request_id -> {"submitted", "session", "bin", "routes",
    "terminals", "reroutes"}; a complete fleet run leaves every ticket
    with exactly one terminal."""

    def __init__(self):
        self.tickets: dict[str, dict] = {}
        self.seq_max = -1
        self.torn_lines = 0
        self.malformed: list[str] = []

    def _ticket(self, rid: str) -> dict:
        return self.tickets.setdefault(rid, {
            "submitted": False, "session": None, "bin": None,
            "routes": [], "reroutes": 0, "terminals": [],
        })

    def apply(self, doc: dict) -> None:
        problems = validate_journal_record(doc)
        if problems:
            self.malformed.append("; ".join(problems))
            return
        self.seq_max = max(self.seq_max, int(doc["seq"]))
        t = self._ticket(doc["request_id"])
        kind = doc["kind"]
        if kind == "submit":
            t["submitted"] = True
            t["session"] = doc.get("session")
            t["bin"] = doc.get("bin")
        elif kind == "route":
            t["routes"].append(int(doc["replica"]))
            if doc.get("reroute"):
                t["reroutes"] += 1
        elif kind == "terminal":
            t["terminals"].append(
                (doc["state"], doc.get("replica"))
            )

    # -- derived views ----------------------------------------------------

    def open_on(self, replica: int) -> list[str]:
        """Tickets whose LAST route landed on `replica` and that never
        reached a terminal — the re-route set when `replica` dies."""
        out = []
        for rid, t in self.tickets.items():
            if t["terminals"] or not t["routes"]:
                continue
            if t["routes"][-1] == int(replica):
                out.append(rid)
        return sorted(out)

    def terminal_counts(self) -> dict:
        counts = {s: 0 for s in TERMINAL_STATES}
        for t in self.tickets.values():
            for state, _rep in t["terminals"]:
                counts[state] += 1
        return counts

    def counts(self) -> dict:
        """The journal block of the fleet report."""
        term = self.terminal_counts()
        n_term = sum(
            1 for t in self.tickets.values() if t["terminals"]
        )
        return {
            "tickets": len(self.tickets),
            "terminal": term,
            "open": len(self.tickets) - n_term,
            "rerouted": sum(
                t["reroutes"] for t in self.tickets.values()
            ),
            "torn_lines": self.torn_lines,
        }


def replay(paths) -> JournalState:
    """Fold journal segments into a `JournalState`. Pure and
    idempotent: same segments -> same state, and a state rebuilt after
    reconciliation already contains the reconciliation's own records —
    there is nothing to 'apply twice'. A torn tail line (the router
    died mid-append) is counted, never parsed."""
    state = JournalState()
    for raw in paths:
        path = pathlib.Path(raw)
        if not path.is_file():
            continue
        try:
            text = path.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                state.torn_lines += 1
                continue
            if isinstance(doc, dict):
                state.apply(doc)
            else:
                state.torn_lines += 1
    return state


def exactly_one_terminal(state: JournalState) -> list[str]:
    """The fleet accounting invariant (docs/SERVING.md "The fleet"):
    at fleet drain, every journaled ticket has exactly one terminal
    record — zero means a ticket vanished with a replica (the exact
    loss the journal exists to catch), two means a re-routed ticket's
    side effects ran twice. Problem strings; [] when the books
    balance."""
    problems = []
    for rid in sorted(state.tickets):
        t = state.tickets[rid]
        n = len(t["terminals"])
        if not t["submitted"]:
            problems.append(f"{rid}: routed/terminated, never submitted")
        if n == 0:
            problems.append(f"{rid}: no terminal state (lost ticket)")
        elif n > 1:
            states = [s for s, _ in t["terminals"]]
            problems.append(
                f"{rid}: {n} terminal states {states} (want exactly 1)"
            )
    if state.malformed:
        problems.append(
            f"{len(state.malformed)} malformed record(s): "
            + state.malformed[0]
        )
    return problems


# ---------------------------------------------------------------------------
# the merged fleet report
# ---------------------------------------------------------------------------


def fleet_report_doc(replicas, slo: dict, journal_counts: dict, *,
                     accounting_ok: bool, autoscale=()) -> dict:
    """The schema-versioned merged fleet report
    (`rmt-fleet-report` v1): one row per replica (alive or not — a
    killed replica's frozen view stays in the record), the merged SLO
    block (journal-derived terminal counts: replica counters die with
    the replica, the journal does not), the journal accounting block,
    and the autoscale event trail."""
    return {
        "schema": FLEET_REPORT_SCHEMA,
        "v": FLEET_REPORT_VERSION,
        # A record's wall stamp (the `t` every telemetry record
        # carries), not an interval measurement.
        "t": time.time(),
        "replicas": list(replicas),
        "slo": dict(slo),
        "journal": dict(journal_counts),
        "autoscale": list(autoscale),
        "accounting_ok": bool(accounting_ok),
    }


def validate_fleet_report(doc: dict) -> list[str]:
    """Problem strings for a fleet-report.json document (stdlib;
    shared with `telemetry regress --check-schema`)."""
    problems: list[str] = []
    if doc.get("schema") != FLEET_REPORT_SCHEMA:
        problems.append(
            f"schema {doc.get('schema')!r} != {FLEET_REPORT_SCHEMA}"
        )
    if not isinstance(doc.get("v"), int):
        problems.append("missing int v")
    if not isinstance(doc.get("accounting_ok"), bool):
        problems.append("missing bool accounting_ok")
    reps = doc.get("replicas")
    if not isinstance(reps, list) or not reps:
        problems.append("missing non-empty replicas list")
    else:
        for i, rep in enumerate(reps):
            if not isinstance(rep, dict):
                problems.append(f"replicas[{i}] not an object")
                continue
            if not isinstance(rep.get("id"), int):
                problems.append(f"replicas[{i}] missing int id")
            if not isinstance(rep.get("alive"), bool):
                problems.append(f"replicas[{i}] missing bool alive")
            steady = rep.get("steady_state")
            if not isinstance(steady, int) or isinstance(steady, bool):
                problems.append(
                    f"replicas[{i}] missing int steady_state"
                )
    slo = doc.get("slo")
    if not isinstance(slo, dict):
        problems.append("missing slo block")
    else:
        for field in ("submitted", "done", "failed", "rejected",
                      "expired", "quarantined", "retries"):
            v = slo.get(field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                problems.append(f"slo.{field} {v!r} is not a count")
    jc = doc.get("journal")
    if not isinstance(jc, dict):
        problems.append("missing journal block")
    else:
        for field in ("tickets", "open", "rerouted", "torn_lines"):
            v = jc.get(field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                problems.append(f"journal.{field} {v!r} is not a count")
        term = jc.get("terminal")
        if not isinstance(term, dict) or set(term) != set(
            TERMINAL_STATES
        ):
            problems.append(
                "journal.terminal must map every terminal state"
            )
    if not isinstance(doc.get("autoscale"), list):
        problems.append("missing autoscale event list")
    return problems


def write_fleet_report(path, doc: dict) -> None:
    """Atomic tmp+rename write: the merged report is the one artifact a
    killed fleet leaves for triage, so it is never left torn."""
    problems = validate_fleet_report(doc)
    if problems:
        raise ValueError("bad fleet report: " + "; ".join(problems))
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
