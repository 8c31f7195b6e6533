"""CLI: python -m rocm_mpi_tpu_torch.telemetry
           {summarize,regress,monitor,export-openmetrics,trace} …

The counterpart of `python -m rocm_mpi_tpu.telemetry`, with the same
verbs, options, documents and exit codes; it imports neither torch nor
JAX, so it runs on the card's machine and on any box holding a run's
streams.

    summarize DIR [--json] [--out FILE] [--trace FILE]
                  [--straggler-factor F]
        Merge DIR's telemetry-rank*.jsonl streams; write the summary
        (default DIR/telemetry-summary.json) and a Chrome trace (default
        DIR/telemetry-trace.json, openable at ui.perfetto.dev — health
        heartbeat sidecars in DIR merge in as progress counter tracks);
        print a human report (--json prints the summary document
        instead). Exit 0 on success, 2 when DIR has no rank streams.

    regress SUMMARY --baseline FILE [--tolerance F]
        Gate SUMMARY (a summary file, or a run directory to summarize on
        the fly) against a committed baseline. Exit 0 pass, 1 regression,
        2 missing/unreadable inputs.

    regress --check-schema FILE [FILE…]
        Validate committed measurement artifacts (BASELINE.json,
        MULTICHIP_r0*.json, mechanics/telemetry JSONLs, summaries,
        heartbeat/post-mortem sidecars) still parse as a known format.
        The graftlint and serving families are recognized by their
        schema marker and named as not deep-checked. Exit 0 ok, 1
        problems.

    monitor DIR [--interval S] [--iterations N]
        Live per-rank view from the health-plane heartbeat sidecars
        (docs/TELEMETRY.md "Health plane"): step counter, step rate,
        current phase, phase age, delta vs the cross-rank median. When
        the elastic supervisor left an elastic.jsonl sidecar in DIR
        (docs/RESILIENCE.md "Elastic recovery" and §7), the header shows
        the CURRENT mesh shape plus SHRUNK / GROWN badges for runs that
        changed topology, a STORAGE DEGRADED indicator when the
        ckpt_* heartbeat counters say a rank is skipping saves through a
        storage outage, and a WIRE badge when the run's telemetry
        streams carry reduced-precision exchange annotations
        (docs/PERF.md "Wire precision"). Curses-free — redraws in place
        on a TTY, appends
        snapshots otherwise. Exit 0 after N iterations (default: run
        until ^C), 2 when DIR has no heartbeat sidecars to watch.

    export-openmetrics DIR [--out FILE]
        One Prometheus/OpenMetrics text snapshot of the run's gauges,
        counters, and per-rank progress, metric keys verbatim in a
        `key` label (scrape-ready; round-trips `run.gpts@4dev:scan`
        keys exactly). Exit 0, 2 when DIR has neither rank streams nor
        heartbeat sidecars.

    trace DIR --request ID [--out FILE] [--chrome FILE]
        One request's causal timeline across every rank stream under
        DIR (fleet layouts with replica subdirectories included):
        hop-indented human lines plus the latency decomposition
        (docs/TELEMETRY.md "Request tracing"). --out banks the
        schema-versioned trace report (rmt-trace-report, gated by
        regress --check-schema); --chrome exports a per-hop Chrome
        trace for the request. Exit 0, 2 when DIR has no streams or
        no stream mentions the request.

stdlib-only end to end: the read side of telemetry must run on machines
that will never import torch (CI, a laptop holding a run's stream).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from rocm_mpi_tpu_torch.telemetry import aggregate, health, regress, trace, tracing


def _cmd_summarize(args) -> int:
    streams, skipped = aggregate.load_rank_streams(args.dir)
    if not streams:
        print(
            f"error: no telemetry-rank*.jsonl under {args.dir} "
            "(run with --telemetry DIR, or RMT_TELEMETRY_DIR=DIR)",
            file=sys.stderr,
        )
        return 2
    summary = aggregate.summarize(streams, skipped, args.straggler_factor)
    out = pathlib.Path(
        args.out or pathlib.Path(args.dir) / "telemetry-summary.json"
    )
    aggregate.write_json_atomic(out, summary)
    trace_path = pathlib.Path(
        args.trace or pathlib.Path(args.dir) / "telemetry-trace.json"
    )
    # Health sidecars, when the run left any, ride into the trace as
    # progress counter tracks — same merge the post-mortem bundle gets.
    beats, _ = health.load_heartbeats(args.dir)
    trace.write_chrome_trace(streams, trace_path, heartbeats=beats or None)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(aggregate.format_summary(summary))
        print(f"summary: {out}")
        print(f"chrome trace: {trace_path} (open at ui.perfetto.dev)")
    return 0


def _cmd_regress(args) -> int:
    if args.check_schema:
        targets = [args.summary] if args.summary else []
        targets += args.extra
        if not targets:
            print("error: --check-schema needs at least one file",
                  file=sys.stderr)
            return 2
        notes: list[str] = []
        problems = regress.check_schema(targets, notes=notes)
        for n in notes:
            print(f"note: {n}")
        for p in problems:
            print(p, file=sys.stderr)
        if not problems:
            print(f"schema check ok: {len(targets)} file(s)")
        return 1 if problems else 0

    if not args.summary or not args.baseline:
        print("error: regress needs SUMMARY and --baseline FILE",
              file=sys.stderr)
        return 2
    summary_path = pathlib.Path(args.summary)
    if summary_path.is_dir():
        summary = aggregate.summarize_dir(summary_path)
        if not summary["ranks"]:
            print(f"error: no telemetry streams under {summary_path}",
                  file=sys.stderr)
            return 2
    else:
        summary = regress.load_json(summary_path)
        if summary is None:
            print(f"error: cannot read summary {summary_path}",
                  file=sys.stderr)
            return 2
    baseline = regress.load_json(args.baseline)
    if baseline is None:
        print(f"error: cannot read baseline {args.baseline}",
              file=sys.stderr)
        return 2
    deltas = regress.compare(summary, baseline, args.tolerance)
    if not deltas:
        print(
            "error: no comparable metrics between summary and baseline "
            "(a gate that compares nothing must not pass)",
            file=sys.stderr,
        )
        return 2
    # Key drift must be VISIBLE: a baseline metric with no counterpart in
    # the summary simply drops out of the comparison (e.g. gauge keys
    # grew a ':driver' suffix, or a phase stopped being observed) — that
    # family is then ungated, which the operator must be told about even
    # while the remaining metrics still gate.
    dropped = sorted(
        set(regress.extract_metrics(baseline))
        - set(regress.extract_metrics(summary))
    )
    if dropped:
        shown = ", ".join(dropped[:5]) + ("…" if len(dropped) > 5 else "")
        print(
            f"warning: {len(dropped)} baseline metric(s) have no "
            f"counterpart in the summary and are NOT gated: {shown} "
            "(renamed keys? re-bank the baseline)",
            file=sys.stderr,
        )
    for d in deltas:
        print(d.describe())
    bad = regress.regressions(deltas)
    if bad:
        print(f"REGRESSION: {len(bad)}/{len(deltas)} metric(s) beyond "
              f"{args.tolerance:.0%} tolerance", file=sys.stderr)
        return 1
    print(f"pass: {len(deltas)} metric(s) within "
          f"{args.tolerance:.0%} tolerance")
    return 0


def _cmd_monitor(args) -> int:
    import time

    beats, skipped = health.load_heartbeats(args.dir)
    if not beats:
        print(
            f"error: no heartbeat-rank*.json under {args.dir} — is a "
            "--health run writing sidecars there? (docs/TELEMETRY.md)",
            file=sys.stderr,
        )
        return 2
    prev: dict[int, dict] | None = None
    i = 0
    clear_screen = sys.stdout.isatty()
    # Reduced-precision wire badge (docs/PERF.md "Wire precision"):
    # annotation-sourced from the rank streams — an f32 run and a
    # bf16-wire run must never be eyeballed (or regress-compared) as
    # the same measurement. Wire modes are trace-time facts, fixed per
    # compiled program: read the streams ONCE here, not per poll (they
    # grow with the run; the heartbeat sidecars the loop re-reads stay
    # small by construction).
    wire_line = health.format_wire_status(health.wire_status(args.dir))
    try:
        while True:
            rows = health.monitor_rows(beats, prev)
            if clear_screen:
                print("\x1b[H\x1b[2J", end="")
            print(f"health monitor: {args.dir}  "
                  f"({len(beats)} rank(s), poll {args.interval:g}s)")
            # Elastic runs (resilience.elastic) leave an elastic.jsonl
            # next to the sidecars: surface the current mesh and the
            # SHRUNK / GROWN badges — an operator must see at a glance
            # that this run is no longer on the mesh it started with.
            elastic_events, _ = health.load_elastic_events(args.dir)
            elastic_line = health.format_elastic_status(
                health.elastic_status(elastic_events)
            )
            if elastic_line:
                print(elastic_line)
            # Degraded checkpoint storage (docs/RESILIENCE.md §7): the
            # segmented loop keeps computing through an outage, so the
            # ONLY place an operator sees the widening loss window is
            # here — the ckpt_* heartbeat counters each boundary bumps.
            storage_line = health.format_storage_status(
                health.storage_status(beats)
            )
            if storage_line:
                print(storage_line)
            # Serving runs (docs/SERVING.md): queue depth + served /
            # requeued counts from the serve_* heartbeat counters — the
            # operator's at-a-glance backlog view.
            serve_line = health.format_serve_status(
                health.serve_status(beats)
            )
            if serve_line:
                print(serve_line)
            if wire_line:
                print(wire_line)
            print(health.format_monitor(rows, skipped))
            sys.stdout.flush()
            i += 1
            if args.iterations is not None and i >= args.iterations:
                return 0
            time.sleep(args.interval)
            prev = beats
            beats, skipped = health.load_heartbeats(args.dir)
            if not beats:
                print(f"error: heartbeat sidecars vanished from {args.dir}",
                      file=sys.stderr)
                return 2
    except KeyboardInterrupt:
        return 0


def _cmd_export_openmetrics(args) -> int:
    text = health.export_openmetrics(args.dir)
    if text is None:
        print(
            f"error: nothing to export under {args.dir} (neither "
            "telemetry-rank*.jsonl nor heartbeat-rank*.json)",
            file=sys.stderr,
        )
        return 2
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(out.suffix + ".tmp")
        tmp.write_text(text)
        tmp.replace(out)
        print(f"wrote {out}", file=sys.stderr)
    else:
        print(text, end="")
    return 0


def _cmd_trace(args) -> int:
    streams, _ = aggregate.load_rank_streams(args.dir)
    if not streams:
        print(
            f"error: no telemetry-rank*.jsonl under {args.dir} "
            "(run with --telemetry DIR, or RMT_TELEMETRY_DIR=DIR)",
            file=sys.stderr,
        )
        return 2
    timeline = tracing.request_timeline(streams, args.request)
    if timeline is None:
        print(
            f"error: no stream under {args.dir} mentions request "
            f"{args.request!r} (tracing off, or wrong id?)",
            file=sys.stderr,
        )
        return 2
    print(tracing.format_timeline(timeline))
    if args.out:
        doc = tracing.trace_report_doc(timeline)
        tracing.write_trace_report(args.out, doc)
        print(f"trace report: {args.out}")
    if args.chrome:
        tracing.write_request_chrome(timeline, args.chrome)
        print(f"per-hop chrome trace: {args.chrome} "
              "(open at ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m rocm_mpi_tpu_torch.telemetry",
        description="telemetry read side: merge rank streams, export "
                    "Chrome traces, gate on perf baselines "
                    "(docs/TELEMETRY.md)",
    )
    sub = parser.add_subparsers(dest="command")

    p_sum = sub.add_parser("summarize", help="merge per-rank streams")
    p_sum.add_argument("dir", help="directory of telemetry-rank*.jsonl")
    p_sum.add_argument("--json", action="store_true",
                       help="print the summary document instead of the "
                            "human report")
    p_sum.add_argument("--out", default=None, metavar="FILE",
                       help="summary path (default DIR/telemetry-summary.json)")
    p_sum.add_argument("--trace", default=None, metavar="FILE",
                       help="Chrome trace path (default "
                            "DIR/telemetry-trace.json)")
    p_sum.add_argument("--straggler-factor", type=float,
                       default=aggregate.DEFAULT_STRAGGLER_FACTOR,
                       help="rank flagged when phase wall exceeds the "
                            "median by this factor (default %(default)s)")

    p_reg = sub.add_parser("regress", help="gate a summary vs a baseline")
    p_reg.add_argument("summary", nargs="?", default=None,
                       help="summary JSON (or run directory)")
    p_reg.add_argument("extra", nargs="*", default=[],
                       help="more files (--check-schema mode)")
    p_reg.add_argument("--baseline", default=None, metavar="FILE")
    p_reg.add_argument("--tolerance", type=float,
                       default=regress.DEFAULT_TOLERANCE,
                       help="allowed relative slip (default %(default)s)")
    p_reg.add_argument("--check-schema", action="store_true",
                       help="only validate the files parse as known "
                            "measurement formats")

    p_mon = sub.add_parser(
        "monitor", help="live per-rank progress from heartbeat sidecars"
    )
    p_mon.add_argument("dir", help="directory of heartbeat-rank*.json")
    p_mon.add_argument("--interval", type=float, default=1.0, metavar="S",
                       help="poll interval in seconds (default %(default)s)")
    p_mon.add_argument("--iterations", type=int, default=None, metavar="N",
                       help="exit 0 after N redraws (default: run until ^C)")

    p_om = sub.add_parser(
        "export-openmetrics",
        help="Prometheus text snapshot of gauges/counters/progress",
    )
    p_om.add_argument("dir", help="telemetry/health run directory")
    p_om.add_argument("--out", default=None, metavar="FILE",
                      help="write the snapshot here instead of stdout")

    p_tr = sub.add_parser(
        "trace",
        help="one request's causal timeline + latency decomposition",
    )
    p_tr.add_argument("dir", help="directory of telemetry-rank*.jsonl")
    p_tr.add_argument("--request", required=True, metavar="ID",
                      help="request id (== trace id) to reconstruct")
    p_tr.add_argument("--out", default=None, metavar="FILE",
                      help="bank the rmt-trace-report artifact here")
    p_tr.add_argument("--chrome", default=None, metavar="FILE",
                      help="export the per-hop Chrome trace here")

    args = parser.parse_args(argv)
    if args.command == "summarize":
        return _cmd_summarize(args)
    if args.command == "regress":
        return _cmd_regress(args)
    if args.command == "monitor":
        return _cmd_monitor(args)
    if args.command == "export-openmetrics":
        return _cmd_export_openmetrics(args)
    if args.command == "trace":
        return _cmd_trace(args)
    parser.print_usage(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
