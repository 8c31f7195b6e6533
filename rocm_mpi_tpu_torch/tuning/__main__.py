"""The autotuner CLI — counterpart of rocm_mpi_tpu/tuning/__main__.py.

    python -m rocm_mpi_tpu_torch.tuning search   [--ops A,B] [--shape N[,M…]]
                                                 [--dtype f32] [--repeats R]
                                                 [--cache PATH] [--force]
                                                 [--device cuda|cpu]
    python -m rocm_mpi_tpu_torch.tuning show     [--cache PATH]
    python -m rocm_mpi_tpu_torch.tuning validate PATH [PATH…]

* `search` — tune the default ops (the diffusion and wave VMEM loops) or
  --ops at the per-shard --shape ("252x252" or "252,252"), on the card
  unless --device cpu. The hit scan comes first: keys whose
  fingerprint-valid entry exists are pure hits, nothing runs, and on a
  fully warm cache the closing line reports `compiles.steady_state=0`.
  Exit 0 on success (all hits included), 1 when a key ends all-rejected
  (every candidate over its traffic budget), 2 on usage.
* `show` — the cache's entries, entries of another torch marked STALE.
* `validate` — the strict schema and traffic-gate check of cache files:
  exit 1 on a schema problem or any entry whose config models over its
  A_eff budget, 2 on an unreadable path. A torn file FAILS here, where
  the runtime reads it as empty.
"""

from __future__ import annotations

import argparse
import json
import sys

from rocm_mpi_tpu_torch.tuning import cache as _cache
from rocm_mpi_tpu_torch.tuning import gate as _gate
from rocm_mpi_tpu_torch.tuning.keys import parse_dims, parse_key


def _log(*parts) -> None:
    print(*parts, file=sys.stderr)


DEFAULT_SEARCH_OPS = ("diffusion.vmem_loop", "wave.vmem_loop")


def _shape(text: str) -> tuple[int, ...]:
    return parse_dims(text.replace(",", "x"))


def cmd_search(args) -> int:
    from rocm_mpi_tpu_torch.telemetry import compiles
    from rocm_mpi_tpu_torch.tuning import resolve as _resolve
    from rocm_mpi_tpu_torch.tuning import search as _search

    ops = tuple(o for o in args.ops.split(",") if o) if args.ops else DEFAULT_SEARCH_OPS
    shape = _shape(args.shape)
    path = args.cache or _cache.default_cache_path()
    compiles.install()

    # The hit scan first: a fully warm cache does no work, and every
    # compile after the steady mark would be a recompile.
    results = []
    pending = []
    for op in ops:
        r = _search.search_op(op, shape, args.dtype, repeats=args.repeats, cache_path=path,
                              force=args.force, log=_log, device=args.device)
        if r["status"] == "hit":
            results.append(r)
        else:
            pending.append((op, r))
    if not pending:
        compiles.mark_steady()
    statuses = [r["status"] for r in results] + [r["status"] for _, r in pending]
    hits = statuses.count("hit")
    tuned = statuses.count("tuned")
    bad = statuses.count("all-rejected")
    _log(
        f"tuning search: {hits} hit(s), {tuned} tuned, {bad} rejected-out, "
        f"{statuses.count('empty')} empty — cache {path}; "
        f"compiles.steady_state={compiles.steady_state()}"
    )
    _resolve.emit_gauges()
    return 1 if bad else 0


def cmd_show(args) -> int:
    path = args.cache or _cache.default_cache_path()
    doc = _cache.load(path)
    entries = doc.get("entries", {})
    if not entries:
        print(f"tuning cache {path}: empty")
        return 0
    import torch

    print(f"tuning cache {path}: {len(entries)} entr{'y' if len(entries) == 1 else 'ies'}")
    for raw_key, entry in sorted(entries.items()):
        fp = entry.get("fingerprint", {})
        stale = ""
        if fp.get("torch") != torch.__version__:
            stale = f"  [STALE: torch {fp.get('torch')}]"
        print(
            f"  {raw_key}\n"
            f"    config={json.dumps(entry.get('config'), sort_keys=True)} "
            f"median_us={entry.get('median_us')} "
            f"gate={entry.get('gate_ratio')}x{stale}"
        )
    return 0


def cmd_validate(args) -> int:
    if not args.paths:
        _log("tuning validate: no paths given")
        return 2
    problems = []
    for path in args.paths:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except OSError as e:
            _log(f"tuning validate: cannot read {path}: {e}")
            return 2
        except ValueError as e:
            problems.append(f"{path}: not valid JSON ({e})")
            continue
        problems.extend(_cache.validate_doc(doc, path))
        entries = doc.get("entries") if isinstance(doc, dict) else None
        if not isinstance(entries, dict):
            continue
        for raw_key, entry in sorted(entries.items()):
            try:
                key = parse_key(raw_key)
            except ValueError:
                continue  # already reported by validate_doc
            if not isinstance(entry, dict) or not isinstance(entry.get("config"), dict):
                continue
            g = _gate.validate_entry(key, entry)
            if not g.ok:
                problems.append(f"{path}: entry {raw_key!r}: {g.reason}")
        if not problems:
            _log(f"tuning validate: {path} ok "
                 f"({len(entries)} entr{'y' if len(entries) == 1 else 'ies'})")
    for p in problems:
        _log(f"tuning validate: PROBLEM: {p}")
    return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rocm_mpi_tpu_torch.tuning",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("search", help="measure + gate + persist winners")
    ps.add_argument("--ops", default=None,
                    help="comma-separated tunable ops (default: "
                    + ",".join(DEFAULT_SEARCH_OPS) + ")")
    ps.add_argument("--shape", default="32x32",
                    help="per-shard field shape, e.g. 252x252 or 252,252 (default %(default)s)")
    ps.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"])
    ps.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per candidate (median wins)")
    ps.add_argument("--cache", default=None, metavar="PATH")
    ps.add_argument("--force", action="store_true",
                    help="re-measure keys that already have valid entries")
    ps.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's kernels; cpu: the plain versions (default %(default)s)")

    pw = sub.add_parser("show", help="print the cache's entries")
    pw.add_argument("--cache", default=None, metavar="PATH")

    pv = sub.add_parser("validate", help="strict schema + traffic-gate check")
    pv.add_argument("paths", nargs="*", metavar="PATH")

    args = p.parse_args(argv)
    if args.cmd == "search":
        try:
            _shape(args.shape)
        except ValueError as e:
            _log(f"tuning search: {e}")
            return 2
        if args.repeats < 1:
            _log("tuning search: --repeats must be >= 1")
            return 2
        return cmd_search(args)
    if args.cmd == "show":
        return cmd_show(args)
    return cmd_validate(args)


if __name__ == "__main__":
    sys.exit(main())
