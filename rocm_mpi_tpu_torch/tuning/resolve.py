"""The one consumer of the tuning cache — counterpart of
rocm_mpi_tpu/tuning/resolve.py.

Every `config="auto"` path of the port funnels through `resolve()`:
build the tuning key of the call site, look it up in the process's cache
snapshot, and return the winning config dict, or None for "use the
defaults" (the miss contract: auto is never worse than the defaults).
The consumers pass the resolved values on as the explicit arguments the
defaults would have taken; a value that breaks one of their rules is
dropped there, silently, and the default used.

The cache document is read once per process (the first resolve) and
kept: a rewrite during a run never changes the programs of that run.
Tests and the search CLI swap snapshots with `refresh()` and
`configure(path=…)`.

**One decision for a grid of several ranks.** The JAX package resolves
once for a mesh that one process drives, and resolves nothing where
several processes drive one (`jax.process_count() > 1`), since each
would read its own file. A port rank is a JAX device, not a JAX process:
each rank is one process. So where a call site runs on a grid of more
than one rank, the grid's rank 0 resolves and broadcasts its result over
the grid's process group (the default group, or a weak-scaling rung's
subgroup), before any CUDA-graph capture. The ranks can never disagree
on `k`, `wire_mode` or `chunk`, which would mean mismatched collectives:
the hang the JAX package's guard avoids. Every rank of the grid must
make the same resolves in the same order, as it makes the same
exchanges.
"""

from __future__ import annotations

import json

from rocm_mpi_tpu_torch.tuning import cache as _cache
from rocm_mpi_tpu_torch.tuning import keys as _keys

# The snapshot, an explicit path override and the outcome counters.
_STATE: dict = {
    "doc": None,  # loaded cache document (None = not loaded yet)
    "path": None,  # explicit override (configure/tests); None = default
    "hits": 0,
    "misses": 0,
}


def configure(path) -> None:
    """Point this process at an explicit cache file; drops the snapshot."""
    _STATE["path"] = str(path) if path is not None else None
    _STATE["doc"] = None


def refresh() -> None:
    """Drop the snapshot; the next resolve() re-reads the file."""
    _STATE["doc"] = None


def cache_path() -> str:
    return _STATE["path"] or _cache.default_cache_path()


def _doc() -> dict:
    doc = _STATE["doc"]
    if doc is None:
        doc = _cache.load(cache_path())
        _STATE["doc"] = doc
    return doc


def _valid_wire_mode(v) -> bool:
    from rocm_mpi_tpu_torch.parallel.wire import WIRE_MODES

    return v in WIRE_MODES


def _positive_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


# Per-knob validity at the consumption seam: a cache entry is untrusted
# input, so a field that would crash a kernel is dropped here. These are
# crash-safety bounds only; the rules with numerical consequences (a VMEM
# chunk >= 4, k within the shard) live with the consumers and the gate.
# `run_rows` stands where the JAX package has `tm` (tuning/space.py).
_FIELD_VALID = {
    "chunk": _positive_int,
    "body_form": lambda v: v in ("eqc", "conly"),
    "pad_pow2": lambda v: isinstance(v, bool),
    "run_rows": _positive_int,
    "k": _positive_int,
    "wire_mode": _valid_wire_mode,
}


def _sanitize(config: dict) -> dict:
    """Drop unknown or invalid fields (an all-invalid entry becomes {}, a
    miss to every consumer)."""
    return {
        k: v for k, v in config.items()
        if k in _FIELD_VALID and _FIELD_VALID[k](v)
    }


def _lookup(key) -> dict | None:
    config = _cache.lookup(_doc(), key, _keys.fingerprint(key.backend))
    if config is not None:
        config = _sanitize(config)
    return config or None


def _broadcast(config: dict | None, grid, device) -> dict | None:
    """Rank 0's config on every rank of `grid`'s process group."""
    import torch
    import torch.distributed as dist

    box = [json.dumps(config, sort_keys=True) if grid.rank == 0 else None]
    where = torch.device(device) if dist.get_backend(grid.group) == "nccl" else None
    dist.broadcast_object_list(box, src=0, group=grid.group, device=where)
    return json.loads(box[0])


def resolve(op: str, shape, dtype, topology=None, *, device, grid=None) -> dict | None:
    """The winning config of this call site, or None on any miss (unknown
    key, stale fingerprint, unreadable cache). `device` is the device the
    call runs on (a torch.device or its name): its type is the key's
    backend, and over NCCL the broadcast travels there. With `grid` of
    more than one rank in a process group, rank 0 resolves and every rank
    of the grid gets its result (module docstring). Emits one
    `tune.resolve` annotation per distinct outcome and counts hits and
    misses for the run gauges (stats())."""
    key = _keys.tuning_key(op, shape, dtype, topology, device)
    if grid is not None and grid.nprocs > 1 and _distributed():
        config = _broadcast(_lookup(key) if grid.rank == 0 else None, grid, device)
    else:
        config = _lookup(key)
    hit = bool(config)
    if not hit:
        config = None
    _STATE["hits" if hit else "misses"] += 1

    from rocm_mpi_tpu_torch import telemetry

    if telemetry.enabled():
        telemetry.annotate(
            "tune.resolve",
            key=_keys.key_str(key),
            hit=hit,
            config=json.dumps(config, sort_keys=True) if hit else "",
        )
    return config


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def stats() -> dict:
    """Process-cumulative resolve outcomes: {"hits": n, "misses": n}."""
    return {"hits": _STATE["hits"], "misses": _STATE["misses"]}


def reset_stats() -> None:
    _STATE["hits"] = 0
    _STATE["misses"] = 0


def emit_gauges() -> None:
    """Bank the resolve outcomes as `tune.hits` / `tune.misses` run gauges
    (nothing when telemetry is off or nothing was resolved): a tuned run
    and a default run are different measurements, and the gauges say
    which this was."""
    from rocm_mpi_tpu_torch import telemetry

    if not telemetry.enabled():
        return
    s = stats()
    if not (s["hits"] or s["misses"]):
        return
    telemetry.gauge("tune.hits", s["hits"])
    telemetry.gauge("tune.misses", s["misses"])
