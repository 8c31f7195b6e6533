"""Checkpoint/resume with integrity manifests — counterpart of
rocm_mpi_tpu/utils/checkpoint.py.

A long run segments its step budget at checkpoint boundaries
(`run_segmented`): the model's own advance runs between saves, and a
resumed run continues from the latest valid saved step with the same
advance, so its graphs are captured once for the whole run. A state is a
tensor or a nested tuple/list of tensors (the JAX package's pytrees of
the three models: (T,), (U, U⁻), (h, (u0, …))), each leaf this rank's
shard of a field of the process grid (`grid`, a parallel/mesh.GlobalGrid;
None means one rank and the whole field).

Storage, not orbax. Each rank writes its shard of each leaf as
`<dir>/<step>/rank-<r>/leaf-<i>.npy` (bf16, which numpy lacks, as its
16-bit pattern). A save is written under `<dir>/.<step>.partial/` and
renamed to `<dir>/<step>/` by rank 0 once every rank's files are down,
so a step directory is a finished save (orbax's finalize). Rank 0 then
writes the step's manifest atomically, and keeps the newest `keep` steps
(and their manifests). Every collective decision — an I/O error on any
rank, the ENOSPC prune, the slow-save watchdog — is taken on every rank
alike, so the ranks retry, skip or raise together.

Manifest (manifest-<step>.json beside the step directories), the JAX
package's v2 keys with the same meanings:
    {"step": int, "v": 2, "treedef": str,
     "leaves": [{"shape": [global...], "dtype": "...", "crc32": int|null}, ...],
     "files": {"<relpath under the step dir>": size_bytes, ...},
     "meta": {"mesh": {"dims": [...], "axes": [...]},
              "specs": [[axis per array dim] | null, ...], "extra": {...}},
     "shards": [{"rank": r, "coords": [...], "crc32": [per leaf]}, ...]}
`crc32` is over the leaf's row-major bytes, null where no single process
holds the whole leaf (more than one rank); "shards" holds each rank's
crc32 of its shard of every leaf. Validation (`latest_valid_step`,
`verify_step`) compares the file inventory (a truncated, missing or extra
file changes it); `restore_state(verify=True)` re-hashes every shard.

Device state (the port's side of the JAX package's two donation
hazards). A save copies the state to the host only after the device work
that wrote it has ended, before the next segment is enqueued: the scan
driver's slots are the state it returns, and the next segment overwrites
them. A restore returns fresh tensors on the model's device, which alias
no buffer a loop holds (the loop copies them into its slots).

Storage faults run under a `StoragePolicy` (the RMT_CKPT_* variables):
bounded retry with exponential backoff on OSError, ENOSPC prunes every
kept step but the newest valid one and retries, and a save slower than
`slow_save_timeout_s` trips the watchdog. `save_state` stays loud
(retries, then raises); `run_segmented` alone degrades: it skips the
save and keeps computing, probing the storage at later boundaries.

Telemetry, as in the JAX package: every save, restore and validation is
a `checkpoint.save` / `checkpoint.restore` / `checkpoint.validate` span
(the checkpoint phase of the summary); each storage-policy decision is
a `ckpt.retry`, `ckpt.degraded`, `ckpt.recovered` or
`ckpt.enospc-prune` run event; the segmented loop publishes its step to
the flight recorder before each save, and the degraded-storage counters
(`ckpt_degraded`, `ckpt_skipped`, `ckpt_recovered`) the monitor reads.
With telemetry on, the state's device work is waited out before a save
span opens, so the span times the save and not the segment before it.
A `log` callable still receives the policy's lines.

The resilience plane (rocm_mpi_tpu_torch/resilience/), as in the JAX
package:

* fault sites (resilience/faults.py): "save" inside every save attempt
  before any shard is written (an injected OSError is agreed over the grid
  like a real one), "restore" before every restore attempt, and in
  `run_segmented` "segment-pre" after each segment's advance (before the
  flight-recorder bump and the save) and "segment" after each save;
* preemption (resilience/preempt.py): every boundary of `run_segmented`
  polls the SIGTERM notice, agreed over the grid when the ranks armed
  the handler (RMT_PREEMPT_GRACE_S; unarmed ranks of a grid skip the
  gather). When the grace left
  fits the p90 save wall (`save_wall_p90`, the walls this process
  measured) the boundary's save runs as the emergency save and
  `Preempted(step, saved=True)` is raised; otherwise the save is skipped
  outright (`preempt.skip-save`: a save killed mid-write would be a torn
  step) and `Preempted(last durable step, saved=False)` is raised. The
  events: `preempt.noticed`, `preempt.save`, `preempt.save-failed`,
  `preempt.skip-save`, `preempt.stop`;
* restores onto another process grid of the same domain (a run resumed
  on fewer or more ranks, resilience/elastic.py): each rank reads only
  the saved shards that overlap its block of the new grid
  (resilience/reshard.read_block), bit for bit the saved field.
"""

from __future__ import annotations

import collections
import dataclasses
import errno
import json
import os
import pathlib
import shutil
import time
import zlib

import numpy as np
import torch

from rocm_mpi_tpu_torch.telemetry import enabled as _telemetry_enabled
from rocm_mpi_tpu_torch.telemetry import flight as _flight
from rocm_mpi_tpu_torch.telemetry import record_event as _record_event
from rocm_mpi_tpu_torch.telemetry import span

MANIFEST_VERSION = 2


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity validation (manifest mismatch)."""


class TopologyMismatch(ValueError):
    """The restore template contradicts the checkpoint manifest (leaf
    count, global shape, dtype): the process grid may change on resume,
    the global domain may not. A ValueError on purpose: a configuration
    error that reproduces identically, never to be retried."""


# ---------------------------------------------------------------------------
# Storage policy
# ---------------------------------------------------------------------------

_FALSY = ("0", "off", "false", "no", "")

DEFAULT_SAVE_RETRIES = 2
DEFAULT_SAVE_BACKOFF_S = 0.25
DEFAULT_BACKOFF_FACTOR = 2.0
DEFAULT_RESTORE_RETRIES = 2

# The walls (monotonic seconds, the slowest rank's) of this process's
# recent completed saves: what a save costs, the preemption budget's input.
_SAVE_WALLS: collections.deque = collections.deque(maxlen=32)


def save_wall_p90() -> float | None:
    """Interpolating p90 of the recent save walls this process measured
    (None with no history) — the preemption emergency-save budget."""
    if not _SAVE_WALLS:
        return None
    vals = sorted(_SAVE_WALLS)
    if len(vals) == 1:
        return vals[0]
    pos = 0.9 * (len(vals) - 1)
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] * (1 - frac) + vals[hi] * frac


@dataclasses.dataclass
class StoragePolicy:
    """How a save responds to a misbehaving filesystem; `from_env` reads
    the RMT_CKPT_* variables a launcher forwards to its ranks."""

    retries: int = DEFAULT_SAVE_RETRIES
    backoff_s: float = DEFAULT_SAVE_BACKOFF_S
    backoff_factor: float = DEFAULT_BACKOFF_FACTOR
    slow_save_timeout_s: float | None = None
    degrade: bool = True  # run_segmented only: skip the save and continue
    probe_every: int = 1  # degraded mode: attempt every Nth boundary
    sleep: object = time.sleep  # injectable for tests

    @classmethod
    def from_env(cls) -> "StoragePolicy":
        def _num(name, cast, default):
            raw = os.environ.get(name, "").strip()
            if not raw:
                return default
            try:
                return cast(raw)
            except ValueError:
                return default

        return cls(
            retries=_num("RMT_CKPT_RETRIES", int, DEFAULT_SAVE_RETRIES),
            backoff_s=_num("RMT_CKPT_BACKOFF_S", float, DEFAULT_SAVE_BACKOFF_S),
            slow_save_timeout_s=_num("RMT_CKPT_SLOW_S", float, None),
            degrade=os.environ.get("RMT_CKPT_DEGRADE", "1").lower() not in _FALSY,
            probe_every=max(_num("RMT_CKPT_PROBE_EVERY", int, 1), 1),
        )


class _StorageState:
    """One run_segmented loop's bookkeeping: degraded mode, the saves
    the outage has cost, and the last step known durable."""

    def __init__(self, last_durable=None):
        self.degraded = False
        self.skipped = 0
        self.boundaries_degraded = 0
        self.last_durable = last_durable


def _say(log, msg: str) -> None:
    if log is not None:
        log(msg)


def _drain(state) -> None:
    """Telemetry on only: wait out the device work that wrote `state`
    before a checkpoint span opens, so the span times the save, not the
    segment still running."""
    if not _telemetry_enabled():
        return
    from rocm_mpi_tpu_torch.utils.metrics import force

    for leaf in tree_leaves(state):
        force(leaf)


# ---------------------------------------------------------------------------
# States, ranks and collectives
# ---------------------------------------------------------------------------


def tree_leaves(state) -> list:
    """The tensors of `state` (a tensor, or nested tuples/lists), depth
    first."""
    if isinstance(state, (tuple, list)):
        return [leaf for item in state for leaf in tree_leaves(item)]
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"a checkpoint state holds tensors, got {type(state).__name__}")
    return [state]


def _treedef(state) -> str:
    """The state's structure in the JAX package's spelling, e.g.
    "PyTreeDef((*, (*, *)))"."""

    def spell(node):
        if isinstance(node, (tuple, list)):
            inner = ", ".join(spell(x) for x in node)
            if isinstance(node, tuple):
                return f"({inner},)" if len(node) == 1 else f"({inner})"
            return f"[{inner}]"
        return "*"

    return f"PyTreeDef({spell(state)})"


def _unflatten(like, leaves: list):
    """`leaves` arranged as `like`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _distributed() -> bool:
    from rocm_mpi_tpu_torch.parallel import distributed

    return distributed.is_distributed() and distributed.world_size() > 1


def _check_grid(grid):
    """The grid a save or restore describes: `grid`, or None for one
    process holding whole fields. Several ranks need their grid."""
    if grid is None and _distributed():
        raise ValueError("a checkpoint over several ranks needs their process grid "
                         "(grid=model.grid)")
    return grid


def _rank(grid) -> int:
    return 0 if grid is None else grid.rank


def _group(grid):
    return None if grid is None else grid.group


def _gather(obj, grid) -> list:
    """`obj` of every rank of the grid, in rank order, on every rank."""
    if grid is None or grid.nprocs == 1 or not _distributed():
        return [obj]
    import torch.distributed as dist

    out = [None] * grid.nprocs
    dist.all_gather_object(out, obj, group=_group(grid))
    return out


def _from_rank0(obj, grid):
    """Rank 0's `obj`, on every rank of the grid."""
    if grid is None or grid.nprocs == 1 or not _distributed():
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_group(grid))
    return box[0]


def _barrier(grid) -> None:
    if grid is not None and grid.nprocs > 1 and _distributed():
        from rocm_mpi_tpu_torch.parallel import distributed

        distributed.barrier(_group(grid))


def _agree(err: OSError | None, grid) -> None:
    """Raise on every rank the first rank's OSError, if any rank had one:
    every rank then retries, prunes, degrades or raises alike."""
    seen = _gather(None if err is None else (err.errno, str(err)), grid)
    for rank, got in enumerate(seen):
        if got is not None:
            if rank == _rank(grid) and err is not None:
                raise err
            code, text = got
            raise OSError(code, f"rank {rank}: {text}")


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def _manifest_path(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"manifest-{int(step)}.json"


def _step_dir(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / str(int(step))


def _partial_dir(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f".{int(step)}.partial"


def _leaf_file(rank: int, i: int) -> str:
    return f"rank-{rank}/leaf-{i}.npy"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).rpartition(".")[2]


def _layout(leaves, grid):
    """(mesh dims, axis names, spec and global shape per leaf): a leaf of
    the grid's local shape is sharded over every grid axis; any other
    leaf is whole on every rank (spec None)."""
    from rocm_mpi_tpu_torch.parallel.mesh import AXIS_NAMES

    if grid is None:
        ndim = leaves[0].ndim
        dims, local = (1,) * ndim, tuple(leaves[0].shape)
    else:
        dims, local = grid.dims, grid.local_shape
    axes = AXIS_NAMES[:len(dims)]
    specs, shapes = [], []
    for leaf in leaves:
        if tuple(leaf.shape) == tuple(local):
            specs.append(list(axes))
            shapes.append([n * d for n, d in zip(leaf.shape, dims)])
        else:
            specs.append(None)
            shapes.append(list(leaf.shape))
    return list(dims), list(axes), specs, shapes


def _to_host(leaves) -> list:
    """Each leaf as a C-contiguous numpy array (bf16 as uint16), copied
    after the device work that wrote it has ended."""
    from rocm_mpi_tpu_torch.utils.metrics import force

    out = []
    for t in leaves:
        force(t)
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            out.append(t.view(torch.int16).numpy().view(np.uint16))
        else:
            out.append(t.numpy())
    return out


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _write_array(path: pathlib.Path, a: np.ndarray) -> None:
    """Write one shard file: to a temporary name, then renamed."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.save(f, a, allow_pickle=False)
    os.replace(tmp, path)


def _read_array(path: pathlib.Path) -> np.ndarray:
    return np.load(path, allow_pickle=False)


def _file_inventory(step_dir: pathlib.Path) -> dict:
    return {
        str(p.relative_to(step_dir)): p.stat().st_size
        for p in sorted(step_dir.rglob("*"))
        if p.is_file()
    }


# ---------------------------------------------------------------------------
# Saves
# ---------------------------------------------------------------------------


def _clean_partial_save(directory, step, grid) -> None:
    """Remove what a failed save attempt may have left (its partial
    directory, or a step directory without a manifest)."""
    if _rank(grid) == 0:
        shutil.rmtree(_partial_dir(directory, step), ignore_errors=True)
        step_dir = _step_dir(directory, step)
        if step_dir.exists() and not _manifest_path(directory, step).is_file():
            shutil.rmtree(step_dir, ignore_errors=True)
    _barrier(grid)


def _prune_kept(directory, keep: int) -> None:
    """Keep the newest `keep` steps; delete the others and their
    manifests, and any manifest whose step is gone."""
    root = pathlib.Path(directory)
    for step in all_steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
        _manifest_path(directory, step).unlink(missing_ok=True)
    for path in root.glob("manifest-*.json"):
        step = path.stem.rpartition("-")[2]
        if step.isdigit() and not (root / step).is_dir():
            path.unlink(missing_ok=True)


def _prune_for_space(directory, grid) -> list:
    """ENOSPC response: delete every kept step except the newest valid
    one. Returns the pruned steps (rank 0's, on every rank)."""
    pruned = []
    if _rank(grid) == 0:
        steps = all_steps(directory)
        keep_newest = next((s for s in reversed(steps) if verify_step(directory, s)[0]),
                           None)
        for step in steps:
            if step == keep_newest:
                continue
            shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
            _manifest_path(directory, step).unlink(missing_ok=True)
            pruned.append(step)
    return _from_rank0(pruned, grid)


def _save_once(directory, step, state, grid, keep: int) -> float:
    """One save attempt on every rank: the shards to host, each rank's
    files under the partial directory, then (rank 0) the rename, the
    manifest and the keep-list. Returns the slowest rank's wall; raises
    OSError on every rank when any rank's write failed, an injected
    storage fault at the "save" site included."""
    from rocm_mpi_tpu_torch.resilience import faults

    t0 = time.monotonic()
    leaves = tree_leaves(state)
    hosts = _to_host(leaves)
    rank = _rank(grid)
    partial = _partial_dir(directory, step)
    err = None
    try:
        faults.fault_point("save", step=step, directory=directory)
        for i, a in enumerate(hosts):
            path = partial / _leaf_file(rank, i)
            path.parent.mkdir(parents=True, exist_ok=True)
            _write_array(path, a)
    except OSError as exc:
        err = exc
    _agree(err, grid)
    coords = [0] * leaves[0].ndim if grid is None else list(grid.coords)
    shards = _gather({"rank": rank, "coords": coords, "crc32": [_crc(a) for a in hosts]},
                     grid)
    if rank == 0:
        err = None
        try:
            step_dir = _step_dir(directory, step)
            shutil.rmtree(step_dir, ignore_errors=True)
            _manifest_path(directory, step).unlink(missing_ok=True)
            os.replace(partial, step_dir)
            write_manifest(directory, step, state, grid=grid, shards=shards)
            _prune_kept(directory, keep)
        except OSError as exc:
            err = exc
    _agree(err if rank == 0 else None, grid)
    wall = max(_gather(time.monotonic() - t0, grid))
    _SAVE_WALLS.append(wall)
    return wall


def _retrying_save(directory, step, state, policy: StoragePolicy, grid, keep: int,
                   log=None) -> float:
    """Save with the policy's bounded retry and backoff, and ENOSPC
    pruning. Returns the last attempt's wall; raises the last OSError
    when every attempt failed."""
    attempt = 0
    pruned = False
    while True:
        try:
            return _save_once(directory, step, state, grid, keep)
        except OSError as exc:
            _clean_partial_save(directory, step, grid)
            err = f"{type(exc).__name__}: {exc}"
            if getattr(exc, "errno", None) == errno.ENOSPC and not pruned:
                pruned = True
                freed = _prune_for_space(directory, grid)
                _record_event("ckpt.enospc-prune", step=int(step), pruned_steps=freed)
                _say(log, f"checkpoint step {step}: ENOSPC — pruned kept step(s) {freed} "
                     "to make room, retrying")
                if freed:
                    continue  # space freed: retry without spending an attempt
            if attempt >= policy.retries:
                raise
            wait = policy.backoff_s * policy.backoff_factor**attempt
            _record_event("ckpt.retry", step=int(step), attempt=attempt, wait_s=wait,
                          error=err)
            _say(log, f"checkpoint step {step}: save attempt {attempt} failed ({err}); "
                 f"retrying in {wait:.2f}s")
            policy.sleep(wait)
            attempt += 1


def _guarded_save(directory, step, state, policy: StoragePolicy, st: _StorageState,
                  grid, keep: int, log=None) -> bool:
    """The segmented loop's save: `_retrying_save` plus degraded mode.
    Returns whether `step` is durable on disk. In degraded mode (retries
    exhausted, or the slow-save watchdog tripped) each boundary makes at
    most one attempt (every `probe_every`th boundary); a fast success
    leaves degraded mode, anything else skips the save."""
    if st.degraded:
        st.boundaries_degraded += 1
        if policy.probe_every > 1 and st.boundaries_degraded % policy.probe_every:
            st.skipped += 1
            _record_event("ckpt.degraded", step=int(step), reason="skip",
                          skipped=st.skipped, last_valid_step=st.last_durable)
            _flight.progress(ckpt_skipped=1)
            _say(log, f"checkpoint step {step}: storage degraded, save skipped (last valid "
                 f"step {st.last_durable})")
            return False
        try:
            wall = _save_once(directory, step, state, grid, keep)
        except OSError as exc:
            _clean_partial_save(directory, step, grid)
            st.skipped += 1
            _record_event("ckpt.degraded", step=int(step), reason="probe-failed",
                          error=f"{type(exc).__name__}: {exc}", skipped=st.skipped,
                          last_valid_step=st.last_durable)
            _flight.progress(ckpt_skipped=1)
            _say(log, f"checkpoint step {step}: storage still degraded ({exc}); continuing "
                 f"without a save (last valid step {st.last_durable})")
            return False
        st.last_durable = int(step)
        if policy.slow_save_timeout_s is not None and wall > policy.slow_save_timeout_s:
            _record_event("ckpt.degraded", step=int(step), reason="io-slow", wall_s=wall,
                          skipped=st.skipped, last_valid_step=st.last_durable)
            _say(log, f"checkpoint step {step}: save took {wall:.2f}s, storage still slow")
            return True  # durable, but the storage still crawls
        st.degraded = False
        _record_event("ckpt.recovered", step=int(step), skipped=st.skipped)
        # The monitor's degraded-storage badge compares the cumulative
        # counters; the recovery bump clears it, flushed now.
        _flight.progress(ckpt_recovered=1)
        _flight.flush()
        _say(log, f"checkpoint step {step}: storage recovered after {st.skipped} skipped "
             "save(s)")
        st.skipped = 0
        st.boundaries_degraded = 0
        return True

    try:
        wall = _retrying_save(directory, step, state, policy, grid, keep, log=log)
    except OSError as exc:
        if not policy.degrade:
            raise
        st.degraded = True
        st.skipped += 1
        _record_event("ckpt.degraded", step=int(step), reason="io-error",
                      error=f"{type(exc).__name__}: {exc}", skipped=st.skipped,
                      last_valid_step=st.last_durable)
        _flight.progress(ckpt_degraded=1, ckpt_skipped=1)
        _flight.flush()
        _say(log, f"checkpoint step {step}: save failed after {policy.retries + 1} "
             f"attempt(s) ({exc}); entering DEGRADED mode — compute continues, loss "
             f"bounded by step {st.last_durable}")
        return False
    st.last_durable = int(step)
    if policy.slow_save_timeout_s is not None and wall > policy.slow_save_timeout_s:
        st.degraded = True
        _record_event("ckpt.degraded", step=int(step), reason="io-slow", wall_s=wall,
                      timeout_s=policy.slow_save_timeout_s, last_valid_step=st.last_durable)
        _flight.progress(ckpt_degraded=1)
        _flight.flush()
        _say(log, f"checkpoint step {step}: save took {wall:.2f}s (> "
             f"{policy.slow_save_timeout_s:.2f}s watchdog); entering DEGRADED mode")
    return True


def write_manifest(directory, step: int, state, extra_meta=None, *, grid=None,
                   shards=None) -> None:
    """Record the integrity manifest of the finished save of `state` at
    `step` (rank 0 only; the other ranks return). `shards` is every
    rank's {"rank", "coords", "crc32"} record, in rank order; None
    hashes `state` here (one process)."""
    grid = _check_grid(grid)
    if _rank(grid) != 0:
        return
    leaves = tree_leaves(state)
    if shards is None:
        shards = [{"rank": 0, "coords": [0] * leaves[0].ndim,
                   "crc32": [_crc(a) for a in _to_host(leaves)]}]
    dims, axes, specs, shapes = _layout(leaves, grid)
    whole = len(shards) == 1
    meta = {"mesh": {"dims": dims, "axes": axes}, "specs": specs}
    if extra_meta:
        meta["extra"] = dict(extra_meta)
    manifest = {
        "step": int(step),
        "v": MANIFEST_VERSION,
        "treedef": _treedef(state),
        "leaves": [{"shape": shape, "dtype": _dtype_name(leaf),
                    "crc32": shards[0]["crc32"][i] if whole or spec is None else None}
                   for i, (leaf, shape, spec) in enumerate(zip(leaves, shapes, specs))],
        "files": _file_inventory(_step_dir(directory, step)),
        "meta": meta,
        "shards": shards,
    }
    path = _manifest_path(directory, step)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(manifest, indent=1))
    tmp.replace(path)  # atomic: a crash mid-write cannot half-publish


def read_manifest(directory, step: int) -> dict | None:
    path = _manifest_path(directory, step)
    if not path.is_file():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None  # unreadable or truncated manifest = no manifest


def validate_manifest_meta(manifest: dict) -> list[str]:
    """Structural validation of a manifest's topology metadata: problem
    strings, empty when it is sound (or absent)."""
    meta = manifest.get("meta")
    if meta is None:
        return []
    problems: list[str] = []
    if not isinstance(meta, dict):
        return ["meta: not a mapping"]
    mesh = meta.get("mesh")
    if not isinstance(mesh, dict):
        problems.append("meta.mesh: missing or not a mapping")
        mesh = {}
    dims = mesh.get("dims")
    axes = mesh.get("axes")
    if not (isinstance(dims, list) and dims
            and all(isinstance(d, int) and d >= 1 for d in dims)):
        problems.append(f"meta.mesh.dims: want positive ints, got {dims!r}")
        dims = []
    if not (isinstance(axes, list) and all(isinstance(a, str) for a in axes)
            and len(axes) == len(dims)):
        problems.append(f"meta.mesh.axes: want {len(dims)} axis name(s), got {axes!r}")
        axes = []
    leaves = manifest.get("leaves", [])
    specs = meta.get("specs")
    if not isinstance(specs, list) or len(specs) != len(leaves):
        problems.append(
            f"meta.specs: want one spec per leaf ({len(leaves)}), got "
            f"{len(specs) if isinstance(specs, list) else specs!r}"
        )
        specs = []
    by_axis = dict(zip(axes, dims))
    for i, (rec, spec) in enumerate(zip(leaves, specs)):
        if spec is None:
            continue
        shape = rec.get("shape", [])
        if not isinstance(spec, list) or len(spec) != len(shape):
            problems.append(f"meta.specs[{i}]: want {len(shape)} entr(ies), got {spec!r}")
            continue
        for d, (size, entry) in enumerate(zip(shape, spec)):
            if entry is None:
                continue
            names = entry if isinstance(entry, list) else [entry]
            factor = 1
            for name in names:
                if name not in by_axis:
                    problems.append(f"meta.specs[{i}][{d}]: unknown mesh axis {name!r}")
                    break
                factor *= by_axis[name]
            else:
                if isinstance(size, int) and size % factor:
                    problems.append(f"meta.specs[{i}][{d}]: global size {size} not "
                                    f"divisible by mesh factor {factor}")
    return problems


def verify_step(directory, step: int) -> tuple[bool, str]:
    """Validate the checkpoint at `step` against its manifest without
    restoring it: the step directory's files must match the manifest's
    inventory in names and sizes (every rank's shards). Returns (ok,
    reason); a step without a manifest reports (False, "no manifest")."""
    with span("checkpoint.validate", step=int(step)):
        return _verify_step(directory, step)


def _verify_step(directory, step: int) -> tuple[bool, str]:
    step_dir = _step_dir(directory, step)
    if not step_dir.is_dir():
        return False, f"step dir {step_dir} missing"
    manifest = read_manifest(directory, step)
    if manifest is None:
        return False, "no manifest"
    if manifest.get("step") != int(step):
        return False, f"manifest step field {manifest.get('step')} != {step}"
    want = manifest.get("files", {})
    have = _file_inventory(step_dir)
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        resized = sorted(k for k in set(want) & set(have) if want[k] != have[k])
        return False, (f"file inventory mismatch (missing={missing[:3]}, "
                       f"extra={extra[:3]}, resized={resized[:3]})")
    meta_problems = validate_manifest_meta(manifest)
    if meta_problems:
        return False, (f"topology metadata failed validation ({meta_problems[0]}"
                       + (f", +{len(meta_problems) - 1} more" if len(meta_problems) > 1
                          else "") + ")")
    return True, "ok"


def all_steps(directory) -> list:
    """Every finished save's step in `directory`, ascending."""
    path = pathlib.Path(directory)
    if not path.is_dir():
        return []
    return sorted(int(d.name) for d in path.iterdir() if d.is_dir() and d.name.isdigit())


def latest_step(directory) -> int | None:
    """The newest saved step in `directory` (no validation), or None.
    Prefer latest_valid_step for resume decisions."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def latest_valid_step(directory, log=None, *, grid=None) -> int | None:
    """The newest saved step that passes integrity validation, falling
    back through older kept steps past corrupt or truncated ones; `log`
    receives one line per rejected step. Rank 0 of the grid decides and
    every rank returns its answer, so every rank resumes the same step.

    A step without a manifest counts only when the directory has no
    manifest at all (legacy); otherwise it is an unfinished save."""
    if _rank(grid) != 0:
        return _from_rank0(None, grid)
    steps = all_steps(directory)
    found = None
    legacy = not any(_manifest_path(directory, s).is_file() for s in steps)
    for step in reversed(steps):
        ok, reason = verify_step(directory, step)
        if ok or (legacy and reason == "no manifest"):
            found = step
            break
        _say(log, f"checkpoint step {step} failed validation ({reason}); falling back to "
             "the previous kept step")
    return _from_rank0(found, grid)


def save_state(directory, step: int, state, keep: int = 3,
               storage: StoragePolicy | None = None, *, grid=None, log=None) -> None:
    """Save `state` (this rank's shards; every rank of `grid` calls it)
    labelled by absolute step count, then record its manifest. Runs under
    the storage policy (default StoragePolicy.from_env): transient
    OSErrors retry with backoff, ENOSPC prunes the keep-list first, and
    exhausted retries raise."""
    grid = _check_grid(grid)
    policy = storage or StoragePolicy.from_env()
    _drain(state)
    with span("checkpoint.save", step=int(step)):
        _retrying_save(directory, step, state, policy, grid, keep, log=log)


# ---------------------------------------------------------------------------
# Restores
# ---------------------------------------------------------------------------


def _check_like_against_manifest(like, manifest, step, grid) -> None:
    """TopologyMismatch when `like` contradicts the manifest's global
    facts: leaf count, global shape, dtype."""
    leaves = tree_leaves(like)
    want = manifest.get("leaves", [])
    if len(want) != len(leaves):
        raise TopologyMismatch(
            f"step {step}: template has {len(leaves)} leaves, manifest records "
            f"{len(want)} — was this checkpoint written by a different workload/state "
            "layout?")
    _, _, _, shapes = _layout(leaves, grid)
    for i, (leaf, shape, rec) in enumerate(zip(leaves, shapes, want)):
        saved = tuple(int(n) for n in rec.get("shape", []))
        if tuple(shape) != saved:
            raise TopologyMismatch(
                f"step {step} leaf {i}: template global shape {tuple(shape)} != "
                f"checkpointed {saved} — the global domain may not change on resume")
        if _dtype_name(leaf) != rec.get("dtype"):
            raise TopologyMismatch(f"step {step} leaf {i}: template dtype "
                                   f"{_dtype_name(leaf)} != checkpointed {rec.get('dtype')}")


def _tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def restore_state(directory, step: int, like=None, verify: bool = True, devices=None, *,
                  grid=None, log=None):
    """Restore the state saved at `step` as this rank's shards, fresh
    tensors on the model's device: `like`'s device, else `devices` (a
    device or its name; None means the GPU, as every entry point).

    `like` (the freshly initialised state) gives the structure, and must
    agree with the manifest's leaf count, global shapes and dtypes, else
    TopologyMismatch. With `like=None` the manifest alone rebuilds the
    state (resilience/reshard.template_from_meta), returned as a tuple of
    leaves in tree order. The process grid may differ from the one saved:
    each rank then reads only the saved shards that overlap its block
    (resilience/reshard.read_block); the global domain may not change.

    verify=True re-hashes every shard read against the manifest and raises
    CheckpointCorruptionError on a mismatch. Transient OSErrors while
    reading (the "restore" fault site fires before each attempt) retry
    with backoff."""
    with span("checkpoint.restore", step=int(step)):
        return _restore_body(directory, step, like, verify, devices, grid, log)


def _restore_body(directory, step, like, verify, devices, grid, log):
    from rocm_mpi_tpu_torch.resilience import faults, reshard
    from rocm_mpi_tpu_torch.utils.backend import resolve_device

    grid = _check_grid(grid)
    manifest = read_manifest(directory, step)
    if like is None and (manifest is None or not manifest.get("meta")):
        raise TopologyMismatch(
            f"step {step}: template-less restore needs a manifest with topology "
            "metadata (v2) — pass `like` (the freshly-initialized state)")
    moved = False  # restoring onto another process grid than the one saved
    if manifest is not None:
        problems = validate_manifest_meta(manifest)
        if problems:
            raise CheckpointCorruptionError(
                f"step {step}: topology metadata failed validation: {problems[0]}")
        saved_dims = manifest["meta"]["mesh"]["dims"] if manifest.get("meta") else None
        here = list(grid.dims) if grid is not None else None
        if like is not None:
            _check_like_against_manifest(like, manifest, step, grid)
            here = here or _layout(tree_leaves(like), None)[0]
        elif here is None:
            here = [1] * len(saved_dims)
        moved = saved_dims is not None and list(saved_dims) != list(here)
    if like is not None:
        leaves_like = tree_leaves(like)
        device = leaves_like[0].device
        dtypes = [_dtype_name(t) for t in leaves_like]
    else:
        device = resolve_device(devices)
        try:
            template = reshard.template_from_meta(manifest, grid)
        except ValueError as exc:
            raise TopologyMismatch(f"step {step}: {exc}") from None
        dtypes = [_dtype_name(t) for t in template]
    rank = _rank(grid)
    step_dir = _step_dir(directory, step)
    attempt = 0
    while True:
        try:
            faults.fault_point("restore", step=int(step), directory=directory)
            if moved:
                hosts = reshard.read_block(directory, step, manifest, grid, verify=verify)
            else:
                hosts = [_read_array(step_dir / _leaf_file(rank, i))
                         for i in range(len(dtypes))]
            break
        except OSError as exc:
            if attempt >= DEFAULT_RESTORE_RETRIES:
                raise
            wait = DEFAULT_SAVE_BACKOFF_S * DEFAULT_BACKOFF_FACTOR**attempt
            _record_event("ckpt.retry", step=int(step), attempt=attempt, wait_s=wait,
                          op="restore", error=f"{type(exc).__name__}: {exc}")
            _say(log, f"checkpoint step {step}: restore attempt {attempt} failed "
                 f"({type(exc).__name__}: {exc}); retrying in {wait:.2f}s")
            time.sleep(wait)
            attempt += 1
    if moved:
        # read_block checked each shard it read against its crc32, and cut
        # this rank's block of the new grid.
        tensors = [_tensor(a, name, device) for a, name in zip(hosts, dtypes)]
        return tuple(tensors) if like is None else _unflatten(like, tensors)
    if manifest is not None:
        recs = manifest.get("leaves", [])
        if len(recs) != len(hosts):
            raise CheckpointCorruptionError(f"step {step}: manifest records {len(recs)} leaves, "
                                 f"restored {len(hosts)}")
        dims = manifest["meta"]["mesh"]["dims"] if manifest.get("meta") else None
        specs = manifest["meta"]["specs"] if manifest.get("meta") else [None] * len(recs)
        for i, (a, rec, spec) in enumerate(zip(hosts, recs, specs)):
            want = [n // d for n, d in zip(rec["shape"], dims)] if spec else rec["shape"]
            if list(a.shape) != list(want):
                raise CheckpointCorruptionError(f"step {step} leaf {i}: rank {rank}'s shard has shape "
                                     f"{list(a.shape)}, manifest implies {want}")
        if verify:
            shard = next((s for s in manifest.get("shards", []) if s["rank"] == rank), None)
            for i, a in enumerate(hosts):
                crc = _crc(a)
                want = shard["crc32"][i] if shard is not None else recs[i].get("crc32")
                if want is not None and crc != want:
                    raise CheckpointCorruptionError(f"step {step} leaf {i}: crc32 {crc} != manifest "
                                         f"{want} — restored data is corrupt")
    tensors = [_tensor(a, name, device) for a, name in zip(hosts, dtypes)]
    if like is None:
        return tuple(tensors)
    return _unflatten(like, tensors)


# ---------------------------------------------------------------------------
# The segmented loop
# ---------------------------------------------------------------------------


def run_segmented(advance, state, nt: int, directory, every: int, start_step: int = 0,
                  keep: int = 3, storage: StoragePolicy | None = None, *, grid=None,
                  log=None):
    """Advance `state` by `nt - start_step` steps, checkpointing every
    `every` steps (and at the end); returns the final state.
    `advance(state, n) -> state` must run exactly n steps for any n, the
    same advance for every segment (the scan driver with exact=True, a
    schedule's sweep loop, or the step driver). Each save completes —
    the state on the host — before the next segment is enqueued.

    Saves run under `storage` (default StoragePolicy.from_env): a storage
    outage costs checkpoints, never the run (degraded mode). `log`
    receives the policy's lines.

    Each boundary, in order: the "segment-pre" fault site, the flight
    recorder's step (before any collective of the boundary: a rank wedged
    in one has published it), the preemption poll (module docstring;
    raises `resilience.preempt.Preempted`, a SystemExit with code 75),
    the save, the "segment" fault site, and the poll again (a notice that
    landed during the save stops the run at the step just saved).

    Resume idiom (what the apps' --resume does):

        start = latest_valid_step(dir, grid=grid) or 0
        state = restore_state(dir, start, init_state, grid=grid) if start else init_state
        state = run_segmented(advance, state, nt, dir, every, start, grid=grid)
    """
    if every < 1:
        raise ValueError(f"checkpoint interval must be >= 1, got {every}")
    if not 0 <= start_step <= nt:
        raise ValueError(f"need 0 <= start_step <= nt, got {start_step}, {nt}")
    from rocm_mpi_tpu_torch.resilience import faults

    grid = _check_grid(grid)
    policy = storage or StoragePolicy.from_env()
    st = _StorageState(last_durable=start_step if start_step else None)
    if _rank(grid) == 0:
        pathlib.Path(directory).mkdir(parents=True, exist_ok=True)
    _barrier(grid)
    step = start_step
    while step < nt:
        n = min(every, nt - step)
        state = advance(state, n)
        step += n
        _drain(state)
        # Opt-in site: after the segment, before the progress bump and the
        # save's collectives — a rank stalled here lags the step its peers
        # are about to publish, which is how the watchdog names it.
        faults.fault_point("segment-pre", step=step, directory=directory)
        # The step this rank reached goes to the flight recorder before the
        # boundary's collectives: a rank wedged in them has published it.
        _flight.progress(step=step)
        notice = _preempt_notice(grid)
        if notice is not None:
            _preempted_boundary(directory, step, state, grid, keep, st, notice)
        with span("checkpoint.save", step=step):
            durable = _guarded_save(directory, step, state, policy, st, grid, keep, log=log)
        faults.fault_point("segment", step=step, directory=directory)
        notice = _preempt_notice(grid)
        if notice is not None:
            # The notice landed during the save or the post-save site: the
            # boundary just published is the resume point.
            from rocm_mpi_tpu_torch.resilience import preempt

            _note_notice(step, notice)
            _record_event("preempt.stop", step=step, saved=bool(durable),
                          last_valid_step=st.last_durable)
            raise preempt.Preempted(step if durable else st.last_durable, saved=bool(durable))
    return state


def _preempt_notice(grid) -> tuple[float | None, float | None] | None:
    """The grid's preemption notice at a boundary: None when no rank holds
    one, else (the least grace left of the ranks that hold one, the
    largest p90 save wall of any rank). One gather over the grid, so every
    rank stops at the same boundary and makes the same save decision;
    none on a grid whose ranks armed no SIGTERM handler (every rank has
    the launcher's environment, so all armed or none did)."""
    from rocm_mpi_tpu_torch.resilience import preempt

    if not preempt.armed() and grid is not None and grid.nprocs > 1 and _distributed():
        return None
    mine = (preempt.requested(), preempt.remaining_grace_s(), save_wall_p90())
    seen = _gather(mine, grid)
    if not any(r for r, _, _ in seen):
        return None
    graces = [g for r, g, _ in seen if r and g is not None]
    walls = [w for _, _, w in seen if w is not None]
    return (min(graces) if graces else None, max(walls) if walls else None)


def _note_notice(step: int, notice) -> None:
    from rocm_mpi_tpu_torch.resilience import preempt

    if preempt.note_noticed() or not preempt.requested():
        # The first boundary to see the notice (a rank without a notice of
        # its own learns of it here, from the grid).
        _record_event("preempt.noticed", step=step, remaining_grace_s=notice[0])


def _preempted_boundary(directory, step, state, grid, keep, st, notice) -> None:
    """A boundary with a preemption notice: the emergency save when the
    grace fits the p90 save wall, else no save; raises Preempted."""
    from rocm_mpi_tpu_torch.resilience import preempt

    _note_notice(step, notice)
    remaining, p90 = notice
    if not preempt.budget_allows_save(p90, remaining_s=remaining):
        _record_event("preempt.skip-save", step=step, remaining_grace_s=remaining,
                      save_wall_p90_s=p90, last_valid_step=st.last_durable)
        raise preempt.Preempted(st.last_durable, saved=False)
    # The emergency save is the boundary's save, deadline-shaped: one
    # attempt, no backoff.
    _record_event("preempt.save", step=step, remaining_grace_s=remaining, save_wall_p90_s=p90)
    try:
        with span("checkpoint.save", step=step):
            _save_once(directory, step, state, grid, keep)
    except OSError as exc:
        _clean_partial_save(directory, step, grid)
        _record_event("preempt.save-failed", step=step, error=f"{type(exc).__name__}: {exc}",
                      last_valid_step=st.last_durable)
        raise preempt.Preempted(st.last_durable, saved=False) from None
    raise preempt.Preempted(step, saved=True)
