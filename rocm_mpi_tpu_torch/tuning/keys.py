"""The tuning key — counterpart of rocm_mpi_tpu/tuning/keys.py: what a
tuned kernel configuration is keyed by.

    TuningKey(op, shape_class, dtype, topology, backend)

* `op`          — the tunable entry point, "workload.family" spelled
                  (KNOWN_OPS: the JAX package's eight, in its order).
* `shape_class` — the per-shard field shape, "252x252" spelled: exact
                  shapes, since admission (the budgets of ops/multistep.py)
                  is shape-exact.
* `dtype`       — the storage dtype short name ("f32"/"bf16"/"f64").
* `topology`    — the process grid's dims, "2x2" spelled ("1x1" = one rank).
* `backend`     — the torch device type the call runs on, "cuda" or
                  "cpu", read from that device and never from a global: a
                  CPU-searched entry must never steer a card run, nor the
                  reverse.

`key_str` is the on-disk spelling "op|shape|dtype|topology|backend",
the JAX package's, parsed back by `parse_key`. The cache entry's
`fingerprint()` is {"torch": torch.__version__, "backend": …}, where
the JAX package writes {"jax", "backend"}: an entry the JAX package
wrote has no "torch" and is a miss here, never an error.

stdlib-only apart from `fingerprint` (torch's version) and dtype
instances handed in by callers: the validate CLI reads keys alone.
"""

from __future__ import annotations

from typing import NamedTuple

CACHE_VERSION = 1
CACHE_KIND = "rmt-tuning-cache"

# The tunable ops, in the canonical search order (the CLI iterates this).
KNOWN_OPS = (
    "diffusion.vmem_loop",
    "wave.vmem_loop",
    "swe.vmem_loop",
    "diffusion.masked_step",
    "diffusion.deep",
    "diffusion.scan",
    "wave.scan",
    "swe.scan",
)

BACKENDS = ("cuda", "cpu")

_DTYPE_NAMES = {
    "float32": "f32", "float64": "f64", "bfloat16": "bf16",
    "f32": "f32", "f64": "f64", "bf16": "bf16",
}


class TuningKey(NamedTuple):
    op: str
    shape_class: str
    dtype: str
    topology: str
    backend: str


def dtype_name(dtype) -> str:
    """The short spelling of a dtype name ("float32", "f32") or a torch
    dtype (torch.float32)."""
    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    try:
        return _DTYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"unsupported tuning dtype {name!r}") from None


def shape_class(shape) -> str:
    return "x".join(str(int(n)) for n in shape)


def topology_class(dims) -> str:
    if isinstance(dims, str):
        return dims
    return "x".join(str(int(d)) for d in dims)


def parse_dims(cls: str) -> tuple[int, ...]:
    """Inverse of shape_class/topology_class ("252x252" -> (252, 252))."""
    try:
        dims = tuple(int(p) for p in cls.split("x"))
    except ValueError:
        raise ValueError(f"malformed shape/topology class {cls!r}") from None
    if not dims or any(d < 1 for d in dims):
        raise ValueError(f"malformed shape/topology class {cls!r}")
    return dims


def backend_of(device) -> str:
    """The key's backend from a device ("cuda", "cpu", "cuda:1" or a
    torch.device): its type."""
    kind = device if isinstance(device, str) else getattr(device, "type", None)
    kind = str(kind).split(":", 1)[0]
    if kind not in BACKENDS:
        raise ValueError(f"tuning backend must be one of {BACKENDS}, got {device!r}")
    return kind


def tuning_key(op: str, shape, dtype, topology=None, backend=None) -> TuningKey:
    """The key of one tunable call site. `topology=None` means one rank,
    (1,)*ndim. `backend` is the device the call runs on (a device or its
    type); there is no default, since the port keeps no global device."""
    if op not in KNOWN_OPS:
        raise ValueError(f"unknown tunable op {op!r}; known: {KNOWN_OPS}")
    if backend is None:
        raise ValueError("tuning_key needs the device the call runs on (backend)")
    shape = tuple(int(n) for n in shape)
    if topology is None:
        topology = (1,) * len(shape)
    return TuningKey(
        op=op,
        shape_class=shape_class(shape),
        dtype=dtype_name(dtype),
        topology=topology_class(topology),
        backend=backend_of(backend),
    )


def key_str(key: TuningKey) -> str:
    return "|".join(key)


def parse_key(s: str) -> TuningKey:
    """Parse the on-disk spelling; raises ValueError on a malformed key."""
    parts = s.split("|")
    if len(parts) != 5 or not all(parts):
        raise ValueError(f"malformed tuning key {s!r} (want 5 '|' fields)")
    key = TuningKey(*parts)
    if key.op not in KNOWN_OPS:
        raise ValueError(f"unknown tunable op in key {s!r}")
    parse_dims(key.shape_class)
    parse_dims(key.topology)
    return key


def fingerprint(backend) -> dict:
    """The cache entry's fingerprint: the torch that ran the measured
    programs, and the backend it ran them on."""
    import torch

    return {"torch": torch.__version__, "backend": backend_of(backend)}
