"""Legal config-space enumeration, admission-filtered — counterpart of
rocm_mpi_tpu/tuning/space.py.

`enumerate_space(op, shape, dtype, backend)` returns the ordered
candidates the search measures. Admission takes the port's own budget
(ops/multistep.py `_VMEM_BLOCK_BUDGET_BYTES`, the JAX package's value),
so the port routes every candidate as the JAX package does; the striped
slab budget bounded only `tm`, which the port has not. The order is
canonical (defaults first, then ascending knob values): the search's
tie-break is "earlier candidate wins".

The knobs per op family, the JAX package's:

* `*.vmem_loop`   — the chunk a launch (16, 64, 256; only 16 past 256 KB,
                    and on the CPU); diffusion adds `body_form`
                    (eqc/conly) and `pad_pow2`. Chunks stay >= 4: below,
                    the kernel takes another body form.
* `diffusion.deep` — the sweep depth k (4, 8, 16, 32, at most the
                    smallest shard edge) and the state exchange's
                    `wire_mode`, f32 first.
* `*.scan`        — the scan driver's chunk q (16, 64, 256).

One knob differs: `diffusion.masked_step`. The TPU kernel's stripe
height `tm` has no counterpart in the port's kernel, whose warps each
walk a run of rows (csrc/stencil.cu, `kMsRunRows` = 4). Its knob is
that run's length, `{"run_rows": r}` for r = 1, 2, 4, at fields the VMEM
loop would not serve (JAX's rule). A warp's registers hold its rows, so
no slab budget applies.

The Hopper knobs (the cluster size of ops/resident.py, the graph length
models/scan.GRAPH_STEP_CAP, b_width) are not in the JAX package's space
and stay out of this one.
"""

from __future__ import annotations

_CHUNKS = (16, 64, 256)
_SCAN_CHUNKS = (16, 64, 256)
_DEEP_KS = (4, 8, 16, 32)
# The masked_step kernel's run lengths (csrc/stencil.cu kMsRunRows = 4 the
# longest).
_RUN_ROWS = (1, 2, 4)


def _vmem_budget() -> int:
    from rocm_mpi_tpu_torch.ops.multistep import _VMEM_BLOCK_BUDGET_BYTES

    return _VMEM_BLOCK_BUDGET_BYTES


def compute_itemsize(dtype_name: str) -> int:
    """The compute width of a key's dtype: bf16 is computed at f32 width,
    so every budget is taken at >= 4 bytes (multistep._compute_itemsize)."""
    storage = {"f32": 4, "f64": 8, "bf16": 2}
    try:
        return max(storage[dtype_name], 4)
    except KeyError:
        raise ValueError(f"unsupported tuning dtype {dtype_name!r}") from None


def next_pow2_shape(shape) -> tuple[int, ...]:
    return tuple(1 << (int(n) - 1).bit_length() for n in shape)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def enumerate_space(op: str, shape, dtype: str, backend: str | None = None) -> list[dict]:
    """Ordered legal candidates for `op` at per-shard `shape` and storage
    dtype name; empty when nothing is tunable there. On the "cpu" backend
    the VMEM loops' chunks stop at 16, as the JAX package caps them for
    its interpreter, so both packages search the same CPU space."""
    vmem_budget = _vmem_budget()
    shape = tuple(int(n) for n in shape)
    itemsize = compute_itemsize(dtype)
    nbytes = _prod(shape) * itemsize
    family = op.split(".", 1)[1] if "." in op else op

    if family == "vmem_loop":
        admitted_bytes = {
            "diffusion.vmem_loop": vmem_budget,
            # The wave holds the state pair + M + Cw; the SWE 2(ndim+1)
            # state + ndim masks (the kernels' own admission).
            "wave.vmem_loop": vmem_budget // 2,
            "swe.vmem_loop": vmem_budget // (3 * len(shape) + 2),
        }[op]
        if nbytes > admitted_bytes:
            return []
        chunks = [c for c in _CHUNKS if nbytes <= 256 * 1024 or c <= 16]
        if backend == "cpu":
            chunks = [c for c in chunks if c <= 16]
        if op != "diffusion.vmem_loop":
            return [{"chunk": c} for c in chunks]
        out = []
        padded = next_pow2_shape(shape)
        pad_ok = padded != shape and _prod(padded) * itemsize <= vmem_budget
        for form in ("eqc", "conly"):
            for pad in (False, True) if pad_ok else (False,):
                for c in chunks:
                    out.append({"body_form": form, "pad_pow2": pad, "chunk": c})
        return out

    if family == "masked_step":
        if nbytes <= vmem_budget:
            return []  # the VMEM loop serves it
        return [{"run_rows": r} for r in _RUN_ROWS]

    if family == "deep":
        from rocm_mpi_tpu_torch.parallel.wire import WIRE_MODES

        # wire_mode outer, k inner, f32 first: at equal speed the tie-break
        # keeps full precision, and within a mode the shallower sweep.
        return [
            {"k": k, "wire_mode": wm}
            for wm in WIRE_MODES
            for k in _DEEP_KS if k <= min(shape)
        ]

    if family == "scan":
        return [{"chunk": q} for q in _SCAN_CHUNKS]

    raise ValueError(f"no config space for op {op!r}")
