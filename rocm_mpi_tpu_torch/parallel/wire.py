"""On-wire halo precision — counterpart of rocm_mpi_tpu/parallel/wire.py.

The port's own copy of the JAX package's wire plane: the `wire_mode`
registry, the per-mode slab codecs (torch for the exchange over
torch.distributed, a numpy twin for the host-staged oracle), the per-mode
byte accounting, and the tolerance contract that holds every non-f32
mode against the f64 host-staged oracle.

Modes (fractions of the full-precision wire):

* ``f32``        — the state dtype verbatim (an f64 run ships f64). The
                   exchange keeps its code path: no codec runs.
* ``bf16``       — round to bfloat16 (nearest even) on send, widen to
                   the buffer dtype on receive before any arithmetic.
                   0.5× the f32 wire.
* ``int8``       — per-slab symmetric int8 (scale = max|x| / 127, sent
                   beside the codes) with an error-feedback residual
                   carried in the exchange state: the error of send t is
                   added to the slab of send t + 1. ~0.25×. Stateful.
* ``int8_delta`` — int8 over the difference from the previous send's
                   reconstruction, which sender and receiver both keep
                   (the first send's "previous" is zero). ~0.25×.
                   Stateful.

Stateful modes carry their state as a flat tuple of tensors,
``state_arity(mode)`` per slab in exchange order (axis-major, lo then
hi; `slab_shapes` is the shape contract). A port rank holds only its own
state, so `init_exchange_state` builds per-rank tensors of the slab
shapes where the JAX package builds global arrays sharded by slab. The
per-step variants are stateless, so they take f32 and bf16 only; the
deep-halo schedules (parallel/deep_halo.py) thread the state through
their sweeps.

NCCL carries torch.bfloat16 and torch.int8 as they are, so the bf16
payload needs no bitcast to uint16 (the JAX package's bitcast only
defeats an XLA rewrite); it is still 2 bytes an element on the wire.

Import is stdlib-only (torch and numpy inside the functions that use
them), so the mode tables are readable without either.
"""

from __future__ import annotations

import math
from typing import NamedTuple

WIRE_MODES = ("f32", "bf16", "int8", "int8_delta")

# Modes that carry exchange state (error-feedback residuals, delta
# reconstructions) from one exchange to the next.
STATEFUL_MODES = frozenset({"int8", "int8_delta"})

# The wire-bytes ladder: the largest allowed fraction of a mode's on-wire
# bytes against the full-precision wire at the same geometry.
DEFAULT_LADDER = {
    "f32": 1.02,  # exact metric; the tolerance covers rounding only
    "bf16": 0.55,
    "int8": 0.35,
    "int8_delta": 0.35,
}

# The tolerance contract: the largest allowed relative max-abs error of a
# run with this wire mode against the f64 host-staged oracle without it,
# at `check_tolerance`'s drill horizon.
TOLERANCE = {
    "f32": 2e-4,
    "bf16": 2e-2,
    "int8": 6e-2,
    "int8_delta": 3e-2,
}


def validate_mode(mode: str) -> str:
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown wire_mode {mode!r}; known: {WIRE_MODES}")
    return mode


def is_stateful(mode: str) -> bool:
    return validate_mode(mode) in STATEFUL_MODES


def state_arity(mode: str) -> int:
    """State tensors carried per slab: int8 the error-feedback residual;
    int8_delta also the sender's and the receiver's reconstructions
    (prev_send, prev_recv)."""
    if mode == "int8":
        return 1
    if mode == "int8_delta":
        return 3
    return 0


def payload_itemsize(mode: str, itemsize: int) -> int:
    """On-wire bytes per slab element; f32 ships the state dtype."""
    validate_mode(mode)
    if mode == "bf16":
        return 2
    if mode in STATEFUL_MODES:
        return 1
    return int(itemsize)


def payload_dtype(mode: str, dtype):
    """The torch dtype a stateless mode's slab travels in: f32 the state
    dtype, bf16 bfloat16. Their codecs are a cast each way, so the
    exchange packs and lands a slab with `copy_` into and out of a
    buffer of this dtype, bitwise what `slab_codec` gives."""
    import torch

    if is_stateful(mode):
        raise ValueError(f"wire_mode {mode!r} ships int8 codes and a scale, not one dtype")
    return torch.bfloat16 if mode == "bf16" else dtype


def slab_overhead_bytes(mode: str, itemsize: int) -> int:
    """Per-slab side bytes: the int8 modes ship one scale in the state
    dtype beside each slab."""
    return int(itemsize) if mode in STATEFUL_MODES else 0


def wire_slab_nbytes(n_elems: int, itemsize: int, mode: str) -> int:
    """On-wire bytes of one slab under `mode`."""
    return int(n_elems) * payload_itemsize(mode, itemsize) + slab_overhead_bytes(mode, itemsize)


def slab_shapes(local_shape, width: int, axes=None) -> list[tuple[int, ...]]:
    """Per-shard slab shapes in exchange order (axis-major, lo then hi).
    Axis k's slabs span the padded extent of every axis exchanged before
    it (the corner trick) and the core extent of the rest."""
    local_shape = tuple(int(n) for n in local_shape)
    ndim = len(local_shape)
    axes = tuple(range(ndim) if axes is None else axes)
    width = int(width)
    shapes: list[tuple[int, ...]] = []
    done: list[int] = []
    for ax in axes:
        shape = tuple(
            width if a == ax
            else local_shape[a] + 2 * width if a in done
            else local_shape[a]
            for a in range(ndim)
        )
        shapes.extend((shape, shape))  # lo ghost, hi ghost
        done.append(ax)
    return shapes


def exchange_wire_nbytes(local_shape, itemsize: int, width: int = 1, axes=None,
                         mode: str = "f32") -> int:
    """Bytes an interior rank sends per exchange under `mode`."""
    return sum(
        wire_slab_nbytes(math.prod(s), itemsize, mode)
        for s in slab_shapes(local_shape, width, axes)
    )


def ladder_fraction(local_shape, width: int, mode: str, itemsize: int = 4) -> float:
    """A mode's wire bytes as a fraction of the full-precision wire's."""
    full = exchange_wire_nbytes(local_shape, itemsize, width, mode="f32")
    this = exchange_wire_nbytes(local_shape, itemsize, width, mode=mode)
    return this / full if full else 0.0


def init_exchange_state(local_shape, width: int, mode: str, dtype, axes=None,
                        fields: int = 1, device=None) -> tuple:
    """This rank's zero exchange state for one stateful exchange per
    sweep of each of `fields` same-shaped fields: `state_arity(mode)`
    tensors per slab, of the shapes `slab_shapes` gives, in exchange
    order. Zeros are the first-send contract: a zero residual adds
    nothing, and a zero reconstruction makes the first delta send ship
    the plain slab."""
    import torch

    if not is_stateful(mode):
        return ()
    arity = state_arity(mode)
    return tuple(
        torch.zeros(shape, dtype=dtype, device=device)
        for _ in range(int(fields))
        for shape in slab_shapes(local_shape, width, axes)
        for _j in range(arity)
    )


# ---------------------------------------------------------------------------
# The torch slab codec (parallel/halo.exchange_into)
# ---------------------------------------------------------------------------


def _quantize_int8(x, out=None):
    """(int8 codes, scale as a one-element tensor in x.dtype), written
    into `out` = (codes, scale) buffers when given. An all-zero slab
    takes scale 1, so nothing divides by zero, and a zero scale (a slab
    that never arrived) still decodes to 0. The operation order is the
    JAX package's: x / scale (a division, not a reciprocal product) in
    x's dtype, round half to even, then clamp. The divisor 127 is a
    tensor on x's device: CUDA divides by a Python scalar as a product
    with its reciprocal, which moves the scale by an ulp."""
    import torch

    m = x.abs().max()
    scale = torch.where(m > 0, m / torch.full_like(m, 127.0), torch.ones_like(m))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    if out is None:
        return q.to(torch.int8), scale.reshape(1)
    # The codes are whole numbers in [-127, 127]: the cast into the int8
    # buffer is exact, as .to(torch.int8) is.
    return out[0].copy_(q), out[1].copy_(scale.reshape(1))


def _dequantize_int8(q, scale, dtype):
    return q.to(dtype) * scale.to(dtype)


class SlabCodec(NamedTuple):
    """One slab's wire transform: `send(slab, state, out=None) ->
    (payload, state)` and `recv(payload, state, dtype) -> (decoded,
    state)`. The payload is a tuple of tensors, each sent as one message,
    written into the tensors of `out` when given (the int8 modes: codes
    and scale); `state` a tuple of `state_arity(mode)` tensors (empty for
    stateless modes)."""

    send: object
    recv: object


def slab_codec(mode: str) -> SlabCodec:
    import torch

    validate_mode(mode)

    if mode == "f32":

        def send(slab, state, out=None):
            return (slab,), state

        def recv(shipped, state, dtype):
            return shipped[0], state

    elif mode == "bf16":

        def send(slab, state, out=None):
            return (slab.to(torch.bfloat16),), state

        def recv(shipped, state, dtype):
            # Widen before anything else touches the slab.
            return shipped[0].to(dtype), state

    elif mode == "int8":

        def send(slab, state, out=None):
            (resid,) = state
            comp = slab + resid  # error feedback: carry the last send's error
            q, scale = _quantize_int8(comp, out)
            deq = _dequantize_int8(q, scale, slab.dtype)
            return (q, scale), (comp - deq,)

        def recv(shipped, state, dtype):
            q, scale = shipped
            return _dequantize_int8(q, scale, dtype), state

    else:  # int8_delta

        def send(slab, state, out=None):
            resid, prev_send, prev_recv = state
            comp = slab + resid
            q, scale = _quantize_int8(comp - prev_send, out)
            deq = _dequantize_int8(q, scale, slab.dtype)
            new_prev = prev_send + deq
            return (q, scale), (comp - new_prev, new_prev, prev_recv)

        def recv(shipped, state, dtype):
            resid, prev_send, prev_recv = state
            q, scale = shipped
            decoded = prev_recv + _dequantize_int8(q, scale, dtype)
            # Both sides integrate the same dequantized values, so the
            # receiver's reconstruction equals the sender's. A slab that
            # never arrives (domain edge) decodes from zeros: the ghost and
            # its reconstruction stay zero.
            return decoded, (resid, prev_send, decoded)

    return SlabCodec(send, recv)


# ---------------------------------------------------------------------------
# The numpy twin (host-staged oracle and the tolerance drill)
# ---------------------------------------------------------------------------


class NumpyWireCodec:
    """Per-slab numpy twin of `slab_codec`, its state held inside.
    `apply(key, slab)` returns the slab as the receiver decodes it; `key`
    names the logical wire (receiver coordinates, axis, side), so that
    each wire keeps its own residual and reconstruction across steps.
    `feedback=False` drops the error-feedback residual (for drift
    comparisons only)."""

    def __init__(self, mode: str, feedback: bool = True):
        self.mode = validate_mode(mode)
        self.feedback = feedback
        self._resid: dict = {}
        self._prev: dict = {}

    def apply(self, key, slab):
        import numpy as np

        if self.mode == "f32":
            return slab
        if self.mode == "bf16":
            return _np_bf16_round(slab).astype(slab.dtype)
        resid = self._resid.get(key, 0.0)
        comp = slab + resid if self.feedback else slab
        prev = self._prev.get(key, 0.0) if self.mode == "int8_delta" else 0.0
        d = comp - prev
        m = float(np.max(np.abs(d)))
        scale = m / 127.0 if m > 0 else 1.0
        deq = np.clip(np.round(d / scale), -127.0, 127.0) * scale
        decoded = prev + deq
        if self.feedback:
            self._resid[key] = comp - decoded
        if self.mode == "int8_delta":
            self._prev[key] = decoded
        return decoded.astype(slab.dtype)


def _np_bf16_round(x):
    """Round to nearest even float -> bfloat16 -> float in numpy: bf16 is
    f32 with the mantissa cut to 7 bits."""
    import numpy as np

    f = np.asarray(x, np.float32)
    u = f.view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return rounded.view(np.float32).astype(np.asarray(x).dtype)


# ---------------------------------------------------------------------------
# The tolerance contract (against the f64 host-staged oracle)
# ---------------------------------------------------------------------------


class ContractResult(NamedTuple):
    mode: str
    ok: bool
    rel_err: float
    bound: float
    steps: int


class OracleGrid(NamedTuple):
    """The geometry the host-staged stepper reads (parallel/halo.py
    HostStagedStepper), with no process group behind it."""

    global_shape: tuple[int, ...]
    dims: tuple[int, ...]
    spacing: tuple[float, ...]

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // d for n, d in zip(self.global_shape, self.dims))


_CERT_CACHE: dict = {}


def check_tolerance(mode: str, shape=(32, 32), dims=(2, 2), steps: int = 60) -> ContractResult:
    """The drill: run the f64 host-staged diffusion oracle plain and with
    the wire codec on its ghost slabs, and bound the relative max-abs
    divergence by the mode's TOLERANCE row. numpy only, deterministic."""
    import numpy as np

    from rocm_mpi_tpu_torch.parallel.halo import HostStagedStepper

    validate_mode(mode)
    bound = TOLERANCE[mode]
    shape = tuple(int(n) for n in shape)
    dims = tuple(int(d) for d in dims)
    grid = OracleGrid(global_shape=shape, dims=dims, spacing=tuple(10.0 / n for n in shape))
    lam, cp0 = 1.0, 1.0
    h2 = min(d * d for d in grid.spacing)
    dt = h2 * cp0 / lam / (2 * grid.ndim + 0.1)
    coords = np.meshgrid(
        *[(np.arange(n) + 0.5) * d - 5.0 for n, d in zip(shape, grid.spacing)],
        indexing="ij",
    )
    T0 = np.exp(-sum(c * c for c in coords)).astype(np.float64)
    Cp = np.full(shape, cp0, np.float64)
    ref = HostStagedStepper(grid, lam, dt, use_native=False).run(T0.copy(), Cp, steps)
    got = HostStagedStepper(grid, lam, dt, use_native=False, wire_mode=mode).run(
        T0.copy(), Cp, steps)
    rel = float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))
    return ContractResult(mode, rel <= bound, rel, bound, steps)


def certify(mode: str) -> ContractResult:
    """`check_tolerance` at the drill's standard geometry, cached on the
    mode and its current bound."""
    key = (mode, TOLERANCE[validate_mode(mode)])
    out = _CERT_CACHE.get(key)
    if out is None:
        out = _CERT_CACHE[key] = check_tolerance(mode)
    return out
