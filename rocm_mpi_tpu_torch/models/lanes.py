"""The lane loop of the batched advances (docs/SERVING.md) — the port's
counterpart of the `lax.fori_loop` the JAX package's batched advances
run, with its per-lane freeze select.

A batched advance runs `n` steps over a rank's lane block, `n` the
longest lane's count; lane j stops at its own `lane_steps[j]`. JAX
selects `where(i < lane_steps, new, old)` every step; the port keeps the
same select but skips it on steps every lane runs (where(True, new, old)
is new, bit for bit), so a batch whose lanes share one length selects
nothing. The active lanes only change when a lane finishes: the mask
`i < lane_steps` is made on the device from the step counts, uploaded
once per call without a host wait (pinned memory, non-blocking), so the
loop never synchronises the host and a batch's launches queue behind the
one before it.

`LaneSlots` keeps a program's spare state buffers, one set per state
shape, so a steady-state batch allocates no state: the advance
ping-pongs between the caller's buffers and the slots, as the
single-lane advances swap two buffers (the counterpart of JAX's
donation). A spare never aliases the call's input.
"""

from __future__ import annotations

import torch


class Active:
    """The lanes a step advances: `lanes` the local lane indices, `mask`
    a `(lanes, 1, …)` bool tensor, True on an advancing lane."""

    __slots__ = ("lanes", "mask")

    def __init__(self, lanes, mask):
        self.lanes = tuple(lanes)
        self.mask = mask


def upload_steps(lane_steps, device) -> torch.Tensor:
    """The per-lane step counts as an int64 tensor on `device`, copied
    from pinned memory without a host wait on a CUDA device."""
    host = torch.tensor([int(s) for s in lane_steps], dtype=torch.int64)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def schedule(lane_steps, n: int, space_ndim: int, device):
    """Yield, for each step i < n that some lane runs, None when every
    lane runs it, else an Active (the same object until a lane
    finishes)."""
    steps = [int(s) for s in lane_steps]
    width = len(steps)
    dev_steps = None
    current = None
    live_n = None
    for i in range(int(n)):
        live = [j for j in range(width) if i < steps[j]]
        if not live:
            return
        if len(live) == width:
            yield None
            continue
        if len(live) != live_n:
            if dev_steps is None:
                dev_steps = upload_steps(steps, device)
            mask = (dev_steps > i).reshape((width,) + (1,) * space_ndim)
            current, live_n = Active(live, mask), len(live)
        yield current


def hold_mask(mask: torch.Tensor, active: Active | None) -> torch.Tensor:
    """The cells a step keeps: the Dirichlet `mask` (space-shaped), and
    every cell of a lane that does not advance."""
    return mask if active is None else mask | ~active.mask


class LaneSlots:
    """Spare state buffers of one batched program (module docstring)."""

    def __init__(self):
        self._slots: dict = {}

    def spare(self, like: torch.Tensor, avoid=()) -> torch.Tensor:
        """A buffer of `like`'s shape, dtype and device, none of `avoid`
        (the tensors the step reads)."""
        key = (tuple(like.shape), like.dtype, like.device)
        bufs = self._slots.setdefault(key, [])
        for b in bufs:
            if not any(b is a for a in avoid):
                return b
        b = torch.empty_like(like)
        bufs.append(b)
        return b
