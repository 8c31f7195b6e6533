"""Device policy — the port's counterpart of the Pallas dispatch rule
(rocm_mpi_tpu/ops/pallas_kernels.py `_interpret_default`).

Two decisions live here and nowhere else:

* Which device an entry point runs on: `device=None` means the GPU, and
  without CUDA that raises instead of silently running the plain
  versions on the CPU; the CPU is used only when the caller asks for it
  (`device="cpu"`, as the tests do).
* Which implementation a kernel wrapper takes: a CPU tensor goes to the
  kernel's plain PyTorch version, a CUDA tensor to the hand-written
  kernel, and anything else raises. There is no fallback from the kernel
  to the plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means the current CUDA
    device; "cpu" runs the plain versions. Raises when CUDA is asked for
    (explicitly or by default) and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions instead"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the hand kernel must run (every tensor on one CUDA
    device), False when the plain version must (every tensor on the CPU).
    Mixed devices and any other device type raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            devices = sorted({str(u.device) for u in tensors})
            raise ValueError(f"tensors on different devices: {devices}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise RuntimeError(
        f"no kernel dispatch for device type {dev.type!r}: CUDA tensors run "
        "the hand kernels, CPU tensors their plain versions"
    )
