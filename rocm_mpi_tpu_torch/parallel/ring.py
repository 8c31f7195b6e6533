"""Device-resident ring exchange — the port's capability smoke test;
counterpart of rocm_mpi_tpu/parallel/ring.py.

The reference's ROCm-aware MPI proof (`rocmaware_test_selectdevice.jl`)
fills a 4-element GPU buffer on each rank with its rank and passes it one
step round a ring with `MPI.Sendrecv!` on device pointers. Here each rank
posts one `dist.batch_isend_irecv`: a send to rank + shift and a receive
from rank − shift. Over NCCL the buffer goes device to device, the
CUDA-aware-MPI path; a CUDA buffer on a gloo group is staged through host
memory, as parallel/halo.py stages its slabs. With two ranks the same
peer is sender and receiver in one batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rocm_mpi_tpu_torch import telemetry
from rocm_mpi_tpu_torch.parallel import distributed
from rocm_mpi_tpu_torch.utils.backend import resolve_device


def ring_exchange(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """This rank's block after one cyclic shift of every rank's block by
    `shift`: the block of rank (rank − shift) mod n. Where the shift
    lands every block on its own rank (one rank, or a multiple of n) the
    ring is the identity, as a `ppermute` over one device is: nothing is
    posted and a copy comes back. With telemetry on, the JAX package's
    `ring.exchange` annotation records the whole block's bytes."""
    if telemetry.enabled():
        telemetry.annotate("ring.exchange", bytes=x.numel() * x.element_size(), shift=shift)
    n = distributed.world_size()
    if shift % n == 0:
        return x.clone()
    me = distributed.rank()
    send = x.contiguous()
    recv = torch.empty_like(send)
    staged = distributed.staged(x)
    if staged:
        send, recv = send.cpu(), recv.cpu()
    ops = [dist.P2POp(dist.isend, send, (me + shift) % n),
           dist.P2POp(dist.irecv, recv, (me - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


def ring_exchange_demo(width: int = 4, dtype=torch.float32, device=None):
    """The ring smoke test on this rank: (sent, received), `sent` a
    `width`-element buffer on `device` filled with this rank's number. A
    correct ring gives `received == (rank − 1) mod n`, the left
    neighbour's rank."""
    dev = resolve_device(device)
    sent = torch.full((int(width),), float(distributed.rank()), dtype=dtype, device=dev)
    return sent, ring_exchange(sent)
