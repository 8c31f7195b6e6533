"""Process-group setup — counterpart of rocm_mpi_tpu/parallel/distributed.py.

One process per GPU, as the reference runs one MPI rank per GPU. The
halo exchange rides the default process group: NCCL for CUDA tensors
(device to device, the CUDA-aware-MPI path) and gloo for CPU tensors.
A gloo group that is handed CUDA tensors stages each slab through host
memory (parallel/halo.py); that is how several ranks share one card, and
`maybe_initialize_distributed` takes gloo when a host's ranks outnumber
its cards.

Ranks come either from `torchrun` (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK in the environment; `maybe_initialize_distributed`)
or from a store port, world size and rank (`init_distributed`, used by
parallel/launcher.spawn_ranks, which serves the store on localhost). The
argv launcher (parallel/launcher.spawn_app_ranks) gives its ranks
torchrun's variables, so they join through `maybe_initialize_distributed`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from rocm_mpi_tpu_torch.utils.backend import resolve_device


def default_backend(device_type: str, local_ranks: int = 1) -> str:
    """NCCL for CUDA ranks, one a card; gloo for CPU ranks and for CUDA
    ranks that share a card (more local ranks than visible cards: NCCL
    refuses two ranks on one device, gloo stages through host memory)."""
    if device_type != "cuda" or local_ranks > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_distributed(rank: int, world_size: int, store_port: int,
                     backend: str) -> None:
    """Join the default process group through the key-value store served
    on localhost:`store_port` (parallel/launcher.spawn_ranks serves it)."""
    store = dist.TCPStore("localhost", store_port, world_size, is_master=False)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def maybe_initialize_distributed(device_type: str = "cuda") -> bool:
    """Join the process group `torchrun` describes, when it describes one
    with more than one rank; binds this rank's GPU first on CUDA. Returns
    True when running distributed. Idempotent."""
    if dist.is_available() and dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    # The resilience plane's "init" site: a delay@… clause here is the slow
    # joiner, before the group forms.
    from rocm_mpi_tpu_torch.resilience import faults

    faults.fault_point("init")
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    kwargs = {}
    if os.environ.get("RMT_INIT_TIMEOUT_S"):
        # The argv launcher's init_timeout_s: how long the rendezvous, and
        # then each collective, may wait for a peer (torch's default when
        # unset: NCCL's watchdog would otherwise abort a rank whose peer
        # builds its kernels for minutes).
        kwargs["timeout"] = datetime.timedelta(seconds=float(os.environ["RMT_INIT_TIMEOUT_S"]))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    dist.init_process_group(default_backend(device_type, local_ranks), init_method="env://",
                            **kwargs)
    # One collective over every rank first: NCCL then sets up its
    # communicator before the halo exchange's point-to-point batches, in
    # which ranks at the domain edge post fewer operations.
    dist.barrier()
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def backend() -> str | None:
    return dist.get_backend() if is_distributed() else None


def staged(t: torch.Tensor) -> bool:
    """True when the process group cannot carry `t` where it lies (gloo
    and a CUDA tensor): it then goes through host memory."""
    return t.is_cuda and backend() == "gloo"


def local_device(device_type: str) -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK mod card count), or the CPU.
    Raises when CUDA is asked for and absent."""
    if device_type != "cuda":
        return torch.device("cpu")
    resolve_device("cuda")  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def barrier(group=None) -> None:
    """Wait for every rank of `group` (None: the default group)."""
    if is_distributed():
        dist.barrier(group=group)


def finalize() -> None:
    """Destroy the default process group, after the scan and sweep loops'
    captured graphs (models/scan.release_graphs): over NCCL they hold work
    on its communicator, and destroy_process_group waits for ever while
    one is alive."""
    if is_distributed():
        from rocm_mpi_tpu_torch.models import scan

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        scan.release_graphs()
        dist.destroy_process_group()
