"""Ring-exchange smoke test — run this first on new hardware; counterpart
of apps/ici_ring_test.py.

Each rank fills a device buffer with its rank and passes it one step
round the ring (parallel/ring.py), device to device over NCCL on cards
(the reference's ROCm-aware MPI proof, rocmaware_test_selectdevice.jl).
Success: every rank holds its left neighbour's rank. Rank 0 prints each
rank's sent and received buffers, then `ring exchange: PASS` or `FAIL`;
a mismatch exits 1. `--telemetry DIR`, `--health` and `--profile DIR`
are every app's (apps/_common.py); with telemetry on, the ring records
its `ring.exchange` annotation.

  python -m rocm_mpi_tpu_torch.apps.ici_ring_test                 # one rank: the identity
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.ici_ring_test
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.ici_ring_test --device cpu
"""

import argparse
import sys

from rocm_mpi_tpu_torch.apps._common import (
    add_health_flag,
    add_profile_flag,
    add_telemetry_flag,
    finish_observability,
    profile_context,
    setup_observability,
)


def make_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=4, help="elements per rank's buffer (ref: 4)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: NCCL between cards; cpu: gloo between host processes")
    add_telemetry_flag(p)
    add_health_flag(p)
    add_profile_flag(p)
    return p


def torch_device_name(device) -> str:
    """The card's name and index, or "cpu"."""
    import torch

    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return "cpu"


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    import torch.distributed as dist

    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.ring import ring_exchange_demo

    distributed.maybe_initialize_distributed(args.device)
    device = distributed.local_device(args.device)
    me, n = distributed.rank(), distributed.world_size()
    setup_observability(args, me)
    with profile_context(args, device, me):
        sent, received = ring_exchange_demo(args.width, device=device)
    expect = (me - 1) % n
    good = bool((received == expect).all())
    name = torch_device_name(device)
    line = (f"rank {me} on {name}: sent {sent.tolist()} "
            f"recv {received.tolist()} (expect {float(expect)}) "
            f"{'ok' if good else 'MISMATCH'}")
    lines = [None] * n
    if distributed.is_distributed():
        dist.all_gather_object(lines, (line, good))
    else:
        lines = [(line, good)]
    ok = all(g for _, g in lines)
    if me == 0:
        backend = distributed.backend() or "none (one rank)"
        print(f"ring over {n} rank(s), backend {backend}", flush=True)
        for text, _ in lines:
            print(text, flush=True)
        print("ring exchange: " + ("PASS" if ok else "FAIL"), flush=True)
    finish_observability(lambda msg: print(msg, flush=True) if me == 0 else None)
    distributed.finalize()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
