"""The port's ring smoke test (rocm_mpi_tpu_torch/parallel/ring.py and
apps/ici_ring_test.py) against the JAX package's ring on N CPU devices:
N gloo ranks for N in 1..4 (N = 2 sends to and receives from one peer in
one batch), shift +1 and -1, exactly."""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

import test_torch_transport_worker as worker
from rocm_mpi_tpu.parallel.mesh import init_global_grid as jax_grid
from rocm_mpi_tpu.parallel.ring import ring_exchange, ring_exchange_demo
from rocm_mpi_tpu.utils.compat import shard_map
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

WIDTH = 4
SHIFTS = (1, -1)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", params=[1, 2, 3, 4], ids=lambda n: f"N{n}")
def ring(request):
    n = request.param
    spec = dict(width=WIDTH, shifts=SHIFTS)
    return n, spawn_ranks(n, worker.run_ring_rank, (spec,), backend="gloo", timeout=120)


def _jax_ring(n, shift):
    """(sent, received) of the JAX ring on n devices, one row per device."""
    mesh = jax_grid(n * WIDTH, lengths=(1.0,), dims=(n,), devices=jax.devices()[:n]).mesh
    if shift == 1:
        sent, received = ring_exchange_demo(mesh, width=WIDTH)
    else:
        sent, _ = ring_exchange_demo(mesh, width=WIDTH)
        axis = mesh.axis_names[0]
        received = jax.jit(shard_map(lambda b: ring_exchange(b, axis, shift=shift), mesh=mesh,
                                     in_specs=PartitionSpec(axis),
                                     out_specs=PartitionSpec(axis)))(sent)
    return np.asarray(sent).reshape(n, WIDTH), np.asarray(received).reshape(n, WIDTH)


@pytest.mark.parametrize("shift", SHIFTS)
def test_ring_equals_jax_ring(ring, shift):
    n, ranks = ring
    want_sent, want_recv = _jax_ring(n, shift)
    got_sent = np.stack([r[shift][0] for r in ranks])
    got_recv = np.stack([r[shift][1] for r in ranks])
    np.testing.assert_array_equal(got_sent, want_sent)
    np.testing.assert_array_equal(got_recv, want_recv)
    # Every rank holds the rank `shift` to its left.
    np.testing.assert_array_equal(got_recv[:, 0], (np.arange(n) - shift) % n)


def test_ring_on_one_rank_is_a_copy():
    import torch

    from rocm_mpi_tpu_torch.parallel.ring import ring_exchange as torch_ring

    x = torch.arange(4.0)
    y = torch_ring(x, 1)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()


def test_ring_app_on_one_rank(capsys):
    from rocm_mpi_tpu_torch.apps import ici_ring_test

    assert ici_ring_test.main(["--device", "cpu", "--width", "3"]) == 0
    out = capsys.readouterr().out
    assert "recv [0.0, 0.0, 0.0] (expect 0.0) ok" in out
    assert out.strip().endswith("ring exchange: PASS")


def test_ring_app_under_torchrun_on_two_ranks():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "-m", "rocm_mpi_tpu_torch.apps.ici_ring_test", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "rank 0 on cpu: sent [0.0, 0.0, 0.0, 0.0] recv [1.0, 1.0, 1.0, 1.0]" in proc.stdout
    assert "rank 1 on cpu: sent [1.0, 1.0, 1.0, 1.0] recv [0.0, 0.0, 0.0, 0.0]" in proc.stdout
    assert "ring exchange: PASS" in proc.stdout


def test_ring_app_fails_on_a_wrong_neighbour(monkeypatch, capsys):
    from rocm_mpi_tpu_torch.apps import ici_ring_test
    from rocm_mpi_tpu_torch.parallel import ring

    monkeypatch.setattr(ring, "ring_exchange", lambda x, shift=1: x + 1)
    assert ici_ring_test.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "ring exchange: FAIL" in out
