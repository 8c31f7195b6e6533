"""Ranks of tests/test_torch_tuning.py (gloo), started by
rocm_mpi_tpu_torch.parallel.launcher.spawn_ranks; it holds no tests
itself. Imports torch and the port only, so a spawned rank starts fast."""

from __future__ import annotations

import torch


def run_resolve_rank(rank, spec):
    """One rank of a 2×2 grid that points the tuning plane at its own
    cache file (spec["paths"][rank]: rank 0's holds the entries, the
    others' are empty) and resolves the scan chunk and the deep config
    with config="auto", then runs the scan driver and run_deep. Returns
    what it resolved, the q and k its runs took, and its final fields."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import deep_halo
    from rocm_mpi_tpu_torch.tuning import resolve

    torch.set_num_threads(1)
    resolve.configure(spec["paths"][rank])
    resolve.reset_stats()
    cfg = DiffusionConfig(global_shape=(32, 32), lengths=(10.0, 10.0), nt=24, warmup=8,
                          dtype="f64", dims=(2, 2))
    model = HeatDiffusion(cfg, device="cpu")
    deep = deep_halo.resolve_deep_config(model.grid, cfg.torch_dtype, "auto", model.device)
    scan = model.run("perf", driver="scan", config="auto")
    ran_deep = model.run_deep(config="auto")
    return {"deep": deep, "q": scan.k, "k": ran_deep.k, "stats": resolve.stats(),
            "scan_T": scan.T.numpy(), "deep_T": ran_deep.T.numpy()}


def run_explicit_rank(rank, spec):
    """The same runs as run_resolve_rank with the knobs passed explicitly
    (no cache): the scan chunk spec["chunk"], the deep spec["k"] and
    spec["wire_mode"]."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion

    torch.set_num_threads(1)
    cfg = DiffusionConfig(global_shape=(32, 32), lengths=(10.0, 10.0), nt=24, warmup=8,
                          dtype="f64", dims=(2, 2))
    model = HeatDiffusion(cfg, device="cpu")
    advance, q = model.scan_advance_fn("perf", chunk=spec["chunk"])
    T, Cp = model.init_state()
    T = advance(T, Cp, 24)
    ran_deep = model.run_deep(block_steps=spec["k"], wire_mode=spec["wire_mode"])
    return {"q": q, "k": ran_deep.k, "scan_T": T.numpy(), "deep_T": ran_deep.T.numpy()}
