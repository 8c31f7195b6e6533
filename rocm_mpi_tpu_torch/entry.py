"""The flagship step — twin of `__graft_entry__.entry()`.

`entry()` returns the `perf` variant's single step at the benchmark
geometry (252², f32, one device) and its example state: on a GPU that
step is one launch of the masked_step kernel.
"""

from __future__ import annotations


def entry(device=None):
    """(fn, (T, Cp)): fn(T, Cp) -> new T, one perf step at 252² f32."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = DiffusionConfig(
        global_shape=(252, 252), lengths=(10.0, 10.0), nt=100, warmup=0,
        dtype="f32", dims=(1, 1),
    )
    grid = init_global_grid(*cfg.global_shape, lengths=cfg.lengths,
                            dims=cfg.dims, nprocs=1, rank=0)
    model = HeatDiffusion(cfg, grid=grid, device=device)
    T, Cp = model.init_state()
    return model.step_fn("perf"), (T, Cp)
