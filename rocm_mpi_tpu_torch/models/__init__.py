"""Workload models."""

from rocm_mpi_tpu_torch.models.diffusion import HeatDiffusion, RunResult

__all__ = ["HeatDiffusion", "RunResult"]
