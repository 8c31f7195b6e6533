"""Workload models."""

from rocm_mpi_tpu_torch.models.diffusion import HeatDiffusion, RunResult
from rocm_mpi_tpu_torch.models.swe import ShallowWater, SWERunResult
from rocm_mpi_tpu_torch.models.wave import AcousticWave, WaveRunResult

__all__ = ["AcousticWave", "HeatDiffusion", "RunResult", "SWERunResult", "ShallowWater",
           "WaveRunResult"]
