"""2D heat diffusion — the fused-kernel performance variant on the GPU.

The memory-bound rung: one hand kernel per step (masked_step on one GPU;
halo exchange + fused_step_cm when sharded), two field buffers swapped
each step, T_eff and Gpts/s over the warmup-excluded steps. Reference
defaults: 12288² (fact=12), 1000 steps, f32. `--deep K` runs deep-halo
sweeps instead (HeatDiffusion.run_deep): K must divide both the warmup
and the timed window, or it degrades to their gcd.

  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf                 # one GPU
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf --deep 8 --nt 1016 --warmup 16
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf --device cpu --nx 64 --ny 64 --nt 20
"""

import sys

from rocm_mpi_tpu_torch.apps._common import make_parser, run_app


def main(argv=None) -> int:
    parser = make_parser("perf", nx=12288, ny=12288, nt=1000, dtype="f32")
    return run_app("perf", parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
