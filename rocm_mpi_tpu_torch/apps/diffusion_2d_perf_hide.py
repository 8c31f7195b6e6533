"""2D heat diffusion — the communication/computation overlap (`hide`) variant.

The top rung of the reference's ladder (`diffusion_2D_perf_hide.jl`): per
step, the boundary frame of width `--b-width` (clamped to half the shard)
is computed from the exchanged halo on a high-priority CUDA stream, and
the interior, which reads no ghost cell, on a normal-priority stream
while the exchange runs (parallel/overlap.py). Every region is one
fused_step_cm launch. One rank has nothing to hide and runs the `perf`
step. Reference defaults: 12288² (fact=12), 100 steps, f32, b_width=(32,4).

  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide                  # one GPU
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide --device cpu --nx 64 --ny 64 --nt 12
"""

import sys

from rocm_mpi_tpu_torch.apps._common import make_parser, run_app


def main(argv=None) -> int:
    parser = make_parser("hide", nx=12288, ny=12288, nt=100, dtype="f32")
    return run_app("hide", parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
