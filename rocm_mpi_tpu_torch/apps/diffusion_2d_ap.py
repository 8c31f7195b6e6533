"""2D heat diffusion — the array-programming (`ap`) variant on the GPU.

The baseline rung of the reference's ladder (`diffusion_2D_ap.jl`): the
step is plain PyTorch array operations in staggered flux form, on the
halo-padded shard (the exchange is explicit, as the reference's
`update_halo!`). No hand kernel runs. Reference defaults: 128², 1000
steps, f64. `--save-field` writes the gathered field, to compare it with
the kp and perf apps'.

  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_ap                    # one GPU
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_ap
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_ap --device cpu --nx 32 --ny 32 --nt 20
"""

import sys

from rocm_mpi_tpu_torch.apps._common import make_parser, run_app


def main(argv=None) -> int:
    parser = make_parser("ap", nx=128, ny=128, nt=1000, dtype="f64", vis=True)
    return run_app("ap", parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
