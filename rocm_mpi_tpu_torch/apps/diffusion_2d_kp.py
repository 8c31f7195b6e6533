"""2D heat diffusion — the kernel-programming (`kp`) variant on the GPU.

The hand-written-kernels rung of the reference's ladder
(`diffusion_2D_kp.jl`): each step exchanges the halo, then launches three
separate kernels on the staggered grid — flux q = −λ∇T on the faces,
residual −∇·q/Cp, update T + dt·dTdt — and holds the Dirichlet edge. The
fused `perf` rung removes two launches and the round trips of the
intermediates. Reference defaults: 128², 1000 steps, f64. `--save-field`
writes the gathered field, to compare it with the ap and perf apps'.

  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_kp                    # one GPU
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_2d_kp
  python -m rocm_mpi_tpu_torch.apps.diffusion_2d_kp --device cpu --nx 32 --ny 32 --nt 20
"""

import sys

from rocm_mpi_tpu_torch.apps._common import make_parser, run_app


def main(argv=None) -> int:
    parser = make_parser("kp", nx=128, ny=128, nt=1000, dtype="f64", vis=True)
    return run_app("kp", parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
