"""3D heat diffusion — the communication/computation overlap (`hide`)
variant; counterpart of apps/diffusion_3d_perf_hide.py.

The 3D weak-scaling configuration (BASELINE.json's diffusion_3D_perf_hide:
128³ a device, the 6-face halo): per step the boundary shell of width
`--b-width` (clamped to half the shard) is computed from the exchanged
halo on a high-priority CUDA stream, and the ghost-free interior on a
normal-priority stream while the exchange runs (parallel/overlap.py),
every box one fused_step_cm region launch of the 7-point stencil. One
rank has nothing to hide and runs the `perf` step (masked_step). The
default shell (8, 8, 128) clamps to (8, 8, 64) on a 128³ shard, which
leaves no interior box, as in the JAX package: the app prints the clamped
width and the boxes. `--deep K` runs the deep-halo schedule instead
(tb_sweep in 3D at 128³; K must divide both --warmup and nt − warmup, or
it degrades to their gcd).

  python -m rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide                  # one GPU, 128³
  torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide \\
      --nx 256 --ny 256 --nz 128 --dims 2,2,1 --b-width 8,8,8           # 128³ a rank
  python -m rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide --device cpu --nx 24 --ny 24 --nz 24 --nt 8
"""

import sys

from rocm_mpi_tpu_torch.apps._common import make_parser, run_app


def main(argv=None) -> int:
    parser = make_parser("hide", nx=128, ny=128, nz=128, nt=100, dtype="f32")
    parser.set_defaults(b_width="8,8,128")
    return run_app("hide", parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
