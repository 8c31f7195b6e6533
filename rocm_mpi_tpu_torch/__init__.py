"""PyTorch/CUDA port of rocm_mpi_tpu, the distributed explicit stencil
framework for 2D/3D transient heat diffusion.

The package mirrors the JAX package's module names (config, ops,
parallel, models, utils, apps) so each part can be read beside the module
it ports. Plain tensor code is PyTorch; the per-step stencils are CUDA C++
kernels written for Hopper (csrc/), each with a plain PyTorch version of
the same arithmetic that CPU tensors take (ops/kernels.py). Entry points
run on the GPU unless the caller passes device="cpu".

Ported so far: the `perf` heat-diffusion path (config, grid, halo
exchange over torch.distributed, the masked_step and fused_step_cm
kernels, HeatDiffusion with the ap/fused/shard/perf variants, the perf
app). ROADMAP.md lists what is still to port.
"""
