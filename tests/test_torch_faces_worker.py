"""Ranks of tests/test_torch_faces.py (gloo), started by
rocm_mpi_tpu_torch.parallel.launcher.spawn_ranks (`run_faces_rank`); it
holds no tests itself. Imports torch and the port only, so a spawned rank
starts fast; the parent holds the results against the JAX package."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def register_padded_variants(model):
    """Register "perf-padded" and "hide-padded" on a sharded HeatDiffusion:
    the same steps over the padded route (exchange_halo: the shard copied
    into a padded buffer, one batch an axis; fused_step_cm on the block,
    and the hide boxes from it), the route the face exchange replaces."""
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
    from rocm_mpi_tpu_torch.parallel.overlap import make_overlap_step

    cfg, grid = model.config, model.grid
    prepare = model.prepare_fn("perf")

    def perf(T, Cm, out=None, pad=None):
        Tp = exchange_halo(T, grid, out=pad, wire_mode=cfg.wire_mode)
        return kernels.fused_step_cm(Tp, Cm, cfg.spacing, out=out)

    def region_update(src, offset, box, Cm, out):
        kernels.fused_step_cm_region(src, offset, Cm, cfg.spacing, box, out)

    local = make_overlap_step(grid, region_update, cfg.b_width, wire_mode=cfg.wire_mode,
                              device=model.device)

    def hide(T, Cm, out=None, pad=None):
        return local(T, Cm, out=out, pad=pad)

    model.register_variant("perf-padded", perf, prepare)
    model.register_variant("hide-padded", hide, prepare)


def _exchange_case(shape, dims, mode, dtype, calls):
    """exchange_faces against exchange_halo's padded buffer on this rank:
    per face whether it is None, whether a neighbour is there, whether it
    equals the matching ghost bit for bit (or the ghost is zero where it is
    None); the batches each call posted; the buffers' pointers per call."""
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.ops.kernels import ghost_slices
    from rocm_mpi_tpu_torch.parallel import halo
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    grid = init_global_grid(*shape, dims=dims)
    G = np.random.default_rng(3).random(shape)
    u = torch.from_numpy(np.ascontiguousarray(G[grid.shard_slices()])).to(DTYPES[dtype])
    batches = []
    real = dist.batch_isend_irecv

    def counted(ops):
        batches.append(len(ops))
        return real(ops)

    dist.batch_isend_irecv = counted
    try:
        pointers, per_call = [], []
        for _ in range(calls):
            n = len(batches)
            faces = halo.exchange_faces(u, grid, wire_mode=mode)
            per_call.append(len(batches) - n)
            pointers.append([None if f is None else f.data_ptr() for f in faces])
    finally:
        dist.batch_isend_irecv = real
    padded = halo.exchange_halo(u, grid, wire_mode=mode)
    rows = []
    for k, (face, sl) in enumerate(zip(faces, ghost_slices(u.ndim))):
        ghost = padded[sl]
        neighbour = grid.neighbor(k // 2, -1 if k % 2 == 0 else +1) is not None
        same = (bool(torch.equal(ghost, torch.zeros_like(ghost))) if face is None
                else bool(torch.equal(face, ghost)) and face.is_contiguous())
        rows.append(dict(none=face is None, neighbour=neighbour, same=same))
    return dict(faces=rows, batches_per_call=per_call, sizes=batches, pointers=pointers)


def run_faces_rank(rank, spec):
    """One rank of tests/test_torch_faces.py: the face exchange against the
    padded one (spec["exchanges"]), then each sharded diffusion run of
    spec["runs"] through the face route and the padded route, under its
    driver, from the JAX package's initial state where spec["states"] has
    it (else the model's own), gathered to rank 0."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.state import state_from_numpy

    torch.set_num_threads(1)
    kernels.reset_launches()
    out = {"exchange": {}, "runs": {}}
    for key, (shape, dims, mode, dtype) in spec["exchanges"].items():
        out["exchange"][key] = _exchange_case(shape, dims, mode, dtype, spec["calls"])
    for key, (shape, dims, dtype, wire, variant, driver, bw) in spec["runs"].items():
        cfg = DiffusionConfig(global_shape=shape, lengths=(10.0,) * len(shape),
                              nt=spec["nt"], warmup=spec["warmup"], dtype=dtype, dims=dims,
                              b_width=bw, wire_mode=wire)
        model = HeatDiffusion(cfg, device="cpu")
        register_padded_variants(model)
        if key in spec["states"]:
            T0, Cp = state_from_numpy(*spec["states"][key], model.grid, device="cpu")
        else:
            T0, Cp = model.init_state()
        fields = {}
        for route in (variant, f"{variant}-padded"):
            if driver == "step":
                T = model.advance_fn(route)(T0.clone(), Cp, spec["nt"])
            else:
                advance, _ = model.scan_advance_fn(route, nt=spec["nt"], warmup=0)
                T = advance(T0.clone(), Cp, spec["nt"])
            fields[route] = T
        same = bool(torch.equal(fields[variant], fields[f"{variant}-padded"]))
        gathered = gather_to_host0(fields[variant].to(torch.float64), model.grid)
        out["runs"][key] = dict(same=same, field=gathered)
    out["launches"] = dict(kernels.LAUNCHES)
    return out
