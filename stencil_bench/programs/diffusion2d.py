"""2D heat diffusion under the scan driver: the program's per-step path as
its apps run it, `HeatDiffusion.scan_advance_fn(variant)`
(rocm_mpi_tpu_torch/models/diffusion.py), one call a run of nt steps.

Each run starts from the seed's T0 (stencil_bench/inputs/diffusion2d.py),
written in place into the state the last call returned, so the scan
driver binds it without a copy; Cp is the same every run, and the
advance prepares its coefficient once a call, as it does for every
caller. The first run builds or loads the kernels and captures the
graphs.

The check (stencil_bench/compare.py): the final field of a run on this
rank's whole shard against the plain reference
(stencil_bench/reference/diffusion.py) from the same T0 and Cp for the
same nt steps, on the shard grown by nt cells a side; the float32
control is that reference computed in float32.
"""

from __future__ import annotations

import gc

import torch

from stencil_bench import compare
from stencil_bench.inputs import diffusion2d as inputs
from stencil_bench.reference import diffusion as reference


def global_shape(config: dict, traffic: dict) -> tuple[int, ...]:
    """The global grid: the process grid times the cells a GPU holds (the
    port's shards do not overlap)."""
    return tuple(int(d) * int(n) for d, n in zip(config["process_grid"],
                                                  traffic["cells_per_gpu"]))


class Program:
    """This rank's model, advance and inputs for one cell."""

    def __init__(self, rank: int, config: dict, traffic: dict, device):
        from rocm_mpi_tpu_torch.config import DiffusionConfig
        from rocm_mpi_tpu_torch.models.diffusion import HeatDiffusion

        self.config, self.device = config, device
        self.shape = global_shape(config, traffic)
        self.lengths = tuple(float(x) for x in config["lengths"])
        self.lam, self.cp0 = float(config["lam"]), float(config["cp0"])
        self.nt = int(config["nt"])
        cfg = DiffusionConfig(global_shape=self.shape, lengths=self.lengths, lam=self.lam,
                              cp0=self.cp0, nt=self.nt, warmup=0, dtype=config["dtype"],
                              dims=tuple(config["process_grid"]),
                              b_width=tuple(config.get("b_width") or (32, 4)),
                              wire_mode=config["wire_mode"])
        self.model = HeatDiffusion(cfg, device=device)
        grid = self.model.grid
        self.region = grid.shard_slices()
        self.advance, self.q = self.model.scan_advance_fn(config["variant"], nt=self.nt,
                                                          warmup=0)
        self.vec = self.T = self.Cp = None
        self.facts = {"global_shape": self.shape, "local_shape": tuple(grid.local_shape),
                      "coords": tuple(grid.coords), "dims": tuple(grid.dims),
                      "itemsize": torch.empty(0, dtype=cfg.torch_dtype).element_size(),
                      "steps_per_run": self.nt}

    def set_seed(self, seed: int) -> None:
        self.vec = inputs.make_vectors(seed, self.shape, self.lengths,
                                       self.config["initial_condition"], self.cp0, self.device)
        dtype = self.model.config.torch_dtype
        if self.T is None:
            self.T = inputs.make_T0(self.vec, self.region, dtype)
        self.Cp = inputs.make_Cp(self.vec, self.region, dtype)

    def run(self) -> None:
        inputs.write_T0(self.vec, self.region, self.T)
        self.T = self.advance(self.T, self.Cp, self.nt)

    def output(self) -> torch.Tensor:
        return self.T

    def loop_facts(self) -> dict:
        from rocm_mpi_tpu_torch.ops import kernels

        loop = self.advance.loop
        return {"route": loop.route, "q": self.q, "capture_s": loop.capture_s,
                "launches": dict(kernels.LAUNCHES)}

    def release(self) -> None:
        self.advance.loop.release()
        self.advance = self.model = self.T = self.Cp = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, dtype):
        spacing = tuple(length / n for length, n in zip(self.lengths, self.shape))
        block, inner = reference.margin_region(self.region, self.shape, self.nt)
        T0 = inputs.make_T0(self.vec, block)
        R = reference.run(T0, inputs.make_Cp(self.vec, block), self.nt, self.lam,
                          reference.time_step(spacing, self.cp0, self.lam), spacing,
                          dtype=dtype)
        return T0[inner], R[inner]

    def readings(self, output) -> dict:
        """The widest gap of `output` from the float64 reference, and the
        widest move of the reference, on this rank's shard."""
        T0, R = self._reference(torch.float64)
        return compare.readings(output, R, T0)

    def control_output(self) -> torch.Tensor:
        return self._reference(torch.float32)[1]


def checks(config: dict, per_rank: list[dict]) -> dict:
    return {"err_over_change": {"value": compare.err_over_change(per_rank),
                                "limit": float(config["limits"]["err_over_change"])}}
