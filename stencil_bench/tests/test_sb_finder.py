"""A later change adds a program, a configuration, a traffic mix and a
metric as new files and entries alone: the finder reads them by name."""

from __future__ import annotations

import json
import shutil
import time

import pytest

from stencil_bench import registry, run

# A program of its own, in 3D, with its own inputs and reference: nothing
# of the diffusion adapter, its 2D inputs or its reference is used.
DECAY3D = '''
import torch


class Program:
    def __init__(self, rank, config, traffic, device):
        self.device, self.nt = device, int(config["nt"])
        self.shape = tuple(int(n) for n in traffic["cells_per_gpu"])
        self.facts = {"global_shape": self.shape, "local_shape": self.shape,
                      "coords": (0, 0, 0), "dims": (1, 1, 1), "itemsize": 8,
                      "steps_per_run": self.nt}

    def set_seed(self, seed):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.x0 = torch.rand(self.shape, generator=gen, dtype=torch.float64,
                             device=self.device)
        self.x = self.x0.clone()

    def run(self):
        self.x.copy_(self.x0)
        for _ in range(self.nt):
            self.x.mul_(0.5).add_(1.0)

    def output(self):
        return self.x

    def loop_facts(self):
        return {"route": "eager", "q": self.nt, "capture_s": 0.0, "launches": {}}

    def release(self):
        pass

    def readings(self, out):
        ref = self.x0.clone()
        for _ in range(self.nt):
            ref = ref * 0.5 + 1.0
        return {"gap": float((out - ref).abs().max())}

    def control_output(self):
        return self.x.float()


def checks(config, per_rank):
    return {"gap": {"value": max(r["gap"] for r in per_rank), "limit": 0.0}}
'''


def _copy_tree(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(registry.ROOT / "stencil_bench", tmp_path / "stencil_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "stencil_bench", json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_new_files_are_found_by_name(tmp_path):
    pkg, bench = _copy_tree(tmp_path)
    config = json.loads((pkg / "configs" / "diffusion2d-perf-f64.json").read_text())
    config.update(name="throwaway-perf", nt=24)
    (pkg / "configs" / "throwaway-perf.json").write_text(json.dumps(config))
    (pkg / "workloads" / "throwaway24.json").write_text(json.dumps(
        {"cells_per_gpu": [24, 24], "queued_runs": 1, "trace_skip_runs": 1,
         "trace_runs": 1}))
    (pkg / "metrics" / "throwaway.runs.py").write_text(
        "def read(ctx):\n    return float(ctx.ranks[0]['runs'])\n")
    bench["configs"].append({"name": "throwaway-perf", "source": "a test",
                             "file": "stencil_bench/configs/throwaway-perf.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-cell", "config": "throwaway-perf",
                               "traffic": "throwaway24", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "throwaway.runs", "unit": "runs",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("throwaway-cell", root=tmp_path)
    assert cell.config["nt"] == 24 and cell.traffic["cells_per_gpu"] == [24, 24]
    ranks, line = run.execute(cell, 5, 0.2, False, device="cpu", t_start=time.time())
    assert line["metrics"]["throwaway.runs"]["value"] == float(ranks[0]["runs"])
    assert line["metrics"]["throwaway.runs"]["unit"] == "runs"
    assert line["correct"] is True
    # The repository's own cells do not report the throwaway metric.
    other = registry.cell("diff2d-perf-f64-252", root=tmp_path)
    assert "throwaway.runs" not in {m["name"] for m in other.metrics(False)}


def test_a_new_program_is_found_by_name(tmp_path):
    """A 3D program that brings its own adapter, inputs and reference, with
    its configuration and traffic, runs through the harness unedited."""
    pkg, bench = _copy_tree(tmp_path)
    (pkg / "programs" / "throwaway_decay3d.py").write_text(DECAY3D)
    (pkg / "configs" / "throwaway-decay.json").write_text(json.dumps(
        {"name": "throwaway-decay", "program": "throwaway_decay3d", "nt": 6,
         "process_grid": [1, 1, 1], "reduced": []}))
    (pkg / "workloads" / "throwaway-box.json").write_text(json.dumps(
        {"cells_per_gpu": [3, 4, 5], "queued_runs": 1, "trace_skip_runs": 1,
         "trace_runs": 2}))
    bench["configs"].append({"name": "throwaway-decay", "source": "a test",
                             "file": "stencil_bench/configs/throwaway-decay.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway-decay-cell", "config": "throwaway-decay",
                               "traffic": "throwaway-box", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("throwaway-decay-cell", root=tmp_path)
    ranks, line = run.execute(cell, 7, 0.2, False, device="cpu", t_start=time.time())
    assert line["correct"] is True and line["checks"] == {"gap": {"value": 0.0,
                                                                   "limit": 0.0}}
    assert ranks[0]["global_shape"] == (3, 4, 5)
    steps = ranks[0]["runs"] * 6
    assert line["metrics"]["gcells_per_s"]["value"] == pytest.approx(
        60 * steps / max(r["window_s"] for r in ranks) / 1e9)
    ranks, line = run.execute(cell, 7, 0.2, True, device="cpu", t_start=time.time())
    assert line["correct"] is True and line["device"]["window_s"] > 0
