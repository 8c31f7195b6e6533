"""On the card: every one-chip cell runs correct through the command,
and the float32 control at the cell's own size comes out not correct.

    python -m pytest stencil_bench/tests -q -m card
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from stencil_bench import registry, run
from stencil_bench.tests import helpers


def _need_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s)")


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in registry.benchmark()["workloads"]])
def test_each_cell_runs_correct(workload):
    cell = registry.cell(workload)
    _need_cards(cell.chips)
    proc = subprocess.run([sys.executable, "-m", "stencil_bench.run", "--workload", workload,
                           "--seed", str(2 ** 31 + 77), "--seconds", "2"], cwd=registry.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check err_over_change")


@pytest.mark.card
@pytest.mark.parametrize("workload", ["diff2d-perf-f64-12288", "diff2d-perf-f64-252"])
def test_the_float32_control_at_the_cells_size_is_not_correct(workload):
    cell = registry.cell(workload)
    _need_cards(cell.chips)
    _, line = run.execute(cell, 2 ** 31 + 78, 1.0, False, device="cuda",
                          t_start=time.time(), rank_fn=helpers.control_rank)
    check = line["checks"]["err_over_change"]
    assert line["correct"] is False and check["value"] > 3 * check["limit"]
