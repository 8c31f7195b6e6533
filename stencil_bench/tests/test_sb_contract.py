"""The result line's contract on the CPU dry path, BENCHMARK.json's
contract, and the harness's refusals."""

from __future__ import annotations

import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

from stencil_bench import registry, run
from stencil_bench.tests import helpers

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _one_line(text: str, limit: int = 200) -> bool:
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_line_keys_on_the_cpu_dry_path(traced):
    cell = helpers.small_cell(helpers.PERF)
    ranks, line = run.execute(cell, 2 ** 31 + 11, 0.3, traced, device="cpu",
                              t_start=time.time())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    units = {m["name"]: m["unit"] for m in registry.benchmark()["end_to_end"]
             + registry.benchmark()["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and math.isfinite(m["value"])
    if traced:
        assert set(line["metrics"]) <= {m["name"] for m in registry.benchmark()["per_layer"]}
        assert dev["window_s"] > 0 and dev["busy_s"] >= 0
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(s, float) for n, s in rows)
    else:
        assert {"gcells_per_s", "setup_s"} <= set(line["metrics"])
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(line)


def test_main_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "stencil_bench.run", "--workload",
                           helpers.PERF, "--seed", "1", "--seconds", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone
    runs nothing: the program is missing, and no line is printed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "stencil_bench", tmp_path / "stencil_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from stencil_bench import run; "
            "from stencil_bench.tests import helpers; "
            "c = helpers.small_cell(helpers.PERF); "
            "print(run.execute(c, 1, 0.1, False, device='cpu', t_start=time.time())[1])")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "rocm_mpi_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["stencil_bench"]
    assert all(_one_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check with the 24 cells a benchmark may grow to fits in 12 hours.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("stencil_bench/") and (ROOT / c["file"]).is_file()
        config = registry.load_json(ROOT / c["file"])
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert config["limits"]["err_over_change"] > 0
        assert NAME.match(config["program"])
        assert (ROOT / "stencil_bench" / "programs" / f"{config['program']}.py").is_file()
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "stencil_bench" / "workloads" / f"{w['traffic']}.json").is_file()
        registry.cell(w["name"])  # the process grid matches the chips
        used.add(w["config"])
    assert used == set(names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _one_line(m["layer"])
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in cells}
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "stencil_bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        cell = registry.cell(w["name"])
        untraced = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in untraced and len(untraced) >= 2 and cell.metrics(True)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for path in (ROOT / "stencil_bench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
