"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from stencil_bench import guard, registry

ROOT = registry.ROOT


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["rocm_mpi_tpu_torch", "rocm_mpi_tpu_torch.ops"]) == []
    assert guard.forbidden_loaded(["jaxtyping", "flaxen.x"]) == []
    assert guard.forbidden_loaded(["rocm_mpi_tpu.ops.x", "jaxlib.xla", "jax", "flax"]) == [
        "flax", "jax", "jaxlib", "rocm_mpi_tpu"]


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "stencil_bench").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & set(guard.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "stencil_bench" / "reference").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert tops <= {"__future__", "torch"}, (path, tops)
    code = ("import sys; from stencil_bench.reference import diffusion; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert not {"rocm_mpi_tpu_torch", "stencil_bench.cell"} & set(json.loads(
        out.replace("'", '"')))


def test_a_run_loads_no_forbidden_module():
    """Every module of the harness imported, every metric reader loaded,
    and a run of a cell on the CPU: no forbidden top-level name."""
    code = """
import sys, time
from stencil_bench import calibrate, guard, registry, run, sets
from stencil_bench.tests import helpers
for w in registry.benchmark()["workloads"]:
    c = registry.cell(w["name"])
    for m in c.metrics(False) + c.metrics(True):
        c.reader(m["name"])
run.execute(helpers.small_cell(helpers.PERF), 3, 0.1, False, device="cpu",
            t_start=time.time())
print("FOUND", guard.forbidden_loaded())
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "FOUND []"
