"""Rules of the port that later slices must keep: it imports neither JAX
nor the JAX package, and its entry points run on the GPU unless the
caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.utils.backend import resolve_device, use_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "rocm_mpi_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "rocm_mpi_tpu", "__graft_entry__")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"kernels.py", "multistep.py", "halo.py", "deep_halo.py", "diffusion.py",
            "chip_smoke.py"} <= names


def test_scan_would_catch_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from rocm_mpi_tpu.ops import stencil\n    import jax.numpy\n")
    assert {m.split(".")[0] for m in _imported_modules(bad)} == {"rocm_mpi_tpu", "jax"}


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_the_gpu(monkeypatch):
    _no_cuda(monkeypatch)
    from rocm_mpi_tpu_torch.entry import entry
    from rocm_mpi_tpu_torch.models import HeatDiffusion

    cfg = DiffusionConfig(global_shape=(16, 16), dims=(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeatDiffusion(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    HeatDiffusion(cfg, device="cpu")  # the explicit ask is honoured


def test_dispatch_rules():
    assert use_kernel(torch.zeros(2)) is False
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        use_kernel(torch.zeros(2), torch.zeros(2, device="meta"))
