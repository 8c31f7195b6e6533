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
PORT_FILES = sorted((REPO / "rocm_mpi_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_trace_hide.py"] + sorted(
    (REPO / "scripts").glob("torch_*.py"))  # the port's benchmark harnesses
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
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    pkg = "rocm_mpi_tpu_torch/"
    assert {pkg + f for f in ("ops/kernels.py", "ops/multistep.py", "ops/wave.py",
                              "ops/swe.py", "parallel/halo.py", "parallel/deep_halo.py",
                              "parallel/overlap.py", "models/diffusion.py", "models/wave.py",
                              "models/swe.py", "apps/wave_2d.py", "apps/swe_2d.py",
                              "apps/diffusion_2d_perf_hide.py", "ops/kp.py",
                              "apps/diffusion_2d_kp.py", "apps/diffusion_2d_ap.py",
                              "parallel/ring.py", "parallel/wire.py",
                              "parallel/native_halo.py", "apps/ici_ring_test.py",
                              "entry.py", "apps/weak_scaling.py", "models/scan.py",
                              "parallel/mesh.py", "parallel/distributed.py",
                              "utils/metrics.py", "ops/resident.py",
                              "apps/_common.py", "utils/checkpoint.py",
                              "apps/diffusion_3d_perf_hide.py", "tuning/keys.py",
                              "tuning/cache.py", "tuning/space.py", "tuning/gate.py",
                              "tuning/resolve.py", "tuning/search.py", "tuning/__main__.py",
                              "tuning/__init__.py", "perf/traffic.py",
                              "resilience/__init__.py", "resilience/faults.py",
                              "resilience/preempt.py", "resilience/policy.py",
                              "resilience/supervisor.py", "resilience/reshard.py",
                              "resilience/elastic.py", "parallel/launcher.py",
                              "models/lanes.py", "serving/__init__.py", "serving/queue.py",
                              "serving/bins.py", "serving/slo.py", "serving/service.py",
                              "apps/serve.py", "telemetry/tracing.py",
                              "serving/journal.py", "serving/router.py", "apps/fleet.py",
                              "apps/soak.py", "utils/viz.py")} <= names
    assert {"chip_smoke.py", "chip_trace_hide.py"} <= names
    assert {"scripts/torch_kernel_ab.py", "scripts/torch_face_variants.py"} <= names


def test_fleet_modules_import_without_torch():
    # The journal and the router are stdlib at import, as the JAX ones are
    # (the telemetry read side validates fleet sidecars without torch);
    # viz imports matplotlib only when it draws.
    import subprocess
    import sys

    code = ("import sys; import rocm_mpi_tpu_torch.serving.journal, "
            "rocm_mpi_tpu_torch.serving.router, rocm_mpi_tpu_torch.telemetry.regress, "
            "rocm_mpi_tpu_torch.utils.viz; "
            "print(sorted(m for m in ('torch', 'matplotlib') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    assert out.strip() == "[]"


def test_fleet_and_soak_default_to_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from rocm_mpi_tpu_torch.apps import fleet, soak

    assert fleet.make_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        fleet.main(["--synthetic", "2", "--out", str(tmp_path / "f")])
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        soak.main(["--bounded", "--out", str(tmp_path / "s")])
    assert not (tmp_path / "s" / "soak-report.json").exists()


def _counted_launches():
    """Names counted by `LAUNCHES["name"] += 1` anywhere in the port."""
    found = set()
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript)
                    and getattr(node.target.value, "id", None) == "LAUNCHES"
                    and isinstance(node.target.slice, ast.Constant)):
                found.add(node.target.slice.value)
    return found


def test_every_kernel_counts_its_launches():
    # Each key of LAUNCHES is counted by a wrapper, and every count names a key.
    from rocm_mpi_tpu_torch.ops.kernels import LAUNCHES

    assert _counted_launches() == set(LAUNCHES)
    assert {"wave_step", "wave_step_masked", "wave_multi_step", "swe_step",
            "swe_multi_step", "fused_step_padded", "kp_flux", "kp_residual",
            "kp_update"} <= set(LAUNCHES)


def test_cpu_entry_points_launch_no_kernel():
    # A CPU run of every entry point takes the plain versions: no count moves.
    from rocm_mpi_tpu_torch.apps import diffusion_2d_ap, diffusion_2d_kp, swe_2d
    from rocm_mpi_tpu_torch.config import SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    reset_launches()
    heat = HeatDiffusion(DiffusionConfig(global_shape=(16, 16), nt=8, warmup=0, dims=(1, 1)),
                         device="cpu")
    for variant in heat.variants:
        heat.run(variant)
    heat.run_vmem_resident()
    heat.run_deep(block_steps=4)
    wave = AcousticWave(WaveConfig(global_shape=(16, 16), nt=8, warmup=0, dims=(1, 1)),
                        device="cpu")
    for variant in AcousticWave.VARIANTS:
        wave.run(variant)
    wave.run_vmem_resident()
    wave.run_deep(block_steps=4)
    swe = ShallowWater(SWEConfig(global_shape=(16, 16), nt=8, warmup=0, dims=(1, 1)),
                       device="cpu")
    for variant in ShallowWater.VARIANTS:
        swe.run(variant)
    swe.run_vmem_resident()
    swe.run_deep(block_steps=4)
    assert swe_2d.main(["--device", "cpu", "--nx", "16", "--ny", "16", "--nt", "8",
                        "--warmup", "0", "--deep", "4"]) == 0
    for app in (diffusion_2d_kp, diffusion_2d_ap):
        assert app.main(["--device", "cpu", "--nx", "16", "--ny", "16", "--nt", "8",
                         "--warmup", "0"]) == 0
    from rocm_mpi_tpu_torch.apps import diffusion_3d_perf_hide

    assert diffusion_3d_perf_hide.main(["--device", "cpu", "--nx", "16", "--ny", "16", "--nz",
                                        "16", "--nt", "8", "--warmup", "0"]) == 0
    assert "kp" in heat.variants
    assert set(LAUNCHES.values()) == {0}


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
    from rocm_mpi_tpu_torch.apps import diffusion_2d_ap, diffusion_2d_kp, swe_2d, weak_scaling
    from rocm_mpi_tpu_torch.config import SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.entry import entry
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    cfg = DiffusionConfig(global_shape=(16, 16), dims=(1, 1))
    wcfg = WaveConfig(global_shape=(16, 16), dims=(1, 1))
    scfg = SWEConfig(global_shape=(16, 16), dims=(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeatDiffusion(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AcousticWave(wcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShallowWater(scfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    # The app's default device is the card: without one it refuses.
    assert swe_2d.make_parser().parse_args([]).device == "cuda"
    assert weak_scaling.make_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        weak_scaling.main(["--local", "8", "--nt", "4", "--warmup", "0"])
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        swe_2d.main(["--nx", "16", "--ny", "16", "--nt", "4", "--warmup", "0"])
    from rocm_mpi_tpu_torch.apps import diffusion_3d_perf_hide

    for app in (diffusion_2d_kp, diffusion_2d_ap, diffusion_3d_perf_hide):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            app.main(["--nx", "16", "--ny", "16", "--nt", "4", "--warmup", "0"])
    HeatDiffusion(cfg, device="cpu")  # the explicit ask is honoured
    AcousticWave(wcfg, device="cpu")
    ShallowWater(scfg, device="cpu")


def test_dispatch_rules():
    assert use_kernel(torch.zeros(2)) is False
    with pytest.raises(RuntimeError, match="no kernel dispatch"):
        use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        use_kernel(torch.zeros(2), torch.zeros(2, device="meta"))


@pytest.mark.parametrize("extra", [[], ["--deep", "8", "--nt", "40"]], ids=["perf", "deep8"])
def test_swe_app_module_runs_on_cpu_and_reports_mass_drift(extra):
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.swe_2d", "--device", "cpu",
           "--nx", "48", "--ny", "40", "--nt", "24", "--warmup", "8", *extra]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "mass drift" in proc.stdout and "not a GPU measurement" in proc.stdout
    drift = float(proc.stdout.split("mass drift = ")[1].split()[0])
    assert drift <= 1e-13


def test_face_variants_script_finds_what_it_rewrites():
    # scripts/torch_face_variants.py rewrites these lines of csrc/stencil.cu
    # (the shared kernel's run length, register cap and launch bounds; the
    # f64 route's cells a lane, run length, launch bounds and its switch):
    # a rename there must fail here, not on the card.
    import importlib.util

    path = REPO / "scripts" / "torch_face_variants.py"
    spec = importlib.util.spec_from_file_location("torch_face_variants", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    src = (REPO / "rocm_mpi_tpu_torch" / "csrc" / "stencil.cu").read_text()
    assert len(script.MARKERS) == 8
    assert [m for m in script.MARKERS if m not in src] == []
    # Each variant rewrites what it names, and only its own route's lines.
    assert script.variant_source(src, "shared:8:6").count("if constexpr (false) {") == 1
    f64 = script.variant_source(src, "f64:2:1:8:6")
    assert "constexpr int kF64Cells2 = 2;" in f64 and "constexpr int kF64Cells3 = 1;" in f64
    assert "constexpr int kF64RunRows = 8;" in f64
    assert script.F64_LAUNCH.replace("32)", "32, 6)") in f64 and script.RUN in f64
    assert script.variant_source(src, "f64:4:2:3:0") == src  # the checkout's route
