"""3D diffusion in the port (the diffusion_3D_perf_hide configuration:
apps/diffusion_3d_perf_hide.py's twin, --nz on the diffusion apps)
against the JAX package on the CPU, the cases of tests/test_diffusion_3d.py
at 24³ f64: `shard`, `perf` and `hide` against `ap` on 2×2×2 gloo ranks
(tests/test_torch_rank_worker.py `run_3d_rank`, from the JAX package's
initial state) and each against the JAX model's field on its 2×2×2 mesh;
the 3D app's --save-field against the JAX model's `hide`; the default
shell's clamp and boxes (no interior at 128³) against the JAX package's
decomposition; --nz and --fact in 3D; the 3D deep schedule's depth
degrading at the app's windows.

Tolerances: against `ap`, tests/test_diffusion_3d.py's rtol 1e-13 /
atol 1e-15; against the JAX package, f64 rtol 1e-12 / atol 1e-14."""

import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import test_torch_rank_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.parallel import overlap as jax_overlap
from rocm_mpi_tpu_torch.apps import _common, diffusion_3d_perf_hide
from rocm_mpi_tpu_torch.parallel import overlap
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPE, NT, B_WIDTH = (24, 24, 24), 20, (4, 4, 4)
TOL_AP = dict(rtol=1e-13, atol=1e-15)
TOL64 = dict(rtol=1e-12, atol=1e-14)


def _jax_model(dims=(2, 2, 2)):
    cfg = JaxConfig(global_shape=SHAPE, lengths=(10.0,) * 3, nt=NT, warmup=0,
                    b_width=B_WIDTH, dims=dims)
    return JaxHeatDiffusion(cfg, devices=jax.devices()[:int(np.prod(dims))])


@pytest.fixture(scope="module")
def jax_runs():
    model = _jax_model()
    state = tuple(np.asarray(a) for a in model.init_state())
    fields = {v: np.asarray(model.run(variant=v).T) for v in ("ap", "shard", "perf", "hide")}
    return state, fields


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    state, _ = jax_runs
    spec = dict(shape=SHAPE, dims=(2, 2, 2), nt=NT, b_width=B_WIDTH, jax_state=state,
                variants=("ap", "shard", "perf", "hide"))
    ranks = spawn_ranks(8, worker.run_3d_rank, (spec,), backend="gloo", timeout=300)
    return ranks


@pytest.mark.parametrize("variant", ["shard", "perf", "hide"])
def test_3d_variant_matches_ap_on_2x2x2_ranks(port_runs, variant):
    got = port_runs[0]
    np.testing.assert_allclose(got[variant], got["ap"], **TOL_AP)
    assert all(set(r["launches"].values()) == {0} for r in port_runs)  # plain versions


@pytest.mark.parametrize("variant", ["ap", "shard", "perf", "hide"])
def test_3d_variant_matches_the_jax_model(port_runs, jax_runs, variant):
    _, fields = jax_runs
    np.testing.assert_allclose(port_runs[0][variant], fields[variant], **TOL64)


def test_3d_app_save_field_matches_jax_hide(jax_runs, tmp_path):
    _, fields = jax_runs
    out = tmp_path / "hide3d.npy"
    cmd = [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide",
           "--device", "cpu", "--nx", "24", "--ny", "24", "--nz", "24", "--nt", str(NT),
           "--warmup", "0", "--dtype", "f64", "--b-width", "4,4,4", "--save-field", str(out)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "grid (24, 24, 24) f64" in proc.stdout
    assert "runs the perf step" in proc.stdout  # one rank
    np.testing.assert_allclose(np.load(out), fields["hide"], **TOL64)


def _jax_boxes(local, bw):
    """The JAX package's hide decomposition of a shard, read from its
    region splice: (every box, the ghost-free ones)."""
    splice = jax_overlap._make_region_splice(
        types.SimpleNamespace(local_shape=local, ndim=len(local)), None, bw, False)
    cells = dict(zip(splice.__code__.co_freevars, splice.__closure__))
    boxes = cells["all_boxes"].cell_contents
    ghost_free = cells["ghost_free"].cell_contents
    return boxes, [b for b in boxes if ghost_free(b)]


@pytest.mark.parametrize("local, b_width", [((128, 128, 128), (8, 8, 128)),
                                            ((128, 128, 128), (8, 8, 8)),
                                            ((24, 24, 24), (4, 4, 4))])
def test_hide_boxes_match_jax(local, b_width):
    bw = overlap.effective_b_width(local, b_width)
    assert bw == jax_overlap.effective_b_width(local, b_width)
    boxes = overlap.region_boxes(local, bw)
    inner = [b for b in boxes if overlap.ghost_free(b, local)]
    jboxes, jinner = _jax_boxes(local, bw)
    assert boxes == jboxes and inner == jinner
    if b_width == (8, 8, 128):
        # The app's default shell clamps to (8, 8, 64): no interior to hide.
        assert bw == (8, 8, 64) and inner == [] and len(boxes) == 6
    else:
        assert len(inner) == 1 and len(boxes) == 7


def test_default_frame_note_names_the_clamp():
    grid = types.SimpleNamespace(local_shape=(128, 128, 128), nprocs=4)
    note = _common.hide_note(grid, (8, 8, 128))
    assert "clamped to (8, 8, 64)" in note and "0 interior box(es), 6 slab box(es)" in note


def test_nz_and_fact_make_a_3d_grid():
    parser = _common.make_parser("hide", nx=128, ny=128, nz=128, nt=100, dtype="f32")
    args = parser.parse_args([])
    assert _common.grid_shape(args, 3) == (128, 128, 128)
    args = parser.parse_args(["--nx", "32", "--ny", "24", "--nz", "16"])
    assert _common.grid_shape(args, 3 if args.nz else 2) == (32, 24, 16)
    args = parser.parse_args(["--fact", "2"])
    assert _common.grid_shape(args, 3) == (2048, 2048, 2048)
    flat = _common.make_parser("perf", nx=64, ny=64, nt=10, dtype="f32").parse_args(
        ["--fact", "1"])
    assert flat.nz == 0 and _common.grid_shape(flat, 3 if flat.nz else 2) == (1024, 1024)
    app = diffusion_3d_perf_hide  # its defaults: BASELINE.json's diffusion_3D_perf_hide
    assert app.main.__module__ == "rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide"


def test_app_defaults_and_nz_on_the_2d_app(capsys):
    assert diffusion_3d_perf_hide.main(["--device", "cpu", "--nx", "16", "--ny", "16",
                                        "--nz", "16", "--nt", "4", "--warmup", "0"]) == 0
    out = capsys.readouterr().out
    assert "grid (16, 16, 16) f32" in out and "b_width (8, 8, 128) clamped to (8, 8, 8)" in out
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    assert diffusion_2d_perf.main(["--device", "cpu", "--nx", "16", "--ny", "12", "--nz", "8",
                                   "--nt", "4", "--warmup", "0"]) == 0
    assert "grid (16, 12, 8) f32" in capsys.readouterr().out


def test_3d_deep_degrades_at_the_apps_windows(capsys):
    assert diffusion_3d_perf_hide.main(["--device", "cpu", "--nx", "24", "--ny", "24", "--nz",
                                        "24", "--deep", "8"]) == 0
    out = capsys.readouterr().out
    assert "k=2, degraded from 8" in out and "deep2: local route" in out
