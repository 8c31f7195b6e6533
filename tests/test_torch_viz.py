"""The port's pictures (rocm_mpi_tpu_torch/utils/viz.py and the apps'
--vis/--no-vis/--vis-shards) against the JAX package's, on the CPU: the
same artifact names, the same pixels for the same field, the JAX apps'
defaults (on for ap and kp, off elsewhere), PNGs from the apps in 2D, 3D
(the mid-z slice) and as shard panels, and a clean refusal (exit 2,
naming --no-vis) where matplotlib is missing."""

import importlib
import sys
import types

import numpy as np
import pytest

from rocm_mpi_tpu.utils import viz as jviz
from rocm_mpi_tpu_torch.apps import _common
from rocm_mpi_tpu_torch.utils import viz

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("variant,nprocs,shape", [
    ("ap", 1, (128, 128)), ("perf", 4, (12288, 12288)), ("hide", 8, (128, 128, 128)),
    ("swe_perf", 2, (48, 40)), ("wave_deep8", 1, (252, 252))])
def test_artifact_names_are_the_jax_names(variant, nprocs, shape):
    assert viz.artifact_name(variant, nprocs, shape) == \
        jviz.artifact_name(variant, nprocs, shape)


def _field(shape):
    x = np.linspace(-1.0, 1.0, shape[0])[:, None]
    y = np.linspace(-1.0, 1.0, shape[1])[None, :]
    f = np.exp(-4 * (x ** 2 + y ** 2)) * np.cos(3 * x)
    return f if len(shape) == 2 else f[..., None] * np.linspace(0.5, 1.0, shape[2])


@pytest.mark.parametrize("shape", [(24, 16), (16, 16, 8)], ids=["2d", "3d"])
def test_heatmap_pixels_equal_jax(shape, tmp_path):
    import matplotlib.image as mpimg

    field = _field(shape)
    a = viz.save_heatmap(field, tmp_path / "port" / "t.png", title="t")
    b = jviz.save_heatmap(field, tmp_path / "jax" / "t.png", title="t")
    assert a.read_bytes()[:8] == PNG
    assert np.array_equal(mpimg.imread(a), mpimg.imread(b))
    with pytest.raises(ValueError):
        viz.save_heatmap(np.zeros(4), tmp_path / "bad.png")


@pytest.mark.parametrize("signed", [False, True])
def test_shard_panels_equal_jax(signed, tmp_path):
    import matplotlib.image as mpimg

    grid = types.SimpleNamespace(nprocs=4, dims=(2, 2))
    field = _field((24, 16))
    a = viz.save_shard_panels_artifact(field, grid, "swe_perf", tmp_path / "port", signed)
    b = jviz.save_shard_panels_artifact(field, grid, "swe_perf", tmp_path / "jax", signed)
    assert a.name == b.name == "poc_swe_perf_4.png"
    assert np.array_equal(mpimg.imread(a), mpimg.imread(b))
    with pytest.raises(ValueError, match="2D-only"):
        viz.save_shard_panels(_field((8, 8, 4)), (2, 2), tmp_path / "x.png")


APPS = {"diffusion_2d_ap": True, "diffusion_2d_kp": True, "diffusion_2d_perf": False,
        "diffusion_2d_perf_hide": False, "diffusion_3d_perf_hide": False,
        "diffusion_2d_perf_hide_prof": False, "wave_2d": False, "swe_2d": False}


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("app", sorted(APPS))
def test_vis_defaults_are_the_jax_apps(app, monkeypatch):
    """Each app's parsed options where it first checks the picture."""
    def stop(args):
        raise _Parsed(args)

    mod = importlib.import_module(f"rocm_mpi_tpu_torch.apps.{app}")
    monkeypatch.setattr(_common, "check_vis", stop)
    if hasattr(mod, "check_vis"):
        monkeypatch.setattr(mod, "check_vis", stop)
    for argv, want in (([], APPS[app]), (["--no-vis"], False), (["--vis"], True)):
        with pytest.raises(_Parsed) as got:
            mod.main(argv)
        assert got.value.args[0].do_vis is want and got.value.args[0].vis_shards is False


SMALL = ["--device", "cpu", "--nx", "16", "--ny", "16", "--nt", "4", "--warmup", "0"]


@pytest.mark.parametrize("app,extra,names", [
    ("diffusion_2d_ap", ["--vis-shards"], ["Temp_ap_1_16_16.png", "poc_ap_1.png"]),
    ("diffusion_2d_kp", [], ["Temp_kp_1_16_16.png"]),
    ("diffusion_2d_perf", ["--vis", "--deep", "2"], ["Temp_deep2_1_16_16.png"]),
    ("diffusion_3d_perf_hide", ["--vis", "--nz", "8"], ["Temp_hide_1_16_16_8.png"]),
    ("wave_2d", ["--vis"], ["Temp_wave_perf_1_16_16.png"]),
    ("swe_2d", ["--vis", "--vis-shards"], ["Temp_swe_perf_1_16_16.png",
                                           "poc_swe_perf_1.png"]),
])
def test_apps_write_their_pictures(app, extra, names, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(_common, "OUTPUT_DIR", tmp_path)
    mod = importlib.import_module(f"rocm_mpi_tpu_torch.apps.{app}")
    assert mod.main(SMALL + extra) == 0
    out = capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
    for name in names:
        assert (tmp_path / name).read_bytes()[:8] == PNG
        assert f"wrote {tmp_path / name}" in out


def test_apps_without_vis_draw_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_common, "OUTPUT_DIR", tmp_path)
    from rocm_mpi_tpu_torch.apps import diffusion_2d_kp, diffusion_2d_perf

    assert diffusion_2d_perf.main(SMALL) == 0
    assert diffusion_2d_kp.main(SMALL + ["--no-vis"]) == 0
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("app,extra", [("diffusion_2d_ap", []), ("diffusion_2d_kp", []),
                                       ("wave_2d", ["--vis"]), ("swe_2d", ["--vis"]),
                                       ("diffusion_2d_perf_hide_prof", ["--vis"])])
def test_vis_refuses_without_matplotlib(app, extra, tmp_path, monkeypatch, capsys):
    """matplotlib patched away (as on a machine without it): an app whose
    picture is on exits 2 before its run, naming --no-vis; with --no-vis it
    runs."""
    monkeypatch.setattr(_common, "OUTPUT_DIR", tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not viz.available()
    mod = importlib.import_module(f"rocm_mpi_tpu_torch.apps.{app}")
    with pytest.raises(SystemExit) as e:
        mod.main(SMALL + extra)
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert "--no-vis" in captured.err and "Executed" not in captured.out
    if app != "diffusion_2d_perf_hide_prof":
        assert mod.main(SMALL + ["--no-vis"]) == 0
    assert list(tmp_path.iterdir()) == []
