"""The port's weak-scaling app (rocm_mpi_tpu_torch/apps/weak_scaling.py)
against the JAX package's apps/weak_scaling.py on the CPU:

* the app under torchrun on 1, 2 and 4 gloo ranks with --counts 1,2,4:
  one row per count it can run, the counts beyond the world skipped, the
  ranks that sit a rung out never deadlock, and every row has the keys
  and `dims` of the JAX app's row for the same count, `mechanics_only`
  true;
* in f64, the 4-rank `hide` rung's final field equal to the JAX
  package's HeatDiffusion(...).run("hide") on the same global grid
  within 1e-12, both started from JAX's initial state (the packages'
  Gaussian differs in the last place);
* `--autotune` runs the ladder with config="auto" (with a cold cache, the
  default chunk), and a variant the wave or the shallow water lacks exits
  2, as in JAX.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import test_torch_rank_worker as rank_worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeat
from rocm_mpi_tpu_torch.apps import weak_scaling
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNTS = (1, 2, 4)
ARGS = ["--device", "cpu", "--local", "16", "--nt", "20", "--warmup", "4", "--counts",
        "1,2,4", "--json"]


def _rows(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def jax_rows():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the app picks the CPU through --cpu-devices
    proc = subprocess.run(
        [sys.executable, str(REPO / "apps" / "weak_scaling.py"), "--cpu-devices", "4",
         "--local", "16", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return {row["devices"]: row for row in _rows(proc.stdout)}


def _port_app(world: int, *args):
    if world == 1:
        cmd = [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.weak_scaling", *args]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
               "-m", "rocm_mpi_tpu_torch.apps.weak_scaling", *args]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_app_rows_match_the_jax_rows(jax_rows, world):
    proc = _port_app(world, *ARGS)
    assert proc.returncode == 0, proc.stderr
    rows = _rows(proc.stdout)
    assert [row["devices"] for row in rows] == [n for n in COUNTS if n <= world]
    for n in COUNTS:
        if n > world:
            assert f"n={n}: skipped (only {world} ranks)" in proc.stdout
    assert set(jax_rows) == set(COUNTS)
    for row in rows:
        want = jax_rows[row["devices"]]
        assert set(row) == set(want) and row["dims"] == want["dims"]
        assert row["metric"] == want["metric"] == "weak-scaling hide 16²/dev"
        assert row["mechanics_only"] is True and want["mechanics_only"] is True
        assert np.isfinite([row["gpts"], row["gpts_per_device"], row["efficiency"]]).all()
    assert rows[0]["efficiency"] == 1.0
    assert "efficiency=100.0% vs n=1" in proc.stdout
    assert "not a GPU measurement" in proc.stdout


def test_hide_rung_f64_matches_jax():
    shape, dims = (32, 32), (2, 2)
    cfg = JaxConfig(global_shape=shape, lengths=(20.0, 20.0), nt=12, warmup=3, dtype="f64",
                    dims=dims)
    ref = JaxHeat(cfg, devices=jax.devices()[:4])
    state = tuple(np.asarray(a) for a in ref.init_state())
    spec = dict(jax_state=state, argv=["--device", "cpu", "--local", "16", "--nt", "12",
                                       "--warmup", "3", "--counts", "4", "--dtype", "f64",
                                       "--variant", "hide"])
    ranks = spawn_ranks(4, rank_worker.run_weak_scaling_rank, (spec,), backend="gloo",
                        timeout=240)
    rows, got = ranks[0]
    assert [(r["devices"], r["dims"]) for r in rows] == [(4, [2, 2])]
    want = np.asarray(ref.run("hide").T)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert not np.array_equal(got, state[0])  # the rung stepped


@pytest.mark.parametrize("flag", [["--autotune"]], ids=lambda f: f[0])
def test_unported_flags_raise(flag, tmp_path, capsys):
    from rocm_mpi_tpu_torch.tuning import resolve

    # --telemetry, --telemetry-windows, --health and --no-probes are real
    # (tests/test_torch_telemetry.py), and so is --autotune now: with a
    # cold tuning cache its one-rank ladder is the default ladder (the
    # warm four-rank case: tests/test_torch_tuning.py).
    resolve.configure(tmp_path / "cold.json")
    argv = ["--device", "cpu", "--local", "8", "--nt", "24", "--warmup", "8", "--json"]
    try:
        assert weak_scaling.main([*argv, *flag]) == 0
    finally:
        resolve.configure(None)
    tuned = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert weak_scaling.main(argv) == 0
    plain = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [r["devices"] for r in tuned] == [r["devices"] for r in plain] == [1]


def test_a_variant_the_workload_lacks_exits_2(capsys):
    assert weak_scaling.main(["--device", "cpu", "--workload", "wave", "--variant",
                              "kp"]) == 2
    assert "supports variants ap/perf/hide/deep, not 'kp'" in capsys.readouterr().out


def test_counts_sorted_and_defaulted():
    assert weak_scaling.parse_counts("4,1,2,4", 8) == [1, 2, 4]
    assert weak_scaling.parse_counts(None, 4) == [1, 2, 4]
    assert weak_scaling.parse_counts(None, 6) == [1, 2, 4]
    assert weak_scaling.parse_counts(None, 1) == [1]
