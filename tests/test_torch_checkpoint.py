"""Checkpointed runs of the port (rocm_mpi_tpu_torch/utils/checkpoint.py
and the apps' --checkpoint/--ckpt-every/--resume) on the CPU, the
counterparts of tests/test_checkpoint.py and of the storage cases of
tests/test_storage_preempt.py: segmented runs bitwise equal to straight
runs (one rank and 2×2 gloo ranks), crash and resume into a fresh model,
interval and window validation, corruption falling back, the storage
policy's retry, degrade, ENOSPC prune and watchdog through a
monkeypatched writer, the scan driver's exact segments and its graph
count, and the JAX package's checkpointing of the same SWE state (f64,
rtol 1e-12 / atol 1e-14, tests/test_torch_swe.py's tolerance)."""

import errno
import json
import pathlib
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

import test_torch_rank_worker as worker
from rocm_mpi_tpu.models.swe import ShallowWater as JaxSWE
from rocm_mpi_tpu.models.swe import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.utils import checkpoint as jax_ckpt
from rocm_mpi_tpu_torch.config import SWEConfig
from rocm_mpi_tpu_torch.models import ShallowWater, scan
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
from rocm_mpi_tpu_torch.state import swe_state_from_numpy
from rocm_mpi_tpu_torch.utils import checkpoint as ckpt
from test_torch_scan import _toy_step, fake_cuda  # noqa: F401 (a fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL64 = dict(rtol=1e-12, atol=1e-14)
NT = 16
EVERY = 4


def _swe(driver="step", every=None, nt=48, dims=(1, 1)):
    """(model, advance(state, n) -> state, state): the shallow water's
    perf advance at 32² f64 over (h, us)."""
    cfg = SWEConfig(global_shape=(32, 32), nt=nt, warmup=0, dtype="f64", dims=dims)
    model = ShallowWater(cfg, device="cpu")
    Mus = model.face_masks()
    if driver == "scan":
        advance, _ = model.scan_advance_fn("perf", nt=every, warmup=0, exact=True)
    else:
        advance = model.advance_fn("perf")

    def adv(s, n):
        return tuple(advance(s[0], s[1], Mus, n))

    adv.loop = getattr(advance, "loop", None)
    return model, adv, model.init_state()


def _clone(state):
    return state[0].clone(), tuple(u.clone() for u in state[1])


def _equal(a, b):
    fa, fb = ckpt.tree_leaves(a), ckpt.tree_leaves(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


def _policy(**kw):
    base = dict(retries=2, backoff_s=0.01, backoff_factor=2.0)
    base.update(kw)
    return ckpt.StoragePolicy(**base)


# ---------------------------------------------------------------------------
# Segmented runs, resume, validation
# ---------------------------------------------------------------------------


def test_segmented_run_bitwise_equals_straight(tmp_path):
    _, adv, state = _swe()
    ref = adv(_clone(state), 48)
    out = ckpt.run_segmented(adv, state, 48, tmp_path, every=16)
    assert _equal(out, ref)
    assert ckpt.latest_step(tmp_path) == 48
    assert ckpt.all_steps(tmp_path) == [16, 32, 48]


def test_crash_resume_lands_on_straight_run(tmp_path):
    _, adv, state = _swe()
    ref = adv(_clone(state), 48)
    ckpt.run_segmented(adv, state, 32, tmp_path, every=16)  # "crashes" after 32
    assert ckpt.latest_valid_step(tmp_path) == 32
    model, adv, like = _swe()  # a fresh model and template, as --resume
    restored = ckpt.restore_state(tmp_path, 32, like)
    for r, t in zip(ckpt.tree_leaves(restored), ckpt.tree_leaves(like)):
        assert r.data_ptr() != t.data_ptr() and r.device == t.device
    out = ckpt.run_segmented(adv, restored, 48, tmp_path, every=16, start_step=32)
    assert _equal(out, ref)


def test_interval_and_window_validation(tmp_path):
    _, adv, state = _swe()
    with pytest.raises(ValueError, match="interval"):
        ckpt.run_segmented(adv, state, 8, tmp_path, every=0)
    with pytest.raises(ValueError, match="start_step"):
        ckpt.run_segmented(adv, state, 8, tmp_path, every=4, start_step=9)


def test_latest_step_empty_dir(tmp_path):
    assert ckpt.latest_step(tmp_path / "nonexistent") is None
    assert ckpt.latest_valid_step(tmp_path / "nonexistent") is None
    assert ckpt.all_steps(tmp_path) == []


def test_keep_prunes_steps_with_their_manifests(tmp_path):
    _, adv, state = _swe()
    ckpt.run_segmented(adv, state, 48, tmp_path, every=8)
    assert ckpt.all_steps(tmp_path) == [32, 40, 48]
    assert sorted(p.name for p in tmp_path.glob("manifest-*.json")) == [
        "manifest-32.json", "manifest-40.json", "manifest-48.json"]
    assert not list(tmp_path.glob(".*partial"))


@pytest.mark.parametrize("damage", ["truncate", "no-manifest"])
def test_damaged_newest_step_falls_back(tmp_path, damage):
    _, adv, state = _swe()
    ckpt.run_segmented(adv, state, 48, tmp_path, every=16)
    if damage == "truncate":
        leaf = tmp_path / "48" / "rank-0" / "leaf-1.npy"
        leaf.write_bytes(leaf.read_bytes()[:-9])
        ok, reason = ckpt.verify_step(tmp_path, 48)
        assert not ok and "resized" in reason
    else:
        (tmp_path / "manifest-48.json").unlink()
        assert ckpt.verify_step(tmp_path, 48) == (False, "no manifest")
    lines = []
    assert ckpt.latest_step(tmp_path) == 48
    assert ckpt.latest_valid_step(tmp_path, log=lines.append) == 32
    assert len(lines) == 1 and "checkpoint step 48 failed validation" in lines[0]


def test_flipped_byte_is_never_restored(tmp_path):
    _, adv, state = _swe()
    ckpt.run_segmented(adv, state, 32, tmp_path, every=16)
    leaf = tmp_path / "32" / "rank-0" / "leaf-0.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-5] ^= 0x40
    leaf.write_bytes(bytes(raw))
    assert ckpt.latest_valid_step(tmp_path) == 32  # the sizes still match
    _, _, like = _swe()
    with pytest.raises(ckpt.CheckpointCorruptionError, match="crc32"):
        ckpt.restore_state(tmp_path, 32, like)
    restored = ckpt.restore_state(tmp_path, 16, like)  # the older step is sound
    assert restored[0].shape == like[0].shape


def test_manifest_keys_and_jax_validation(tmp_path):
    _, adv, state = _swe()
    ckpt.run_segmented(adv, state, 16, tmp_path, every=16)
    manifest = json.loads((tmp_path / "manifest-16.json").read_text())
    assert manifest["v"] == 2 and manifest["step"] == 16
    assert manifest["treedef"] == "PyTreeDef((*, (*, *)))"
    assert manifest["meta"]["mesh"] == {"dims": [1, 1], "axes": ["gx", "gy"]}
    assert manifest["meta"]["specs"] == [["gx", "gy"]] * 3
    assert sorted(manifest["files"]) == [f"rank-0/leaf-{i}.npy" for i in range(3)]
    h = ckpt.restore_state(tmp_path, 16, None, devices="cpu")[0]
    assert manifest["leaves"][0] == {
        "shape": [32, 32], "dtype": "float64",
        "crc32": zlib.crc32(np.ascontiguousarray(h.numpy()).tobytes())}
    assert manifest["shards"][0]["crc32"][0] == manifest["leaves"][0]["crc32"]
    assert jax_ckpt.validate_manifest_meta(manifest) == []
    assert ckpt.validate_manifest_meta(manifest) == []


def test_bf16_state_round_trips(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = (torch.rand(12, 10, generator=g).to(torch.bfloat16),
             torch.rand(12, 10, generator=g, dtype=torch.float64))
    ckpt.save_state(tmp_path, 3, state)
    manifest = ckpt.read_manifest(tmp_path, 3)
    assert [rec["dtype"] for rec in manifest["leaves"]] == ["bfloat16", "float64"]
    got = ckpt.restore_state(tmp_path, 3, tuple(torch.zeros_like(t) for t in state))
    assert _equal(got, state) and got[0].dtype == torch.bfloat16


def test_topology_mismatch(tmp_path):
    _, _, state = _swe()
    ckpt.save_state(tmp_path, 8, state)
    h, us = state
    with pytest.raises(ckpt.TopologyMismatch, match="leaves"):
        ckpt.restore_state(tmp_path, 8, (h,))
    with pytest.raises(ckpt.TopologyMismatch, match="global shape"):
        ckpt.restore_state(tmp_path, 8, (h[:16], us))
    with pytest.raises(ckpt.TopologyMismatch, match="dtype"):
        ckpt.restore_state(tmp_path, 8, (h.float(), us))
    # Onto another process grid: each rank's block, bit for bit.
    for rank in range(2):
        other = init_global_grid(32, 32, dims=(2, 1), nprocs=2, rank=rank)
        block = ckpt.restore_state(tmp_path, 8, None, grid=other, devices="cpu")
        rows = slice(16 * rank, 16 * (rank + 1))
        assert _equal(block, (h[rows], *(u[rows] for u in us)))
    flat = ckpt.restore_state(tmp_path, 8, None, devices="cpu")
    assert isinstance(flat, tuple) and _equal(flat, state)


# ---------------------------------------------------------------------------
# The storage policy
# ---------------------------------------------------------------------------


@pytest.fixture
def faulty_writer(monkeypatch):
    """Make the writer fail at chosen steps: `plan[(step, kind)] = times`
    fails the next `times` saves of `step` with `kind` (an errno, or
    "slow" to sleep 0.3 s first)."""
    plan = {}
    real = ckpt._write_array

    def write(path, a):
        step = int(path.parent.parent.name.strip(".").split(".")[0])
        for (at, kind), left in list(plan.items()):
            if at == step and left > 0:
                if path.name.startswith("leaf-0"):
                    plan[(at, kind)] = left - 1
                if kind == "slow":
                    import time

                    time.sleep(0.3)
                    continue
                raise OSError(kind, f"injected {errno.errorcode[kind]}")
        real(path, a)

    monkeypatch.setattr(ckpt, "_write_array", write)
    return plan


def _model_16():
    _, adv, state = _swe(nt=NT)
    return adv, state


def test_transient_io_error_retries_and_completes(tmp_path, faulty_writer):
    adv, state = _model_16()
    ref = adv(_clone(state), NT)
    faulty_writer[(8, errno.EIO)] = 1
    waits, lines = [], []
    out = ckpt.run_segmented(adv, state, NT, tmp_path, every=EVERY,
                             storage=_policy(sleep=waits.append), log=lines.append)
    assert _equal(out, ref)
    assert ckpt.all_steps(tmp_path)[-1] == NT
    assert waits == [0.01]
    assert len(lines) == 1 and "checkpoint step 8: save attempt 0 failed" in lines[0]


def test_io_error_outage_degrades_bounds_loss_and_recovers(tmp_path, faulty_writer):
    adv, state = _model_16()
    ref = adv(_clone(state), NT)
    faulty_writer[(8, errno.EIO)] = 3
    faulty_writer[(12, errno.EIO)] = 1
    lines = []
    out = ckpt.run_segmented(adv, state, NT, tmp_path, every=EVERY, keep=8,
                             storage=_policy(sleep=lambda _: None), log=lines.append)
    assert _equal(out, ref)
    assert ckpt.all_steps(tmp_path) == [4, 16]  # 8 and 12 lost; 4 stayed valid
    assert ckpt.latest_valid_step(tmp_path) == 16
    text = "\n".join(lines)
    assert "step 8: save failed after 3 attempt(s)" in text and "bounded by step 4" in text
    assert "step 12: storage still degraded" in text
    assert "step 16: storage recovered after 2 skipped save(s)" in text


def test_degrade_off_raises_after_retries(tmp_path, faulty_writer):
    adv, state = _model_16()
    faulty_writer[(8, errno.EIO)] = 3
    with pytest.raises(OSError):
        ckpt.run_segmented(adv, state, NT, tmp_path, every=EVERY,
                           storage=_policy(degrade=False, sleep=lambda _: None))
    assert ckpt.all_steps(tmp_path) == [4]  # no torn step left behind
    assert ckpt.latest_valid_step(tmp_path) == 4
    assert not list(tmp_path.glob(".*partial"))


def test_enospc_prunes_keep_list_then_save_lands(tmp_path, faulty_writer):
    adv, state = _model_16()
    ckpt.run_segmented(adv, state, 8, tmp_path, every=EVERY, keep=8)
    assert ckpt.all_steps(tmp_path) == [4, 8]
    faulty_writer[(12, errno.ENOSPC)] = 1
    _, _, like = _swe(nt=NT)
    restored = ckpt.restore_state(tmp_path, 8, like)
    lines = []
    ckpt.run_segmented(adv, restored, NT, tmp_path, every=EVERY, start_step=8, keep=8,
                       storage=_policy(sleep=lambda _: None), log=lines.append)
    assert ckpt.all_steps(tmp_path) == [8, 12, 16]  # 4 sacrificed, the newest kept
    assert lines == ["checkpoint step 12: ENOSPC — pruned kept step(s) [4] to make room, "
                     "retrying"]


def test_enospc_outage_with_nothing_to_prune_degrades(tmp_path, faulty_writer):
    _, adv, state = _swe(nt=20)
    faulty_writer[(8, errno.ENOSPC)] = 2
    faulty_writer[(12, errno.ENOSPC)] = 1
    lines = []
    ckpt.run_segmented(adv, state, 20, tmp_path, every=EVERY, keep=8,
                       storage=_policy(retries=1, sleep=lambda _: None), log=lines.append)
    assert ckpt.all_steps(tmp_path) == [4, 16, 20]
    text = "\n".join(lines)
    assert "pruned kept step(s) [] to make room" in text
    assert "entering DEGRADED mode" in text and "recovered after 2 skipped" in text


def test_io_slow_watchdog_degrades_but_keeps_the_saves(tmp_path, faulty_writer):
    adv, state = _model_16()
    faulty_writer[(8, "slow")] = 1
    faulty_writer[(12, "slow")] = 1
    lines = []
    ckpt.run_segmented(adv, state, NT, tmp_path, every=EVERY, keep=8,
                       storage=_policy(slow_save_timeout_s=0.2, sleep=lambda _: None),
                       log=lines.append)
    assert ckpt.all_steps(tmp_path) == [4, 8, 12, 16]  # nothing lost
    assert "step 8: save took" in lines[0] and "entering DEGRADED mode" in lines[0]
    assert "step 12: save took" in lines[1] and "still slow" in lines[1]
    assert "step 16: storage recovered" in lines[2]


def test_save_state_stays_loud(tmp_path, faulty_writer):
    _, state = _model_16()
    faulty_writer[(4, errno.EIO)] = 3
    with pytest.raises(OSError):
        ckpt.save_state(tmp_path, 4, state, storage=_policy(sleep=lambda _: None))
    faulty_writer[(8, errno.EIO)] = 1
    ckpt.save_state(tmp_path, 8, state, storage=_policy(sleep=lambda _: None))
    assert ckpt.latest_valid_step(tmp_path) == 8


def test_restore_retries_transient_io_error(tmp_path, monkeypatch):
    _, state = _model_16()
    ckpt.save_state(tmp_path, 4, state)
    real, failed = ckpt._read_array, []

    def read(path):
        if not failed:
            failed.append(path)
            raise OSError(errno.EIO, "injected EIO")
        return real(path)

    monkeypatch.setattr(ckpt, "_read_array", read)
    monkeypatch.setattr(ckpt.time, "sleep", lambda s: None)
    lines = []
    out = ckpt.restore_state(tmp_path, 4, None, devices="cpu", log=lines.append)
    assert _equal(out, state) and len(failed) == 1
    assert "restore attempt 0 failed" in lines[0]


def test_storage_policy_from_env(monkeypatch):
    monkeypatch.setenv("RMT_CKPT_RETRIES", "5")
    monkeypatch.setenv("RMT_CKPT_BACKOFF_S", "0.125")
    monkeypatch.setenv("RMT_CKPT_SLOW_S", "2.5")
    monkeypatch.setenv("RMT_CKPT_DEGRADE", "0")
    monkeypatch.setenv("RMT_CKPT_PROBE_EVERY", "3")
    p = ckpt.StoragePolicy.from_env()
    assert (p.retries, p.backoff_s, p.slow_save_timeout_s, p.degrade,
            p.probe_every) == (5, 0.125, 2.5, False, 3)
    monkeypatch.setenv("RMT_CKPT_RETRIES", "garbage")
    monkeypatch.delenv("RMT_CKPT_DEGRADE")
    p = ckpt.StoragePolicy.from_env()
    assert p.retries == ckpt.DEFAULT_SAVE_RETRIES and p.degrade is True


# ---------------------------------------------------------------------------
# The scan driver's segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("every", [1, 5, 12, 16])
def test_scan_segments_run_exactly_their_steps(tmp_path, every):
    _, step_adv, state = _swe()
    ref = step_adv(_clone(state), 48)
    _, adv, state = _swe(driver="scan", every=every)
    assert adv.loop.exact and adv.loop.plan.q == every
    out = ckpt.run_segmented(adv, state, 48, tmp_path, every=every)
    assert _equal(out, ref)


@pytest.mark.parametrize("every", [1, 5, 12, 16])
def test_scan_graph_count_does_not_grow_per_segment(fake_cuda, tmp_path, every):  # noqa: F811
    g = torch.Generator().manual_seed(0)
    T0 = torch.rand(12, 8, generator=g, dtype=torch.float64)
    C = torch.full((12, 8), 0.1, dtype=torch.float64)
    plan = scan.graph_plan(every, 2)
    loop = scan.ScanLoop(_toy_step, plan, "scan-graph", exact=True)
    counts = []

    def advance(s, n):
        (T,) = loop((s[0],), (C,), n)
        counts.append(len(loop.graphs))
        return (T,)

    out = ckpt.run_segmented(advance, (T0.clone(),), 48, tmp_path, every=every)
    eager = scan.ScanLoop(_toy_step, scan.graph_plan(48, 2), "scan-eager", exact=True)
    (ref,) = eager((T0.clone(),), (C,), 48)
    assert torch.equal(out[0], ref)
    assert len(counts) == -(-48 // every)
    full = counts if 48 % every == 0 else counts[:-1]
    assert set(full) == {plan.graphs}  # captured at the first segment, then reused
    assert counts[-1] <= plan.graphs + plan.period


# ---------------------------------------------------------------------------
# Against the JAX package, and on 2×2 gloo ranks
# ---------------------------------------------------------------------------


def test_port_segmented_swe_matches_jax_run_segmented(tmp_path):
    cfg = JaxSWEConfig(global_shape=(32, 32), lengths=(10.0, 10.0), nt=48, warmup=0,
                       dtype="f64", dims=(1, 1))
    jmodel = JaxSWE(cfg, devices=jax.devices()[:1])
    h, us = jmodel.init_state()
    h_np, us_np = np.asarray(h), [np.asarray(u) for u in us]  # before any donation
    Mus = jmodel.face_masks()
    jadv = jmodel.advance_fn("perf")
    jout = jax_ckpt.run_segmented(lambda s, n: tuple(jadv(s[0], s[1], Mus, n)), (h, us), 48,
                                  tmp_path / "jax", every=16)
    model, adv, _ = _swe(driver="scan", every=16)
    state = swe_state_from_numpy(h_np, us_np, model.grid, device="cpu")
    out = ckpt.run_segmented(adv, state, 48, tmp_path / "port", every=16)
    for got, want in zip(ckpt.tree_leaves(out), [jout[0], *jout[1]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL64)
    port = ckpt.read_manifest(tmp_path / "port", 48)
    assert jax_ckpt.validate_manifest_meta(port) == []
    theirs = jax_ckpt.read_manifest(tmp_path / "jax", 48)
    assert [r["shape"] for r in port["leaves"]] == [r["shape"] for r in theirs["leaves"]]
    assert [r["dtype"] for r in port["leaves"]] == [r["dtype"] for r in theirs["leaves"]]
    assert port["meta"]["mesh"]["dims"] == theirs["meta"]["mesh"]["dims"]


def test_segmented_and_resumed_runs_on_2x2_gloo_ranks(tmp_path):
    spec = dict(shape=(32, 32), dims=(2, 2), nt=48, dir=str(tmp_path))
    ranks = spawn_ranks(4, worker.run_checkpoint_rank, (spec,), backend="gloo", timeout=300)
    for r in ranks:
        assert r["step_segments"] and r["scan_segments"]
        assert r["start"] == 32 and r["resumed"] and r["fresh_tensors"] and r["like_none"]
    manifest = ranks[0]["manifest"]
    assert manifest["meta"]["mesh"]["dims"] == [2, 2]
    assert all(rec["crc32"] is None and rec["shape"] == [32, 32]
               for rec in manifest["leaves"])
    assert [s["rank"] for s in manifest["shards"]] == [0, 1, 2, 3]
    assert [s["coords"] for s in manifest["shards"]] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert sorted(manifest["files"]) == sorted(f"rank-{r}/leaf-{i}.npy" for r in range(4)
                                               for i in range(3))
    assert jax_ckpt.validate_manifest_meta(manifest) == []


# ---------------------------------------------------------------------------
# The apps (subprocess, CPU)
# ---------------------------------------------------------------------------


def _app(app, *argv, rc=0):
    cmd = [sys.executable, "-m", f"rocm_mpi_tpu_torch.apps.{app}", "--device", "cpu", *argv]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == rc, (proc.returncode, proc.stdout, proc.stderr)
    return proc


def test_app_checkpoint_then_resume(tmp_path):
    """A run checkpointed at nt=24, then resumed to nt=48, ends on the
    field of one straight 48-step run."""
    d, straight, resumed = tmp_path / "ck", tmp_path / "straight.npy", tmp_path / "res.npy"
    common = ["--nx", "24", "--ny", "24", "--warmup", "0"]
    _app("swe_2d", *common, "--nt", "48", "--save-field", str(straight))
    _app("swe_2d", *common, "--nt", "24", "--checkpoint", str(d), "--ckpt-every", "12")
    out = _app("swe_2d", *common, "--nt", "48", "--checkpoint", str(d), "--resume",
               "--save-field", str(resumed)).stdout
    assert "restoring step 24" in out and "graph(s) captured for the whole run" in out
    np.testing.assert_array_equal(np.load(resumed), np.load(straight))


def test_app_deep_interval_rounds_to_the_quantum(tmp_path):
    out = _app("swe_2d", "--nx", "24", "--ny", "24", "--warmup", "0", "--deep", "8", "--nt",
               "24", "--checkpoint", str(tmp_path / "ck"), "--ckpt-every", "10").stdout
    assert "rounded to 16" in out
    assert ckpt.all_steps(tmp_path / "ck") == [16, 24]


def test_app_resume_refuses_quantum_misaligned_checkpoint(tmp_path):
    d = tmp_path / "ck"
    common = ["--nx", "24", "--ny", "24", "--warmup", "0", "--checkpoint", str(d)]
    _app("swe_2d", *common, "--nt", "12", "--ckpt-every", "6")
    proc = _app("swe_2d", *common, "--nt", "36", "--deep", "9", "--resume", rc=2)
    assert "not a multiple of the schedule's step quantum" in proc.stdout


@pytest.mark.parametrize("flag", [["--retries", "1"], ["--inject-fault", "crash@step=4"]])
def test_app_refuses_the_unported_resilience_flags(tmp_path, flag):
    """The two flags the port once refused now work: --retries supervises
    the checkpointed run; --inject-fault crashes it at step 4, after the
    step-4 save, and --resume then ends on the straight run's field."""
    d, straight, got = tmp_path / "ck", tmp_path / "straight.npy", tmp_path / "got.npy"
    common = ["--nx", "24", "--ny", "24", "--nt", "8", "--warmup", "0"]
    _app("swe_2d", *common, "--save-field", str(straight))
    ckpt_args = [*common, "--checkpoint", str(d), "--ckpt-every", "4"]
    if flag[0] == "--retries":
        out = _app("swe_2d", *ckpt_args, *flag, "--save-field", str(got)).stdout
        assert "supervised run: up to 1 restart(s)" in out
    else:
        proc = _app("swe_2d", *ckpt_args, *flag, rc=1)
        assert "InjectedCrash" in proc.stderr and "not ported" not in proc.stderr
        assert ckpt.latest_valid_step(d) == 4
        _app("swe_2d", *ckpt_args, "--resume", "--save-field", str(got))
    np.testing.assert_array_equal(np.load(got), np.load(straight))


def test_app_vmem_with_checkpoint_is_refused(tmp_path):
    proc = _app("wave_2d", "--nx", "24", "--ny", "24", "--nt", "8", "--vmem", "--checkpoint",
                str(tmp_path / "ck"), rc=2)
    assert "drop --vmem" in proc.stdout


def test_wave_app_checkpoint_resume_and_save_field(tmp_path):
    d, straight, resumed = tmp_path / "ck", tmp_path / "s.npy", tmp_path / "r.npy"
    common = ["--nx", "24", "--ny", "20", "--warmup", "0", "--dtype", "f64"]
    _app("wave_2d", *common, "--nt", "30", "--save-field", str(straight))
    _app("wave_2d", *common, "--nt", "20", "--checkpoint", str(d), "--ckpt-every", "7")
    _app("wave_2d", *common, "--nt", "30", "--checkpoint", str(d), "--resume",
         "--save-field", str(resumed))
    np.testing.assert_array_equal(np.load(resumed), np.load(straight))
    assert np.load(straight).shape == (24, 20)
