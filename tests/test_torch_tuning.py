"""The port's tuning plane (rocm_mpi_tpu_torch/tuning/, perf/traffic.py)
against the JAX package's (rocm_mpi_tpu/tuning/, perf/traffic.py) on the
CPU:

* keys: the same on-disk spelling for the same call site;
* space and gate: the same candidates for every op but masked_step, whose
  knob is the port kernel's run length (run_rows r, modeled as the JAX
  gate models tm = 8r), and the same (ok, ratio, measured, ideal) for
  every candidate and for doctored entries, on the issue's grid of shapes
  in f32/f64/bf16;
* traffic: the three analytic ideals equal, and wire.DEFAULT_LADDER equal
  to the JAX package's committed ladder (perf/budgets.json);
* cache: atomic, torn, foreign, stale (and JAX-written) and byte-identical;
* resolve: hits and misses, the sanitizer;
* config="auto": bitwise the defaults on a cold cache and the explicit
  knobs on a warm one (the three VMEM loops, the three scan drivers,
  run_deep's k and wire mode, a k deeper than the shard, masked_step's run
  length), and the port's auto run against the JAX package's, given
  equivalent caches, within the run_vmem_resident parity tolerance;
* search and the CLI: winners, pure hits, the gate's teeth, exit codes;
* four gloo ranks: every rank resolves rank 0's config, and weak_scaling
  --autotune emits tune.hits/tune.misses.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tuning_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxDiffusionConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.perf import traffic as jtraffic
from rocm_mpi_tpu.tuning import gate as jgate
from rocm_mpi_tpu.tuning import keys as jkeys
from rocm_mpi_tpu.tuning import resolve as jresolve
from rocm_mpi_tpu.tuning import space as jspace
from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.ops import multistep as M
from rocm_mpi_tpu_torch.ops import swe as S
from rocm_mpi_tpu_torch.ops import wave as W
from rocm_mpi_tpu_torch.parallel import deep_halo, wire
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid
from rocm_mpi_tpu_torch.perf import traffic
from rocm_mpi_tpu_torch.telemetry import compiles
from rocm_mpi_tpu_torch.tuning import cache, gate, keys, resolve, search, space
from rocm_mpi_tpu_torch.tuning.__main__ import main as cli

SHAPES = [(16, 16), (20, 24), (252, 252), (400, 400), (1448, 1448), (16, 16, 16)]
DTYPES = ["f32", "f64", "bf16"]
OPS = [op for op in keys.KNOWN_OPS if op != "diffusion.masked_step"]
TOL = {"f64": dict(rtol=1e-12, atol=1e-14)}


@pytest.fixture(autouse=True)
def isolated(tmp_path):
    """Each test its own cache files and fresh resolve state in both
    packages (resolve keeps its snapshot by design)."""
    path = tmp_path / "cache.json"
    resolve.configure(path)
    resolve.reset_stats()
    jresolve.configure(tmp_path / "jax-cache.json")
    jresolve.reset_stats()
    yield path
    for mod in (resolve, jresolve):
        mod.configure(None)
        mod.refresh()
        mod.reset_stats()


def _entry(config, fp=None):
    return {"config": config, "median_us": 1.0, "compile_s": 0.1, "gate_ratio": 1.0,
            "fingerprint": fp or keys.fingerprint("cpu")}


def _write(path, entries):
    doc = cache.empty_doc()
    doc["entries"].update(entries)
    cache.write_doc(path, doc)
    resolve.refresh()


def _key(op, shape, topology=None, dtype="f32"):
    return keys.key_str(keys.tuning_key(op, shape, dtype, topology, backend="cpu"))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", keys.KNOWN_OPS)
def test_key_str_equals_jax(op):
    assert keys.KNOWN_OPS == jkeys.KNOWN_OPS
    assert (keys.CACHE_KIND, keys.CACHE_VERSION) == (jkeys.CACHE_KIND, jkeys.CACHE_VERSION)
    for shape in SHAPES:
        for dtype, tdtype in (("f32", torch.float32), ("f64", torch.float64),
                              ("bf16", torch.bfloat16)):
            for topo in (None, (2,) * len(shape)):
                ours = keys.tuning_key(op, shape, tdtype, topo, backend=torch.device("cpu"))
                want = jkeys.tuning_key(op, shape, dtype, topo, backend="cpu")
                assert keys.key_str(ours) == jkeys.key_str(want)
                assert keys.parse_key(jkeys.key_str(want)) == ours


def test_keys_need_the_device_and_read_its_type():
    with pytest.raises(ValueError, match="device the call runs on"):
        keys.tuning_key("diffusion.scan", (16, 16), "f32")
    assert keys.tuning_key("diffusion.scan", (16, 16), "f32", backend="cuda:1").backend == "cuda"
    with pytest.raises(ValueError, match="backend"):
        keys.tuning_key("diffusion.scan", (16, 16), "f32", backend="tpu")
    assert keys.fingerprint("cpu") == {"torch": torch.__version__, "backend": "cpu"}
    for bad in ("a|b", "nope|16x16|f32|1x1|cpu", "diffusion.scan|16xq|f32|1x1|cpu"):
        with pytest.raises(ValueError):
            keys.parse_key(bad)


# ---------------------------------------------------------------------------
# Space and gate
# ---------------------------------------------------------------------------


def _verdict(g):
    return (g.ok, g.ratio, g.measured_bytes, g.ideal_bytes, g.budget)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_space_and_gate_equal_jax(op, dtype):
    for shape in SHAPES:
        for backend in ("cpu", "cuda"):
            ours = space.enumerate_space(op, shape, dtype, backend=backend)
            assert ours == jspace.enumerate_space(op, shape, dtype,
                                                  backend="cpu" if backend == "cpu" else "tpu")
        for config in space.enumerate_space(op, shape, dtype):
            assert (_verdict(gate.validate_config(op, shape, dtype, config))
                    == _verdict(jgate.validate_config(op, shape, dtype, config))), config


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_step_space_is_the_run_length(dtype):
    budget = M._VMEM_BLOCK_BUDGET_BYTES
    for shape in SHAPES:
        cands = space.enumerate_space("diffusion.masked_step", shape, dtype)
        big = np.prod(shape) * space.compute_itemsize(dtype) > budget
        assert cands == ([{"run_rows": r} for r in (1, 2, 4)] if big else [])
        if not big:
            assert jspace.enumerate_space("diffusion.masked_step", shape, dtype) == []
        for c in cands:
            # A warp's run of r rows reads T (r+2)/r times over: the JAX
            # gate's model of a stripe of tm = 8r rows.
            r = c["run_rows"]
            ours = gate.validate_config("diffusion.masked_step", shape, dtype, c)
            want = jgate.validate_config("diffusion.masked_step", shape, dtype, {"tm": 8 * r})
            assert _verdict(ours) == _verdict(want)
            assert ours.ok == (r > 1)
            assert ours.ratio == pytest.approx((2 + (r + 2) / r) / 3, rel=1e-6)


DOCTORED = [
    ("diffusion.vmem_loop", (140, 140), {"body_form": "eqc", "pad_pow2": True, "chunk": 16}),
    ("diffusion.vmem_loop", (16, 16), {"chunk": 3}),
    ("diffusion.vmem_loop", (16, 16), {"chunk": 24}),
    ("diffusion.vmem_loop", (16, 16), {"chunk": True}),
    ("diffusion.vmem_loop", (16, 16), {"body_form": "bogus"}),
    ("diffusion.vmem_loop", (16, 16), {"pad_pow2": "yes"}),
    ("diffusion.vmem_loop", (16, 16), {"chunk": 4, "wire_mode": "bf16"}),
    ("diffusion.deep", (16, 16), {"k": 0}),
    ("diffusion.deep", (16, 16), {"k": 32}),
    ("diffusion.deep", (16, 16), {"k": 8, "wire_mode": "f16"}),
    ("diffusion.deep", (64, 64), {"k": 8, "wire_mode": "int8_delta"}),
    ("diffusion.scan", (16, 16), {"chunk": 16, "wire_mode": "int8"}),
    ("diffusion.scan", (16, 16), {"chunk": 16, "wire_mode": "bf16"}),
    ("wave.scan", (16, 16, 16), {"chunk": 256}),
]


@pytest.mark.parametrize("op, shape, config", DOCTORED, ids=lambda v: str(v))
def test_doctored_entries_gate_as_jax(op, shape, config):
    for dtype in DTYPES:
        ours = gate.validate_config(op, shape, dtype, config)
        want = jgate.validate_config(op, shape, dtype, config)
        assert _verdict(ours) == _verdict(want)
        assert bool(ours.reason) == (not ours.ok)


def test_gate_run_rows_must_be_a_positive_int():
    for bad in (0, -1, 2.0, True, None, "4"):
        assert not gate.validate_config("diffusion.masked_step", (1448, 1448), "f32",
                                        {"run_rows": bad}).ok
    assert gate.BUDGETS == jgate.BUDGETS


# ---------------------------------------------------------------------------
# Traffic ideals and the wire ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_traffic_ideals_equal_jax(shape):
    for itemsize in (2, 4, 8):
        for width in (1, 2, 8):
            assert (traffic.ideal_exchanged_step_bytes(shape, itemsize, width)
                    == jtraffic.ideal_exchanged_step_bytes(shape, itemsize, width))
            assert (traffic.ideal_deep_sweep_bytes(shape, itemsize, width)
                    == jtraffic.ideal_deep_sweep_bytes(shape, itemsize, width))
            for mode in wire.WIRE_MODES:
                assert (traffic.ideal_wire_bytes(shape, itemsize, width, mode)
                        == jtraffic.ideal_wire_bytes(shape, itemsize, width, mode))


def test_wire_ladder_equals_the_committed_budgets():
    assert wire.DEFAULT_LADDER == jtraffic.load_budgets()["wire"]["ladder"]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def test_cache_writes_atomically_and_byte_identically(tmp_path):
    path = tmp_path / "sub" / "c.json"
    key = keys.tuning_key("wave.vmem_loop", (16, 16), "f32", backend="cpu")
    cache.store(path, key, _entry({"chunk": 16}))
    blob = path.read_bytes()
    assert not (tmp_path / "sub" / "c.json.tmp").exists()
    assert cache.validate_doc(json.loads(blob)) == []
    cache.store(path, key, _entry({"chunk": 16}))
    assert path.read_bytes() == blob
    assert cache.lookup(cache.load(path), key, keys.fingerprint("cpu")) == {"chunk": 16}
    assert cache.default_cache_path().endswith("output/tuning/cache_torch.json")


def test_cache_torn_and_foreign_files_read_empty_once(tmp_path):
    torn = tmp_path / "torn.json"
    torn.write_text('{"v": 1, "kind": ')
    with pytest.warns(UserWarning) as got:
        assert cache.load(torn) == cache.empty_doc()
    assert len(got) == 1
    alien = tmp_path / "alien.json"
    alien.write_text(json.dumps({"v": 2, "kind": "something-else", "entries": {}}))
    with pytest.warns(UserWarning, match="not a v1"):
        assert cache.load(alien) == cache.empty_doc()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cache.load(tmp_path / "missing.json") == cache.empty_doc()


def test_cache_stale_and_jax_entries_miss_and_stay(tmp_path):
    path = tmp_path / "c.json"
    key = keys.tuning_key("diffusion.scan", (16, 16), "f32", backend="cpu")
    other = keys.tuning_key("wave.scan", (16, 16), "f32", backend="cpu")
    stale = {keys.key_str(key): _entry({"chunk": 16}, {"torch": "0.0", "backend": "cpu"})}
    for fp in ({"torch": "0.0", "backend": "cpu"}, {"torch": torch.__version__,
                                                     "backend": "cuda"},
               jkeys.fingerprint("cpu")):
        _write(path, {keys.key_str(key): _entry({"chunk": 16}, fp)})
        assert cache.lookup(cache.load(path), key, keys.fingerprint("cpu")) is None
    _write(path, stale)
    cache.store(path, other, _entry({"chunk": 64}))
    doc = cache.load(path)
    assert keys.key_str(key) in doc["entries"]  # never deleted
    assert cache.lookup(doc, other, keys.fingerprint("cpu")) == {"chunk": 64}
    # A JAX-written document is a miss for the port, never an error.
    jdoc = cache.empty_doc()
    jdoc["entries"][keys.key_str(key)] = _entry({"chunk": 16}, jkeys.fingerprint("cpu"))
    cache.write_doc(path, jdoc)
    resolve.refresh()
    assert resolve.resolve("diffusion.scan", (16, 16), "f32", device="cpu") is None
    problems = cache.validate_doc(jdoc)
    assert problems and "fingerprint needs torch+backend" in problems[0]


# ---------------------------------------------------------------------------
# Resolve
# ---------------------------------------------------------------------------


def test_resolve_hits_misses_and_stats(isolated):
    _write(isolated, {_key("diffusion.vmem_loop", (20, 24)): _entry({"body_form": "conly"})})
    assert resolve.resolve("diffusion.vmem_loop", (20, 24), torch.float32,
                           device=torch.device("cpu")) == {"body_form": "conly"}
    assert resolve.resolve("diffusion.vmem_loop", (64, 64), "f32", device="cpu") is None
    assert resolve.stats() == {"hits": 1, "misses": 1}
    isolated.write_text("{{{{")
    resolve.refresh()
    with pytest.warns(UserWarning):
        assert resolve.resolve("diffusion.vmem_loop", (20, 24), "f32", device="cpu") is None


@pytest.mark.parametrize("config", [
    {"chunk": -8, "body_form": "bogus", "pad_pow2": "yes"},
    {"chunk": 16, "body_form": "conly", "pad_pow2": True, "k": 8, "wire_mode": "bf16"},
    {"chunk": 2.0, "k": True, "wire_mode": "f16", "extra": 1},
    {"k": 0, "chunk": 0},
])
def test_sanitize_as_jax(config):
    want = jresolve._sanitize(config)
    assert resolve._sanitize(config) == want
    # The masked_step knob: run_rows where JAX has tm.
    assert resolve._sanitize({"run_rows": 2, "tm": 16}) == {"run_rows": 2}
    for bad in (0, -1, True, 2.5, "2"):
        assert resolve._sanitize({"run_rows": bad}) == {}


# ---------------------------------------------------------------------------
# config="auto": cold = defaults, warm = the explicit knobs, bitwise
# ---------------------------------------------------------------------------


def _models(shape=(16, 16), nt=32, warmup=16, dtype="f32", dims=None):
    common = dict(global_shape=shape, lengths=(10.0,) * len(shape), nt=nt, warmup=warmup,
                  dtype=dtype, dims=dims or (1,) * len(shape))
    return (HeatDiffusion(DiffusionConfig(**common), device="cpu"),
            AcousticWave(WaveConfig(**common), device="cpu"),
            ShallowWater(SWEConfig(**common), device="cpu"))


def _eq(a, b):
    assert torch.equal(a, b)


def test_auto_equals_default_on_a_cold_cache():
    diff, wave, swe = _models()
    _eq(diff.run_vmem_resident(config="auto").T, diff.run_vmem_resident().T)
    _eq(wave.run_vmem_resident(config="auto").U, wave.run_vmem_resident().U)
    _eq(swe.run_vmem_resident(config="auto").h, swe.run_vmem_resident().h)
    for model, leaf in ((diff, "T"), (wave, "U"), (swe, "h")):
        a, b = model.run("perf", driver="scan", config="auto"), model.run("perf", driver="scan")
        _eq(getattr(a, leaf), getattr(b, leaf))
        assert a.k == b.k
    a, b = diff.run_deep(config="auto"), diff.run_deep()
    _eq(a.T, b.T)
    assert a.k == b.k
    assert resolve.stats()["hits"] == 0 and resolve.stats()["misses"] >= 8


@pytest.mark.parametrize("body_form, pad", [("eqc", False), ("eqc", True), ("conly", False)])
def test_diffusion_vmem_auto_is_the_explicit_run(isolated, body_form, pad):
    shape = (20, 24)
    tuned = {"body_form": body_form, "pad_pow2": pad, "chunk": 4}
    # An entry of another dtype is another key: a miss.
    _write(isolated, {_key("diffusion.vmem_loop", shape): _entry(tuned)})
    diff = _models(shape, dtype="f64")[0]
    _eq(diff.run_vmem_resident(config="auto").T, diff.run_vmem_resident().T)
    assert resolve.stats() == {"hits": 0, "misses": 1}
    _write(isolated, {_key("diffusion.vmem_loop", shape, dtype="f64"): _entry(tuned)})
    got = diff.run_vmem_resident(config="auto")
    want = diff.run_vmem_resident(chunk=4, body_form=body_form, pad_pow2=pad)
    _eq(got.T, want.T)
    assert got.k == want.k == 4 and resolve.stats()["hits"] == 1
    # conly is another floating-point expression than the default eqc:
    # within the run_vmem_resident parity tolerance of the default.
    np.testing.assert_allclose(got.T.numpy(), diff.run_vmem_resident().T.numpy(), **TOL["f64"])
    # The ops-level planner takes the same knobs from the same entry.
    T, Cp = diff.init_state()
    _eq(M.fused_multi_step(T, Cp, 1.0, diff.dt_value, diff.config.spacing, 8, config="auto"),
        M.fused_multi_step(T, Cp, 1.0, diff.dt_value, diff.config.spacing, 8, chunk=4,
                           body_form=body_form, pad_pow2=pad))


def test_wave_and_swe_vmem_auto_are_the_explicit_runs(isolated):
    shape = (20, 24)
    _write(isolated, {_key("wave.vmem_loop", shape): _entry({"chunk": 4}),
                      _key("swe.vmem_loop", shape): _entry({"chunk": 8})})
    _, wave, swe = _models(shape)
    a, b = wave.run_vmem_resident(config="auto"), wave.run_vmem_resident(chunk=4)
    _eq(a.U, b.U)
    assert a.k == 4
    a, b = swe.run_vmem_resident(config="auto"), swe.run_vmem_resident(chunk=8)
    _eq(a.h, b.h)
    assert a.k == 8
    U, Uprev, C2 = wave.init_state()
    _eq(W.wave_multi_step(U, Uprev, C2, 0.01, wave.config.spacing, 8, config="auto")[0],
        W.wave_multi_step(U, Uprev, C2, 0.01, wave.config.spacing, 8, chunk=4)[0])
    h, us = swe.init_state()
    Mus = swe.face_masks()
    cfg = swe.config
    _eq(S.swe_multi_step(h, us, Mus, cfg.dt, cfg.spacing, cfg.H0, cfg.g, 16, config="auto")[0],
        S.swe_multi_step(h, us, Mus, cfg.dt, cfg.spacing, cfg.H0, cfg.g, 16, chunk=8)[0])
    assert resolve.stats()["hits"] == 4


def test_unadoptable_chunks_keep_the_defaults(isolated):
    shape = (16, 16)
    _write(isolated, {_key("diffusion.vmem_loop", shape): _entry({"chunk": 2}),
                      _key("wave.vmem_loop", shape): _entry({"chunk": 12})})
    diff, wave, _ = _models(shape)
    a, b = diff.run_vmem_resident(config="auto"), diff.run_vmem_resident()
    _eq(a.T, b.T)
    assert a.k == b.k == 16
    _eq(wave.run_vmem_resident(config="auto").U, wave.run_vmem_resident().U)


@pytest.mark.parametrize("index, op", enumerate(["diffusion.scan", "wave.scan", "swe.scan"]))
def test_scan_auto_chunk_is_the_explicit_chunk(isolated, index, op):
    model = _models()[index]
    leaf = ("T", "U", "h")[index]
    _write(isolated, {_key(op, (16, 16)): _entry({"chunk": 4})})
    a = model.run("perf", driver="scan", config="auto")
    advance, q = model.scan_advance_fn("perf", chunk=4)
    assert a.k == q == 4
    _eq(getattr(a, leaf), getattr(model.run("perf", driver="scan"), leaf))
    # A preference: gcd'd against the windows (16 | 16) without a warning,
    # and an explicit chunk leaves the config unread.
    _write(isolated, {_key(op, (16, 16)): _entry({"chunk": 64})})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert model.scan_advance_fn("perf", config="auto")[1] == 16
    assert model.scan_advance_fn("perf", chunk=2, config="auto")[1] == 2
    with pytest.raises(ValueError, match="config must be"):
        model.scan_advance_fn("perf", config="fast")


def test_deep_auto_is_the_explicit_run_and_a_deep_k_falls_back(isolated):
    diff = _models((16, 16), nt=24, warmup=8, dtype="f64")[0]
    _write(isolated, {_key("diffusion.deep", (16, 16), dtype="f64"):
                      _entry({"k": 4, "wire_mode": "bf16"})})
    a, b = diff.run_deep(config="auto"), diff.run_deep(block_steps=4, wire_mode="bf16")
    _eq(a.T, b.T)
    assert a.k == 4 and diff.effective_wire_mode(config="auto") == "bf16"
    # A cached depth deeper than the shard (an entry that outlived a
    # reshard) falls back to the default policy.
    _write(isolated, {_key("diffusion.deep", (16, 16), dtype="f64"): _entry({"k": 32})})
    a, b = diff.run_deep(config="auto"), diff.run_deep()
    _eq(a.T, b.T)
    assert a.k == b.k
    grid = init_global_grid(16, 16, lengths=(10.0, 10.0), dims=(1, 1))
    assert deep_halo.resolve_deep_k(grid, torch.float64, "auto", "cpu") is None
    assert deep_halo.resolve_deep_k(grid, torch.float64, None) is None


def test_masked_step_run_rows_auto_and_explicit(isolated):
    shape = (800, 700)  # 2.24 MB in f32: past the VMEM budget
    rng = np.random.default_rng(3)
    T = torch.from_numpy(rng.random(shape).astype(np.float32))
    Cm = torch.from_numpy((rng.random(shape) * 1e-4).astype(np.float32))
    assert K.masked_run_rows(T, config="auto") == 0
    _write(isolated, {_key("diffusion.masked_step", shape): _entry({"run_rows": 2})})
    assert K.masked_run_rows(T, config="auto") == 2
    assert K.masked_run_rows(T, 4, config="auto") == 4
    assert K.masked_run_rows(T[:64, :64].contiguous(), config="auto") == 0  # VMEM-class
    want = K.masked_step(T, Cm, (0.1, 0.1))
    _eq(K.masked_step(T, Cm, (0.1, 0.1), config="auto"), want)
    _eq(K.masked_step(T, Cm, (0.1, 0.1), run_rows=1), want)
    for bad in (0, -2, 1.5, True):
        with pytest.raises(ValueError, match="run_rows"):
            K.masked_step(T, Cm, (0.1, 0.1), run_rows=bad)
    with pytest.raises(ValueError, match="config must be"):
        K.masked_step(T, Cm, (0.1, 0.1), config="fast")
    assert K._SIGNATURES["rmt_masked_step"][1].count(K.C_INT) == 4


def test_port_auto_agrees_with_jax_auto(isolated, tmp_path):
    shape, tuned = (16, 16), {"body_form": "eqc", "pad_pow2": False, "chunk": 4}
    _write(isolated, {_key("diffusion.vmem_loop", shape, dtype="f64"): _entry(tuned)})
    jdoc = cache.empty_doc()
    jkey = jkeys.key_str(jkeys.tuning_key("diffusion.vmem_loop", shape, "f64", backend="cpu"))
    jdoc["entries"][jkey] = _entry(tuned, jkeys.fingerprint("cpu"))
    cache.write_doc(tmp_path / "jax-cache.json", jdoc)
    jresolve.refresh()
    common = dict(global_shape=shape, lengths=(10.0, 10.0), nt=16, warmup=8, dtype="f64",
                  dims=(1, 1))
    ours = HeatDiffusion(DiffusionConfig(**common), device="cpu").run_vmem_resident(
        config="auto")
    ref = JaxHeatDiffusion(JaxDiffusionConfig(**common)).run_vmem_resident(config="auto")
    assert jresolve.stats()["hits"] == 1 and resolve.stats()["hits"] == 1
    assert ours.k == 4
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), **TOL["f64"])


def test_every_auto_path_accepts_only_the_three_configs():
    diff, wave, swe = _models()
    for bad in ("fast", 1):
        with pytest.raises(ValueError, match="config must be"):
            diff.run_vmem_resident(config=bad)
        with pytest.raises(ValueError, match="config must be"):
            wave.run_vmem_resident(config=bad)
        with pytest.raises(ValueError, match="config must be"):
            swe.run_vmem_resident(config=bad)
        with pytest.raises(ValueError, match="config must be"):
            diff.effective_deep_depth(config=bad)
    assert M.plan_vmem_loop((16, 16), torch.float32, 16, config="auto", device="cpu") == \
        M.plan_vmem_loop((16, 16), torch.float32, 16)
    with pytest.raises(ValueError, match="device the call runs on"):
        M.plan_vmem_loop((16, 16), torch.float32, 16, config="auto")


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def test_search_persists_a_winner_then_is_a_pure_hit(tmp_path, monkeypatch):
    path = tmp_path / "s.json"
    cands = [{"body_form": "eqc", "pad_pow2": False, "chunk": 4},
             {"body_form": "conly", "pad_pow2": False, "chunk": 4}]
    r1 = search.search_op("diffusion.vmem_loop", (16, 16), "f32", repeats=1, cache_path=path,
                          candidates=cands, device="cpu")
    assert r1["status"] == "tuned" and r1["entry"]["config"] in cands
    assert len(r1["measured"]) == 2
    assert cache.validate_doc(cache.load(path)) == []
    assert r1["entry"]["fingerprint"] == keys.fingerprint("cpu")

    def no_runs(*a):
        raise AssertionError("a warm cache measures nothing")

    monkeypatch.setattr(search, "_make_runner", no_runs)
    r2 = search.search_op("diffusion.vmem_loop", (16, 16), "f32", repeats=1, cache_path=path,
                          candidates=cands, device="cpu")
    assert r2["status"] == "hit" and r2["entry"]["config"] == r1["entry"]["config"]


def test_search_gate_rejects_a_doctored_fast_winner(tmp_path, monkeypatch):
    overbudget = {"body_form": "eqc", "pad_pow2": True, "chunk": 4}
    honest = {"body_form": "eqc", "pad_pow2": False, "chunk": 4}
    monkeypatch.setattr(search, "_make_runner",
                        lambda op, shape, dtype, device: lambda c: 1e-6 if c["pad_pow2"] else 1e-5)
    r = search.search_op("diffusion.vmem_loop", (140, 140), "f32", repeats=1,
                         cache_path=tmp_path / "t.json", candidates=[overbudget, honest],
                         device="cpu")
    assert r["status"] == "tuned" and r["entry"]["config"] == honest
    assert r["rejected"][0][0] == overbudget and "rejected" in r["rejected"][0][1]
    r2 = search.search_op("diffusion.vmem_loop", (140, 140), "f32", repeats=1,
                          cache_path=tmp_path / "none.json", candidates=[overbudget],
                          device="cpu")
    assert r2["status"] == "all-rejected" and r2["entry"] is None
    assert not (tmp_path / "none.json").exists()


def test_search_empty_space_is_a_clean_noop_and_ties_keep_the_first(tmp_path, monkeypatch):
    r = search.search_op("diffusion.masked_step", (16, 16), "f32", repeats=1,
                         cache_path=tmp_path / "e.json", device="cpu")
    assert r["status"] == "empty" and not (tmp_path / "e.json").exists()
    with pytest.raises(ValueError, match="no single-process measurement runner"):
        search.search_op("diffusion.masked_step", (1448, 1448), "f32", repeats=1,
                         cache_path=tmp_path / "m.json", device="cpu")
    monkeypatch.setattr(search, "_make_runner", lambda *a: lambda c: 1e-5)
    r = search.search_op("wave.vmem_loop", (16, 16), "f32", repeats=1,
                         cache_path=tmp_path / "tie.json", device="cpu",
                         candidates=[{"chunk": 16}, {"chunk": 4}])
    assert r["entry"]["config"] == {"chunk": 16}


def test_search_deep_measures_each_wire_mode(tmp_path):
    r = search.search_op("diffusion.deep", (16, 16), "f32", repeats=1,
                         cache_path=tmp_path / "d.json", device="cpu",
                         candidates=[{"k": 4, "wire_mode": "f32"},
                                     {"k": 4, "wire_mode": "bf16"},
                                     {"k": 8, "wire_mode": "int8"}])
    assert r["status"] == "tuned" and len(r["measured"]) == 3


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_search_show_validate_and_warm_determinism(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(space, "_CHUNKS", (4,))
    path = tmp_path / "cli.json"
    argv = ["search", "--shape", "16,16", "--repeats", "1", "--cache", str(path),
            "--device", "cpu"]
    assert cli(argv) == 0
    assert "2 tuned" in capsys.readouterr().err
    blob = path.read_bytes()
    compiles.reset()
    assert cli(argv) == 0
    err = capsys.readouterr().err
    assert "2 hit(s), 0 tuned" in err and "compiles.steady_state=0" in err
    assert path.read_bytes() == blob
    assert cli(["show", "--cache", str(path)]) == 0
    out = capsys.readouterr().out
    assert "diffusion.vmem_loop|16x16|f32|1x1|cpu" in out and "STALE" not in out
    assert cli(["validate", str(path)]) == 0
    # The doctored pad entry: 140² padded to 256².
    doc = json.loads(blob)
    doc["entries"][_key("diffusion.vmem_loop", (140, 140))] = _entry(
        {"body_form": "eqc", "pad_pow2": True, "chunk": 16})
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert cli(["validate", str(bad)]) == 1
    assert "fast-but-wasteful" in capsys.readouterr().err


def test_cli_exit_codes(tmp_path, monkeypatch, capsys):
    assert cli(["validate"]) == 2
    assert cli(["validate", str(tmp_path / "missing.json")]) == 2
    torn = tmp_path / "torn.json"
    torn.write_text("{")
    assert cli(["validate", str(torn)]) == 1
    assert cli(["search", "--shape", "0x4", "--device", "cpu"]) == 2
    assert cli(["search", "--shape", "16,16", "--repeats", "0", "--device", "cpu"]) == 2
    with pytest.raises(SystemExit) as e:
        cli(["search", "--device", "tpu"])
    assert e.value.code == 2
    assert cli(["show", "--cache", str(tmp_path / "empty.json")]) == 0
    assert "empty" in capsys.readouterr().out
    monkeypatch.setattr(space, "enumerate_space",
                        lambda *a, **k: [{"body_form": "eqc", "pad_pow2": True, "chunk": 16}])
    assert cli(["search", "--ops", "diffusion.vmem_loop", "--shape", "140x140", "--cache",
                str(tmp_path / "r.json"), "--device", "cpu"]) == 1
    assert "1 rejected-out" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Four gloo ranks: one decision for the grid
# ---------------------------------------------------------------------------


def test_four_ranks_resolve_rank_0s_config(tmp_path):
    paths = [str(tmp_path / f"rank{r}.json") for r in range(4)]
    doc = cache.empty_doc()
    doc["entries"][_key("diffusion.scan", (16, 16), (2, 2), "f64")] = _entry({"chunk": 4})
    doc["entries"][_key("diffusion.deep", (16, 16), (2, 2), "f64")] = _entry(
        {"k": 4, "wire_mode": "bf16"})
    cache.write_doc(paths[0], doc)
    for p in paths[1:]:
        cache.write_doc(p, cache.empty_doc())
    got = spawn_ranks(4, worker.run_resolve_rank, ({"paths": paths},), timeout=300)
    want = spawn_ranks(4, worker.run_explicit_rank,
                       ({"chunk": 4, "k": 4, "wire_mode": "bf16"},), timeout=300)
    for g, w in zip(got, want):
        assert g["deep"] == {"k": 4, "wire_mode": "bf16"}
        assert g["q"] == w["q"] == 4 and g["k"] == w["k"] == 4
        assert g["stats"]["misses"] == 0 and g["stats"]["hits"] >= 3
        np.testing.assert_array_equal(g["scan_T"], w["scan_T"])
        np.testing.assert_array_equal(g["deep_T"], w["deep_T"])


def test_four_rank_weak_scaling_autotune_emits_tune_gauges(tmp_path, monkeypatch):
    import test_torch_rank_worker as rank_worker

    path = tmp_path / "c.json"
    doc = cache.empty_doc()
    doc["entries"][_key("diffusion.scan", (16, 16), (2, 2))] = _entry({"chunk": 4})
    cache.write_doc(path, doc)
    monkeypatch.setenv("RMT_TUNING_CACHE", str(path))
    tel = tmp_path / "telemetry"
    argv = ["--device", "cpu", "--autotune", "--local", "16", "--nt", "24", "--warmup", "8",
            "--counts", "1,4", "--no-probes"]
    assert spawn_ranks(4, rank_worker.run_weak_scaling_app, (argv,), timeout=240,
                       telemetry_dir=tel) == [0] * 4
    for rk in range(4):
        recs = [json.loads(ln) for ln in
                (tel / f"telemetry-rank{rk}.jsonl").read_text().splitlines()]
        gauges = {r["name"]: r["value"] for r in recs if r.get("kind") == "gauge"}
        assert gauges["tune.hits"] == 1, (rk, gauges)
        assert gauges["tune.misses"] == (1 if rk == 0 else 0), (rk, gauges)
        hits = [r for r in recs if r["name"] == "tune.resolve" and r["attrs"]["hit"]]
        assert [json.loads(r["attrs"]["config"]) for r in hits] == [{"chunk": 4}]
