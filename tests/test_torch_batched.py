"""The port's batched lanes (parallel/mesh.BatchedGrid,
halo.exchange_halo_batched, overlap.make_batched_overlap_step, the batched
deep sweep, and the models' batched advances) against the port's own
standalone runs and the JAX package's batched lanes, on the CPU.

The serving contract: every lane of a batched advance is bitwise equal to
the port's standalone single-lane run of its own length
(`lane_advance_fn`, which is `advance_fn` but for "hide" on one rank,
where the lanes keep the overlap form), in f64, f32 and bf16. Against the
JAX package's batched lanes, from JAX's own initial state (the Gaussian's
`exp` differs by an ulp between the packages): f64 within rtol 1e-12 /
atol 1e-14, f32 within rtol 2e-5 / atol 2e-6 — the tolerances of the
port's single-lane model tests (tests/test_torch_wave.py): XLA's CPU
compile may contract a multiply and an add into one rounding.

The multi-rank cases (4 gloo ranks: the exchange against per-lane
exchanges, the batched advances on 2 rows of 1×2 and 1 row of 2×2
against one rank) run in tests/test_torch_serving_worker.py.
"""

import jax
import numpy as np
import pytest
import torch

from rocm_mpi_tpu.config import DiffusionConfig as JDiffusionConfig
from rocm_mpi_tpu.models import HeatDiffusion as JHeatDiffusion
from rocm_mpi_tpu.models.swe import SWEConfig as JSWEConfig
from rocm_mpi_tpu.models.swe import ShallowWater as JShallowWater
from rocm_mpi_tpu.models.wave import AcousticWave as JAcousticWave
from rocm_mpi_tpu.models.wave import WaveConfig as JWaveConfig
from rocm_mpi_tpu.parallel import mesh as jmesh
from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
from rocm_mpi_tpu_torch.models import HeatDiffusion
from rocm_mpi_tpu_torch.models.swe import ShallowWater
from rocm_mpi_tpu_torch.models.wave import AcousticWave
from rocm_mpi_tpu_torch.parallel import deep_halo, halo, mesh
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

import test_torch_serving_worker as worker

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}
LANE_STEPS = [5, 3, 5, 1]
SCALES = [1.0 + 0.1 * i for i in range(4)]


def _jput(a):
    return jax.device_put(np.asarray(a), jax.devices()[0])


def _lanes(base: torch.Tensor) -> torch.Tensor:
    return torch.stack([base * s for s in SCALES])


# ---------------------------------------------------------------------------
# BatchedGrid
# ---------------------------------------------------------------------------


def test_batched_grid_shapes_match_jax_rank_by_rank():
    jbg = jmesh.init_batched_grid(6, 16, 16, space_dims=(1, 2), batch_dims=2,
                                  devices=jax.devices()[:4])
    for r in range(4):
        bg = mesh.init_batched_grid(6, 16, 16, space_dims=(1, 2), batch_dims=2, nprocs=4,
                                    rank=r)
        assert bg.axis_names == jbg.axis_names == ("batch", "gx", "gy")
        assert (bg.batch, bg.batch_dims, bg.local_batch) == (6, 2, 3)
        assert bg.global_shape == jbg.global_shape == (6, 16, 16)
        assert bg.local_shape == jbg.local_shape == (3, 16, 8)
        assert bg.dims == jbg.dims and bg.nprocs == jbg.nprocs == 4
        assert bg.space.dims == jbg.space.dims == (1, 2)
        # rank r: row r // 2, space coordinates of r % 2, its row's lanes
        assert bg.row == r // 2 and bg.space.coords == (0, r % 2)
        assert list(bg.lane_range()) == list(range(3 * (r // 2), 3 * (r // 2) + 3))
        assert bg.space.base == 2 * (r // 2)
        peer = bg.space.neighbor(1, +1 if r % 2 == 0 else -1)
        assert peer == (r + 1 if r % 2 == 0 else r - 1)
    idle = mesh.init_batched_grid(2, 16, 16, space_dims=(1, 1), batch_dims=2, nprocs=3, rank=2)
    assert not idle.active and idle.row is None and list(idle.lane_range()) == []


@pytest.mark.parametrize("args,kw,match", [
    ((3, 16, 16), dict(space_dims=(1, 1), batch_dims=2), "not divisible"),
    ((4, 16, 16), dict(space_dims=(2, 2), batch_dims=4), "devices"),
])
def test_batched_grid_validation_matches_jax(args, kw, match):
    n = 2 if kw["batch_dims"] == 2 else 8
    with pytest.raises(ValueError, match=match):
        jmesh.init_batched_grid(*args, **kw, devices=jax.devices()[:n])
    with pytest.raises(ValueError, match=match):
        mesh.init_batched_grid(*args, **kw, nprocs=n, rank=0)


def test_rebuild_batched_for_mesh_grows_rows_as_jax():
    jbg = jmesh.init_batched_grid(4, 16, 16, space_dims=(1, 1), batch_dims=1,
                                  devices=jax.devices()[:1])
    jg = jmesh.rebuild_batched_for_mesh(jbg, batch_dims=2, devices=jax.devices()[:2])
    bg = mesh.init_batched_grid(4, 16, 16, space_dims=(1, 1), batch_dims=1, nprocs=1, rank=0)
    grown = mesh.rebuild_batched_for_mesh(bg, batch_dims=2, nprocs=2)
    assert (grown.batch_dims, grown.batch, grown.space.dims) == \
        (jg.batch_dims, jg.batch, jg.space.dims) == (2, 4, (1, 1))
    assert grown.space.global_shape == bg.space.global_shape


def test_batched_exchanges_refuse_stateful_wires():
    bg = mesh.init_batched_grid(2, 16, 16, space_dims=(1, 1), nprocs=1, rank=0)
    with pytest.raises(ValueError, match="stateful"):
        halo.exchange_halo_batched(torch.zeros(2, 16, 16), bg, wire_mode="int8")
    with pytest.raises(ValueError, match="stateful"):
        halo.exchange_faces_batched(torch.zeros(2, 16, 16), bg, wire_mode="int8_delta")
    with pytest.raises(ValueError, match="stateful"):
        deep_halo.make_deep_sweep(bg, 4, 1.0, 0.1, (0.5, 0.5), wire_mode="int8")


def test_batched_advance_refuses_the_pallas_rungs():
    m = HeatDiffusion(DiffusionConfig(global_shape=(16, 16), dtype="f64"), device="cpu")
    with pytest.raises(ValueError, match="single-lane"):
        m.batched_advance_fn(batch=2, variant="perf")
    w = AcousticWave(WaveConfig(global_shape=(16, 16), dtype="f64"), device="cpu")
    with pytest.raises(ValueError, match="single-lane"):
        w.batched_advance_fn(batch=2, variant="hide")


def test_one_rank_exchange_of_lanes_pads_every_lane_as_place_core():
    bg = mesh.init_batched_grid(3, 8, 6, space_dims=(1, 1), nprocs=1, rank=0)
    ub = torch.arange(3 * 48, dtype=torch.float64).reshape(3, 8, 6)
    got = halo.exchange_halo_batched(ub, bg, width=2)
    for j in range(3):
        assert torch.equal(got[j], halo.exchange_halo(ub[j], bg.space, width=2))


# ---------------------------------------------------------------------------
# Per-lane parity: batched advance == standalone runs, and ~ JAX's lanes
# ---------------------------------------------------------------------------


def _diffusion(dtype, variant="shard"):
    kw = dict(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype)
    return HeatDiffusion(DiffusionConfig(**kw), device="cpu"), kw


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("variant", ["shard", "hide", "ap", "fused"])
def test_diffusion_lanes_bitwise_to_standalone(variant, dtype):
    m, _ = _diffusion(dtype)
    adv, bg = m.batched_advance_fn(batch=4, variant=variant)
    T0, Cp = m.init_state()
    out = adv(_lanes(T0), Cp, LANE_STEPS, max(LANE_STEPS))
    one = m.lane_advance_fn(variant)
    for i, n in enumerate(LANE_STEPS):
        assert torch.equal(out[i], one(T0 * SCALES[i], Cp, n)), f"lane {i}"


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("variant", ["shard", "hide"])
def test_diffusion_lanes_match_jax_batched(variant, dtype):
    m, kw = _diffusion(dtype)
    jm = JHeatDiffusion(JDiffusionConfig(**kw), devices=jax.devices()[:1])
    T0j, Cpj = jm.init_state()
    lanes = np.stack([np.asarray(T0j) * s for s in SCALES])
    jadv, _ = jm.batched_advance_fn(batch=4, batch_dims=1, variant=variant,
                                    devices=jax.devices()[:1])
    want = np.asarray(jadv(_jput(lanes), Cpj, _jput(np.array(LANE_STEPS, np.int32)),
                           max(LANE_STEPS)))
    adv, _ = m.batched_advance_fn(batch=4, variant=variant)
    got = adv(torch.from_numpy(lanes.copy()), torch.from_numpy(np.asarray(Cpj)), LANE_STEPS,
              max(LANE_STEPS))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("variant", ["shard", "ap"])
def test_wave_lanes_bitwise_to_standalone(variant, dtype):
    w = AcousticWave(WaveConfig(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype),
                     device="cpu")
    adv, _ = w.batched_advance_fn(batch=4, variant=variant)
    U0, _, C2 = w.init_state()
    oU, oUp = adv(_lanes(U0), _lanes(U0), C2, LANE_STEPS, max(LANE_STEPS))
    one = w.advance_fn(variant)
    for i, n in enumerate(LANE_STEPS):
        rU, rUp = one(U0 * SCALES[i], U0 * SCALES[i], C2, n)
        assert torch.equal(oU[i], rU) and torch.equal(oUp[i], rUp), f"lane {i}"


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_wave_lanes_match_jax_batched(dtype):
    kw = dict(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype)
    jw = JAcousticWave(JWaveConfig(**kw), devices=jax.devices()[:1])
    U0j, _, C2j = jw.init_state()
    ul = np.stack([np.asarray(U0j) * s for s in SCALES])
    jadv, _ = jw.batched_advance_fn(batch=4, batch_dims=1, devices=jax.devices()[:1])
    jU, jUp = jadv(_jput(ul), _jput(ul.copy()), C2j, _jput(np.array(LANE_STEPS, np.int32)),
                   max(LANE_STEPS))
    w = AcousticWave(WaveConfig(**kw), device="cpu")
    adv, _ = w.batched_advance_fn(batch=4)
    U, Up = adv(torch.from_numpy(ul.copy()), torch.from_numpy(ul.copy()),
                torch.from_numpy(np.asarray(C2j)), LANE_STEPS, max(LANE_STEPS))
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), **TOL[dtype])
    np.testing.assert_allclose(Up.numpy(), np.asarray(jUp), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("variant", ["shard", "ap"])
def test_swe_lanes_bitwise_to_standalone(variant, dtype):
    s = ShallowWater(SWEConfig(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype),
                     device="cpu")
    adv, _ = s.batched_advance_fn(batch=4, variant=variant)
    h0, us0 = s.init_state()
    Mus = s.face_masks()
    z = torch.zeros((4,) + tuple(h0.shape), dtype=h0.dtype)
    oh, ous = adv(_lanes(h0), (z, z.clone()), Mus, LANE_STEPS, max(LANE_STEPS))
    one = s.advance_fn(variant)
    for i, n in enumerate(LANE_STEPS):
        rh, rus = one(h0 * SCALES[i], tuple(torch.zeros_like(h0) for _ in us0), Mus, n)
        assert torch.equal(oh[i], rh), f"lane {i} h"
        for a in range(2):
            assert torch.equal(ous[a][i], rus[a]), f"lane {i} u{a}"


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_swe_lanes_match_jax_batched(dtype):
    kw = dict(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype)
    js = JShallowWater(JSWEConfig(**kw), devices=jax.devices()[:1])
    h0j, _ = js.init_state()
    Mj = js.face_masks()
    hl = np.stack([np.asarray(h0j) * s for s in SCALES])
    zb = np.zeros_like(hl)
    jadv, _ = js.batched_advance_fn(batch=4, batch_dims=1, devices=jax.devices()[:1])
    jh, jus = jadv(_jput(hl), (_jput(zb), _jput(zb)), Mj,
                   _jput(np.array(LANE_STEPS, np.int32)), max(LANE_STEPS))
    s = ShallowWater(SWEConfig(**kw), device="cpu")
    adv, _ = s.batched_advance_fn(batch=4)
    h, us = adv(torch.from_numpy(hl.copy()),
                (torch.from_numpy(zb.copy()), torch.from_numpy(zb.copy())),
                tuple(torch.from_numpy(np.asarray(M)) for M in Mj), LANE_STEPS,
                max(LANE_STEPS))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL[dtype])
    for a in range(2):
        np.testing.assert_allclose(us[a].numpy(), np.asarray(jus[a]), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_deep_lanes_bitwise_to_standalone_and_near_jax(dtype):
    kw = dict(global_shape=(16, 16), nt=8, warmup=0, dtype=dtype)
    m = HeatDiffusion(DiffusionConfig(**kw), device="cpu")
    adv, bg, k = m.batched_deep_advance_fn(batch=4, block_steps=4)
    assert k == 4
    T0, Cp = m.init_state()
    out = adv(_lanes(T0), Cp, 8)
    sched = deep_halo.make_deep_sweep(m.grid, 4, m.config.lam, m.dt, m.config.spacing,
                                      local_form="jnp")
    Cm = sched.prepare(Cp)
    for i, s in enumerate(SCALES):
        T = T0 * s
        for _ in range(2):
            T = sched.sweep(T, Cm).clone()
        assert torch.equal(out[i], T), f"deep lane {i}"
    with pytest.raises(ValueError, match="multiple"):
        adv(_lanes(T0), Cp, 6)
    jm = JHeatDiffusion(JDiffusionConfig(**kw), devices=jax.devices()[:1])
    T0j, Cpj = jm.init_state()
    lanes = np.stack([np.asarray(T0j) * s for s in SCALES])
    jadv, _, jk = jm.batched_deep_advance_fn(batch=4, batch_dims=1, block_steps=4,
                                            devices=jax.devices()[:1])
    want = np.asarray(jadv(_jput(lanes), Cpj, 8))
    got = adv(torch.from_numpy(lanes.copy()), torch.from_numpy(np.asarray(Cpj)), 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


# ---------------------------------------------------------------------------
# The ladder: lanes of smaller original domains on one rung-shaped block
# ---------------------------------------------------------------------------


ORIG = [(16, 16), (14, 14), (12, 16), (16, 16)]


def _ladder_inputs(state_of, rung_model, models):
    """The rung-shaped lane block of each original domain's initial state
    (×scale) at the origin corner, its hold mask, and each lane's
    geometry (its model's dt and spacing)."""
    rung = rung_model.config.global_shape
    leaves, hold, geom = [], torch.ones((len(models),) + rung, dtype=torch.bool), []
    for j, (om, s) in enumerate(zip(models, SCALES)):
        region = tuple(slice(0, n) for n in om.config.global_shape)
        lane = []
        for b in state_of(om):
            e = torch.zeros(rung, dtype=b.dtype)
            e[region] = b * s
            lane.append(e)
        leaves.append(lane)
        hold[(j,) + tuple(slice(1, n - 1) for n in om.config.global_shape)] = False
        geom.append((om.dt, tuple(om.config.spacing)))
    return [torch.stack([lv[i] for lv in leaves]) for i in range(len(leaves[0]))], hold, geom


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_diffusion_ladder_lanes_bitwise_to_their_original_runs(dtype):
    models = [HeatDiffusion(DiffusionConfig(global_shape=sh, dtype=dtype), device="cpu")
              for sh in ORIG]
    rung = models[0]
    (Tb,), hold, geom = _ladder_inputs(lambda m: m.init_state()[:1], rung, models)
    adv, _ = rung.batched_ladder_advance_fn(batch=4)
    Cp = rung.init_state()[1]
    out = adv(Tb, Cp, hold, geom, LANE_STEPS, max(LANE_STEPS))
    for j, (om, s) in enumerate(zip(models, SCALES)):
        T0, Cp0 = om.init_state()
        ref = om.advance_fn("shard")(T0 * s, Cp0, LANE_STEPS[j])
        region = tuple(slice(0, n) for n in om.config.global_shape)
        assert torch.equal(out[j][region], ref), f"ladder lane {j}"


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_wave_ladder_lanes_bitwise_to_their_original_runs(dtype):
    models = [AcousticWave(WaveConfig(global_shape=sh, dtype=dtype), device="cpu")
              for sh in ORIG]
    rung = models[0]
    (Ub, Upb), hold, geom = _ladder_inputs(lambda m: m.init_state()[:2], rung, models)
    adv, _ = rung.batched_ladder_advance_fn(batch=4)
    C2 = rung.init_state()[2]
    oU, oUp = adv(Ub, Upb, C2, hold, geom, LANE_STEPS, max(LANE_STEPS))
    for j, (om, s) in enumerate(zip(models, SCALES)):
        U0, _, C20 = om.init_state()
        rU, rUp = om.advance_fn("shard")(U0 * s, U0 * s, C20, LANE_STEPS[j])
        region = tuple(slice(0, n) for n in om.config.global_shape)
        assert torch.equal(oU[j][region], rU) and torch.equal(oUp[j][region], rUp), j


def test_diffusion_ladder_lanes_match_jax_ladder():
    from rocm_mpi_tpu.serving.service import _DiffusionAdapter

    kw = [dict(global_shape=sh, dtype="f64") for sh in ORIG]
    jms = [JHeatDiffusion(JDiffusionConfig(**k), devices=jax.devices()[:1]) for k in kw]
    rung = (16, 16)
    Tb = np.zeros((4,) + rung)
    hold = np.ones((4,) + rung, dtype=bool)
    a, g = [], []
    for j, (jm, s) in enumerate(zip(jms, SCALES)):
        sh = jm.config.global_shape
        Tb[(j,) + tuple(slice(0, n) for n in sh)] = np.asarray(jm.init_state()[0]) * s
        hold[(j,) + tuple(slice(1, n - 1) for n in sh)] = False
        aj, gj = _DiffusionAdapter().ladder_geom(jm.config)
        a.append(aj)
        g.append(gj)
    jadv, _ = jms[0].batched_ladder_advance_fn(batch=4, batch_dims=1,
                                               devices=jax.devices()[:1])
    Cpj = jms[0].init_state()[1]
    want = np.asarray(jadv(_jput(Tb), Cpj, _jput(hold), _jput(np.array(a)),
                           tuple(_jput(np.array([gg[ax] for gg in g])) for ax in range(2)),
                           _jput(np.array(LANE_STEPS, np.int32)), max(LANE_STEPS)))
    models = [HeatDiffusion(DiffusionConfig(**k), device="cpu") for k in kw]
    adv, _ = models[0].batched_ladder_advance_fn(batch=4)
    geom = [(m.dt, tuple(m.config.spacing)) for m in models]
    got = adv(torch.from_numpy(Tb.copy()), torch.from_numpy(np.asarray(Cpj)),
              torch.from_numpy(hold), geom, LANE_STEPS, max(LANE_STEPS))
    np.testing.assert_allclose(got.numpy(), want, **TOL["f64"])


def test_lane_freeze_ping_pongs_without_new_state():
    m, _ = _diffusion("f64")
    adv, _ = m.batched_advance_fn(batch=4)
    T0, Cp = m.init_state()
    Tb = adv(_lanes(T0), Cp, LANE_STEPS, 5)
    Tb = adv(Tb, Cp, [2, 2, 2, 2], 2)
    Tb = adv(Tb, Cp, [1, 0, 3, 0], 3)
    # the spares: one for the caller's first buffer, one for a chained call
    assert sum(len(v) for v in adv.slots._slots.values()) <= 2


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


def test_four_rank_lanes_match_per_lane_exchanges_and_one_rank():
    # spawn_ranks' own timeout bounds the ranks (200 s).
    got = spawn_ranks(4, worker.run_lanes_rank, (), timeout=200)
    for rank, res in enumerate(got):
        assert res["exchange"] and all(res["exchange"]), f"rank {rank}"
    ref = worker.one_rank_lanes()
    full = worker.gather_lanes(got)
    for layout, fields in full.items():
        for variant, lanes in fields.items():
            for j, lane in enumerate(lanes):
                assert np.array_equal(lane, ref[variant][j]), (layout, variant, j)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("variant", ["shard", "hide"])
def test_diffusion_batched_step_is_one_step_of_the_advance_and_near_jax(variant, dtype):
    """batched_step_fn with batched_prepare_fn's coefficient: bitwise one
    step of the batched advance, and JAX's one batched step within the
    model tests' tolerance (from JAX's initial state)."""
    m, kw = _diffusion(dtype)
    jm = JHeatDiffusion(JDiffusionConfig(**kw), devices=jax.devices()[:1])
    T0j, Cpj = jm.init_state()
    lanes = np.stack([np.asarray(T0j) * s for s in SCALES])
    _, jbg = jm.batched_advance_fn(batch=4, batch_dims=1, variant=variant,
                                   devices=jax.devices()[:1])
    want = np.asarray(jm.batched_step_fn(jbg, variant)(
        _jput(lanes), jm.batched_prepare_fn(jbg, variant)(Cpj)))
    adv, bg = m.batched_advance_fn(batch=4, variant=variant)
    Tb, Cp = torch.from_numpy(lanes.copy()), torch.from_numpy(np.asarray(Cpj))
    got = m.batched_step_fn(bg, variant)(Tb, m.batched_prepare_fn(bg, variant)(Cp))
    assert torch.equal(got, adv(Tb.clone(), Cp, [1] * 4, 1))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
