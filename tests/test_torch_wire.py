"""The port's on-wire precision plane (rocm_mpi_tpu_torch/parallel/wire.py
and the wire modes of parallel/halo.exchange_into, the deep schedules and
the models) against the JAX package's rocm_mpi_tpu/parallel/wire.py.

* Tables and byte accounting: every function equal to JAX's for every
  mode, on 2D and 3D shapes and widths 1 and 4.
* The codecs: the torch slab codec against JAX's on the same slab
  sequences (all-zero, ±max and half-way ties among them), bitwise in
  payload, decoded slab and state over 6 sends; the numpy twin; the
  tolerance contract's result for every mode.
* On 4 gloo ranks against the JAX package on 4 CPU devices: raw exchanges
  with their state (bitwise), diffusion `perf` and `hide` with a bf16
  wire, and `run_deep` k = 4 with the int8 modes for the three workloads
  (f64, within 1e-12); the f32 wire bitwise the default exchange; a
  stateful mode refused on the per-step paths.

The wire-ladder fractions are not parity anchors here: the reference's
own ladder tests fail (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_transport_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import AcousticWave as JaxWave
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeat
from rocm_mpi_tpu.models import ShallowWater as JaxSWE
from rocm_mpi_tpu.models import SWEConfig as JaxSWEConfig
from rocm_mpi_tpu.models import WaveConfig as JaxWaveConfig
from rocm_mpi_tpu.parallel import wire as jwire
from rocm_mpi_tpu.parallel.halo import exchange_halo as jax_exchange_halo
from rocm_mpi_tpu.parallel.halo import exchange_nbytes as jax_exchange_nbytes
from rocm_mpi_tpu.parallel.mesh import init_global_grid as jax_grid
from rocm_mpi_tpu.utils.compat import shard_map
from rocm_mpi_tpu_torch.parallel import wire
from rocm_mpi_tpu_torch.parallel.halo import exchange_into, exchange_nbytes, place_core
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

MODES = wire.WIRE_MODES
SHAPES = [(16, 12), (64, 64), (6144, 6144), (4, 6, 3), (24, 24, 24)]
NPROCS = 4
DIFFUSION = dict(global_shape=(32, 24), nt=16, warmup=8, dims=(2, 2))
K = 4
STEPS = 3
EXCHANGES = {
    f"{mode}-{dtype}-w{width}": ((32, 24), (2, 2), width, mode, dtype)
    for mode in MODES for dtype in ("f64", "f32") for width in (1, 4)
}
EXCHANGES["int8_delta-f64-3d"] = ((8, 12, 6), (2, 2, 1), 2, "int8_delta", "f64")
RUNS = [("f64", "perf", "bf16"), ("f64", "hide", "bf16"), ("f64", "shard", "bf16"),
        ("f64", "perf", "f32"), ("f32", "perf", "bf16")]
DEEP_RUNS = [(w, m) for w in ("diffusion", "wave", "swe")
             for m in ("int8", "int8_delta", "bf16")]
F64_TOL = dict(rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# Tables and byte accounting
# ---------------------------------------------------------------------------


def test_tables_equal_jax():
    assert wire.WIRE_MODES == jwire.WIRE_MODES
    assert wire.STATEFUL_MODES == jwire.STATEFUL_MODES
    assert wire.DEFAULT_LADDER == jwire.DEFAULT_LADDER
    assert wire.TOLERANCE == jwire.TOLERANCE


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_per_mode_functions_equal_jax(mode, itemsize):
    assert wire.validate_mode(mode) == jwire.validate_mode(mode)
    assert wire.is_stateful(mode) == jwire.is_stateful(mode)
    assert wire.state_arity(mode) == jwire.state_arity(mode)
    assert wire.payload_itemsize(mode, itemsize) == jwire.payload_itemsize(mode, itemsize)
    assert wire.slab_overhead_bytes(mode, itemsize) == jwire.slab_overhead_bytes(mode, itemsize)
    for n in (0, 1, 6144, 12290):
        assert wire.wire_slab_nbytes(n, itemsize, mode) == jwire.wire_slab_nbytes(n, itemsize,
                                                                                   mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_geometry_functions_equal_jax(shape, width, mode):
    axes_cases = [None, tuple(reversed(range(len(shape)))), (0,)]
    for axes in axes_cases:
        assert wire.slab_shapes(shape, width, axes) == jwire.slab_shapes(shape, width, axes)
        for itemsize in (2, 4, 8):
            want = jwire.exchange_wire_nbytes(shape, itemsize, width, axes, mode)
            assert wire.exchange_wire_nbytes(shape, itemsize, width, axes, mode) == want
            assert exchange_nbytes(shape, itemsize, width, axes, mode) == want
            assert want == jax_exchange_nbytes(shape, itemsize, width, axes, mode)
    assert wire.ladder_fraction(shape, width, mode) == jwire.ladder_fraction(shape, width, mode)


def test_unknown_mode_raises_like_jax():
    for fn in (wire.validate_mode, jwire.validate_mode, wire.is_stateful):
        with pytest.raises(ValueError, match="unknown wire_mode"):
            fn("fp8")
    with pytest.raises(ValueError):
        exchange_nbytes((8, 8), 4, wire_mode="fp8")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fields", [1, 3])
def test_init_exchange_state_is_this_ranks_share_of_jax(mode, fields):
    # JAX's global zero arrays, cut by the mesh dims, are the port's
    # per-rank tensors: the same count, shapes, dtype and zeros.
    jgrid = jax_grid(32, 24, dims=(2, 2), devices=jax.devices()[:4])
    want = jwire.init_exchange_state(jgrid, 3, mode, jnp.float32, fields=fields)
    got = wire.init_exchange_state(jgrid.local_shape, 3, mode, torch.float32, fields=fields)
    assert len(got) == len(want) == fields * 4 * wire.state_arity(mode)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(n // d for n, d in zip(w.shape, jgrid.dims))
        assert g.dtype == torch.float32 and not g.any()


# ---------------------------------------------------------------------------
# The codecs
# ---------------------------------------------------------------------------


def _slab_sequence(dtype):
    """Six slabs a wire might carry in turn: random, all-zero, ±max,
    half-way ties (max 127, so the scale is 1 and x / scale is x), a
    constant and a negative-skewed one."""
    rng = np.random.default_rng(7)
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5]])
    return [
        rng.standard_normal((3, 8)),
        np.zeros((3, 8)),
        np.array([[-3.0, 3.0, 1e-3, -1e-3, 0.0, 2.9999, -2.9999, 1.0]]).repeat(3, 0),
        ties.repeat(3, 0),
        np.full((3, 8), 0.3),
        -np.abs(rng.standard_normal((3, 8))) * 1e-4,
    ]


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_slab_codec_bitwise_equal_jax(mode, dtype):
    tdt = {"f64": torch.float64, "f32": torch.float32}[dtype]
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
    tc, jc = wire.slab_codec(mode), jwire.slab_codec(mode)
    arity = wire.state_arity(mode)
    t_state = tuple(torch.zeros((3, 8), dtype=tdt) for _ in range(arity))
    j_state = tuple(jnp.zeros((3, 8), jdt) for _ in range(arity))
    for slab in _slab_sequence(dtype):
        t_pay, t_state = tc.send(torch.from_numpy(slab).to(tdt), t_state)
        j_pay, j_state = jc.send(jnp.asarray(slab, jdt), j_state)
        assert len(t_pay) == len(j_pay)
        if mode == "bf16":  # JAX ships the bf16 bits as uint16
            assert t_pay[0].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t_pay[0].view(torch.int16).numpy().view(np.uint16), np.asarray(j_pay[0]))
        else:
            for t, j in zip(t_pay, j_pay):
                np.testing.assert_array_equal(_as_np(t).reshape(np.shape(j)), np.asarray(j))
            if mode in wire.STATEFUL_MODES:
                assert t_pay[0].dtype == torch.int8 and t_pay[1].shape == (1,)
        t_dec, t_state = tc.recv(t_pay, t_state, tdt)
        j_dec, j_state = jc.recv(j_pay, j_state, jdt)
        assert t_dec.dtype == tdt
        np.testing.assert_array_equal(_as_np(t_dec), np.asarray(j_dec))
        for t, j in zip(t_state, j_state):
            np.testing.assert_array_equal(_as_np(t), np.asarray(j))


@pytest.mark.parametrize("mode", ["int8", "int8_delta"])
def test_a_slab_that_never_arrives_decodes_to_zero(mode):
    # A zero payload (what an omitted ppermute delivers) decodes to zero and
    # leaves a zero reconstruction zero, in both packages.
    tc = wire.slab_codec(mode)
    state = tuple(torch.zeros(4, dtype=torch.float64) for _ in range(wire.state_arity(mode)))
    zero = (torch.zeros(4, dtype=torch.int8), torch.zeros(1, dtype=torch.float64))
    dec, state = tc.recv(zero, state, torch.float64)
    assert not dec.any() and not any(s.any() for s in state)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("feedback", [True, False])
def test_numpy_codec_equals_jax(mode, feedback):
    ours, theirs = wire.NumpyWireCodec(mode, feedback), jwire.NumpyWireCodec(mode, feedback)
    for i, slab in enumerate(_slab_sequence("f64")):
        for key in ((0, 0, "lo"), (1, 1, "hi")):
            np.testing.assert_array_equal(ours.apply(key, slab * (i + 1)),
                                          theirs.apply(key, slab * (i + 1)))


def test_np_bf16_round_equals_jax():
    x = np.random.default_rng(3).standard_normal(1000) * 1e3
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(wire._np_bf16_round(x.astype(dt)),
                                      jwire._np_bf16_round(x.astype(dt)))


@pytest.mark.parametrize("mode", MODES)
def test_check_tolerance_equals_jax(mode):
    ours, theirs = wire.check_tolerance(mode), jwire.check_tolerance(mode)
    assert tuple(ours) == tuple(theirs)
    assert ours.ok


def test_certify_caches_on_the_bound(monkeypatch):
    first = wire.certify("bf16")
    assert wire.certify("bf16") is first
    monkeypatch.setitem(wire.TOLERANCE, "bf16", 1e-9)
    again = wire.certify("bf16")
    assert again is not first and not again.ok and again.rel_err == first.rel_err


# ---------------------------------------------------------------------------
# One rank: refusals and the f32 path
# ---------------------------------------------------------------------------


def test_exchange_into_refuses_a_stateful_mode_without_state():
    grid = init_global_grid(8, 6, dims=(1, 1), nprocs=1, rank=0)
    buf = place_core(torch.ones(8, 6))
    for mode in ("int8", "int8_delta"):
        with pytest.raises(ValueError, match="carries error-feedback state"):
            exchange_into(buf, grid, wire_mode=mode)
    with pytest.raises(ValueError, match="unknown wire_mode"):
        exchange_into(buf, grid, wire_mode="fp8")


def test_f32_wire_takes_no_codec(monkeypatch):
    # The f32 wire is today's path: no codec is built or called.
    grid = init_global_grid(8, 6, dims=(1, 1), nprocs=1, rank=0)

    def no_codec(mode):
        raise AssertionError("the f32 wire built a codec")

    monkeypatch.setattr(wire, "slab_codec", no_codec)
    u = torch.arange(48.0).reshape(8, 6)
    assert torch.equal(exchange_into(place_core(u), grid, wire_mode="f32"), place_core(u))


# ---------------------------------------------------------------------------
# Four ranks against four JAX devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    spec = dict(exchanges=EXCHANGES, steps=STEPS, runs=RUNS, deep_runs=DEEP_RUNS,
                diffusion=DIFFUSION, k=K)
    return spawn_ranks(NPROCS, worker.run_wire_rank, (spec,), backend="gloo", timeout=300)


def _jax_exchanges(shape, dims, width, mode, dtype):
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
    grid = jax_grid(*shape, dims=dims, devices=jax.devices()[:NPROCS])
    G = worker.global_field(shape)
    state = jwire.init_exchange_state(grid, width, mode, jdt)
    stateful = jwire.is_stateful(mode)

    def local(u, *ws):
        out = jax_exchange_halo(u, grid, width, wire_mode=mode,
                                wire_state=ws if stateful else None)
        return (out[0], *out[1]) if stateful else (out,)

    n_state = len(state)
    fn = jax.jit(shard_map(local, mesh=grid.mesh, in_specs=(grid.spec,) * (1 + n_state),
                           out_specs=(grid.spec,) * (1 + n_state), check_vma=False))
    out = []
    for t in range(STEPS):
        u = jax.device_put(jnp.asarray(G * (1.0 + t / 10), jdt), grid.sharding)
        padded, *state = fn(u, *state)
        out.append((np.asarray(padded), [np.asarray(s) for s in state]))
    return grid, out


def _block(arr, coords, dims):
    size = tuple(n // d for n, d in zip(arr.shape, dims))
    return arr[tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, size))]


@pytest.mark.parametrize("key", sorted(EXCHANGES))
def test_exchange_and_state_equal_jax(ranks, key):
    # Ghosts and wire state of every rank against its JAX shard over three
    # exchanges. The stateless modes are bitwise. For the int8 modes XLA's
    # CPU compiler rewrites the jitted codec's arithmetic (it fuses
    # `comp - q·scale` into one multiply-add, for one, which rounds once
    # where the port's eager ops round twice), so their ghosts and state
    # agree to a few units in the last place of the slab's magnitude; the
    # eager JAX codec, which is not rewritten, is held bitwise above.
    shape, dims, width, mode, dtype = EXCHANGES[key]
    eps = np.finfo(np.float64 if dtype == "f64" else np.float32).eps
    fused_tol = dict(rtol=0, atol=4 * eps * 1.2)  # |field| < 1.2 over the three scalings
    _, want = _jax_exchanges(shape, dims, width, mode, dtype)
    for rank, out in enumerate(ranks):
        coords = init_global_grid(*shape, dims=dims, nprocs=NPROCS, rank=rank).coords
        for t, ((padded, state), (jpadded, jstate)) in enumerate(zip(out["exchange"][key],
                                                                     want)):
            msg = f"rank {rank} exchange {t}"
            if wire.is_stateful(mode):
                np.testing.assert_allclose(padded, _block(jpadded, coords, dims), **fused_tol,
                                           err_msg=msg)
            else:
                np.testing.assert_array_equal(padded, _block(jpadded, coords, dims),
                                              err_msg=msg)
            assert len(state) == len(jstate)
            for i, (s, js) in enumerate(zip(state, jstate)):
                np.testing.assert_allclose(s, _block(js, coords, dims), **fused_tol,
                                           err_msg=f"{msg} state {i}")


@pytest.mark.parametrize("width", [1, 4])
def test_f32_wire_is_the_plain_exchange(ranks, width):
    # Every f32-wire ghost is the neighbour's cell, bit for bit: a window of
    # the zero-padded global field (the exchange as it was before the wire
    # modes), and the model's f32 wire is its default.
    from rocm_mpi_tpu_torch.config import DiffusionConfig

    shape, dims = (32, 24), (2, 2)
    for dtype in ("f64", "f32"):
        for t, scale in enumerate(1.0 + np.arange(STEPS) / 10):
            G = worker.global_field(shape) * scale
            G = np.pad(G.astype(np.float32) if dtype == "f32" else G, width)
            for rank, out in enumerate(ranks):
                grid = init_global_grid(*shape, dims=dims, nprocs=NPROCS, rank=rank)
                window = tuple(slice(a, b + 2 * width) for a, b in grid.shard_bounds())
                padded, state = out["exchange"][f"f32-{dtype}-w{width}"][t]
                np.testing.assert_array_equal(padded, G[window])
                assert state == ()
    assert DiffusionConfig().wire_mode == "f32"


@pytest.mark.parametrize("dtype,variant,mode", RUNS)
def test_per_step_wire_runs_match_jax(ranks, dtype, variant, mode):
    cfg = JaxConfig(**DIFFUSION, dtype=dtype, wire_mode=mode)
    ref = np.asarray(JaxHeat(cfg, devices=jax.devices()[:NPROCS]).run(variant).T)
    got = ranks[0]["runs"][(dtype, variant, mode)]
    tol = F64_TOL if dtype == "f64" else dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, ref, **tol)
    if mode != "f32" and dtype == "f64":
        plain = ranks[0]["runs"][("f64", "perf", "f32")]
        assert not np.array_equal(got, plain)  # the wire changed the field


@pytest.mark.parametrize("workload,mode", DEEP_RUNS)
def test_deep_wire_runs_match_jax(ranks, workload, mode):
    devices = jax.devices()[:NPROCS]
    if workload == "diffusion":
        res = JaxHeat(JaxConfig(**DIFFUSION, wire_mode=mode), devices=devices).run_deep(
            block_steps=K)
        want = [res.T]
    elif workload == "wave":
        res = JaxWave(JaxWaveConfig(**DIFFUSION, wire_mode=mode), devices=devices).run_deep(
            block_steps=K)
        want = [res.U]
    else:
        res = JaxSWE(JaxSWEConfig(**DIFFUSION, wire_mode=mode), devices=devices).run_deep(
            block_steps=K)
        want = [res.h, *res.us]
    for out in ranks:
        route, k, _ = out["deep"][(workload, mode)]
        assert k == K and route in ("vmem", "jnp")
    got = ranks[0]["deep"][(workload, mode)][2]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **F64_TOL)


def test_stateful_mode_refused_on_per_step_paths(ranks):
    for out in ranks:
        assert set(out["refused"]) == {"perf", "shard", "hide"}
        assert all("carries error-feedback state" in msg for msg in out["refused"].values())
