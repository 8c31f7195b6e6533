"""The port's HeatDiffusion on one rank against the JAX package's on one
CPU device: every ported variant, f64 and f32, at small sizes and at the
flagship 252²; the RunResult metrics; the advance's buffer reuse; the
state carried across from JAX; entry() and the perf app."""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu.models.diffusion import RunResult as JaxRunResult
from rocm_mpi_tpu_torch.config import DiffusionConfig
from rocm_mpi_tpu_torch.entry import entry
from rocm_mpi_tpu_torch.models import HeatDiffusion, RunResult
from rocm_mpi_tpu_torch.ops import kernels
from rocm_mpi_tpu_torch.state import state_from_numpy, tensor_from_numpy

TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}


def _pair(shape, dtype, nt=6, warmup=2):
    kw = dict(global_shape=shape, lengths=(10.0,) * len(shape), nt=nt,
              warmup=warmup, dtype=dtype, dims=(1,) * len(shape))
    return (HeatDiffusion(DiffusionConfig(**kw), device="cpu"),
            JaxHeatDiffusion(JaxConfig(**kw), devices=jax.devices()[:1]))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(32, 24), (252, 252), (12, 10, 8)])
def test_perf_run_matches_jax(shape, dtype):
    ours, ref = _pair(shape, dtype)
    kernels.reset_launches()
    got = ours.run("perf")
    want = np.asarray(ref.run("perf").T)
    assert got.T.dtype == ours.config.torch_dtype
    np.testing.assert_allclose(got.T.numpy(), want, **TOL[dtype])
    assert kernels.LAUNCHES["masked_step"] == 0  # CPU: plain version only


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("variant", ["ap", "fused", "shard"])
def test_other_variants_match_jax(variant, dtype):
    ours, ref = _pair((24, 20), dtype)
    np.testing.assert_allclose(ours.run(variant).T.numpy(),
                               np.asarray(ref.run(variant).T), **TOL[dtype])


def test_init_state_matches_jax():
    ours, ref = _pair((40, 36), "f64")
    T, Cp = ours.init_state()
    Tj, Cpj = ref.init_state()
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(Cp.numpy(), np.asarray(Cpj))


def test_bf16_perf_from_jax_state_is_bitwise():
    # Storage-only bf16 both sides: from the same state, the same steps
    # round at the same places.
    ours, ref = _pair((24, 16), "bf16")
    Tj, Cpj = ref.init_state()
    T, Cp = state_from_numpy(np.asarray(Tj), np.asarray(Cpj), ours.grid, "cpu")
    got = ours.advance_fn("perf")(T, Cp, 5)
    want = np.asarray(ref.advance_fn("perf")(Tj, Cpj, 5))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_run_result_metrics_use_the_jax_formulas():
    cfg = DiffusionConfig(global_shape=(64, 48), nt=20, warmup=4, dtype="f32")
    jcfg = JaxConfig(global_shape=(64, 48), nt=20, warmup=4, dtype="f32")
    T = torch.zeros(64, 48)
    ours = RunResult(T=T, wtime=0.125, nt=20, warmup=4, config=cfg)
    ref = JaxRunResult(T=jax.numpy.zeros((64, 48), jax.numpy.float32),
                       wtime=0.125, nt=20, warmup=4, config=jcfg)
    assert ours.wtime_it == ref.wtime_it
    assert ours.t_eff == ref.t_eff
    assert ours.gpts == ref.gpts


def test_run_validates_windows():
    ours, _ = _pair((16, 16), "f64")
    with pytest.raises(ValueError, match="warmup"):
        ours.run("perf", nt=4, warmup=4)
    with pytest.raises(ValueError, match="unknown variant"):
        ours.run("scan")  # not a variant ("kp" is one on 2D grids)


def test_advance_equals_repeated_steps_and_reuses_buffers():
    ours, _ = _pair((20, 18), "f64")
    T0, Cp = ours.init_state()
    step = ours.step_fn("perf")
    want = T0.clone()
    for _ in range(5):
        nxt = step(want, Cp)
        assert not torch.equal(nxt, want)
        want = nxt
    T = T0.clone()
    out = ours.advance_fn("perf")(T, Cp, 5)
    assert torch.equal(out, want)
    # Two buffers swap: after an odd count the result lies in the spare,
    # after an even count in the caller's (donated) buffer.
    T = T0.clone()
    assert ours.advance_fn("perf")(T, Cp, 4).data_ptr() == T.data_ptr()


def test_tensor_from_numpy_keeps_bf16_bits():
    a = np.asarray(jax.numpy.asarray([1.0, 1.0078125, -3.5], dtype=jax.numpy.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, 1.0078125, -3.5]


def test_entry_matches_graft_entry():
    fn, (T, Cp) = entry(device="cpu")
    jfn, (Tj, Cpj) = jax_entry()
    assert tuple(T.shape) == tuple(Tj.shape) == (252, 252)
    np.testing.assert_allclose(fn(T, Cp).numpy(), np.asarray(jfn(Tj, Cpj)), **TOL["f32"])


def test_perf_app_runs_on_cpu(capsys):
    from rocm_mpi_tpu_torch.apps import diffusion_2d_perf

    rc = diffusion_2d_perf.main(["--device", "cpu", "--nx", "32", "--ny", "24",
                                 "--nt", "6", "--warmup", "2"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "T_eff" in text and "Gpts/s" in text
    assert "not a GPU measurement" in text
