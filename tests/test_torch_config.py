"""The port's DiffusionConfig against the JAX package's: same dt, spacing,
dtype map and validation."""

import dataclasses

import numpy as np
import pytest
import torch

from rocm_mpi_tpu.config import DTYPES as JAX_DTYPES
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu_torch.config import DTYPES, DiffusionConfig

CASES = [
    dict(global_shape=(128, 128)),
    dict(global_shape=(252, 252), dtype="f32"),
    dict(global_shape=(12288, 12288), dtype="bf16"),
    dict(global_shape=(64, 48), lengths=(10.0, 7.5), lam=1.3, cp0=0.7),
    dict(global_shape=(16, 12, 20), lengths=(1.0, 2.0, 3.0), dtype="f32"),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: str(kw["global_shape"]))
def test_dt_and_spacing_equal_jax(kw):
    ours, ref = DiffusionConfig(**kw), JaxConfig(**kw)
    assert ours.dt == ref.dt  # same Python double arithmetic, bit for bit
    assert ours.spacing == ref.spacing
    assert ours.ndim == ref.ndim
    for f in dataclasses.fields(JaxConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_dtype_map_matches_names_and_widths():
    assert set(DTYPES) == set(JAX_DTYPES)
    for name, tdt in DTYPES.items():
        assert torch.empty(0, dtype=tdt).element_size() == np.dtype(JAX_DTYPES[name]).itemsize
    assert DiffusionConfig(dtype="bf16").torch_dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(global_shape=(8, 8), lengths=(1.0,)),
    dict(dtype="f16"),
    dict(halo_transport="mpi"),
    dict(wire_mode="fp8"),
])
def test_invalid_configs_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        DiffusionConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(halo_transport="host"),
    dict(wire_mode="bf16"),
    dict(wire_mode="int8_delta"),
])
def test_unported_knobs_raise_not_implemented(kw):
    # The host-staged transport and the wire modes are ported: the port
    # accepts every knob the reference accepts, with the same values.
    jax_cfg = JaxConfig(**kw)  # valid in the reference
    cfg = DiffusionConfig(**kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == getattr(jax_cfg, name) == value
