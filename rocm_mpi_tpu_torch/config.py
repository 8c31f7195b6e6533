"""Configuration of a diffusion run — counterpart of rocm_mpi_tpu/config.py
— of an acoustic-wave run (`WaveConfig`, rocm_mpi_tpu/models/wave.py) and
of a shallow-water run (`SWEConfig`, rocm_mpi_tpu/models/swe.py).

Same fields, same validation, same stable time step. `halo_transport`
picks the diffusion `shard` variant's transport: "ici" the device
exchange, "host" the host-staged numpy oracle (parallel/halo.py
HostStagedStepper); `wire_mode` the halo slabs' on-wire precision
(parallel/wire.py).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from rocm_mpi_tpu_torch.parallel import wire

DTYPES = {
    "f32": torch.float32,
    "f64": torch.float64,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}

# Halo transport selector: "ici" sends device-resident slabs straight to
# the collective (the reference's IGG_ROCMAWARE_MPI=1); "host" stages the
# exchange through host memory (=0).
HALO_TRANSPORT_ENV = "RMT_HALO_TRANSPORT"


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """All knobs of a diffusion run (2D or 3D)."""

    global_shape: tuple[int, ...] = (128, 128)
    lengths: tuple[float, ...] = (10.0, 10.0)  # lx, ly
    lam: float = 1.0  # thermal conductivity λ
    cp0: float = 1.0  # heat capacity
    nt: int = 1000  # time steps
    warmup: int = 10  # steps excluded from timing
    dtype: str = "f64"
    dims: tuple[int, ...] | None = None  # process grid; None = auto
    b_width: tuple[int, ...] = (32, 4)  # boundary frame width (hide)
    do_vis: bool = False
    halo_transport: str = dataclasses.field(
        default_factory=lambda: os.environ.get(HALO_TRANSPORT_ENV, "ici")
    )
    wire_mode: str = "f32"

    def __post_init__(self):
        if len(self.lengths) != len(self.global_shape):
            raise ValueError("lengths rank must match global_shape rank")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        if self.halo_transport not in ("ici", "host"):
            raise ValueError("halo_transport must be 'ici' or 'host'")
        wire.validate_mode(self.wire_mode)

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(l / n for l, n in zip(self.lengths, self.global_shape))

    @property
    def dt(self) -> float:
        """Stable explicit time step: min(h²)·cp0/λ/(2·ndim + 0.1) — the
        reference's 2D /4.1 generalised to N dimensions."""
        h2 = min(d * d for d in self.spacing)
        return h2 * self.cp0 / self.lam / (2 * self.ndim + 0.1)


@dataclasses.dataclass(frozen=True)
class WaveConfig:
    """All knobs of an acoustic-wave run (2D or 3D); the vocabulary of
    DiffusionConfig plus the wave speed and the Courant number."""

    global_shape: tuple[int, ...] = (128, 128)
    lengths: tuple[float, ...] = (10.0, 10.0)
    c0: float = 1.0  # wave speed
    cfl: float = 0.5  # Courant number, < 1 (dt already has the 1/√ndim factor)
    nt: int = 1000
    warmup: int = 10
    dtype: str = "f64"
    dims: tuple[int, ...] | None = None
    b_width: tuple[int, ...] = (32, 4)  # boundary frame width (hide)
    wire_mode: str = "f32"

    def __post_init__(self):
        if len(self.lengths) != len(self.global_shape):
            raise ValueError("lengths rank must match global_shape rank")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        wire.validate_mode(self.wire_mode)

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(l / n for l, n in zip(self.lengths, self.global_shape))

    @property
    def dt(self) -> float:
        """CFL-stable leapfrog step: cfl·min(h)/(c0·√ndim)."""
        return self.cfl * min(self.spacing) / (self.c0 * math.sqrt(self.ndim))


@dataclasses.dataclass(frozen=True)
class SWEConfig:
    """All knobs of a shallow-water run (2D or 3D) — counterpart of
    rocm_mpi_tpu/models/swe.py SWEConfig: the vocabulary of WaveConfig
    with the resting depth H0 and gravity g in place of the wave speed."""

    global_shape: tuple[int, ...] = (128, 128)
    lengths: tuple[float, ...] = (10.0, 10.0)
    H0: float = 1.0  # resting depth
    g: float = 1.0  # gravity
    cfl: float = 0.5  # Courant number vs c = √(g·H0), < 1
    nt: int = 1000
    warmup: int = 10
    dtype: str = "f64"
    dims: tuple[int, ...] | None = None
    b_width: tuple[int, ...] = (32, 4)  # boundary frame width (hide)
    wire_mode: str = "f32"

    def __post_init__(self):
        if len(self.lengths) != len(self.global_shape):
            raise ValueError("lengths rank must match global_shape rank")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        wire.validate_mode(self.wire_mode)

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def spacing(self) -> tuple[float, ...]:
        return tuple(l / n for l, n in zip(self.lengths, self.global_shape))

    @property
    def wave_speed(self) -> float:
        return math.sqrt(self.g * self.H0)

    @property
    def dt(self) -> float:
        """CFL-stable forward-backward step: cfl·min(d)/(c·√ndim)."""
        return self.cfl * min(self.spacing) / (self.wave_speed * math.sqrt(self.ndim))
