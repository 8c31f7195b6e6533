"""ctypes binding of the native host-staging engine — counterpart of
rocm_mpi_tpu/parallel/native_halo.py.

The C++ library (`rocm_mpi_tpu_torch/csrc/halostage.cpp`, the port's copy
of `native/halostage.cpp`) runs the same pack → stage → unpack → update
cycle as the numpy HostStagedStepper (parallel/halo.py), one thread per
shard; the two are bitwise equal. It builds with g++ at first use into
`rocm_mpi_tpu_torch/_build/` (git-ignored), named by a hash of its source
and flags:

    g++ -O3 -std=c++17 -fPIC -pthread -shared -o libhalostage-<hash>.so \
        csrc/halostage.cpp

Several processes may build at once (the test ranks, xdist workers): each
compiles to a name of its own and renames it into place, which is atomic,
so none ever loads a partial file. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from rocm_mpi_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "halostage.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
ABI_VERSION = 1

_lib = None
_error: str | None = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhalostage-{digest.hexdigest()[:12]}.so"


def build():
    """Compile the engine unless its library is already built; returns
    its path. Raises RuntimeError with the compiler's output on failure."""
    path = library_path()
    if path.is_file():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native halostage engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for halostage.cpp (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a process building alongside never sees a partial file
    return path


def _load():
    """The loaded library; builds it at the first call. Raises RuntimeError
    when it cannot be built or has another ABI (and on every later call)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise RuntimeError(_error)
    try:
        lib = ctypes.CDLL(str(build()))
        if lib.rmt_abi_version() != ABI_VERSION:
            raise RuntimeError(f"halostage ABI {lib.rmt_abi_version()} != {ABI_VERSION}")
    except (RuntimeError, OSError) as e:
        _error = f"native halostage engine unavailable: {e}"
        raise RuntimeError(_error) from e
    dbl = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.rmt_host_staged_step.restype = ctypes.c_int
    lib.rmt_host_staged_step.argtypes = [
        dbl, dbl, dbl,  # T, Cp, out
        i64, i64, ctypes.c_int,  # shape, dims, ndim
        dbl, ctypes.c_double, ctypes.c_double,  # inv_d2, lam, dt
        ctypes.c_int,  # threads
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the engine is built (building it now if needed) and has
    this binding's ABI."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def host_staged_step(T: np.ndarray, Cp: np.ndarray, dims, spacing, lam: float,
                     dt: float, threads: int = 0) -> np.ndarray:
    """One native host-staged diffusion step; the contract of
    HostStagedStepper.step (f64, row-major, 2D/3D). Raises RuntimeError
    when the engine cannot be built, ValueError on a geometry it refuses."""
    if not len(dims) == len(spacing) == np.ndim(T) == np.ndim(Cp) or np.shape(T) != np.shape(Cp):
        raise ValueError(f"T {np.shape(T)}, Cp {np.shape(Cp)}, dims {tuple(dims)} and "
                         f"spacing {tuple(spacing)} disagree on the axes")
    lib = _load()
    T = np.ascontiguousarray(T, dtype=np.float64)
    Cp = np.ascontiguousarray(Cp, dtype=np.float64)
    out = np.empty_like(T)
    ndim = T.ndim
    shape = (ctypes.c_int64 * ndim)(*T.shape)
    dims_c = (ctypes.c_int64 * ndim)(*dims)
    inv_d2 = (ctypes.c_double * ndim)(*(1.0 / (d * d) for d in spacing))

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.rmt_host_staged_step(ptr(T), ptr(Cp), ptr(out), shape, dims_c, ndim, inv_d2,
                                  float(lam), float(dt), int(threads))
    if rc != 0:
        raise ValueError(f"rmt_host_staged_step failed with code {rc}")
    return out
