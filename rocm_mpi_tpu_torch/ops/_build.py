"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc, at first use, into a shared
library with a plain C interface under `rocm_mpi_tpu_torch/_build/`
(git-ignored), named by a hash of its source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source rebuilds. The library is loaded with ctypes. Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

`-fmad=false` keeps each multiply and add rounded separately, as the
plain PyTorch versions compute them, so f32/f64 kernel output can be held
bitwise against them.

Every nvcc build is a compile and a cache miss of telemetry.compiles,
and every load of a library already on disk a cache hit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from rocm_mpi_tpu_torch.telemetry import compiles

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Where library `name` is built: named by a hash of its source, the
    shared headers (csrc/*.cuh) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names, verbose: bool = False) -> dict[str, dict]:
    """Compile every missing library of `names`, one nvcc per source, all
    started together. Returns {name: {"path", "seconds", "log"}}; raises
    RuntimeError with nvcc's output if any build fails. `verbose` adds
    `-Xptxas -v` (registers, shared memory, spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    results = {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            results[name] = {"path": path, "seconds": 0.0, "log": "cached"}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
        compiles.record_build(name, seconds)
        results[name] = {"path": path, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The ctypes handle of library `name`, built if needed, with
    `signatures` ({symbol: (restype, [argtypes])}) declared."""
    lib = _LIBS.get(name)
    if lib is None:
        if build([name])[name]["log"] == "cached":
            compiles.record_load_hit()
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, (restype, argtypes) in signatures.items():
            fn = getattr(lib, symbol)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[name] = lib
    return lib
