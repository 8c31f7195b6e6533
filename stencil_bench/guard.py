"""The check that nothing the benchmark runs loaded JAX or the JAX
package: top-level module names compared whole (`rocm_mpi_tpu_torch` is
not `rocm_mpi_tpu`)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "rocm_mpi_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    top = {name.split(".", 1)[0] for name in names}
    return sorted(top.intersection(FORBIDDEN))
