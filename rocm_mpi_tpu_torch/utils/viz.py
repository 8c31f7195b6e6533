"""Headless heatmap rendering — counterpart of rocm_mpi_tpu/utils/viz.py.

The reference renders the gathered global temperature field with Plots.jl/GR
in headless mode and saves `../output/Temp_<variant>_<nprocs>_<nxg>_<nyg>.png`
(scripts/diffusion_2D_ap.jl:30,47). Here, as in the JAX package: matplotlib
Agg on rank 0, the same filename scheme, the same transpose-for-display
convention (`heatmap(transpose(T_v))` — axis 0 of the field is x, which
matplotlib plots vertically unless transposed). Fields arrive as numpy
arrays (the apps gather them to rank 0 first).

matplotlib is imported only when a picture is drawn: the package imports
without it, and `available()` lets an app refuse --vis before its run on a
machine that lacks it.
"""

from __future__ import annotations

import pathlib

import numpy as np


def available() -> bool:
    """Can this interpreter draw (is matplotlib importable)?"""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def artifact_name(variant: str, nprocs: int, global_shape) -> str:
    """Temp_<variant>_<nprocs>_<nx_g>_<ny_g>.png (ap.jl:47)."""
    dims = "_".join(str(n) for n in global_shape)
    return f"Temp_{variant}_{nprocs}_{dims}.png"


def save_heatmap(field, path, title: str | None = None) -> pathlib.Path:
    """Render `field` (2D, or 3D mid-slice) to `path` as a PNG heatmap."""
    import matplotlib

    matplotlib.use("Agg")  # headless (the reference's GKSwstype="nul", ap.jl:30)
    import matplotlib.pyplot as plt

    field = np.asarray(field)
    if field.ndim == 3:
        field = field[:, :, field.shape[2] // 2]
    if field.ndim != 2:
        raise ValueError(f"expected 2D/3D field, got shape {field.shape}")

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(field.T, origin="lower", cmap="inferno")
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_shard_panels(field, dims, path, title: str | None = None,
                      signed: bool = False):
    """Render each shard of a 2D field as its own panel — the halo-exchange
    PoC artifact (the reference's docs/poc_rocmaware.png shows one GKS
    window per rank, README.md:5-7). A working exchange shows the blob
    spilling smoothly across panel edges; a broken one shows clipped or
    seamed blobs.

    `signed=True` scales the colormap symmetrically around 0 — required
    for fields that oscillate (the SWE surface height): the default
    non-negative scale would clip every trough to flat colormap-bottom,
    hiding exactly the seams the artifact exists to expose.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    field = np.asarray(field)
    if field.ndim != 2 or len(dims) != 2:
        raise ValueError("shard panels are 2D-only")
    lx, ly = field.shape[0] // dims[0], field.shape[1] // dims[1]
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vmax = (np.abs(field).max() if signed else field.max()) or 1.0
    vmin = -vmax if signed else 0.0
    # Panel rows follow display convention: axis 1 (y) is vertical,
    # top row = highest y shard, so panels tile like the field itself.
    fig, axes = plt.subplots(
        dims[1], dims[0],
        figsize=(3 * dims[0], 2.6 * dims[1]), squeeze=False,
    )
    for cx in range(dims[0]):
        for cy in range(dims[1]):
            shard = field[cx * lx:(cx + 1) * lx, cy * ly:(cy + 1) * ly]
            ax = axes[dims[1] - 1 - cy][cx]
            ax.imshow(shard.T, origin="lower",
                      cmap="RdBu_r" if signed else "inferno",
                      vmin=vmin, vmax=vmax)
            ax.set_title(f"device ({cx},{cy})", fontsize=8)
            ax.set_xticks([]), ax.set_yticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_shard_panels_artifact(field, grid, label, out_dir,
                               signed: bool = False):
    """The app drivers' one entry point for the PoC panels: builds the
    shared filename scheme (poc_<label>_<nprocs>.png) and title, so the
    diffusion and SWE apps cannot drift on either. Returns the path."""
    path = pathlib.Path(out_dir) / f"poc_{label}_{grid.nprocs}.png"
    return save_shard_panels(
        field, grid.dims, path,
        title=f"per-device shards — {label} mesh={grid.dims}",
        signed=signed,
    )
