"""Stencil slicing helpers — counterpart of rocm_mpi_tpu/ops/stencil.py.

The reference's array-programming vocabulary (`d_xa/d_xi/d_ya/d_yi/inn`),
generalised to N dimensions. Basic slices of a tensor are views; the
differences allocate their result.

  d_a(A, ax): forward difference along `ax`, all other axes full.
  d_i(A, ax): forward difference along `ax`, all other axes inner (1:-1).
  inn(A): interior of A (1:-1 on every axis).
"""

from __future__ import annotations

import torch


def _slc(ndim: int, axis: int, s: slice, other: slice) -> tuple[slice, ...]:
    return tuple(s if ax == axis else other for ax in range(ndim))


def d_a(A: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward difference along `axis`, full extent on other axes."""
    hi = _slc(A.ndim, axis, slice(1, None), slice(None))
    lo = _slc(A.ndim, axis, slice(None, -1), slice(None))
    return A[hi] - A[lo]


def d_i(A: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward difference along `axis`, inner extent on other axes."""
    hi = _slc(A.ndim, axis, slice(1, None), slice(1, -1))
    lo = _slc(A.ndim, axis, slice(None, -1), slice(1, -1))
    return A[hi] - A[lo]


def inn(A: torch.Tensor) -> torch.Tensor:
    """Interior of A: drop one boundary cell on every axis."""
    return A[tuple(slice(1, -1) for _ in range(A.ndim))]


def d_xa(A):
    return d_a(A, 0)


def d_ya(A):
    return d_a(A, 1)


def d_xi(A):
    return d_i(A, 0)


def d_yi(A):
    return d_i(A, 1)
