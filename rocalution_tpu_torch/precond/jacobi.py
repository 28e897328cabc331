"""Jacobi (diagonal) preconditioner.

Counterpart of rocalution_tpu/precond/jacobi.py (reference: Jacobi,
src/solvers/preconditioners/preconditioner.cpp — Build extracts the
inverse diagonal; apply = pointwise multiply).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, DENSE, DIA, MCSR, Stencil, to_csr
from ..formats.base import get_host, to_device


def jacobi(A):
    """Build a Jacobi preconditioner closure r -> D^{-1} r."""
    inv_diag = inverse_diagonal(A)

    def apply(r):
        return inv_diag * r

    return apply


def extract_diagonal(A) -> torch.Tensor:
    """Diagonal of A on A's device (reference: LocalMatrix::
    ExtractDiagonal), from the device arrays: for operands without a host
    cache, such as coarse operators rebuilt on the device; a stencil's is
    its zero offset's weight."""
    if isinstance(A, DENSE):
        return torch.diagonal(A.data)
    if isinstance(A, Stencil):
        return A.diagonal()
    if isinstance(A, MCSR):
        return A.diag
    if isinstance(A, DIA):
        if 0 in A.offsets:
            return A.data[A.offsets.index(0), : min(A.shape)]
        return A.data.new_zeros(min(A.shape))
    csr = A if isinstance(A, CSR) else to_csr(A)
    is_diag = csr.row_ids == csr.indices
    diag = csr.data.new_zeros(min(csr.shape))
    return diag.index_add_(0, torch.where(is_diag, csr.row_ids, 0).long(),
                           torch.where(is_diag, csr.data, 0))


def inverse_diagonal(A) -> torch.Tensor:
    """Inverse diagonal on A's device: from the host cache where there is
    one (setup reads no device memory), else from the device arrays.
    Zero diagonal entries map to 1."""
    host = inverse_diagonal_host(A)
    if host is not None:
        return to_device(host, A.device)
    d = extract_diagonal(A)
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)


def inverse_diagonal_host(A):
    """Numpy inverse diagonal from host caches; None if unavailable.
    Zero diagonal entries map to 1."""
    if isinstance(A, DIA):
        if 0 not in A.offsets:
            return np.ones(min(A.shape))
        d = get_host(A, "data")[A.offsets.index(0), : min(A.shape)]
    elif isinstance(A, CSR) and getattr(A, "_host_cache", None):
        # CSR stores each diagonal entry at most once: direct assignment
        data = get_host(A, "data")
        indices = get_host(A, "indices")
        rows = get_host(A, "row_ids")
        d = np.zeros(min(A.shape), data.dtype)
        sel = indices == rows
        d[rows[sel]] = data[sel]
    else:
        return None
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
