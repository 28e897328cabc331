"""The operator as a plain torch CSR tensor, and its diagonal."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def csr_tensor(operator: dict, device, dtype=torch.float64) -> torch.Tensor:
    """torch.sparse_csr_tensor of the harness's arrays (int32 indices)."""
    crow = torch.from_numpy(np.asarray(operator["indptr"], dtype=np.int32))
    col = torch.from_numpy(np.asarray(operator["indices"], dtype=np.int32))
    val = torch.from_numpy(np.asarray(operator["data"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(
            crow.to(device), col.to(device), val.to(device, dtype),
            size=tuple(operator["shape"]), check_invariants=False)


def diagonal(operator: dict, device, dtype=torch.float64) -> torch.Tensor:
    """A's diagonal, from the host arrays."""
    indptr = np.asarray(operator["indptr"], dtype=np.int64)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    cols = np.asarray(operator["indices"])
    on = rows == cols
    d = np.zeros(len(indptr) - 1)
    d[rows[on]] = np.asarray(operator["data"])[on]
    return torch.from_numpy(d).to(device, dtype)


def apply(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x of shape (n,) or (n, k)."""
    if x.dim() == 1:
        return (A @ x[:, None])[:, 0]
    return A @ x
