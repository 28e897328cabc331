"""Spectral helpers: Gershgorin bounds and the power method.

Counterpart of rocalution_tpu/ops/spectral.py (reference:
LocalMatrix::Gershgorin, src/base/local_matrix.hpp:1074, which feeds the
Chebyshev solvers, and clients/samples/power-method.cpp).
"""

from __future__ import annotations

import torch

from ..formats import CSR, to_csr
from ..solvers.krylov._common import host_normal, operator_device
from .spmv import as_operator


def gershgorin(A):
    """(lambda_min, lambda_max) bounds from Gershgorin circles, as 0-d
    tensors on A's device: min_i (a_ii - R_i) and max_i (a_ii + R_i),
    where R_i is row i's off-diagonal absolute sum."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    rows = csr.row_ids.long()
    is_diag = csr.row_ids == csr.indices
    zero = torch.zeros_like(csr.data)
    diag = zero.new_zeros(n).index_add_(
        0, rows, torch.where(is_diag, csr.data, zero))
    radius = torch.zeros(n, dtype=zero.real.dtype, device=zero.device)
    radius.index_add_(0, rows, torch.where(is_diag, zero.real,
                                           torch.abs(csr.data)))
    d = torch.real(diag)
    return torch.min(d - radius), torch.max(d + radius)


def power_method(A, *, iters: int = 100, seed: int = 0, x0=None):
    """Dominant eigenvalue estimate after `iters` power iterations
    (reference: clients/samples/power-method.cpp). Returns (lambda, x).
    Without x0 the start is the port's own host draw (as IDR's shadow
    space, solvers/krylov/_common.host_normal), not the JAX package's
    jax.random one."""
    op = as_operator(A)
    if x0 is None:
        n = A.shape[0]
        x0 = host_normal(n, 1, seed)[:, 0].to(
            device=operator_device(A), dtype=getattr(A, "dtype",
                                                     torch.float64))
    else:
        x0 = torch.as_tensor(x0, device=operator_device(A))
    x = x0 / torch.linalg.norm(x0)
    lam = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        y = op(x)
        lam = torch.vdot(x, y)
        x = y / torch.linalg.norm(y)
    return torch.real(lam), x
