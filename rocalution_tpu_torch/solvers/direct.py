"""Dense direct solvers: Inversion, LU, QR.

Counterpart of rocalution_tpu/solvers/direct.py (reference:
src/solvers/direct/{inversion,lu,qr}.{hpp,cpp} — dense-only direct
solvers). Any format is densified first, on the host where the matrix has
a host cache, and the factors live on the matrix's device (torch.linalg).

One difference from the JAX package: `lu` on f64 input factors in f64.
The JAX package factors in f32 and refines in f64 because the TPU's LU is
f32-only; the card has no such limit, so neither the workaround nor its
``refine_steps`` option is carried over.
"""

from __future__ import annotations

import torch

from ..formats import DENSE
from ..formats.base import to_device
from .iter_ctrl import SolverInfo


def _dense(A) -> torch.Tensor:
    if isinstance(A, DENSE):
        return A.data
    if hasattr(A, "numpy_triplet") and getattr(A, "_host_cache", None):
        # densify on the host (setup phase: no device scatter)
        import scipy.sparse as sp

        d, i, p = A.numpy_triplet()
        return to_device(sp.csr_matrix((d, i, p), shape=A.shape).toarray(),
                         A.device)
    if hasattr(A, "to_dense"):
        return A.to_dense()
    return torch.as_tensor(A)


def _as_columns(b):
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def _info(b, r):
    res = torch.linalg.vector_norm(r)
    b0 = torch.linalg.vector_norm(b)
    return SolverInfo(
        iterations=torch.ones((), dtype=torch.int32, device=b.device),
        status=torch.ones((), dtype=torch.int32, device=b.device),
        init_res=b0,
        final_res=res,
        history=torch.stack([b0, res]),
    )


def qr_factor(A):
    """Build phase: Householder QR; returns a solve closure b -> x for b
    of shape (n,) or (n, k) (reference Build/Solve split)."""
    Q, R = torch.linalg.qr(_dense(A))
    Qh = Q.mH

    def solve(b):
        c, vec = _as_columns(Qh @ b)
        x = torch.linalg.solve_triangular(R, c, upper=True)
        return x[:, 0] if vec else x

    return solve


def qr(A, b):
    """Dense QR solve (reference: direct/qr.cpp — Householder QR)."""
    Ad = _dense(A)
    b = torch.as_tensor(b, device=Ad.device)
    x = qr_factor(A)(b)
    return x, _info(b, b - Ad @ x)


def inversion(A, b):
    """Solve by explicit inverse (reference: direct/inversion.cpp), built
    QR-wise (R^{-1} Q^H) as in the JAX package."""
    Ad = _dense(A)
    b = torch.as_tensor(b, device=Ad.device)
    Q, R = torch.linalg.qr(Ad)
    inv = torch.linalg.solve_triangular(R, Q.mH, upper=True)
    x = inv @ b
    return x, _info(b, b - Ad @ x)


def lu_factor(A):
    """Build phase for `lu`: partial-pivoting LU factors in A's own dtype;
    returns a solve closure b -> x."""
    LU, piv = torch.linalg.lu_factor(_dense(A))

    def solve(b):
        c, vec = _as_columns(b)
        x = torch.linalg.lu_solve(LU, piv, c)
        return x[:, 0] if vec else x

    return solve


def lu(A, b):
    """Dense LU solve (reference: direct/lu.cpp)."""
    Ad = _dense(A)
    b = torch.as_tensor(b, device=Ad.device)
    x = lu_factor(A)(b)
    return x, _info(b, b - Ad @ x)
