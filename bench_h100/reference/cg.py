"""Textbook preconditioned CG with Jacobi: the update order and
stopping rule of rocALUTION's CG (stop after the x and r update once
|r|_2 <= rel_tol |r_0|_2), one host read a step."""

from __future__ import annotations

import torch

from . import csr


def pcg_jacobi(A: torch.Tensor, diag: torch.Tensor, b: torch.Tensor,
               rel_tol: float, x0: torch.Tensor, max_iter: int = 100000):
    """(x, iterations) of CG + Jacobi on A x = b from x0, in b's dtype."""
    x = x0.to(b.dtype)
    r = b - csr.apply(A, x)
    r0 = float(torch.linalg.vector_norm(r))
    z = r / diag
    p = z
    rho = torch.dot(r, z)
    it = 0
    while it < max_iter:
        q = csr.apply(A, p)
        alpha = rho / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        it += 1
        if float(torch.linalg.vector_norm(r)) <= rel_tol * r0:
            break
        z = r / diag
        rho_new = torch.dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
    return x, it
