"""Approximate-inverse preconditioners: FSAI, SPAI, TNS, AIChebyshev.

Counterpart of rocalution_tpu/precond/ai.py (reference:
preconditioner_ai.{hpp,cpp} — AIChebyshev, FSAI(q) over the power-q lower
pattern, SPAI, TNS). The FSAI and SPAI setups are batched small dense
solves on the host, one (n, m, m) `np.linalg.solve` as in the JAX package;
the port assembles the batch with vectorized gathers, grouped by pattern
size, where the JAX package walks the rows in Python, so the same systems
are solved at a million rows in seconds. The applies are SpMV chains on
the operator's device: on the card every SpMV is a WJD kernel launch (the
setup attaches the plans).
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR, to_csr
from ..ops.spgemm import _scipy as _scipy_csr
from ..ops.spmv import maybe_attach_wjd, spmv
from ..solvers.multigrid.rs import _sample
from .jacobi import inverse_diagonal


def _power_lower_pattern(S, q: int):
    """The lower triangle (incl. the diagonal) of the pattern |S|^q, as a
    scipy CSR whose rows are the JAX package's index lists."""
    import scipy.sparse as sp

    P = S.copy()
    P.data[:] = 1.0
    Sq = P
    for _ in range(q - 1):
        Sq = (Sq @ P).tocsr()
        Sq.data[:] = 1.0
    return sp.tril(Sq).tocsr()


def _row_groups(indptr, indices):
    """(k, rows, J) for each pattern size k: the rows of k entries and
    their (rows, k) index lists."""
    lens = np.diff(indptr)
    for k in np.unique(lens):
        if k == 0:
            continue
        rows = np.flatnonzero(lens == k)
        J = indices[indptr[rows][:, None] + np.arange(k)]
        yield int(k), rows, J


def _batched_solve(S, indptr, indices, entry, rhs_of):
    """Solve one identity-padded (n, m, m) system per row of the pattern
    (indptr, indices), m its longest row: block[i][a, b] = entry(J_a,
    J_b), right-hand side rhs_of(i, J). Returns (g, groups)."""
    n = len(indptr) - 1
    m = int(np.diff(indptr).max())
    blocks = np.tile(np.eye(m, dtype=S.dtype), (n, 1, 1))
    rhs = np.zeros((n, m), dtype=S.dtype)
    groups = list(_row_groups(indptr, indices))
    for k, rows, J in groups:
        blocks[rows, :k, :k] = entry(
            np.broadcast_to(J[:, :, None], (len(rows), k, k)),
            np.broadcast_to(J[:, None, :], (len(rows), k, k)))
        rhs[rows, :k] = rhs_of(rows, J)
    return np.linalg.solve(blocks, rhs[..., None]).squeeze(-1), groups


def _entries(M):
    def entry(r, c):
        return _sample(M, r.reshape(-1), c.reshape(-1)).reshape(r.shape)
    return entry


def fsai_matrices(A, q: int = 1):
    """The FSAI(q) factor pair (G, G^T) as CSRs on A's device:
    G ~ L^{-1} over the lower pattern of |A|^q, row i from the system
    A[J, J] g = e_last, scaled by 1/sqrt(g_last)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    S = _scipy_csr(csr)
    n = csr.shape[0]
    L = _power_lower_pattern(S, max(q, 1))

    def unit_last(rows, J):
        e = np.zeros(J.shape, S.dtype)
        e[:, -1] = 1.0   # J ascending: the diagonal entry comes last
        return e

    g, groups = _batched_solve(S, L.indptr, L.indices, _entries(S),
                               unit_last)
    rows, cols, vals = [], [], []
    for k, r, J in groups:
        d = g[r, k - 1]
        if np.any(d <= 0):
            i = int(r[np.argmax(d <= 0)])
            raise ValueError(f"FSAI breakdown at row {i} (pivot "
                             f"{g[i, k - 1]})")
        rows.append(np.repeat(r, k))
        cols.append(J.reshape(-1))
        vals.append((g[r, :k] / np.sqrt(d)[:, None]).reshape(-1))
    G = CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals).astype(S.dtype), (n, n),
                     device=csr.device)
    return G, G.transpose_host()


def fsai(A, q: int = 1):
    """FSAI(q): M^{-1} = G^T G with G ~ L^{-1} over the lower pattern of
    |A|^q (reference: FSAI preconditioner). Apply: two SpMVs."""
    G, Gt = fsai_matrices(A, q)
    for M in (G, Gt):
        maybe_attach_wjd(M)

    def apply(r):
        return spmv(Gt, spmv(G, r))

    apply.matrices = (G, Gt)
    return apply


def spai_matrix(A) -> CSR:
    """The SPAI matrix M = argmin ||A M - I||_F over A's pattern, column j
    from the normal equations (A[:, J]^T A[:, J]) m = A[j, J]^T, J the
    rows of column j; on A's device."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    S = _scipy_csr(csr)
    n = csr.shape[0]
    Sc = S.tocsc()
    AtA = (S.T @ S).tocsr()       # (A[:, J]^T A[:, J])[a, b] = AtA[J_a, J_b]

    def row_j(cols, J):
        return _sample(S, np.repeat(cols, J.shape[1]),
                       J.reshape(-1)).reshape(J.shape)

    mvals, groups = _batched_solve(S, Sc.indptr, Sc.indices, _entries(AtA),
                                   row_j)
    rows = np.concatenate([J.reshape(-1) for _, _, J in groups])
    cols = np.concatenate([np.repeat(c, k) for k, c, _ in groups])
    vals = np.concatenate([mvals[c, :k].reshape(-1) for k, c, _ in groups])
    return CSR.from_coo(rows, cols, vals.astype(S.dtype), (n, n),
                        device=csr.device)


def spai(A):
    """SPAI: M minimizing ||A M - I||_F over the pattern of A; apply = one
    SpMV (reference: SPAI preconditioner)."""
    M = maybe_attach_wjd(spai_matrix(A))

    return lambda r: spmv(M, r)


def tns(A, order: int = 2):
    """TNS: truncated Neumann series M^{-1} = sum_{k<=q} (I - D^{-1}A)^k
    D^{-1}, applied by Horner: `order` SpMVs an apply (reference: TNS
    preconditioner)."""
    csr = maybe_attach_wjd(A if isinstance(A, CSR) else to_csr(A))
    inv_d = inverse_diagonal(csr)

    def apply(r):
        dinv = inv_d if r.dim() == 1 else inv_d[:, None]
        dinv_r = dinv * r
        z = dinv_r
        for _ in range(order):
            z = dinv_r + z - dinv * spmv(csr, z)
        return z

    return apply


def aichebyshev(A, degree: int = 4, lambda_min=None, lambda_max=None):
    """AIChebyshev: z = p(A) r with p the degree-`degree` Chebyshev
    approximation of 1/x on [lambda_min, lambda_max] (reference:
    AIChebyshev; Gershgorin bounds where none are given). Apply: `degree`
    SpMVs, no setup storage."""
    from ..ops.spectral import gershgorin

    csr = maybe_attach_wjd(A if isinstance(A, CSR) else to_csr(A))
    if lambda_min is None or lambda_max is None:
        lo, hi = gershgorin(csr)
        lambda_min = float(lo) if lambda_min is None else lambda_min
        lambda_max = float(hi) if lambda_max is None else lambda_max
        # keep the interval positive and not absurdly wide: a low-degree
        # polynomial cannot track 1/x over many decades (Gershgorin's
        # lower bound is often 0 for M-matrices)
        lambda_min = max(lambda_min, lambda_max / 30.0)
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta

    def apply(r):
        # Chebyshev semi-iteration on A z = r from 0: after `degree` steps
        # z = p_degree(A) r
        z = r / theta
        d = z
        rho = 1.0 / sigma1
        res = r - spmv(csr, z)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            z = z + d
            res = res - spmv(csr, d)
            rho = rho_new
        return z

    return apply
