"""ILU(p) / IC(0) / ILUT / ItILU0 and the BCSR ILU(0) / IC(0)
preconditioners.

Counterpart of rocalution_tpu/precond/ilu.py (reference: ILU / IC / ILUT /
ItILU0 preconditioners, src/solvers/preconditioners/preconditioner.cpp;
Build runs the factorization, the apply runs LUSolve / LLSolve; the BCSR
ones rocsparse bsrilu0 / bsric0). The factorization is host setup work
(ops/factorize.py); the apply runs on the operator's device, either as
exact level-scheduled solves (``method="levels"``, analog
TriSolverAlg_Default) or as fixed Jacobi sweeps on the factors
(``method="jacobi"``, analog TriSolverAlg_Iterative / ItILU0), whose SpMVs
go through the WJD kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, to_csr
from ..formats.base import to_device
from ..ops.factorize import bsric0, bsrilu0, ic0, ilu0, ilup, ilut
from ..ops.trisolve import (build_schedule, inverse_diagonal_of,
                            prepare_offd, solve_schedule, trisolve_jacobi)


def _lu_apply(Lo: CSR, Up: CSR, method: str, sweeps: int, device,
               unit_lower: bool):
    """Closure r -> Up^{-1} Lo^{-1} r on ``device``. Everything the apply
    reads (schedules, or the off-diagonal parts with their plans and the
    inverse diagonals) is built here, at setup."""
    if method == "levels":
        ls = build_schedule(Lo, unit_diag=unit_lower, device=device)
        us = build_schedule(Up, device=device)

        def apply(r):
            return solve_schedule(us, solve_schedule(ls, r))
    elif method == "jacobi":
        # csritsv-analysis analog, run now (setup phase)
        for T in (Lo, Up):
            prepare_offd(T, device)
        for T in ((Up,) if unit_lower else (Lo, Up)):
            inverse_diagonal_of(T, device, T.dtype)

        def apply(r):
            y = trisolve_jacobi(Lo, r, sweeps=sweeps, unit_diag=unit_lower)
            return trisolve_jacobi(Up, y, sweeps=sweeps)
    else:
        raise ValueError(f"unknown tri-solve method {method!r}")
    apply.factors = (Lo, Up)
    apply.schedules = (ls, us) if method == "levels" else None
    return apply


def ilu(A, p: int = 0, *, method: str = "levels", sweeps: int = 8):
    """ILU(p) preconditioner closure r -> (LU)^{-1} r (reference: ILU
    preconditioner with SetLevel(p))."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L, U = ilu0(csr) if p == 0 else ilup(csr, p)
    return _lu_apply(L, U, method, sweeps, A.device, unit_lower=True)


def ilut_precond(A, tol: float = 1e-3, max_fill: int = 32, *,
                 method: str = "levels", sweeps: int = 8):
    """ILUT(t, m) preconditioner (reference: ILUT preconditioner)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L, U = ilut(csr, tol, max_fill)
    return _lu_apply(L, U, method, sweeps, A.device, unit_lower=True)


def ic(A, *, method: str = "levels", sweeps: int = 8):
    """IC(0) preconditioner: z = L^{-T} L^{-1} r (reference: IC
    preconditioner, LLSolve path). Any method other than "levels" applies
    Jacobi sweeps, as in the reference."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L = ic0(csr)
    Lt = L.transpose_host()
    return _lu_apply(L, Lt, "levels" if method == "levels" else "jacobi",
                      sweeps, A.device, unit_lower=False)


def itilu0(A, sweeps: int = 8):
    """ItILU0: ILU(0) factors applied with fixed iterative sweeps
    (reference: ItILU0 preconditioner / rocsparse csritilu0)."""
    return ilu(A, 0, method="jacobi", sweeps=sweeps)


def _flatten_blocks(vals, bcols, brows, nrowb, ncolb, bd, *,
                    unit_diag_blocks: bool) -> CSR:
    """(nnzb, bd, bd) block triplet -> host scalar CSR. With
    ``unit_diag_blocks`` an identity diagonal block is appended per block
    row (the factor stores only its off-diagonal blocks)."""
    n = nrowb * bd
    nb = len(vals)
    r0 = np.repeat(brows * bd, bd * bd) + np.tile(
        np.repeat(np.arange(bd), bd), nb)
    c0 = np.repeat(bcols * bd, bd * bd) + np.tile(
        np.tile(np.arange(bd), bd), nb)
    v0 = vals.reshape(-1)
    if unit_diag_blocks:
        dr = np.arange(n, dtype=np.int64)
        r0 = np.concatenate([r0, dr])
        c0 = np.concatenate([c0, dr])
        v0 = np.concatenate([v0, np.ones(n, vals.dtype)])
    # drop structural zeros inside blocks, never the diagonal itself
    keep = (v0 != 0) | (r0 == c0)
    return CSR.from_coo(r0[keep], c0[keep], v0[keep], (n, ncolb * bd),
                        device="cpu")


def _blockdiag_apply(dinv, y, bd, n):
    """x_i = inv(D_ii) y_i per block row: one batched product."""
    nrowb = dinv.shape[0]
    tail = tuple(y.shape[1:])
    pad = nrowb * bd - y.shape[0]
    yp = torch.cat([y, y.new_zeros((pad,) + tail)]) if pad else y
    xb = torch.einsum("nij,nj...->ni...", dinv,
                      yp.reshape((nrowb, bd) + tail))
    return xb.reshape((nrowb * bd,) + tail)[:n]


def bsr_ilu0(A, *, method: str = "levels", sweeps: int = 8):
    """BCSR ILU(0) preconditioner: the factorization runs at BLOCK
    granularity (ops/factorize.bsrilu0, reference rocsparse_bsrilu0), then

    * L (unit diagonal blocks) flattens to a scalar unit-lower factor;
    * U is row-transformed by the inverses of its diagonal blocks
      (U~ = D_U^{-1} U, identity diagonal blocks), so that the scalar
      factor is unit-upper and each (bd, bd) solve is one batched product.

    Apply: z = U~^{-1} D_U^{-1} L^{-1} r, exactly (L_b U_b)^{-1} r."""
    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR), "bsr_ilu0 wants a BCSR operand"
    (lv, lc, lr), (uv, uc, ur), dinv = bsrilu0(A)
    bd = A.block_dim
    nrowb = dinv.shape[0]
    # U~'s strictly upper blocks: inv(U_ii) U_ij (its diagonal blocks are
    # exactly I, appended as the flat unit diagonal)
    upper_strict = uc != ur
    uv2 = np.einsum("nij,njk->nik", dinv[ur[upper_strict]],
                    uv[upper_strict])
    L = _flatten_blocks(lv, lc, lr, nrowb, nrowb, bd, unit_diag_blocks=True)
    Ut = _flatten_blocks(uv2, uc[upper_strict], ur[upper_strict], nrowb,
                         nrowb, bd, unit_diag_blocks=True)
    dinv_d = to_device(dinv, A.device)
    n = A.shape[0]
    if method == "levels":
        ls = build_schedule(L, unit_diag=True, device=A.device)
        us = build_schedule(Ut, unit_diag=True, device=A.device)

        def apply(r):
            y = _blockdiag_apply(dinv_d, solve_schedule(ls, r), bd, n)
            return solve_schedule(us, y)
    else:
        for T in (L, Ut):
            prepare_offd(T, A.device)

        def apply(r):
            y = trisolve_jacobi(L, r, sweeps=sweeps, unit_diag=True)
            y = _blockdiag_apply(dinv_d, y, bd, n)
            return trisolve_jacobi(Ut, y, sweeps=sweeps, unit_diag=True)
    apply.factors = (L, Ut)
    apply.schedules = (ls, us) if method == "levels" else None
    return apply


def bsr_ic0(A, *, method: str = "levels", sweeps: int = 8):
    """BCSR IC(0): the block Cholesky factor (ops/factorize.bsric0,
    reference rocsparse_bsric0). The flattened factor is scalar lower
    triangular (Cholesky diagonal blocks are lower triangular), so the
    L L^T solves of `ic` apply unchanged."""
    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR), "bsr_ic0 wants a BCSR operand"
    vals, cols, rows = bsric0(A)
    bd = A.block_dim
    nrowb = -(-A.shape[0] // bd)
    L = _flatten_blocks(vals, cols, rows, nrowb, nrowb, bd,
                        unit_diag_blocks=False)
    return _lu_apply(L, L.transpose_host(),
                     "levels" if method == "levels" else "jacobi", sweeps,
                     A.device, unit_lower=False)
