"""ILU(0) / IC(0) preconditioners and ItILU0.

Counterpart of rocalution_tpu/precond/ilu.py (reference: ILU / IC / ItILU0
preconditioners, src/solvers/preconditioners/preconditioner.cpp; Build
runs the factorization, the apply runs LUSolve / LLSolve). The
factorization is host setup work (ops/factorize.py); the apply runs on the
operator's device, either as exact level-scheduled solves
(``method="levels"``, analog TriSolverAlg_Default) or as fixed Jacobi
sweeps on the factors (``method="jacobi"``, analog TriSolverAlg_Iterative /
ItILU0), whose SpMVs go through the WJD kernels on the card. ILU(p > 0),
ILUT and the block factorizations come with the rest of the
preconditioners (ROADMAP.md section 1 item 8).
"""

from __future__ import annotations

from ..formats import CSR, to_csr
from ..ops.factorize import ic0, ilu0
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
    preconditioner with SetLevel(p)); p = 0 is ported."""
    if p != 0:
        raise NotImplementedError(
            "ILU(p > 0) is not ported yet (ROADMAP.md section 1 item 8)")
    csr = A if isinstance(A, CSR) else to_csr(A)
    L, U = ilu0(csr)
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
