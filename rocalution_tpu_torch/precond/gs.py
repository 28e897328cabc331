"""Gauss-Seidel, symmetric GS and the SOR family.

Counterpart of rocalution_tpu/precond/gs.py (reference: GS, SGS,
src/solvers/preconditioners/preconditioner.cpp — Build extracts the
triangular splits, the apply is LSolve/LLSolve — plus SOR and SSOR).
Applies are exact triangular solves. The split is host setup
(ops/extract.py); each apply runs the level schedule
(ops/trisolve.py) on the operator's device: one step of plain torch ops a
level, as the ILU(0) levels are.
"""

from __future__ import annotations

from ..formats import CSR, to_csr
from ..ops.extract import extract_lower, extract_upper, scale_diagonal
from ..ops.trisolve import build_schedule, solve_schedule
from .jacobi import extract_diagonal


def _csr(A) -> CSR:
    return A if isinstance(A, CSR) else to_csr(A)


def _split(csr: CSR, lower: bool, omega: float = 1.0):
    """The level schedule of D/omega + L (lower) or D/omega + U on csr's
    device."""
    part = (extract_lower if lower else extract_upper)(csr, diag=True)
    if omega != 1.0:
        part = scale_diagonal(part, 1.0 / omega)
    return build_schedule(part)


def _one_sided(sched):
    def apply(r):
        return solve_schedule(sched, r)

    apply.schedules = (sched,)
    return apply


def _symmetric(lo, up, d):
    def apply(r):
        y = solve_schedule(lo, r)
        return solve_schedule(up, d * y if r.dim() == 1 else d[:, None] * y)

    apply.schedules = (lo, up)
    return apply


def gs(A):
    """Gauss-Seidel: z = (D + L)^{-1} r (reference: GS preconditioner)."""
    return _one_sided(_split(_csr(A), True))


def backward_gs(A):
    """Backward Gauss-Seidel: z = (D + U)^{-1} r."""
    return _one_sided(_split(_csr(A), False))


def sgs(A):
    """Symmetric Gauss-Seidel: z = (D+U)^{-1} D (D+L)^{-1} r (reference:
    SGS preconditioner, LLSolve path)."""
    csr = _csr(A)
    return _symmetric(_split(csr, True), _split(csr, False),
                      extract_diagonal(csr))


def sor(A, omega: float = 1.0):
    """SOR: z = (D/omega + L)^{-1} r."""
    return _one_sided(_split(_csr(A), True, omega))


def ssor(A, omega: float = 1.0):
    """Symmetric SOR: z = (D/w+U)^{-1} (D/w) (D/w+L)^{-1} r."""
    csr = _csr(A)
    return _symmetric(_split(csr, True, omega), _split(csr, False, omega),
                      extract_diagonal(csr) / omega)
