"""Multi-coloured preconditioners.

Counterpart of rocalution_tpu/precond/multicolored.py (reference:
MultiColored -> MultiColoredGS / MultiColoredSGS, preconditioner_
multicolored.cpp, _gs.cpp, and MultiColoredILU with the power(q) pattern
``Set(p, q)``, preconditioner_multicolored_ilu.hpp:75): colour-reorder the
matrix so that the triangular sweeps become one batch a colour. The
colouring runs on the host (Jones-Plassmann, ops/ordering.py); the
permuted factors feed the same level schedules as plain GS and ILU, whose
Kahn layering of a colour-permuted matrix gives at most one level a
colour; the permutation is a gather on the device around the solves.
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR, to_csr
from ..formats.base import get_host, to_device
from ..ops.factorize import ilu0, ilup
from ..ops.ordering import multicoloring, permute_csr
from ..ops.trisolve import build_schedule, solve_schedule
from .gs import gs as _gs, sgs as _sgs


def _power_pattern(A: CSR, q: int) -> CSR:
    """Sparsity pattern of |A|^q carrying A's values on the original
    entries (reference: LocalMatrix::SymbolicPower feeding ILU(p, q)), on
    the host."""
    if q <= 1:
        return A
    import scipy.sparse as sp

    data = get_host(A, "data")
    cols = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    S = sp.csr_matrix((np.ones(len(cols)), cols, indptr), shape=A.shape)
    P = S.copy()
    for _ in range(q - 1):
        P = (P @ S).tocsr()
        P.data[:] = 1.0
    Av = sp.csr_matrix((data, cols, indptr), shape=A.shape)
    # the pattern of P (explicit zeros) carrying A's values
    out = sp.csr_matrix(
        (np.zeros(P.nnz, dtype=data.dtype), P.indices, P.indptr),
        shape=A.shape)
    out = (out + Av).tocsr()
    out.sum_duplicates()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(out.indptr))
    return CSR.from_coo(rows, out.indices, out.data, A.shape, device="cpu")


def _permuted(csr: CSR, inner_of, pattern: CSR = None):
    """Colour csr by `pattern` (default: csr), build `inner_of(Ap)` on the
    permuted matrix (on csr's device) and return r -> inner(r[order])[perm]
    on that device."""
    _, perm, _ = multicoloring(csr if pattern is None else pattern)
    inner = inner_of(permute_csr(csr, perm))
    perm_d = to_device(perm, csr.device)
    order_d = to_device(np.argsort(perm), csr.device)

    def apply(r):
        return inner(r[order_d])[perm_d]

    apply.schedules = inner.schedules
    return apply


def multicolored_gs(A):
    """MultiColoredGS: colour-permute, then forward GS on the permuted
    matrix (the colours bound the level count)."""
    return _permuted(A if isinstance(A, CSR) else to_csr(A), _gs)


def multicolored_sgs(A):
    """MultiColoredSGS (reference: preconditioner_multicolored_gs.cpp)."""
    return _permuted(A if isinstance(A, CSR) else to_csr(A), _sgs)


def multicolored_ilu(A, p: int = 0, q: int | None = None):
    """MultiColoredILU(p, q): colour by the |A|^q pattern, permute, ILU(p)
    factorize, level-scheduled solves (reference:
    preconditioner_multicolored_ilu.hpp Set(p, q, level))."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    if q is None:
        q = p + 1

    def inner_of(Ap):
        L, U = ilu0(Ap) if p == 0 else ilup(Ap, p)
        ls = build_schedule(L, unit_diag=True, device=Ap.device)
        us = build_schedule(U, device=Ap.device)

        def apply(r):
            return solve_schedule(us, solve_schedule(ls, r))

        apply.schedules = (ls, us)
        return apply

    return _permuted(csr, inner_of, _power_pattern(csr, max(q, 1)))
