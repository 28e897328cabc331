"""MultiElimination (ME-ILU), VariablePreconditioner, saddle-point
preconditioner.

Counterpart of rocalution_tpu/precond/me.py (reference:
- MultiElimination, preconditioner_multielimination.{hpp,cpp}: recursive
  2x2 block elimination; ZeroBlockPermutation puts a maximal independent
  set first so that the leading block D is diagonal; recurse on the
  (dropped) Schur complement S = C - E D^{-1} F, ``Set(AA_solver, level,
  drop_off)``, preconditioner_multielimination.hpp:87-98;
- VariablePreconditioner, preconditioner.hpp:431-445: cycles among its
  sub-preconditioners, one a call;
- DiagJacobiSaddlePointPrecond, preconditioner_saddlepoint.hpp:38-59:
  K = [A B; C 0] by the Jacobi-diagonal transform, inner solves on A and
  on S = -C D_A^{-1} B).
The permutations and Schur products are host setup (scipy); the applies
are gathers, SpMVs (WJD kernel launches on the card) and the inner
closures, on the operator's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..formats import CSR, to_csr
from ..formats.base import to_device
from ..ops.ordering import permute_csr, zero_block_permutation
from ..ops.spgemm import _scipy
from ..ops.spgemm import from_scipy as _from_scipy
from ..ops.spmv import maybe_attach_wjd, spmv


def _dense_inverse_solver(A: CSR) -> Callable:
    """r -> A^{-1} r with the inverse formed on the host (setup)."""
    inv = to_device(np.linalg.inv(_scipy(A).toarray()), A.device)
    return lambda r: inv @ r


def multi_elimination(A, levels: int = 2, drop_tol: float = 0.0,
                      last_solver: Optional[Callable] = None) -> Callable:
    """ME-ILU preconditioner closure (reference: MultiElimination
    Set(AA_solver, level, drop_off)). `last_solver(matrix) -> closure`
    builds the coarsest solver (default: the dense inverse); `drop_tol`
    drops Schur entries below it (drop_off)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    dev = csr.device
    build_last = last_solver or _dense_inverse_solver
    if levels <= 0 or n <= 8:
        return build_last(csr)
    size, perm = zero_block_permutation(csr)
    if size == 0 or size == n:
        return build_last(csr)
    import scipy.sparse as sp

    Sp = _scipy(permute_csr(csr, perm, device="cpu"))
    D = Sp[:size, :size]
    F = Sp[:size, size:]
    E = Sp[size:, :size]
    C = Sp[size:, size:]
    d = np.asarray(D.diagonal())
    if np.any(d == 0):
        return build_last(csr)
    inv_d = 1.0 / d
    S = (C - E @ sp.diags(inv_d) @ F).tocsr()
    if drop_tol > 0:
        diag = S.diagonal()
        S.data[np.abs(S.data) < drop_tol] = 0.0
        S.eliminate_zeros()
        S = (S + sp.diags(diag - S.diagonal())).tocsr()

    inner = multi_elimination(_from_scipy(S, dev), levels - 1, drop_tol,
                              last_solver)
    Fd = maybe_attach_wjd(_from_scipy(F, dev))
    Ed = maybe_attach_wjd(_from_scipy(E, dev))
    inv_dd = to_device(inv_d, dev)
    order_d = to_device(np.argsort(perm), dev)   # old index per new slot
    perm_d = to_device(perm, dev)

    def apply(r):
        rp = r[order_d]
        r1, r2 = rp[:size], rp[size:]
        y2 = inner(r2 - spmv(Ed, inv_dd * r1))
        y1 = inv_dd * (r1 - spmv(Fd, y2))
        return torch.cat([y1, y2])[perm_d]

    return apply


def variable_precond(preconds: Sequence[Callable]) -> Callable:
    """VariablePreconditioner: cycles among its sub-preconditioners, one a
    call (reference: preconditioner.hpp:431-445). The counter advances
    with every application, as the JAX package's on-device counter does
    inside a solver loop."""
    branches = list(preconds)
    count = [0]

    def apply(r):
        k = count[0]
        count[0] = k + 1
        return branches[k % len(branches)](r)

    return apply


def saddle_point_precond(K, m: int, solver_A: Optional[Callable] = None,
                         solver_S: Optional[Callable] = None) -> Callable:
    """Saddle-point preconditioner for K = [A B; C 0] with A the leading
    m x m block (reference: DiagJacobiSaddlePointPrecond).
    `solver_A(A_csr) -> closure`, `solver_S(S_csr) -> closure` (defaults:
    dense inverses)."""
    import scipy.sparse as sp

    csr = K if isinstance(K, CSR) else to_csr(K)
    dev = csr.device
    Sp = _scipy(csr)
    A = Sp[:m, :m].tocsr()
    B = Sp[:m, m:].tocsr()
    C = Sp[m:, :m].tocsr()
    dA = np.asarray(A.diagonal())
    if np.any(dA == 0):
        raise ValueError("saddle-point A block has zero diagonal")
    S = (-C @ sp.diags(1.0 / dA) @ B).tocsr()
    solveA = (solver_A or _dense_inverse_solver)(_from_scipy(A, dev))
    solveS = (solver_S or _dense_inverse_solver)(_from_scipy(S, dev))
    Cd = maybe_attach_wjd(_from_scipy(C, dev))

    def apply(r):
        z1 = solveA(r[:m])
        z2 = solveS(r[m:] - spmv(Cd, z1))
        return torch.cat([z1, z2])

    return apply
