"""Preconditioned Conjugate Residual.

Counterpart of rocalution_tpu/solvers/krylov/cr.py (reference: CR,
src/solvers/krylov/cr.{hpp,cpp}): minimises the residual norm for
symmetric, possibly indefinite operators. The recurrence keeps both
z = M r and v = A p, so a step costs one apply of A and one of M. The
loop runs in masked chunks (see _common.run_chunked).
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, run_chunked, safe_div


def cr(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
       check_every: int = 32, **kwargs):
    """Solve A x = b with (preconditioned) CR. Returns ``(x, SolverInfo)``;
    ``check_every`` changes no result (see `cg`)."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))

    z = precond(r)
    p = z
    w = op(z)           # A z
    v = w               # A p
    rho = red.dot_nonconj(z, w)

    def body(carry):
        x, r, z, p, v, rho, state = carry
        t = precond(v)                       # M A p
        sigma = red.dot_nonconj(v, t)
        alpha = safe_div(rho, sigma)
        x = x + alpha * p
        r = r - alpha * v
        z = z - alpha * t
        state = ctrl.check_residual(state, torch.abs(red.res_norm(r)))
        w = op(z)
        rho_new = red.dot_nonconj(z, w)
        beta = safe_div(rho_new, rho)
        p = z + beta * p
        v = w + beta * v
        return (x, r, z, p, v, rho_new, state)

    carry = run_chunked(body, (x, r, z, p, v, rho, state), check_every)
    return carry[0], info_from_state(carry[-1])
