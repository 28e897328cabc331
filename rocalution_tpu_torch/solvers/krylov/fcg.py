"""Flexible Conjugate Gradient.

Counterpart of rocalution_tpu/solvers/krylov/fcg.py (reference: FCG,
src/solvers/krylov/fcg.{hpp,cpp}): CG with the Polak-Ribiere (Notay)
beta, so the preconditioner may change from one step to the next (an
inner iterative solver, for one). The loop runs in masked chunks (see
_common.run_chunked).
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, run_chunked, safe_div


def fcg(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
        check_every: int = 32, **kwargs):
    """Solve A x = b with flexible CG. Returns ``(x, SolverInfo)``;
    ``check_every`` changes no result (see `cg`)."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))
    z = precond(r)
    p = z
    rho = red.dot_nonconj(r, z)

    def body(carry):
        x, r, p, rho, state = carry
        q = op(p)
        alpha = safe_div(rho, red.dot_nonconj(p, q))
        x = x + alpha * p
        r_new = r - alpha * q
        state = ctrl.check_residual(state, torch.abs(red.res_norm(r_new)))
        z = precond(r_new)
        rho_new = red.dot_nonconj(r_new, z)
        # Polak-Ribiere / Notay flexible beta: <z_{k+1}, r_{k+1} - r_k> / rho
        beta = safe_div(rho_new - red.dot_nonconj(z, r), rho)
        p = z + beta * p
        return (x, r_new, p, rho_new, state)

    carry = run_chunked(body, (x, r, p, rho, state), check_every)
    return carry[0], info_from_state(carry[-1])
