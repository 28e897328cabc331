"""Preconditioned BiCGStab.

Counterpart of rocalution_tpu/solvers/krylov/bicgstab.py (reference:
BiCGStab, src/solvers/krylov/bicgstab.{hpp,cpp}): van der Vorst's
stabilised bi-conjugate gradients with right preconditioning and the
half-step check (||s|| is checked before the second apply, and a hit
there ends the solve with the half update). A step computes both halves
and selects between them where the half-step check stopped, as the JAX
package does, so the counts are its own. Breakdown divisions are guarded
(safe_div). The loop runs in masked chunks (see _common.run_chunked).
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, run_chunked, safe_div, select_tree


def bicgstab(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
             check_every: int = 32, **kwargs):
    """Solve A x = b with right-preconditioned BiCGStab.

    Returns ``(x, SolverInfo)``; ``check_every`` changes no result (see
    `cg`)."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))
    r0 = r                      # shadow residual
    p = torch.zeros_like(r)
    v = torch.zeros_like(r)
    one = torch.ones((), dtype=r.dtype, device=r.device)
    rho, alpha, omega = one, one, one

    def body(carry):
        x, r, p, v, rho, alpha, omega, state = carry
        rho_new = red.dot_nonconj(r0, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = op(phat)
        alpha = safe_div(rho_new, red.dot_nonconj(r0, v))
        s = r - alpha * v
        # the half-step check (the reference checks ||s|| mid-iteration)
        state_half = ctrl.check_residual(state, torch.abs(red.res_norm(s)))
        x_half = x + alpha * phat

        shat = precond(s)
        t = op(shat)
        omega_new = safe_div(red.dot_nonconj(t, s), red.dot_nonconj(t, t))
        x_full = x_half + omega_new * shat
        r_full = s - omega_new * t
        state_full = ctrl.check_residual(state,
                                         torch.abs(red.res_norm(r_full)))

        go_full = state_half.running
        x = torch.where(go_full, x_full, x_half)
        r = torch.where(go_full, r_full, s)
        omega = torch.where(go_full, omega_new, omega)
        state = select_tree(go_full, state_full, state_half)
        return (x, r, p, v, rho_new, alpha, omega, state)

    carry = run_chunked(body, (x, r, p, v, rho, alpha, omega, state),
                        check_every)
    return carry[0], info_from_state(carry[-1])
