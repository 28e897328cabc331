"""QMRCGStab: quasi-minimal-residual smoothed BiCGStab.

Counterpart of rocalution_tpu/solvers/krylov/qmrcgstab.py (reference:
QMRCGStab, src/solvers/krylov/qmrcgstab.{hpp,cpp}): the algorithm of
Chan, Gallopoulos, Simoncini, Szeto and Tong, BiCGStab's two half-steps
each followed by a QMR smoothing update, right preconditioned. Both
half-steps check the quasi-residual tau (two `guarded_check`s a step);
a hit at the first keeps the half update. The loop runs in masked chunks
(see _common.run_chunked).
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, prepare, real_dtype, run_chunked, \
    safe_div


def qmrcgstab(A, b, x0=None, M=None, *,
              ctrl: IterationControl | None = None, check_every: int = 32,
              **kwargs):
    """Solve A x = b with right-preconditioned QMRCGStab.

    Returns ``(x, SolverInfo)``; ``check_every`` changes no result (see
    `cg`)."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    dtype, dev = b.dtype, b.device

    r = b - op(x)
    res0 = red.norm(r)
    state = ctrl.init_residual(torch.abs(res0))
    r0 = r
    one = torch.ones((), dtype=dtype, device=dev)
    zero_v = torch.zeros_like(r)
    p, v, d = zero_v, zero_v, zero_v
    rho, alpha, omega = one, one, one
    tau = res0.to(real_dtype(dtype))
    theta = torch.zeros((), dtype=tau.dtype, device=dev)
    eta = torch.zeros((), dtype=dtype, device=dev)

    def body(carry):
        x, r, p, v, d, rho, alpha, omega, tau, theta, eta, state = carry
        rho_new = red.dot_nonconj(r0, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = op(phat)
        alpha = safe_div(rho_new, red.dot_nonconj(r0, v))
        s = r - alpha * v

        # first quasi-minimisation half-step
        theta1 = safe_div(red.norm(s), tau)
        c1 = 1.0 / torch.sqrt(1.0 + theta1 * theta1)
        tau1 = tau * theta1 * c1
        eta1 = c1 * c1 * alpha
        d1 = phat + safe_div(theta * theta * eta, alpha) * d
        x_half = x + eta1 * d1
        state = guarded_check(ctrl, state, torch.abs(tau1))
        live = state.running

        # second half-step
        shat = precond(s)
        t = op(shat)
        omega_new = safe_div(red.dot_nonconj(t, s), red.dot_nonconj(t, t))
        r_new = s - omega_new * t
        theta2 = safe_div(red.norm(r_new), tau1)
        c2 = 1.0 / torch.sqrt(1.0 + theta2 * theta2)
        tau2 = tau1 * theta2 * c2
        eta2 = c2 * c2 * omega_new
        d2 = shat + safe_div(theta1 * theta1 * eta1, omega_new) * d1
        x_full = x_half + eta2 * d2
        state = guarded_check(ctrl, state, torch.abs(tau2))

        x = torch.where(live, x_full, x_half)
        r = torch.where(live, r_new, s)
        d = torch.where(live, d2, d1)
        tau = torch.where(live, tau2, tau1)
        theta = torch.where(live, theta2, theta1)
        eta = torch.where(live, eta2, eta1)
        omega = torch.where(live, omega_new, omega)
        return (x, r, p, v, d, rho_new, alpha, omega, tau, theta, eta, state)

    carry = run_chunked(
        body, (x, r, p, v, d, rho, alpha, omega, tau, theta, eta, state),
        check_every)
    return carry[0], info_from_state(carry[-1])
