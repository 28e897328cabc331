"""BiCGStab(l): stabilised bi-conjugate gradients with a degree-l minimal
residual polynomial.

Counterpart of rocalution_tpu/solvers/krylov/bicgstabl.py (reference:
BiCGStabl, src/solvers/krylov/bicgstabl.{hpp,cpp}, ``SetOrder(l)``,
bicgstabl.hpp:69, default 2). Right preconditioned: the recurrences run
on (A M) z = r0 with x = x0 + M z, so the tracked residual is the true
one. The order is a Python int, so the BiCG and MR sweeps unroll into
straight-line vector code; the l+1 directions and residuals are tuples of
vectors in the carry. A step checks the residual l+1 times
(`guarded_check`), and every update after a hit is masked by the live
flag, as in the JAX package. The loop runs in masked chunks (see
_common.run_chunked).
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, prepare, run_chunked, safe_div


def bicgstabl(A, b, x0=None, M=None, *,
              ctrl: IterationControl | None = None, check_every: int = 32,
              **kwargs):
    """Solve A x = b with right-preconditioned BiCGStab(l).

    ``order`` kwarg = l (default 2, as the reference). Returns
    ``(x, SolverInfo)``; ``check_every`` changes no result (see `cg`)."""
    l = int(kwargs.pop("order", 2))
    if l < 1:
        raise ValueError(f"order must be >= 1, got {l}")
    op, b, x0v, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    dtype, dev = b.dtype, b.device

    def K(v):  # the transformed operator
        return op(precond(v))

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=dev)

    r0 = b - op(x0v)
    state = ctrl.init_residual(torch.abs(red.res_norm(r0)))
    rhat = r0  # shadow residual

    z = torch.zeros_like(b)               # solution in the transformed space
    R = (r0,) + (torch.zeros_like(b),) * l
    U = (torch.zeros_like(b),) * (l + 1)
    rho0, alpha, omega = scalar(1.0), scalar(0.0), scalar(1.0)

    def body(carry):
        z, R, U, rho0, alpha, omega, state = carry
        R, U = list(R), list(U)
        rho0 = -omega * rho0

        # BiCG part
        for j in range(l):
            live = state.running
            rho1 = red.dot_nonconj(rhat, R[j])
            beta = safe_div(alpha * rho1, rho0)
            rho0 = torch.where(live, rho1, rho0)
            for i in range(j + 1):
                U[i] = torch.where(live, R[i] - beta * U[i], U[i])
            U[j + 1] = torch.where(live, K(U[j]), U[j + 1])
            gamma = red.dot_nonconj(rhat, U[j + 1])
            alpha = torch.where(live, safe_div(rho0, gamma), alpha)
            for i in range(j + 1):
                R[i] = torch.where(live, R[i] - alpha * U[i + 1], R[i])
            R[j + 1] = torch.where(live, K(R[j]), R[j + 1])
            z = torch.where(live, z + alpha * U[0], z)
            state = guarded_check(ctrl, state, torch.abs(red.res_norm(R[0])))

        # MR part: minimise ||R[0]|| over span{R[1..l]} (modified
        # Gram-Schmidt)
        live = state.running
        tau = [[scalar(0.0) for _ in range(l + 1)] for _ in range(l + 1)]
        sigma = [scalar(0.0) for _ in range(l + 1)]
        gamma_p = [scalar(0.0) for _ in range(l + 1)]
        for j in range(1, l + 1):
            for i in range(1, j):
                tau[i][j] = safe_div(red.dot_nonconj(R[i], R[j]), sigma[i])
                R[j] = torch.where(live, R[j] - tau[i][j] * R[i], R[j])
            sigma[j] = red.dot_nonconj(R[j], R[j])
            gamma_p[j] = safe_div(red.dot_nonconj(R[0], R[j]), sigma[j])

        gamma = [scalar(0.0) for _ in range(l + 1)]
        gamma[l] = gamma_p[l]
        for j in range(l - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j][i] * gamma[i]
            gamma[j] = acc
        gamma_pp = [scalar(0.0) for _ in range(l + 1)]
        for j in range(1, l):
            acc = gamma[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j][i] * gamma[i + 1]
            gamma_pp[j] = acc

        omega = torch.where(live, gamma[l], omega)
        z = torch.where(live, z + gamma[1] * R[0], z)
        R[0] = torch.where(live, R[0] - gamma_p[l] * R[l], R[0])
        U[0] = torch.where(live, U[0] - gamma[l] * U[l], U[0])
        for j in range(1, l):
            U[0] = torch.where(live, U[0] - gamma[j] * U[j], U[0])
            z = torch.where(live, z + gamma_pp[j] * R[j], z)
            R[0] = torch.where(live, R[0] - gamma_p[j] * R[j], R[0])
        state = guarded_check(ctrl, state, torch.abs(red.res_norm(R[0])))
        return (z, tuple(R), tuple(U), rho0, alpha, omega, state)

    carry = run_chunked(body, (z, R, U, rho0, alpha, omega, state),
                        check_every)
    return x0v + precond(carry[0]), info_from_state(carry[-1])
