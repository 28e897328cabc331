"""Chebyshev iteration.

Counterpart of rocalution_tpu/solvers/chebyshev.py (reference: Chebyshev,
src/solvers/chebyshev.{hpp,cpp}): needs bounds of the spectrum through
``Set(lambda_min, lambda_max)`` (chebyshev.hpp:61), as from Gershgorin
circles (ops/spectral.gershgorin) or the power method, and takes an inner
preconditioner like the reference. The recurrence has no inner products:
a step costs one apply of A, one of M and the convergence norm. The loop
runs in masked chunks (see krylov/_common.run_chunked).
"""

from __future__ import annotations

import torch

from .iter_ctrl import IterationControl, info_from_state
from .krylov._common import prepare, run_chunked


def chebyshev(A, b, x0=None, M=None, *, lambda_min, lambda_max,
              ctrl: IterationControl | None = None, check_every: int = 32,
              **kwargs):
    """Solve A x = b with the (preconditioned) Chebyshev semi-iteration.

    ``lambda_min``/``lambda_max`` bound the spectrum of M^{-1} A (numbers
    or 0-d tensors). Returns ``(x, SolverInfo)``; ``check_every`` changes
    no result (see `cg`)."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    lmin = torch.as_tensor(lambda_min, dtype=b.dtype, device=b.device)
    lmax = torch.as_tensor(lambda_max, dtype=b.dtype, device=b.device)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))
    z = precond(r)
    d = z / theta
    x = x + d
    rho = 1.0 / sigma1

    def body(carry):
        x, r, d, rho, state = carry
        r = r - op(d)
        state = ctrl.check_residual(state, torch.abs(red.res_norm(r)))
        z = precond(r)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        return (x, r, d, rho_new, state)

    carry = run_chunked(body, (x, r, d, rho, state), check_every)
    return carry[0], info_from_state(carry[-1])
