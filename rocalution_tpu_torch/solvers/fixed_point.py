"""Fixed-point (preconditioned Richardson) iteration.

Counterpart of rocalution_tpu/solvers/fixed_point.py (reference:
FixedPoint, src/solvers/solver.hpp:467-510 —
x_{k+1} = x_k + omega * M^{-1} r_k with ``SetRelaxation(omega)``).
`fixed_point` runs in masked chunks (`_common.run_chunked`), so its
iterations and history do not depend on ``check_every``;
`fixed_point_sweeps` is the fixed-count variant without a convergence
check, the smoother building block.
"""

from __future__ import annotations

import torch

from ..ops.spmv import as_operator
from .iter_ctrl import IterationControl, info_from_state
from .krylov._common import identity_precond, prepare, run_chunked


def fixed_point(A, b, x0=None, M=None, *, omega: float = 1.0,
                ctrl: IterationControl | None = None, check_every: int = 32,
                **kwargs):
    """Solve A x = b with relaxed fixed-point iteration. Returns
    ``(x, SolverInfo)``; kwargs as for `cg`."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))

    def body(carry):
        x, r, state = carry
        x = x + omega * precond(r)
        r = b - op(x)
        state = ctrl.check_residual(state, torch.abs(red.res_norm(r)))
        return (x, r, state)

    x, r, state = run_chunked(body, (x, r, state), check_every)
    return x, info_from_state(state)


def fixed_point_sweeps(A, b, x, M=None, *, sweeps: int = 1,
                       omega: float = 1.0):
    """`sweeps` relaxation steps with NO convergence check (reference:
    FixedPoint as the default smoother, base_amg.cpp). Returns x only."""
    op = as_operator(A)
    precond = identity_precond if M is None else as_operator(M)
    for _ in range(sweeps):
        x = x + omega * precond(b - op(x))
    return x
