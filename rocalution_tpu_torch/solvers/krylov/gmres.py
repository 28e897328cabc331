"""Restarted GMRES and flexible GMRES.

Counterpart of rocalution_tpu/solvers/krylov/gmres.py (reference: GMRES,
src/solvers/krylov/gmres.{hpp,cpp}, and FGMRES, fgmres.{hpp,cpp}):
restarted Arnoldi, right preconditioning, default basis size 30, classical
Gram-Schmidt applied twice (CGS2) as two (m+1, n) products a step, Givens
rotations, and the least-squares solve with the unprocessed columns of R
left at the identity. FGMRES stores the preconditioned basis Z, so the
preconditioner may change every step. Real and complex dtypes: the
projections conjugate the basis, and the rotations are the complex-safe
ones of the reference.

PyTorch has no device `while_loop`, so the inner steps run in chunks of
`check_every`, with one host read of the stop flag per chunk. A step
after the stop is masked where it writes: one row of V (and of Z), one
column of R, two rows of the rotation matrix, the iteration state and the
count of steps the cycle took. The cycle then applies its update to x
from the steps taken before the stop, as the reference's `outer_body`
does, so iterations, statuses and histories do not depend on
`check_every`. The rotations of a cycle are kept as one small
(m+1, m+1) matrix Q^T on the device: a step rotates its new Hessenberg
column with one product Q^T h and updates two rows of Q^T, instead of a
round of scalar ops per stored rotation; the residual estimate |g[j+1]|
is beta*|Q^T[j+1, 0]|.
"""

from __future__ import annotations

import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, select_tree


def _givens(a, b):
    """Complex-safe Givens rotation: returns (c, s, r) with c real so that
    [c, s; -conj(s), c] @ [a, b] = [r, 0]."""
    abs_a = torch.abs(a)
    t = torch.sqrt(abs_a ** 2 + torch.abs(b) ** 2)
    safe_t = torch.where(t == 0, torch.ones_like(t), t)
    phase = torch.where(abs_a == 0, torch.ones_like(a),
                        a / torch.where(abs_a == 0, torch.ones_like(abs_a),
                                        abs_a))
    c = torch.where(t == 0, torch.ones_like(abs_a), abs_a / safe_t)
    s = torch.where(t == 0, torch.zeros_like(a),
                    torch.where(abs_a == 0, torch.ones_like(a),
                                phase * torch.conj(b) / safe_t))
    return c, s, phase * t


def _gmres_core(A, b, x0, M, ctrl, check_every, kwargs, *, flexible: bool):
    m = int(kwargs.pop("basis_size", 30))
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    ar = torch.arange(m + 1, device=dev)
    masks = torch.tril(torch.ones((m + 1, m + 1), dtype=dtype, device=dev))

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.norm(r)))

    def inner_step(j, V, Z, R, Qt, beta, taken, state):
        run = state.running
        zj = precond(V[j])
        if flexible:
            Z[j] = torch.where(run, zj, Z[j])
        w = op(zj)
        # CGS2 orthogonalization against V[0..j]
        mask = masks[j]                       # rows 0..j
        h1 = red.project(V, w) * mask
        w = w - h1 @ V
        h2 = red.project(V, w) * mask
        w = w - h2 @ V
        h = h1 + h2
        hj1 = red.norm(w)
        V[j + 1] = torch.where(run, w / torch.where(hj1 == 0, 1.0, hj1),
                               V[j + 1])
        h[j + 1] = hj1
        # apply the stored rotations 0..j-1, then make rotation j
        h = Qt @ h
        c, s, rr = _givens(h[j], h[j + 1])
        qj, qj1 = Qt[j], Qt[j + 1]
        Qt[j], Qt[j + 1] = (torch.where(run, c * qj + s * qj1, qj),
                            torch.where(run, c * qj1 - torch.conj(s) * qj,
                                        qj1))
        h[j] = rr
        h[j + 1] = 0.0
        R[:, j] = torch.where(run, h[:m], R[:, j])
        new = ctrl.check_residual(state, torch.abs(beta * Qt[j + 1, 0]))
        return taken + run.to(taken.dtype), select_tree(run, new, state)

    while bool(state.running):
        r = b - op(x)
        beta = red.norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.where(beta == 0, 1.0, beta)
        Z = torch.zeros((m if flexible else 1, n), dtype=dtype, device=dev)
        R = torch.eye(m, dtype=dtype, device=dev)
        Qt = torch.eye(m + 1, dtype=dtype, device=dev)
        taken = torch.zeros((), dtype=torch.int64, device=dev)
        for j in range(m):
            taken, state = inner_step(j, V, Z, R, Qt, beta, taken, state)
            if (j + 1) % check_every == 0 and not bool(state.running):
                break
        # least squares over the steps taken: R's other columns are the
        # identity and their entries of g are masked to 0
        g = torch.where(ar[:m] < taken, beta * Qt[:m, 0], 0.0)
        y = torch.linalg.solve_triangular(R, g[:, None], upper=True)[:, 0]
        x = x + (y @ Z if flexible else precond(y @ V[:m]))
    return x, info_from_state(state)


def gmres(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
          check_every: int = 32, **kwargs):
    """Solve A x = b with restarted right-preconditioned GMRES(m).

    ``basis_size`` sets the restart length m (default 30, as the reference
    gmres.hpp:46). Iterations count inner steps. ``check_every`` is the
    number of inner steps between host reads of the stop flag; it changes
    no result. Returns ``(x, SolverInfo)``."""
    return _gmres_core(A, b, x0, M, ctrl, check_every, kwargs,
                       flexible=False)


def fgmres(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
           check_every: int = 32, **kwargs):
    """Solve A x = b with flexible restarted GMRES(m): the preconditioner
    may itself be an (iterative) solver that changes every application."""
    return _gmres_core(A, b, x0, M, ctrl, check_every, kwargs,
                       flexible=True)
