"""IDR(s): Induced Dimension Reduction with a shadow space of dimension s.

Counterpart of rocalution_tpu/solvers/krylov/idr.py (reference: IDR,
src/solvers/krylov/idr.{hpp,cpp}, ``SetShadowSpace`` and
``SetRandomSeed``, idr.hpp:73-76): the bi-orthogonalised, preconditioned
IDR(s) of van Gijzen and Sonneveld, with the omega angle correction
(kappa = 0.7). s is a Python int, so the inner k-sweep unrolls; the s
shadow inner products of a step are one (s, n) @ (n,) product
(`ReductionOps.project`). A step checks the residual s+1 times
(`guarded_check`), and every update after a hit is masked by the live
flag. The loop runs in masked chunks (see
_common.run_chunked).

The shadow space P is an orthonormalised (n, s) normal draw. The JAX
package draws it with jax.random, whose numbers torch cannot reproduce;
the port draws it on the host (`host_normal`, f64), so the CPU and the
card use one P, and a test hands the port JAX's draw (``shadow_draw``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, host_normal, prepare, run_chunked, \
    safe_div


def shadow_basis(n: int, s: int, seed: int, draw=None) -> torch.Tensor:
    """(s, n) orthonormal rows: the Q of a QR of the (n, s) normal draw
    (`host_normal(n, s, seed)` unless `draw` is given), in f64 on the
    host."""
    P = (host_normal(n, s, seed) if draw is None
         else torch.from_numpy(np.array(draw, dtype=np.float64)))
    if tuple(P.shape) != (n, s):
        raise ValueError(f"shadow_draw must have shape ({n}, {s}), got "
                         f"{tuple(P.shape)}")
    return torch.linalg.qr(P)[0].T


def idr(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
        check_every: int = 32, **kwargs):
    """Solve A x = b with preconditioned IDR(s).

    Kwargs: ``shadow_space`` = s (default 4), ``seed`` (default 0, analog
    SetRandomSeed), ``kappa`` (default 0.7), ``shadow_draw``: the (n, s)
    normal draw to orthonormalise in place of the port's own. Returns
    ``(x, SolverInfo)``; ``check_every`` changes no result (see `cg`)."""
    s = int(kwargs.pop("shadow_space", 4))
    seed = int(kwargs.pop("seed", 0))
    kappa = float(kwargs.pop("kappa", 0.7))
    draw = kwargs.pop("shadow_draw", None)
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    n, dtype, dev = b.shape[0], b.dtype, b.device

    r = b - op(x)
    state = ctrl.init_residual(torch.abs(red.res_norm(r)))

    # distributed, every part draws the same (n/parts, s) basis, as every
    # shard of the JAX package's shard_map draws it from one key
    P = shadow_basis(n // red.parts, s, seed, draw).to(device=dev,
                                                       dtype=dtype)
    P = P.repeat(1, red.parts)
    G = (torch.zeros_like(b),) * s
    U = (torch.zeros_like(b),) * s
    Mm = torch.eye(s, dtype=dtype, device=dev)
    omega = torch.ones((), dtype=dtype, device=dev)
    ar = torch.arange(s, device=dev)

    def shadow_dots(v):
        return red.project(P, v)  # (s,)

    def combine(c, V):
        """sum_j c[j] V[j] for a tuple of vectors V."""
        return c @ torch.stack(V)

    def body(carry):
        x, r, G, U, Mm, omega, state = carry
        G, U = list(G), list(U)
        f = shadow_dots(r)
        for k in range(s):
            live = state.running
            # solve the lower-triangular Mm[k:, k:] c = f[k:]
            c = torch.linalg.solve_triangular(
                Mm[k:, k:], f[k:, None], upper=False)[:, 0]
            v = precond(r - combine(c, G[k:]))
            u_new = combine(c, U[k:]) + omega * v
            g_new = op(u_new)
            # bi-orthogonalise g_new against P[0..k-1], one at a time
            for i in range(k):
                ai = safe_div(red.dot_nonconj(P[i], g_new), Mm[i, i])
                g_new = g_new - ai * G[i]
                u_new = u_new - ai * U[i]
            U[k] = torch.where(live, u_new, U[k])
            G[k] = torch.where(live, g_new, G[k])
            mk = shadow_dots(G[k])
            # Mm[k:, k] = mk[k:] while live
            Mm = torch.where(live & (ar >= k)[:, None] & (ar == k)[None, :],
                             mk[:, None], Mm)
            beta = safe_div(f[k], Mm[k, k])
            r = torch.where(live, r - beta * G[k], r)
            x = torch.where(live, x + beta * U[k], x)
            state = guarded_check(ctrl, state, torch.abs(red.res_norm(r)))
            if k + 1 < s:
                f = torch.where(live, f - beta * Mm[:, k], f)
                f = torch.where(ar <= k, torch.zeros_like(f), f)
        # enter the next Sonneveld space
        live = state.running
        v = precond(r)
        t = op(v)
        tt = red.dot_nonconj(t, t)
        tr = red.dot_nonconj(t, r)
        om = safe_div(tr, tt)
        # angle correction (van Gijzen): keep |cos| >= kappa
        nt = torch.sqrt(torch.abs(tt))
        nr = red.norm(r)
        rho = torch.abs(safe_div(tr, nt * nr))
        om = torch.where(rho < kappa,
                         om * safe_div(torch.full_like(rho, kappa), rho), om)
        omega = torch.where(live, om, omega)
        x = torch.where(live, x + omega * v, x)
        r = torch.where(live, r - omega * t, r)
        state = guarded_check(ctrl, state, torch.abs(red.res_norm(r)))
        return (x, r, tuple(G), tuple(U), Mm, omega, state)

    carry = run_chunked(body, (x, r, G, U, Mm, omega, state), check_every)
    return carry[0], info_from_state(carry[-1])
