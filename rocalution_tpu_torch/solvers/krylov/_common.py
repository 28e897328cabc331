"""Shared helpers for Krylov solvers.

Counterpart of rocalution_tpu/solvers/krylov/_common.py. A solver runs
distributed when ``axis_name`` is a communicator (parallel/comm.py): its
vectors are this process's parts end to end, and every reduction sums
per-part partials over the parts (the JAX package's `psum` over the mesh
axis; `pmax` for the L-infinity norm).

PyTorch has no device `while_loop`, so `run_chunked` runs a solver
body in chunks of `check_every` steps: each step keeps its new carry only
where `running` holds (`select_tree`), and the host reads `running` once
per chunk. Iteration counts, statuses and histories therefore do not
depend on `check_every`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...config import default_device, get_config
from ...formats import MatrixBase
from ...ops import blas1
from ...ops.spmv import as_operator
from ...utils import validate
from ...utils.log import log_debug
from ..iter_ctrl import IterationControl


class ReductionOps(NamedTuple):
    """Inner products/norms. `res_norm` is the convergence-check norm
    selected by the user (L1/L2/L-infinity: SetResidualNorm analog,
    solver.hpp:386); algorithmic norms always use `norm` (L2)."""

    dot: Callable
    dot_nonconj: Callable
    norm: Callable
    sum: Callable
    # conj(V) @ w over the whole vector, for the rows of a (k, n) basis V:
    # the JAX package's `allreduce(conj(V) @ w)`
    project: Callable
    res_norm: Callable = blas1.norm
    parts: int = 1               # parts the vectors hold in this process


def _project_local(V, w):
    # conj(V) w as conj(V conj(w)): no conjugated copy of V
    return (V @ w.conj()).conj()


def make_reductions(axis_name=None, res_norm_type: int = 2) -> ReductionOps:
    """Local reductions, or, where ``axis_name`` is a communicator
    (parallel/comm.py), the mesh-global ones: each part reduces its own
    slice of the vector, then the communicator sums (or takes the max of)
    the per-part partials."""
    if res_norm_type not in (1, 2, 3):
        raise ValueError(
            f"res_norm must be 1 (L1), 2 (L2) or 3 (L-infinity), got "
            f"{res_norm_type!r}")
    if axis_name is None:
        local = {1: blas1.asum, 2: blas1.norm, 3: blas1.amax_value}
        return ReductionOps(
            blas1.dot, blas1.dot_nonconj, blas1.norm, blas1.reduce_sum,
            _project_local, local[res_norm_type],
        )
    if isinstance(axis_name, str):
        raise TypeError("axis_name must be a communicator of "
                        "rocalution_tpu_torch.parallel.comm, not a mesh "
                        "axis name")
    comm = axis_name
    Pl = comm.local

    def parts(x):
        return x.reshape(Pl, -1)

    def pdot(x, y):
        return comm.psum(torch.linalg.vecdot(parts(x), parts(y)))

    def pdot_nc(x, y):
        return comm.psum(torch.sum(parts(x) * parts(y), dim=1))

    def pnorm(x):
        xp = parts(x)
        return torch.sqrt(comm.psum(torch.real(torch.linalg.vecdot(xp, xp))))

    def psum(x):
        return comm.psum(torch.sum(parts(x), dim=1))

    def pproject(V, w):
        Vp = V.reshape(V.shape[0], Pl, -1).transpose(0, 1)      # (Pl, k, nl)
        part = torch.bmm(Vp.conj(), parts(w).unsqueeze(-1))[..., 0]
        return comm.psum(part)

    def pasum(x):
        return comm.psum(torch.sum(torch.abs(parts(x)), dim=1))

    def pamax(x):
        return comm.pmax(torch.amax(torch.abs(parts(x)), dim=1))

    pres = {1: pasum, 2: pnorm, 3: pamax}[res_norm_type]
    return ReductionOps(pdot, pdot_nc, pnorm, psum, pproject, pres, Pl)


def select_tree(pred, on_true, on_false):
    """Elementwise select over (nested) tuples of tensors."""
    if isinstance(on_true, tuple):
        vals = [select_tree(pred, a, b) for a, b in zip(on_true, on_false)]
        return type(on_true)(*vals) if hasattr(on_true, "_fields") \
            else tuple(vals)
    return torch.where(pred, on_true, on_false)


def guarded_check(ctrl, state, res):
    """check_residual only while running: lets solvers with several checks
    in one step (BiCGStab(l), IDR(s), QMRCGStab) freeze the state after
    the first criterion hit, within the step."""
    new = ctrl.check_residual(state, res)
    return select_tree(state.running, new, state)


def run_chunked(body: Callable, carry: Tuple, check_every: int) -> Tuple:
    """Run `body(carry) -> carry` while `carry[-1].running` holds: chunks
    of `check_every` masked steps, one host read of `running` per chunk."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    while bool(carry[-1].running):
        for _ in range(check_every):
            carry = select_tree(carry[-1].running, body(carry), carry)
    return carry


def safe_div(num, den):
    """num/den with 0/0 -> 0 (guards terminal-iteration breakdowns that would
    otherwise poison a masked lane with NaN)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def identity_precond(r):
    return r


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.zeros((), dtype=dtype).real.dtype


def host_normal(n: int, cols: int, seed: int) -> torch.Tensor:
    """An (n, cols) standard normal draw in f64 on the host, from
    torch.Generator().manual_seed(seed): the same numbers whatever device
    the solve runs on. The JAX package draws with jax.random, whose
    numbers torch cannot reproduce; a test hands the port JAX's draw."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n, cols), generator=gen, dtype=torch.float64)


def operator_device(A) -> torch.device:
    """Device of a matrix operand; the default device for callables."""
    if isinstance(A, MatrixBase):
        return A.device
    return default_device()


def prepare(A, b, x0, M, ctrl: Optional[IterationControl], kwargs) -> Tuple:
    """Normalize solver inputs: operator closure, rhs, initial guess,
    preconditioner closure, iteration control, reduction ops."""
    axis_name = kwargs.pop("axis_name", None)
    # SetResidualNorm analog: 1=L1, 2=L2 (default), 3=L-infinity
    res_norm_type = int(kwargs.pop("res_norm", 2))
    log_debug(A, "solve", getattr(b, "shape", None), axis_name, kwargs)
    op = as_operator(A)
    device = operator_device(A)
    b = torch.as_tensor(b, device=device)
    if get_config().debug:
        if isinstance(A, MatrixBase):
            validate.check_matrix(A)
        validate.check_vector(b, "rhs")
    x = (torch.zeros_like(b) if x0 is None
         else torch.as_tensor(x0, dtype=b.dtype, device=device))
    precond = identity_precond if M is None else as_operator(M)
    if ctrl is None:
        ctrl = IterationControl(**kwargs)
    elif kwargs:
        raise ValueError("pass either ctrl= or tolerance kwargs, not both")
    red = make_reductions(axis_name, res_norm_type)
    return op, b, x, precond, ctrl, red
