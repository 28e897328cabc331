"""Shared helpers for Krylov solvers.

Counterpart of rocalution_tpu/solvers/krylov/_common.py, local reductions
only. PyTorch has no device `while_loop`, so `run_chunked` runs a solver
body in chunks of `check_every` steps: each step keeps its new carry only
where `running` holds (`select_tree`), and the host reads `running` once
per chunk. Iteration counts, statuses and histories therefore do not
depend on `check_every`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...config import default_device
from ...formats import MatrixBase
from ...ops import blas1
from ...ops.spmv import as_operator
from ..iter_ctrl import IterationControl


class ReductionOps(NamedTuple):
    """Inner products/norms. `res_norm` is the convergence-check norm
    selected by the user (L1/L2/L-infinity: SetResidualNorm analog,
    solver.hpp:386); algorithmic norms always use `norm` (L2)."""

    dot: Callable
    dot_nonconj: Callable
    norm: Callable
    sum: Callable
    allreduce: Callable          # identity: the reductions are local
    res_norm: Callable = blas1.norm


def make_reductions(axis_name: Optional[str],
                    res_norm_type: int = 2) -> ReductionOps:
    if res_norm_type not in (1, 2, 3):
        raise ValueError(
            f"res_norm must be 1 (L1), 2 (L2) or 3 (L-infinity), got "
            f"{res_norm_type!r}")
    if axis_name is not None:
        raise NotImplementedError(
            "distributed reductions (axis_name) are not ported yet")
    local = {1: blas1.asum, 2: blas1.norm, 3: blas1.amax_value}
    return ReductionOps(
        blas1.dot, blas1.dot_nonconj, blas1.norm, blas1.reduce_sum,
        lambda v: v, local[res_norm_type],
    )


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
    op = as_operator(A)
    device = operator_device(A)
    b = torch.as_tensor(b, device=device)
    x = (torch.zeros_like(b) if x0 is None
         else torch.as_tensor(x0, dtype=b.dtype, device=device))
    precond = identity_precond if M is None else as_operator(M)
    if ctrl is None:
        ctrl = IterationControl(**kwargs)
    elif kwargs:
        raise ValueError("pass either ctrl= or tolerance kwargs, not both")
    red = make_reductions(axis_name, res_norm_type)
    return op, b, x, precond, ctrl, red
