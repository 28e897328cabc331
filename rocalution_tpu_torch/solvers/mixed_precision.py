"""Mixed-precision defect correction.

Counterpart of rocalution_tpu/solvers/mixed_precision.py (reference:
MixedPrecisionDC, src/solvers/mixed_precision.{hpp,cpp}): an outer defect
correction in b's precision around an inner solve in a lower one:
r = b - A x; solve A_low d = cast(r); x += cast(d); repeat
(SolveNonPrecond_, mixed_precision.cpp:369-399). The outer loop runs on
the host, one inner solve a sweep. The build (the cast operator, its WJD
plan on the card) is cached on the operator, so repeated solves pay it
once, as a built reference solver does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import torch_dtype
from ..formats.convert import cast_values
from ..ops.spmv import as_operator
from .iter_ctrl import SolverInfo
from .krylov._common import operator_device
from .krylov.cg import cg


def mixed_precision_dc(
    A,
    b,
    x0=None,
    *,
    inner_solver: Optional[Callable] = None,
    inner_dtype=torch.float32,
    inner_kwargs: Optional[dict] = None,
    abs_tol: float = 1e-15,
    rel_tol: float = 1e-6,
    div_tol: float = 1e8,
    max_iter: int = 50,
):
    """Solve A x = b: outer defect correction in b's dtype (f64 by default),
    inner solves in `inner_dtype` (f32 by default).

    `inner_solver(A_low, r_low, **inner_kwargs) -> (d, info)`: any solver
    of the package; defaults to CG (the reference pairs DC with any inner
    solver through Set(Solver_L)). Returns ``(x, SolverInfo)``; the
    history holds the outer residuals."""
    solver = inner_solver or cg
    inner_dtype = torch_dtype(inner_dtype)
    ikw = dict(inner_kwargs or {})
    ikw.setdefault("rel_tol", 1e-3)
    ikw.setdefault("max_iter", 10000)

    b = torch.as_tensor(b, device=operator_device(A))
    x = (torch.zeros_like(b) if x0 is None
         else torch.as_tensor(x0, dtype=b.dtype, device=b.device))

    # Build/Solve split (reference: MixedPrecisionDC::Build casts and builds
    # once, Solve reuses): the operators are cached on A
    key = (str(inner_dtype), getattr(solver, "__name__", repr(solver)),
           tuple(sorted(ikw.items())), tuple(b.shape), str(b.dtype))
    cache = getattr(A, "_mpdc_cache", None)
    if cache is not None and cache[0] == key:
        op, A_low = cache[1], cache[2]
    else:
        op = as_operator(A)
        # from the host arrays where the format has them, so a CSR copy
        # keeps a host cache and plans without a device read (an ELL, HYB
        # or BCSR copy is read back once, when it is planned)
        A_low = cast_values(A, inner_dtype)
        as_operator(A_low)      # attach the low-precision fast path now
        object.__setattr__(A, "_mpdc_cache", (key, op, A_low))

    r = b - op(x)
    init_res = float(torch.linalg.norm(r))
    res = init_res
    status, it = 0, 0
    history = [init_res]
    while it < max_iter:
        if not np.isfinite(res):
            status = 0
            break
        if res <= abs_tol:
            status = 1
            break
        if res / init_res <= rel_tol:
            status = 2
            break
        if res / init_res >= div_tol:
            status = 3
            break
        d = solver(A_low, r.to(inner_dtype), **ikw)[0]
        x = x + d.to(b.dtype)
        r = b - op(x)
        res = float(torch.linalg.norm(r))
        it += 1
        history.append(res)
    else:
        status = 4

    info = SolverInfo(
        iterations=torch.tensor(it),
        status=torch.tensor(status),
        init_res=torch.tensor(init_res),
        final_res=torch.tensor(res),
        history=torch.tensor(history, dtype=torch.float64),
    )
    return x, info
