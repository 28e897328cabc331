"""Distributed solves.

Counterpart of rocalution_tpu/parallel/solve.py (reference: the Global
instantiation of every solver, e.g. cg.cpp:459-466: one code path serves
Local and Global operators). The same functional solver runs on this
process's parts end to end, with the halo exchange in its operator
closure and its reductions summed over the parts by the communicator
(``axis_name=comm``, solvers/krylov/_common.py); the iteration state is
the same in every part because every scalar it reads is a `psum`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..formats.base import get_host, to_device
from .comm import StackedComm
from .ops import shard_operator
from .partition import GlobalCSR, distribute_vector, gather_vector


def make_comm(nparts: int) -> StackedComm:
    """All `nparts` parts in this process on one device: the counterpart
    of `make_mesh(nparts)`."""
    return StackedComm(nparts)


def _stacked(v, A: GlobalCSR) -> torch.Tensor:
    """v as this process's parts, (Pl, n_local): a global vector is
    distributed, a 2-D one taken as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 2:
        return v.to(A.device)
    if not isinstance(v, torch.Tensor) and np.ndim(v) == 2:
        return to_device(np.asarray(v), A.device)
    return distribute_vector(v, A.nparts, A.n_local, device=A.device)


def dist_solve(solver: Callable, A: GlobalCSR, b, x0=None, M=None,
               comm=None, **kwargs):
    """Run a functional solver over the parts of `A`.

    `solver` is any of the port's solvers taking (A, b, x0, M, **kwargs)
    (cg, bicgstab, gmres, ...). `M` may be a stacked inverse diagonal
    (P, n_local) (the BlockJacobi/Jacobi global preconditioner), a
    `parallel.precond.ShardPrecond` (BlockJacobi with a local
    sub-preconditioner per diagonal block) or None. `comm` defaults to
    all parts in this process (`make_comm`). Returns the global x and the
    solver's info."""
    from .precond import ShardPrecond

    comm = make_comm(A.nparts) if comm is None else comm
    Pl = A.local_parts
    bp = _stacked(b, A)
    x0p = None if x0 is None else _stacked(x0, A).reshape(-1)
    op = shard_operator(A, comm)
    precond = None
    if isinstance(M, ShardPrecond):
        precond = M.operator(Pl)
    elif M is not None:
        inv = _stacked(M, A).reshape(-1)
        precond = lambda r: inv * r                      # noqa: E731
    x, info = solver(op, bp.reshape(-1), x0p, precond, axis_name=comm,
                     **kwargs)
    return gather_vector(x.reshape(Pl, -1), A.n_global), info


def block_jacobi_diag(A: GlobalCSR) -> torch.Tensor:
    """Stacked inverse diagonal (P, n_local) for BlockJacobi/Jacobi
    preconditioning of a GlobalCSR (reference: the Global Jacobi,
    preconditioner.cpp:1121-1127), from the host arrays."""
    rows = get_host(A, "int_rows")
    is_diag = rows == get_host(A, "int_cols")
    data = get_host(A, "int_data")
    P_, nl = data.shape[0], A.n_local
    diag = np.zeros((P_, nl), dtype=data.dtype)
    for p in range(P_):
        np.add.at(diag[p], rows[p][is_diag[p]], data[p][is_diag[p]])
    inv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 1.0)
    return to_device(inv, A.device)
