"""Distributed algebraic multigrid over a host-built hierarchy.

Counterpart of rocalution_tpu/parallel/amg.py (reference: the Global
instantiation of BaseAMG/BaseMultiGrid, base_amg.cpp:449-456): the
hierarchy is built once on the host from the global matrix
(solvers/multigrid), then every level's operator and transfer is
row-partitioned into a GlobalCSR, the coarsest included, which the cycle
solves with a fixed number of Jacobi-CG steps. For a hierarchy built from
per-part data (no global matrix), see parallel/amg_setup.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..formats.base import to_device
from ..solvers.multigrid import Hierarchy, amg_hierarchy
from .amg_setup import DistLevels, dist_cycle_closure
from .comm import StackedComm
from .ops import shard_operator
from .partition import (GlobalCSR, distribute_csr, distribute_vector,
                        gather_vector)


class DistMG(NamedTuple):
    """Distributed hierarchy operands."""

    As: Tuple[GlobalCSR, ...]      # operators per level incl. the coarsest
    Ps: Tuple[GlobalCSR, ...]      # prolongations (fine rows, coarse cols)
    Rs: Tuple[GlobalCSR, ...]      # restrictions (coarse rows, fine cols)
    inv_diags: Tuple[torch.Tensor, ...]   # (P, nl) per level incl. coarsest


def _stacked_inv_diag(A, nparts: int, nl: int, device) -> torch.Tensor:
    d, i, p = A.numpy_triplet()
    rows = A.numpy_rows()
    diag = np.zeros(A.shape[0], d.dtype)
    np.add.at(diag, rows[i == rows], d[i == rows])
    dpad = np.ones(nparts * nl, d.dtype)
    dpad[: len(diag)] = np.where(diag != 0, diag, 1.0)
    return to_device((1.0 / dpad).reshape(nparts, nl), device)


def distribute_hierarchy(h: Hierarchy, nparts: int,
                         device=None) -> DistMG:
    """Partition a host-built hierarchy over `nparts` parts, on ``device``
    (default: the fine operator's). Every level takes the auto rule for
    its plans (`partition.plans_interiors`), its transfers too, as
    `distribute_csr` does in the JAX package."""
    device = h.levels[0].A.device if device is None else device
    As, Ps, Rs, invds = [], [], [], []
    for lv in h.levels[:-1]:
        Ag = distribute_csr(lv.A, nparts, device=device)
        As.append(Ag)
        Ps.append(distribute_csr(lv.P, nparts, device=device))
        Rs.append(distribute_csr(lv.R, nparts, device=device))
        invds.append(_stacked_inv_diag(lv.A, nparts, Ag.n_local, device))
    Ac = h.levels[-1].A
    Acg = distribute_csr(Ac, nparts, device=device)
    As.append(Acg)
    invds.append(_stacked_inv_diag(Ac, nparts, Acg.n_local, device))
    return DistMG(tuple(As), tuple(Ps), tuple(Rs), tuple(invds))


def _dist_cycle(dh: DistMG, comm, *, coarse_iters: int = 24) -> Callable:
    """V-cycle closure over flat vectors of this process's parts, the
    coarsest solve `coarse_iters` fixed Jacobi-CG steps on the sharded
    coarse operator: `dist_cycle_closure` over the same levels."""
    return dist_cycle_closure(
        DistLevels(dh.As, dh.Ps, dh.Rs, dh.inv_diags[:-1],
                   dh.inv_diags[-1]), comm, coarse_iters=coarse_iters)


def dist_amg_solve(solver: Callable, A, b, nparts: int, *, comm=None,
                   kind: str = "sa", hierarchy: Optional[Hierarchy] = None,
                   amg_kwargs: Optional[dict] = None, **solver_kwargs):
    """AMG-preconditioned solve: the hierarchy built on the host from the
    global CSR `A`, the solve over `nparts` parts (the reference's
    cg-amg_mpi flow). Returns the global x and the info."""
    h = hierarchy or amg_hierarchy(A, kind, **(amg_kwargs or {}))
    if h.num_levels < 2:
        raise ValueError(
            "dist_amg_solve: hierarchy has a single level (matrix already "
            "at/below coarse_size, so no coarse grids were built): use "
            "dist_solve with a block_jacobi preconditioner instead")
    dh = distribute_hierarchy(h, nparts)
    Ag = dh.As[0]
    comm = StackedComm(nparts) if comm is None else comm
    bp = distribute_vector(b, nparts, Ag.n_local, device=Ag.device)
    x, info = solver(shard_operator(Ag, comm), bp.reshape(-1), None,
                     _dist_cycle(dh, comm), axis_name=comm, **solver_kwargs)
    return gather_vector(x.reshape(Ag.local_parts, -1), Ag.n_global), info
