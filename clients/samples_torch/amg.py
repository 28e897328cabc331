"""Geometric multigrid with a user-supplied hierarchy (reference:
clients/samples/amg.cpp: MultiGrid with SetOperatorHierarchy /
SetRestrictOperator / SetProlongOperator): nested 2D grids with full
weighting restriction / bilinear prolongation built explicitly.
Port of clients/samples/amg.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import scipy.sparse as sp
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.multigrid.base import (build_hierarchy,
                                                         mg_solve)


def bilinear_p(nc: int):
    """Prolongation from an nc x nc grid to a (2nc+1) x (2nc+1) grid."""
    nf = 2 * nc + 1
    rows, cols, vals = [], [], []
    for jc in range(nc):
        for ic in range(nc):
            coarse = jc * nc + ic
            fi, fj = 2 * ic + 1, 2 * jc + 1
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    w = (1.0 if (di, dj) == (0, 0)
                         else 0.5 if di == 0 or dj == 0 else 0.25)
                    rows.append((fj + dj) * nf + (fi + di))
                    cols.append(coarse)
                    vals.append(w)
    return sp.csr_matrix((vals, (rows, cols)), shape=(nf * nf, nc * nc))


def to_sp(M):
    d, i, p = M.numpy_triplet()
    return sp.csr_matrix((d, i, p), shape=M.shape)


def to_rt(S):
    S = S.tocsr()
    return rt.CSR.from_arrays(S.data, S.indices, S.indptr, S.shape)


levels = [63, 31, 15, 7]          # nested grids (2n+1 refinement)
A0 = rt.laplacian_2d(levels[0])
ops, prolongs, restricts = [A0], [], []
Ak = to_sp(A0)
for k in range(len(levels) - 1):
    P = bilinear_p(levels[k + 1])
    R = (0.25 * P.T).tocsr()      # full weighting = scaled transpose
    Ak = (R @ Ak @ P).tocsr()     # user-supplied Galerkin coarse operator
    prolongs.append(to_rt(P))
    restricts.append(to_rt(R))
    ops.append(to_rt(Ak))

h = build_hierarchy(ops, prolongs, restricts, cycle="V")
A = ops[0]
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
x, info = mg_solve(h, b, rel_tol=1e-8, max_iter=100)
print(f"geometric-mg: levels={h.num_levels} iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
