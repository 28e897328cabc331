"""Weak-scaling driver (reference:
clients/samples/laplace_2d_weak_scaling.cpp): per-partition problem size
stays constant as partitions are added; reports time per CG iteration and
weak-scaling efficiency. Port of clients/samples/laplace_2d_weak_scaling.py:
the parts live in this process on the default device (`make_comm` in
place of the mesh).
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import scipy.sparse as sp

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (block_jacobi_diag, dist_solve,
                                           distribute_csr, make_comm)

local_n = int(sys.argv[1]) if len(sys.argv) > 1 else 64  # grid side per part
max_parts = 8

base_time = None
for nparts in [p for p in (1, 2, 4, 8) if p <= max_parts]:
    # global grid grows with partitions: rows scale linearly
    ny = local_n * nparts
    I = sp.eye(local_n)
    L = sp.diags([-np.ones(local_n - 1), 2 * np.ones(local_n),
                  -np.ones(local_n - 1)], [-1, 0, 1])
    Iy = sp.eye(ny)
    Ly = sp.diags([-np.ones(ny - 1), 2 * np.ones(ny),
                   -np.ones(ny - 1)], [-1, 0, 1])
    S = (sp.kron(Iy, L) + sp.kron(Ly, I)).tocsr().tocoo()
    Ag_csr = rt.CSR.from_coo(S.row, S.col, S.data, S.shape)
    b = rt.spmv(Ag_csr, Ag_csr.data.new_ones(S.shape[0]))

    Ag = distribute_csr(Ag_csr, nparts)
    M = block_jacobi_diag(Ag)
    # fixed iteration budget: measure time/iteration, not convergence
    t0 = time.perf_counter()
    x, info = dist_solve(rt.cg, Ag, b, M=M, comm=make_comm(nparts),
                         rel_tol=0.0, abs_tol=0.0, max_iter=50)
    x.cpu()
    dt = (time.perf_counter() - t0) / max(int(info.iterations), 1)
    if base_time is None:
        base_time = dt
    eff = base_time / dt
    print(f"parts={nparts} n={S.shape[0]:8d} t/iter={dt*1e3:7.2f}ms "
          f"weak-eff={eff:5.2f}")
