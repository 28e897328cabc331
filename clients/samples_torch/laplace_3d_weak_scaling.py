"""3D weak-scaling driver (reference:
clients/samples/laplace_3d_weak_scaling.cpp): each partition owns a fixed
local_n^3 slab of a global 7-point Laplacian stacked along z; rows per
part stay constant as partitions are added. Reports time per CG iteration
and weak-scaling efficiency. Port of
clients/samples/laplace_3d_weak_scaling.py: the parts live in this
process on the default device (`make_comm` in place of the mesh).
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

local_n = int(sys.argv[1]) if len(sys.argv) > 1 else 16   # local cube side
max_parts = 8


def laplace_3d_slab(nx, ny, nz):
    def lap1d(n):
        return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                        [-1, 0, 1])

    Ix, Iy, Iz = sp.eye(nx), sp.eye(ny), sp.eye(nz)
    return (sp.kron(Iz, sp.kron(Iy, lap1d(nx)))
            + sp.kron(Iz, sp.kron(lap1d(ny), Ix))
            + sp.kron(lap1d(nz), sp.kron(Iy, Ix))).tocoo()


base_time = None
for nparts in [p for p in (1, 2, 4, 8) if p <= max_parts]:
    S = laplace_3d_slab(local_n, local_n, local_n * nparts)
    A = rt.CSR.from_coo(S.row, S.col, S.data, S.shape)
    b = rt.spmv(A, A.data.new_ones(S.shape[0]))

    Ag = distribute_csr(A, nparts)
    M = block_jacobi_diag(Ag)
    t0 = time.perf_counter()
    x, info = dist_solve(rt.cg, Ag, b, M=M, comm=make_comm(nparts),
                         rel_tol=0.0, abs_tol=0.0, max_iter=50)
    x.cpu()
    dt = (time.perf_counter() - t0) / max(int(info.iterations), 1)
    if base_time is None:
        base_time = dt
    eff = base_time / dt
    print(f"parts={nparts} n={S.shape[0]:8d} nnz={S.nnz:9d} "
          f"t/iter={dt*1e3:7.2f}ms weak-eff={eff:5.2f} mode={Ag.mode}")
