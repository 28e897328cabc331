"""Distributed Krylov family with BlockJacobi + local sub-preconditioners.
Covers the reference's remaining preconditioned MPI samples in one driver
(each was one solver x one local preconditioner on the rank's diagonal
block via BlockJacobi, preconditioner_blockjacobi.hpp). Port of
clients/samples/global_krylov.py (`make_comm` in place of the mesh)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (block_jacobi_precond, dist_solve,
                                           distribute_csr, make_comm)

nparts = 8
print(f"device: {rt.config.default_device()} -> {nparts} partitions")

A = rt.laplacian_2d(48)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
Ag = distribute_csr(A, nparts)
comm = make_comm(nparts)

RUNS = [
    ("bicgstab + BJ(ilu0)", rt.bicgstab, "ilu0", {}),
    ("fcg       + BJ(ilu0)", rt.fcg, "ilu0", {}),
    ("fgmres    + BJ(spai)", rt.fgmres, "spai", {}),
    ("idr(4)    + BJ(fsai)", rt.idr, "fsai", {"shadow_space": 4}),
    ("qmrcgstab + BJ(ilut)", rt.qmrcgstab, "ilut", {}),
]

for name, solver, kind, kw in RUNS:
    M = block_jacobi_precond(Ag, kind)
    x, info = dist_solve(solver, Ag, b, M=M, comm=comm, rel_tol=1e-8,
                         max_iter=2000, **kw)
    err = float(torch.linalg.norm(x - 1.0))
    print(f"{name}: iters={int(info.iterations)} "
          f"status={int(info.status)} err={err:.2e}")
