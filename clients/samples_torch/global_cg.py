"""Distributed CG over parts of one operator (reference:
clients/samples/cg_mpi.cpp). Port of clients/samples/global_cg.py: the 8
parts live in this process on the default device (`make_comm` in place
of the mesh)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (block_jacobi_diag, dist_solve,
                                           distribute_csr, make_comm)

nparts = 8
print(f"device: {rt.config.default_device()} -> {nparts} partitions")

A = rt.laplacian_2d(64)
x_true = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, x_true)

Ag = distribute_csr(A, nparts)
comm = make_comm(nparts)
M = block_jacobi_diag(Ag)
x, info = dist_solve(rt.cg, Ag, b, M=M, comm=comm, rel_tol=1e-8,
                     max_iter=2000)
print(f"distributed CG: iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
