"""Distributed IO sample (reference: clients/samples/global-io_mpi.cpp):
write the per-rank triad (matrix parts + ParallelManager descriptor),
read it back, and solve distributed. Port of clients/samples/global_io.py
(`make_comm` in place of the mesh); the files go to a temporary
directory that is removed at the end."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import tempfile

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.io import read_global_csr, write_global_csr
from rocalution_tpu_torch.parallel import (dist_solve, distribute_csr,
                                           make_comm)

nparts = 4
A = rt.laplacian_2d(48)
Ag = distribute_csr(A, nparts)
with tempfile.TemporaryDirectory() as tmp:
    prefix = os.path.join(tmp, "lap48")
    write_global_csr(prefix, Ag)
    print("wrote triad:", prefix + ".{pm.json,matrix.rank.N,pm.rank.N}")
    Ag2 = read_global_csr(prefix)

b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
x, info = dist_solve(rt.cg, Ag2, b, comm=make_comm(nparts),
                     rel_tol=1e-8, max_iter=2000)
print(f"dist cg on read-back matrix: iters={int(info.iterations)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
