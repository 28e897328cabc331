"""Iterative triangular solve sample (reference:
clients/samples/itsolve.cpp): ILU(0) applied with Jacobi-sweep iterative
tri-solves (TriSolverAlg_Iterative / csritsv analog) vs level-scheduled.
Port of clients/samples/itsolve.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(48)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
for method in ("levels", "jacobi"):
    M = rt.precond.ilu(A, 0, method=method, sweeps=10)
    x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=2000)
    print(f"cg+ilu0[{method:6s}]: iters={int(info.iterations)} "
          f"status={int(info.status)} "
          f"err={float(torch.linalg.norm(x - 1)):.2e}")
