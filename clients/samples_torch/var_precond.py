"""Variable preconditioner sample (reference:
clients/samples/var-precond.cpp). Port of clients/samples/var_precond.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.precond import jacobi, sgs, tns, variable_precond

A = rt.laplacian_2d(40)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
M = variable_precond([jacobi(A), sgs(A), tns(A)])
x, info = rt.fgmres(A, b, M=M, rel_tol=1e-8, max_iter=2000)
print(f"FGMRES+VariablePrecond: iters={int(info.iterations)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
