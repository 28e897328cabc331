"""Multi-elimination ILU sample (reference:
clients/samples/me-preconditioner.cpp). Port of
clients/samples/me_preconditioner.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.precond import multi_elimination

A = rt.laplacian_2d(40)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
M = multi_elimination(A, levels=3, drop_tol=1e-3)
x, info = rt.fgmres(A, b, M=M, rel_tol=1e-8, max_iter=2000)
print(f"FGMRES+ME(3): iters={int(info.iterations)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
