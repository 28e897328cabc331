"""Flexible CG sample (reference: clients/samples/fcg.cpp) with an SGS
preconditioner. Port of clients/samples/fcg.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(48)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
M = rt.precond.sgs(A)
x, info = rt.fcg(A, b, M=M, rel_tol=1e-8, max_iter=2000)
print(f"fcg+sgs: iters={int(info.iterations)} status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
