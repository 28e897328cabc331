"""Fixed-point iteration sample (reference: clients/samples/
fixed-point.cpp) with Jacobi. Port of clients/samples/fixed_point.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(32)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
x, info = rt.fixed_point(A, b, M=rt.jacobi(A), omega=1.0,
                         rel_tol=1e-6, max_iter=20000)
print(f"fixed-point(jacobi): iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
