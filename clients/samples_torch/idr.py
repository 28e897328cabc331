"""IDR(s) sample (reference: clients/samples/idr.cpp). Port of
clients/samples/idr.py; the shadow space is the port's own seeded host
draw (solvers/krylov/idr.py)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.convection_diffusion_2d(40)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
for s in (1, 2, 4):
    x, info = rt.idr(A, b, M=rt.jacobi(A), shadow_space=s,
                     rel_tol=1e-8, max_iter=4000)
    print(f"idr({s})+jacobi: iters={int(info.iterations)} "
          f"status={int(info.status)} "
          f"err={float(torch.linalg.norm(x - 1)):.2e}")
