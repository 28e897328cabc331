"""Flexible GMRES sample (reference: clients/samples/fgmres.cpp) whose
preconditioner is itself an iterative solver. Port of
clients/samples/fgmres.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.convection_diffusion_2d(48)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)

# "any solver preconditions any solver" (reference README.md:76-80):
# the preconditioner is itself an iterative solver, 4 Jacobi-smoothed
# fixed-point sweeps on A z = r
inv_d = rt.jacobi(A)
M = lambda r: rt.fixed_point_sweeps(A, r, torch.zeros_like(r),  # noqa: E731
                                    M=inv_d, sweeps=4, omega=0.8)
x, info = rt.fgmres(A, b, M=M, basis_size=30, rel_tol=1e-8, max_iter=2000)
print(f"fgmres(30)+jacobi-sweeps: iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
