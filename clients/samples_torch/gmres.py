"""GMRES sample (reference: clients/samples/gmres.cpp): restarted
GMRES(30) with ILU(0) on a nonsymmetric convection-diffusion system. Port
of clients/samples/gmres.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.convection_diffusion_2d(48)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
M = rt.precond.ilu(A, 0)
x, info = rt.gmres(A, b, M=M, basis_size=30, rel_tol=1e-8, max_iter=2000)
print(f"gmres(30)+ilu0: iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
