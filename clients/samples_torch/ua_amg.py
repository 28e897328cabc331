"""CG + unsmoothed-aggregation AMG sample (reference:
clients/samples/ua-amg.cpp). Port of clients/samples/ua_amg.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.multigrid import amg_precond

A = rt.laplacian_2d(64)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
M = amg_precond(A, "ua", coarse_size=200, over_interp=1.5)
x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=400)
print(f"cg+uaamg: iters={int(info.iterations)} status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
