"""Standalone smoothed-aggregation AMG solver (reference:
clients/samples/sa-amg.cpp: AMG used as the SOLVER, fixed-point cycling
until tolerance, not as a preconditioner). Port of
clients/samples/sa_amg.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.multigrid import amg_hierarchy, mg_solve

A = rt.laplacian_2d(64)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
h = amg_hierarchy(A, "sa", coarse_size=200)
print(f"sa-amg: levels={h.num_levels} sizes={h.operator_sizes()}")
x, info = mg_solve(h, b, rel_tol=1e-8, max_iter=100)
print(f"sa-amg solve: iters={int(info.iterations)} status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
