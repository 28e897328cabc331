"""CG + Ruge-Stueben AMG sample (reference: clients/samples/cg-rsamg.cpp):
PMIS/greedy coarsening x direct/ext+i interpolation. Port of
clients/samples/cg_rsamg.py."""

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
for coarsening in ("pmis", "greedy"):
    for interp in ("direct", "extpi"):
        M = amg_precond(A, "rs", coarse_size=200,
                        coarsening=coarsening, interpolation=interp)
        x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=200)
        print(f"cg+rsamg[{coarsening}/{interp}]: "
              f"iters={int(info.iterations)} status={int(info.status)} "
              f"err={float(torch.linalg.norm(x - 1)):.2e}")
