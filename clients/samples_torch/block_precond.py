"""Block preconditioner sample (reference:
clients/samples/block-precond.cpp). Port of
clients/samples/block_precond.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.ops.extract import extract_submatrices
from rocalution_tpu_torch.precond import block_precond, ilu

A = rt.laplacian_2d(40)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
nb = 4
blocks = extract_submatrices(A, nb)
solvers = [ilu(blocks[i][i]) for i in range(nb)]
M = block_precond(A, nb, solvers, lower=True)
x, info = rt.fgmres(A, b, M=M, rel_tol=1e-8, max_iter=2000)
print(f"FGMRES+BlockPrecond(lower, ILU0 blocks): iters={int(info.iterations)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
