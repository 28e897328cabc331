"""Additive Schwarz sample (reference: clients/samples/as-precond.cpp):
AS and restricted AS preconditioned CG. Port of
clients/samples/as_precond.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.precond import additive_schwarz

A = rt.laplacian_2d(48)
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
for restricted in (False, True):
    M = additive_schwarz(A, num_blocks=4, overlap=8, restricted=restricted)
    x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=2000)
    kind = "ras" if restricted else "as"
    print(f"cg+{kind}: iters={int(info.iterations)} "
          f"status={int(info.status)} "
          f"err={float(torch.linalg.norm(x - 1)):.2e}")
