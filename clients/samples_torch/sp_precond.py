"""Saddle-point preconditioner sample (reference:
clients/samples/sp-precond.cpp): K = [A B; B^T 0] solved with the
diagonal-Jacobi saddle-point transform preconditioner. Port of
clients/samples/sp_precond.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np
import scipy.sparse as sp
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.precond import saddle_point_precond

rng = np.random.default_rng(7)
m, k = 256, 64
A11 = sp.random(m, m, density=0.03, random_state=7)
A11 = (A11 + A11.T + 4 * m * sp.eye(m)).tocsr()      # SPD block
B = sp.random(m, k, density=0.08, random_state=8).tocsr()
K = sp.bmat([[A11, B], [B.T, None]], format="coo")
Kc = rt.CSR.from_coo(K.row, K.col, K.data, K.shape)

xs = torch.from_numpy(rng.standard_normal(m + k)).to(Kc.device)
b = rt.spmv(Kc, xs)
M = saddle_point_precond(Kc, m)
x, info = rt.gmres(Kc, b, M=M, basis_size=40, rel_tol=1e-8, max_iter=4000)
print(f"gmres+saddle-point: iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - xs)):.2e}")
