"""Complex-valued solve sample (reference: clients/samples/complex.cpp).
Port of clients/samples/complex_solve.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np
import torch

import rocalution_tpu_torch as rt

rng = np.random.default_rng(0)
n = 200
B = rng.standard_normal((n, n))
S = B @ B.T + n * np.eye(n)
T = 0.05 * (lambda C: C + C.T)(rng.standard_normal((n, n)))
H = S + 1j * T                       # complex symmetric
A = rt.CSR.from_dense(H)
x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
b = torch.from_numpy(H @ x_true).to(A.device)

x, info = rt.cg(A, b, rel_tol=1e-12, max_iter=1000)
err = np.linalg.norm(x.cpu().numpy() - x_true) / np.linalg.norm(x_true)
print(f"complex-symmetric CG: iters={int(info.iterations)} relerr={err:.2e}")
