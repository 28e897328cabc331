"""Power method sample (reference: clients/samples/power-method.cpp):
dominant eigenvalue + Gershgorin bounds feeding a Chebyshev solve. Port
of clients/samples/power_method.py; the start vector is the port's own
seeded host draw (ops/spectral.py)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(50)
lam, _ = rt.power_method(A, iters=200)
lo, hi = rt.gershgorin(A)
print(f"power-method lambda_max ~= {float(lam):.6f}; "
      f"Gershgorin [{float(lo):.3f}, {float(hi):.3f}]")

b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))
x, info = rt.chebyshev(A, b, lambda_min=max(float(lo), 1e-3),
                       lambda_max=float(lam) * 1.05, rel_tol=1e-7,
                       max_iter=20000)
print(f"chebyshev: iters={int(info.iterations)} status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
