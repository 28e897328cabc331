"""Mixed-precision defect correction sample (reference:
clients/samples/mixed-precision.cpp): f64 outer DC around an f32 inner
CG. Port of clients/samples/mixed_precision.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(64)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))

x, info = rt.mixed_precision_dc(A, b, rel_tol=1e-10, max_iter=50)
print(f"MPDC: outer_iters={int(info.iterations)} "
      f"final_res={float(info.final_res):.3e} "
      f"dtype={x.cpu().numpy().dtype}")
print("error:", float(torch.linalg.norm(x - 1.0)))
