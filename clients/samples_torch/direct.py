"""Dense direct solver sample (reference: clients/samples/direct.cpp):
LU / QR / explicit inversion on a small dense system. Port of
clients/samples/direct.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.direct import inversion, lu, qr

A = rt.laplacian_2d(12)          # 144x144, solved densely
ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
b = rt.spmv(A, ones)
for name, solver in (("lu", lu), ("qr", qr), ("inversion", inversion)):
    x, info = solver(A, b)
    print(f"{name:9s} err={float(torch.linalg.norm(x - 1)):.2e} "
          f"status={int(info.status)}")
