"""Simple SpMV sample (reference: clients/samples/simple-spmv.cpp):
build a matrix, convert formats, apply, compare. Port of
clients/samples/simple_spmv.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np
import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(40)
x = torch.from_numpy(np.random.default_rng(0).standard_normal(
    A.shape[0])).to(A.device)
y_ref = rt.spmv(A, x)
for fmt in ("COO", "ELL", "DIA", "HYB", "BCSR", "MCSR"):
    B = rt.convert(A, fmt)
    err = float(torch.linalg.norm(rt.spmv(B, x) - y_ref))
    print(f"{fmt:5s} n={A.shape[0]} nnz={A.nnz}  |y - y_csr| = {err:.2e}")
