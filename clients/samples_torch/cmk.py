"""CMK/RCMK reordering sample (reference: clients/samples/cmk.cpp). Port
of clients/samples/cmk.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.ops import ordering

A = rt.utils.generators.random_spd(300, density=0.02, seed=11)
d, i, p = A.numpy_triplet()
rows = A.numpy_rows()
bw0 = int(np.max(np.abs(rows - i)))
perm = ordering.rcmk(A)
Ap = ordering.permute_csr(A, perm)
dp, ip, pp = Ap.numpy_triplet()
bw1 = int(np.max(np.abs(Ap.numpy_rows() - ip)))
print(f"bandwidth: original={bw0} RCMK={bw1}")

bp = rt.spmv(Ap, torch.ones(A.shape[0], dtype=Ap.dtype, device=Ap.device))
x, info = rt.cg(Ap, bp, rel_tol=1e-8, max_iter=5000)
print(f"CG on reordered system: iters={int(info.iterations)} "
      f"status={int(info.status)}")
