"""Matrix-free stencil sample (reference: clients/samples/stencil.cpp).
Port of clients/samples/stencil.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

st = rt.laplace2d_stencil(100)
print(f"stencil: grid={st.grid} ndim={st.ndim} n={st.shape[0]}")
b = rt.spmv(st, torch.ones(st.shape[0], dtype=st.dtype, device=st.device))
x, info = rt.cg(st, b, rel_tol=1e-8, max_iter=2000)
print(f"CG on stencil: iters={int(info.iterations)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
