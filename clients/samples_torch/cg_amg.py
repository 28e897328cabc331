"""CG preconditioned with one SA-AMG V-cycle (reference:
clients/samples/cg-amg.cpp); also RS/UA/pairwise via argv[1]. Port of
clients/samples/cg_amg.py."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.multigrid import amg_hierarchy, amg_precond

kind = sys.argv[1] if len(sys.argv) > 1 else "sa"
n = int(sys.argv[2]) if len(sys.argv) > 2 else 128

A = rt.laplacian_2d(n)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))

t0 = time.perf_counter()
h = amg_hierarchy(A, kind)
t_setup = time.perf_counter() - t0
print(f"{kind}-AMG hierarchy: levels={h.num_levels} sizes={h.operator_sizes()}"
      f" setup={t_setup*1e3:.0f}ms")

M = amg_precond(h)
t0 = time.perf_counter()
x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=500)
x = x.cpu()
print(f"CG+{kind}AMG: iters={int(info.iterations)} "
      f"res={float(info.final_res):.3e} "
      f"solve={1e3*(time.perf_counter()-t0):.1f}ms "
      f"err={float(torch.linalg.norm(x - 1.0)):.2e}")
