"""Large-scale SA-AMG preconditioned CG on the 3D Poisson problem.

The BASELINE north-star scale demo (3D Poisson up to 256^3): builds the
smoothed-aggregation hierarchy on the host (SpGEMM Galerkin,
ops/spgemm.py), converts it to an f32 device hierarchy, and runs the
preconditioned CG solve on the device. Port of
clients/samples/poisson3d_large.py: one warm-up solve, then the timed
solve, by CUDA events on the card (the host clock on the CPU).

POISSON_N=128 python clients/samples_torch/poisson3d_large.py   # 2.1M unknowns
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.solvers.multigrid import (amg_hierarchy,
                                                    convert_hierarchy,
                                                    cycle_closure)

n = int(os.environ.get("POISSON_N", "64"))
A = rt.laplacian_3d(n, dtype=np.float64)
N = A.shape[0]
print(f"3D Poisson {n}^3: N={N} nnz={A.nnz}")

t0 = time.perf_counter()
hier = amg_hierarchy(A, "sa", coarse_size=1000)
t_setup = time.perf_counter() - t0
print(f"setup: {t_setup:.1f}s levels={hier.operator_sizes()}")

hier = convert_hierarchy(hier, dtype=np.float32)
M = cycle_closure(hier)
# b = A @ 1 computed host-side (the fine f64 operator is never applied)
d, i, p = A.numpy_triplet()
# row sums via bincount over row ids (reduceat mis-handles empty rows)
row_ids = np.repeat(np.arange(A.shape[0]), np.diff(p))
b = np.bincount(row_ids, weights=d, minlength=A.shape[0]).astype(np.float32)
A0 = M.hierarchy.levels[0].A
b = torch.from_numpy(b).to(A0.device)


def solve():
    xs, info = rt.cg(A0, b, M=M, rel_tol=1e-6, max_iter=200)
    return xs, info.iterations, info.final_res


solve()                                  # warm-up: plans, first launches
if b.is_cuda:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xs, it, res = solve()
    end.record()
    end.synchronize()
    t_solve = start.elapsed_time(end) / 1e3
else:
    t0 = time.perf_counter()
    xs, it, res = solve()
    xs = xs.cpu()
    t_solve = time.perf_counter() - t0
err = float(torch.linalg.norm(xs.double() - 1.0)) / np.sqrt(N)
print(f"cg+saamg {n}^3: iters={int(it)} res={float(res):.2e} "
      f"rms_err={err:.2e} solve={t_solve*1e3:.0f} ms setup={t_setup:.1f}s")
assert err < 1e-4
