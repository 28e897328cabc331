"""3D Poisson at scale via the DISTRIBUTED setup route: the BASELINE
ladder's 256^3 row (16.78M unknowns).

The fine operator is never assembled globally: each part generates its own
row block (laplacian_3d_block), the SA-AMG hierarchy is built by the
distributed setup (boundary-row exchanges, iterative coarse solve over the
parts, parallel/amg_setup.py), and the solve is CG preconditioned by the
distributed V-cycle. Reference flow: cg-amg_mpi with distribute_matrix
(clients/samples/cg-amg_mpi.cpp + global AMG build,
global_matrix.cpp:4041-4311). Port of clients/samples/poisson3d_dist.py:
the parts live in this process on the default device (`make_comm` in
place of the mesh).

Env knobs:
  POISSON_N   edge size (default 256 -> 16.78M unknowns)
  PARTS       number of parts (default 8)
  DTYPE       float32 (default; memory at this scale) | float64
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (dist_amg_solve_sharded,
                                           distributed_amg_setup, make_comm)
from rocalution_tpu_torch.parallel.amg_setup import _offsets
from rocalution_tpu_torch.solvers.krylov.cg import cg
from rocalution_tpu_torch.utils.generators import laplacian_3d_block

n = int(os.environ.get("POISSON_N", "256"))
P = int(os.environ.get("PARTS", "8"))
dtype = np.dtype(os.environ.get("DTYPE", "float32"))
N = n ** 3
print(f"3D Poisson {n}^3 = {N:,} unknowns, {P} parts, {dtype.name}, "
      f"device={rt.config.default_device()}", flush=True)

offs = _offsets(P, N)
t0 = time.perf_counter()
blocks = [laplacian_3d_block(n, int(offs[q]), int(offs[q + 1]), dtype=dtype)
          for q in range(P)]
nnz = sum(len(b[2]) for b in blocks)
print(f"blocks generated: nnz={nnz:,} ({time.perf_counter()-t0:.1f}s)",
      flush=True)

t0 = time.perf_counter()
dl = distributed_amg_setup(blocks, (N, N), coarse_size=2000,
                           strategy="auto")
t_setup = time.perf_counter() - t0
sizes = [int(A.n_global) for A in dl.As]
print(f"distributed SA-AMG setup: {t_setup:.1f}s, levels={sizes}",
      flush=True)

# b = A @ 1 assembled from the blocks alone
b = np.zeros(N, dtype)
for q, (r, c, d) in enumerate(blocks):
    np.add.at(b, r + int(offs[q]), d)

t0 = time.perf_counter()
x, info = dist_amg_solve_sharded(cg, dl, b, comm=make_comm(P),
                                 rel_tol=1e-6, max_iter=60)
x = x.cpu().numpy()
t_solve = time.perf_counter() - t0
err = float(np.linalg.norm(x - 1.0) / np.sqrt(N))
print(f"CG+distAMG: iters={int(info.iterations)} status={int(info.status)} "
      f"solve={t_solve:.1f}s rms_err={err:.2e}", flush=True)
assert int(info.status) in (1, 2), "did not converge"
assert err < 1e-3
