"""Distributed CG + AMG where the HIERARCHY itself is built from
per-part row blocks (reference: clients/samples/cg-amg_mpi.cpp + the
boundary-row exchange setup, global_matrix.cpp:1444-1495): per-part local
generation, distributed SA setup, iterative coarse solve over the parts.
Port of clients/samples/global_cg_amg.py (`make_comm` in place of the
mesh)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (dist_amg_solve_sharded,
                                           distributed_amg_setup, make_comm)
from rocalution_tpu_torch.parallel.amg_setup import _offsets
from rocalution_tpu_torch.utils.generators import laplacian_2d_block

nparts = 8
n = 128
N = n * n
offs = _offsets(nparts, N)
# each "rank" builds only its own rows: the global matrix never exists
blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
          for q in range(nparts)]
dl = distributed_amg_setup(blocks, (N, N), coarse_size=200, wjd=False)
print(f"dist hierarchy: levels={len(dl.As)} "
      f"sizes={[a.n_global for a in dl.As]} mode={dl.As[0].mode}")
b = np.zeros(N)
for q, (r, c, d) in enumerate(blocks):
    np.add.at(b, r + int(offs[q]), d)
x, info = dist_amg_solve_sharded(
    rt.solvers.cg, dl, b, comm=make_comm(nparts), rel_tol=1e-8,
    max_iter=100)
print(f"global cg+dist-amg: iters={int(info.iterations)} "
      f"status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
