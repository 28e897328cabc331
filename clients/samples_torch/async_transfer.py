"""Async build/transfer sample (reference: clients/samples/async.cpp,
Solver::BuildMoveToAcceleratorAsync). Port of
clients/samples/async_transfer.py: CUDA work is queued on the card's
stream and the host goes on; the right-hand side goes up by a
non-blocking copy from pinned host memory, and the host builds a second
preconditioner while the device works. `rt.sync()` (torch.cuda.synchronize
on the card) waits for the device."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import torch

import rocalution_tpu_torch as rt

A = rt.laplacian_2d(128)
d, _, p = A.numpy_triplet()
b_host = torch.from_numpy(np.add.reduceat(d, p[:-1]))      # A @ 1 on the host
if A.device.type == "cuda":
    b_host = b_host.pin_memory()
b = b_host.to(A.device, non_blocking=True)

# queue a full CG solve: the host waits for the device only at the
# solver's convergence checks
t0 = time.perf_counter()
x, info = rt.cg(A, b, M=rt.jacobi(A), rel_tol=1e-8, max_iter=2000)
t_dispatch = time.perf_counter() - t0

# overlap: build a SECOND preconditioner on the host while the last device
# work of the solve is in flight (the reference's
# BuildMoveToAcceleratorAsync overlap)
t0 = time.perf_counter()
M2 = rt.precond.ilu(A, 0)
t_build = time.perf_counter() - t0

rt.sync()
err = float(torch.linalg.norm(x - 1))
print(f"dispatch={t_dispatch*1e3:.1f}ms (async) "
      f"host ILU build overlapped={t_build*1e3:.1f}ms err={err:.2e}")

x2, info2 = rt.cg(A, b, M=M2, rel_tol=1e-8, max_iter=2000)
print(f"cg+ilu0 (built during overlap): iters={int(info2.iterations)} "
      f"err={float(torch.linalg.norm(x2 - 1)):.2e}")
