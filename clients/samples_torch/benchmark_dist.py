"""Distributed benchmark sample (reference:
clients/samples/benchmark_mpi.cpp): halo-exchange SpMV and a global
reduction over the parts, per-op timing with the reference byte models.
Port of clients/samples/benchmark_dist.py: the parts live in this
process (`make_comm` in place of the mesh); timed by CUDA events on the
card, the host clock on the CPU."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import torch

import rocalution_tpu_torch as rt
from rocalution_tpu_torch.parallel import (distribute_csr, distribute_vector,
                                           make_comm, shard_spmv)

nparts = 8
A = rt.laplacian_3d(32)
Ag = distribute_csr(A, nparts)
comm = make_comm(nparts)
xg = distribute_vector(
    np.random.default_rng(0).standard_normal(A.shape[0]) / A.shape[0],
    nparts, Ag.n_local, device=Ag.device)


def step(x):
    y = shard_spmv(Ag, x, comm)
    # global dot: the once-per-Krylov-iteration reduction over the parts
    s = comm.psum((y * y).sum(1))
    return y / torch.sqrt(s)


reps = 50
x = step(step(xg))
if x.is_cuda:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        x = step(x)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / reps
else:
    t0 = time.perf_counter()
    for _ in range(reps):
        x = step(x)
    float(x.sum())
    dt = (time.perf_counter() - t0) / reps
dt = max(dt, 1e-12)
vs = Ag.int_data.element_size()
gbs = (vs + 4) * A.nnz / dt / 1e9
print(f"dist spmv+psum-norm over {nparts} parts (mode={Ag.mode}): "
      f"{dt*1e6:.1f} us/op  {gbs:.2f} GB/s aggregate")
