"""Benchmark sample (reference: clients/samples/benchmark.cpp): per-op
bandwidth sweep over BLAS-1 and per-format SpMV with the reference byte
models. Port of clients/samples/benchmark.py: each op runs REPS times in a
loop, timed by CUDA events on the card (the host clock on the CPU, and
the first line says which)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import torch

import rocalution_tpu_torch as rt

n = 1 << 20
reps = 100
dev = rt.config.default_device()
x = torch.from_numpy(np.random.default_rng(0).standard_normal(n) / n).to(dev)
y = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(dev)


def per_op_s(step, v):
    """Seconds per step over reps steps, after two warm-up steps."""
    for _ in range(2):
        v = step(v)
    if v.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            v = step(v)
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) / 1e3 / reps, 1e-12)
    t0 = time.perf_counter()
    for _ in range(reps):
        v = step(v)
    float(v.sum())
    return max((time.perf_counter() - t0) / reps, 1e-12)


print(f"device={dev} clock={'CUDA events' if dev.type == 'cuda' else 'host'}")
fs = x.element_size()
t = per_op_s(lambda c: c + 1e-6 * y, x)
print(f"axpy    {3*n*fs/t/1e9:8.1f} GB/s  {2*n/t/1e9:8.1f} GFlop/s")
t = per_op_s(lambda c: c + (1e-12 * torch.dot(c, y)) * y, x)
print(f"dot     {2*n*fs/t/1e9:8.1f} GB/s  {2*n/t/1e9:8.1f} GFlop/s")

A = rt.laplacian_3d(48)
xv = torch.from_numpy(
    np.random.default_rng(2).standard_normal(A.shape[0]) / A.shape[0]
).to(device=A.device, dtype=A.dtype)
for fmt in ("DIA", "ELL", "HYB"):
    B = rt.convert(A, fmt)
    t = per_op_s(lambda c, B=B: rt.spmv(B, c) * (1 / 8.0), xv)
    gbs = (fs + 4) * A.nnz / t / 1e9
    print(f"spmv[{fmt:4s}] {gbs:8.1f} GB/s  {2*A.nnz/t/1e9:8.1f} GFlop/s")
