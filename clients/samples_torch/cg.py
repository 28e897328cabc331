"""CG sample (reference: clients/samples/cg.cpp).

Reads a MatrixMarket file (or builds a gr_30_30-scale 2D Laplacian),
solves A x = b with Jacobi-preconditioned CG, reports
iterations/residual/timing. Port of clients/samples/cg.py.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np
import torch

import rocalution_tpu_torch as rt


def main():
    if len(sys.argv) > 1:
        A = rt.io.read_mtx(sys.argv[1])
        print(f"read {sys.argv[1]}: n={A.shape[0]} nnz={A.nnz}")
    else:
        A = rt.laplacian_2d(30)      # gr_30_30 scale (reference README.md)
    ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    b = rt.spmv(A, ones)

    M = rt.jacobi(A)
    t0 = time.perf_counter()
    x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=5000,
                    record_history=True)
    x = x.cpu()
    dt = time.perf_counter() - t0

    hist = info.history.cpu().numpy()
    hist = hist[~np.isnan(hist)]
    print(f"iters={int(info.iterations)} status={int(info.status)} "
          f"final_res={float(info.final_res):.3e} time={dt*1e3:.1f}ms")
    print("residual history (first 5):", [f"{h:.3e}" for h in hist[:5]])
    print("error:", float(torch.linalg.norm(x - ones.cpu())))


if __name__ == "__main__":
    main()
