"""QMRCGStab solve (reference: clients/samples/qmrcgstab_mpi.cpp: the MPI
variant collapsed into this sample; pass --dist to run it over 8 parts).
Port of clients/samples/qmrcgstab.py: with --dist the parts live in this
process on the default device (`make_comm`)."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import torch

import rocalution_tpu_torch as rt

A = rt.convection_diffusion_2d(64)
b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype, device=A.device))

if "--dist" in sys.argv:
    from rocalution_tpu_torch.parallel import (block_jacobi_diag,
                                               dist_solve, distribute_csr,
                                               make_comm)

    nparts = 8
    Ag = distribute_csr(A, nparts)
    x, info = dist_solve(rt.qmrcgstab, Ag, b, M=block_jacobi_diag(Ag),
                         comm=make_comm(nparts), rel_tol=1e-8,
                         max_iter=2000)
    tag = f"qmrcgstab[dist x{nparts}]"
else:
    x, info = rt.qmrcgstab(A, b, M=rt.jacobi(A), rel_tol=1e-8, max_iter=2000)
    tag = "qmrcgstab"
print(f"{tag}: iters={int(info.iterations)} status={int(info.status)} "
      f"err={float(torch.linalg.norm(x - 1)):.2e}")
