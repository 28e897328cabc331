"""The plain references against the port's output, at a tiny size on the
CPU."""

import numpy as np
import torch

from bench_h100.operators import fem_parabolic, heat3d_7pt
from bench_h100.reference import cg, checks, csr


def test_reference_cg_is_the_ports_cg_jacobi(port_on_cpu):
    rt = port_on_cpu
    op = heat3d_7pt.build({"grid": 6, "tau": 4.0})
    A = rt.CSR.from_arrays(op["data"], op["indices"], op["indptr"],
                           op["shape"], device="cpu")
    rt.attach_wjd(A)
    Ar = csr.csr_tensor(op, "cpu")
    b = csr.apply(Ar, torch.ones(216, dtype=torch.float64))
    x0 = torch.rand(216, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5)) * 2 - 1
    kept = x0.clone()
    x, info = rt.cg(A, b, x0=x0, M=rt.jacobi(A), rel_tol=1e-6)
    assert torch.equal(x0, kept)          # the pool's x0 is not written
    xr, it = cg.pcg_jacobi(Ar, csr.diagonal(op, "cpu"), b, 1e-6, x0=x0)
    assert int(info.iterations) == it
    assert checks.rel_gap(x, xr) < 1e-13
    assert checks.rel_residual(Ar, x, b, x0) <= 1e-6
    assert checks.rel_residual(Ar, x0, b, x0) == 1.0


def test_reference_product_is_the_ports_spmm(port_on_cpu):
    rt = port_on_cpu
    op = fem_parabolic.build({"points": 700, "mesh_seed": 2,
                              "dt_times_points": 2.0})
    A = rt.CSR.from_arrays(op["data"], op["indices"], op["indptr"],
                           op["shape"], device="cpu")
    rt.attach_wjd(A)
    X = torch.randn((700, 32), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))
    Y = rt.spmv(A, X)
    Yr = csr.apply(csr.csr_tensor(op, "cpu"), X)
    assert checks.column_gap(Y, Yr) < 1e-14


def test_checks_read_wrong_shapes_and_nan_as_failures():
    op = heat3d_7pt.build({"grid": 3, "tau": 1.0})
    A = csr.csr_tensor(op, "cpu")
    b = torch.ones(27, dtype=torch.float64)
    assert checks.rel_residual(A, b[:13], b, b) == float("inf")
    assert checks.rel_gap(b[:13], b) == float("inf")
    assert checks.column_gap(torch.ones(27, 16), torch.ones(27, 32)) \
        == float("inf")
    assert checks.worst([1e-7, float("nan"), 1.0]) == float("inf")
    assert checks.worst([]) == 0.0
    np.testing.assert_allclose(
        float(csr.diagonal(op, "cpu")[0]), 7.0)
