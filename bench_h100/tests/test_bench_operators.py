"""The benchmark's operator builders against the port's generators, at a
tiny size."""

import numpy as np
import pytest

from bench_h100.operators import fem_parabolic, heat3d_7pt


@pytest.mark.parametrize("n", [1, 2, 5])
def test_heat3d_is_identity_plus_tau_times_the_ports_laplacian(n,
                                                               port_on_cpu):
    tau = 4.0
    got = heat3d_7pt.build({"grid": n, "tau": tau})
    L = port_on_cpu.laplacian_3d(n, device="cpu")
    data, indices, indptr = L.numpy_triplet()
    rows = np.repeat(np.arange(n ** 3), np.diff(indptr))
    want = tau * data + (rows == indices)
    assert got["shape"] == (n ** 3, n ** 3)
    np.testing.assert_array_equal(got["indptr"], indptr)
    np.testing.assert_array_equal(got["indices"], indices)
    np.testing.assert_array_equal(got["data"], want)


def test_fem_assembly_is_the_ports_parabolic_fem(port_on_cpu):
    npts, seed = 500, 3
    A = fem_parabolic.assemble(npts, seed, 2.0 / npts)
    P = port_on_cpu.fem_2d_unstructured(npts, seed=seed, rcm=False,
                                        parabolic=True, device="cpu")
    data, indices, indptr = P.numpy_triplet()
    np.testing.assert_array_equal(A.indptr, indptr)
    np.testing.assert_array_equal(A.indices, indices)
    np.testing.assert_allclose(A.data, data, rtol=1e-14, atol=0)


def test_fem_build_is_a_symmetric_reordering_with_a_narrow_band():
    import scipy.sparse as sp

    cfg = {"points": 800, "mesh_seed": 1, "dt_times_points": 2.0}
    op = fem_parabolic.build(cfg)
    B = sp.csr_matrix((op["data"], op["indices"], op["indptr"]),
                      shape=op["shape"])
    A = fem_parabolic.assemble(800, 1, 2.0 / 800)
    assert B.nnz == A.nnz and abs(B - B.T).max() == 0
    np.testing.assert_allclose(np.sort(B.diagonal()), np.sort(A.diagonal()))
    band = lambda M: np.max(np.abs(M.tocoo().row - M.tocoo().col))
    assert band(B) < band(A) / 4
    assert np.all(np.diff(op["indices"][op["indptr"][0]:op["indptr"][1]]) > 0)
