"""Port parity: the preconditioner samples of clients/samples, each at its
own size and settings, through the JAX package and the port on the CPU.

as_precond.py (CG + AS and + RAS), block_precond.py (FGMRES + a
block-lower BlockPreconditioner of ILU(0) blocks), me_preconditioner.py
(FGMRES + ME(3)), sp_precond.py (GMRES(40) + the saddle-point
preconditioner), tns.py (CG + TNS), var_precond.py (FGMRES + a
VariablePreconditioner of Jacobi, SGS and TNS) and cmk.py (CG on the RCMK
reordering of a random SPD matrix). Each solve in f64 gives the JAX
package's status and iteration count, with residual histories within rtol
1e-10 (plus 1e-14 of the initial residual, as in the AMG tests).
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu import precond as jp
from rocalution_tpu.ops import extract as jax_ext
from rocalution_tpu.ops import ordering as jax_ord
from rocalution_tpu_torch import precond as tp
from rocalution_tpu_torch.ops import extract, ordering
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _rhs(A):
    d, _, p = A.numpy_triplet()
    return np.add.reduceat(d, p[:-1]).astype(d.dtype)


def _same_solve(Aj, At, b, solver, Mj, Mt, **kw):
    xj, ij = getattr(jrt, solver)(Aj, b, M=Mj, record_history=True, **kw)
    xt, it = getattr(rt, solver)(At, torch.from_numpy(b), M=Mt,
                                 record_history=True, **kw)
    assert int(it.status) == int(ij.status)
    assert int(it.iterations) == int(ij.iterations)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    keep = ~np.isnan(hj)
    assert np.array_equal(keep, ~np.isnan(ht))
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10,
                               atol=1e-14 * hj[0])
    return xt, it


@pytest.mark.parametrize("restricted", [False, True])
def test_as_precond_sample(restricted):
    Aj, At = jrt.laplacian_2d(48), rt.laplacian_2d(48)
    kw = dict(num_blocks=4, overlap=8, restricted=restricted)
    xt, it = _same_solve(Aj, At, _rhs(At), "cg",
                         jp.additive_schwarz(Aj, **kw),
                         tp.additive_schwarz(At, **kw),
                         rel_tol=1e-8, max_iter=2000)
    assert int(it.status) == 2
    assert np.abs(xt.numpy() - 1.0).max() < 1e-5


def test_block_precond_sample():
    Aj, At = jrt.laplacian_2d(40), rt.laplacian_2d(40)
    bj = jax_ext.extract_submatrices(Aj, 4)
    bt = extract.extract_submatrices(At, 4)
    Mj = jp.block_precond(Aj, 4, [jp.ilu(bj[i][i]) for i in range(4)],
                          lower=True)
    Mt = tp.block_precond(At, 4, [tp.ilu(bt[i][i]) for i in range(4)],
                          lower=True)
    _same_solve(Aj, At, _rhs(At), "fgmres", Mj, Mt, rel_tol=1e-8,
                max_iter=2000)


def test_me_preconditioner_sample():
    Aj, At = jrt.laplacian_2d(40), rt.laplacian_2d(40)
    _same_solve(Aj, At, _rhs(At), "fgmres",
                jp.multi_elimination(Aj, levels=3, drop_tol=1e-3),
                tp.multi_elimination(At, levels=3, drop_tol=1e-3),
                rel_tol=1e-8, max_iter=2000)


def test_sp_precond_sample():
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    m, k = 256, 64
    A11 = sp.random(m, m, density=0.03, random_state=7)
    A11 = (A11 + A11.T + 4 * m * sp.eye(m)).tocsr()
    B = sp.random(m, k, density=0.08, random_state=8).tocsr()
    K = sp.bmat([[A11, B], [B.T, None]], format="coo")
    Kj = jrt.CSR.from_coo(K.row, K.col, K.data, K.shape)
    Kt = rt.CSR.from_coo(K.row, K.col, K.data, K.shape)
    xs = rng.standard_normal(m + k)
    b = np.array(jrt.spmv(Kj, xs))
    _same_solve(Kj, Kt, b, "gmres", jp.saddle_point_precond(Kj, m),
                tp.saddle_point_precond(Kt, m), basis_size=40,
                rel_tol=1e-8, max_iter=4000)


def test_tns_sample():
    Aj, At = jrt.laplacian_2d(48), rt.laplacian_2d(48)
    _same_solve(Aj, At, _rhs(At), "cg", jrt.precond.tns(Aj),
                rt.precond.tns(At), rel_tol=1e-8, max_iter=2000)


def test_var_precond_sample():
    Aj, At = jrt.laplacian_2d(40), rt.laplacian_2d(40)
    Mj = jp.variable_precond([jp.jacobi(Aj), jp.sgs(Aj), jp.tns(Aj)])
    Mt = tp.variable_precond([tp.jacobi(At), tp.sgs(At), tp.tns(At)])
    _same_solve(Aj, At, _rhs(At), "fgmres", Mj, Mt, rel_tol=1e-8,
                max_iter=2000)


def test_cmk_sample():
    """The sample's random SPD matrix comes from the JAX package's
    generator (the port's arrives with the generators of a later slice);
    the ordering and the solve are each package's own."""
    Aj = jrt.utils.generators.random_spd(300, density=0.02, seed=11)
    At = rt.CSR.from_arrays(*Aj.numpy_triplet(), Aj.shape)
    perm = ordering.rcmk(At)
    np.testing.assert_array_equal(jax_ord.rcmk(Aj), perm)
    Apj, Apt = jax_ord.permute_csr(Aj, perm), ordering.permute_csr(At, perm)
    bw = [int(np.max(np.abs(M.numpy_rows() - M.numpy_triplet()[1])))
          for M in (At, Apt)]
    assert bw[1] < bw[0]
    _same_solve(Apj, Apt, _rhs(Apt), "cg", None, None, rel_tol=1e-8,
                max_iter=5000)
