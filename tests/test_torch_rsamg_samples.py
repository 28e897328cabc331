"""Port parity: the cg_rsamg.py sample (clients/samples) at its own size,
laplacian_2d(64): CG + Ruge-Stüben AMG with PMIS and greedy coarsening,
direct and extended+i interpolation, coarse_size 200, rel_tol 1e-8,
through the JAX package and the port on the CPU. Each combination gives
the JAX package's status and iteration count, with residual histories
within rtol 1e-10 (plus 1e-14 of the initial residual, as in the AMG
tests), and the cycles of the port run the same arithmetic in another
summation order.
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.solvers import multigrid as jmg
from rocalution_tpu_torch.solvers import multigrid as tmg
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from test_torch_rsamg import on_the_cpu  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def sample_op():
    """cg_rsamg.py's operator, laplacian_2d(64), and b = A 1."""
    Aj, At = jrt.laplacian_2d(64), rt.laplacian_2d(64)
    d, _, p = At.numpy_triplet()
    return Aj, At, np.add.reduceat(d, p[:-1])


@pytest.mark.parametrize("interp", ["direct", "extpi"])
@pytest.mark.parametrize("coarsening", ["pmis", "greedy"])
def test_cg_rsamg_sample_matches_jax(sample_op, coarsening, interp):
    Aj, At, b = sample_op
    kw = dict(coarse_size=200, coarsening=coarsening, interpolation=interp)
    solve = dict(rel_tol=1e-8, max_iter=200, record_history=True)
    xj, ij = jrt.cg(Aj, b, M=jmg.amg_precond(Aj, "rs", **kw), **solve)
    xt, it = rt.cg(At, torch.from_numpy(b), M=tmg.amg_precond(At, "rs", **kw),
                   check_every=8, **solve)
    assert int(it.status) == int(ij.status) == 2
    assert int(it.iterations) == int(ij.iterations)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    keep = ~np.isnan(hj)
    assert np.array_equal(keep, ~np.isnan(ht))
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10,
                               atol=1e-14 * hj[0])
    assert np.abs(xt.numpy() - 1.0).max() < 1e-5
