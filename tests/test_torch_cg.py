"""Port parity: the slice as a whole — CG + Jacobi through WJD.

The JAX package solves with `attach_wjd(A)` set explicitly (no global
config change); the port attaches the same way. f64 must give the same
iterations and status as `rt.cg`, with residual histories within rtol
1e-10 (XLA and torch reduce in different orders). f32 must converge on
both sides with iteration counts at most 2 apart.
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.ops.spmv import attach_wjd as jax_attach_wjd
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)

@pytest.fixture(autouse=True)
def one_tile_steps(monkeypatch):
    """One tile per grid step in both planners: the JAX side's interpreted
    Pallas kernel unrolls group x K slot bodies per step, and the tiles of
    zeros that pad these operators to a group cost most of its seconds. The
    product does not depend on the grouping (as in
    tests/test_torch_spmv.py)."""
    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)


GENERATORS = {
    "lap2d_30": lambda m, dt: m.laplacian_2d(30, dtype=dt),
    "randband_3000": lambda m, dt: m.random_banded_spd(
        3000, bandwidth=512, dtype=dt),
}


def _rhs(Aj):
    """b = A @ 1, from the host triplet (one copy shared by both sides)."""
    d, _, p = Aj.numpy_triplet()
    return np.add.reduceat(d, p[:-1]).astype(d.dtype)


def _solve_both(name, dtype, attach_kw=None, **kw):
    Aj, At = GENERATORS[name](jrt, dtype), GENERATORS[name](rt, dtype)
    jax_attach_wjd(Aj, cache=False, **(attach_kw or {}))
    rt.attach_wjd(At, **(attach_kw or {}))
    b = _rhs(Aj)
    xj, ij = jrt.cg(Aj, b, M=jrt.jacobi(Aj), **kw)
    xt, it = rt.cg(At, torch.from_numpy(b), M=rt.jacobi(At), **kw)
    return (np.asarray(xj), ij), (xt.numpy(), it)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_cg_jacobi_f64_matches_jax(name):
    """The entry() problem (laplacian_2d(30)) and the random gather one."""
    (xj, ij), (xt, it) = _solve_both(
        name, np.float64, rel_tol=1e-8, max_iter=200, record_history=True)
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status) == 2
    hj = np.asarray(ij.history)
    ht = it.history.numpy()
    assert np.array_equal(np.isnan(hj), np.isnan(ht))
    keep = ~np.isnan(hj)
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10, atol=0)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    assert np.linalg.norm(xt - 1.0) / np.sqrt(len(xt)) < 1e-6


@pytest.mark.parametrize("split_dia", ["auto", False])
def test_cg_jacobi_f32_converges_like_jax(split_dia):
    """f32 Laplacian: split (DIA part only) and unsplit (roll kernel)."""
    (xj, ij), (xt, it) = _solve_both(
        "lap2d_30", np.float32, attach_kw={"split_dia": split_dia},
        rel_tol=1e-5, max_iter=200)
    assert int(ij.status) == int(it.status) == 2
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert np.abs(xt - 1.0).max() < 1e-3


def test_cg_jacobi_65k_matches_bench_record():
    """bench.py's cg_jacobi section (laplacian_2d(256) f32 as DIA, Jacobi,
    rel_tol 1e-6): BENCH_r05.json records cg_jacobi_65k_iters = 397."""
    A = rt.laplacian_2d(256, dtype=np.float32)
    d, i, p = A.numpy_triplet()
    rows = A.numpy_rows()
    b = np.bincount(rows, weights=d, minlength=A.shape[0]).astype(np.float32)
    invd = torch.from_numpy((1.0 / np.bincount(
        rows, weights=np.where(i == rows, d, 0),
        minlength=A.shape[0])).astype(np.float32))
    _, info = rt.cg(rt.DIA.from_csr_host(A), torch.from_numpy(b),
                    M=lambda r: invd * r, rel_tol=1e-6, max_iter=1000)
    assert int(info.status) == 2
    assert int(info.iterations) == 397


def test_check_every_changes_nothing():
    A = rt.laplacian_2d(30)
    rt.attach_wjd(A)
    b = torch.from_numpy(_rhs(A))
    runs = [rt.cg(A, b, M=rt.jacobi(A), rel_tol=1e-8, max_iter=200,
                  record_history=True, check_every=ce) for ce in (1, 32)]
    (x1, i1), (x32, i32) = runs
    assert torch.equal(x1, x32)
    for a, c in zip(i1, i32):
        assert torch.equal(a.nan_to_num(-1.0), c.nan_to_num(-1.0))


def _zero_matrix(m, n=16):
    return m.CSR.from_arrays(np.zeros(0), np.zeros(0, np.int32),
                             np.zeros(n + 1, np.int32), (n, n))


def test_iteration_control_nan_stop():
    """All-zero matrix: alpha = rho/0 poisons the residual -> status 0."""
    b = np.ones(16)
    _, ij = jrt.cg(_zero_matrix(jrt), b, M=jrt.jacobi(_zero_matrix(jrt)),
                   max_iter=50)
    At = _zero_matrix(rt)
    xt, it = rt.cg(At, torch.from_numpy(b), M=rt.jacobi(At), max_iter=50)
    assert int(it.status) == int(ij.status) == 0
    assert int(it.iterations) == int(ij.iterations) == 1
    assert not bool(torch.isfinite(it.final_res))


def test_iteration_control_abs_stop_at_init():
    """Zero rhs, zero x0: the initial residual meets abs_tol -> status 1."""
    Aj, At = jrt.laplacian_2d(8), rt.laplacian_2d(8)
    _, ij = jrt.cg(Aj, np.zeros(64), abs_tol=1e-15)
    _, it = rt.cg(At, torch.zeros(64, dtype=torch.float64), abs_tol=1e-15)
    assert int(it.status) == int(ij.status) == 1
    assert int(it.iterations) == int(ij.iterations) == 0


def test_iteration_control_max_iter():
    Aj, At = jrt.laplacian_2d(8), rt.laplacian_2d(8)
    b = _rhs(Aj)
    _, ij = jrt.cg(Aj, b, rel_tol=1e-14, max_iter=3, record_history=True)
    _, it = rt.cg(At, torch.from_numpy(b), rel_tol=1e-14, max_iter=3,
                  record_history=True)
    assert int(it.status) == int(ij.status) == 4
    assert int(it.iterations) == int(ij.iterations) == 3
    np.testing.assert_allclose(it.history.numpy(), np.asarray(ij.history),
                               rtol=1e-12)


def test_distributed_reductions_not_ported():
    A = rt.laplacian_2d(4)
    with pytest.raises(NotImplementedError):
        rt.cg(A, torch.ones(16, dtype=torch.float64), axis_name="x")
