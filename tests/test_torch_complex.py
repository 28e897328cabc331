"""Port parity: complex operators as two real WJD planes (ComplexWJD).

A complex CSR is planned into a ComplexWJD, its real and imaginary parts
as two WJD planes on one layout. The same seeded numpy operators go
through the JAX package and the port:

* each plane equals the JAX planner's plane (roll and gather mode,
  complex64 on f32 planes, complex128 on f64 planes: the JAX hi + lo pair
  against the port's native f64 plane to 2^-47 relative; the complex64
  gather case under the reference's f32 DIA split);
* the port's plain complex product (the CPU side of `cwjd_spmv`) agrees
  with JAX `spmv(ComplexWJD)` within 2e-5 (complex64) and 1e-13
  (complex128) relative, JAX's own bars (its f64 kernel is float-float);
* complex CG (complex symmetric, through dot_nonconj), GMRES (Hermitian)
  and BiCGStab (non-Hermitian) on tests/test_misc.py's problems give the
  JAX package's status and count, histories within rtol 1e-10 or, where
  the solve's own rounding moves an entry more, 100 times the port's own
  drift under a 1e-15 change of b (the rule of tests/test_torch_krylov.py:
  the dense products sum in another order than JAX's segment sums);
* a complex CSR attaches a ComplexWJD, solves through it as through the
  plain path, and `to_csr` gives the triplet back.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rocalution_tpu as jrt
import rocalution_tpu.formats.wjd as jax_wjd
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu.ops.spmv import spmv as jax_spmv
from rocalution_tpu_torch.interop import matrix_from_numpy
from test_torch_krylov import _assert_history_close
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

TOL = {np.complex64: 2e-5, np.complex128: 1e-13}
HIST_RTOL = 1e-10
# (kernel mode, values, split_dia)
CASES = [("roll", np.complex64, False), ("roll", np.complex128, False),
         ("gather", np.complex64, "auto"), ("gather", np.complex128, False)]


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU
    (module scope: the module-scoped fixtures build on it too)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture(autouse=True)
def one_tile_steps(monkeypatch):
    """One tile per grid step in both planners: the JAX side's interpreted
    f32 kernel costs less, and the product does not depend on grouping."""
    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)


def _triplet(mode, cdt):
    """A complex-symmetric operator S + 0.05j*T, T a seeded symmetric
    matrix on S's pattern: S = laplacian_2d(30) (roll planes) or
    random_banded_spd(2500, bandwidth=400) (gather planes)."""
    S = (rt.laplacian_2d(30, device="cpu") if mode == "roll" else
         rt.random_banded_spd(2500, bandwidth=400, device="cpu"))
    d, i, p = S.numpy_triplet()
    # the entry of S^T at each entry's place: S's pattern is symmetric
    at = sp.csr_matrix((np.arange(1.0, len(d) + 1), i, p), shape=S.shape)
    at = at.T.tocsr()
    at.sort_indices()
    mirror = at.data.astype(np.int64) - 1
    v = np.random.default_rng(5).standard_normal(len(d))
    return (d + 0.05j * (v + v[mirror])).astype(cdt), i, p, S.shape


@pytest.fixture(scope="module")
def pairs():
    """(JAX ComplexWJD, port ComplexWJD, scipy matrix) per case, planned
    with the reference's DIA rule (split_dia="auto") on both sides."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_wjd, torch_wjd):
            mp.setattr(mod, "_auto_group", lambda K: 1)
        for mode, cdt, split in CASES:
            d, i, p, shape = _triplet(mode, cdt)
            kw = dict(kernel_mode=mode, split_dia=split)
            Wj = jax_wjd.from_csr(jrt.CSR.from_arrays(d, i, p, shape), **kw)
            Wt = torch_wjd.from_csr(rt.CSR.from_arrays(d, i, p, shape), **kw)
            out[mode, cdt] = Wj, Wt, sp.csr_matrix((d, i, p), shape=shape)
    return out


def _assert_plane_equal(pj, pt):
    """A JAX WJD plane against the port's: every array and static."""
    data = np.asarray(pj.data)
    if pj.data_lo is not None:
        np.testing.assert_allclose(
            pt.data.numpy(), data.astype(np.float64)
            + np.asarray(pj.data_lo), rtol=2.0 ** -47, atol=0)
    else:
        np.testing.assert_array_equal(pt.data.numpy(), data)
    for f in ("uloc", "brow", "diag_u", "win_base", "dia_data", "spill_row",
              "spill_col", "spill_val"):
        a, b = getattr(pj, f), getattr(pt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
    for f in ("dia_offsets", "shape", "kernel_mode", "pad_lo", "xp_len",
              "nnz", "group", "wlog", "win_rows"):
        assert getattr(pt, f) == getattr(pj, f), f


@pytest.mark.parametrize("mode,cdt,split", CASES)
def test_planes_equal_the_jax_planes(pairs, mode, cdt, split):
    Wj, Wt, _ = pairs[mode, cdt]
    assert isinstance(Wj, jax_wjd.ComplexWJD)
    assert isinstance(Wt, rt.ComplexWJD)
    assert Wt.value_dtype == Wj.value_dtype == np.dtype(cdt).name
    assert Wt.dtype == rt.config.torch_dtype(cdt)
    assert Wt.re.kernel_mode == mode
    assert Wt.re.dtype == (torch.float32 if cdt == np.complex64
                           else torch.float64)
    assert bool(Wt.re.dia_offsets) == (split == "auto")
    for pj, pt in ((Wj.re, Wt.re), (Wj.im, Wt.im)):
        _assert_plane_equal(pj, pt)


@pytest.mark.parametrize("mode,cdt,split", CASES)
def test_product_matches_jax(pairs, mode, cdt, split):
    """x of shape (n,) against JAX spmv(ComplexWJD) and the exact product;
    X of shape (n, 3) and a real x against the exact product."""
    Wj, Wt, S = pairs[mode, cdt]
    rng = np.random.default_rng(11)
    n = S.shape[0]
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(cdt)
    ref = S @ x
    got = rt.spmv(Wt, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_spmv(Wj, jnp.asarray(x)))
    assert got.dtype == cdt
    for other in (want, ref):
        assert np.linalg.norm(got - other) / np.linalg.norm(other) \
            < TOL[cdt]
    X = (rng.standard_normal((n, 3))
         + 1j * rng.standard_normal((n, 3))).astype(cdt)
    Y = rt.spmv(Wt, torch.from_numpy(X)).numpy()
    assert np.linalg.norm(Y - S @ X) / np.linalg.norm(S @ X) < TOL[cdt]
    xr = rng.standard_normal(n).astype(np.float32 if cdt == np.complex64
                                       else np.float64)
    yr = rt.spmv(Wt, torch.from_numpy(xr)).numpy()
    assert np.linalg.norm(yr - S @ xr) / np.linalg.norm(S @ xr) < TOL[cdt]
    # the reference's formula over the planes' plain products
    from rocalution_tpu_torch.ops.cuda.spmv_wjd import cwjd_reference

    np.testing.assert_allclose(
        cwjd_reference(Wt, torch.from_numpy(x)).numpy(), got,
        rtol=0, atol=TOL[cdt] * np.abs(ref).max())


def _misc_problem(name):
    """The operators of tests/test_misc.py, with b = H x_true."""
    if name == "cg":             # complex symmetric: S + i T
        rng = np.random.default_rng(1)
        n = 60
        B = rng.standard_normal((n, n))
        C = rng.standard_normal((n, n))
        H = B @ B.T + n * np.eye(n) + 1j * 0.05 * (C + C.T)
    elif name == "gmres":        # Hermitian positive definite
        rng = np.random.default_rng(3)
        n = 40
        B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        H = B @ B.conj().T + n * np.eye(n)
    else:                        # non-Hermitian, diagonally dominant
        rng = np.random.default_rng(7)
        n = 50
        M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        H = M * 0.1 + n * np.eye(n)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return H, H @ x_true, x_true


SOLVES = {"cg": dict(rel_tol=1e-12, max_iter=500),
          "gmres": dict(rel_tol=1e-10, max_iter=500),
          "bicgstab": dict(rel_tol=1e-12, max_iter=500)}


def _port_solve(name, A, b, nudge=False, **kw):
    if nudge:
        b = b * (1 + 1e-15)
    x, info = getattr(rt, name)(A, torch.from_numpy(b), record_history=True,
                                **SOLVES[name], **kw)
    return (x.numpy(), int(info.status), int(info.iterations),
            info.history.numpy())


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_complex_solver_matches_jax(name):
    H, b, x_true = _misc_problem(name)
    xj, info = getattr(jrt, name)(jrt.CSR.from_dense(H), jnp.asarray(b),
                                  record_history=True, **SOLVES[name])
    hj = np.asarray(info.history)
    xt, st, it, ht = _port_solve(name, rt.CSR.from_dense(H), b)
    hp = _port_solve(name, rt.CSR.from_dense(H), b, nudge=True)[3]
    assert (st, it) == (int(info.status), int(info.iterations))
    assert st == 2
    _assert_history_close(hj, ht, hp, HIST_RTOL)
    assert np.linalg.norm(xt - x_true) < 1e-6 * np.linalg.norm(x_true)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0,
                               atol=1e-10 * np.abs(x_true).max())


def test_attach_path_and_to_csr(pairs):
    """A complex CSR takes a ComplexWJD where auto-attach applies, solves
    through it with the plain path's status and count, gives its triplet
    back through to_csr, and a JAX ComplexWJD comes across by interop."""
    H, b, _ = _misc_problem("cg")
    A = rt.CSR.from_dense(H)
    plain = _port_solve("cg", A, b, M=rt.jacobi(A))
    nudged = _port_solve("cg", A, b, nudge=True, M=rt.jacobi(A))
    B = rt.CSR.from_dense(H)
    rt.set_auto_wjd(True)
    try:
        via = _port_solve("cg", B, b, M=rt.jacobi(B))
    finally:
        rt.set_auto_wjd(None)
    assert isinstance(B._wjd_cache, rt.ComplexWJD)
    assert getattr(A, "_wjd_cache", None) is None
    assert via[1:3] == plain[1:3]
    _assert_history_close(plain[3], via[3], nudged[3], HIST_RTOL)
    # to_csr: the triplet back, bit for bit (no stored zeros here)
    for (mode, cdt), (Wj, Wt, S) in pairs.items():
        back = rt.to_csr(Wt)
        d, i, p = back.numpy_triplet()
        assert d.dtype == cdt, (mode, cdt)
        np.testing.assert_array_equal(p, S.indptr)
        np.testing.assert_array_equal(i, S.indices)
        np.testing.assert_array_equal(d, S.data)
        # interop: the JAX planes on the port, the same product
        fields = {"re": {f.name: np.asarray(getattr(Wj.re, f.name))
                         if hasattr(getattr(Wj.re, f.name), "shape")
                         else getattr(Wj.re, f.name)
                         for f in dataclasses.fields(Wj.re)}}
        fields["im"] = {f.name: np.asarray(getattr(Wj.im, f.name))
                        if hasattr(getattr(Wj.im, f.name), "shape")
                        else getattr(Wj.im, f.name)
                        for f in dataclasses.fields(Wj.im)}
        fields["value_dtype"] = Wj.value_dtype
        Wi = matrix_from_numpy("ComplexWJD", fields, device="cpu")
        x = torch.from_numpy(np.exp(1j * np.arange(S.shape[0])).astype(cdt))
        ref = S @ x.numpy()
        got = rt.spmv(Wi, x).numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < TOL[cdt]
