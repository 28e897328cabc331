"""Port parity: the factorization slice (generators, RCM ordering, ILU(0)
and IC(0), level schedules, both tri-solve methods, and `ic` / `ilu` /
`itilu0` as CG preconditioners).

Host code is copied from the JAX package, so the generators' triplets,
the permutations, the factors (native sweep and numpy fallback) and the
`LevelSchedule` arrays must be equal, entry for entry. The tri-solves run
the same arithmetic in another summation order: a schedule solve and a
Jacobi-swept solve agree to rtol 1e-13 in f64. Each CG solve gives the
JAX package's status and iteration count, with residual histories within
rtol 1e-10 in f64; the f32 row gives the same status and iterations
within 2. The JAX side runs with its CPU default (auto_wjd off, no
interpreted Pallas) and is solved once per case (module-scoped fixtures);
one case turns auto_wjd on on both sides to hold `prepare_offd`'s plans
against the JAX planner's.
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.config import set_auto_wjd as jax_set_auto_wjd
from rocalution_tpu.ops import factorize as jax_fac
from rocalution_tpu.ops import ordering as jax_ord
from rocalution_tpu.ops import trisolve as jax_tri
from rocalution_tpu.precond import ic as jax_ic
from rocalution_tpu.precond import ilu as jax_ilu
from rocalution_tpu.precond import itilu0 as jax_itilu0
from rocalution_tpu_torch.ops import factorize, ordering, trisolve
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU
    (module scope: the module-scoped fixtures below build on it too)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _triplets_equal(Mj, Mt):
    assert Mj.shape == Mt.shape
    for a, b in zip(Mj.numpy_triplet(), Mt.numpy_triplet()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _rhs(A):
    """b = A @ 1 from the host triplet."""
    d, _, p = A.numpy_triplet()
    return np.add.reduceat(d, p[:-1]).astype(d.dtype)


GENERATORS = {
    "cd2d_24_f64": lambda m: m.convection_diffusion_2d(24),
    "cd2d_24_f32": lambda m: m.convection_diffusion_2d(24,
                                                       dtype=np.float32),
    "cd2d_9_pe0": lambda m: m.convection_diffusion_2d(9, peclet=0.0),
    "fem_2000": lambda m: m.fem_2d_unstructured(2000),
    "fem_2000_parabolic_f32": lambda m: m.fem_2d_unstructured(
        2000, dtype=np.float32, parabolic=True),
    "fem_500_no_rcm": lambda m: m.fem_2d_unstructured(500, seed=3,
                                                      rcm=False),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_jax(name):
    _triplets_equal(GENERATORS[name](jrt), GENERATORS[name](rt))


@pytest.fixture(scope="module")
def fem():
    """fem_2d_unstructured(2000, parabolic): the FEM row's operator at a
    small size, on both sides."""
    return (jrt.fem_2d_unstructured(2000, parabolic=True),
            rt.fem_2d_unstructured(2000, parabolic=True))


@pytest.mark.parametrize("which", ["rcmk", "cmk"])
def test_orderings_match_jax(which):
    Aj = jrt.fem_2d_unstructured(800, rcm=False)
    At = rt.fem_2d_unstructured(800, rcm=False)
    pj, pt = getattr(jax_ord, which)(Aj), getattr(ordering, which)(At)
    np.testing.assert_array_equal(pj, pt)
    assert sorted(pt.tolist()) == list(range(At.shape[0]))
    _triplets_equal(jax_ord.permute_csr(Aj, pj),
                    ordering.permute_csr(At, pt))


def test_rcm_cuts_the_bandwidth():
    A = rt.fem_2d_unstructured(800, rcm=False)
    B = ordering.permute_csr(A, ordering.rcmk(A))

    def band(M):
        return int(np.abs(M.numpy_triplet()[1] - M.numpy_rows()).max())

    assert band(B) < band(A) // 4


FACTOR_CASES = {
    "lap2d_12_f64": lambda m: m.laplacian_2d(12),
    "lap2d_12_f32": lambda m: m.laplacian_2d(12, dtype=np.float32),
    "cd2d_12_f64": lambda m: m.convection_diffusion_2d(12),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(FACTOR_CASES))
def test_ilu0_factors_match_jax(name, native, monkeypatch):
    """The native sweep (f32 through f64) and the numpy fallback."""
    if not native:
        monkeypatch.setattr(jax_fac, "_use_native", lambda d: False)
        monkeypatch.setattr(factorize, "_use_native", lambda d: False)
    Aj, At = FACTOR_CASES[name](jrt), FACTOR_CASES[name](rt)
    (Lj, Uj), (Lt, Ut) = jax_fac.ilu0(Aj), factorize.ilu0(At)
    _triplets_equal(Lj, Lt)
    _triplets_equal(Uj, Ut)
    assert Lt.device.type == "cpu"          # host-resident factors
    if native:
        # and the factors' product restores A on its pattern
        d, i, p = At.numpy_triplet()
        LU = (Lt.to_dense().double() @ Ut.to_dense().double()).numpy()
        rows = At.numpy_rows()
        np.testing.assert_allclose(LU[rows, i], d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["lap2d_12_f64", "lap2d_12_f32"])
def test_ic0_factor_matches_jax(name, native, monkeypatch):
    if not native:
        monkeypatch.setattr(jax_fac, "_use_native", lambda d: False)
        monkeypatch.setattr(factorize, "_use_native", lambda d: False)
    Aj, At = FACTOR_CASES[name](jrt), FACTOR_CASES[name](rt)
    _triplets_equal(jax_fac.ic0(Aj), factorize.ic0(At))


def test_factor_breakdowns_raise():
    A = rt.CSR.from_dense(np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0],
                                    [0.0, 1.0, 1.0]]))   # pivot 1 is 0
    with pytest.raises(ZeroDivisionError):
        factorize._ilu0_numeric(*factorize._host(A), 3)
    with pytest.raises(ValueError):
        factorize.ic0(rt.CSR.from_dense(np.array([[1.0, 2.0], [2.0, 1.0]])))
    with pytest.raises(ValueError):
        factorize._diag_ptrs(np.array([1]), np.array([0, 1]), 1)


@pytest.fixture(scope="module")
def fem_factors(fem):
    Aj, At = fem
    return jax_fac.ilu0(Aj), factorize.ilu0(At)


@pytest.fixture(scope="module")
def schedules(fem_factors):
    (Lj, Uj), (Lt, Ut) = fem_factors
    return {"L": (jax_tri.build_schedule(Lj, unit_diag=True),
                  trisolve.build_schedule(Lt, unit_diag=True)),
            "U": (jax_tri.build_schedule(Uj), trisolve.build_schedule(Ut))}


@pytest.mark.parametrize("which", ["L", "U"])
def test_level_schedules_match_jax(schedules, which):
    sj, st = schedules[which]
    assert st.nlev == sj.rows.shape[0] > 10
    for field in trisolve.LevelSchedule._fields:
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)))


@pytest.mark.parametrize("cols", [None, 3])
@pytest.mark.parametrize("which", ["L", "U"])
def test_solve_schedule_matches_jax(schedules, fem_factors, which, cols):
    sj, st = schedules[which]
    n = fem_factors[1][0].shape[0]
    shape = (n,) if cols is None else (n, cols)
    b = np.random.default_rng(2).standard_normal(shape)
    want = np.asarray(jax_tri.solve_schedule(sj, b))
    got = trisolve.solve_schedule(st, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    # an exact solve: T x = b
    Lt, Ut = fem_factors[1]
    T = (Lt if which == "L" else Ut).to_dense().numpy()
    np.testing.assert_allclose(T @ got, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("unit", [True, False])
def test_trisolve_jacobi_matches_jax(fem_factors, unit):
    (Lj, Uj), (Lt, Ut) = fem_factors
    Tj, Tt = (Lj, Lt) if unit else (Uj, Ut)
    b = np.random.default_rng(3).standard_normal(Tt.shape[0])
    want = np.asarray(jax_tri.trisolve_jacobi(Tj, b, sweeps=5,
                                              unit_diag=unit))
    got = trisolve.trisolve_jacobi(Tt, torch.from_numpy(b), sweeps=5,
                                   unit_diag=unit).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    # the off-diagonal part and the inverse diagonal are built once
    N = Tt._offd_cache
    trisolve.trisolve_jacobi(Tt, torch.from_numpy(b), sweeps=1,
                             unit_diag=unit)
    assert Tt._offd_cache is N
    assert getattr(N, "_wjd_cache", None) is None    # auto_wjd off here


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_prepare_offd_plans_like_the_jax_planner(dtype, monkeypatch):
    """auto_wjd on, on both sides: the off-diagonal part of each IC(0)
    factor of laplacian_2d(24) gets a WJD plan equal to the JAX planner's
    when the port plans under the reference's split rule (split_dia
    "auto": f64 a roll plan, f32 its DIA split); under the port's own
    default no diagonal splits off. Both of the port's plans apply as the
    plain CSR product of that part."""
    import functools

    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    for mod in (jax_wjd, torch_wjd):          # fixture one_tile_steps
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)
    monkeypatch.setenv("ROCALUTION_TPU_PLAN_CACHE", "0")
    port_rule = torch_wjd.csr_to_wjd_plan
    Lj = jax_fac.ic0(jrt.laplacian_2d(24, dtype=dtype))
    Lt = factorize.ic0(rt.laplacian_2d(24, dtype=dtype))
    for Tj, Tt in ((Lj, Lt), (Lj.transpose_host(device=False),
                              Lt.transpose_host())):
        plans = {}
        for split in ("auto", False):
            monkeypatch.setattr(torch_wjd, "csr_to_wjd_plan",
                                functools.partial(port_rule,
                                                  split_dia=split))
            object.__setattr__(Tt, "_offd_cache", None)
            jax_set_auto_wjd(True)
            rt.set_auto_wjd(True)
            try:
                Nj, Nt = jax_tri.prepare_offd(Tj), trisolve.prepare_offd(Tt)
            finally:
                jax_set_auto_wjd(None)
                rt.set_auto_wjd(None)
            _triplets_equal(Nj, Nt)
            plans[split] = Nt._wjd_cache
            x = torch.from_numpy(
                np.random.default_rng(4).standard_normal(Nt.shape[1])
                .astype(dtype))
            plain = rt.CSR.from_arrays(*Nt.numpy_triplet(), Nt.shape)
            want = rt.spmv(plain, x).numpy()
            np.testing.assert_allclose(rt.spmv(Nt, x).numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        Wj, Wt = Nj._wjd_cache, plans["auto"]
        assert Wt.kernel_mode == Wj.kernel_mode
        assert Wt.dia_offsets == Wj.dia_offsets
        assert (Wt.xp_len, Wt.pad_lo, Wt.nnz) == (Wj.xp_len, Wj.pad_lo,
                                                  Wj.nnz)
        np.testing.assert_array_equal(Wt.brow.numpy(), np.asarray(Wj.brow))
        assert plans[False].dia_offsets == ()
        assert bool(Wj.dia_offsets) == (dtype == np.float32)


# ---------------------------------------------------------------------------
# CG with ic / ilu / itilu0: one JAX solve per case
# ---------------------------------------------------------------------------

PRECONDS = {
    "ic_levels": lambda m, A: m[0](A, method="levels"),
    "ic_jacobi": lambda m, A: m[0](A, method="jacobi", sweeps=8),
    "ilu_levels": lambda m, A: m[1](A, 0, method="levels"),
    "ilu_jacobi": lambda m, A: m[1](A, 0, method="jacobi", sweeps=4),
    "itilu0": lambda m, A: m[2](A, sweeps=6),
}
JAX_P, TORCH_P = (jax_ic, jax_ilu, jax_itilu0), (rt.ic, rt.ilu, rt.itilu0)


def _cg_pair(Aj, At, pname, **kw):
    b = _rhs(Aj)
    xj, ij = jrt.cg(Aj, b, M=PRECONDS[pname](JAX_P, Aj),
                    record_history=True, **kw)
    xt, it = rt.cg(At, torch.from_numpy(b), M=PRECONDS[pname](TORCH_P, At),
                   record_history=True, **kw)
    return (np.asarray(xj), ij), (xt.numpy(), it)


@pytest.fixture(scope="module")
def cg_lap():
    Aj, At = jrt.laplacian_2d(24), rt.laplacian_2d(24)
    return {p: _cg_pair(Aj, At, p, rel_tol=1e-8, max_iter=300)
            for p in PRECONDS}


def _same_solve(pair, hist_len=None):
    """Same status and iterations; histories within rtol 1e-10 (over the
    first `hist_len` entries where given), solutions within 1e-9."""
    (xj, ij), (xt, it) = pair
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status) == 2
    hj, ht = np.asarray(ij.history), it.history.numpy()
    assert np.array_equal(np.isnan(hj), np.isnan(ht))
    keep = np.flatnonzero(~np.isnan(hj))[:hist_len]
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10,
                               atol=1e-14 * hj[0])
    if hist_len is None:
        np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("pname", sorted(PRECONDS))
def test_cg_with_factor_preconditioner_matches_jax(cg_lap, pname):
    _same_solve(cg_lap[pname])
    xt = cg_lap[pname][1][0]
    assert np.linalg.norm(xt - 1.0) / np.sqrt(len(xt)) < 1e-6


def test_ic_beats_no_preconditioner(cg_lap):
    A = rt.laplacian_2d(24)
    _, info = rt.cg(A, torch.from_numpy(_rhs(A)), rel_tol=1e-8)
    assert int(cg_lap["ic_levels"][1][1].iterations) < int(info.iterations)


def test_fem_row_cg_ilu_levels_matches_jax(fem):
    """bench.py's fem_ilu0 row at 2,000 points: CG with ilu(Af, 0,
    method="levels"), rel_tol 1e-4, max_iter 200. In floating point the
    ILU(0) factors of this SPD operator are not exactly symmetric, and CG
    amplifies a difference of rounding about tenfold a step: scaling the
    preconditioner's output by 1 + 1e-15 moves the history by more than
    1e-6 relative (checked below on the port). So the histories are held
    to rtol 1e-10 over their first 6 entries, and the solves to the same
    status, iterations and error."""
    pair = _cg_pair(*fem, "ilu_levels", rel_tol=1e-4, max_iter=200)
    _same_solve(pair, hist_len=6)
    for x, _ in pair:
        assert np.linalg.norm(x - 1.0) / np.sqrt(len(x)) < 1e-2
    At = fem[1]
    M = rt.ilu(At, 0, method="levels")
    _, info = rt.cg(At, torch.from_numpy(_rhs(At)),
                    M=lambda r: M(r) * (1 + 1e-15), rel_tol=1e-4,
                    max_iter=200, record_history=True)
    ht, hp = pair[1][1].history.numpy(), info.history.numpy()
    keep = ~np.isnan(ht) & ~np.isnan(hp)
    assert np.max(np.abs(hp[keep] - ht[keep]) / ht[keep]) > 1e-6


def test_cg_ic0_row_f32_converges_like_jax():
    """bench.py's cg_ic0 row at 24x24 in f32: ic(A, method="jacobi",
    sweeps=8), CG on the DIA operator, rel_tol 1e-6."""
    Aj = jrt.laplacian_2d(24, dtype=np.float32)
    At = rt.laplacian_2d(24, dtype=np.float32)
    b = _rhs(Aj)
    _, ij = jrt.cg(jrt.convert(Aj, "DIA"), b,
                   M=jax_ic(Aj, method="jacobi", sweeps=8), rel_tol=1e-6)
    xt, it = rt.cg(rt.convert(At, "DIA"), torch.from_numpy(b),
                   M=rt.ic(At, method="jacobi", sweeps=8), rel_tol=1e-6)
    assert int(it.status) == int(ij.status) == 2
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert np.abs(xt.numpy() - 1.0).max() < 1e-3


def test_unknown_method_and_fill_level_raise():
    A = rt.laplacian_2d(4)
    with pytest.raises(ValueError):
        rt.ilu(A, 0, method="gauss")
    # ILU(p > 0) is ported (tests/test_torch_precond.py): a fill level
    # takes the same method check
    with pytest.raises(ValueError):
        rt.ilu(A, 1, method="gauss")
