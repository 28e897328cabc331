"""Port parity: the CG + SA-AMG slice (native layer, SpGEMM, aggregation,
hierarchies, cycles, FixedPoint, dense direct solvers).

Setup is host code copied from the JAX package and the same native
library, so level sizes and the P, R and Ac arrays must be equal. The
cycles run the same arithmetic in another summation order (the JAX CSR
apply is `segment_sum`, the port's plain one `index_add_`): one cycle
application agrees to rtol 1e-12 in f64; CG + SA-AMG gives the same
iterations and status, with histories within rtol 1e-10 (plus 1e-14 of the
initial residual: the last entries of a history lie 1e-9 below the first,
where the summation order alone moves them by about 1e-16 of it, which the
preconditioner carries from step to step). The f32 hierarchy
converges within 2 iterations of the JAX package's. The JAX side is built
once per operator (module-scoped fixtures).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu import native as jax_native
from rocalution_tpu.ops import spgemm as jax_spgemm
from rocalution_tpu.solvers import direct as jax_direct
from rocalution_tpu.solvers import multigrid as jmg
from rocalution_tpu.solvers.multigrid import aggregation as jax_agg
from rocalution_tpu_torch import native
from rocalution_tpu_torch.ops import spgemm
from rocalution_tpu_torch.solvers import multigrid as tmg
from rocalution_tpu_torch.solvers.multigrid import aggregation as torch_agg
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


GENERATORS = {
    "lap2d_24": lambda m: m.laplacian_2d(24),
    "lap3d_12": lambda m: m.laplacian_3d(12),
}
COARSE = 50          # three levels or more on both operators


def _triplets_equal(Mj, Mt, what=""):
    assert Mj.shape == Mt.shape, what
    for a, b in zip(Mj.numpy_triplet(), Mt.numpy_triplet()):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)


def _rhs(A):
    d, _, p = A.numpy_triplet()
    return np.add.reduceat(d, p[:-1]).astype(d.dtype)


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _histories_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14 * want[0])


@pytest.fixture(scope="module")
def built():
    """Per operator: (JAX A, port A, JAX SA hierarchy, port SA hierarchy)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    out = {}
    for name, make in GENERATORS.items():
        Aj, At = make(jrt), make(rt)
        out[name] = (Aj, At, jmg.amg_hierarchy(Aj, "sa", coarse_size=COARSE),
                     tmg.amg_hierarchy(At, "sa", coarse_size=COARSE))
    rt.set_default_device(before)
    return out


# ---------------------------------------------------------------- native

def test_native_layer_builds_where_the_jax_one_does():
    assert native.available() == jax_native.available()
    assert native.available(), "g++ is needed for the native setup layer"
    assert native.library_path().parent == native.BUILD_DIR


def test_native_graph_entry_points_match_jax(built):
    Aj, At, _, _ = built["lap3d_12"]
    d, i, p = At.numpy_triplet()
    for eps in (0.08, 0.3):
        (pj, cj), (pt, ct) = (m.strength_graph(p, i, d, eps)
                              for m in (jax_native, native))
        np.testing.assert_array_equal(pj, pt)
        np.testing.assert_array_equal(cj, ct)
    sptr, scol = native.strength_graph(p, i, d, 0.08)
    np.testing.assert_array_equal(jax_native.greedy_aggregate(sptr, scol),
                                  native.greedy_aggregate(sptr, scol))
    order = np.argsort(np.diff(p), kind="stable")
    for a, b in zip(jax_native.pairwise_match(p, i, d, 0.25, order),
                    native.pairwise_match(p, i, d, 0.25, order)):
        np.testing.assert_array_equal(a, b)
    st = np.zeros(len(p) - 1, np.int8)
    np.testing.assert_array_equal(
        jax_native.rs_coarsening(sptr, scol, sptr, scol, st),
        native.rs_coarsening(sptr, scol, sptr, scol, st))


def test_native_numeric_entry_points_match_jax(tmp_path):
    A = rt.laplacian_2d(12)
    d, i, p = A.numpy_triplet()
    i32 = i.astype(np.int32)
    agg = torch_agg._aggregate(
        torch_agg.strength_connect(torch_agg._scipy(A)), "greedy", 0)
    for a, b in zip(jax_native.sa_galerkin(p, i, d, agg, agg.max() + 1,
                                           0.08, 2 / 3, True),
                    native.sa_galerkin(p, i, d, agg, agg.max() + 1, 0.08,
                                       2 / 3, True)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(jax_native.spgemm(p, i, d, p, i, d, A.shape[1]),
                    native.spgemm(p, i, d, p, i, d, A.shape[1])):
        np.testing.assert_array_equal(a, b)
    import scipy.sparse as sp

    low = sp.tril(sp.csr_matrix((d, i, p), shape=A.shape)).tocsr()
    for fn, (dd, ii, pp) in (("ilu0_inplace", (d, i32, p)),
                             ("ic0_inplace", (low.data, low.indices,
                                              low.indptr.astype(np.int64)))):
        dj, dt = dd.copy(), dd.copy()
        getattr(jax_native, fn)(pp, ii, dj)
        getattr(native, fn)(pp, ii, dt)
        np.testing.assert_array_equal(dj, dt)
    for a, b in zip(jax_native.ilut(p, i32, d.copy(), 1e-3, 5),
                    native.ilut(p, i32, d.copy(), 1e-3, 5)):
        np.testing.assert_array_equal(a, b)
    header = "%%MatrixMarket matrix coordinate real general\n3 3 3\n"
    path = tmp_path / "m.mtx"
    path.write_text(header + "1 1 2.5\n2 3 -1\n3 2 4e-3\n")
    for a, b in zip(jax_native.mtx_body(str(path), len(header), 3, 3)[:3],
                    native.mtx_body(str(path), len(header), 3, 3)[:3]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- level builders

LEVELS = {
    "sa": ("sa_level", {}),
    "sa_pmis": ("sa_level", {"strategy": "pmis", "seed": 3}),
    "ua": ("ua_level", {"over_interp": 1.5}),
    "pairwise": ("pairwise_level", {}),
}


@pytest.mark.parametrize("kind", sorted(LEVELS))
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_level_builders_match_jax(built, name, kind):
    Aj, At, _, _ = built[name]
    fn, kw = LEVELS[kind]
    outj = getattr(jax_agg, fn)(Aj, **kw)
    outt = getattr(torch_agg, fn)(At, **kw)
    for what, Mj, Mt in zip("PRA", outj, outt):
        _triplets_equal(Mj, Mt, f"{kind} {what}")
        assert Mt.device == torch.device("cpu")     # host-resident


def test_sa_level_without_the_native_layer_matches_jax(built, monkeypatch):
    """The numpy fallbacks (Python greedy sweep, scipy SpGEMM) on both
    sides, and the generic SA path for rows without a stored diagonal."""
    Aj, At, _, _ = built["lap2d_24"]
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    for Mj, Mt in zip(jax_agg.sa_level(Aj), torch_agg.sa_level(At)):
        _triplets_equal(Mj, Mt)
    d, i, p = At.numpy_triplet()
    keep = np.flatnonzero(~((i == At.numpy_rows()) & (At.numpy_rows() == 5)))
    rows = At.numpy_rows()[keep]
    Bj = jrt.CSR.from_coo(rows, i[keep], d[keep], At.shape)
    Bt = rt.CSR.from_coo(rows, i[keep], d[keep], At.shape)
    for Mj, Mt in zip(jax_agg.sa_level(Bj), torch_agg.sa_level(Bt)):
        _triplets_equal(Mj, Mt)


def test_pmis_aggregate_matches_jax(built):
    _, At, _, _ = built["lap3d_12"]
    C = torch_agg.strength_connect(torch_agg._scipy(At))
    for seed in (0, 7):
        np.testing.assert_array_equal(jax_agg.pmis_aggregate(C, seed),
                                      torch_agg.pmis_aggregate(C, seed))


@pytest.mark.parametrize("kind,kw", [("sa", {}), ("sa", {"eps": 0.04}),
                                     ("ua", {}), ("pairwise", {})])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_hierarchy_level_sizes_match_jax(built, name, kind, kw):
    """amg_hierarchy: eps halves per level and the seed follows the level,
    so every level of every kind is equal, not only the first."""
    Aj, At, hj, ht = built[name]
    if kind != "sa" or kw:
        hj = jmg.amg_hierarchy(Aj, kind, coarse_size=COARSE, **kw)
        ht = tmg.amg_hierarchy(At, kind, coarse_size=COARSE, **kw)
    assert ht.operator_sizes() == hj.operator_sizes()
    assert ht.num_levels >= 3
    for lj, lt in zip(hj.levels, ht.levels):
        for what in "APR":
            if getattr(lj, what) is not None:
                _triplets_equal(getattr(lj, what), getattr(lt, what), what)


def test_rs_is_not_ported_yet():
    """Ruge-Stüben AMG was the kind this slice left out; it is ported now
    (tests/test_torch_rsamg.py holds it to the JAX package), and
    amg_hierarchy builds the JAX package's levels for kind="rs"."""
    hj = jmg.amg_hierarchy(jrt.laplacian_2d(8), "rs", coarse_size=10)
    ht = tmg.amg_hierarchy(rt.laplacian_2d(8), "rs", coarse_size=10)
    assert ht.operator_sizes() == hj.operator_sizes()
    assert ht.num_levels >= 2


# ----------------------------------------------------------------- SpGEMM

def test_spgemm_and_triple_product_match_jax(built):
    Aj, At, hj, ht = built["lap3d_12"]
    Pj, Rj, Pt, Rt = hj.levels[0].P, hj.levels[0].R, ht.levels[0].P, \
        ht.levels[0].R
    for Cj, Ct in ((jax_spgemm.spgemm(Aj, Pj), spgemm.spgemm(At, Pt)),
                   (jax_spgemm.triple_product(Rj, Aj, Pj),
                    spgemm.triple_product(Rt, At, Pt)),
                   (jax_spgemm.spgeam(Aj, Aj, 2.0, -0.5),
                    spgemm.spgeam(At, At, 2.0, -0.5)),
                   (jax_spgemm.transpose(Pj), spgemm.transpose(Pt))):
        dj, ij, pj = Cj.numpy_triplet()
        dt, it, pt = Ct.numpy_triplet()
        np.testing.assert_array_equal(ij, it)
        np.testing.assert_array_equal(pj, pt)
        np.testing.assert_allclose(dt, dj, rtol=1e-13)
    Cj, upd_j = jax_spgemm.triple_product_plan(Rj, Aj, Pj)
    Ct, upd_t = spgemm.triple_product_plan(Rt, At, Pt)
    _triplets_equal(Cj, Ct)
    scale = 1.0 + np.random.default_rng(2).random(At.nnz)
    new_j = np.asarray(upd_j(jnp.asarray(Aj.numpy_triplet()[0] * scale)))
    new_t = upd_t(torch.from_numpy(At.numpy_triplet()[0] * scale))
    _close(new_t, new_j, 1e-13)


# ----------------------------------------------------------------- cycles

CYCLES = {
    "V": {}, "W": {"cycle": "W"}, "F": {"cycle": "F"}, "K": {"cycle": "K"},
    "V_scaling": {"scaling": True}, "W_host_levels": {"cycle": "W",
                                                      "host_levels": 1},
}


@pytest.mark.parametrize("opts", sorted(CYCLES))
def test_cycle_application_matches_jax(built, opts):
    """One application of each cycle on the 3D hierarchy (the 2D one is
    cycled by the CG and mg_solve tests)."""
    _, At, hj, ht = built["lap3d_12"]
    b = np.random.default_rng(5).standard_normal(At.shape[0])
    ej = jmg.cycle_closure(hj.with_options(**CYCLES[opts]))(jnp.asarray(b))
    et = tmg.cycle_closure(ht.with_options(**CYCLES[opts]))(
        torch.from_numpy(b))
    _close(et, ej, 1e-12)


def test_cg_saamg_matches_jax():
    """CG + SA-AMG (coarse_size 300) on laplacian_2d(32), f64."""
    Aj, At = jrt.laplacian_2d(32), rt.laplacian_2d(32)
    b = _rhs(At)
    kw = dict(rel_tol=1e-10, max_iter=100, record_history=True)
    xj, ij = jrt.cg(Aj, b, M=jmg.amg_precond(Aj), **kw)
    xt, it = rt.cg(At, torch.from_numpy(b), M=tmg.amg_precond(At),
                   check_every=4, **kw)
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status) == 2
    hj, ht = np.asarray(ij.history), it.history.numpy()
    keep = ~np.isnan(hj)
    assert np.array_equal(keep, ~np.isnan(ht))
    _histories_close(ht[keep], hj[keep])
    _close(xt, xj, 1e-10)


def test_mg_solve_and_fixed_point_match_jax(built):
    Aj, At, hj, ht = built["lap2d_24"]
    b = _rhs(At)
    kw = dict(rel_tol=1e-9, max_iter=60, record_history=True)
    for (xj, ij), (xt, it) in (
            (jmg.mg_solve(hj, b, **kw),
             tmg.mg_solve(ht, torch.from_numpy(b), check_every=8, **kw)),
            (jrt.fixed_point(Aj, b, M=jrt.jacobi(Aj), omega=0.8, **kw),
             rt.fixed_point(At, torch.from_numpy(b), M=rt.jacobi(At),
                            omega=0.8, **kw))):
        assert int(it.iterations) == int(ij.iterations)
        assert int(it.status) == int(ij.status)
        keep = ~np.isnan(np.asarray(ij.history))
        _histories_close(it.history.numpy()[keep],
                         np.asarray(ij.history)[keep])
        _close(xt, xj, 1e-10)
    x0 = np.zeros_like(b)
    _close(rt.fixed_point_sweeps(At, torch.from_numpy(b),
                                 torch.from_numpy(x0), M=rt.jacobi(At),
                                 sweeps=3, omega=0.7),
           jrt.fixed_point_sweeps(Aj, jnp.asarray(b), jnp.asarray(x0),
                                  M=jrt.jacobi(Aj), sweeps=3, omega=0.7),
           1e-13)


def test_direct_solvers_match_jax():
    """qr, inversion and lu; the port's lu factors f64 natively where the
    JAX package factors in f32 and refines: solutions within rtol 1e-10."""
    Aj, At = jrt.laplacian_2d(9), rt.laplacian_2d(9)
    b = np.random.default_rng(4).standard_normal(At.shape[0])
    for fn in ("qr", "inversion", "lu"):
        xj, ij = getattr(jax_direct, fn)(Aj, jnp.asarray(b))
        xt, it = getattr(rt, fn)(At, torch.from_numpy(b))
        _close(xt, xj, 1e-10)
        assert int(it.status) == int(ij.status) == 1
        assert float(it.final_res) < 1e-12 * np.linalg.norm(b)
    B = np.random.default_rng(4).standard_normal((At.shape[0], 3))
    for make in (rt.qr_factor, rt.lu_factor):
        _close(make(At)(torch.from_numpy(B)),
               jax_direct.qr_factor(Aj)(jnp.asarray(B)), 1e-10)


@pytest.mark.parametrize("with_plans", [False, True])
def test_rebuild_hierarchy_numeric_matches_jax(built, with_plans):
    Aj, At, hj, ht = built["lap3d_12"]
    d, i, p = At.numpy_triplet()
    d2 = d * (1.0 + 0.1 * np.random.default_rng(3).random(len(d)))
    Bj = jrt.CSR.from_arrays(d2, i, p, At.shape)
    Bt = rt.CSR.from_arrays(d2, i, p, At.shape)
    pj = jmg.make_galerkin_plans(hj) if with_plans else None
    pt = tmg.make_galerkin_plans(ht) if with_plans else None
    rj = jmg.rebuild_hierarchy_numeric(hj, Bj, plans=pj)
    rt_ = tmg.rebuild_hierarchy_numeric(ht, Bt, plans=pt)
    assert rt_.operator_sizes() == rj.operator_sizes()
    for lj, lt in zip(rj.levels[1:], rt_.levels[1:]):
        _close(lt.A.data, lj.A.data, 1e-13)
        if with_plans:      # values computed where the fine values lie
            assert not getattr(lt.A, "_host_cache", None)
        else:
            _triplets_equal(lj.A, lt.A)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        At.shape[0]))
    assert torch.isfinite(tmg.cycle_closure(rt_)(b)).all()


def test_f32_hierarchy_converges_like_jax(built):
    """convert_hierarchy(dtype=float32): the bench's recipe (fine level to
    DIA, the rest cast), CG rel_tol 1e-6, within 2 iterations."""
    Aj, At, hj, ht = built["lap2d_24"]
    b = _rhs(At).astype(np.float32)
    h32j = jmg.convert_hierarchy(hj, dtype=np.float32)
    h32t = tmg.convert_hierarchy(ht, dtype=np.float32)
    assert [type(lv.A).__name__ for lv in h32t.levels] == \
        [type(lv.A).__name__ for lv in h32j.levels]
    _, ij = jrt.cg(h32j.levels[0].A, b, M=jmg.cycle_closure(h32j),
                   rel_tol=1e-6, max_iter=100)
    xt, it = rt.cg(h32t.levels[0].A, torch.from_numpy(b),
                   M=tmg.cycle_closure(h32t), rel_tol=1e-6, max_iter=100,
                   check_every=4)
    assert int(ij.status) == int(it.status) == 2
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert xt.dtype == torch.float32
    assert float((xt.double() - 1).abs().max()) < 1e-3


def test_bench_65k_row():
    """bench.py's cg_saamg section: laplacian_2d(256) f64 host setup,
    convert_hierarchy(dtype=float32), CG rel_tol 1e-6. The level sizes
    equal the JAX host setup's; BENCH_r05.json records 6 iterations."""
    Aj, At = jrt.laplacian_2d(256), rt.laplacian_2d(256)
    hj = jmg.amg_hierarchy(Aj, "sa", coarse_size=300)
    ht = tmg.amg_hierarchy(At, "sa", coarse_size=300)
    assert ht.operator_sizes() == hj.operator_sizes()
    h32 = tmg.convert_hierarchy(ht, dtype=np.float32)
    b = torch.from_numpy(_rhs(At).astype(np.float32))
    x, info = rt.cg(h32.levels[0].A, b, M=tmg.cycle_closure(h32),
                    rel_tol=1e-6, max_iter=200, check_every=4)
    assert int(info.status) == 2
    assert int(info.iterations) == 6


# -------------------------------------------------------------- placement

def _places(h):
    for lv in h.levels:
        yield lv.A
        for M in (lv.P, lv.R):
            if M is not None:
                yield M
        if lv.smooth is not None and hasattr(lv.smooth, "inv_d"):
            yield lv.smooth.inv_d


def test_setup_levels_stay_on_the_host_until_placed(built):
    """amg_hierarchy leaves the levels it makes host-resident; placing the
    hierarchy puts every level, transfer and smoother vector on the fine
    operator's device, once: a second placement reuses the same copies."""
    _, At, _, ht = built["lap3d_12"]
    assert all(M.device == torch.device("cpu") for M in _places(ht))
    meta = torch.device("meta")
    Am = rt.CSR.from_arrays(*At.numpy_triplet(), At.shape, device=meta)
    hm = tmg.amg_hierarchy(Am, "sa", coarse_size=100)
    assert hm.operator_sizes() == ht.operator_sizes()
    assert all(lv.A.device == torch.device("cpu") for lv in hm.levels[1:])
    placed = tmg.place_hierarchy(hm)
    assert all(M.device == meta for M in _places(placed))
    again = tmg.place_hierarchy(hm)
    for l1, l2 in zip(placed.levels[1:], again.levels[1:]):
        assert l1.A is l2.A and l1.R is l2.R
    assert placed.coarse_solve._A is placed.levels[-1].A
    M = tmg.cycle_closure(ht)
    assert M.hierarchy.levels[0].A is At
    assert all(x.device == At.device for x in _places(M.hierarchy))


def test_cast_and_convert_keep_each_operator_where_it_is(built):
    _, At, _, ht = built["lap2d_24"]
    meta = torch.device("meta")
    Am = rt.CSR.from_arrays(*At.numpy_triplet(), At.shape, device=meta)
    C = rt.cast_values(Am, np.float32)
    assert C.device == meta and C.dtype == torch.float32
    np.testing.assert_array_equal(C.numpy_triplet()[0],
                                  At.numpy_triplet()[0].astype(np.float32))
    assert Am.transpose_host().device == meta
    assert rt.cast_values(At, np.float32).device == torch.device("cpu")
    h32 = tmg.convert_hierarchy(ht, dtype=np.float32)
    assert h32.levels[0].A.device == At.device
    assert all(lv.A.dtype == torch.float32 for lv in h32.levels)


def test_rebuilt_levels_get_a_plan_where_wjd_applies():
    """Levels that a planned numeric rebuild computes carry no host arrays;
    where auto_wjd applies (the card by default, forced here), the cycle
    closure reads their triplets back once and plans each of them, and the
    cycle gives the result of the plain applies."""
    At = rt.laplacian_3d(10)
    h = tmg.amg_hierarchy(At, "sa", coarse_size=100)
    plans = tmg.make_galerkin_plans(h)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        At.shape[0]))
    plain = tmg.cycle_closure(
        tmg.rebuild_hierarchy_numeric(h, At, plans=plans))(b)
    fresh = tmg.rebuild_hierarchy_numeric(
        h, rt.CSR.from_arrays(*At.numpy_triplet(), At.shape), plans=plans)
    assert not getattr(fresh.levels[1].A, "_host_cache", None)
    rt.set_auto_wjd(True)
    try:
        M = tmg.cycle_closure(fresh)
    finally:
        rt.set_auto_wjd(None)
    for M_ in _places(M.hierarchy):
        if isinstance(M_, rt.CSR):
            assert M_._wjd_cache is not None
    _close(M(b), plain, 1e-12)
