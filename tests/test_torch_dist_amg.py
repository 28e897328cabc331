"""Port parity: distributed AMG (rocalution_tpu_torch/parallel/amg_setup.py,
amg.py, matops.py).

The same per-part row blocks go through the JAX package's host setup
(rocalution_tpu/parallel/amg_setup.py) and the port's copy: each of the
four coarsening steps (SA, RS, UA, pairwise) gives the same P, R and
Galerkin product to 1e-12, `distributed_amg_setup` the same level sizes
and halo modes, and `global_transpose` / `global_triple_product` the same
GlobalCSR arrays. One `dist_amg_solve_sharded` and one `dist_amg_solve`
(the host hierarchy, distributed) give JAX's status and count; one
apply of the W, F and K cycles equals JAX's `dist_cycle_closure` on the
same residual to 1e-12, and each converges with no more iterations than
the V cycle, as the JAX package's tests/test_dist_amg_setup.py holds
JAX's.
The JAX solves run once each under `jax.jit` (its eager `shard_map`
compiles every primitive on its own), at 576 and 256 rows; the cycles
are held on the 576-row operator's four-level hierarchy.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import rocalution_tpu as jrt
import rocalution_tpu.parallel as jpar
import rocalution_tpu.parallel.amg_setup as jas
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.parallel as tpar
import rocalution_tpu_torch.parallel.amg_setup as tas
from rocalution_tpu_torch.parallel.partition import ARRAY_FIELDS
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NP = 4
N2 = 24                      # laplacian_2d(24): 576 rows


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _blocks(n, nparts):
    N = n * n
    offs = jas._offsets(nparts, N)
    return [rt.utils.generators.laplacian_2d_block(n, int(offs[q]),
                                                   int(offs[q + 1]))
            for q in range(nparts)], offs, N


def _mats(blocks, offs, N):
    return [sp.csr_matrix((d, (r, c)), shape=(int(offs[q + 1] - offs[q]), N))
            for q, (r, c, d) in enumerate(blocks)]


def _rhs(blocks, offs, N):
    b = np.zeros(N)
    for q, (r, _, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)        # b = A 1 from the blocks
    return b


def _same_mats(got, want, tag):
    assert len(got) == len(want), tag
    for q, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (tag, q)
        diff = (g - w).tocsr()
        scale = max(1.0, float(np.abs(w.data).max()) if w.nnz else 1.0)
        assert (np.abs(diff.data).max() if diff.nnz else 0.0) <= \
            1e-12 * scale, (tag, q)
        # the same pattern, stored zeros aside
        gp, wp = g.copy(), w.copy()
        gp.eliminate_zeros(), wp.eliminate_zeros()
        assert (gp != 0).sum() == (wp != 0).sum(), (tag, q)


@pytest.mark.parametrize("kind", ["sa", "rs", "ua", "pairwise"])
def test_level_coarsening_matches_jax(kind):
    blocks, offs, N = _blocks(16, NP)
    mats = _mats(blocks, offs, N)
    fn = {"sa": "dist_sa_level", "rs": "dist_rs_level",
          "ua": "dist_ua_level", "pairwise": "dist_pairwise_level"}[kind]
    kw = {"sa": {"strategy": "greedy"}, "ua": {"strategy": "greedy"}}.get(
        kind, {})
    Pj, Rj, Acj, cj = getattr(jas, fn)(mats, offs, **kw)
    Pt, Rt, Act, ct = getattr(tas, fn)(mats, offs, **kw)
    np.testing.assert_array_equal(cj, ct)
    _same_mats(Pt, Pj, "P")
    _same_mats(Rt, Rj, "R")
    _same_mats(Act, Acj, "Ac")


def _levels_equal(dj, dt):
    assert len(dj.As) == len(dt.As)
    for group in ("As", "Ps", "Rs"):
        for Gj, Gt in zip(getattr(dj, group), getattr(dt, group)):
            assert (Gj.shape, Gj.mode, Gj.shifts) == (Gt.shape, Gt.mode,
                                                      Gt.shifts), group
            for key in ARRAY_FIELDS:
                a, b = np.asarray(getattr(Gj, key)), getattr(Gt, key).numpy()
                assert a.shape == b.shape, (group, key)
                if np.issubdtype(a.dtype, np.floating):
                    np.testing.assert_allclose(b, a, rtol=1e-12,
                                               atol=1e-12, err_msg=key)
                else:
                    np.testing.assert_array_equal(b, a, err_msg=key)
    for a, b in zip(dj.inv_diags + (dj.coarse_inv_diag,),
                    dt.inv_diags + (dt.coarse_inv_diag,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)


@pytest.fixture(scope="module")
def setups():
    """The 576-row hierarchy of both packages (SA, greedy, 4 parts)."""
    blocks, offs, N = _blocks(N2, NP)
    kw = dict(coarse_size=60, strategy="greedy", wjd=False)
    dj = jpar.distributed_amg_setup(blocks, (N, N), **kw)
    dt = tpar.distributed_amg_setup(blocks, (N, N), **kw)
    return dj, dt, _rhs(blocks, offs, N)


@pytest.fixture(scope="module")
def deep_setups():
    """The same operator down to 10 rows: four levels, so that the W and F
    cycles nest below the first coarse level."""
    blocks, offs, N = _blocks(N2, NP)
    kw = dict(coarse_size=10, strategy="greedy", wjd=False)
    dj = jpar.distributed_amg_setup(blocks, (N, N), **kw)
    dt = tpar.distributed_amg_setup(blocks, (N, N), **kw)
    assert len(dt.As) == len(dj.As) == 4
    return dj, dt, _rhs(blocks, offs, N)


def test_distributed_amg_setup_levels_equal(setups):
    dj, dt, _ = setups
    assert [G.shape for G in dt.As] == [G.shape for G in dj.As]
    assert len(dt.As) >= 3
    _levels_equal(dj, dt)
    # RS: the sizes alone (its levels are held by the coarsening test)
    blocks, offs, N = _blocks(16, NP)
    rj = jpar.distributed_amg_setup(blocks, (N, N), kind="rs",
                                    coarse_size=30, wjd=False)
    rt_ = tpar.distributed_amg_setup(blocks, (N, N), kind="rs",
                                     coarse_size=30, wjd=False)
    assert [G.shape for G in rt_.As] == [G.shape for G in rj.As]


def test_global_transpose_and_triple_product_match_jax():
    from rocalution_tpu.solvers.multigrid.aggregation import sa_level

    Aj = jrt.laplacian_2d(12)
    Pj, Rj, _ = sa_level(Aj)

    def pair(M):
        return (jpar.distribute_csr(M, NP),
                tpar.distribute_csr(rt.CSR.from_arrays(
                    *M.numpy_triplet(), M.shape), NP))

    (Agj, Agt), (Pgj, Pgt), (Rgj, Rgt) = pair(Aj), pair(Pj), pair(Rj)
    for got, want in ((tpar.global_transpose(Pgt),
                       jpar.global_transpose(Pgj)),
                      (tpar.global_triple_product(Rgt, Agt, Pgt),
                       jpar.global_triple_product(Rgj, Agj, Pgj))):
        assert (got.shape, got.mode, got.shifts) == (want.shape, want.mode,
                                                     want.shifts)
        for key in ARRAY_FIELDS:
            a, b = np.asarray(getattr(want, key)), getattr(got, key).numpy()
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-13,
                                       err_msg=key)


def test_dist_amg_solve_sharded_matches_jax(setups):
    dj, dt, b = setups
    kw = dict(rel_tol=1e-8, max_iter=100)
    xj, ij = jax.jit(lambda dl: jpar.dist_amg_solve_sharded(
        jrt.cg, dl, b, **kw))(dj)
    xt, it = tpar.dist_amg_solve_sharded(rt.cg, dt, b, **kw)
    assert (int(it.status), int(it.iterations)) == (int(ij.status),
                                                    int(ij.iterations))
    assert np.linalg.norm(xt.numpy() - 1.0) < 1e-5
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)


def test_dist_amg_solve_host_hierarchy_matches_jax():
    """tests/test_parallel.py's dist_amg_solve row: the host hierarchy of
    laplacian_2d(16), SA, coarse_size 40, over 4 parts."""
    Aj = jrt.laplacian_2d(16)
    b = np.asarray(jrt.spmv(Aj, np.ones(Aj.shape[0])))
    At = rt.CSR.from_arrays(*Aj.numpy_triplet(), Aj.shape)
    kw = dict(amg_kwargs={"coarse_size": 40}, rel_tol=1e-10, max_iter=200)
    hj = jrt.solvers.multigrid.amg_hierarchy(Aj, "sa", coarse_size=40)
    dh = jpar.distribute_hierarchy(hj, NP)
    _, ij = jax.jit(lambda dh: _jax_host_amg(dh, b))(dh)
    xt, it = tpar.dist_amg_solve(rt.cg, At, b, NP, **kw)
    assert (int(it.status), int(it.iterations)) == (int(ij.status),
                                                    int(ij.iterations))
    assert np.linalg.norm(xt.numpy() - 1.0) < 1e-6


def _jax_host_amg(dh, b):
    """The body of JAX `dist_amg_solve` on a distributed hierarchy."""
    from jax.sharding import PartitionSpec as P

    from rocalution_tpu.parallel.amg import _dist_cycle
    from rocalution_tpu.parallel.solve import _info_struct

    Ag = dh.As[0]
    bp = jpar.distribute_vector(b, NP, Ag.n_local)

    def shard_fn(dh, b_l):
        x, info = jrt.cg(jpar.shard_operator(dh.As[0], "p"), b_l[0], None,
                         _dist_cycle(dh, "p"), axis_name="p",
                         rel_tol=1e-10, max_iter=200)
        return x[None], jax.tree.map(lambda v: v[None], info)

    fn = jax.shard_map(
        shard_fn, mesh=jpar.make_mesh(NP),
        in_specs=(jax.tree.map(lambda _: P("p"), dh), P("p")),
        out_specs=(P("p"), jax.tree.map(lambda _: P("p"), _info_struct())),
        check_vma=False)
    xp, info = fn(dh, bp)
    return xp, jax.tree.map(lambda v: v[0], info)


def _jax_cycle(dl, r, cycle):
    """One JAX `dist_cycle_closure` apply to the stacked r (P, n_local)."""
    from jax.sharding import PartitionSpec as P

    def shard_fn(dl, r_l):
        return jas.dist_cycle_closure(dl, "p", cycle=cycle)(r_l[0])[None]

    fn = jax.shard_map(
        shard_fn, mesh=jpar.make_mesh(NP),
        in_specs=(jax.tree.map(lambda _: P("p"), dl), P("p")),
        out_specs=P("p"), check_vma=False)
    return fn(dl, r)


@pytest.mark.parametrize("cycle", ["W", "F", "K"])
def test_dist_cycles_converge(deep_setups, cycle):
    """One apply of the cycle equals JAX's on the same residual (1e-12),
    and FCG through it converges in no more iterations than the V cycle."""
    dj, dt, b = deep_setups
    Ag = dt.As[0]
    r = np.random.default_rng(7).standard_normal(Ag.n_global)
    want = np.asarray(jax.jit(_jax_cycle, static_argnums=2)(
        dj, jpar.distribute_vector(r, NP, Ag.n_local), cycle))
    rp = tpar.distribute_vector(r, NP, Ag.n_local)
    got = tas.dist_cycle_closure(dt, tpar.StackedComm(NP), cycle=cycle)(
        rp.reshape(-1)).reshape(NP, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    kw = dict(rel_tol=1e-8, max_iter=100)
    x, info = tpar.dist_amg_solve_sharded(rt.fcg, dt, b, cycle=cycle, **kw)
    _, info_v = tpar.dist_amg_solve_sharded(rt.fcg, dt, b, cycle="V", **kw)
    assert int(info.status) in (1, 2), cycle
    assert np.linalg.norm(x.numpy() - 1.0) < 1e-5, cycle
    assert int(info.iterations) <= int(info_v.iterations), cycle
