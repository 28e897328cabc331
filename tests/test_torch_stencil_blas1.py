"""Port parity: matrix-free stencils, spmv_add, BLAS-1 and the generators.

The same seeded numpy inputs go through the JAX package and the port:

* `Stencil` applies (2-D and 3-D Laplace stencils, x of shape (n,) and
  (n, k)) equal the JAX package's to 1e-14 relative, its `to_csr` gives
  the JAX package's triplet bit for bit, and CG on a stencil takes the
  JAX package's status and count with its history within rtol 1e-10 (or
  100 times the port's own drift under a 1e-15 change of b, the rule of
  tests/test_torch_krylov.py: its last residual is at rounding level);
* `spmv_add` and every BLAS-1 operation of ops/blas1.py (real and
  complex operands) against the JAX package's at 1e-14 relative (exactly
  where the operation is exact); the random fills, which draw from
  torch's generator and cannot reproduce JAX's threefry, by determinism
  of the seed and by their moments;
* the five generators of this slice (anisotropic_laplacian_2d,
  permuted_identity, random_spd, laplacian_2d_block, laplacian_3d_block)
  bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu.ops.blas1 as jb
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.ops.blas1 as tb
from rocalution_tpu.utils import generators as jgen
from rocalution_tpu_torch.utils import generators as tgen
from test_torch_krylov import _assert_history_close
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-14


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


STENCILS = {"2d": ("laplace2d_stencil", "laplacian_2d", 13),
            "3d": ("laplace3d_stencil", "laplacian_3d", 6)}


@pytest.mark.parametrize("dim", sorted(STENCILS))
def test_stencil_apply_and_to_csr_match_jax(dim):
    make, gen, n = STENCILS[dim]
    Sj, St = getattr(jrt, make)(n), getattr(rt, make)(n)
    assert St.shape == Sj.shape and St.nnz == Sj.nnz
    assert St.dtype == torch.float64
    rng = np.random.default_rng(3)
    N = St.shape[0]
    for shape in ((N,), (N, 3)):
        x = rng.standard_normal(shape)
        want = np.asarray(jrt.spmv(Sj, jnp.asarray(x)))
        _close(rt.spmv(St, torch.from_numpy(x)).numpy(), want)
        _close(rt.spmv(getattr(rt, gen)(n), torch.from_numpy(x)).numpy(),
               want)
    Cj, Ct = Sj.to_csr(), rt.to_csr(St)
    for a, b in zip(Cj.numpy_triplet(), Ct.numpy_triplet()):
        np.testing.assert_array_equal(b, a)
    assert rt.convert(St, "CSR").nnz == Ct.nnz
    x32 = rng.standard_normal(N).astype(np.float32)
    S32 = getattr(rt, make)(n, dtype=np.float32)
    _close(S32.apply(torch.from_numpy(x32)).numpy(),
           np.asarray(jrt.spmv(getattr(jrt, make)(n, dtype=np.float32),
                               jnp.asarray(x32))), rtol=1e-6)


def test_stencil_cg_matches_jax():
    Sj, St = jrt.laplace2d_stencil(12), rt.laplace2d_stencil(12)
    b = np.array(jrt.spmv(Sj, jnp.ones(144)))
    kw = dict(rel_tol=1e-10, max_iter=500, record_history=True)
    xj, ij = jrt.cg(Sj, jnp.asarray(b), **kw)
    xt, it = rt.cg(St, torch.from_numpy(b), **kw)
    _, ip = rt.cg(St, torch.from_numpy(b * (1 + 1e-15)), **kw)
    assert int(it.status) == int(ij.status) == 2
    assert int(it.iterations) == int(ij.iterations)
    _assert_history_close(np.asarray(ij.history), it.history.numpy(),
                          ip.history.numpy(), 1e-10)
    assert np.abs(xt.numpy() - 1.0).max() < 1e-8
    # Jacobi from the stencil's own diagonal: as on the assembled matrix
    from rocalution_tpu_torch.precond.jacobi import inverse_diagonal

    A = rt.laplacian_2d(12)
    assert torch.equal(inverse_diagonal(St), inverse_diagonal(A))
    _, i_s = rt.cg(St, torch.from_numpy(b), M=rt.jacobi(St), **kw)
    _, i_a = rt.cg(A, torch.from_numpy(b), M=rt.jacobi(A), **kw)
    assert int(i_s.iterations) == int(i_a.iterations)


def test_spmv_add_matches_jax():
    Aj, At = jrt.convection_diffusion_2d(9), rt.convection_diffusion_2d(9)
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal(81), rng.standard_normal(81)
    for alpha in (1.0, -0.5):
        want = jrt.spmv_add(Aj, jnp.asarray(x), jnp.asarray(y), alpha)
        got = rt.spmv_add(At, torch.from_numpy(x), torch.from_numpy(y),
                          alpha)
        _close(got.numpy(), want)
    S = rt.laplace3d_stencil(4)
    _close(rt.spmv_add(S, torch.from_numpy(x[:64]), torch.from_numpy(
        y[:64]), 2.0).numpy(), np.asarray(jrt.spmv_add(
            jrt.laplace3d_stencil(4), jnp.asarray(x[:64]),
            jnp.asarray(y[:64]), 2.0)))


def _vectors(kind):
    rng = np.random.default_rng(7)
    if kind == "real":
        return [rng.standard_normal(40) for _ in range(3)]
    return [rng.standard_normal(40) + 1j * rng.standard_normal(40)
            for _ in range(3)]


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_blas1_matches_jax(kind):
    x, y, z = _vectors(kind)
    J = [jnp.asarray(v) for v in (x, y, z)]
    T = [torch.from_numpy(v) for v in (x, y, z)]
    a, b, c = 0.75, -1.25, 2.0
    cases = {
        "dot": ((J[0], J[1]), (T[0], T[1])),
        "dot_nonconj": ((J[0], J[1]), (T[0], T[1])),
        "norm": ((J[0],), (T[0],)),
        "asum": ((J[0],), (T[0],)),
        "reduce_sum": ((J[0],), (T[0],)),
        "scale": ((J[0], a), (T[0], a)),
        "add_scale": ((J[0], J[1], a), (T[0], T[1], a)),
        "scale_add": ((J[0], J[1], a), (T[0], T[1], a)),
        "scale_add_scale": ((J[0], J[1], a, b), (T[0], T[1], a, b)),
        "scale_add2": ((*J, a, b, c), (*T, a, b, c)),
        "pointwise_mult": ((J[0], J[1]), (T[0], T[1])),
        "pointwise_mult_yz": ((*J,), (*T,)),
        "power": ((J[0], 3), (T[0], 3)),
        "inclusive_sum": ((J[0],), (T[0],)),
        "exclusive_sum": ((J[0],), (T[0],)),
        "sigma_norm": ((J[0], 0.5), (T[0], 0.5)),
    }
    for name, (ja, ta) in cases.items():
        fn = name.replace("_yz", "")
        _close(getattr(tb, fn)(*ta).numpy(), getattr(jb, fn)(*ja))
    ij, vj = jb.amax(J[0])
    it, vt = tb.amax(T[0])
    assert int(it) == int(ij) and complex(vt) == complex(vj)
    assert float(tb.amax_value(T[0])) == abs(complex(vj))
    rng = np.random.default_rng(8)
    perm = rng.permutation(40)
    idx = rng.integers(0, 40, 12)
    vals = rng.standard_normal(12).astype(x.dtype)
    for name, ja, ta in (
            ("permute", (J[0], jnp.asarray(perm)),
             (T[0], torch.from_numpy(perm))),
            ("permute_backward", (J[0], jnp.asarray(perm)),
             (T[0], torch.from_numpy(perm))),
            ("get_index_values", (J[0], jnp.asarray(idx)),
             (T[0], torch.from_numpy(idx))),
            ("set_index_values", (J[0], jnp.asarray(np.unique(idx)),
                                  jnp.asarray(vals[:len(np.unique(idx))])),
             (T[0], torch.from_numpy(np.unique(idx)),
              torch.from_numpy(vals[:len(np.unique(idx))]))),
            ("add_index_values", (J[0], jnp.asarray(idx), jnp.asarray(vals)),
             (T[0], torch.from_numpy(idx), torch.from_numpy(vals)))):
        _close(getattr(tb, name)(*ta).numpy(), getattr(jb, name)(*ja))
    assert torch.equal(tb.permute_backward(tb.permute(T[0], torch.from_numpy(
        perm)), torch.from_numpy(perm)), T[0])
    fmap = rng.integers(-1, 9, 40)
    _close(tb.restriction(T[0], torch.from_numpy(fmap), 9).numpy(),
           jb.restriction(J[0], jnp.asarray(fmap), 9))
    _close(tb.prolongation(T[1][:9], torch.from_numpy(fmap)).numpy(),
           jb.prolongation(J[1][:9], jnp.asarray(fmap)))


def test_random_fills_and_coarse_maps():
    """The fills: one seed, one draw, on any device and every call; within
    their moments; of the asked dtype. The coarse maps: as JAX's."""
    u = tb.set_random_uniform(0, 5000, low=2.0, high=3.0)
    assert u.dtype == torch.float64 and u.device.type == "cpu"
    assert torch.equal(u, tb.set_random_uniform(0, 5000, 2.0, 3.0,
                                                device="cpu"))
    assert not torch.equal(u, tb.set_random_uniform(1, 5000, 2.0, 3.0))
    assert bool((u >= 2.0).all()) and bool((u < 3.0).all())
    assert abs(float(u.mean()) - 2.5) < 0.05
    g = tb.set_random_normal(0, 5000, mean=1.0, std=2.0, dtype=np.float32)
    assert g.dtype == torch.float32
    assert torch.equal(g, tb.set_random_normal(0, 5000, 1.0, 2.0,
                                               dtype=torch.float32))
    assert abs(float(g.mean()) - 1.0) < 0.15
    assert abs(float(g.std()) - 2.0) < 0.15
    # the JAX fill's moments are the same law's
    import jax

    gj = np.asarray(jb.set_random_normal(jax.random.PRNGKey(0), 5000, 1.0,
                                         2.0))
    assert abs(gj.std() - float(g.std())) < 0.15
    agg = np.array([0, 0, 1, 2, 2, 3, 1, 3], np.int32)
    rng = np.random.default_rng(9)
    for _ in range(5):
        bnd = rng.integers(0, 8, rng.integers(1, 8))
        m_t, k_t = tb.extract_coarse_mapping(agg, bnd, 4)
        m_j, k_j = jb.extract_coarse_mapping(agg, bnd, 4)
        np.testing.assert_array_equal(m_t, m_j)
        assert k_t == k_j
        np.testing.assert_array_equal(tb.extract_coarse_boundary(agg, bnd, 4),
                                      jb.extract_coarse_boundary(agg, bnd, 4))


def test_generators_bit_for_bit():
    def same(a, b):
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)

    for dt in (np.float64, np.float32):
        for name, args in (("anisotropic_laplacian_2d", (11, 0.05)),
                           ("permuted_identity", (37, 3)),
                           ("random_spd", (45, 0.1, 2))):
            Aj = getattr(jgen, name)(*args, dtype=dt)
            At = getattr(tgen, name)(*args, dtype=dt)
            assert At.shape == Aj.shape
            same(Aj.numpy_triplet(), At.numpy_triplet())
            assert At.data.dtype == rt.config.torch_dtype(dt)
        same(jgen.laplacian_2d_block(9, 17, 50, dtype=dt),
             tgen.laplacian_2d_block(9, 17, 50, dtype=dt))
        same(jgen.laplacian_3d_block(5, 30, 77, dtype=dt),
             tgen.laplacian_3d_block(5, 30, 77, dtype=dt))
    assert rt.anisotropic_laplacian_2d(4).data.dtype == torch.float64
