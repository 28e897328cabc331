"""Port parity: matrix IO and the on-disk WJD plan cache.

Files written by the port equal the JAX package's byte for byte, and each
package reads the other's files to the same triplet: MatrixMarket
(rocalution_tpu_torch/io/mtx.py; every banner the JAX reader takes),
the package's binary container (io/binary.py; the zip members' times are
fixed while both write, since zipfile stamps the wall clock) and
rocsparseio (io/rocsparseio.py: CSX, MCSX, the dense vector, and COO and
column-direction objects assembled by hand). The repo's two MatrixMarket
fixtures and the byte-golden rocsparseio file read the same in both
packages, and the fixture solves (CG + IC(0), GMRES(30) + ILU(0)) reach
the JAX package's status and count. The plan cache: a hit equals the cold
plan, array for array, and a change of version or of an option plans
again; small plans, ``cache=False`` and ``ROCALUTION_TPU_TORCH_PLAN_CACHE=0``
write nothing.
"""

import os
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu.io as jio
import rocalution_tpu.io.rocsparseio as jrsio
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu_torch.formats import wjd_cache
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture
def fixed_zip_time(monkeypatch):
    """zipfile stamps each member with the wall clock: fix it while both
    packages write, so that their files can be compared byte for byte."""
    import time

    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_triplet(a, b):
    """Two CSRs (either package) with equal shape and host triplets."""
    assert tuple(a.shape) == tuple(b.shape)
    for x, y in zip(a.numpy_triplet(), b.numpy_triplet()):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_mtx_files_equal_and_read_across(tmp_path):
    Aj = jrt.utils.generators.random_spd(30, density=0.1, seed=4)
    At = rt.utils.generators.random_spd(30, density=0.1, seed=4)
    pj, pt = str(tmp_path / "j.mtx"), str(tmp_path / "t.mtx")
    jio.write_mtx(pj, Aj)
    rt.io.write_mtx(pt, At)
    assert _bytes(pt) == _bytes(pj)
    _assert_same_triplet(rt.io.read_mtx(pj), jio.read_mtx(pt))
    _assert_same_triplet(rt.io.read_mtx(pt), At)


BANNERS = {
    "real symmetric": ("real symmetric", ["1 1 4.0", "2 1 -1.5", "3 3 2.0",
                                          "3 2 0.25"]),
    "skew": ("real skew-symmetric", ["2 1 1.5", "3 1 -2.0", "3 2 0.5"]),
    "hermitian": ("complex hermitian", ["1 1 3.0 0.0", "2 1 1.0 -2.0",
                                        "3 2 0.5 0.25", "3 3 1.0 0.0"]),
    "complex general": ("complex general", ["1 2 1.0 2.0", "3 1 -1.0 0.5"]),
    "pattern": ("pattern general", ["1 1", "2 3", "3 2"]),
    "integer": ("integer general", ["1 1 7", "2 2 -3", "3 1 2"]),
}


def test_mtx_banners_read_as_jax(tmp_path):
    """Every banner the JAX reader takes reads to the same triplet: the
    mirrored entries of symmetric, skew and Hermitian files, pattern ones,
    and a complex file as a complex128 CSR; and an array file as a
    vector."""
    for name, (banner, lines) in BANNERS.items():
        path = str(tmp_path / (name.replace(" ", "_") + ".mtx"))
        with open(path, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate {banner}\n% c\n")
            f.write(f"3 3 {len(lines)}\n" + "\n".join(lines) + "\n")
        At = rt.io.read_mtx(path)
        _assert_same_triplet(At, jio.read_mtx(path))
        if "complex" in banner:
            assert At.data.dtype == torch.complex128
    path = str(tmp_path / "v.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n4 1\n"
                "1.5\n-2\n3.25\n0\n")
    np.testing.assert_array_equal(rt.io.read_mtx_vector(path),
                                  jio.read_mtx_vector(path))


def test_binary_files_equal_and_read_across(tmp_path, fixed_zip_time):
    Aj, At = jrt.laplacian_2d(9), rt.laplacian_2d(9)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jio.write_csr(pj, Aj)
    rt.io.write_csr(pt, At)
    assert _bytes(pt + ".npz") == _bytes(pj + ".npz")
    _assert_same_triplet(rt.io.read_csr(pj), jio.read_csr(pt))
    _assert_same_triplet(rt.io.read_csr(pt + ".npz"), At)
    v = np.random.default_rng(2).standard_normal(64)
    for binary, suffix in ((True, ".npz"), (False, "")):
        jio.write_vector(str(tmp_path / "vj"), v, binary=binary)
        rt.io.write_vector(str(tmp_path / "vt"), torch.from_numpy(v),
                           binary=binary)
        assert _bytes(str(tmp_path / "vt") + suffix) == _bytes(
            str(tmp_path / "vj") + suffix)
        np.testing.assert_array_equal(
            rt.io.read_vector(str(tmp_path / "vj"), binary=binary),
            jio.read_vector(str(tmp_path / "vt"), binary=binary))


def _hand_built(path, kind):
    """A COO object or a column-direction CSX object of a known 3x4
    matrix, assembled with the JAX module's own primitives."""
    rows = np.array([0, 0, 2, 1], "<i4")
    cols = np.array([3, 0, 1, 2], "<i4")
    vals = np.array([1.5, -2.0, 0.5, 4.0], "<f8")
    with open(path, "wb") as f:
        f.write(jrsio._header_words())
        f.write(jrsio._name_field(kind))
        if kind == "coo":
            jrsio._write_u64(f, jrsio._FMT_SPARSE_COO, 3, 4, 4, 0, 0, 3, 1)
            for a in (rows + 1, cols + 1, vals):
                jrsio._write_array(f, a)
        else:
            import scipy.sparse as sp

            C = sp.csc_matrix((vals, (rows, cols)), shape=(3, 4))
            jrsio._write_u64(f, jrsio._FMT_SPARSE_CSX, 1, 3, 4, 4, 0, 0, 3,
                             0)
            for a in (C.indptr.astype("<i4"), C.indices.astype("<i4"),
                      C.data):
                jrsio._write_array(f, a)


def test_rocsparseio_files_equal_and_read_across(tmp_path):
    cases = {"f64": np.float64, "f32": np.float32}
    for tag, dt in cases.items():
        Aj, At = jrt.laplacian_2d(7, dtype=dt), rt.laplacian_2d(7, dtype=dt)
        pj, pt = str(tmp_path / f"j{tag}"), str(tmp_path / f"t{tag}")
        jio.write_rocsparseio(pj, Aj)
        rt.io.write_rocsparseio(pt, At)
        assert _bytes(pt) == _bytes(pj), tag
        _assert_same_triplet(rt.io.read_rocsparseio(pj),
                             jio.read_rocsparseio(pt))
    # complex values, and an MCSR as an MCSX object
    d, i, p = rt.laplacian_2d(5).numpy_triplet()
    dc = d + 0.5j * np.arange(len(d))
    Aj, At = jrt.CSR.from_arrays(dc, i, p, (25, 25)), rt.CSR.from_arrays(
        dc, i, p, (25, 25))
    for name, mj, mt in (("c128", Aj, At),
                         ("mcsx", jrt.convert(jrt.laplacian_2d(6), "MCSR"),
                          rt.convert(rt.laplacian_2d(6), "MCSR"))):
        pj, pt = str(tmp_path / f"j{name}"), str(tmp_path / f"t{name}")
        jio.write_rocsparseio(pj, mj)
        rt.io.write_rocsparseio(pt, mt)
        assert _bytes(pt) == _bytes(pj), name
        Bt, Bj = rt.io.read_rocsparseio(pj), jio.read_rocsparseio(pt)
        assert type(Bt).__name__ == type(Bj).__name__ == type(mt).__name__
        np.testing.assert_array_equal(Bt.to_dense().numpy(),
                                      np.asarray(Bj.to_dense()))
    for dt in (np.float64, np.float32, np.int32):
        v = (np.random.default_rng(1).standard_normal(257) * 100).astype(dt)
        pj, pt = str(tmp_path / "vj.dv"), str(tmp_path / "vt.dv")
        jio.write_vector_rocsparseio(pj, v)
        rt.io.write_vector_rocsparseio(pt, torch.from_numpy(v))
        assert _bytes(pt) == _bytes(pj)
        w = rt.io.read_vector_rocsparseio(pj)
        assert w.dtype == v.dtype
        np.testing.assert_array_equal(w, v)
    for kind in ("coo", "csc"):
        path = str(tmp_path / kind)
        _hand_built(path, kind)
        _assert_same_triplet(rt.io.read_rocsparseio(path),
                             jio.read_rocsparseio(path))


def test_fixtures_read_as_jax(tmp_path):
    for name in ("gr_30_30_like.mtx", "convdiff_24.mtx"):
        path = os.path.join(FIX, name)
        At = rt.io.read_mtx(path)
        _assert_same_triplet(At, jio.read_mtx(path))
    assert At.shape == (576, 576)
    assert rt.io.read_mtx(os.path.join(FIX, "gr_30_30_like.mtx")).nnz == 7744
    golden = os.path.join(FIX, "golden_csr.rocsparseio")
    G = rt.io.read_rocsparseio(golden)
    _assert_same_triplet(G, jio.read_rocsparseio(golden))
    d, i, p = G.numpy_triplet()
    assert G.shape == (4, 5)
    np.testing.assert_array_equal(p, [0, 2, 3, 3, 5])
    np.testing.assert_array_equal(i, [0, 3, 1, 2, 4])
    np.testing.assert_array_equal(d, [1.5, -2.0, 3.25, 0.5, 7.0])
    out = str(tmp_path / "g.rsio")
    rt.io.write_rocsparseio(out, G, name="golden")
    assert _bytes(out) == _bytes(golden)


FIXTURE_SOLVES = {
    "gr_30_30_like-cg-ic0": ("gr_30_30_like.mtx", "cg", "ic", {}),
    "convdiff_24-gmres-ilu0": ("convdiff_24.mtx", "gmres", "ilu",
                               {"basis_size": 30}),
}


@pytest.mark.parametrize("case", sorted(FIXTURE_SOLVES))
def test_fixture_solve_matches_jax(case):
    """File -> solve -> 1e-8, as tests/test_fixtures.py, through both
    packages: the same status and count."""
    name, solver, precond, kw = FIXTURE_SOLVES[case]
    path = os.path.join(FIX, name)
    kw = dict(kw, rel_tol=1e-8, max_iter=500)

    def make_m(mod, A):
        return mod.precond.ic(A) if precond == "ic" else mod.precond.ilu(
            A, 0)

    Aj = jio.read_mtx(path)
    b = np.array(jrt.spmv(Aj, np.ones(Aj.shape[0])))
    xj, info_j = getattr(jrt, solver)(Aj, jnp.asarray(b), M=make_m(jrt, Aj),
                                      **kw)
    At = rt.io.read_mtx(path)
    xt, info_t = getattr(rt, solver)(At, torch.from_numpy(b),
                                     M=make_m(rt, At), **kw)
    assert int(info_t.status) == int(info_j.status) == 2
    assert int(info_t.iterations) == int(info_j.iterations)
    r = b - rt.spmv(At, xt).numpy()
    assert np.linalg.norm(r) <= 1.1e-8 * np.linalg.norm(b)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-8)


def _plans_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_plan_cache_hit_equals_the_cold_plan(tmp_path, monkeypatch):
    """laplacian_2d(150), 112,000 entries: planned cold, then read back;
    with the planner's assembly made to fail, only a hit can answer. A
    complex operator's two planes go through the cache as one plan."""
    monkeypatch.setenv(wjd_cache.ENV, str(tmp_path))
    A = rt.laplacian_2d(150)
    trip = A.numpy_triplet()
    assert len(trip[0]) >= 100_000
    cold = torch_wjd.csr_to_wjd_plan(*trip, A.shape)
    assert len(os.listdir(tmp_path)) == 1
    Ac = rt.CSR.from_arrays(trip[0] * (1 + 0.5j), trip[1], trip[2], A.shape)
    Wc_cold = torch_wjd.from_csr(Ac)
    assert len(os.listdir(tmp_path)) == 2

    def no_planning(*args, **kwargs):
        raise AssertionError("planned again")

    monkeypatch.setattr(torch_wjd, "_assemble", no_planning)
    _plans_equal(cold, torch_wjd.csr_to_wjd_plan(*trip, A.shape))
    Wc = torch_wjd.from_csr(Ac)
    for plane in ("re", "im"):
        for f in ("data", "brow", "diag_u", "win_base"):
            torch.testing.assert_close(getattr(getattr(Wc, plane), f),
                                       getattr(getattr(Wc_cold, plane), f),
                                       rtol=0, atol=0)
    # another option or another version is another plan
    with pytest.raises(AssertionError, match="planned again"):
        torch_wjd.csr_to_wjd_plan(*trip, A.shape, kernel_mode="gather")
    key = wjd_cache.plan_key(trip[0], trip[1], trip[2], A.shape, {
        "wlog": "auto", "max_slots": 128, "kernel_mode": "auto",
        "values_dtype": None, "split_dia": False})
    assert wjd_cache.load_plan(key) is not None
    monkeypatch.setattr(wjd_cache, "PLAN_VERSION", wjd_cache.PLAN_VERSION + 1)
    assert wjd_cache.load_plan(key) is None           # the file's version
    with pytest.raises(AssertionError, match="planned again"):
        torch_wjd.csr_to_wjd_plan(*trip, A.shape)


def test_plan_cache_writes_only_what_it_should(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(wjd_cache.ENV)
    assert wjd_cache.cache_dir() == str(
        tmp_path / "home" / ".cache" / "rocalution_tpu_torch" / "wjd_plans")
    monkeypatch.setenv(wjd_cache.ENV, str(tmp_path / "c"))
    small = rt.laplacian_2d(40)                       # 7,840 entries
    torch_wjd.csr_to_wjd_plan(*small.numpy_triplet(), small.shape)
    big = rt.laplacian_2d(150)
    torch_wjd.csr_to_wjd_plan(*big.numpy_triplet(), big.shape, cache=False)
    assert not os.path.exists(tmp_path / "c")
    monkeypatch.setenv(wjd_cache.ENV, "0")
    assert wjd_cache.cache_dir() is None
    torch_wjd.csr_to_wjd_plan(*big.numpy_triplet(), big.shape)
    assert not os.path.exists(tmp_path / "c")
    assert not os.path.exists(tmp_path / "home")
