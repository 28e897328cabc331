"""Port parity: the distributed layer (rocalution_tpu_torch/parallel).

The same host operators go through the JAX package's distributed layer
(rocalution_tpu/parallel, `shard_map` over 4 of the 8 virtual CPU devices
of tests/conftest.py) and the port's, whose parts all live in this
process (`make_comm`): the GlobalCSR arrays are equal (integers exactly,
values bit for bit) in both halo modes, for an uneven partition and for a
rectangular operator; the stacked interior plans equal JAX `stack_wjd`'s
arrays (f64 as the exact hi + lo sum); `shard_spmv` agrees with JAX's to
1e-14; the nine Krylov solvers of tests/test_parallel.py give JAX's
status and count through `dist_solve`, with residual histories within
1e-12 relative wherever the solve is reproducible to that level (the BiCG
family amplifies rounding: there the bound is 100 times the port's own
drift under a 1e-15 change of b, as in test_torch_krylov.py); BlockJacobi
with its four local kinds gives JAX's status and count; a JAX GlobalCSR
carried across (`interop.global_csr_from_numpy`) applies as the port's
own; and the per-rank global files are the JAX package's byte for byte
and read across. With a 1 KiB X_VMEM_BUDGET the windowed branch of the
stacked planner gives JAX `stack_wjd`'s arrays and windows, and its
distributed apply JAX's, in roll f64, roll f32 and gather f32.

The JAX side runs under one `jax.jit` a call: its eager `shard_map`
compiles every primitive on its own (~8 s a solve, ~4 s an apply).
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import rocalution_tpu as jrt
import rocalution_tpu.parallel as jpar
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.parallel as tpar
from rocalution_tpu_torch.parallel.partition import ARRAY_FIELDS
from test_torch_cg import one_tile_steps  # noqa: F401
from test_torch_io import fixed_zip_time  # noqa: F401
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NP = 4
SOLVERS = ("cg", "cr", "fcg", "bicgstab", "bicgstabl", "gmres", "fgmres",
           "idr", "qmrcgstab")
# their histories amplify rounding (test_torch_krylov.py)
BICG = ("bicgstab", "bicgstabl", "idr", "qmrcgstab")
HIST_RTOL = 1e-12
NUDGE = 1e-15
DRIFT_FACTOR = 100.0
SOLVE_KW = dict(rel_tol=1e-8, max_iter=2000, record_history=True)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _port_csr(Aj):
    """The port's CSR of a JAX CSR's host triplet."""
    return rt.CSR.from_arrays(*Aj.numpy_triplet(), Aj.shape)


def _rect_operator():
    from rocalution_tpu.solvers.multigrid.aggregation import sa_level

    Pm, _, _ = sa_level(jrt.laplacian_2d(12))
    return Pm


OPERATORS = {
    # (JAX operator, parts, max_neighbor_shifts, expected mode)
    "lap2d_12_ppermute": (lambda: jrt.laplacian_2d(12), NP, 6, "ppermute"),
    "lap2d_12_allgather": (lambda: jrt.laplacian_2d(12), NP, 0,
                           "allgather"),
    "lap2d_10_uneven_8": (lambda: jrt.laplacian_2d(10), 8, 6, "ppermute"),
    "sa_prolongation": (_rect_operator, NP, 6, None),
}


def _jax_apply(Gj, x):
    """JAX shard_spmv over the mesh of Gj.nparts virtual devices."""
    nloc = Gj.n_local_col or Gj.n_local
    xp = jpar.distribute_vector(x, Gj.nparts, nloc)
    fn = jax.jit(jax.shard_map(
        lambda A, xs: jpar.shard_spmv(A, xs[0], "p")[None],
        mesh=jpar.make_mesh(Gj.nparts),
        in_specs=(jax.tree.map(lambda _: JP("p"), Gj), JP("p")),
        out_specs=JP("p"), check_vma=False))
    return np.asarray(jpar.gather_vector(fn(Gj, xp), Gj.n_global))


def _port_apply(Gt, x):
    nloc = Gt.n_local_col or Gt.n_local
    xp = tpar.distribute_vector(x, Gt.nparts, nloc)
    return tpar.gather_vector(
        tpar.shard_spmv(Gt, xp, tpar.make_comm(Gt.nparts)),
        Gt.n_global).numpy()


def _assert_global_equal(Gj, Gt):
    for key in ARRAY_FIELDS:
        a, b = np.asarray(getattr(Gj, key)), getattr(Gt, key).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("nparts", "n_local", "n_global", "shape", "n_local_col",
                "n_global_col", "shifts", "mode", "int_nnz"):
        assert getattr(Gj, key) == getattr(Gt, key), key


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_global_csr_equals_jax(name):
    make, parts, shifts, mode = OPERATORS[name]
    Aj = make()
    Gj = jpar.distribute_csr(Aj, parts, max_neighbor_shifts=shifts)
    Gt = tpar.distribute_csr(_port_csr(Aj), parts,
                             max_neighbor_shifts=shifts)
    assert Gt.int_wjd is None            # the CPU's auto rule: no plans
    if mode is not None:
        assert Gt.mode == mode
    _assert_global_equal(Gj, Gt)
    assert Gt.nnz == Gj.nnz
    x = np.random.default_rng(7).standard_normal(Aj.shape[1])
    y = _port_apply(Gt, x)
    np.testing.assert_allclose(y, _jax_apply(Gj, x), rtol=0, atol=1e-14)


def _stacked_plan_equal(Wj, St):
    """JAX's stacked WJD against the port's per-part plans, stacked."""
    lo = Wj.data_lo
    data = np.asarray(Wj.data)
    if lo is not None:
        # the JAX pair holds 48 of the 53 bits: hi + lo to 2^-47
        np.testing.assert_allclose(
            St.stacked("data").numpy(),
            data.astype(np.float64) + np.asarray(lo).astype(np.float64),
            rtol=2.0 ** -47, atol=0)
    else:
        np.testing.assert_array_equal(St.stacked("data").numpy(), data)
    for key in ("uloc", "brow", "diag_u", "win_base", "spill_row",
                "spill_col", "spill_val"):
        a, b = getattr(Wj, key), St.stacked(key)
        assert (a is None) == (b is None), key
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("shape", "pad_lo", "xp_len", "group", "wlog", "win_rows",
                "kernel_mode"):
        assert all(getattr(Wj, key) == getattr(w, key) for w in St.parts), key
    assert Wj.nnz == St.nnz


@pytest.mark.parametrize("case", ["lap2d_64_f64_roll",
                                  "randband_4096_f32_gather"])
def test_stack_wjd_equals_jax(case, one_tile_steps):  # noqa: F811
    if case.startswith("lap"):
        Aj = jrt.laplacian_2d(64)
    else:
        Aj = jrt.random_banded_spd(4096, bandwidth=512, dtype=np.float32)
    Gj = jpar.distribute_csr(Aj, NP, wjd=True)
    Gt = tpar.distribute_csr(_port_csr(Aj), NP, wjd=True)
    _assert_global_equal(Gj, Gt)
    assert Gt.int_wjd.kernel_mode == case.split("_")[-1]
    _stacked_plan_equal(Gj.int_wjd, Gt.int_wjd)
    # each part's plain product is its interior's, and the planned
    # operator applies as JAX's does through its kernel
    x = np.random.default_rng(3).standard_normal(Aj.shape[0]).astype(
        np.asarray(Aj.numpy_triplet()[0]).dtype)
    tol = 1e-12 if Gt.dtype == torch.float64 else 1e-5
    y = _port_apply(Gt, x)
    y_plain = _port_apply(tpar.distribute_csr(_port_csr(Aj), NP, wjd=False),
                          x)
    scale = np.abs(y_plain).max()
    assert np.abs(y - y_plain).max() <= tol * scale
    assert np.abs(y - _jax_apply(Gj, x)).max() <= tol * scale


WINDOWED = {
    # operator over NP parts (several tiles, so several windows, a part)
    "lap2d_128_f64_roll": lambda: jrt.laplacian_2d(128),
    "lap2d_128_f32_roll": lambda: jrt.laplacian_2d(128, dtype=np.float32),
    "randband_8192_f32_gather": lambda: jrt.random_banded_spd(
        8192, bandwidth=512, dtype=np.float32),
}


@pytest.mark.parametrize("case", sorted(WINDOWED))
def test_windowed_stack_wjd_equals_jax(case, monkeypatch):
    """The windowed branch of the stacked planner: with a 1 KiB budget
    (tests/test_torch_wjd_window.py) every part's x plane passes
    X_VMEM_BUDGET, so both planners group by the windowed rule and give
    each grid step a window on the unified grouping. The stacked arrays,
    `win_base` and `win_rows` included, are JAX `stack_wjd`'s; each part
    is in the windowed regime (a gather part with the window-relative
    compact form); one distributed apply equals JAX's under one
    `jax.jit(shard_map)` and the port's plain interior apply (rtol 1e-12
    in f64, 1e-5 in f32)."""
    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "X_VMEM_BUDGET", 1024)
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)
        monkeypatch.setattr(mod, "_auto_group_windowed", lambda K: 1)
    Aj = WINDOWED[case]()
    Gj = jpar.distribute_csr(Aj, NP, wjd=True)
    Gt = tpar.distribute_csr(_port_csr(Aj), NP, wjd=True)
    _assert_global_equal(Gj, Gt)
    W = Gt.int_wjd
    assert W.kernel_mode == case.split("_")[-1]
    assert Gj.int_wjd.win_base is not None and W.parts[0].win_rows > 0
    _stacked_plan_equal(Gj.int_wjd, W)
    for Wq in W.parts:
        assert torch_wjd.windowed(Wq, Wq.dtype)
        assert len(Wq.win_base) > 1
        if W.kernel_mode == "gather":
            assert Wq.window_relative
    x = np.random.default_rng(3).standard_normal(Aj.shape[0]).astype(
        np.asarray(Aj.numpy_triplet()[0]).dtype)
    rtol = 1e-12 if Gt.dtype == torch.float64 else 1e-5
    y = _port_apply(Gt, x)
    y_plain = _port_apply(tpar.distribute_csr(_port_csr(Aj), NP, wjd=False),
                          x)
    np.testing.assert_allclose(y, _jax_apply(Gj, x), rtol=rtol,
                               atol=rtol * np.abs(y_plain).max())
    np.testing.assert_allclose(y, y_plain, rtol=rtol,
                               atol=rtol * np.abs(y_plain).max())


@pytest.fixture(scope="module")
def problem():
    Aj = jrt.laplacian_2d(16)
    b = np.asarray(jrt.spmv(Aj, np.ones(Aj.shape[0])))
    return Aj, _port_csr(Aj), b


def _jax_dist_solve(solver, Gj, b, M, **kw):
    """JAX dist_solve under one jit (b closed over as host data)."""
    return jax.jit(lambda G, M: jpar.dist_solve(solver, G, b, M=M, **kw))(
        Gj, M)


def _drift_bound(hj, ht, hn, n):
    """Per entry: HIST_RTOL, or 100x the port's own drift up to there."""
    drift = np.maximum.accumulate(np.abs(hn[:n] - ht[:n])
                                  / np.abs(ht[:n]))
    return np.maximum(HIST_RTOL, DRIFT_FACTOR * drift)


def test_dist_solve_family_matches_jax(problem):
    Aj, At, b = problem
    Gj = jpar.distribute_csr(Aj, NP)
    Gt = tpar.distribute_csr(At, NP)
    Mj, Mt = jpar.block_jacobi_diag(Gj), tpar.block_jacobi_diag(Gt)
    np.testing.assert_array_equal(np.asarray(Mj), Mt.numpy())
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (Gt.n_local, 4), np.float64))
    for name in SOLVERS:
        xj, ij = _jax_dist_solve(getattr(jrt, name), Gj, b, Mj, **SOLVE_KW)
        kw = dict(SOLVE_KW, **({"shadow_draw": draw} if name == "idr"
                               else {}))
        xt, it = tpar.dist_solve(getattr(rt, name), Gt, b, M=Mt, **kw)
        n = int(ij.iterations) + 1
        assert (int(it.status), int(it.iterations)) == (
            int(ij.status), int(ij.iterations)), name
        hj, ht = np.asarray(ij.history)[:n], it.history.numpy()[:n]
        rel = np.abs(hj - ht) / np.abs(hj)
        if name in BICG:
            _, inudge = tpar.dist_solve(getattr(rt, name), Gt,
                                        b * (1 + NUDGE), M=Mt, **kw)
            bound = _drift_bound(hj, ht, inudge.history.numpy(), n)
        else:
            bound = HIST_RTOL
        assert (rel <= bound).all(), (name, rel.max())
        assert np.abs(xt.numpy() - 1.0).max() < 1e-5, name
        assert xt.shape == (Aj.shape[0],)


def test_block_jacobi_kinds_match_jax():
    """tests/test_parallel.py's BlockJacobi rows: spai and fsai with cg,
    ilu0 and ilut with fgmres, 8 parts."""
    Aj = jrt.laplacian_2d(32)
    b = np.asarray(jrt.spmv(Aj, np.ones(Aj.shape[0])))
    Gj = jpar.distribute_csr(Aj, 8)
    Gt = tpar.distribute_csr(_port_csr(Aj), 8)
    for kind, solver in (("spai", "cg"), ("fsai", "cg"), ("ilu0", "fgmres"),
                         ("ilut", "fgmres")):
        Mj = jpar.block_jacobi_precond(Gj, kind)
        Mt = tpar.block_jacobi_precond(Gt, kind)
        assert Mt.kind == Mj.kind
        for a, c in zip(Mj.arrays, Mt.arrays):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-14)
        kw = dict(rel_tol=1e-8, max_iter=2000)
        _, ij = jax.jit(lambda G, arrs, s=getattr(jrt, solver), k=Mj.kind:
                        jpar.dist_solve(s, G, b, M=jpar.ShardPrecond(arrs, k),
                                        **kw))(Gj, Mj.arrays)
        x, it = tpar.dist_solve(getattr(rt, solver), Gt, b, M=Mt, **kw)
        assert (int(it.status), int(it.iterations)) == (
            int(ij.status), int(ij.iterations)), kind
        assert np.linalg.norm(x.numpy() - 1.0) < 1e-5, kind


def test_global_csr_from_numpy_applies_as_jax(one_tile_steps):  # noqa: F811
    from rocalution_tpu_torch.interop import global_csr_from_numpy

    Aj = jrt.laplacian_2d(40)
    Gj = jpar.distribute_csr(Aj, NP, wjd=True)
    fields = {k: np.asarray(getattr(Gj, k)) for k in ARRAY_FIELDS}
    fields.update({k: getattr(Gj, k) for k in (
        "nparts", "n_local", "n_global", "shape", "n_local_col",
        "n_global_col", "shifts", "mode", "int_nnz")})
    fields["int_wjd"] = {k: (None if getattr(Gj.int_wjd, k) is None
                             else np.asarray(getattr(Gj.int_wjd, k))
                             if hasattr(getattr(Gj.int_wjd, k), "shape")
                             else getattr(Gj.int_wjd, k))
                         for k in Gj.int_wjd.__dataclass_fields__}
    Gt = global_csr_from_numpy(fields, device="cpu")
    _assert_global_equal(Gj, Gt)
    own = tpar.distribute_csr(_port_csr(Aj), NP, wjd=True)
    _stacked_plan_equal(Gj.int_wjd, Gt.int_wjd)
    assert [w.nnz for w in Gt.int_wjd.parts] == [
        w.nnz for w in own.int_wjd.parts]
    x = np.random.default_rng(5).standard_normal(Aj.shape[0])
    np.testing.assert_allclose(_port_apply(Gt, x), _port_apply(own, x),
                               rtol=0, atol=1e-13)


def test_global_io_files_equal_and_read_across(
        tmp_path, fixed_zip_time):  # noqa: F811
    import rocalution_tpu.io as jio

    Aj = jrt.laplacian_2d(12)
    Gj = jpar.distribute_csr(Aj, NP)
    Gt = tpar.distribute_csr(_port_csr(Aj), NP)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jio.write_global_csr(pj, Gj)
    rt.io.write_global_csr(pt, Gt)
    names = sorted(f[len("jax"):] for f in os.listdir(tmp_path)
                   if f.startswith("jax"))
    assert len(names) == 2 * NP + 1
    for suffix in names:
        with open(pj + suffix, "rb") as f, open(pt + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
    # each package reads the other's files
    _assert_global_equal(Gj, rt.io.read_global_csr(pj, device="cpu"))
    _assert_global_equal(jio.read_global_csr(pt), Gt)
    x = np.random.default_rng(1).standard_normal(Aj.shape[0])
    np.testing.assert_allclose(
        _port_apply(rt.io.read_global_csr(pj, device="cpu"), x),
        _port_apply(Gt, x), rtol=0, atol=0)
