"""Port parity: generators and the WJD host planner.

The same host triplets go through the JAX planner
(rocalution_tpu/formats/wjd.py) and the port's copy
(rocalution_tpu_torch/formats/wjd.py); every plan array must be equal.
The port stores f64 values as one native plane, so it is compared with
the JAX package's exact hi + lo pair.
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.formats.wjd import csr_to_wjd_plan as jax_plan
from rocalution_tpu_torch.formats.wjd import csr_to_wjd_plan as torch_plan
from rocalution_tpu_torch.formats.wjd import from_csr
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)

GENERATORS = {
    "lap2d_30": lambda m, dt: m.laplacian_2d(30, dtype=dt),
    "lap3d_12": lambda m, dt: m.laplacian_3d(12, dtype=dt),
    "randband_3000": lambda m, dt: m.random_banded_spd(
        3000, bandwidth=512, dtype=dt),
}
DTYPES = [np.float64, np.float32]


def _pair(name, dtype):
    return GENERATORS[name](jrt, dtype), GENERATORS[name](rt, dtype)


def _assert_plans_equal(pj, pt):
    lo = pj.pop("data_lo")
    if lo is not None:
        # the JAX pair is hi = f32(v), lo = f32(v - hi): 48 of the 53
        # significand bits, so it meets the port's native f64 plane to
        # 2^-47 relative (bit for bit for values such as 4.0 and -1.0)
        assert pt["data"].dtype == np.float64
        np.testing.assert_allclose(
            pt["data"], pj["data"].astype(np.float64) + lo,
            rtol=2.0 ** -47, atol=0)
        pj.pop("data"), pt.pop("data")
    assert set(pj) == set(pt)
    for key in pj:
        a, b = pj[key], pt[key]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), key
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_triplets_bit_identical(name, dtype):
    Aj, At = _pair(name, dtype)
    assert Aj.shape == At.shape
    for a, b in zip(Aj.numpy_triplet(), At.numpy_triplet()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert At.data.dtype == rt.config.torch_dtype(dtype)
    assert At.indices.dtype == torch.int32


def test_generators_default_to_f64():
    assert rt.laplacian_2d(4).data.dtype == torch.float64


@pytest.mark.parametrize("split_dia", ["auto", False])
@pytest.mark.parametrize("kernel_mode", ["auto", "roll", "gather"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_plan_arrays_equal(name, dtype, kernel_mode, split_dia):
    Aj, _ = _pair(name, dtype)
    d, i, p = Aj.numpy_triplet()
    kw = dict(kernel_mode=kernel_mode, split_dia=split_dia)
    _assert_plans_equal(jax_plan(d, i, p, Aj.shape, cache=False, **kw),
                        torch_plan(d, i, p, Aj.shape, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_plan_arrays_equal_with_spill(name, dtype):
    Aj, _ = _pair(name, dtype)
    d, i, p = Aj.numpy_triplet()
    pj = jax_plan(d, i, p, Aj.shape, cache=False, max_slots=2,
                  split_dia=False)
    pt = torch_plan(d, i, p, Aj.shape, max_slots=2, split_dia=False)
    assert len(pt["spill_row"]) > 0
    _assert_plans_equal(pj, pt)


@pytest.mark.parametrize("kernel_mode", ["roll", "gather"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_arrays_equal_in_the_windowed_regime(dtype, kernel_mode,
                                                  monkeypatch):
    """With the x budget set small, both planners size their groups for the
    windowed kernels: group, Tp, win_base and win_rows must be equal there
    too, not only in the resident regime."""
    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    Aj, _ = _pair("lap3d_12", dtype)
    d, i, p = Aj.numpy_triplet()
    kw = dict(kernel_mode=kernel_mode, split_dia=False)
    resident = torch_plan(d, i, p, Aj.shape, **kw)
    monkeypatch.setattr(jax_wjd, "X_VMEM_BUDGET", 1024)
    monkeypatch.setattr(torch_wjd, "X_VMEM_BUDGET", 1024)
    pj = jax_plan(d, i, p, Aj.shape, cache=False, **kw)
    pt = torch_plan(d, i, p, Aj.shape, **kw)
    assert pt["group"] > resident["group"]
    assert pt["win_base"] is not None and pt["win_rows"] > 0
    assert pt["data"].shape[0] == pt["group"] * len(pt["win_base"])
    _assert_plans_equal(pj, pt)


def test_plan_table_for_the_slice_operators():
    """The modes the slice's kernels serve (f64 roll/gather; f32 unsplit
    by the port's default, and under the reference's split rule)."""
    expect = {
        ("lap2d_30", np.float64, False): ("roll", (8, 5), 0),
        ("lap3d_12", np.float64, False): ("roll", (8, 7), 0),
        ("randband_3000", np.float64, False): ("gather", (4, 128), 0),
        ("lap3d_12", np.float32, False): ("roll", (8, 7), 0),
        ("lap3d_12", np.float32, "auto"): ("gather", (8, 1), 7),
    }
    for (name, dtype, split), (mode, shape, ndia) in expect.items():
        _, At = _pair(name, dtype)
        W = from_csr(At) if split is False else from_csr(At, split_dia=split)
        assert W.kernel_mode == mode
        assert tuple(W.brow.shape) == shape
        assert len(W.dia_offsets) == ndia
        assert W.data.dtype == rt.config.torch_dtype(dtype)
        assert W.brow.dtype == W.diag_u.dtype == torch.int32
        if mode == "gather":
            want = torch.uint8 if W.wlog <= 8 else torch.int16
            assert W.uloc.dtype == want
        else:
            assert W.uloc is None


@pytest.mark.parametrize("name,dtype", [("lap2d_30", np.float64),
                                        ("randband_3000", np.float64)])
def test_plan_with_loads_outside_x_is_refused(name, dtype):
    """A plan whose slot loads pass xp_len (or fall below 0) raises before
    any upload, for roll and gather mode alike."""
    from rocalution_tpu_torch.formats.wjd import _plan_to_wjd

    _, At = _pair(name, dtype)
    plan = torch_plan(*At.numpy_triplet(), At.shape)
    _plan_to_wjd(plan, device="cpu")          # the planner's own plan fits
    deep = dict(plan, brow=plan["brow"].copy())
    deep["brow"][-1, -1] = plan["xp_len"] // 128
    with pytest.raises(ValueError, match="xp_len"):
        _plan_to_wjd(deep, device="cpu")
    low = dict(plan, brow=plan["brow"].copy())
    low["brow"][0, 0] = -(1 << plan["wlog"]) // 128 - 1   # below any u
    with pytest.raises(ValueError, match="xp_len"):
        _plan_to_wjd(low, device="cpu")


def test_empty_matrix_plan():
    At = rt.CSR.from_arrays(np.zeros(0, np.float32), np.zeros(0, np.int32),
                            np.zeros(11, np.int32), (10, 10))
    W = from_csr(At)
    assert W.nnz == 0
    y = rt.spmv(W, torch.ones(10, dtype=torch.float32))
    assert torch.equal(y, torch.zeros(10, dtype=torch.float32))


@pytest.fixture(scope="module")
def transfers():
    """P (tall) and R (wide) of the first SA level of laplacian_3d(12), as
    host triplets."""
    from rocalution_tpu_torch.solvers.multigrid.aggregation import sa_level

    before = rt.config.default_device()
    rt.set_default_device("cpu")
    P, R, _ = sa_level(GENERATORS["lap3d_12"](rt, np.float64))
    rt.set_default_device(before)
    return {"P": P, "R": R}


@pytest.mark.parametrize("kernel_mode", ["auto", "gather", "roll"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["P", "R"])
def test_rectangular_plans_equal_and_apply_like_jax(transfers, which, dtype,
                                                    kernel_mode):
    """AMG transfers are rectangular: P is n_fine x n_coarse, R the
    transpose. Both planners size x, its padding and the windows by the
    column count; the plans must be equal, and the port's CPU apply must
    match the product: the JAX package's `wjd_reference` on the same plan
    for the f64 plan the planner picks (gather mode), a scipy product for
    the others (each JAX reference call compiles for its shape: that is
    what costs here)."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from rocalution_tpu.formats.wjd import csr_to_wjd as jax_to_wjd
    from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference

    M = transfers[which]
    d, i, p = M.numpy_triplet()
    d = d.astype(dtype)
    n, m = M.shape
    assert n != m
    kw = dict(kernel_mode=kernel_mode)
    pt = torch_plan(d, i, p, M.shape, **kw)
    _assert_plans_equal(jax_plan(d, i, p, M.shape, cache=False, **kw), pt)
    x = np.random.default_rng(11).standard_normal(m).astype(dtype)
    if kernel_mode == "auto":
        assert pt["kernel_mode"] == "gather"
    if kernel_mode == "auto" and dtype == np.float64:
        want = np.asarray(wjd_reference(
            jax_to_wjd(d, i, p, M.shape, cache=False), jnp.asarray(x)))
    else:
        want = sp.csr_matrix((d, i, p), shape=M.shape) @ x
    W = from_csr(rt.CSR.from_arrays(d, i, p, M.shape), **kw)
    got = rt.spmv(W, torch.from_numpy(x)).numpy()
    assert got.shape == (n,)
    tol = 1e-13 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
