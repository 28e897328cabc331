"""Port parity: storage formats, conversions and their SpMV.

The three parametrised tests of tests/test_formats.py (convert round trip,
`spmv` per format for x of shape (m,) and (m, k), `nnz`) run through the
port and are held against the JAX package on the same host triplets:
`laplacian_2d(7)` and one rectangular random matrix. f64 throughout, rtol
1e-13 (sums in another order). ELL, HYB and BCSR routed through a WJD plan
(on the CPU: its plain version) give the unrouted result.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.formats import convert as jax_convert
from rocalution_tpu.formats.convert import cast_values as jax_cast_values
from rocalution_tpu_torch.interop import matrix_from_numpy
from rocalution_tpu_torch.ops.spmv import as_operator, maybe_attach_wjd
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

FORMATS = ["CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE"]
RTOL = 1e-13


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _rect_dense():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((37, 53))
    d[np.abs(d) < 1.0] = 0
    return d


PAIRS = {
    "lap2d_7": lambda: (jrt.laplacian_2d(7), rt.laplacian_2d(7)),
    "rect_37x53": lambda: (jrt.CSR.from_dense(_rect_dense()),
                           rt.CSR.from_dense(_rect_dense())),
}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1.0))


def _fields(obj):
    """A JAX format object's fields as numpy arrays, plain values and, for
    a field that is itself a matrix, a dict of the same."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        else:
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_convert_roundtrip(name, fmt):
    Aj, At = PAIRS[name]()
    ref = np.asarray(Aj.to_dense())
    Bj, Bt = jax_convert(Aj, fmt), rt.convert(At, fmt)
    assert type(Bt).__name__ == fmt and Bt.shape == Bj.shape
    np.testing.assert_array_equal(Bt.to_dense().numpy(),
                                  np.asarray(Bj.to_dense()))
    np.testing.assert_array_equal(Bt.to_dense().numpy(), ref)
    # round trip back to CSR: the JAX package's triplet, entry for entry
    Ct, Cj = rt.to_csr(Bt), jrt.formats.to_csr(Bj)
    for a, b in zip(Ct.numpy_triplet(), Cj.numpy_triplet()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spmv_matches_jax(name, fmt, k):
    Aj, At = PAIRS[name]()
    shape = (At.shape[1],) if k is None else (At.shape[1], k)
    x = np.random.default_rng(42).standard_normal(shape)
    want = np.asarray(jrt.spmv(jax_convert(Aj, fmt), jnp.asarray(x)))
    got = rt.spmv(rt.convert(At, fmt), torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    _close(got.numpy(), np.asarray(Aj.to_dense()) @ x)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_nnz_counts(name, fmt):
    Aj, At = PAIRS[name]()
    if name == "lap2d_7":
        assert At.nnz == 5 * 7 * 7 - 4 * 7     # 5-point stencil less boundary
    assert rt.convert(At, fmt).nnz == jax_convert(Aj, fmt).nnz


@pytest.mark.parametrize("fmt", FORMATS)
def test_formats_carried_across_from_jax(fmt):
    """interop.matrix_from_numpy rebuilds each format from the JAX object's
    fields as numpy."""
    Aj, _ = PAIRS["rect_37x53"]()
    Bj = jax_convert(Aj, fmt)
    Bt = matrix_from_numpy(fmt, _fields(Bj), device="cpu")
    assert type(Bt).__name__ == fmt
    np.testing.assert_array_equal(Bt.to_dense().numpy(),
                                  np.asarray(Bj.to_dense()))
    for a, b in zip(rt.to_csr(Bt).numpy_triplet(), Aj.numpy_triplet()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("fmt", ["ELL", "HYB", "BCSR"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_routed_formats_give_the_unrouted_result(name, fmt, k):
    _, At = PAIRS[name]()
    B = rt.convert(At, fmt)
    shape = (At.shape[1],) if k is None else (At.shape[1], k)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    unrouted = rt.spmv(B, x)
    maybe_attach_wjd(B)                   # CPU operand: auto-attach is off
    assert getattr(B, "_wjd_cache", None) is None
    rt.set_auto_wjd(True)
    try:
        op = as_operator(B)
    finally:
        rt.set_auto_wjd(None)
    assert B._wjd_cache.data.dtype == torch.float64
    _close(op(x).numpy(), unrouted.numpy())
    _close(rt.spmv(B, x).numpy(), unrouted.numpy())
    # an f32 x does not ride the f64 plan
    y32 = rt.spmv(rt.cast_values(B, np.float32), x.float())
    np.testing.assert_allclose(y32.numpy(), unrouted.numpy(), rtol=2e-5,
                               atol=2e-5 * float(unrouted.abs().max()))


@pytest.mark.parametrize("fmt", ["ELL", "HYB", "BCSR"])
def test_cast_routed_format_gets_a_plan(fmt):
    """A `cast_values` copy of an ELL, HYB or BCSR operand is cast tensor by
    tensor and has no host arrays. With auto_wjd on (the card's default)
    `maybe_attach_wjd` reads it back once and plans it, as MixedPrecisionDC
    needs for its f32 operator; the routed apply gives the unrouted one."""
    B = rt.cast_values(rt.convert(rt.laplacian_2d(40), fmt), torch.float32)
    assert not getattr(B.ell if fmt == "HYB" else B, "_host_cache", None)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        B.shape[1]).astype(np.float32))
    unrouted = rt.spmv(B, x)
    rt.set_auto_wjd(True)
    try:
        maybe_attach_wjd(B)
    finally:
        rt.set_auto_wjd(None)
    W = B._wjd_cache
    assert W is not None and W.dtype == torch.float32
    np.testing.assert_allclose(rt.spmv(B, x).numpy(), unrouted.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cast_values_matches_jax():
    Aj, At = PAIRS["lap2d_7"]()
    for fmt in FORMATS:
        Ct = rt.cast_values(rt.convert(At, fmt), np.float32)
        Cj = jax_cast_values(jax_convert(Aj, fmt), np.float32)
        assert Ct.dtype == torch.float32, fmt
        np.testing.assert_array_equal(Ct.to_dense().numpy(),
                                      np.asarray(Cj.to_dense()))


def test_convert_rejects_unknown_format():
    with pytest.raises(ValueError):
        rt.convert(rt.laplacian_2d(3), "JDS")
    with pytest.raises(TypeError):
        rt.to_csr(object())
