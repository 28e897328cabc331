"""Port parity: WJD plans with bfloat16 values.

The JAX planner's ``values_dtype="bfloat16"`` stores the slot values, the
spill and the DIA part in bfloat16 and its kernels sum their products in
f32 over an f32 x. The port's planner rounds the same values with torch's
cast and keeps them on the host as f32 arrays (numpy has no bfloat16);
here every plan array must equal the JAX planner's, the values bit for
bit (JAX's uint16 view against the port's bfloat16 bits). The port's
plain product over such a plan (the CPU path of every bf16 kernel: direct,
compact, window-relative compact, blocked right-hand sides, DIA part) is
held against the JAX `wjd_reference` at 1e-5 relative: both sum the same
f32 products, in another order. The dispatch table (which x a plan's
kernels take, and y's dtype) is the JAX package's `_use_pallas`, and a
JAX bfloat16 WJD carries over through `interop.wjd_from_numpy` bit for
bit. The CUDA kernels themselves are checked by tests/test_torch_kernels.py,
which needs a card.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu.formats.wjd as jax_wjd
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu.formats.wjd import csr_to_wjd_plan as jax_plan
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference as jax_reference
from rocalution_tpu.ops.spmv import attach_wjd as jax_attach_wjd
from rocalution_tpu_torch.formats.wjd import csr_to_wjd_plan as torch_plan
from rocalution_tpu_torch.formats.wjd import from_csr
from rocalution_tpu_torch.interop import wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

BF16 = "bfloat16"
GENERATORS = {
    "lap3d_12": lambda m, dt: m.laplacian_3d(12, dtype=dt),
    "randband_3000": lambda m, dt: m.random_banded_spd(
        3000, bandwidth=512, dtype=dt),
}
# max|y_port - y_jax| / max|y_jax|: the same f32 products of the same
# bfloat16 values, summed in another order
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU
    (module scope: module-scoped operands build on it too)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture
def one_tile_steps(monkeypatch):
    """One tile per grid step in both planners, so that these operators of
    two or three tiles have as many windows in the windowed regime. The
    product does not depend on the grouping."""
    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)
        monkeypatch.setattr(mod, "_auto_group_windowed", lambda K: 1)


@pytest.fixture
def small_budget(monkeypatch, one_tile_steps):
    """The windowed regime on small operators, in both packages."""
    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "X_VMEM_BUDGET", 1024)


def _bits(a: np.ndarray) -> np.ndarray:
    """The bfloat16 bits of f32 values that bfloat16 holds exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def _assert_bf16_plans_equal(pj: dict, pt: dict) -> None:
    """Every array equal; a JAX bfloat16 array bit for bit against the
    port's f32 host form of it. An empty slot plan (all of the operator
    in the DIA part) keeps f32 planes in both planners."""
    assert pj.pop("data_lo") is None
    rounded = []
    for key in ("data", "spill_val", "dia_data"):
        a, b = pj.pop(key), pt.pop(key)
        assert (a is None) == (b is None), key
        if a is None:
            continue
        assert b.dtype == np.float32, key
        if a.dtype.name != BF16:
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        rounded.append(key)
        # the port's f32 host values are bfloat16 values, exactly
        np.testing.assert_array_equal(
            torch.from_numpy(b).to(torch.bfloat16).float().numpy(), b)
        np.testing.assert_array_equal(a.view(np.uint16), _bits(b),
                                      err_msg=key)
    assert rounded
    assert pj.pop("value_dtype") == pt.pop("value_dtype") == (
        BF16 if "data" in rounded else "float32")
    assert set(pj) == set(pt)
    for key in pj:
        a, b = pj[key], pt[key]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


def _triplet(name, dtype):
    A = GENERATORS[name](jrt, dtype)
    return (*A.numpy_triplet(), A.shape)


PLANS = {
    "roll_unsplit": ("lap3d_12", np.float32,
                     dict(kernel_mode="roll", split_dia=False)),
    # every diagonal of the stencil is dense: all of it goes to the DIA
    # part, and the slot plan is empty
    "dia_only": ("lap3d_12", np.float32, dict(split_dia="auto")),
    "gather_f64_values": ("randband_3000", np.float64,
                          dict(kernel_mode="gather", split_dia=False)),
    # the main diagonal goes to the DIA part, the rest to gather slots
    "gather_dia_split": ("randband_3000", np.float32,
                         dict(split_dia="auto")),
    "gather_spill": ("randband_3000", np.float32,
                     dict(max_slots=2, split_dia=False)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_bf16_plan_equals_jax(case, one_tile_steps):
    name, dtype, kw = PLANS[case]
    d, i, p, shape = _triplet(name, dtype)
    pt = torch_plan(d, i, p, shape, values_dtype=BF16, **kw)
    if case == "gather_spill":
        assert len(pt["spill_row"]) > 0
    if case in ("dia_only", "gather_dia_split"):
        assert pt["dia_data"] is not None
    _assert_bf16_plans_equal(
        jax_plan(d, i, p, shape, cache=False, values_dtype=BF16, **kw), pt)


@pytest.mark.parametrize("kernel_mode", ["roll", "gather"])
def test_bf16_plan_equals_jax_in_the_windowed_regime(kernel_mode,
                                                     small_budget):
    d, i, p, shape = _triplet("lap3d_12", np.float32)
    kw = dict(kernel_mode=kernel_mode, split_dia=False, values_dtype=BF16)
    pt = torch_plan(d, i, p, shape, **kw)
    assert pt["win_base"] is not None and len(pt["win_base"]) > 1
    _assert_bf16_plans_equal(jax_plan(d, i, p, shape, cache=False, **kw), pt)


def test_bf16_rounding_of_f64_values_is_jax_s():
    """An f64 value goes to bfloat16 through f32 in both packages (two
    roundings): 1 + 2^-8 + 2^-40 becomes 0x3F80 (1.0), where one rounding
    of the f64 value would give 0x3F81. The spill takes the same cast."""
    A = jrt.laplacian_2d(40)
    d, i, p = A.numpy_triplet()
    d = d.copy()
    d[::3] = 1.0 + 2.0 ** -8 + 2.0 ** -40
    d[1::3] *= 1.0 + 1e-3 * np.arange(len(d[1::3])) / len(d)
    pt = torch_plan(d, i, p, A.shape, values_dtype=BF16, max_slots=3)
    assert len(pt["spill_row"]) > 0
    # the rows whose first entry is the value hold it in slot 0
    first = _bits(pt["data"][:, 0].reshape(-1))
    assert 0x3F80 in first and 0x3F81 not in first
    _assert_bf16_plans_equal(jax_plan(d, i, p, A.shape, cache=False,
                                      values_dtype=BF16, max_slots=3), pt)


# operator, planner kwargs, windowed regime
PRODUCTS = {
    "roll": ("lap3d_12", dict(kernel_mode="roll", split_dia=False), False),
    "compact": ("randband_3000", dict(split_dia=False), False),
    "window_relative": ("randband_3000", dict(split_dia=False), True),
    "dia_split": ("randband_3000", dict(split_dia="auto"), False),
}


@pytest.fixture(scope="module")
def products():
    """The f32 operators of PRODUCTS on both sides, made once."""
    return {name: (GENERATORS[name](jrt, np.float32),
                   GENERATORS[name](rt, np.float32))
            for name in ("lap3d_12", "randband_3000")}


@pytest.fixture(scope="module")
def product_plans(products):
    """The bfloat16 plans of PRODUCTS on both sides, made once, with one
    tile per grid step (and the small x budget where the case is in the
    windowed regime)."""
    out = {}
    for case, (name, kw, in_window) in PRODUCTS.items():
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jax_wjd, torch_wjd):
                mp.setattr(mod, "_auto_group", lambda K: 1)
                mp.setattr(mod, "_auto_group_windowed", lambda K: 1)
                if in_window:
                    mp.setattr(mod, "X_VMEM_BUDGET", 1024)
            Aj, At = products[name]
            out[case] = (jax_from_csr(Aj, cache=False, values_dtype=BF16,
                                      **kw),
                         from_csr(At, values_dtype=BF16, **kw))
    return out


def _jax_product(Wj, X32):
    """JAX wjd_reference on an f32 x (1-D, or 2-D column by column)."""
    if X32.ndim == 1:
        return np.asarray(jax_reference(Wj, jnp.asarray(X32)))
    return np.asarray(jax.vmap(lambda c: jax_reference(Wj, c), in_axes=1,
                               out_axes=1)(jnp.asarray(X32)))


@pytest.mark.parametrize("cols", [1, 16])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_bf16_plain_product_matches_jax_reference(case, xdt, cols,
                                                  product_plans):
    in_window = PRODUCTS[case][2]
    Wj, W = product_plans[case]
    assert Wj.data.dtype == jnp.bfloat16 and W.dtype == torch.bfloat16
    assert W.x_dtype == torch.float32
    # a gather plan carries its regime in its compact form
    assert W.kernel_mode == "gather" or not in_window
    assert W.window_relative is in_window
    if case == "dia_split":
        assert W.dia_data.dtype == torch.bfloat16
    n, m = W.shape
    shape = (m,) if cols == 1 else (m, cols)
    X = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32)).to(getattr(torch, xdt))
    y = rt.spmv(W, X)
    assert y.dtype == torch.float32 and tuple(y.shape) == (
        (n,) + tuple(shape[1:]))
    # a bfloat16 x is widened to f32 first: the product the JAX kernels
    # compute, which widen the value and promote bf16 x f32 to f32
    want = _jax_product(Wj, X.float().numpy())
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def dispatch_operands():
    """f32, bfloat16 and f64 plans on both sides (laplacian_2d(30): one
    tile), each attached to a CSR of its own. No DIA part: with a bfloat16
    x the JAX package's DIA part multiplies in bfloat16 and the port's in
    f32 (ROADMAP.md, deliberate differences)."""
    out = {}
    for plan, (dtype, vdt) in {"float32": (np.float32, None),
                               "bfloat16": (np.float32, BF16),
                               "float64": (np.float64, None)}.items():
        Aj = jax_attach_wjd(jrt.laplacian_2d(30, dtype=dtype),
                            values_dtype=vdt, cache=False, split_dia=False)
        At = rt.attach_wjd(rt.laplacian_2d(30, dtype=dtype),
                           values_dtype=vdt, split_dia=False)
        out[plan] = (Aj, At)
    return out


@pytest.mark.parametrize("xdt", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("plan", ["float32", "bfloat16", "float64"])
def test_dispatch_is_jax_s(plan, xdt, dispatch_operands):
    """Which x a plan's kernels take is the JAX package's `_use_pallas`,
    and y has the JAX apply's dtype (abstract evaluation on the JAX side:
    the Pallas kernel is traced, not run)."""
    from rocalution_tpu.ops.spmv import _use_pallas
    from rocalution_tpu_torch.ops.spmv import _use_kernel

    Aj, At = dispatch_operands[plan]
    assert str(At._wjd_cache.dtype) == f"torch.{plan}"
    served = _use_pallas(Aj._wjd_cache, jnp.dtype(xdt))
    assert _use_kernel(At._wjd_cache, getattr(torch, xdt)) is served
    x = np.random.default_rng(3).standard_normal(At.shape[1])
    want = jax.eval_shape(lambda v: jrt.spmv(Aj, v),
                          jnp.asarray(x, dtype=xdt)).dtype
    calls = []
    real = kernels.wjd_spmv
    with pytest.MonkeyPatch.context() as mp:
        # the module: rocalution_tpu_torch.ops.spmv as an attribute is the
        # function
        spmv_mod = sys.modules["rocalution_tpu_torch.ops.spmv"]
        mp.setattr(spmv_mod, "wjd_spmv",
                   lambda A, v: calls.append(1) or real(A, v))
        y = rt.spmv(At, torch.from_numpy(x).to(getattr(torch, xdt)))
    assert bool(calls) is served
    assert str(y.dtype) == f"torch.{jnp.dtype(want).name}"


@pytest.mark.parametrize("kw", [dict(kernel_mode="roll", split_dia=False),
                                dict(split_dia="auto"),
                                dict(max_slots=2, split_dia=False)])
def test_wjd_from_numpy_takes_jax_bf16_by_its_bits(kw, products):
    Aj, At = products["randband_3000"] if "max_slots" in kw or (
        kw["split_dia"] == "auto") else products["lap3d_12"]
    Wj = jax_from_csr(Aj, cache=False, values_dtype=BF16, **kw)
    fields = {f.name: getattr(Wj, f.name) for f in dataclasses.fields(Wj)}
    Wt = wjd_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v)
                         for k, v in fields.items()}, device="cpu")
    W = from_csr(At, values_dtype=BF16, **kw)
    for name in ("data", "spill_val", "dia_data"):
        a, b = getattr(Wj, name), getattr(Wt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                b.view(torch.int16).numpy().view(np.uint16), err_msg=name)
            assert torch.equal(b, getattr(W, name)), name
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        At.shape[1]).astype(np.float32))
    assert torch.equal(kernels.wjd_spmv(Wt, x), kernels.wjd_spmv(W, x))


def test_bf16_plan_refuses_an_f64_x():
    W = from_csr(rt.laplacian_2d(30, dtype=np.float32), values_dtype=BF16)
    with pytest.raises(TypeError):
        kernels.wjd_spmv(W, torch.ones(900, dtype=torch.float64))
    with pytest.raises(ValueError):
        from_csr(rt.laplacian_2d(30), values_dtype="float16")
