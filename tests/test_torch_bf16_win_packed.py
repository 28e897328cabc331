"""Port parity: the packed form of a windowed bfloat16 gather plan.

A bfloat16 gather plan in the windowed regime takes the window-relative
compact form (every slice of grid step i based at the step's window,
win_base[i]*128); where its offsets are uint16 it is uploaded packed
(formats/wjd.py: `pack_bf16_slices`), keeps ``window_relative`` and is
checked against its step windows on the host first. Here, with a small
x budget and one tile a grid step on both planners (so that operators of
two or three tiles have as many windows): such a plan takes the packed
form and unpacks to `compact_slices(plan, window_relative=True)` bit for
bit, ragged and empty slices included; a packed word that leaves its
window is refused before any upload, and by the plain version; the packed
windowed plain products (single, and 16 columns) equal the JAX
`wjd_reference` on the JAX planner's windowed bfloat16 plan carried over
by `interop`; and an f32 CG over the packed windowed form stops where it
stops over the compact windowed form. The kernels are checked by
tests/test_torch_kernels.py on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu.formats.wjd as jax_wjd
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference as jax_reference
from rocalution_tpu_torch.formats.wjd import (PACK, SLICE, compact_slices,
                                              csr_to_wjd_plan, from_csr,
                                              unpack_bf16_slices, windowed)
from rocalution_tpu_torch.interop import wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_bf16_packed import _ragged
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = "bfloat16"
# max|y_port - y_jax| / max|y_jax|: the f32 sums of the same f32 products
# of the same bfloat16 values, in another order
RTOL = 1e-5
GATHER = dict(kernel_mode="gather", split_dia=False)


OPERATORS = {
    "randband_3000": lambda m: m.random_banded_spd(3000, bandwidth=512,
                                                   dtype=np.float32),
    "ragged": _ragged,
}


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _small_windows(mp):
    """The windowed regime on small operators, one tile a grid step, in
    both planners."""
    for mod in (jax_wjd, torch_wjd):
        mp.setattr(mod, "X_VMEM_BUDGET", 1024)
        mp.setattr(mod, "_auto_group", lambda K: 1)
        mp.setattr(mod, "_auto_group_windowed", lambda K: 1)


@pytest.fixture
def small_windows(monkeypatch):
    _small_windows(monkeypatch)


def _bf16_plan(name):
    A = OPERATORS[name](rt)
    return csr_to_wjd_plan(*A.numpy_triplet(), A.shape, values_dtype=BF16,
                           **GATHER)


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_windowed_bf16_plan_takes_the_packed_form(name, small_windows):
    """The plan is packed and keeps its regime: window-relative, windowed,
    its slice bases the step windows; unpacked, its words are the
    window-relative compact form bit for bit; and its windowed plain
    product equals the compact form's bit for bit (each row adds the same
    terms in the same order, plus zero words)."""
    plan = _bf16_plan(name)
    assert plan["win_base"] is not None and len(plan["win_base"]) > 1
    comp = compact_slices(plan, window_relative=True)
    assert comp["coff"].dtype == np.uint16
    width = np.diff(comp["slice_ptr"]) // SLICE
    if name == "ragged":
        assert (width == 0).any() and (width % PACK != 0).any()
    W = torch_wjd._plan_to_wjd(plan, "cpu")
    assert W.compact_form == "packed" and W.cval is None and W.coff is None
    assert W.window_relative and windowed(W, torch.float32)
    np.testing.assert_array_equal(W.xbase.numpy(), np.repeat(
        W.win_base.numpy().astype(np.int64) * 128, W.group * 32))
    back = unpack_bf16_slices(W.cpack.numpy(), W.slice_ptr.numpy(),
                              W.xbase.numpy())
    np.testing.assert_array_equal(back["cval"].view(np.uint32),
                                  comp["cval"].view(np.uint32))
    for key in ("coff", "slice_ptr", "xbase"):
        assert back[key].dtype == comp[key].dtype, key
        np.testing.assert_array_equal(back[key], comp[key], err_msg=key)
    Wc = dataclasses.replace(
        W, cpack=None, slice_ptr=torch.from_numpy(comp["slice_ptr"]),
        cval=torch.from_numpy(comp["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(comp["coff"]))
    xp = kernels.pad_x(W, torch.from_numpy(np.random.default_rng(2)
                                           .standard_normal(W.shape[1])
                                           .astype(np.float32)))
    assert kernels.plain_gather(W) is kernels.slots_plain_packed_windowed
    assert torch.equal(kernels.slots_plain_packed_windowed(W, xp),
                       kernels.slots_plain_compact_windowed(Wc, xp))


def test_a_word_that_leaves_its_window_is_refused(small_windows,
                                                  monkeypatch):
    """A packed word whose offset reaches win_rows*128 (still inside padded
    x) is refused on the host before any array is uploaded, and by the
    windowed plain product (IndexError)."""
    plan = _bf16_plan("randband_3000")
    win_rows = int(plan["win_rows"])
    assert win_rows * 128 < 1 << 16
    real_pack = torch_wjd.pack_bf16_slices

    def leaving(compact):
        out = real_pack(compact)
        cpack = out["cpack"].copy()
        q = int(np.flatnonzero(cpack & 0xFFFF)[0])   # a real entry
        cpack[q] = (cpack[q] & 0xFFFF) | (win_rows * 128) << 16
        return {**out, "cpack": cpack}

    uploads = []
    real_upload = torch_wjd.to_device
    monkeypatch.setattr(torch_wjd, "pack_bf16_slices", leaving)
    monkeypatch.setattr(torch_wjd, "to_device", lambda *a, **k: (
        uploads.append(a[0]), real_upload(*a, **k))[1])
    with pytest.raises(ValueError, match="window"):
        torch_wjd._plan_to_wjd(plan, "cpu")
    assert uploads == []

    monkeypatch.setattr(torch_wjd, "pack_bf16_slices", real_pack)
    W = torch_wjd._plan_to_wjd(plan, "cpu")
    bad = W.cpack.numpy().view(np.uint32).copy()
    q = int(np.flatnonzero(bad & 0xFFFF)[0])
    bad[q] = (bad[q] & 0xFFFF) | (win_rows * 128) << 16
    bad = torch.from_numpy(bad.view(np.int32))
    xp = kernels.pad_x(W, torch.ones(W.shape[1]))
    with pytest.raises(IndexError):
        kernels.slots_plain_packed_windowed(
            dataclasses.replace(W, cpack=bad), xp)


@pytest.fixture(scope="module")
def jax_plans():
    """The JAX planner's windowed bfloat16 gather plan of each operator,
    as the JAX WJD and as the port's WJD carried over by interop, and the
    port's own plan, all with small windows."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _small_windows(mp)
        for name in sorted(OPERATORS):
            Wj = jax_from_csr(OPERATORS[name](jrt), cache=False,
                              values_dtype=BF16, **GATHER)
            fields = {f.name: getattr(Wj, f.name)
                      for f in dataclasses.fields(Wj)}
            Wt = wjd_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                     else v) for k, v in fields.items()},
                                device="cpu")
            own = from_csr(OPERATORS[name](rt), values_dtype=BF16, **GATHER)
            out[name] = (Wj, Wt, own)
    return out


def _jax_product(Wj, X32):
    if X32.ndim == 1:
        return np.asarray(jax_reference(Wj, jnp.asarray(X32)))
    return np.asarray(jax.vmap(lambda c: jax_reference(Wj, c), in_axes=1,
                               out_axes=1)(jnp.asarray(X32)))


@pytest.mark.parametrize("cols", [1, 16])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_packed_windowed_plain_product_matches_jax_reference(name, cols,
                                                             jax_plans):
    """wjd_spmv (the windowed plain product over the packed form) and
    wjd_spmm (the packed blocked product through xbase, which holds the
    step windows) against JAX wjd_reference on the JAX planner's plan;
    the port's own plan packs to the same words."""
    Wj, Wt, own = jax_plans[name]
    assert Wj.win_base is not None and len(Wj.win_base) > 1
    assert Wt.compact_form == "packed" and Wt.window_relative
    assert torch.equal(Wt.cpack, own.cpack)
    assert torch.equal(Wt.slice_ptr, own.slice_ptr)
    assert torch.equal(Wt.xbase, own.xbase)
    n, m = Wt.shape
    shape = (m,) if cols == 1 else (m, cols)
    X = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    Xt = torch.from_numpy(X)
    y = (kernels.wjd_spmv(Wt, Xt) if cols == 1
         else kernels.wjd_spmm(Wt, Xt))
    assert y.dtype == torch.float32 and tuple(y.shape) == (n,) + shape[1:]
    want = _jax_product(Wj, X)
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_cg_over_the_packed_windowed_form_stops_where_the_compact_does(
        small_windows):
    """One f32 CG + Jacobi over a packed windowed bfloat16 plan and over
    the same plan in the window-relative compact form (on the CPU: their
    windowed plain products): the same status and count, the same
    solution within rounding (rtol 1e-4, atol 1e-5: a few f32 ulps of
    the iterates)."""
    A = OPERATORS["randband_3000"](rt)
    rt.attach_wjd(A, values_dtype=BF16)
    W = A._wjd_cache
    assert W.compact_form == "packed" and windowed(W, torch.float32)
    comp = compact_slices(csr_to_wjd_plan(*A.numpy_triplet(), A.shape,
                                          values_dtype=BF16),
                          window_relative=True)
    B = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    object.__setattr__(B, "_wjd_cache", dataclasses.replace(
        W, cpack=None, slice_ptr=torch.from_numpy(comp["slice_ptr"]),
        cval=torch.from_numpy(comp["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(comp["coff"])))
    Wc = B._wjd_cache
    assert Wc.compact_form == "compact" and windowed(Wc, torch.float32)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(np.float32))
    out = {}
    for tag, op in (("packed", A), ("compact", B)):
        x, info = rt.cg(op, b, M=rt.jacobi(op), rel_tol=1e-5, max_iter=500,
                        check_every=1)
        out[tag] = (int(info.status), int(info.iterations), x)
    assert out["packed"][0] == out["compact"][0] == 2
    assert out["packed"][1] == out["compact"][1]
    torch.testing.assert_close(out["packed"][2], out["compact"][2],
                               rtol=1e-4, atol=1e-5)
