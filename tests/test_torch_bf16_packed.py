"""Port parity: the packed form of a bfloat16 gather plan.

A bfloat16 gather plan whose compact offsets are uint16 is uploaded in the
packed form (formats/wjd.py: `pack_bf16_slices`): one 32-bit word a stored
element, bfloat16 bits | offset << 16, 4 ranks of a row in 16 consecutive
bytes, a slice padded to a multiple of 4 ranks. Here: the packed form
unpacked is `compact_slices`' form bit for bit (ragged and empty slices
included); a plan whose offsets pass 24 bits, direct or
window-relative, keeps the compact form; the packed
form's plain products (single, and blocked over 16 and 20 columns) equal
the JAX `wjd_reference` on the JAX planner's bfloat16 plan at 1e-5, as
tests/test_torch_bf16.py holds the compact form; and an f32 CG over a
packed plan stops where it stops over the compact form. The kernels over
the packed form are checked by tests/test_torch_kernels.py on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rocalution_tpu as jrt
import rocalution_tpu.formats.wjd as jax_wjd
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference as jax_reference
from rocalution_tpu_torch.formats.wjd import (PACK, SLICE, compact_slices,
                                              csr_to_wjd_plan, from_csr,
                                              pack_bf16_slices,
                                              unpack_bf16_slices)
from rocalution_tpu_torch.interop import wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = "bfloat16"
# max|y_port - y_jax| / max|y_jax|: the same f32 products of the same
# bfloat16 values, summed in another order (tests/test_torch_bf16.py)
RTOL = 1e-5
GATHER = dict(kernel_mode="gather", split_dia=False)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _ragged(module, device=None):
    """3,000 rows of 0 to 37 entries each (slices of every width mod 4, a
    run of empty rows, so empty slices, and a ragged last tile), columns
    within 3,000 of the row: uint16 offsets."""
    rng = np.random.default_rng(11)
    n = 3000
    lens = rng.integers(0, 38, n)
    lens[1024:1120] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = np.clip(rows + rng.integers(-1500, 1500, len(rows)), 0, n - 1)
    S = sp.csr_matrix((rng.standard_normal(len(rows)).astype(np.float32),
                       (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    S.sort_indices()
    kw = {} if device is None else {"device": device}
    return module.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                                  S.indptr.astype(np.int32), S.shape, **kw)


OPERATORS = {
    "randband_3000": lambda m: m.random_banded_spd(3000, bandwidth=512,
                                                   dtype=np.float32),
    "lap3d_12": lambda m: m.laplacian_3d(12, dtype=np.float32),
    "ragged": _ragged,
}


def _bf16_plan(name):
    A = OPERATORS[name](rt)
    return csr_to_wjd_plan(*A.numpy_triplet(), A.shape, values_dtype=BF16,
                           **GATHER)


@pytest.mark.parametrize("name", ["randband_3000", "ragged"])
def test_packed_form_unpacks_to_the_compact_form(name):
    """Unpacked, the packed words are `compact_slices`' values and offsets
    bit for bit; each slice is its compact width rounded up to 4 ranks,
    the extra words zero; every word sits at (j // 4)*128 + lane*4 + j % 4
    of its slice."""
    comp = compact_slices(_bf16_plan(name))
    assert comp["coff"].dtype == np.uint16
    packed = pack_bf16_slices(comp)
    width = np.diff(comp["slice_ptr"]) // SLICE
    pwidth = np.diff(packed["slice_ptr"]) // SLICE
    assert (width == 0).any() and (width % PACK != 0).any()
    np.testing.assert_array_equal(pwidth, -(-width // PACK) * PACK)
    assert packed["cpack"].dtype == np.uint32
    back = unpack_bf16_slices(packed["cpack"], packed["slice_ptr"],
                              packed["xbase"])
    np.testing.assert_array_equal(back["cval"].view(np.uint32),
                                  comp["cval"].view(np.uint32))
    for key in ("coff", "slice_ptr", "xbase"):
        assert back[key].dtype == comp[key].dtype, key
        np.testing.assert_array_equal(back[key], comp[key], err_msg=key)
    # one slice by hand: rank j of lane l
    i = int(np.flatnonzero(width % PACK == 3)[0])
    p0, q0 = comp["slice_ptr"][i], packed["slice_ptr"][i]
    for j in range(int(pwidth[i])):
        for lane in (0, 7, 31):
            word = int(packed["cpack"][q0 + (j // 4) * 128 + lane * 4 + j % 4])
            if j < width[i]:
                p = p0 + j * SLICE + lane
                assert word & 0xFFFF == int(comp["cval"][p:p + 1].view(
                    np.uint32)[0]) >> 16
                assert word >> 16 == int(comp["coff"][p])
            else:
                assert word == 0


def test_packed_plan_on_the_wjd():
    """from_csr gives the packed form: int32 words, no cval/coff, the
    bfloat16 dtype and f32 x, its words per nonzero as the padding."""
    A = OPERATORS["randband_3000"](rt)
    W = from_csr(A, values_dtype=BF16)
    assert W.compact_form == "packed" and W.cval is None and W.coff is None
    assert W.cpack.dtype == torch.int32 and W.dtype == torch.bfloat16
    assert W.x_dtype == torch.float32
    assert W.compact_padding_ratio == W.cpack.numel() / W.nnz
    comp = compact_slices(_bf16_plan("randband_3000"))
    assert W.cpack.numel() >= len(comp["cval"])
    # the f32 plan of the same operator keeps the compact form
    assert from_csr(A).compact_form == "compact"


@pytest.mark.parametrize("case", ["int32_offsets", "window_relative"])
def test_other_bf16_plans_keep_the_compact_form(case, monkeypatch):
    """The form is chosen by offset width alone: a bfloat16 plan whose
    offsets pass 24 bits keeps the compact form with int32 offsets (and its
    kernels), direct or in the windowed regime, where a window of more
    than 2**24 elements of x (win_rows*128) lets its window-relative
    offsets pass 24 bits. The operator: 64 rows, each coupled to a column
    2**24 + 2**19 further on. A direct plan's x is at most X_VMEM_BUDGET
    bytes, so the direct case raises the budget; offsets between 16 and 24
    bits take the packed24 form (tests/test_torch_bf16_packed24.py)."""
    n, m = 64, (1 << 24) + (1 << 20)
    rows = np.repeat(np.arange(n), 2)
    cols = np.stack([np.arange(n), (1 << 24) + (1 << 19) + np.arange(n)],
                    1).reshape(-1)
    vals = np.random.default_rng(5).standard_normal(2 * n).astype(np.float32)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    A = rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                           S.indptr.astype(np.int32), S.shape)
    if case == "window_relative":
        monkeypatch.setattr(torch_wjd, "X_VMEM_BUDGET", 1024)
        monkeypatch.setattr(torch_wjd, "_auto_group", lambda K: 1)
        monkeypatch.setattr(torch_wjd, "_auto_group_windowed", lambda K: 1)
    else:
        monkeypatch.setattr(torch_wjd, "X_VMEM_BUDGET", 1 << 30)
    W = from_csr(A, values_dtype=BF16, split_dia=False, kernel_mode="gather")
    assert W.window_relative is (case == "window_relative")
    if W.window_relative:
        assert W.win_rows * 128 > 1 << 24
    assert W.coff.dtype == torch.int32 and int(W.coff.max()) >= 1 << 24
    assert W.compact_form == "compact" and W.cpack is None and W.chi is None
    assert W.cval.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def jax_plans():
    """The JAX planner's bfloat16 gather plan of each operator, as the JAX
    WJD and as the port's WJD carried over by interop (one tile per grid
    step in both planners), and the port's own plan."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_wjd, torch_wjd):
            mp.setattr(mod, "_auto_group", lambda K: 1)
        for name in ("randband_3000", "lap3d_12"):
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


@pytest.mark.parametrize("cols", [1, 16, 20])
@pytest.mark.parametrize("name", ["randband_3000", "lap3d_12"])
def test_packed_plain_product_matches_jax_reference(name, cols, jax_plans):
    """The packed form's plain product (wjd_spmv / wjd_spmm on the CPU: 20
    columns go as 16 + 4) against JAX wjd_reference on the JAX planner's
    plan; the port's own plan packs to the same words."""
    Wj, Wt, own = jax_plans[name]
    assert Wt.compact_form == "packed"
    assert torch.equal(Wt.cpack, own.cpack)
    assert torch.equal(Wt.slice_ptr, own.slice_ptr)
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
    # the slot part alone (no spill) against the padded slot product
    if cols == 1:
        xp = kernels.pad_x(Wt, Xt)
        got = kernels.slots_plain_packed(Wt, xp)
        slots = kernels.slots_plain(Wt, xp)
    else:
        xp = kernels.pad_x(Wt, Xt[:, :16], 16)
        got = kernels.slots_plain_packed_mrhs(Wt, xp)
        slots = kernels.slots_plain_mrhs(Wt, xp)
    torch.testing.assert_close(got.reshape(slots.shape), slots, rtol=RTOL,
                               atol=RTOL * float(slots.abs().max()))


def test_cg_over_the_packed_form_stops_where_the_compact_form_does():
    """One f32 CG + Jacobi over a packed bfloat16 plan and over the same
    plan in the compact form (on the CPU: their plain products): the same
    status and count, the same history within rounding."""
    A = OPERATORS["randband_3000"](rt)
    rt.attach_wjd(A, values_dtype=BF16)
    W = A._wjd_cache
    assert W.compact_form == "packed"
    comp = compact_slices(csr_to_wjd_plan(*A.numpy_triplet(), A.shape,
                                          values_dtype=BF16))
    B = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    object.__setattr__(B, "_wjd_cache", dataclasses.replace(
        W, cpack=None, slice_ptr=torch.from_numpy(comp["slice_ptr"]),
        cval=torch.from_numpy(comp["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(comp["coff"])))
    assert B._wjd_cache.compact_form == "compact"
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
