"""Port parity: the packed form of a bfloat16 gather plan with a high byte
a word (the packed24 form).

A bfloat16 gather plan whose offsets pass 16 bits but lie below 2**24,
direct or window-relative, is uploaded as the packed form's words (the
offset's low 16 bits in each word's high half) and a plane ``chi`` of one
byte a word holding bits 16-23 (formats/wjd.py: `pack_bf16_slices`).
Here: packed and unpacked, a compact form comes back bit for bit (ragged
and empty slices, offsets at 2**16 - 1, 2**16 and 2**24 - 1); the offset
width alone picks the form (2**24 keeps the compact int32 form); a word
that leaves x or its window is refused before any upload, and by the
plain version; the new form's plain products (single, 16 columns, and
windowed, with windows of more than 512 rows) equal the JAX
`wjd_reference` on the JAX planner's bfloat16 plan carried over by
`interop`, at 1e-5; and an f32 CG over the new form stops where it stops
over the compact form. The kernels are checked by
tests/test_torch_kernels.py on a card.
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
                                              unpack_bf16_slices, windowed)
from rocalution_tpu_torch.interop import wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = "bfloat16"
# max|y_port - y_jax| / max|y_jax|: the same f32 products of the same
# bfloat16 values, summed in another order (tests/test_torch_bf16.py)
RTOL = 1e-5
WIDE = dict(split_dia=False)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _wide(module):
    """2,500 rows whose columns scatter over 150,000 (the operator of
    tests/test_torch_bf16_roll_spmm.py): its slices span more than 65,535
    elements of x."""
    rng = np.random.default_rng(5)
    S = sp.random(2500, 150_000, density=8 / 150_000, format="csr",
                  random_state=rng)
    S.data = rng.standard_normal(S.nnz)
    S.sort_indices()
    return module.CSR.from_arrays(S.data.astype(np.float32),
                                  S.indices.astype(np.int32),
                                  S.indptr.astype(np.int32), S.shape)


def _small_windows(mp):
    """The windowed regime on small operators, one tile a grid step, in
    both planners."""
    for mod in (jax_wjd, torch_wjd):
        mp.setattr(mod, "X_VMEM_BUDGET", 1024)
        mp.setattr(mod, "_auto_group", lambda K: 1)
        mp.setattr(mod, "_auto_group_windowed", lambda K: 1)


def _one_tile_steps(mp):
    for mod in (jax_wjd, torch_wjd):
        mp.setattr(mod, "_auto_group", lambda K: 1)


def _compact(offsets):
    """A compact form by hand: 6 slices of widths 0, 3, 1, 0, 5, 4 ranks
    (ragged rows: a lane's ranks past its length hold value 0, offset 0),
    bfloat16 values, int32 offsets drawn below 2**16 with `offsets` put
    on real entries; xbase 0."""
    rng = np.random.default_rng(17)
    width = np.array([0, 3, 1, 0, 5, 4])
    ptr = np.zeros(len(width) + 1, np.int64)
    np.cumsum(width * SLICE, out=ptr[1:])
    total = int(ptr[-1])
    vals = torch.from_numpy(rng.standard_normal(total).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    vals[vals == 0] = 1.0
    off = rng.integers(0, 1 << 16, total).astype(np.int32)
    lens = [rng.integers(0, w + 1, SLICE) for w in width]
    for i, (w, ln) in enumerate(zip(width, lens)):
        if w:
            ln[0] = w                      # the longest row fills the slice
        j = np.arange(w)[:, None]
        pad = np.flatnonzero((j >= ln[None, :]).reshape(-1)) + ptr[i]
        vals[pad], off[pad] = 0.0, 0
    real = np.flatnonzero(vals)
    off[real[:len(offsets)]] = offsets
    return dict(cval=vals, coff=off, slice_ptr=ptr,
                xbase=np.zeros(len(width), np.int64))


def _equal_compact(back, comp):
    np.testing.assert_array_equal(back["cval"].view(np.uint32),
                                  comp["cval"].view(np.uint32))
    for key in ("coff", "slice_ptr", "xbase"):
        assert back[key].dtype == comp[key].dtype, key
        np.testing.assert_array_equal(back[key], comp[key], err_msg=key)


@pytest.mark.parametrize("case", ["edges", "wide_plan"])
def test_packed24_unpacks_bit_for_bit(case):
    """Packed with its high bytes and unpacked, a compact form with int32
    offsets comes back bit for bit: by hand (ragged and empty slices,
    offsets 2**16 - 1, 2**16 and 2**24 - 1) and the 2,500 x 150,000 plan's
    compact form. Word (j, lane) of a slice sits at (j // 4)*128 + lane*4 +
    j % 4, its high byte at the same index; padding words are 0 in both."""
    edges = [(1 << 16) - 1, 1 << 16, (1 << 24) - 1]
    if case == "edges":
        comp = _compact(edges)
    else:
        comp = compact_slices(csr_to_wjd_plan(
            *_wide(rt).numpy_triplet(), (2500, 150_000), values_dtype=BF16,
            **WIDE))
    assert comp["coff"].dtype == np.int32
    packed = pack_bf16_slices(comp)
    chi, cpack = packed["chi"], packed["cpack"]
    assert chi.dtype == np.uint8 and chi.shape == cpack.shape
    width = np.diff(comp["slice_ptr"]) // SLICE
    pwidth = np.diff(packed["slice_ptr"]) // SLICE
    np.testing.assert_array_equal(pwidth, -(-width // PACK) * PACK)
    assert (width == 0).any() and (width % PACK != 0).any()
    _equal_compact(unpack_bf16_slices(cpack, packed["slice_ptr"],
                                      packed["xbase"], chi), comp)
    # every word by hand
    for i in np.flatnonzero(width):
        p0, q0 = comp["slice_ptr"][i], packed["slice_ptr"][i]
        for j in range(int(pwidth[i])):
            for lane in range(SLICE):
                q = q0 + (j // 4) * 128 + lane * 4 + j % 4
                word, hi = int(cpack[q]), int(chi[q])
                if j < width[i]:
                    p = p0 + j * SLICE + lane
                    off = int(comp["coff"][p])
                    assert word >> 16 == off & 0xFFFF and hi == off >> 16
                    assert word & 0xFFFF == int(comp["cval"][p:p + 1].view(
                        np.uint32)[0]) >> 16
                else:
                    assert word == 0 and hi == 0
        if case == "wide_plan":
            break
    if case == "edges":
        off = unpack_bf16_slices(cpack, packed["slice_ptr"],
                                 packed["xbase"], chi)["coff"]
        assert set(edges) <= set(off.tolist())


@pytest.mark.parametrize("top", [(1 << 16) - 1, 1 << 16, (1 << 24) - 1,
                                 1 << 24])
def test_the_offset_width_picks_the_form(top):
    """The widest offset alone picks the form: below 2**16 the packed form
    (no high bytes), below 2**24 the packed24 form, 2**24 and past it the
    compact int32 form, which the packer refuses."""
    comp = _compact([top])
    if top < 1 << 16:
        comp = {**comp, "coff": comp["coff"].astype(np.uint16)}
    bf16, f32 = {"value_dtype": BF16}, {}
    assert not torch_wjd._packs(f32, comp)
    assert torch_wjd._packs(bf16, comp) is (top < 1 << 24)
    if top >= 1 << 24:
        with pytest.raises(ValueError, match="2\\*\\*24"):
            pack_bf16_slices(comp)
        return
    packed = pack_bf16_slices(comp)
    assert ("chi" in packed) is (top >= 1 << 16)
    back = unpack_bf16_slices(packed["cpack"], packed["slice_ptr"],
                              packed["xbase"], packed.get("chi"))
    _equal_compact(back, comp)


def _leave(words, chi, q, off):
    """Words and high bytes with word q's offset set to `off`."""
    words, chi = words.copy(), chi.copy()
    words[q] = (words[q] & 0xFFFF) | (off & 0xFFFF) << 16
    chi[q] = off >> 16
    return words, chi


@pytest.mark.parametrize("regime", ["direct", "windowed"])
def test_a_word_that_leaves_x_or_its_window_is_refused(regime, monkeypatch):
    """A packed24 word whose offset reaches past padded x (direct) or its
    step window (windowed; still inside x) is refused on the host before
    any array is uploaded, and by the plain version (IndexError)."""
    if regime == "windowed":
        _small_windows(monkeypatch)
    else:
        _one_tile_steps(monkeypatch)
    plan = csr_to_wjd_plan(*_wide(rt).numpy_triplet(), (2500, 150_000),
                           values_dtype=BF16, **WIDE)
    real_pack = torch_wjd.pack_bf16_slices
    W = torch_wjd._plan_to_wjd(plan, "cpu")
    assert W.compact_form == "packed24"
    assert W.window_relative is (regime == "windowed")
    words = W.cpack.numpy().view(np.uint32)
    q = int(np.flatnonzero(words & 0xFFFF)[-1])            # a real entry
    if regime == "windowed":
        off = W.win_rows * 128
        assert 1 << 16 < off < 1 << 24 and W.win_rows > 512
    else:
        sl = int(np.searchsorted(W.slice_ptr.numpy(), q, side="right")) - 1
        off = W.xp_len - int(W.xbase[sl])
    bad_words, bad_chi = _leave(words, W.chi.numpy(), q, off)

    def leaving(compact):
        out = real_pack(compact)
        return {**out, **dict(zip(("cpack", "chi"), _leave(
            out["cpack"], out["chi"], q, off)))}

    uploads = []
    real_upload = torch_wjd.to_device
    monkeypatch.setattr(torch_wjd, "pack_bf16_slices", leaving)
    monkeypatch.setattr(torch_wjd, "to_device", lambda *a, **k: (
        uploads.append(a[0]), real_upload(*a, **k))[1])
    with pytest.raises(ValueError, match="window" if regime == "windowed"
                       else "xp_len"):
        torch_wjd._plan_to_wjd(plan, "cpu")
    assert uploads == []
    Wb = dataclasses.replace(W, cpack=torch.from_numpy(bad_words.view(
        np.int32)), chi=torch.from_numpy(bad_chi))
    xp = kernels.pad_x(W, torch.ones(W.shape[1]))
    with pytest.raises(IndexError):
        kernels.plain_gather(Wb)(Wb, xp)


@pytest.fixture(scope="module")
def jax_plans():
    """The JAX planner's bfloat16 gather plan of the wide operator, direct
    (one tile a grid step) and windowed (small windows), as the JAX WJD
    and as the port's WJD carried over by interop, and the port's own
    plan."""
    out = {}
    for regime in ("direct", "windowed"):
        with pytest.MonkeyPatch.context() as mp:
            (_small_windows if regime == "windowed" else _one_tile_steps)(mp)
            Wj = jax_from_csr(_wide(jrt), cache=False, values_dtype=BF16,
                              **WIDE)
            fields = {f.name: getattr(Wj, f.name)
                      for f in dataclasses.fields(Wj)}
            Wt = wjd_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                     else v) for k, v in fields.items()},
                                device="cpu")
            own = from_csr(_wide(rt), values_dtype=BF16, **WIDE)
        out[regime] = (Wj, Wt, own)
    return out


def _jax_product(Wj, X):
    if X.ndim == 1:
        return np.asarray(jax_reference(Wj, jnp.asarray(X)))
    return np.asarray(jax.vmap(lambda c: jax_reference(Wj, c), in_axes=1,
                               out_axes=1)(jnp.asarray(X)))


@pytest.mark.parametrize("regime,cols", [("direct", 1), ("direct", 16),
                                         ("windowed", 1)])
def test_packed24_plain_products_match_jax_reference(regime, cols,
                                                     jax_plans):
    """wjd_spmv (direct, or through the step windows) and wjd_spmm over the
    packed24 form against JAX wjd_reference on the JAX planner's plan; the
    port's own plan packs to the same words and high bytes; the windowed
    plan's windows pass 512 rows. The packed24 product is the compact
    form's bit for bit (the same terms in the same order, plus zero
    words)."""
    Wj, Wt, own = jax_plans[regime]
    assert Wt.compact_form == own.compact_form == "packed24"
    assert Wt.window_relative is (regime == "windowed")
    assert windowed(Wt, torch.float32) is (regime == "windowed")
    if regime == "windowed":
        assert Wt.win_rows > 512 and len(Wt.win_base) > 1
    for key in ("cpack", "chi", "slice_ptr", "xbase"):
        assert torch.equal(getattr(Wt, key), getattr(own, key)), key
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
    c = unpack_bf16_slices(*(getattr(Wt, k).numpy() for k in (
        "cpack", "slice_ptr", "xbase", "chi")))
    Wc = dataclasses.replace(
        Wt, cpack=None, chi=None, slice_ptr=torch.from_numpy(c["slice_ptr"]),
        cval=torch.from_numpy(c["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"]))
    assert Wc.compact_form == "compact"
    yc = (kernels.wjd_spmv(Wc, Xt) if cols == 1
          else kernels.wjd_spmm(Wc, Xt))
    assert torch.equal(y, yc)


def _far_coupled(n=70_000, d=66_000):
    """An SPD operator: 5 on the diagonal, -1 on diagonals -1, +1, -d, +d
    (strictly dominant); rows below n - d reach d columns away, so their
    slices span more than 65,535 elements of x."""
    S = sp.diags([5.0, -1.0, -1.0, -1.0, -1.0], [0, -1, 1, -d, d],
                 shape=(n, n), format="csr", dtype=np.float32)
    S.sort_indices()
    return rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape)


def test_cg_over_packed24_stops_where_the_compact_form_does():
    """One f32 CG + Jacobi over a packed24 bfloat16 plan and over the same
    plan in the compact int32 form (on the CPU: their plain products): the
    same status and count, the same solution within rounding (rtol 1e-4,
    atol 1e-5: a few f32 ulps of the iterates)."""
    A = _far_coupled()
    rt.attach_wjd(A, values_dtype=BF16, kernel_mode="gather",
                  split_dia=False)
    W = A._wjd_cache
    assert W.compact_form == "packed24" and not W.window_relative
    c = unpack_bf16_slices(*(getattr(W, k).numpy() for k in (
        "cpack", "slice_ptr", "xbase", "chi")))
    assert c["coff"].dtype == np.int32 and int(c["coff"].max()) >= 1 << 16
    B = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    object.__setattr__(B, "_wjd_cache", dataclasses.replace(
        W, cpack=None, chi=None, slice_ptr=torch.from_numpy(c["slice_ptr"]),
        cval=torch.from_numpy(c["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"])))
    assert B._wjd_cache.compact_form == "compact"
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(np.float32))
    out = {}
    for tag, op in (("packed24", A), ("compact", B)):
        x, info = rt.cg(op, b, M=rt.jacobi(op), rel_tol=1e-5, max_iter=500,
                        check_every=1)
        out[tag] = (int(info.status), int(info.iterations), x)
    assert out["packed24"][0] == out["compact"][0] == 2
    assert out["packed24"][1] == out["compact"][1]
    torch.testing.assert_close(out["packed24"][2], out["compact"][2],
                               rtol=1e-4, atol=1e-5)
