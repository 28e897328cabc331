"""Port parity: the row-compacted slice form of gather-mode WJD plans.

A gather-mode plan is mostly padding (a slot for every (tile, window, rank)
that any of 1024 rows occupies), so the port's direct gather kernels read a
compact form instead (formats/wjd.py:`compact_slices`): slices of 32 rows,
each row's real entries packed in ascending slot order, 2-byte or 4-byte
offsets into padded x relative to a per-slice base. Here, on the CPU:

* the compact form holds exactly the plan's real entries;
* its plain product (`slots_plain_compact`, which a CPU tensor takes)
  equals the JAX package's product on the same operator and the port's
  padded slot product: 1e-12 relative in f64, 1e-5 in f32 (sums in another
  order), for one right-hand side and for blocks of 16 and 20;
* a slice that spans 65,536 or more elements of x takes int32 offsets;
* a compact form that would read outside padded x is refused.

The JAX side runs as its own tests run it on the CPU: the plain CSR apply
for one right-hand side; for blocks `spmv(W, X)`, which is `wjd_reference`
per column in f64 and the Pallas kernel in interpret mode in f32 (on a
300 x 300 operator with two slots a tile, in chunks of two columns:
interpreting costs seconds). The CUDA kernels are checked by
tests/test_torch_kernels.py, which needs a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as wjd_mod
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu_torch.formats.convert import to_csr
from rocalution_tpu_torch.formats.wjd import (SLICE, _check_compact_reach,
                                              _plan_to_wjd, compact_slices,
                                              csr_to_wjd_plan, from_csr)
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _scipy_pair(S, dtype, seed=3):
    """The same CSR triplet in both packages, values from a seed."""
    S = sp.csr_matrix(S)
    S.data = np.random.default_rng(seed).standard_normal(S.nnz).astype(dtype)
    S.sort_indices()
    args = (S.data, S.indices.astype(np.int32), S.indptr.astype(np.int32),
            S.shape)
    return jrt.CSR.from_arrays(*args), rt.CSR.from_arrays(*args)


def _empty_rows(dtype):
    """1,500 rows, every third one empty."""
    S = sp.random(1500, 1500, density=0.006, format="lil",
                  random_state=np.random.default_rng(9))
    S[::3] = 0
    return _scipy_pair(S.tocsr(), dtype)


def _wide(dtype):
    """700 rows whose columns scatter over 140,000: a slice of 32 rows
    spans more than 65,535 elements of x."""
    S = sp.random(700, 140_000, density=6 / 140_000, format="csr",
                  random_state=np.random.default_rng(5))
    return _scipy_pair(S, dtype)


OPERATORS = {
    # name: (make the pair for a dtype, planner kwargs)
    "lap2d_30_gather": (lambda dt: (jrt.laplacian_2d(30, dtype=dt),
                                    rt.laplacian_2d(30, dtype=dt)),
                        {"kernel_mode": "gather", "split_dia": False}),
    "randband_3000": (lambda dt: (
        jrt.random_banded_spd(3000, bandwidth=512, dtype=dt),
        rt.random_banded_spd(3000, bandwidth=512, dtype=dt)), {}),
    "randband_3000_spill": (lambda dt: (
        jrt.random_banded_spd(3000, bandwidth=512, dtype=dt),
        rt.random_banded_spd(3000, bandwidth=512, dtype=dt)),
        {"max_slots": 3}),
    "empty_rows_1500": (_empty_rows, {"kernel_mode": "gather"}),
    "wide_700": (_wide, {"kernel_mode": "gather", "split_dia": False}),
}
DTYPES = [np.float64, np.float32]


def _plan(At, kw):
    return csr_to_wjd_plan(*At.numpy_triplet(), At.shape, **kw)


def _x(shape, dtype, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, dtype):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_compact_form_holds_the_plans_real_entries(name, dtype):
    """Rebuilt as COO, the compact form is the CSR it came from less the
    spill and the DIA part; its layout is what the kernels assume."""
    make, kw = OPERATORS[name]
    _, At = make(dtype)
    plan = _plan(At, kw)
    assert plan["kernel_mode"] == "gather"
    assert At.shape[0] % 1024                  # a ragged last tile
    c = compact_slices(plan)
    ptr, Tp = c["slice_ptr"], plan["brow"].shape[0]
    assert len(ptr) == Tp * (1024 // SLICE) + 1 == len(c["xbase"]) + 1
    assert ptr[0] == 0 and ptr[-1] == len(c["cval"]) == len(c["coff"])
    assert not (np.diff(ptr) % SLICE).any()
    # COO of the compact form
    p = np.flatnonzero(c["cval"])
    sl = np.searchsorted(ptr, p, side="right") - 1
    rows = sl * SLICE + p % SLICE
    cols = c["xbase"][sl] + c["coff"][p].astype(np.int64) - plan["pad_lo"]
    got = sp.csr_matrix((c["cval"][p], (rows, cols)), shape=At.shape)
    # the CSR less the spill and less the DIA part (f32 plans split off
    # globally dense diagonals)
    d, i, ip = At.numpy_triplet()
    want = sp.csr_matrix((d, i, ip), shape=At.shape) - sp.csr_matrix(
        (plan["spill_val"], (plan["spill_row"], plan["spill_col"])),
        shape=At.shape)
    if plan["dia_data"] is not None:
        want = want - sp.dia_matrix(
            (np.stack([np.roll(row, off) for row, off in zip(
                plan["dia_data"], plan["dia_offsets"])]),
             plan["dia_offsets"]), shape=At.shape).tocsr()
    want.eliminate_zeros()
    got.sort_indices(), want.sort_indices()
    assert got.nnz == want.nnz == plan["nnz"] - len(plan["spill_val"])
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)
    if "spill" in name:
        assert len(plan["spill_val"]) > 0
    # a row's entries lie at ranks 0..len-1 in ascending slot order, which
    # within one (row, window) run is ascending column order
    filled = c["cval"] != 0
    for s_ in range(0, len(ptr) - 1, 7):
        block = filled[ptr[s_]:ptr[s_ + 1]].reshape(-1, SLICE)
        assert not (block[1:] & ~block[:-1]).any()
        offs = c["coff"][ptr[s_]:ptr[s_ + 1]].reshape(-1, SLICE).astype(int)
        assert (np.diff(offs, axis=0)[block[1:]] > 0).all()
    # padding points at the slice's base
    assert not c["coff"][~filled].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_compact_spmv_matches_jax_and_padded(name, dtype):
    make, kw = OPERATORS[name]
    Aj, At = make(dtype)
    W = from_csr(At, **kw)
    assert W.kernel_mode == "gather" and W.cval is not None
    assert W.data is not None                  # a CPU plan keeps its planes
    x = _x(At.shape[1], dtype)
    xt = torch.from_numpy(x)
    used = []
    real = kernels.slots_plain_compact
    kernels.slots_plain_compact = lambda A, xp: used.append(1) or real(A, xp)
    try:
        got = kernels.wjd_spmv(W, xt).numpy()
    finally:
        kernels.slots_plain_compact = real
    assert used == [1]               # the dispatch took the compact form
    _close(got, np.asarray(jrt.spmv(Aj, jnp.asarray(x))), dtype)
    # the port's padded slot product, slots alone and the whole apply
    xp = kernels.pad_x(W, xt)
    _close(kernels.slots_plain_compact(W, xp).numpy(),
           kernels.slots_plain(W, xp).numpy(), dtype)
    _close(got, kernels.wjd_reference(W, xt).numpy(), dtype)


@pytest.fixture
def jax_chunks_of_two(monkeypatch):
    """The interpreted Pallas kernel is traced per chunk width; two columns
    a chunk keep it cheap, and its result does not depend on the chunk."""
    import rocalution_tpu.formats.wjd as jax_wjd
    from rocalution_tpu.ops.pallas import spmv_wjd as jax_mod

    monkeypatch.setattr(jax_mod, "_MRHS_MAX_COLS", 2)
    # one tile per grid step: the interpreted kernel unrolls group x K slot
    # bodies, and the planner pads one tile of rows to a group of 8
    monkeypatch.setattr(jax_wjd, "_auto_group", lambda K: 1)


def _rand_300(dtype):
    return _scipy_pair(sp.random(300, 300, density=0.02, format="csr",
                                 random_state=np.random.default_rng(3)),
                       dtype)


# the interpreted f32 kernel is traced slot by slot: two slots a tile (the
# rest spills) keep it to a second
MRHS_CASES = (
    [(n, np.float64, k) for n in ("randband_3000_spill", "wide_700")
     for k in (16, 20)]
    + [("rand_300_spill", np.float32, 16), ("rand_300_spill", np.float32, 20)]
)


@pytest.mark.parametrize("name,dtype,k", MRHS_CASES)
def test_compact_spmm_matches_jax_and_padded(name, dtype, k,
                                             jax_chunks_of_two):
    make, kw = OPERATORS.get(name, (_rand_300, {"max_slots": 2}))
    Aj, At = make(dtype)
    Wj, W = jax_from_csr(Aj, cache=False, **kw), from_csr(At, **kw)
    assert W.kernel_mode == Wj.kernel_mode == "gather"
    X = _x((At.shape[1], k), dtype)
    Xt = torch.from_numpy(X)
    got = rt.spmv(W, Xt)
    assert got.shape == (At.shape[0], k) and got.is_contiguous()
    _close(got.numpy(), np.asarray(jrt.spmv(Wj, jnp.asarray(X))), dtype)
    _close(got.numpy(), kernels.wjd_reference(W, Xt).numpy(), dtype)
    xp = kernels.pad_x(W, Xt[:, :16].contiguous(), 16)
    _close(kernels.slots_plain_compact_mrhs(W, xp).numpy(),
           kernels.slots_plain_mrhs(W, xp).numpy(), dtype)
    # a column is the single apply of that column, bit for bit
    assert torch.equal(got[:, k - 1],
                       kernels.wjd_spmv(W, Xt[:, k - 1].contiguous()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_offset_width_follows_the_slice_span(dtype):
    """Fewer than 65,536 elements of x under every slice: uint16; else
    int32 for the whole plan, and the same product."""
    _, band = OPERATORS["randband_3000"][0](dtype)
    assert from_csr(band).coff.dtype == torch.uint16
    make, kw = OPERATORS["wide_700"]
    Aj, At = make(dtype)
    W = from_csr(At, **kw)
    assert W.coff.dtype == torch.int32
    assert int(W.coff.max()) >= 1 << 16
    x = _x(At.shape[1], dtype)
    _close(kernels.wjd_spmv(W, torch.from_numpy(x)).numpy(),
           np.asarray(jrt.spmv(Aj, jnp.asarray(x))), dtype)


def test_compact_form_that_leaves_x_is_refused(monkeypatch):
    """Every load xbase + coff must lie in [0, xp_len): checked on the host
    before any upload, because the kernels read x unchecked."""
    _, At = OPERATORS["randband_3000"][0](np.float64)
    plan = _plan(At, {})
    c = compact_slices(plan)
    _check_compact_reach(c, plan["xp_len"])     # what was just built fits
    last = np.flatnonzero(np.diff(c["slice_ptr"]))[-1]
    deep = dict(c, xbase=c["xbase"].copy())
    deep["xbase"][last] = plan["xp_len"]
    low = dict(c, xbase=c["xbase"].copy())
    low["xbase"][0] = -1
    for bad in (deep, low):
        with pytest.raises(ValueError, match="xp_len"):
            _check_compact_reach(bad, plan["xp_len"])
        uploads = []
        monkeypatch.setattr(wjd_mod, "compact_slices",
                            lambda plan_, **kw: bad)
        monkeypatch.setattr(wjd_mod, "to_device",
                            lambda *a, **k: uploads.append(a))
        with pytest.raises(ValueError, match="xp_len"):
            _plan_to_wjd(plan, device="cpu")
        assert not uploads
        monkeypatch.undo()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["randband_3000_spill", "empty_rows_1500",
                                  "wide_700"])
def test_to_csr_round_trips_a_compact_plan(name, dtype):
    """With its slot planes (a CPU plan) and from the compact form alone
    (what a plan on the card carries)."""
    make, kw = OPERATORS[name]
    _, At = make(dtype)
    W = from_csr(At, **kw)
    bare = dataclasses.replace(W, data=None, uloc=None)
    assert bare.dtype == W.dtype and bare.device == W.device
    for form in (W, bare):
        back = to_csr(form)
        for a, b in zip(At.numpy_triplet(), back.numpy_triplet()):
            np.testing.assert_array_equal(a, b)
    if At.shape[1] < 5000:
        np.testing.assert_array_equal(
            rt.convert(bare, "DENSE").data.numpy(),
            rt.convert(At, "DENSE").data.numpy())
    # the reference follows the form that is there
    x = torch.from_numpy(_x(At.shape[1], dtype))
    _close(kernels.wjd_reference(bare, x).numpy(),
           kernels.wjd_reference(W, x).numpy(), dtype)


def test_padding_ratios():
    """`padding_ratio` keeps its meaning (slot elements over entries); the
    compact form's ratio is far below it on a scattered operator."""
    W = from_csr(rt.random_banded_spd(3000, bandwidth=512))
    Tp, K = W.brow.shape
    assert W.padding_ratio == Tp * K * 1024 / W.nnz
    assert W.compact_padding_ratio == W.cval.numel() / W.nnz
    assert 1.0 <= W.compact_padding_ratio < 2.0 < W.padding_ratio


def test_roll_plans_carry_no_compact_form():
    W = from_csr(rt.laplacian_2d(30))
    assert W.kernel_mode == "roll"
    assert W.cval is None and W.coff is None and W.data is not None
