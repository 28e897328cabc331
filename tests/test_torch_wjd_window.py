"""Port parity: the windowed regime of the WJD SpMV.

Above `X_VMEM_BUDGET` bytes of padded x the JAX package runs kernels that
read x through per-step windows (`win_base`, `win_rows`); the port keeps
that rule (formats/wjd.py:`windowed`) and has windowed kernels and a
windowed plain version. Here, on the CPU, the plain version
`slots_plain_windowed` is held bit for bit against the direct
`slots_plain` (the same loads, addressed relative to the window) and the
whole apply against the JAX `wjd_reference` (f64 rtol 1e-13, f32 rtol 2e-5:
sums in another order). A gather-mode f32 plan in the regime carries its
compact slice form window-relative (offsets from `win_base[step]*128`):
that form must hold the entries of the per-slice form (exactly),
`slots_plain_compact_windowed` must equal `slots_plain_compact` bit for bit
(the same terms in the same order), a load that leaves its window must be
refused when the plan is built, and a plan carried over from the JAX
planner must get the same form. The regime is reached on small operators by
setting the budget small, as tests/test_wjd.py does. The CUDA kernels
themselves are checked by tests/test_torch_kernels.py, which needs a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as wjd_mod
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference as jax_reference
from rocalution_tpu_torch.formats.wjd import (_check_compact_windows,
                                              _plan_to_wjd, compact_entries,
                                              compact_slices, csr_to_wjd_plan,
                                              from_csr, windowed)
from rocalution_tpu_torch.interop import wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

GENERATORS = {
    "lap2d_30": lambda m, dt: m.laplacian_2d(30, dtype=dt),
    "lap3d_12": lambda m, dt: m.laplacian_3d(12, dtype=dt),
    "randband_3000": lambda m, dt: m.random_banded_spd(
        3000, bandwidth=512, dtype=dt),
}
RTOL = {np.float64: 1e-13, np.float32: 2e-5}
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture
def small_budget(monkeypatch):
    """Force the windowed regime on small operators: the planner sizes its
    groups, and `windowed` picks the kernel, by this constant."""
    monkeypatch.setattr(wjd_mod, "X_VMEM_BUDGET", 1024)
    _one_tile_steps(monkeypatch)


def _one_tile_steps(monkeypatch):
    """One tile per grid step, so that operators of two or three tiles have
    as many windows (the planner's own groups of 8 to 64 tiles would give
    them one). The product does not depend on the grouping."""
    monkeypatch.setattr(wjd_mod, "_auto_group", lambda K: 1)
    monkeypatch.setattr(wjd_mod, "_auto_group_windowed", lambda K: 1)


def _x(n, dtype, seed=7):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_windowed_plain_equals_direct_and_jax(name, dtype, small_budget):
    Aj, At = GENERATORS[name](jrt, dtype), GENERATORS[name](rt, dtype)
    # split_dia=False: with the split a pure f32 stencil has no slots left
    W = from_csr(At, split_dia=False)
    assert W.win_base is not None and W.win_rows > 0
    assert W.group == 1 and len(W.win_base) == -(-At.shape[0] // 1024)
    x = _x(At.shape[1], dtype)
    xp = kernels.pad_x(W, torch.from_numpy(x))
    y_win = kernels.slots_plain_windowed(W, xp)
    assert torch.equal(y_win, kernels.slots_plain(W, xp))
    # a gather plan that the windowed kernel serves is window-relative, and
    # its plain version adds the direct compact product's terms in its order
    relative = W.kernel_mode == "gather" and dtype == np.float32
    assert W.window_relative is relative
    if relative:
        assert torch.equal(kernels.slots_plain_compact_windowed(W, xp),
                           kernels.slots_plain_compact(W, xp))
    # the whole apply, through the dispatch where the regime allows it
    Wj = jax_from_csr(Aj, cache=False, split_dia=False)
    want = np.asarray(jax_reference(Wj, jnp.asarray(x)))
    got = kernels.wjd_spmv(W, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())


CASES = [  # name, dtype, windowed under a small budget?
    ("lap3d_12", np.float64, True),        # roll f64: _kernel_roll_ff_hbm
    ("lap3d_12", np.float32, True),        # roll f32: _kernel_roll_hbm
    ("randband_3000", np.float32, "compact"),  # gather f32: _kernel_hbm
    ("randband_3000", np.float64, False),  # gather f64: no windowed kernel
]
# what a CPU tensor takes outside the windowed regime: the slot product in
# roll mode, the product over the compact slice form in gather mode
DIRECT = {"lap3d_12": "slots_plain", "randband_3000": "slots_plain_compact"}


@pytest.mark.parametrize("name,dtype,want", CASES)
def test_windowed_dispatch(name, dtype, want, monkeypatch):
    At = GENERATORS[name](rt, dtype)
    W_resident = from_csr(At, split_dia=False)
    assert not windowed(W_resident, TORCH_DT[dtype])   # 12 MiB: resident
    monkeypatch.setattr(wjd_mod, "X_VMEM_BUDGET", 1024)
    _one_tile_steps(monkeypatch)
    W = from_csr(At, split_dia=False)
    assert windowed(W, TORCH_DT[dtype]) is bool(want)
    calls = []
    for fn in ("slots_plain", "slots_plain_windowed", "slots_plain_compact",
               "slots_plain_compact_windowed"):
        monkeypatch.setattr(kernels, fn, lambda A, xp, fn=fn, real=getattr(
            kernels, fn): calls.append(fn) or real(A, xp))
    x = torch.from_numpy(_x(At.shape[1], dtype))
    y = kernels.wjd_spmv(W, x)
    # in the regime: over the window-relative compact form in gather mode,
    # over the slot planes in roll mode
    assert calls == [{True: "slots_plain_windowed",
                      "compact": "slots_plain_compact_windowed",
                      False: DIRECT[name]}[want]]
    torch.testing.assert_close(y, kernels.wjd_reference(W, x),
                               rtol=RTOL[dtype], atol=RTOL[dtype])
    # the reference is the padded slot product, direct
    assert set(calls[1:]) == {"slots_plain"}


def test_windowed_needs_windows():
    """A plan without win_base (no slots) is never in the windowed regime."""
    At = rt.laplacian_2d(10, dtype=np.float32)
    W = from_csr(At, split_dia="auto")     # all diagonals split off to DIA
    assert W.win_base is None
    assert not windowed(W, torch.float32)


@pytest.mark.parametrize("name", ["lap3d_12", "randband_3000"])
def test_plan_that_breaks_a_window_is_refused(name, small_budget):
    At = GENERATORS[name](rt, np.float32)
    plan = csr_to_wjd_plan(*At.numpy_triplet(), At.shape, split_dia=False)
    assert len(plan["win_base"]) > 1
    _plan_to_wjd(plan, device="cpu")          # the planner's own plan fits
    # a slot whose base row lies below its step's window
    low = dict(plan, win_base=plan["win_base"].copy())
    low["win_base"][1] += 1
    with pytest.raises(ValueError, match="step window"):
        _plan_to_wjd(low, device="cpu")
    # a slot whose load rows pass the end of its step's window (the
    # planner leaves 8 to 15 rows of slack)
    short = dict(plan, win_rows=plan["win_rows"] - 16)
    with pytest.raises(ValueError, match="step window"):
        _plan_to_wjd(short, device="cpu")
    # a last window that passes the end of padded x
    long = dict(plan, win_rows=plan["xp_len"] // 128 + 8)
    with pytest.raises(ValueError, match="xp_len"):
        _plan_to_wjd(long, device="cpu")
    # win_base must have one entry per step
    with pytest.raises(ValueError, match="win_base"):
        _plan_to_wjd(dict(plan, group=plan["group"] * 2 + 1), device="cpu")


def test_windowed_plain_raises_outside_its_window(small_budget):
    """The windowed plain version reads x only through the window."""
    import dataclasses

    W = from_csr(rt.laplacian_3d(12), split_dia=False)
    xp = torch.zeros(W.xp_len, dtype=torch.float64)
    tight = dataclasses.replace(W, win_rows=8)
    with pytest.raises(IndexError):
        kernels.slots_plain_windowed(tight, xp)


def _gather_plan(dtype=np.float32, **kw):
    At = GENERATORS["randband_3000"](rt, dtype)
    return At, csr_to_wjd_plan(*At.numpy_triplet(), At.shape, **kw)


@pytest.mark.parametrize("kw", [{}, {"max_slots": 4}], ids=["full", "spill"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_window_relative_form_holds_the_same_entries(dtype, kw, small_budget):
    """The same values at the same places, the same offsets into padded x
    once each slice's base is added, and a base that is the step's window:
    so a row's terms come in the same order as in the per-slice form."""
    _, plan = _gather_plan(dtype, **kw)
    per_slice, rel = compact_slices(plan), compact_slices(plan, True)
    assert rel["window_relative"] and not per_slice["window_relative"]
    assert np.array_equal(rel["cval"], per_slice["cval"])
    assert np.array_equal(rel["slice_ptr"], per_slice["slice_ptr"])
    names = ("cval", "coff", "slice_ptr", "xbase")
    for a, b in zip(compact_entries(*(rel[f] for f in names)),
                    compact_entries(*(per_slice[f] for f in names))):
        assert np.array_equal(a, b)
    assert len(plan["win_base"]) > 1 and plan["group"] == 1
    assert np.array_equal(rel["xbase"], np.repeat(
        plan["win_base"].astype(np.int64) * 128, 32))
    assert rel["coff"].dtype == np.uint16
    assert int(rel["coff"].max()) < plan["win_rows"] * 128
    _check_compact_windows(rel, plan)


def test_compact_load_that_leaves_its_window_is_refused(small_budget,
                                                        monkeypatch):
    """Checked on the host before any upload: the windowed gather kernel
    reads x from its step's window unchecked."""
    _, plan = _gather_plan()
    good = compact_slices(plan, True)
    _check_compact_windows(good, plan)
    deep = dict(good, coff=good["coff"].copy())
    deep["coff"][np.flatnonzero(good["cval"])[0]] = plan["win_rows"] * 128
    moved = dict(good, xbase=good["xbase"].copy())
    moved["xbase"][40] += 128                  # a slice not on its window
    for bad, match in ((deep, "step window"), (moved, "step windows")):
        with pytest.raises(ValueError, match=match):
            _check_compact_windows(bad, plan)
    with pytest.raises(ValueError, match="xp_len"):    # the last window
        _check_compact_windows(good, dict(
            plan, xp_len=(int(plan["win_base"].max()) + plan["win_rows"])
            * 128 - 128))
    # an entry below its window cannot be written as an unsigned offset
    with pytest.raises(ValueError, match="below its step window"):
        compact_slices(dict(plan, win_base=plan["win_base"] + 64), True)
    # and nothing is uploaded once the check fails
    uploads = []
    monkeypatch.setattr(wjd_mod, "compact_slices", lambda plan_, **kw: deep)
    monkeypatch.setattr(wjd_mod, "to_device",
                        lambda *a, **k: uploads.append(a))
    with pytest.raises(ValueError, match="step window"):
        _plan_to_wjd(plan, device="cpu")
    assert not uploads


def test_compact_windowed_plain_raises_outside_its_window(small_budget):
    At, _ = _gather_plan()
    W = from_csr(At)
    assert W.window_relative
    xp = torch.zeros(W.xp_len, dtype=torch.float32)
    kernels.slots_plain_compact_windowed(W, xp)
    with pytest.raises(IndexError):
        kernels.slots_plain_compact_windowed(
            dataclasses.replace(W, win_rows=8), xp)


def test_per_slice_form_in_the_regime_stays_on_the_direct_product(
        monkeypatch):
    """Which product serves a gather plan is decided once, when its compact
    form is built. A per-slice form keeps the direct product even where
    the budget, read again at apply time, would put the plan in the
    windowed regime; the windowed plain version refuses it, as the kernel's
    wrapper does, and does not add window bases to per-slice offsets."""
    At, _ = _gather_plan()
    W = from_csr(At)                           # 12 MiB budget: per-slice form
    assert W.win_base is not None and not W.window_relative
    monkeypatch.setattr(wjd_mod, "X_VMEM_BUDGET", 1024)
    assert not windowed(W, torch.float32)
    x = torch.from_numpy(_x(At.shape[1], np.float32))
    xp = kernels.pad_x(W, x)
    with pytest.raises(ValueError, match="window-relative"):
        kernels.slots_plain_compact_windowed(W, xp)
    # exact: both are the direct product over the same compact form
    assert torch.equal(kernels.wjd_spmv(W, x), kernels.wjd_reference(
        dataclasses.replace(W, data=None, uloc=None), x))
    # rtol 2e-5 (f32) against the padded slot product: sums in another order
    torch.testing.assert_close(kernels.wjd_spmv(W, x),
                               kernels.wjd_reference(W, x),
                               rtol=2e-5, atol=2e-5)


def test_jax_planned_plan_gets_the_window_relative_form(small_budget,
                                                        monkeypatch):
    """A gather plan made by the JAX planner in the windowed regime and
    carried across as numpy arrays gets the form the port's own planner
    gives (exactly), and applies through it (f32 rtol 2e-5 against the JAX
    `wjd_reference`: sums in another order)."""
    import rocalution_tpu.formats.wjd as jax_wjd

    monkeypatch.setattr(jax_wjd, "X_VMEM_BUDGET", 1024)
    monkeypatch.setattr(jax_wjd, "_auto_group", lambda K: 1)
    monkeypatch.setattr(jax_wjd, "_auto_group_windowed", lambda K: 1)
    Aj = GENERATORS["randband_3000"](jrt, np.float32)
    Wj = jax_from_csr(Aj, cache=False)
    fields = {f.name: getattr(Wj, f.name) for f in dataclasses.fields(Wj)}
    Wt = wjd_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v)
                         for k, v in fields.items()}, device="cpu")
    # the JAX planner's default is the reference's split rule
    W = from_csr(GENERATORS["randband_3000"](rt, np.float32),
                 split_dia="auto")
    assert Wt.window_relative and windowed(Wt, torch.float32)
    for name in ("cval", "coff", "slice_ptr", "xbase", "win_base"):
        assert torch.equal(getattr(Wt, name), getattr(W, name)), name
    assert (Wt.win_rows, Wt.group) == (W.win_rows, W.group)
    x = _x(Aj.shape[1], np.float32)
    got = kernels.wjd_spmv(Wt, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_reference(Wj, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
