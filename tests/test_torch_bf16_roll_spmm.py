"""Port parity: the plans behind the direct bf16 roll SpMV and the compact
bf16 SpMM.

The direct bf16 roll kernel is the windowed bf16 roll body with no window
(csrc/spmv_wjd_win.cu): a direct roll plan read as one window at base 0
whose grid step holds every tile. Here its plain windowed product under
that view is its plain direct product bit for bit, and both equal the JAX
`wjd_reference` on the JAX planner's bf16 roll plan at 1e-5 (the same f32
products of the same bfloat16 values, summed in another order), on
laplacian_3d(12) and on a band whose slots read x at every alignment
(diag_u mod 4). A bf16 plan whose offsets pass 16 bits takes the packed24
form (below 2**24) and its SpMM; the compact bf16 SpMM serves the same
plan unpacked to its compact form with int32 offsets, the form of a plan
past 24 bits. Here both forms' plain blocked products over 4, 8, 16 and
20 columns (16 + 4 a launch each) equal the JAX `wjd_reference`, vmapped
over the columns, at 1e-5. The kernels themselves are checked by
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
from rocalution_tpu_torch.formats.wjd import from_csr, unpack_bf16_slices
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = "bfloat16"
# max|y_port - y_jax| / max|y_jax|: the same f32 products of the same
# bfloat16 values, summed in another order (tests/test_torch_bf16.py)
RTOL = 1e-5
ROLL = dict(kernel_mode="roll", split_dia=False)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _csr(module, S):
    S.sort_indices()
    return module.CSR.from_arrays(S.data.astype(np.float32),
                                  S.indices.astype(np.int32),
                                  S.indptr.astype(np.int32), S.shape)


def _band(module):
    """3,000 rows with random values on the diagonals -3 .. 3: slot
    offsets of every residue mod 4, a ragged last tile."""
    rng = np.random.default_rng(9)
    n = 3000
    S = sp.diags([rng.standard_normal(n - abs(d)) for d in range(-3, 4)],
                 list(range(-3, 4)), shape=(n, n), format="csr")
    return _csr(module, S)


def _wide(module):
    """2,500 rows whose columns scatter over 150,000: every slice spans
    more than 65,535 elements of x, so the plan's offsets pass 16 bits."""
    rng = np.random.default_rng(5)
    S = sp.random(2500, 150_000, density=8 / 150_000, format="csr",
                  random_state=rng)
    S.data = rng.standard_normal(S.nnz)
    return _csr(module, S)


ROLL_OPERATORS = {
    "lap3d_12": lambda m: m.laplacian_3d(12, dtype=np.float32),
    "band": _band,
}


def _jax_product(Wj, X):
    if X.ndim == 1:
        return np.asarray(jax_reference(Wj, jnp.asarray(X)))
    return np.asarray(jax.vmap(lambda c: jax_reference(Wj, c), in_axes=1,
                               out_axes=1)(jnp.asarray(X)))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(ROLL_OPERATORS))
def test_direct_roll_plan_as_one_window(name):
    """A direct bf16 roll plan read as one window at base 0 (win_base [0],
    group = Tp, win_rows = xp_len / 128): the plain windowed product is
    the plain direct product bit for bit, and the whole product equals the
    JAX wjd_reference on the JAX planner's bf16 roll plan."""
    W = from_csr(ROLL_OPERATORS[name](rt), values_dtype=BF16, **ROLL)
    assert W.kernel_mode == "roll" and W.dtype == torch.bfloat16
    assert not torch_wjd.windowed(W, torch.float32)
    Tp, _ = W.brow.shape
    if name == "band":
        assert set((W.diag_u & 3).unique().tolist()) == {0, 1, 2, 3}
    one = dataclasses.replace(W, win_base=torch.zeros(1, dtype=torch.int32),
                              group=Tp, win_rows=W.xp_len // 128)
    x = np.random.default_rng(7).standard_normal(W.shape[1]).astype(
        np.float32)
    xt = torch.from_numpy(x)
    xp = kernels.pad_x(W, xt)
    assert torch.equal(kernels.slots_plain_windowed(one, xp),
                       kernels.slots_plain(W, xp))
    y_direct = kernels.wjd_spmv(W, xt)
    y_window = kernels._apply(one, xt, kernels.slots_plain_windowed)
    assert torch.equal(y_window, y_direct)
    Wj = jax_from_csr(ROLL_OPERATORS[name](jrt), cache=False,
                      values_dtype=BF16, **ROLL)
    assert Wj.kernel_mode == "roll"
    _close(y_direct.numpy(), _jax_product(Wj, x))


@pytest.fixture(scope="module")
def wide_plans():
    """The port's and the JAX planner's bf16 plans of the wide operator
    (one tile per grid step in both), a random X of 20 columns and the
    JAX product A X (each column its own wjd_reference)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_wjd, torch_wjd):
            mp.setattr(mod, "_auto_group", lambda K: 1)
        W = from_csr(_wide(rt), values_dtype=BF16, split_dia=False)
        Wj = jax_from_csr(_wide(jrt), cache=False, values_dtype=BF16,
                          split_dia=False)
    X = np.random.default_rng(3).standard_normal(
        (W.shape[1], 20)).astype(np.float32)
    return W, X, _jax_product(Wj, X)


@pytest.mark.parametrize("cols", [4, 8, 16, 20])
def test_wide_plan_blocked_product_matches_jax_reference(cols, wide_plans):
    """The bf16 plan of the wide operator takes the packed24 form (offsets
    past 16 bits, below 2**24); its plain blocked product on `cols`
    columns, through wjd_spmm and rt.spmv, equals the JAX product of the
    same columns, and so does the same plan's compact form with int32
    offsets (`unpack_bf16_slices`: the compact bf16 SpMM's form)."""
    W, X, want = wide_plans
    assert W.compact_form == "packed24" and not W.window_relative
    Xt = torch.from_numpy(np.ascontiguousarray(X[:, :cols]))
    Y = kernels.wjd_spmm(W, Xt)
    assert Y.dtype == torch.float32 and tuple(Y.shape) == (W.shape[0], cols)
    _close(Y.numpy(), want[:, :cols])
    assert torch.equal(rt.spmv(W, Xt), Y)
    c = unpack_bf16_slices(*(getattr(W, k).numpy() for k in (
        "cpack", "slice_ptr", "xbase", "chi")))
    Wc = dataclasses.replace(
        W, cpack=None, chi=None, slice_ptr=torch.from_numpy(c["slice_ptr"]),
        cval=torch.from_numpy(c["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"]))
    assert Wc.compact_form == "compact" and Wc.coff.dtype == torch.int32
    Yc = kernels.wjd_spmm(Wc, Xt)
    _close(Yc.numpy(), want[:, :cols])
    assert torch.equal(Yc, Y)
