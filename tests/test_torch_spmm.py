"""Port parity: blocked right-hand sides, `rt.spmv(A, X)` with X of shape
(m, k), for WJD plans, CSR operands with an attached plan, and the plain CSR
and DIA applies.

On the CPU the port's `wjd_spmm` takes its plain version
(`slots_plain_mrhs`); it is held against the JAX package's `spmv(W, X)`
run as tests/test_wjd.py runs it: the Pallas blocked-RHS kernel in interpret
mode for f32 (rtol 2e-5: f32 sums in another order), `wjd_reference` per
column for f64 (rtol 1e-13: f64 sums in another order). The interpreted
operators keep the reference tests' sizes (600 x 500, 300 x 300): an
interpreted f32 plan costs seconds per chunk width it is traced for. So the
JAX side runs once per operator and value type, on 20 columns in chunks of
two (one trace) with one tile per grid step, and a case with k columns holds the port's product of the
first k columns against the first k columns of that: a column of Y depends
on its own column of X alone, in both packages. The CUDA kernel itself is
checked by tests/test_torch_kernels.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.spmv import attach_wjd as jax_attach_wjd
from rocalution_tpu_torch.formats.wjd import from_csr
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

RTOL = {np.float64: 1e-13, np.float32: 2e-5}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _rand_pair(n, m, density, dtype, seed=3):
    """The same random CSR triplet in both packages."""
    rng = np.random.default_rng(seed)
    S = sp.random(n, m, density=density, format="csr", random_state=rng)
    S.data = rng.standard_normal(S.nnz).astype(dtype)
    S.sort_indices()
    args = (S.data, S.indices.astype(np.int32), S.indptr.astype(np.int32),
            (n, m))
    return jrt.CSR.from_arrays(*args), rt.CSR.from_arrays(*args)


OPERATORS = {
    # name: (make pair, planner kwargs, expected kernel mode)
    "rand_600x500": (lambda dt: _rand_pair(600, 500, 0.01, dt), {}, "gather"),
    "rand_300x300": (lambda dt: _rand_pair(300, 300, 0.02, dt), {}, "gather"),
    "rand_300x300_spill": (lambda dt: _rand_pair(300, 300, 0.02, dt),
                           {"max_slots": 2}, "gather"),
    "lap2d_20_roll": (lambda dt: (jrt.laplacian_2d(20, dtype=dt),
                                  rt.laplacian_2d(20, dtype=dt)),
                      {"split_dia": False}, "roll"),
    # f32 under the reference's split rule (the JAX planner's default): all
    # five diagonals go to the DIA part and the slot plan is empty
    "lap2d_20_split": (lambda dt: (jrt.laplacian_2d(20, dtype=dt),
                                   rt.laplacian_2d(20, dtype=dt)),
                       {"split_dia": "auto"}, None),
}
# k = 20 crosses the port's chunk of 16 columns. f32 plans take the four
# widths on one gather and one roll operator only.
CASES = (
    [("rand_300x300", np.float32, k) for k in (1, 5, 16, 20)]
    + [("lap2d_20_roll", np.float32, k) for k in (1, 5, 16, 20)]
    + [("rand_300x300_spill", np.float32, 5),
       ("lap2d_20_split", np.float32, 5), ("lap2d_20_split", np.float32, 20)]
    + [(name, np.float64, k) for name in ("rand_600x500", "rand_300x300",
                                          "rand_300x300_spill",
                                          "lap2d_20_roll")
       for k in (1, 5, 16, 20)]
)


@pytest.fixture(autouse=True)
def jax_chunks_of_two(monkeypatch):
    """The JAX side computes its reference in chunks of 2 columns (as
    tests/test_wjd.py::test_wjd_spmm_chunking sets 3): the interpreted
    kernel is traced per chunk width, and a 16-column trace costs half a
    minute. Its result does not depend on the chunk; the port's chunk stays
    at 16."""
    from rocalution_tpu.ops.pallas import spmv_wjd as jax_mod

    monkeypatch.setattr(jax_mod, "_MRHS_MAX_COLS", 2)


@pytest.fixture(autouse=True)
def one_tile_steps(monkeypatch):
    """One tile per grid step in both planners. These operators have one
    tile of rows, which the planners pad to a group of 8, and the
    interpreted kernel unrolls group x K slot bodies: seven tiles of zeros
    cost most of its seconds. The product does not depend on the grouping
    (tests/test_torch_wjd_window.py sets it so too)."""
    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)


def _X(m, k, dtype, seed=11):
    """The first k of 20 columns made from the seed."""
    X = np.random.default_rng(seed).standard_normal((m, 20)).astype(dtype)
    return np.ascontiguousarray(X[:, :k])


_JAX_Y = {}


def _jax_spmm(name, dtype):
    """(kernel mode, Y) of the JAX package for operator `name` on the 20
    columns of `_X`, computed once."""
    key = (name, np.dtype(dtype).name)
    if key not in _JAX_Y:
        make, kw, _ = OPERATORS[name]
        Aj, _ = make(dtype)
        Wj = jax_from_csr(Aj, cache=False, **kw)
        X = _X(Aj.shape[1], 20, dtype)
        _JAX_Y[key] = (Wj.kernel_mode,
                       np.asarray(jrt.spmv(Wj, jnp.asarray(X))))
    return _JAX_Y[key]


def _close(got, want, dtype):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


@pytest.mark.parametrize("name,dtype,k", CASES)
def test_wjd_spmm_matches_jax(name, dtype, k):
    make, kw, mode = OPERATORS[name]
    _, At = make(dtype)
    Wt = from_csr(At, **kw)
    jax_mode, want = _jax_spmm(name, dtype)
    assert Wt.kernel_mode == jax_mode
    if mode is None:
        assert Wt.nnz == 0 and Wt.dia_data is not None
    else:
        assert Wt.kernel_mode == mode
    if "spill" in name:
        assert Wt.spill_row.numel() > 0
    X = _X(At.shape[1], k, dtype)
    got = rt.spmv(Wt, torch.from_numpy(X))
    assert got.shape == (At.shape[0], k) and got.is_contiguous()
    _close(got.numpy(), want[:, :k], dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csr_with_attached_plan_spmm_matches_jax(dtype):
    """A CSR with an attached plan sends a 2-D x to the blocked-RHS path
    (4 columns: the JAX side's chunks of two need no trace of their own)."""
    Aj, At = _rand_pair(300, 300, 0.02, dtype)
    X = _X(300, 4, dtype)
    plain = rt.spmv(At, torch.from_numpy(X)).numpy()       # plain CSR apply
    jax_attach_wjd(Aj)
    rt.attach_wjd(At)
    want = np.asarray(jrt.spmv(Aj, jnp.asarray(X)))
    got = rt.spmv(At, torch.from_numpy(X)).numpy()
    _close(got, want, dtype)
    _close(got, plain, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fmt", ["CSR", "DIA"])
def test_plain_apply_on_2d_x_matches_jax(fmt, dtype):
    Aj, At = jrt.laplacian_3d(8, dtype=dtype), rt.laplacian_3d(8, dtype=dtype)
    if fmt == "DIA":
        Aj, At = jrt.DIA.from_csr_host(Aj), rt.DIA.from_csr_host(At)
    X = _X(At.shape[1], 7, dtype)
    want = np.asarray(jrt.spmv(Aj, jnp.asarray(X)))
    _close(rt.spmv(At, torch.from_numpy(X)).numpy(), want, dtype)


def test_empty_plan_gives_zeros():
    At = rt.CSR.from_arrays(np.zeros(0, np.float32), np.zeros(0, np.int32),
                            np.zeros(11, np.int32), (10, 10))
    Y = rt.spmv(from_csr(At), torch.ones((10, 3), dtype=torch.float32))
    assert torch.equal(Y, torch.zeros((10, 3), dtype=torch.float32))


@pytest.mark.parametrize("mode", ["roll", "gather"])
def test_spmm_equals_single_applies_whatever_the_chunk(mode, monkeypatch):
    """Column j of Y is `wjd_spmv` of column j, bit for bit on the CPU, and
    does not depend on how the columns are chunked."""
    W = from_csr(rt.laplacian_3d(8), kernel_mode=mode)
    X = torch.from_numpy(_X(W.shape[1], 20, np.float64))
    Y = kernels.wjd_spmm(W, X)
    for j in range(20):
        assert torch.equal(Y[:, j], kernels.wjd_spmv(W, X[:, j].contiguous()))
    monkeypatch.setattr(kernels, "MRHS_MAX_COLS", 3)       # seven chunks
    assert torch.equal(kernels.wjd_spmm(W, X), Y)


@pytest.mark.parametrize("kc", [4, 8, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_roll_slot_product_per_chunk_width(dtype, kc):
    """What the roll SpMM kernel is held against on the card, at each width
    it is built for: `slots_plain_mrhs` on a padded row-major X of kc
    columns is `slots_plain` of each column, bit for bit (the kernel sums a
    column in the single-RHS kernel's order, whatever kc is)."""
    W = from_csr(rt.laplacian_3d(8, dtype=dtype), split_dia=False)
    assert W.kernel_mode == "roll"
    X = torch.from_numpy(_X(W.shape[1], kc, dtype))
    xp = kernels.pad_x(W, X, kc)
    assert xp.shape == (W.xp_len, kc) and xp.is_contiguous()
    Y = kernels.slots_plain_mrhs(W, xp)
    assert Y.shape == (W.brow.shape[0] * 1024, kc)
    for j in range(kc):
        assert torch.equal(
            Y[:, j], kernels.slots_plain(W, xp[:, j].contiguous()).reshape(-1))


def test_wjd_spmm_rejects_mismatched_x():
    W = from_csr(rt.laplacian_2d(10))
    with pytest.raises(ValueError):
        kernels.wjd_spmm(W, torch.ones((99, 2), dtype=torch.float64))
    with pytest.raises(TypeError):
        kernels.wjd_spmm(W, torch.ones((100, 2), dtype=torch.float32))
    with pytest.raises(ValueError):
        kernels.wjd_spmv(W, torch.ones((100, 2), dtype=torch.float64))
