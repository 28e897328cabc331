"""Port parity: SpMV for CSR, DIA and WJD.

On the CPU the port's WJD wrapper takes its plain version; it is held
against the JAX package: f32 against the Pallas kernels run in interpret
mode (as tests/test_wjd.py runs them), rtol 2e-5 (f32 sums in another
order); f64 against the JAX `wjd_reference`, rtol 1e-13 (f64 sums in
another order). The CUDA kernels themselves are checked by
tests/test_torch_kernels.py, which needs a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.formats.wjd import from_csr as jax_from_csr
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_reference as jax_reference
from rocalution_tpu.ops.pallas.spmv_wjd import wjd_spmv as jax_wjd_spmv
from rocalution_tpu_torch.formats.wjd import from_csr
from rocalution_tpu_torch.interop import csr_from_numpy, wjd_from_numpy
from rocalution_tpu_torch.ops.cuda import _build
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)



@pytest.fixture(autouse=True)
def one_tile_steps(monkeypatch):
    """One tile per grid step in both planners. The planners pad the one to
    three tiles of these operators to groups of up to 8, and the
    interpreted Pallas kernels unroll group x K slot bodies: the tiles of
    zeros cost most of their seconds. The product does not depend on the
    grouping (tests/test_torch_wjd_window.py sets it so too)."""
    import rocalution_tpu.formats.wjd as jax_wjd
    import rocalution_tpu_torch.formats.wjd as torch_wjd

    for mod in (jax_wjd, torch_wjd):
        monkeypatch.setattr(mod, "_auto_group", lambda K: 1)


GENERATORS = {
    "lap2d_30": lambda m, dt: m.laplacian_2d(30, dtype=dt),
    "lap3d_12": lambda m, dt: m.laplacian_3d(12, dtype=dt),
    "randband_3000": lambda m, dt: m.random_banded_spd(
        3000, bandwidth=512, dtype=dt),
}
RTOL = {np.float64: 1e-13, np.float32: 2e-5}


def _x(n, dtype, seed=7):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _jax_spmv(W, x):
    if W.data_lo is not None:
        return np.asarray(jax_reference(W, jnp.asarray(x)))
    return np.asarray(jax_wjd_spmv(W, jnp.asarray(x), interpret=True))


def _close(got, want, dtype):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_csr_spmv_matches_jax(name, dtype):
    Aj, At = GENERATORS[name](jrt, dtype), GENERATORS[name](rt, dtype)
    x = _x(At.shape[1], dtype)
    want = np.asarray(jrt.spmv(Aj, jnp.asarray(x)))
    _close(rt.spmv(At, torch.from_numpy(x)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_spmv_matches_jax(dtype):
    Aj, At = jrt.laplacian_3d(12, dtype=dtype), rt.laplacian_3d(12, dtype=dtype)
    Dj = jrt.DIA.from_csr_host(Aj)
    Dt = rt.DIA.from_csr_host(At)
    assert Dj.offsets == Dt.offsets
    x = _x(At.shape[1], dtype)
    want = np.asarray(jrt.spmv(Dj, jnp.asarray(x)))
    _close(rt.spmv(Dt, torch.from_numpy(x)).numpy(), want, dtype)


# f64 plans are never split, so split_dia=False changes only f32 plans;
# interpreted Pallas costs seconds per plan, so f32 takes one
# split_dia=False case per kernel mode
WJD_CASES = (
    [(n, np.float64, "auto") for n in sorted(GENERATORS)]
    + [(n, np.float32, "auto") for n in sorted(GENERATORS)]
    + [("lap2d_30", np.float32, False)]           # roll mode, kernel 2
)


@pytest.mark.parametrize("name,dtype,split_dia", WJD_CASES)
def test_wjd_spmv_matches_jax(name, dtype, split_dia):
    Aj, At = GENERATORS[name](jrt, dtype), GENERATORS[name](rt, dtype)
    Wj = jax_from_csr(Aj, cache=False, split_dia=split_dia)
    Wt = from_csr(At, split_dia=split_dia)
    assert Wt.kernel_mode == Wj.kernel_mode
    x = _x(At.shape[1], dtype)
    got = kernels.wjd_spmv(Wt, torch.from_numpy(x)).numpy()
    _close(got, _jax_spmv(Wj, x), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wjd_from_jax_plan_via_interop(dtype):
    Aj = jrt.random_banded_spd(3000, bandwidth=512, dtype=dtype)
    Wj = jax_from_csr(Aj, cache=False, max_slots=8)   # spill-heavy
    fields = {f.name: getattr(Wj, f.name) for f in dataclasses.fields(Wj)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    Wt = wjd_from_numpy(fields, device="cpu")
    assert Wt.data.dtype == rt.config.torch_dtype(dtype)
    assert Wt.kernel_mode == Wj.kernel_mode and Wt.xp_len == Wj.xp_len
    assert Wt.spill_row.numel() > 0
    x = _x(Aj.shape[1], dtype)
    got = kernels.wjd_spmv(Wt, torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jax_reference(Wj, jnp.asarray(x))), dtype)


def test_csr_from_numpy_round_trip():
    Aj = jrt.laplacian_2d(12)
    At = csr_from_numpy(*Aj.numpy_triplet(), Aj.shape, device="cpu")
    for a, b in zip(Aj.numpy_triplet(), At.numpy_triplet()):
        np.testing.assert_array_equal(a, b)


def test_attached_csr_routes_by_dtype():
    """An f64 plan serves f64 x and only f64 x (the JAX dtype rules)."""
    from rocalution_tpu_torch.ops.spmv import _use_kernel

    A = rt.laplacian_2d(20)
    rt.attach_wjd(A)
    x64 = torch.from_numpy(_x(A.shape[1], np.float64))
    want = rt.spmv(rt.laplacian_2d(20), x64)
    torch.testing.assert_close(rt.spmv(A, x64), want, rtol=1e-13, atol=1e-13)
    W32 = from_csr(rt.laplacian_2d(20, dtype=np.float32))
    assert _use_kernel(A._wjd_cache, torch.float64)
    assert not _use_kernel(A._wjd_cache, torch.float32)
    assert _use_kernel(W32, torch.float32)
    assert not _use_kernel(W32, torch.float64)
    assert not _use_kernel(W32, torch.float16)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never builds or launches a kernel."""
    before = dict(kernels.launches)
    for dtype in (np.float64, np.float32):
        W = from_csr(rt.random_banded_spd(3000, bandwidth=512, dtype=dtype))
        x = torch.from_numpy(_x(3000, dtype))
        torch.testing.assert_close(kernels.wjd_spmv(W, x),
                                   kernels.wjd_reference(W, x))
    assert kernels.launches == before
    assert "spmv_wjd" not in _build._loaded


def test_wjd_spmv_rejects_mismatched_x():
    W = from_csr(rt.laplacian_2d(10))
    with pytest.raises(TypeError):
        kernels.wjd_spmv(W, torch.ones(100, dtype=torch.float32))
    with pytest.raises(ValueError):
        kernels.wjd_spmv(W, torch.ones(99, dtype=torch.float64))


def test_auto_attach_follows_the_operand_device():
    """auto_wjd=None attaches only for CUDA operands; True forces it."""
    from rocalution_tpu_torch.ops.spmv import maybe_attach_wjd

    A = rt.laplacian_2d(10)
    maybe_attach_wjd(A)
    assert getattr(A, "_wjd_cache", None) is None
    rt.set_auto_wjd(True)
    try:
        maybe_attach_wjd(A)
    finally:
        rt.set_auto_wjd(None)
    assert A._wjd_cache.kernel_mode == "roll"


def test_auto_wjd_reads_no_environment(monkeypatch):
    """set_auto_wjd is the only switch: the JAX package's environment
    variable does not reach the port's config."""
    from rocalution_tpu_torch.config import Config

    monkeypatch.setenv("ROCALUTION_TPU_AUTO_WJD", "0")
    assert Config().auto_wjd is None


BLAS1 = {
    "dot": lambda m, x, y: m.dot(x, y),
    "dot_nonconj": lambda m, x, y: m.dot_nonconj(x, y),
    "norm": lambda m, x, y: m.norm(x),
    "asum": lambda m, x, y: m.asum(x),
    "reduce_sum": lambda m, x, y: m.reduce_sum(x),
    "add_scale": lambda m, x, y: m.add_scale(x, y, 0.75),
}


@pytest.mark.parametrize("name", sorted(BLAS1))
def test_blas1_matches_jax(name):
    from rocalution_tpu.ops import blas1 as jax_blas1
    from rocalution_tpu_torch.ops import blas1

    x, y = _x(1000, np.float64, seed=1), _x(1000, np.float64, seed=2)
    want = np.asarray(BLAS1[name](jax_blas1, jnp.asarray(x), jnp.asarray(y)))
    got = BLAS1[name](blas1, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


def test_safe_div_matches_jax():
    from rocalution_tpu.solvers.krylov._common import safe_div as jax_div
    from rocalution_tpu_torch.solvers.krylov._common import safe_div

    num = np.array([1.0, 0.0, 3.0, -2.0])
    den = np.array([2.0, 0.0, 0.0, 4.0])
    want = np.asarray(jax_div(jnp.asarray(num), jnp.asarray(den)))
    got = safe_div(torch.from_numpy(num), torch.from_numpy(den)).numpy()
    np.testing.assert_array_equal(got, want)
