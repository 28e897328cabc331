"""The port's CUDA kernels on the card: each WJD entry point (direct,
windowed, blocked right-hand sides) against its plain PyTorch version, the
compact gather kernels against the padded slot product as well, and the CG
slice going through them.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor rocalution_tpu, so on a machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as wjd_mod
from rocalution_tpu_torch.formats.wjd import from_csr, windowed
from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels

pytestmark = pytest.mark.cuda

# tolerance on max|y_kernel - y_plain| / max|y_plain|: the kernel sums
# over slots in order with FMA, the plain version by torch.sum
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = {
    "roll_f64": (lambda: rt.laplacian_3d(12), {}),
    "gather_f64": (lambda: rt.random_banded_spd(3000, bandwidth=512), {}),
    "roll_f32": (lambda: rt.laplacian_3d(12, dtype=np.float32),
                 {"split_dia": False}),
    "gather_f32": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32), {}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels need an NVIDIA GPU (no CPU mode)")
    return torch.device("cuda")


def _x(n, dtype, device, seed=7):
    x = np.random.default_rng(seed).standard_normal(n)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("key", sorted(CASES))
def test_kernel_matches_plain_version(cuda_device, key):
    make, kw = CASES[key]
    W = from_csr(make(), device=cuda_device, **kw)
    assert key.startswith(W.kernel_mode)
    x = _x(W.shape[1], W.dtype, cuda_device)
    before = kernels.launches[key]
    got = kernels.wjd_spmv(W, x)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    want = kernels.wjd_reference(W, x)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL[W.dtype], (key, err)


@pytest.mark.parametrize("key", ["gather_f64", "gather_f32"])
def test_kernel_with_heavy_spill(cuda_device, key):
    make, _ = CASES[key]
    W = from_csr(make(), device=cuda_device, max_slots=4)
    assert W.spill_row.numel() > 0
    x = _x(W.shape[1], W.dtype, cuda_device)
    got, want = kernels.wjd_spmv(W, x), kernels.wjd_reference(W, x)
    assert float((got - want).abs().max() / want.abs().max()) \
        <= TOL[W.dtype]


def test_kernel_raises_on_mismatched_dtype(cuda_device):
    W = from_csr(rt.laplacian_3d(8), device=cuda_device)
    with pytest.raises(TypeError):
        kernels.wjd_spmv(W, torch.ones(512, dtype=torch.float32,
                                       device=cuda_device))


def test_cg_on_cuda_goes_through_the_kernel(cuda_device):
    A = rt.laplacian_2d(30, device=cuda_device)
    d, _, p = A.numpy_triplet()
    b = torch.from_numpy(np.add.reduceat(d, p[:-1])).to(cuda_device)
    before = kernels.launches["roll_f64"]
    x, info = rt.cg(A, b, M=rt.jacobi(A), rel_tol=1e-8, max_iter=200)
    assert A._wjd_cache is not None
    assert int(info.status) == 2
    assert kernels.launches["roll_f64"] - before >= int(info.iterations) + 1
    # the same solve on the CPU (plain versions throughout)
    Ac = rt.laplacian_2d(30, device="cpu")
    xc, infoc = rt.cg(Ac, b.cpu(), M=rt.jacobi(Ac), rel_tol=1e-8,
                      max_iter=200)
    assert int(info.iterations) == int(infoc.iterations)
    torch.testing.assert_close(x.cpu(), xc, rtol=1e-9, atol=1e-10)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("kc", [4, 8, 16])
@pytest.mark.parametrize("key", sorted(CASES))
def test_spmm_kernel_matches_plain_version(cuda_device, key, kc):
    make, kw = CASES[key]
    W = from_csr(make(), device=cuda_device, **kw)
    plain = (kernels.slots_plain_compact_mrhs if W.kernel_mode == "gather"
             else kernels.slots_plain_mrhs)
    X = _x(W.shape[1] * kc, W.dtype, cuda_device).view(-1, kc)
    xp = kernels.pad_x(W, X, kc)
    before = kernels.launches[f"spmm_{key}"]
    got = kernels.slots_kernel_mrhs(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches[f"spmm_{key}"] == before + 1
    assert _rel(got, plain(W, xp)) <= TOL[W.dtype], (key, kc)
    # a column is summed in the single-RHS kernel's order, whatever kc is
    for j in range(kc):
        y_j = kernels.slots_kernel(W, xp[:, j].contiguous()).reshape(-1)
        assert torch.equal(got[:, j], y_j), (key, kc, j)
    with pytest.raises(ValueError):             # X in planes: (kc, xp_len)
        kernels.slots_kernel_mrhs(W, xp.t().contiguous())


def _wide_rows(dtype):
    """2,500 rows (a ragged third tile) whose columns scatter over 150,000:
    every slice spans more than 65,535 elements of x."""
    rng = np.random.default_rng(5)
    S = sp.random(2500, 150_000, density=8 / 150_000, format="csr",
                  random_state=rng)
    S.data = rng.standard_normal(S.nnz).astype(dtype)
    S.sort_indices()
    return rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape,
                              device="cpu")


COMPACT = {
    # name: (make on the CPU, planner kwargs, offset dtype)
    "band_u16": (lambda dt: rt.random_banded_spd(
        3000, bandwidth=512, dtype=dt, device="cpu"), {}, torch.uint16),
    "band_spill_u16": (lambda dt: rt.random_banded_spd(
        3000, bandwidth=512, dtype=dt, device="cpu"), {"max_slots": 4},
        torch.uint16),
    "wide_i32": (_wide_rows, {"split_dia": False}, torch.int32),
}


def _on_card(W):
    """A CPU WJD moved to the card whole: slot planes and compact form."""
    return dataclasses.replace(W, **{
        f.name: getattr(W, f.name).cuda() for f in dataclasses.fields(W)
        if isinstance(getattr(W, f.name), torch.Tensor)})


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(COMPACT))
def test_compact_kernels_match_compact_and_padded_plain(cuda_device, name,
                                                        dtype):
    """The compact gather kernels, single and blocked right-hand sides,
    against the plain version over the compact form and against the padded
    slot product, for 2-byte and 4-byte offsets and a ragged last tile."""
    make, kw, off_dtype = COMPACT[name]
    A = make(dtype)
    assert A.shape[0] % 1024
    W = _on_card(from_csr(A, kernel_mode="gather", **kw))
    assert W.coff.dtype == off_dtype and W.data is not None
    tag = "f64" if dtype == np.float64 else "f32"
    tol = TOL[W.dtype]
    x = _x(W.shape[1], W.dtype, cuda_device)
    xp = kernels.pad_x(W, x)
    before = kernels.launches[f"gather_{tag}"]
    got = kernels.slots_kernel(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches[f"gather_{tag}"] == before + 1
    assert _rel(got, kernels.slots_plain_compact(W, xp)) <= tol
    assert _rel(got, kernels.slots_plain(W, xp)) <= tol
    for kc in (4, 8, 16):
        X = _x(W.shape[1] * kc, W.dtype, cuda_device).view(-1, kc)
        xq = kernels.pad_x(W, X, kc)
        before = kernels.launches[f"spmm_gather_{tag}"]
        Y = kernels.slots_kernel_mrhs(W, xq)
        torch.cuda.synchronize()
        assert kernels.launches[f"spmm_gather_{tag}"] == before + 1
        assert _rel(Y, kernels.slots_plain_compact_mrhs(W, xq)) <= tol
        assert _rel(Y, kernels.slots_plain_mrhs(W, xq)) <= tol
        # a column does not depend on the chunk it rode in
        y0 = kernels.slots_kernel(W, xq[:, 0].contiguous()).reshape(-1)
        assert torch.equal(Y[:, 0], y0), kc


@pytest.mark.parametrize("regime", ["resident", "windowed"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gather_plan_on_the_card_carries_no_slot_planes(cuda_device, dtype,
                                                        regime, monkeypatch):
    """In every regime a gather-mode plan on the card is served from its
    compact form alone, window-relative where the windowed kernel serves
    it (f32 in the windowed regime); the reference and `to_csr` follow."""
    if regime == "windowed":
        _windowed_regime(monkeypatch)
    A = rt.random_banded_spd(3000, bandwidth=512, dtype=dtype)
    W = from_csr(A, device=cuda_device, split_dia=False)
    relative = regime == "windowed" and dtype == np.float32
    assert W.data is None and W.uloc is None and W.cval.is_cuda
    assert W.dtype == rt.config.torch_dtype(dtype)
    assert W.device.type == "cuda"
    assert W.window_relative is relative is windowed(W, W.dtype)
    B = rt.convert(W, "CSR")
    for a, b in zip(A.numpy_triplet(), B.numpy_triplet()):
        np.testing.assert_array_equal(a, b)
    x = _x(3000, W.dtype, cuda_device)
    assert _rel(kernels.wjd_reference(W, x), rt.spmv(B, x)) <= TOL[W.dtype]
    assert _rel(kernels.wjd_spmv(W, x), rt.spmv(B, x)) <= TOL[W.dtype]
    if not relative:     # the windowed kernel takes no per-slice form
        with pytest.raises((ValueError, TypeError)):
            kernels.slots_kernel_windowed(W, kernels.pad_x(W, x))


@pytest.mark.parametrize("k", [1, 5, 16, 20])
@pytest.mark.parametrize("key", sorted(CASES))
def test_spmv_of_2d_x_goes_through_the_spmm_kernel(cuda_device, key, k):
    make, kw = CASES[key]
    A = make()
    rt.attach_wjd(A, **kw)
    assert A.data.is_cuda                      # the default device is the card
    W = A._wjd_cache
    X = _x(W.shape[1] * k, W.dtype, cuda_device).view(-1, k)
    before = kernels.launches[f"spmm_{key}"]
    Y = rt.spmv(A, X)
    torch.cuda.synchronize()
    assert kernels.launches[f"spmm_{key}"] == before + -(-k // 16)
    assert Y.shape == (A.shape[0], k)
    assert _rel(Y, kernels.wjd_reference(W, X)) <= TOL[W.dtype]
    singles = torch.stack([kernels.wjd_spmv(W, X[:, j].contiguous())
                           for j in range(k)], dim=1)
    assert _rel(Y, singles) <= TOL[W.dtype]


def _windowed_regime(monkeypatch, group=1):
    """A small budget puts small operators in the windowed regime; `group`
    tiles per step give them several windows."""
    monkeypatch.setattr(wjd_mod, "X_VMEM_BUDGET", 1024)
    monkeypatch.setattr(wjd_mod, "_auto_group", lambda K: group)
    monkeypatch.setattr(wjd_mod, "_auto_group_windowed", lambda K: group)


@pytest.mark.parametrize("key", ["roll_f64", "roll_f32", "gather_f32"])
def test_windowed_kernel_matches_plain_version(cuda_device, key, monkeypatch):
    _windowed_regime(monkeypatch)
    make, kw = CASES[key]
    W = from_csr(make(), device=cuda_device, **kw)
    assert windowed(W, W.dtype) and len(W.win_base) > 1
    plain = (kernels.slots_plain_compact_windowed
             if W.kernel_mode == "gather" else kernels.slots_plain_windowed)
    x = _x(W.shape[1], W.dtype, cuda_device)
    xp = kernels.pad_x(W, x)
    before = kernels.launches[f"win_{key}"]
    got = kernels.slots_kernel_windowed(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches[f"win_{key}"] == before + 1
    assert _rel(got, plain(W, xp)) <= TOL[W.dtype]
    # the entry point takes the windowed kernel by itself
    y = kernels.wjd_spmv(W, x)
    assert kernels.launches[f"win_{key}"] == before + 2
    assert _rel(y, kernels.wjd_reference(W, x)) <= TOL[W.dtype]


def _banded_with_an_empty_tile(dtype):
    """3,000 rows of a banded operator whose rows 1024 .. 2047 are empty:
    with one tile a step, a step all of whose slices are empty."""
    A = rt.random_banded_spd(3000, bandwidth=512, dtype=dtype, device="cpu")
    S = sp.csr_matrix(A.numpy_triplet(), shape=A.shape).tolil()
    S[1024:2048] = 0
    S = S.tocsr()
    S.sort_indices()
    return rt.CSR.from_arrays(S.data.astype(dtype),
                              S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape,
                              device="cpu")


WINDOWED_GATHER = {
    # name: (make on the CPU, planner kwargs, tiles a step, offset dtype)
    "band_group1": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"), {}, 1,
        torch.uint16),
    "band_group2_spill": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"),
        {"max_slots": 4}, 2, torch.uint16),
    "empty_step": (lambda: _banded_with_an_empty_tile(np.float32), {}, 1,
                   torch.uint16),
    "wide_i32": (lambda: _wide_rows(np.float32), {"split_dia": False}, 1,
                 torch.int32),
}


@pytest.mark.parametrize("name", sorted(WINDOWED_GATHER))
def test_windowed_gather_kernel(cuda_device, name, monkeypatch):
    """The windowed gather kernel against the plain version over the
    window-relative compact form and against the padded slot product; bit
    for bit the direct compact kernel's sums."""
    make, kw, group, off_dtype = WINDOWED_GATHER[name]
    _windowed_regime(monkeypatch, group)
    W = _on_card(from_csr(make(), kernel_mode="gather", **kw))
    assert W.window_relative and windowed(W, W.dtype)
    assert W.group == group and W.coff.dtype == off_dtype
    if name == "empty_step":
        per_step = 32 * group
        assert (W.slice_ptr[per_step:2 * per_step + 1].diff() == 0).all()
    tol = TOL[W.dtype]
    x = _x(W.shape[1], W.dtype, cuda_device)
    xp = kernels.pad_x(W, x)
    want = kernels.slots_plain_compact_windowed(W, xp)
    direct = kernels.slots_kernel(W, xp)
    before = kernels.launches["win_gather_f32"]
    got = kernels.slots_kernel_windowed(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches["win_gather_f32"] == before + 1
    assert _rel(got, want) <= tol
    assert _rel(got, kernels.slots_plain(W, xp)) <= tol
    assert torch.equal(got, direct)
    # the entry point takes the windowed kernel by itself
    y = kernels.wjd_spmv(W, x)
    assert _rel(y, kernels.wjd_reference(W, x)) <= tol


def test_refused_launches_raise(cuda_device, monkeypatch):
    W = from_csr(rt.random_banded_spd(3000, bandwidth=512),
                 device=cuda_device)
    x = _x(W.shape[1], W.dtype, cuda_device)
    with pytest.raises(TypeError):              # no windowed gather in f64
        kernels.slots_kernel_windowed(_on_card(from_csr(
            rt.random_banded_spd(3000, bandwidth=512, device="cpu"))),
            kernels.pad_x(W, x))
    with pytest.raises(ValueError):             # 5 columns: not a built width
        kernels.slots_kernel_mrhs(W, kernels.pad_x(W, x[:, None], 5))
    with pytest.raises(ValueError):             # CPU x against CUDA operands
        kernels.slots_kernel(W, kernels.pad_x(W, x).cpu())
    with pytest.raises(TypeError):
        kernels.wjd_spmm(W, torch.ones((3000, 2), dtype=torch.float32,
                                       device=cuda_device))


@pytest.mark.parametrize("fmt", ["ELL", "HYB", "BCSR"])
def test_routed_formats_go_through_the_kernel(cuda_device, fmt):
    from rocalution_tpu_torch.ops.spmv import as_operator

    A = rt.random_banded_spd(3000, bandwidth=512)
    B = rt.convert(A, fmt)
    assert B.device.type == "cuda"
    x = _x(3000, torch.float64, cuda_device)
    want = rt.spmv(A, x)                        # plain CSR apply: no plan yet
    assert getattr(A, "_wjd_cache", None) is None
    op = as_operator(B)                         # a CUDA operand auto-attaches
    before = kernels.launches["gather_f64"]
    y = op(x)
    assert kernels.launches["gather_f64"] == before + 1
    assert _rel(y, want) <= TOL[torch.float64]
