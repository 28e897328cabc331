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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


@pytest.fixture(autouse=True)
def plan_cache_off(monkeypatch):
    """Every plan here is made in this process; nothing is written to the
    on-disk plan cache."""
    monkeypatch.setenv("ROCALUTION_TPU_TORCH_PLAN_CACHE", "0")


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


def _transfers(dtype):
    """P (tall) and R (wide) of the first SA level of laplacian_3d(12),
    host-resident."""
    from rocalution_tpu_torch.solvers.multigrid.aggregation import sa_level

    P, R, _ = sa_level(rt.laplacian_3d(12, device="cpu"))
    out = {}
    for name, M in (("P", P), ("R", R)):
        d, i, p = M.numpy_triplet()
        out[name] = rt.CSR.from_arrays(d.astype(dtype), i, p, M.shape,
                                       device="cpu")
    return out


@pytest.mark.parametrize("regime", ["direct", "windowed"])
@pytest.mark.parametrize("mode", ["gather", "roll"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["P", "R"])
def test_rectangular_operands_through_each_kernel(cuda_device, which, dtype,
                                                  mode, regime, monkeypatch):
    """AMG transfers are tall (P) and wide (R). Each single-RHS entry point
    serves them, in the windowed regime too (a small x budget), and agrees
    with the plain CSR apply on the card and with the plain version of the
    same plan. Gather mode has no windowed f64 kernel: it stays direct."""
    if regime == "windowed":
        _windowed_regime(monkeypatch)
    M = _transfers(dtype)[which]
    n, m = M.shape
    W = from_csr(M, device=cuda_device, kernel_mode=mode)
    tag = "f64" if dtype == np.float64 else "f32"
    win = regime == "windowed" and (mode == "roll" or tag == "f32")
    key = f"{'win_' if win else ''}{mode}_{tag}"
    assert windowed(W, W.dtype) == win
    x = _x(m, W.dtype, cuda_device)
    before = kernels.launches[key]
    y = kernels.wjd_spmv(W, x)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    assert y.shape == (n,)
    assert _rel(y, kernels.wjd_reference(W, x)) <= TOL[W.dtype]
    plain = rt.spmv(rt.CSR.from_arrays(*M.numpy_triplet(), M.shape,
                                       device=cuda_device), x)
    assert _rel(y, plain) <= TOL[W.dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_saamg_on_cuda_goes_through_the_kernels(cuda_device, dtype):
    """CG + SA-AMG on the card: the cycle closure places every level,
    transfer and smoother vector on the card, each CSR gets a WJD plan, the
    solve launches the kernels, and it takes the iterations of the same
    solve on the CPU (within 1)."""
    from rocalution_tpu_torch.solvers.multigrid import (amg_hierarchy,
                                                        convert_hierarchy,
                                                        cycle_closure)

    def solve(device):
        A = rt.laplacian_3d(16, device=device)
        h = amg_hierarchy(A, "sa", coarse_size=100)
        if dtype == np.float32:
            h = convert_hierarchy(h, dtype=dtype)
        M = cycle_closure(h)
        A0 = h.levels[0].A
        d, _, p = A.numpy_triplet()
        b = torch.from_numpy(np.add.reduceat(d, p[:-1]).astype(dtype))
        for key in kernels.launches:
            kernels.launches[key] = 0
        x, info = rt.cg(A0, b.to(device), M=M, rel_tol=1e-8 if
                        dtype == np.float64 else 1e-6, max_iter=100,
                        check_every=4)
        torch.cuda.synchronize()
        return M.hierarchy, x, info, dict(kernels.launches)

    h, x, info, got = solve(cuda_device)
    assert h.num_levels >= 3
    for lv in h.levels:
        for M in (lv.A, lv.P, lv.R):
            if M is None:
                continue
            assert M.device.type == "cuda"
            if isinstance(M, rt.CSR):
                assert M._wjd_cache is not None
        if lv.smooth is not None:
            assert lv.smooth.inv_d.device.type == "cuda"
    assert int(info.status) == 2
    assert float((x.double() - 1).abs().max()) < (
        1e-6 if dtype == np.float64 else 1e-3)
    tag = "f64" if dtype == np.float64 else "f32"
    assert got[f"gather_{tag}"] >= int(info.iterations)
    _, _, info_cpu, _ = solve("cpu")
    assert abs(int(info.iterations) - int(info_cpu.iterations)) <= 1


def test_rebuilt_hierarchy_goes_through_the_kernels(cuda_device):
    """A hierarchy rebuilt for new values on frozen Galerkin plans computes
    its coarse levels on the card, with no host arrays. A cycle closure
    over it still plans every level and transfer, so each SpMV of one
    V-cycle is a kernel launch, and the cycle agrees with the same cycle
    on the CPU."""
    from rocalution_tpu_torch.solvers.multigrid import (
        amg_hierarchy, cycle_closure, make_galerkin_plans,
        rebuild_hierarchy_numeric)

    def closure(device):
        A = rt.laplacian_3d(16, device=device)
        h = amg_hierarchy(A, "sa", coarse_size=100)
        return h, cycle_closure(rebuild_hierarchy_numeric(
            h, A, plans=make_galerkin_plans(h)))

    h, M = closure(cuda_device)
    assert h.num_levels >= 3
    for lv in M.hierarchy.levels:
        for op in (lv.A, lv.P, lv.R):
            if op is not None:
                assert op.device.type == "cuda"
                assert op._wjd_cache is not None
    b = _x(h.levels[0].A.shape[0], torch.float64, cuda_device)
    for key in kernels.launches:
        kernels.launches[key] = 0
    e = M(b)
    torch.cuda.synchronize()
    per_level = h.pre_sweeps + h.post_sweeps + 3   # smooth, res, R, P
    assert sum(kernels.launches.values()) == \
        (M.hierarchy.num_levels - 1) * per_level
    _, M_cpu = closure("cpu")
    want = M_cpu(b.cpu())
    assert _rel(e.cpu(), want) <= 1e-10


@pytest.mark.parametrize("fmt", ["ELL", "HYB", "BCSR"])
def test_cast_routed_format_goes_through_the_kernel(cuda_device, fmt):
    """A `cast_values` copy of an ELL, HYB or BCSR operand has no host
    arrays; on the card a solver's `as_operator` reads it back once and
    plans it, and its apply is a kernel launch equal to the plain CSR
    apply."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    A = rt.laplacian_2d(40, dtype=np.float32)
    B = rt.cast_values(rt.convert(rt.laplacian_2d(40), fmt), torch.float32)
    assert not getattr(B.ell if fmt == "HYB" else B, "_host_cache", None)
    x = _x(1600, torch.float32, cuda_device)
    op = as_operator(B)
    W = B._wjd_cache
    assert W.dtype == torch.float32 and not W.dia_offsets
    key = f"{W.kernel_mode}_f32"
    before = kernels.launches[key]
    y = op(x)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape,
                               device=cuda_device)
    assert _rel(y, rt.spmv(plain, x)) <= TOL[torch.float32]


def test_f32_plan_on_the_card_keeps_its_diagonals(cuda_device):
    """An f32 plan is unsplit unless split_dia says otherwise, so a banded
    f32 operator on the card is served by the roll kernel, and its plan is
    the one the CPU makes."""
    A = rt.laplacian_3d(12, dtype=np.float32)
    W = from_csr(A)
    assert W.kernel_mode == "roll" and not W.dia_offsets
    assert from_csr(A, split_dia="auto").dia_offsets   # the reference's rule
    Wc = from_csr(rt.laplacian_3d(12, dtype=np.float32, device="cpu"))
    assert not Wc.dia_offsets
    assert torch.equal(Wc.brow, W.brow.cpu())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_factor_sweeps_go_through_the_kernel(cuda_device, dtype):
    """IC(0) with Jacobi sweeps on the card: the off-diagonal part of each
    factor carries a plan, each sweep is a kernel launch, and the sweep
    equals its plain version (the part's plain CSR apply) and the same
    tri-solve on the CPU."""
    from rocalution_tpu_torch.ops import factorize, trisolve

    L = factorize.ic0(rt.laplacian_3d(12, dtype=dtype, device="cpu"))
    N = trisolve.prepare_offd(L, cuda_device)
    W = N._wjd_cache
    key = f"{W.kernel_mode}_{'f64' if dtype == np.float64 else 'f32'}"
    x = _x(L.shape[0], W.dtype, cuda_device)
    before = kernels.launches[key]
    y = rt.spmv(N, x)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    plain = rt.CSR.from_arrays(*N.numpy_triplet(), N.shape,
                               device=cuda_device)
    assert _rel(y, rt.spmv(plain, x)) <= TOL[W.dtype]
    before = kernels.launches[key]
    z = trisolve.trisolve_jacobi(L, x, sweeps=5)
    assert kernels.launches[key] == before + 5
    want = trisolve.trisolve_jacobi(L, x.cpu(), sweeps=5)
    assert _rel(z.cpu(), want) <= 10 * TOL[W.dtype]


def test_padded_x_buffer_is_reused_safely(cuda_device):
    """The wrappers copy x into a padded buffer kept on the plan: applies
    of different vectors, queued back to back, each give their own
    product, and a narrower chunk of columns after a wider one (the same
    buffer) gives its own columns' product."""
    W = from_csr(rt.random_banded_spd(3000, bandwidth=512))
    xs = [_x(3000, torch.float64, cuda_device, seed=s) for s in range(4)]
    ys = [kernels.wjd_spmv(W, x) for x in xs]
    for x, y in zip(xs, ys):
        assert _rel(y, kernels.wjd_reference(W, x)) <= TOL[torch.float64]
    X = _x(3000 * 4, torch.float64, cuda_device).view(3000, 4)
    Y4 = rt.spmv(W, X)
    Y3 = rt.spmv(W, X[:, :3].contiguous())
    assert _rel(Y4, kernels.wjd_reference(W, X)) <= TOL[torch.float64]
    assert Y3.shape == (3000, 3)
    assert _rel(Y3, kernels.wjd_reference(W, X[:, :3])) <= TOL[torch.float64]


def test_gmres_ilu_on_cuda_goes_through_the_kernels(cuda_device):
    """GMRES(30) + ILU(0) with Jacobi sweeps on the card: the operator and
    both factors' off-diagonal parts are planned, the solve launches the
    kernels (one apply and 16 sweeps a step at least), and it takes the
    iterations of the CPU solve (within 2)."""

    def solve(device):
        A = rt.convection_diffusion_2d(40, device=device)
        b = torch.from_numpy(np.random.default_rng(4).standard_normal(
            A.shape[0])).to(device)
        M = rt.ilu(A, 0, method="jacobi", sweeps=8)
        before = sum(kernels.launches.values())
        x, info = rt.gmres(A, b, M=M, rel_tol=1e-8, max_iter=300)
        torch.cuda.synchronize()
        return A, M, info, sum(kernels.launches.values()) - before

    A, M, info, got = solve(cuda_device)
    assert A._wjd_cache is not None
    assert all(T._offd_cache._wjd_cache is not None for T in M.factors)
    assert int(info.status) == 2
    assert got >= 17 * int(info.iterations)
    _, _, info_cpu, _ = solve("cpu")
    assert abs(int(info.iterations) - int(info_cpu.iterations)) <= 2


def test_mpdc_on_cuda_goes_through_both_kernels(cuda_device):
    """MixedPrecisionDC on the card: the outer residual through the f64
    operator's plan, the inner CG through the f32 copy's; the outer
    iterations of the CPU solve."""
    kw = dict(rel_tol=1e-10, max_iter=20,
              inner_kwargs={"rel_tol": 1e-4, "max_iter": 2000})

    def solve(device):
        A = rt.laplacian_2d(64, device=device)
        b = torch.from_numpy(np.random.default_rng(5).standard_normal(
            A.shape[0])).to(device)
        before = dict(kernels.launches)
        _, info = rt.mixed_precision_dc(A, b, **kw)
        torch.cuda.synchronize()
        return A, info, {k: kernels.launches[k] - before[k] for k in before}

    A, info, got = solve(cuda_device)
    assert int(info.status) == 2
    outer = f"{A._wjd_cache.kernel_mode}_f64"
    inner = f"{A._mpdc_cache[2]._wjd_cache.kernel_mode}_f32"
    assert got[outer] == int(info.iterations) + 1
    assert got[inner] > 10 * int(info.iterations)
    _, info_cpu, _ = solve("cpu")
    assert int(info.iterations) == int(info_cpu.iterations)


def test_f32_hierarchy_on_the_card_keeps_csr_levels(cuda_device):
    """convert_hierarchy on the card keeps every level CSR (the kernels
    serve it); with auto_wjd off it picks the JAX package's DIA levels."""
    from rocalution_tpu_torch.solvers.multigrid import (amg_hierarchy,
                                                        convert_hierarchy)

    h = amg_hierarchy(rt.laplacian_3d(16), "sa", coarse_size=100)
    h32 = convert_hierarchy(h, dtype=np.float32)
    assert all(isinstance(lv.A, rt.CSR) for lv in h32.levels)
    rt.set_auto_wjd(False)
    try:
        h32p = convert_hierarchy(h, dtype=np.float32)
    finally:
        rt.set_auto_wjd(None)
    assert isinstance(h32p.levels[0].A, rt.DIA)


# bfloat16 values: f32 products summed in f32 by both the kernel and its
# plain version, in another order
BF16_CASES = {
    # launch counter: (operator on the CPU, planner kwargs, windowed regime)
    "roll_bf16": (lambda: rt.laplacian_3d(12, dtype=np.float32,
                                          device="cpu"),
                  {"kernel_mode": "roll", "split_dia": False}, False),
    "gather_bf16": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"),
        {"split_dia": False}, False),
    "win_roll_bf16": (lambda: rt.laplacian_3d(12, dtype=np.float32,
                                              device="cpu"),
                      {"kernel_mode": "roll", "split_dia": False}, True),
    "win_gather_bf16": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"),
        {"split_dia": False, "max_slots": 4}, True),
}


def _bf16_plan(key, monkeypatch):
    make, kw, in_window = BF16_CASES[key]
    if in_window:
        _windowed_regime(monkeypatch)
    W = _on_card(from_csr(make(), values_dtype="bfloat16", **kw))
    assert W.dtype == torch.bfloat16 and W.x_dtype == torch.float32
    assert windowed(W, torch.float32) is in_window
    return W


@pytest.mark.parametrize("key", sorted(BF16_CASES))
def test_bf16_kernel_matches_plain_version(cuda_device, key, monkeypatch):
    W = _bf16_plan(key, monkeypatch)
    gather = W.kernel_mode == "gather"
    if key.startswith("win_"):
        launch = kernels.slots_kernel_windowed
        plain = (kernels.plain_gather(W) if gather
                 else kernels.slots_plain_windowed)
    else:
        launch = kernels.slots_kernel
        plain = (kernels.plain_gather(W) if gather else kernels.slots_plain)
    x = _x(W.shape[1], torch.float32, cuda_device)
    xp = kernels.pad_x(W, x)
    before = kernels.launches[key]
    got = launch(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + 1
    assert got.dtype == torch.float32
    assert _rel(got, plain(W, xp)) <= TOL[torch.float32]
    # the entry point, with an f32 and a bfloat16 x (widened to f32)
    for xv in (x, x.to(torch.bfloat16)):
        y = kernels.wjd_spmv(W, xv)
        assert y.dtype == torch.float32
        assert _rel(y, kernels.wjd_reference(W, xv.float())) \
            <= TOL[torch.float32]
    assert kernels.launches[key] == before + 3


@pytest.mark.parametrize("kc", [4, 16])
@pytest.mark.parametrize("key", ["roll_bf16", "gather_bf16"])
def test_bf16_spmm_kernel_matches_plain_version(cuda_device, key, kc,
                                                monkeypatch):
    W = _bf16_plan(key, monkeypatch)
    plain = (kernels.plain_gather(W, mrhs=True) if W.kernel_mode == "gather"
             else kernels.slots_plain_mrhs)
    X = _x(W.shape[1] * kc, torch.float32, cuda_device).view(-1, kc)
    xp = kernels.pad_x(W, X, kc)
    before = kernels.launches[f"spmm_{key}"]
    got = kernels.slots_kernel_mrhs(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches[f"spmm_{key}"] == before + 1
    assert _rel(got, plain(W, xp)) <= TOL[torch.float32]
    # a column is summed in the single-RHS kernel's order, whatever kc is
    for j in range(kc):
        assert torch.equal(got[:, j], kernels.slots_kernel(
            W, xp[:, j].contiguous()).reshape(-1))
    Xb = X.to(torch.bfloat16)
    Y = rt.spmv(W, Xb)
    assert Y.dtype == torch.float32
    assert _rel(Y, kernels.wjd_reference(W, Xb.float())) <= TOL[torch.float32]


def test_bf16_plan_on_cuda_never_takes_the_plain_version(cuda_device,
                                                         monkeypatch):
    """A bfloat16 plan on the card launches its kernel for an f32 or a
    bfloat16 x, through rt.spmv and a solver, and never reaches a plain
    version; an f64 x is not served by it (plain CSR apply)."""
    A = rt.random_banded_spd(3000, bandwidth=512, dtype=np.float32,
                             device=cuda_device)
    rt.attach_wjd(A, values_dtype="bfloat16")
    assert A._wjd_cache.compact_form == "packed"

    def refuse(*args):
        raise AssertionError("a plain version ran on the card")

    for name in ("slots_plain", "slots_plain_compact", "slots_plain_windowed",
                 "slots_plain_compact_windowed", "slots_plain_mrhs",
                 "slots_plain_compact_mrhs", "slots_plain_packed",
                 "slots_plain_packed_mrhs", "slots_plain_packed_windowed"):
        monkeypatch.setattr(kernels, name, refuse)
    before = dict(kernels.launches)
    x = _x(A.shape[1], torch.float32, cuda_device)
    assert rt.spmv(A, x).dtype == torch.float32
    assert rt.spmv(A, x.to(torch.bfloat16)).dtype == torch.float32
    # check_every=1: no masked step, so one apply an iteration and one
    # for the first residual
    _, info = rt.cg(A, x, M=rt.jacobi(A), rel_tol=1e-4, max_iter=200,
                    check_every=1)
    torch.cuda.synchronize()
    got = kernels.launches["gather_bf16"] - before["gather_bf16"]
    assert int(info.status) == 2 and got == 2 + int(info.iterations) + 1
    assert rt.spmv(A, x.double()).dtype == torch.float64
    assert kernels.launches["gather_bf16"] - before["gather_bf16"] == got


def _ragged_rows():
    """3,000 rows of 0 to 37 entries (every slice width mod 4, empty
    slices, a ragged last tile), columns within 1,500 of the row."""
    rng = np.random.default_rng(11)
    lens = rng.integers(0, 38, 3000)
    lens[1024:1120] = 0
    rows = np.repeat(np.arange(3000), lens)
    cols = np.clip(rows + rng.integers(-1500, 1500, len(rows)), 0, 2999)
    S = sp.csr_matrix((rng.standard_normal(len(rows)).astype(np.float32),
                       (rows, cols)), shape=(3000, 3000))
    S.sum_duplicates()
    S.sort_indices()
    return rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape,
                              device="cpu")


BF16_GATHER = {
    # name: (operator on the CPU, planner kwargs, form the plan takes)
    "band_packed": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"),
        {"split_dia": False}, "packed"),
    "band_spill_packed": (lambda: rt.random_banded_spd(
        3000, bandwidth=512, dtype=np.float32, device="cpu"),
        {"split_dia": False, "max_slots": 4}, "packed"),
    "ragged_packed": (_ragged_rows, {"split_dia": False,
                                     "kernel_mode": "gather"}, "packed"),
    "wide_packed24": (lambda: _wide_rows(np.float32),
                      {"split_dia": False}, "packed24"),
}
# the counter of the direct bf16 gather kernel that serves each form
BF16_GATHER_KEY = {"packed": "gather_bf16",
                   "packed24": "gather_bf16_packed24",
                   "compact": "gather_bf16_compact"}


@pytest.mark.parametrize("name", sorted(BF16_GATHER))
def test_bf16_gather_kernels_on_each_form(cuda_device, name):
    """The direct bf16 gather kernels, single and blocked (KC 4, 8, 16),
    on the form the plan takes: packed (2-byte offsets; ragged widths,
    empty slices, a ragged last tile, a spill) or packed24 (offsets past
    16 bits, a high byte a word). Each against the plain version over its
    form and the padded slot product, counted as its form's kernel; a
    column of a blocked product is the single product bit for bit; rt.spmv
    on 20 columns launches twice (16 + 4) and agrees."""
    make, kw, form = BF16_GATHER[name]
    W = _on_card(from_csr(make(), values_dtype="bfloat16", **kw))
    assert W.compact_form == form and W.data is not None
    key = BF16_GATHER_KEY[form]
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    xp = kernels.pad_x(W, x)
    before = dict(kernels.launches)
    y = kernels.slots_kernel(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, key: before[key] + 1}
    assert _rel(y, kernels.plain_gather(W)(W, xp)) <= tol
    assert _rel(y, kernels.slots_plain(W, xp)) <= tol
    for kc in (4, 8, 16):
        X = _x(W.shape[1] * kc, torch.float32, cuda_device).view(-1, kc)
        xq = kernels.pad_x(W, X, kc)
        n0 = kernels.launches[f"spmm_{key}"]
        Y = kernels.slots_kernel_mrhs(W, xq)
        torch.cuda.synchronize()
        assert kernels.launches[f"spmm_{key}"] == n0 + 1
        assert _rel(Y, kernels.plain_gather(W, mrhs=True)(W, xq)) <= tol
        assert _rel(Y, kernels.slots_plain_mrhs(W, xq)) <= tol
        for j in range(kc):
            assert torch.equal(Y[:, j], kernels.slots_kernel(
                W, xq[:, j].contiguous()).reshape(-1)), (kc, j)
    X = _x(W.shape[1] * 20, torch.float32, cuda_device).view(-1, 20)
    n0 = kernels.launches[f"spmm_{key}"]
    Y = rt.spmv(W, X)
    torch.cuda.synchronize()
    assert kernels.launches[f"spmm_{key}"] == n0 + 2
    assert tuple(Y.shape) == (W.shape[0], 20)
    assert _rel(Y, kernels.wjd_reference(W, X)) <= tol


def test_packed_kernels_refuse_misaligned_operands(cuda_device):
    """The packed kernels read 16 bytes a lane: words or a padded X off a
    16-byte boundary raise before a launch."""
    W = _on_card(from_csr(BF16_GATHER["band_packed"][0](),
                          values_dtype="bfloat16", split_dia=False))
    X = _x(W.shape[1] * 4, torch.float32, cuda_device).view(-1, 4)
    xq = kernels.pad_x(W, X, 4)
    off = torch.empty(xq.numel() + 1, dtype=torch.float32,
                      device=cuda_device)[1:].view(xq.shape)
    off.copy_(xq)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.slots_kernel_mrhs(W, off)
    moved = torch.empty(W.cpack.numel() + 1, dtype=torch.int32,
                        device=cuda_device)[1:]
    moved.copy_(W.cpack)
    with pytest.raises(ValueError):
        kernels.slots_kernel(dataclasses.replace(W, cpack=moved),
                             kernels.pad_x(W, X[:, 0].contiguous()))
    assert kernels.launches == before


WIN_BF16_GATHER = {
    # name: (operator on the CPU, planner kwargs, tiles a step, form)
    "band_packed": (BF16_GATHER["band_packed"][0], {"split_dia": False}, 1,
                    "packed"),
    "band_group2_spill_packed": (BF16_GATHER["band_packed"][0],
                                 {"split_dia": False, "max_slots": 4}, 2,
                                 "packed"),
    "ragged_packed": (_ragged_rows, {"split_dia": False,
                                     "kernel_mode": "gather"}, 1, "packed"),
    "wide_packed24": (lambda: _wide_rows(np.float32),
                      {"split_dia": False}, 1, "packed24"),
}


@pytest.mark.parametrize("name", sorted(WIN_BF16_GATHER))
def test_windowed_bf16_gather_kernels_on_each_form(cuda_device, name,
                                                   monkeypatch):
    """A windowed bf16 gather plan takes the packed form where its
    window-relative offsets fit 2 bytes, else (a window of more than 512
    rows) the packed24 form. Its windowed kernel launches its own counter
    (win_gather_bf16 or win_gather_bf16_packed24) and no other counter
    moves; it agrees with the windowed plain version over its form and the
    padded slot product, and is bit for bit the direct kernel over the
    same form (xbase holds the step windows). Its blocked product goes
    through the SpMM kernel of its form (spmm_gather_bf16 or
    spmm_gather_bf16_packed24), and no other counter moves."""
    make, kw, group, form = WIN_BF16_GATHER[name]
    _windowed_regime(monkeypatch, group)
    W = _on_card(from_csr(make(), values_dtype="bfloat16", **kw))
    assert W.window_relative and windowed(W, torch.float32)
    assert W.compact_form == form and W.group == group
    if form == "packed24":
        assert W.win_rows > 512
    tail = BF16_GATHER_KEY[form][len("gather_bf16"):]
    key, spmm_key = f"win_gather_bf16{tail}", f"spmm_gather_bf16{tail}"
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    xp = kernels.pad_x(W, x)
    direct = kernels.slots_kernel(W, xp)
    before = dict(kernels.launches)
    y = kernels.slots_kernel_windowed(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, key: before[key] + 1}
    assert _rel(y, kernels.plain_gather(W)(W, xp)) <= tol
    assert _rel(y, kernels.slots_plain(W, xp)) <= tol
    assert torch.equal(y, direct)
    y = kernels.wjd_spmv(W, x)
    assert kernels.launches == {**before, key: before[key] + 2}
    assert _rel(y, kernels.wjd_reference(W, x)) <= tol
    X = _x(W.shape[1] * 16, torch.float32, cuda_device).view(-1, 16)
    before = dict(kernels.launches)
    Y = rt.spmv(W, X)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, spmm_key: before[spmm_key] + 1}
    assert _rel(Y, kernels.wjd_reference(W, X)) <= tol


def _past_24_bits():
    """64 rows, each coupled to a column 2**24 + 2**19 further on, on the
    CPU: offsets past 24 bits, direct or window-relative."""
    n, m = 64, (1 << 24) + (1 << 20)
    rows = np.repeat(np.arange(n), 2)
    cols = np.stack([np.arange(n), (1 << 24) + (1 << 19) + np.arange(n)],
                    1).reshape(-1)
    vals = np.random.default_rng(5).standard_normal(2 * n).astype(np.float32)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    return rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape,
                              device="cpu")


@pytest.mark.parametrize("regime", ["direct", "windowed"])
def test_bf16_plan_past_24_bits_reaches_the_compact_kernels(cuda_device,
                                                            regime,
                                                            monkeypatch):
    """A bf16 gather plan whose offsets pass 24 bits keeps the compact form
    with int32 offsets, and its products go through the compact bf16
    kernels (gather_bf16_compact, or win_gather_bf16_compact in the
    windowed regime, and spmm_gather_bf16_compact), each against its plain
    version; no packed kernel is launched. rt.spmv on 20 columns launches
    the SpMM twice (16 + 4). The windowed compact kernel is the direct one
    over the same form bit for bit (xbase holds the step windows). A
    direct plan's x is at most X_VMEM_BUDGET bytes, so the direct case
    raises the budget."""
    if regime == "windowed":
        _windowed_regime(monkeypatch)
    else:
        monkeypatch.setattr(wjd_mod, "X_VMEM_BUDGET", 1 << 30)
    W = _on_card(from_csr(_past_24_bits(), values_dtype="bfloat16",
                          split_dia=False, kernel_mode="gather"))
    assert W.compact_form == "compact" and W.coff.dtype == torch.int32
    assert int(W.coff.max()) >= 1 << 24
    assert W.window_relative is (regime == "windowed")
    key = ("win_" if regime == "windowed" else "") + "gather_bf16_compact"
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    before = dict(kernels.launches)
    y = kernels.wjd_spmv(W, x)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, key: before[key] + 1}
    assert _rel(y, kernels.wjd_reference(W, x)) <= tol
    if regime == "windowed":
        xp = kernels.pad_x(W, x)
        assert torch.equal(kernels.slots_kernel_windowed(W, xp),
                           kernels.slots_kernel(W, xp))
    X = _x(W.shape[1] * 20, torch.float32, cuda_device).view(-1, 20)
    before = dict(kernels.launches)
    Y = rt.spmv(W, X)
    torch.cuda.synchronize()
    spmm_key = "spmm_gather_bf16_compact"
    assert kernels.launches == {**before, spmm_key: before[spmm_key] + 2}
    assert tuple(Y.shape) == (W.shape[0], 20)
    assert _rel(Y, kernels.wjd_reference(W, X)) <= tol


@pytest.mark.parametrize("regime", ["direct", "windowed"])
def test_packed24_kernels_against_the_compact_kernels(cuda_device, regime,
                                                      monkeypatch):
    """On the wide plan (offsets past 16 bits), the packed24 SpMV and SpMM
    against the compact bf16 kernels on the same plan unpacked to int32
    offsets, the form they replace below 2**24 (1e-5), each counted as its
    own kernel; high bytes off a 4-byte boundary are refused before a
    launch."""
    if regime == "windowed":
        _windowed_regime(monkeypatch)
    W = _on_card(from_csr(_wide_rows(np.float32), values_dtype="bfloat16",
                          split_dia=False))
    assert W.compact_form == "packed24"
    assert W.window_relative is (regime == "windowed")
    c = wjd_mod.unpack_bf16_slices(*(getattr(W, k).cpu().numpy() for k in (
        "cpack", "slice_ptr", "xbase", "chi")))
    Wc = _on_card(dataclasses.replace(
        W, cpack=None, chi=None, slice_ptr=torch.from_numpy(c["slice_ptr"]),
        cval=torch.from_numpy(c["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"])))
    assert Wc.compact_form == "compact" and Wc.coff.dtype == torch.int32
    win = "win_" if regime == "windowed" else ""
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    X = _x(W.shape[1] * 16, torch.float32, cuda_device).view(-1, 16)
    before = dict(kernels.launches)
    y, yc = kernels.wjd_spmv(W, x), kernels.wjd_spmv(Wc, x)
    Y, Yc = kernels.wjd_spmm(W, X), kernels.wjd_spmm(Wc, X)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in kernels.launches.items()
             if n != before[k]}
    assert moved == {f"{win}gather_bf16_packed24": 1,
                     f"{win}gather_bf16_compact": 1,
                     "spmm_gather_bf16_packed24": 1,
                     "spmm_gather_bf16_compact": 1}
    assert _rel(y, yc) <= tol and _rel(Y, Yc) <= tol
    shifted = torch.empty(W.chi.numel() + 1, dtype=torch.uint8,
                          device=cuda_device)[1:]
    shifted.copy_(W.chi)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.wjd_spmv(dataclasses.replace(W, chi=shifted), x)
    assert kernels.launches == before


def _diagonals(offsets, n=3000):
    """n rows with random values on the diagonals `offsets`, on the CPU."""
    rng = np.random.default_rng(9)
    offsets = list(offsets)
    S = sp.diags([rng.standard_normal(n - abs(d)).astype(np.float32)
                  for d in offsets], offsets, shape=(n, n), format="csr")
    S.sort_indices()
    return rt.CSR.from_arrays(S.data, S.indices.astype(np.int32),
                              S.indptr.astype(np.int32), S.shape,
                              device="cpu")


ROLL_BF16 = {
    # name: (diagonal offsets, planner kwargs): K = 7, and K = 150, more
    # slots than the kernel stages at a time (128)
    "seven": (range(-3, 4), {}),
    "many_slots": (range(-149, 1), {"max_slots": None}),
}


@pytest.mark.parametrize("name", sorted(ROLL_BF16))
def test_windowed_bf16_roll_kernel(cuda_device, name, monkeypatch):
    """The windowed bf16 roll kernel (4 rows a thread, slot offsets staged
    128 at a time) against its plain version at 1e-5, on plans whose
    diag_u covers every residue mod 4 (every alignment of a thread's 4 x
    values), with K not a multiple of 4 and three grid steps; the entry
    point launches it and no other counter moves; an x off a 16-byte
    boundary is refused."""
    offsets, kw = ROLL_BF16[name]
    _windowed_regime(monkeypatch)
    W = _on_card(from_csr(_diagonals(offsets), values_dtype="bfloat16",
                          kernel_mode="roll", split_dia=False, **kw))
    K = W.brow.shape[1]
    assert windowed(W, torch.float32) and len(W.win_base) == 3
    assert K % 4 and K == len(offsets)
    assert set((W.diag_u & 3).unique().tolist()) == {0, 1, 2, 3}
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    xp = kernels.pad_x(W, x)
    before = dict(kernels.launches)
    y = kernels.slots_kernel_windowed(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches == {**before,
                                "win_roll_bf16": before["win_roll_bf16"] + 1}
    assert _rel(y, kernels.slots_plain_windowed(W, xp)) <= tol
    y = kernels.wjd_spmv(W, x)
    assert kernels.launches["win_roll_bf16"] == before["win_roll_bf16"] + 2
    assert _rel(y, kernels.wjd_reference(W, x)) <= tol
    moved = torch.empty(xp.numel() + 1, dtype=torch.float32,
                        device=cuda_device)[1:]
    moved.copy_(xp)
    with pytest.raises(ValueError):
        kernels.slots_kernel_windowed(W, moved)


@pytest.mark.parametrize("name", sorted(ROLL_BF16))
def test_direct_bf16_roll_kernel(cuda_device, name):
    """The direct bf16 roll kernel (the windowed bf16 roll body with no
    window) against its plain version at 1e-5, on direct plans whose
    diag_u covers every residue mod 4, with K = 7 and K = 150 (two staging
    batches) and a ragged last tile; each column of the bf16 roll SpMM is
    its product bit for bit (both sum the slots in order with FMA); the
    entry point and rt.spmv launch it once a call and no other counter
    moves; an x off a 16-byte boundary is refused and launches nothing."""
    offsets, kw = ROLL_BF16[name]
    W = _on_card(from_csr(_diagonals(offsets), values_dtype="bfloat16",
                          kernel_mode="roll", split_dia=False, **kw))
    K = W.brow.shape[1]
    assert not windowed(W, torch.float32) and W.shape[0] % 1024
    assert K % 4 and K == len(offsets)
    assert set((W.diag_u & 3).unique().tolist()) == {0, 1, 2, 3}
    tol = TOL[torch.float32]
    x = _x(W.shape[1], torch.float32, cuda_device)
    xp = kernels.pad_x(W, x)
    before = dict(kernels.launches)
    y = kernels.slots_kernel(W, xp)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, "roll_bf16": before["roll_bf16"] + 1}
    assert _rel(y, kernels.slots_plain(W, xp)) <= tol
    before = dict(kernels.launches)
    y = rt.spmv(W, x)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, "roll_bf16": before["roll_bf16"] + 1}
    assert _rel(y, kernels.wjd_reference(W, x)) <= tol
    X = _x(W.shape[1] * 4, torch.float32, cuda_device).view(-1, 4)
    xq = kernels.pad_x(W, X, 4)
    Y = kernels.slots_kernel_mrhs(W, xq)
    for j in range(4):
        assert torch.equal(Y[:, j], kernels.slots_kernel(
            W, xq[:, j].contiguous()).reshape(-1)), j
    moved = torch.empty(xp.numel() + 1, dtype=torch.float32,
                        device=cuda_device)[1:]
    moved.copy_(xp)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.slots_kernel(W, moved)
    assert kernels.launches == before


@pytest.mark.parametrize("coff_dtype", [np.int32, np.uint16])
def test_compact_bf16_spmm_kernel(cuda_device, coff_dtype):
    """The compact bf16 SpMM (values held raw, 4 ranks a group) at KC 4, 8
    and 16 on the ragged plan's compact form: slices of every width mod 4,
    empty slices, a ragged last tile. With 4-byte offsets, the form a bf16
    plan whose offsets pass 16 bits keeps; with 2-byte offsets, which no
    plan keeps (the offset width alone packs it) but the kernel serves.
    Against its plain version over the form and the padded slot product; a
    column is the single compact kernel's product bit for bit; the entry
    point and rt.spmv on 16 columns launch it once and no other counter
    moves."""
    Wp = from_csr(_ragged_rows(), values_dtype="bfloat16", split_dia=False,
                  kernel_mode="gather")
    assert Wp.compact_form == "packed"
    c = wjd_mod.unpack_bf16_slices(Wp.cpack.numpy(), Wp.slice_ptr.numpy(),
                                   Wp.xbase.numpy())
    W = _on_card(dataclasses.replace(
        Wp, cpack=None, slice_ptr=torch.from_numpy(c["slice_ptr"]),
        cval=torch.from_numpy(c["cval"]).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"].astype(coff_dtype))))
    assert W.compact_form == "compact"
    width = np.diff(c["slice_ptr"]) // 32
    assert (width == 0).any() and set((width % 4).tolist()) == {0, 1, 2, 3}
    key, tol = "spmm_gather_bf16_compact", TOL[torch.float32]
    for kc in (4, 8, 16):
        X = _x(W.shape[1] * kc, torch.float32, cuda_device).view(-1, kc)
        xq = kernels.pad_x(W, X, kc)
        before = dict(kernels.launches)
        Y = kernels.slots_kernel_mrhs(W, xq)
        torch.cuda.synchronize()
        assert kernels.launches == {**before, key: before[key] + 1}
        assert _rel(Y, kernels.slots_plain_compact_mrhs(W, xq)) <= tol
        assert _rel(Y, kernels.slots_plain_mrhs(W, xq)) <= tol
        for j in range(kc):
            assert torch.equal(Y[:, j], kernels.slots_kernel(
                W, xq[:, j].contiguous()).reshape(-1)), (kc, j)
    X = _x(W.shape[1] * 16, torch.float32, cuda_device).view(-1, 16)
    before = dict(kernels.launches)
    Y = rt.spmv(W, X)
    torch.cuda.synchronize()
    assert kernels.launches == {**before, key: before[key] + 1}
    assert _rel(Y, kernels.wjd_reference(W, X)) <= tol


# the preconditioners of the rest of the stack: name -> (operator, build)
PRECONDS = {
    "sgs": ("lap", lambda P, A: P.sgs(A)),
    "ssor": ("lap", lambda P, A: P.ssor(A, 1.5)),
    "mc_sgs": ("lap", lambda P, A: P.multicolored_sgs(A)),
    "mc_ilu": ("lap", lambda P, A: P.multicolored_ilu(A, 0, 1)),
    "fsai": ("lap", lambda P, A: P.fsai(A)),
    "spai": ("lap", lambda P, A: P.spai(A)),
    "tns": ("lap", lambda P, A: P.tns(A, 2)),
    "aichebyshev": ("lap", lambda P, A: P.aichebyshev(A, 4)),
    "block_jacobi": ("lap", lambda P, A: P.block_jacobi(A, A.shape[0] // 64)),
    "as": ("lap", lambda P, A: P.additive_schwarz(A, A.shape[0] // 64, 8)),
    "ras": ("lap", lambda P, A: P.restricted_additive_schwarz(
        A, A.shape[0] // 64, 8)),
    "bsr_ic0": ("lap", lambda P, A: P.bsr_ic0(rt.convert(A, "BCSR",
                                                         block_dim=2))),
    "ilu1": ("cd", lambda P, A: P.ilu(A, 1)),
    "ilut": ("cd", lambda P, A: P.ilut_precond(A, 1e-3, 32)),
    "bsr_ilu0": ("cd", lambda P, A: P.bsr_ilu0(rt.convert(A, "BCSR",
                                                          block_dim=2))),
    "me": ("cd", lambda P, A: P.multi_elimination(A, 3, 1e-3,
                                                  last_solver=P.ilu)),
    "variable": ("cd", lambda P, A: P.variable_precond(
        [P.jacobi(A), P.sgs(A), P.tns(A)])),
}


@pytest.mark.parametrize("name", sorted(PRECONDS))
def test_preconditioner_apply_on_the_card_matches_the_cpu(cuda_device,
                                                          name):
    """One apply of each preconditioner on the card against the same
    preconditioner built and applied on the CPU, at 1e-12 relative in f64
    (variable: each branch once)."""
    from rocalution_tpu_torch import precond

    op, build = PRECONDS[name]
    make = {"lap": lambda d: rt.laplacian_3d(16, device=d),
            "cd": lambda d: rt.convection_diffusion_2d(48, device=d)}[op]
    M_card, M_cpu = build(precond, make(cuda_device)), build(precond,
                                                             make("cpu"))
    r = _x(make("cpu").shape[0], torch.float64, "cpu", seed=3)
    for _ in range(3 if name == "variable" else 1):
        assert _rel(M_card(r.to(cuda_device)).cpu(), M_cpu(r)) <= 1e-12


def test_fsai_apply_launches_the_kernels(cuda_device):
    """FSAI's two factors carry plans: an apply is two kernel launches."""
    from rocalution_tpu_torch import precond

    M = precond.fsai(rt.laplacian_3d(16, device=cuda_device))
    keys = {f"{G._wjd_cache.kernel_mode}_f64" for G in M.matrices}
    r = _x(16 ** 3, torch.float64, cuda_device)
    M(r)
    before = dict(kernels.launches)
    M(r)
    torch.cuda.synchronize()
    assert sum(kernels.launches[k] - before[k] for k in keys) == 2


def test_rsamg_cycle_launches_the_kernels(cuda_device):
    """CG + RS-AMG (greedy, direct) on the card: every transfer and level
    operator carries a plan, a V-cycle launches a kernel for each of
    them, and the solve takes the iterations of the same solve on the CPU
    (within 1)."""
    from rocalution_tpu_torch.solvers.multigrid import (cycle_closure,
                                                        rsamg)

    def solve(device):
        A = rt.laplacian_2d(96, device=device)
        M = cycle_closure(rsamg(A, coarse_size=200, coarsening="greedy",
                                interpolation="direct"))
        d, _, p = A.numpy_triplet()
        b = torch.from_numpy(np.add.reduceat(d, p[:-1])).to(device)
        x, info = rt.cg(M.hierarchy.levels[0].A, b, M=M, rel_tol=1e-8,
                        max_iter=100, check_every=4)
        return M, b, x, info

    M, b, x, info = solve(cuda_device)
    h = M.hierarchy
    assert h.num_levels >= 3
    plans = [T for lv in h.levels for T in (lv.A, lv.P, lv.R)
             if isinstance(T, rt.CSR)]
    assert all(T._wjd_cache is not None for T in plans)
    before = sum(kernels.launches.values())
    M(b)
    torch.cuda.synchronize()
    assert sum(kernels.launches.values()) - before >= len(plans)
    assert int(info.status) == 2
    assert float((x - 1).abs().max()) < 1e-6
    _, _, _, info_cpu = solve("cpu")
    assert abs(int(info.iterations) - int(info_cpu.iterations)) <= 1


def test_device_pmis_on_the_card_matches_the_cpu(cuda_device):
    from rocalution_tpu_torch.solvers.multigrid import aggregation_device
    from rocalution_tpu_torch.solvers.multigrid import rs

    Sg = rs.classical_strength(rs._scipy(rt.laplacian_2d(64, device="cpu")))
    np.testing.assert_array_equal(
        aggregation_device.pmis_coarsening_device(Sg, 1, cuda_device),
        aggregation_device.pmis_coarsening_device(Sg, 1, "cpu"))
    np.testing.assert_array_equal(
        aggregation_device.pmis_aggregate_jit(Sg, 1, cuda_device),
        aggregation_device.pmis_aggregate_jit(Sg, 1, "cpu"))


def _complex_op(mode, cdt, device):
    """S + 0.05j*T: S laplacian_3d(12) (roll planes) or
    random_banded_spd(3000) (gather planes), T a seeded matrix on S's
    pattern made symmetric."""
    S = (rt.laplacian_3d(12, device="cpu") if mode == "roll" else
         rt.random_banded_spd(3000, bandwidth=512, device="cpu"))
    d, i, p = S.numpy_triplet()
    M = sp.csr_matrix((np.random.default_rng(5).standard_normal(len(d)),
                       i, p), shape=S.shape)
    T = (M + M.T).tocsr()
    T.sort_indices()
    vals = (d + 0.05j * np.asarray(T[np.repeat(np.arange(S.shape[0]),
                                                np.diff(p)), i]).ravel())
    return rt.CSR.from_arrays(vals.astype(cdt), i, p, S.shape,
                              device=device)


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
@pytest.mark.parametrize("mode", ["roll", "gather"])
def test_complex_apply_matches_plain_version(cuda_device, mode, cdt):
    """A ComplexWJD on the card: each plane's SpMM kernel, two launches a
    product, against the reference's formula over the planes' plain
    products and against the plain complex CSR product (x and X)."""
    A = _complex_op(mode, cdt, cuda_device)
    C = from_csr(A)
    assert isinstance(C, rt.ComplexWJD) and C.re.kernel_mode == mode
    tol = TOL[C.re.dtype]
    rng = np.random.default_rng(3)
    n = A.shape[0]
    for shape in ((n,), (n, 5)):
        x = torch.from_numpy((rng.standard_normal(shape) + 1j
                              * rng.standard_normal(shape)).astype(cdt)).to(
            cuda_device)
        key = f"spmm_{mode}_{kernels._DTYPE_TAG[C.re.dtype]}"
        before = kernels.launches[key]
        got = kernels.cwjd_spmv(C, x)
        torch.cuda.synchronize()
        assert kernels.launches[key] == before + 2
        assert got.dtype == A.data.dtype
        assert _rel(got, kernels.cwjd_reference(C, x)) <= tol
        plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
        assert _rel(got, rt.spmv(plain, x)) <= tol


def test_complex_cg_goes_through_the_kernels(cuda_device):
    """Fault 11: a complex CSR on the card is planned into a ComplexWJD at
    setup, and a complex CG launches its planes' kernels, two a product,
    every iteration; the same solve on the CPU takes as many iterations.
    GMRES takes complex input too."""

    def solve(device, solver=rt.cg):
        A = _complex_op("roll", np.complex128, device)
        b = torch.from_numpy(np.exp(1j * np.arange(A.shape[0]))).to(device)
        before = kernels.launches["spmm_roll_f64"]
        x, info = solver(A, b, M=rt.jacobi(A), rel_tol=1e-10, max_iter=500)
        if device != "cpu":
            torch.cuda.synchronize()
        return A, info, kernels.launches["spmm_roll_f64"] - before

    A, info, got = solve(cuda_device)
    assert isinstance(A._wjd_cache, rt.ComplexWJD)
    assert int(info.status) == 2
    assert got >= 2 * (int(info.iterations) + 1)
    _, info_cpu, _ = solve("cpu")
    assert abs(int(info.iterations) - int(info_cpu.iterations)) <= 1
    A, info, got = solve(cuda_device, rt.gmres)
    assert int(info.status) == 2 and got >= 2 * int(info.iterations)


# the distributed layer: a GlobalCSR's interior parts through the kernels
DIST_CASES = {
    "roll_f64": (lambda: rt.laplacian_3d(16), np.float64),
    "gather_f64": (lambda: rt.random_banded_spd(8000, bandwidth=512),
                   np.float64),
    "roll_f32": (lambda: rt.laplacian_3d(16), np.float32),
}


@pytest.mark.parametrize("nparts", [4, 8])
@pytest.mark.parametrize("key", sorted(DIST_CASES))
def test_distributed_interiors_launch_once_per_part(cuda_device, key,
                                                    nparts):
    """On the card `distribute_csr` plans every interior part; one apply
    launches the part's kernel once per part, and each part's kernel
    matches its plain version."""
    from rocalution_tpu_torch import parallel as tpar

    make, dtype = DIST_CASES[key]
    A = make()
    d, i, p = A.numpy_triplet()
    A = rt.CSR.from_arrays(d.astype(dtype), i, p, A.shape, device="cpu")
    Ag = tpar.distribute_csr(A, nparts, device=cuda_device)
    W = Ag.int_wjd
    assert W is not None and W.nparts == nparts
    assert key.startswith(W.kernel_mode)
    x = _x(A.shape[0], Ag.dtype, cuda_device)
    xp = tpar.distribute_vector(x, nparts, Ag.n_local)
    comm = tpar.make_comm(nparts)
    before = kernels.launches[key]
    y = tpar.gather_vector(tpar.shard_spmv(Ag, xp, comm), Ag.n_global)
    torch.cuda.synchronize()
    assert kernels.launches[key] == before + nparts
    for q in range(nparts):
        Wq = W.parts[q]
        got = kernels.wjd_spmv(Wq, xp[q])
        want = kernels.wjd_reference(Wq, xp[q])
        assert _rel(got, want) <= TOL[Wq.dtype], (key, q)
    plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape,
                               device=cuda_device)
    rt.set_auto_wjd(False)
    try:
        want = rt.spmv(plain, x)
    finally:
        rt.set_auto_wjd(None)
    assert _rel(y, want) <= TOL[Ag.dtype], key


def test_distributed_cg_on_cuda_goes_through_the_kernel(cuda_device):
    from rocalution_tpu_torch import parallel as tpar

    A = rt.laplacian_3d(16, device="cpu")
    Ag = tpar.distribute_csr(A, 4, device=cuda_device)
    ones = torch.ones(A.shape[0], dtype=torch.float64, device=cuda_device)
    rhs = tpar.gather_vector(tpar.shard_spmv(
        Ag, tpar.distribute_vector(ones, 4, Ag.n_local),
        tpar.make_comm(4)), Ag.n_global)
    before = kernels.launches["roll_f64"]
    x, info = tpar.dist_solve(rt.cg, Ag, rhs, M=tpar.block_jacobi_diag(Ag),
                              rel_tol=1e-10, max_iter=500, check_every=8)
    it = int(info.iterations)
    assert int(info.status) == 2
    # the residual apply, then every step of the chunks of 8 the loop ran
    # (steps after the stop are masked but still apply A): 4 launches each
    steps = -(-it // 8) * 8
    assert kernels.launches["roll_f64"] - before == 4 * (1 + steps)
    assert float((x - 1.0).abs().max()) < 1e-7


# the windowed branch of the stacked plan: a 1 KiB budget puts every part
# of these operators (several tiles a part) in the windowed regime
WIN_DIST_CASES = {
    "roll_f64": (lambda: rt.laplacian_3d(24, device="cpu"), np.float64),
    "roll_f32": (lambda: rt.laplacian_3d(24, device="cpu"), np.float32),
    "gather_f32": (lambda: rt.random_banded_spd(16000, bandwidth=512,
                                                device="cpu"), np.float32),
}


@pytest.mark.parametrize("key", sorted(WIN_DIST_CASES))
def test_distributed_windowed_interiors(cuda_device, key, monkeypatch):
    """With the budget of `_windowed_regime` the stacked planner gives each
    interior part windows: one apply launches the part's windowed kernel
    once a part and nothing else, and matches the plain CSR product; one
    distributed CG through it reaches the plain interior path's count."""
    from rocalution_tpu_torch import parallel as tpar

    _windowed_regime(monkeypatch)
    nparts = 4
    make, dtype = WIN_DIST_CASES[key]
    A = make()
    d, i, p = A.numpy_triplet()
    A = rt.CSR.from_arrays(d.astype(dtype), i, p, A.shape, device="cpu")
    Ag = tpar.distribute_csr(A, nparts, device=cuda_device)
    W = Ag.int_wjd
    assert W is not None and key.startswith(W.kernel_mode)
    for Wq in W.parts:
        assert windowed(Wq, Wq.dtype) and len(Wq.win_base) > 1
        assert W.kernel_mode == "roll" or Wq.window_relative
    x = _x(A.shape[0], Ag.dtype, cuda_device)
    xp = tpar.distribute_vector(x, nparts, Ag.n_local)
    comm = tpar.make_comm(nparts)
    before = dict(kernels.launches)
    y = tpar.gather_vector(tpar.shard_spmv(Ag, xp, comm), Ag.n_global)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in kernels.launches.items()
             if n != before[k]}
    assert moved == {f"win_{key}": nparts}
    plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape,
                               device=cuda_device)
    rt.set_auto_wjd(False)
    try:
        want = rt.spmv(plain, x)
    finally:
        rt.set_auto_wjd(None)
    assert _rel(y, want) <= TOL[Ag.dtype], key
    ones = torch.ones(A.shape[0], dtype=Ag.dtype, device=cuda_device)
    rhs = tpar.gather_vector(tpar.shard_spmv(
        Ag, tpar.distribute_vector(ones, nparts, Ag.n_local), comm),
        Ag.n_global)
    M = tpar.block_jacobi_diag(Ag)
    kw = dict(rel_tol=1e-10 if dtype == np.float64 else 1e-5,
              max_iter=1000, check_every=8)
    before = kernels.launches[f"win_{key}"]
    xs, info = tpar.dist_solve(rt.cg, Ag, rhs, M=M, **kw)
    it = int(info.iterations)
    assert int(info.status) == 2
    steps = -(-it // 8) * 8
    assert kernels.launches[f"win_{key}"] - before == nparts * (1 + steps)
    _, info_plain = tpar.dist_solve(
        rt.cg, dataclasses.replace(Ag, int_wjd=None), rhs, M=M, **kw)
    assert abs(it - int(info_plain.iterations)) <= 1
    assert float((xs - 1.0).abs().max()) < (1e-7 if dtype == np.float64
                                             else 1e-2)
