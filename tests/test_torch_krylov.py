"""Port parity: the Krylov family beyond CG and GMRES, Chebyshev, the
spectral helpers, and f32 solves over bfloat16 plans.

CR, FCG, BiCGStab, BiCGStab(l), IDR(s) and QMRCGStab, Chebyshev on
Gershgorin bounds and the power method run on laplacian_2d(16) and
convection_diffusion_2d(16), with and without Jacobi, through both
packages on the same operator and rhs. Each case must give the JAX
package's status and iteration count (f64: exactly; f32: the same status
and iterations within 2), and its residual history must stay within rtol
1e-10 of JAX's (f32: 1e-5) wherever the solve itself is reproducible to
that level. The BiCG family (BiCGStab, QMRCGStab, BiCGStab(l), IDR)
amplifies rounding by a factor of about 3 an iteration on these
operators: the JAX package's own history moves by up to 5e-2 relative
when b is changed by 1e-15 relative, as far as the port's lies from it.
So the bound on an entry is rtol or 100 times the port's own drift up to
that iteration under such a change of b (its history with b * (1 + 1e-15),
running maximum), whichever is larger; for CR, FCG, Chebyshev and the
power method the drift stays near 1e-15, and the bound is rtol.

IDR's shadow space is JAX's own draw (jax.random cannot be reproduced in
torch), handed to the port through ``shadow_draw``; the power method
starts from a given x0. Counts and histories do not depend on
`check_every` (bit for bit). The f32 solves over a bfloat16 plan (a CG,
and MixedPrecisionDC with a CG over a bfloat16 copy as its inner solver,
the call chip_smoke.py's phase N3 makes at a million rows) give the JAX
package's status and counts. The JAX side is solved once per case
(module-scoped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu.formats.wjd as jax_wjd
import rocalution_tpu_torch as rt
import rocalution_tpu_torch.formats.wjd as torch_wjd
from rocalution_tpu.ops.spmv import attach_wjd as jax_attach_wjd
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GENERATORS = {
    "lap": lambda m, dt: m.laplacian_2d(16, dtype=dt),
    "cd": lambda m, dt: m.convection_diffusion_2d(16, dtype=dt),
}
RTOL = {np.float64: 1e-10, np.float32: 1e-5}
# the relative change of b that measures a solve's own rounding drift
NUDGE = {np.float64: 1e-15, np.float32: 1e-6}
DRIFT_FACTOR = 100.0


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU
    (module scope: the module-scoped fixtures build on it too)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _b(n, dtype, seed=4):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


# name: (solver, operator, Jacobi, dtype, solver kwargs)
CASES = {
    "cr_lap": ("cr", "lap", False, np.float64, {}),
    # CR assumes a symmetric operator: on convection-diffusion it runs to
    # max_iter, the same in both packages
    "cr_cd_jacobi": ("cr", "cd", True, np.float64, {"max_iter": 120}),
    "fcg_lap_jacobi": ("fcg", "lap", True, np.float64, {}),
    "fcg_cd": ("fcg", "cd", False, np.float64, {}),
    "bicgstab_lap": ("bicgstab", "lap", False, np.float64, {}),
    "bicgstab_cd_jacobi": ("bicgstab", "cd", True, np.float64, {}),
    "bicgstab_cd_res_norm1": ("bicgstab", "cd", True, np.float64,
                              {"res_norm": 1}),
    "bicgstab_cd_res_norm3": ("bicgstab", "cd", True, np.float64,
                              {"res_norm": 3}),
    "qmrcgstab_lap_jacobi": ("qmrcgstab", "lap", True, np.float64, {}),
    "qmrcgstab_cd": ("qmrcgstab", "cd", False, np.float64, {}),
    "bicgstabl1_cd_jacobi": ("bicgstabl", "cd", True, np.float64,
                             {"order": 1}),
    "bicgstabl2_lap": ("bicgstabl", "lap", False, np.float64, {"order": 2}),
    "bicgstabl4_cd_jacobi": ("bicgstabl", "cd", True, np.float64,
                             {"order": 4}),
    "idr1_cd_jacobi": ("idr", "cd", True, np.float64, {"shadow_space": 1}),
    "idr2_lap": ("idr", "lap", False, np.float64, {"shadow_space": 2}),
    "idr4_cd_jacobi": ("idr", "cd", True, np.float64, {"shadow_space": 4}),
    "chebyshev_lap": ("chebyshev", "lap", False, np.float64, {}),
    "chebyshev_lap_jacobi": ("chebyshev", "lap", True, np.float64, {}),
    "bicgstab_cd_jacobi_f32": ("bicgstab", "cd", True, np.float32, {}),
}


def _kwargs(mod, case, A):
    """Solver kwargs of a case on one side: tolerances, JAX's IDR draw,
    and Chebyshev bounds from Gershgorin circles (the lower one clipped to
    1e-3, as clients/samples/power_method.py does: the Laplacian's circles
    reach 0)."""
    solver, _, _, dtype, kw = CASES[case]
    kw = {"rel_tol": 1e-10 if dtype == np.float64 else 1e-5,
          "max_iter": 2000 if solver == "chebyshev" else 500,
          "record_history": True, **kw}
    if solver == "idr" and mod is rt:
        s = kw["shadow_space"]
        kw["shadow_draw"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (A.shape[0], s), jnp.dtype(dtype)))
    if solver == "chebyshev":
        lo, hi = mod.gershgorin(A)
        kw.update(lambda_min=max(float(lo), 1e-3), lambda_max=float(hi))
    return kw


def _solve(mod, case, b, nudge=False):
    solver, op, jacobi, dtype, _ = CASES[case]
    A = GENERATORS[op](mod, dtype)
    M = mod.jacobi(A) if jacobi else None
    kw = _kwargs(mod, case, A)
    if mod is rt:
        bb = b * dtype(1 + NUDGE[dtype]) if nudge else b
        x, info = getattr(rt, solver)(A, torch.from_numpy(bb), M=M, **kw)
        return (x.numpy(), int(info.iterations), int(info.status),
                info.history.numpy())
    x, info = getattr(mod, solver)(A, b, M=M, **kw)
    return (np.asarray(x), int(info.iterations), int(info.status),
            np.asarray(info.history))


@pytest.fixture(scope="module")
def solved():
    out = {}
    for case, (_, op, _, dtype, _) in CASES.items():
        b = _b(GENERATORS[op](rt, dtype).shape[0], dtype)
        out[case] = (_solve(jrt, case, b), _solve(rt, case, b),
                     _solve(rt, case, b, nudge=True))
    return out


def _assert_history_close(hj, ht, hp, rtol):
    """|ht - hj| / |hj| <= max(rtol, DRIFT_FACTOR * drift) entry by entry,
    where drift is the running maximum of |hp - ht| / |ht| (the port's own
    history under a rounding-level change of b; past its end, its last
    value)."""
    n = int((~np.isnan(hj)).sum())
    assert np.isnan(ht[n:]).all() and not np.isnan(ht[:n]).any()
    m = min(n, int((~np.isnan(hp)).sum()))
    drift = np.maximum.accumulate(np.abs(hp[:m] - ht[:m]) / np.abs(ht[:m]))
    drift = np.concatenate([drift, np.full(n - m, drift[-1])])
    err = np.abs(ht[:n] - hj[:n]) / np.abs(hj[:n])
    bound = np.maximum(rtol, DRIFT_FACTOR * drift)
    bad = np.flatnonzero(err > bound)
    assert not len(bad), (f"history entry {bad[0]}: {err[bad[0]]:.3e} > "
                          f"{bound[bad[0]]:.3e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax(solved, case):
    (xj, itj, stj, hj), (xt, itt, stt, ht), (_, _, _, hp) = solved[case]
    dtype = CASES[case][3]
    assert stt == stj
    if dtype == np.float64:
        assert itt == itj
        _assert_history_close(hj, ht, hp, RTOL[dtype])
    else:
        # f32: a rounding difference may move the count
        assert abs(itt - itj) <= 2
        n = min(itj, itt) + 1
        _assert_history_close(hj[:n], ht[:n], hp[:n], RTOL[dtype])
    if stj == 2:                 # converged: the two solutions agree
        scale = np.abs(xj).max()
        np.testing.assert_allclose(xt, xj, rtol=0, atol=(
            1e-8 if dtype == np.float64 else 1e-3) * scale)


def test_expected_stops(solved):
    """Every case converges (status 2) but CR on the nonsymmetric
    operator, which runs to max_iter (status 4)."""
    for case, ((_, it, status, _), _, _) in solved.items():
        want = 4 if case == "cr_cd_jacobi" else 2
        assert status == want, (case, status, it)
    assert solved["cr_cd_jacobi"][0][1] == 120


@pytest.mark.parametrize("check_every", [1, 3, 8])
@pytest.mark.parametrize("case", ["cr_lap", "fcg_cd", "bicgstab_cd_jacobi",
                                  "qmrcgstab_cd", "bicgstabl4_cd_jacobi",
                                  "idr4_cd_jacobi", "chebyshev_lap"])
def test_results_do_not_depend_on_check_every(solved, case, check_every):
    solver, op, jacobi, dtype, _ = CASES[case]
    A = GENERATORS[op](rt, dtype)
    kw = _kwargs(rt, case, A)
    x, info = getattr(rt, solver)(
        A, torch.from_numpy(_b(A.shape[0], dtype)),
        M=rt.jacobi(A) if jacobi else None, check_every=check_every, **kw)
    x0, it0, st0, h0 = solved[case][1]
    assert int(info.iterations) == it0
    assert int(info.status) == st0
    np.testing.assert_array_equal(info.history.numpy(), h0)
    np.testing.assert_array_equal(x.numpy(), x0)


@pytest.mark.parametrize("op", ["lap", "cd"])
def test_gershgorin_and_power_method_match_jax(op):
    Aj, At = GENERATORS[op](jrt, np.float64), GENERATORS[op](rt, np.float64)
    lo_j, hi_j = jrt.gershgorin(Aj)
    lo_t, hi_t = rt.gershgorin(At)
    assert float(lo_t) == float(lo_j) and float(hi_t) == float(hi_j)
    x0 = np.random.default_rng(3).standard_normal(At.shape[0])
    lam_j, v_j = jrt.power_method(Aj, iters=200, x0=jnp.asarray(x0))
    lam_t, v_t = rt.power_method(At, iters=200, x0=torch.from_numpy(x0))
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-12)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                               atol=1e-10)
    # without x0 the port starts from its own host draw, on any device
    lam, v = rt.power_method(At, iters=200)
    assert v.dtype == torch.float64 and abs(float(lam) - float(lam_j)) \
        < 1e-2 * float(lam_j)


def test_port_draws_are_its_own_and_seeded():
    """Without shadow_draw, IDR draws its shadow space from
    torch.Generator().manual_seed(seed) on the host: the same seed gives
    the same solve, another seed another one, and both converge."""
    A = rt.convection_diffusion_2d(16)
    b = torch.from_numpy(_b(A.shape[0], np.float64))
    runs = [rt.idr(A, b, rel_tol=1e-10, record_history=True, seed=s)[1]
            for s in (0, 0, 1)]
    assert all(int(r.status) == 2 for r in runs)
    h = [r.history.numpy() for r in runs]
    np.testing.assert_array_equal(h[0], h[1])
    assert not np.array_equal(h[0], h[2], equal_nan=True)


@pytest.fixture(scope="module")
def bf16_operands():
    """A JAX and a port f32 CSR of laplacian_2d(24) with a bfloat16 roll
    plan (no DIA part), and random_banded_spd(4000, bandwidth=300) in f64
    with an f32 copy carrying a bfloat16 gather plan (tests/test_wjd.py's
    bf16 operator). One tile per grid step in both planners: the JAX side
    runs its interpreted Pallas kernel inside the solves."""
    mp = pytest.MonkeyPatch()
    for mod in (jax_wjd, torch_wjd):
        mp.setattr(mod, "_auto_group", lambda K: 1)
    out = {}
    try:
        lap = jrt.laplacian_2d(24, dtype=np.float32)
        d, i, p = lap.numpy_triplet()
        out["lap"] = (
            jax_attach_wjd(jrt.CSR.from_arrays(d, i, p, lap.shape),
                           values_dtype="bfloat16", split_dia=False,
                           cache=False),
            rt.attach_wjd(rt.CSR.from_arrays(d, i, p, lap.shape),
                          values_dtype="bfloat16", split_dia=False))
        rb = jrt.random_banded_spd(4000, bandwidth=300)
        d, i, p = rb.numpy_triplet()
        out["rb64"] = (rb, rt.CSR.from_arrays(d, i, p, rb.shape))
        out["rb32"] = (
            jax_attach_wjd(jrt.CSR.from_arrays(d.astype(np.float32), i, p,
                                               rb.shape),
                           values_dtype="bfloat16", cache=False),
            rt.attach_wjd(rt.CSR.from_arrays(d.astype(np.float32), i, p,
                                             rb.shape),
                          values_dtype="bfloat16"))
    finally:
        mp.undo()
    return out


def test_f32_cg_over_a_bf16_plan_matches_jax(bf16_operands):
    Aj, At = bf16_operands["lap"]
    assert At._wjd_cache.dtype == torch.bfloat16
    assert At._wjd_cache.kernel_mode == "roll"
    b = _b(At.shape[0], np.float32)
    xj, ij = jrt.cg(Aj, b, M=jrt.jacobi(Aj), rel_tol=1e-5, max_iter=500,
                    record_history=True)
    xt, it = rt.cg(At, torch.from_numpy(b), M=rt.jacobi(At), rel_tol=1e-5,
                   max_iter=500, record_history=True)
    assert xt.dtype == torch.float32
    assert int(it.status) == int(ij.status) == 2
    # the same bfloat16 operator; f32 sums in another order may move the
    # count by one
    assert abs(int(it.iterations) - int(ij.iterations)) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(xj)).max())


def test_mpdc_with_a_bf16_inner_operator_matches_jax(bf16_operands):
    """chip_smoke.py's phase N3 at a small size: the outer defect
    correction in f64 through the f64 operator, the inner CG in f32 over
    the bfloat16 copy. Outer iterations and status equal; the first outer
    residual equal to 1e-12; each later one is what an inner f32 CG to
    rel_tol 1e-3 leaves, which rounding moves (as in
    tests/test_torch_gmres.py: the second within 1e-3, all within 0.3 in
    log10); the solutions within 1e-10."""
    (Aj, At), (Aj32, At32) = bf16_operands["rb64"], bf16_operands["rb32"]
    assert At32._wjd_cache.dtype == torch.bfloat16
    assert At32._wjd_cache.kernel_mode == "gather"
    b = _b(At.shape[0], np.float64)
    xj, ij = jrt.mixed_precision_dc(
        Aj, b, rel_tol=1e-10,
        inner_solver=lambda _, r, **kw: jrt.cg(Aj32, r, **kw))
    xt, it = rt.mixed_precision_dc(
        At, torch.from_numpy(b), rel_tol=1e-10,
        inner_solver=lambda _, r, **kw: rt.cg(At32, r, **kw))
    assert int(it.status) == int(ij.status) == 2
    assert int(it.iterations) == int(ij.iterations)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    np.testing.assert_allclose(ht[0], hj[0], rtol=1e-12)
    np.testing.assert_allclose(ht[1], hj[1], rtol=1e-3)
    np.testing.assert_allclose(np.log10(ht), np.log10(hj), atol=0.3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())
