"""Port parity: GMRES(m), FGMRES and MixedPrecisionDC.

The port's GMRES keeps the reference's arithmetic (restarted Arnoldi,
CGS2, Givens rotations, the update of a cycle applied at a stop), with the
rotations of a cycle held as one small matrix. On the same operator, rhs
and x0 it gives the JAX package's status and iteration count, with
residual histories within rtol 1e-10 in f64 and solutions within 1e-9;
in f32, the same status and iterations within 2. Its results do not
depend on `check_every` (bit for bit on the CPU). MixedPrecisionDC gives
the JAX package's outer iterations and status; its outer history is
ruled by the inner f32 solves' rounding after the first entry (stated
tolerances in the test). The JAX side runs with
its CPU default (auto_wjd off) and is solved once per case
(module-scoped fixtures).

Run as a script, the file solves bench.py's four factorization and
mixed-precision rows at their own sizes on the CPU with both packages (or
with one of them) and prints the status and iterations of each:

    PYTHONPATH=. python tests/test_torch_gmres.py
        [cg_ic0 gmres_ilu0 fem_ilu0 mpdc] [--side jax|torch|both]
        [--dtype=float64] [--perturb=1e-7]

`--dtype` solves the f32 rows in another dtype; `--perturb` scales the
rhs by 1 + perturb in f64, before the cast to the row's dtype, which
shows how far rounding alone moves a row's count.
"""

import numpy as np
import pytest
import torch

import rocalution_tpu_torch as rt
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port builds on the card by default; these tests ask for the CPU
    (module scope: the module-scoped fixtures below build on it too)."""
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture(scope="module")
def jrt():
    import rocalution_tpu

    return rocalution_tpu


def _b(n, dtype=np.float64, seed=4):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _pair(jrt, make, solver, precond=None, **kw):
    """The same solve on both sides: make(module) -> A, precond(module, A)
    -> M or None; returns ((x, info) JAX, (x, info) port)."""
    from rocalution_tpu import precond as jp

    Aj, At = make(jrt), make(rt)
    b = _b(At.shape[0], At.numpy_triplet()[0].dtype)
    Mj = None if precond is None else precond(jp, Aj)
    Mt = None if precond is None else precond(rt, At)
    xj, ij = getattr(jrt, solver)(Aj, b, M=Mj, record_history=True, **kw)
    xt, it = getattr(rt, solver)(At, torch.from_numpy(b), M=Mt,
                                 record_history=True, **kw)
    return (np.asarray(xj), ij), (xt.numpy(), it)


CASES = {
    # bench.py's gmres_ilu0 recipe at 24x24
    "gmres_ilu0_jacobi": dict(
        make=lambda m: m.convection_diffusion_2d(24), solver="gmres",
        precond=lambda m, A: m.ilu(A, 0, method="jacobi", sweeps=8),
        kw=dict(basis_size=30, rel_tol=1e-8, max_iter=600)),
    # many restarts of a short basis, no preconditioner
    "gmres_m5_restarts": dict(
        make=lambda m: m.convection_diffusion_2d(16), solver="gmres",
        precond=None, kw=dict(basis_size=5, rel_tol=1e-8, max_iter=400)),
    # a stop by max_iter in the middle of the second cycle
    "gmres_maxiter_mid_cycle": dict(
        make=lambda m: m.convection_diffusion_2d(16), solver="gmres",
        precond=None, kw=dict(basis_size=5, rel_tol=1e-12, max_iter=7)),
    "fgmres_ilu_levels": dict(
        make=lambda m: m.convection_diffusion_2d(20), solver="fgmres",
        precond=lambda m, A: m.ilu(A, 0, method="levels"),
        kw=dict(basis_size=10, rel_tol=1e-9, max_iter=300)),
}


@pytest.fixture(scope="module")
def solved(jrt):
    return {name: _pair(jrt, c["make"], c["solver"], c["precond"],
                        **c["kw"]) for name, c in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gmres_matches_jax(solved, name):
    (xj, ij), (xt, it) = solved[name]
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    assert np.array_equal(np.isnan(hj), np.isnan(ht))
    keep = ~np.isnan(hj)
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-10,
                               atol=1e-14 * hj[0])
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-10)


def test_gmres_stops_where_the_reference_does(solved):
    """Converged rows stop on the relative criterion; the max_iter row
    stops after 7 inner steps (one cycle of 5 and 2 steps of the next)
    with that cycle's update applied, as the reference's outer_body does."""
    for name in ("gmres_ilu0_jacobi", "gmres_m5_restarts",
                 "fgmres_ilu_levels"):
        (_, ij), (_, it) = solved[name]
        assert int(it.status) == 2 and int(it.iterations) > 5, name
    (xj, ij), (xt, it) = solved["gmres_maxiter_mid_cycle"]
    assert int(it.status) == 4 and int(it.iterations) == 7
    A = rt.convection_diffusion_2d(16)
    b = _b(A.shape[0])
    r = b - rt.spmv(A, torch.from_numpy(xt)).numpy()
    # the second cycle's update moved x: the residual is the last history
    # entry, not the one at the restart
    np.testing.assert_allclose(np.linalg.norm(r), float(it.final_res),
                               rtol=1e-8)
    assert float(it.final_res) < float(it.history[5])


def test_preconditioned_gmres_beats_plain(solved):
    A = rt.convection_diffusion_2d(24)
    _, info = rt.gmres(A, torch.from_numpy(_b(A.shape[0])), rel_tol=1e-8,
                       max_iter=600)
    assert int(solved["gmres_ilu0_jacobi"][1][1].iterations) < \
        int(info.iterations)


@pytest.mark.parametrize("solver", ["gmres", "fgmres"])
def test_results_do_not_depend_on_check_every(solver):
    A = rt.convection_diffusion_2d(16)
    b = torch.from_numpy(_b(A.shape[0]))
    M = rt.ilu(A, 0, method="jacobi", sweeps=2)
    runs = [getattr(rt, solver)(A, b, M=M, basis_size=6, rel_tol=1e-9,
                                max_iter=300, record_history=True,
                                check_every=k) for k in (1, 4, 32)]
    (x0, i0) = runs[0]
    for x, info in runs[1:]:
        assert int(info.iterations) == int(i0.iterations)
        assert int(info.status) == int(i0.status) == 2
        assert torch.equal(x, x0)
        torch.testing.assert_close(info.history, i0.history, rtol=0, atol=0,
                                   equal_nan=True)


def test_gmres_f32_converges_like_jax(jrt):
    """bench.py's gmres_ilu0 row at 24x24 in f32 (attach_wjd on both
    sides does not change the arithmetic of the port's plain apply)."""
    case = dict(CASES["gmres_ilu0_jacobi"])
    (xj, ij), (xt, it) = _pair(
        jrt, lambda m: m.convection_diffusion_2d(24, dtype=np.float32),
        case["solver"], case["precond"], **dict(case["kw"], rel_tol=1e-6))
    assert int(it.status) == int(ij.status) == 2
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-3)


def test_gmres_rejects_bad_check_every():
    A = rt.laplacian_2d(4)
    with pytest.raises(ValueError):
        rt.gmres(A, torch.ones(16, dtype=torch.float64), check_every=0)


# ---------------------------------------------------------------------------
# MixedPrecisionDC
# ---------------------------------------------------------------------------

MPDC_KW = dict(rel_tol=1e-10, max_iter=20,
               inner_kwargs={"rel_tol": 1e-4, "max_iter": 2000})


@pytest.fixture(scope="module")
def mpdc(jrt):
    """bench.py's mpdc recipe at 24x24: laplacian_2d f64, rhs from
    default_rng(5), rel_tol 1e-10, inner CG f32 rel_tol 1e-4."""
    Aj, At = jrt.laplacian_2d(24), rt.laplacian_2d(24)
    b = _b(At.shape[0], seed=5)
    xj, ij = jrt.mixed_precision_dc(Aj, b, **MPDC_KW)
    xt, it = rt.mixed_precision_dc(At, torch.from_numpy(b), **MPDC_KW)
    return At, b, (np.asarray(xj), ij), (xt, it)


def test_mpdc_matches_jax(mpdc):
    _, _, (xj, ij), (xt, it) = mpdc
    assert int(it.iterations) == int(ij.iterations) == 3
    assert int(it.status) == int(ij.status) == 2
    ht, hj = it.history.numpy(), np.asarray(ij.history)
    np.testing.assert_allclose(ht[0], hj[0], rtol=1e-12)
    # each later entry is what an inner f32 solve to rtol 1e-4 leaves, so
    # f32 rounding (1e-7) over a drop of 1e-4 rules it: within 1e-3 after
    # the first solve, and within a factor of 2 after the last, 1e-12
    # below the first entry
    np.testing.assert_allclose(ht[1], hj[1], rtol=1e-3)
    np.testing.assert_allclose(np.log10(ht), np.log10(hj), atol=0.3)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-8, atol=1e-12)


def test_mpdc_reaches_f64_accuracy(mpdc):
    A, b, _, (xt, it) = mpdc
    r = b - rt.spmv(A, xt).numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10
    assert xt.dtype == torch.float64


def test_mpdc_inner_operator_keeps_its_host_cache(mpdc):
    """bench.py's mpdc_inner_fast: the f32 copy keeps its host arrays, so
    its WJD plan attaches without a device read; the build is cached on
    the operator and a second solve reuses it."""
    A, b, _, _ = mpdc
    key, _, A_low = A._mpdc_cache
    assert A_low._host_cache["data"].dtype == np.float32
    x2, info2 = rt.mixed_precision_dc(A, torch.from_numpy(b), **MPDC_KW)
    assert A._mpdc_cache[2] is A_low
    assert int(info2.iterations) == 3


@pytest.mark.parametrize("fmt", ["ELL", "HYB", "BCSR"])
def test_mpdc_plans_its_cast_operator_where_wjd_applies(fmt):
    """With auto_wjd on (the card's default), the f32 copy of an ELL, HYB or
    BCSR operator, which has no host arrays, is read back once and planned,
    and the solve converges as on the CSR."""
    A = rt.convert(rt.laplacian_2d(16), fmt)
    b = torch.from_numpy(_b(256, seed=5))
    rt.set_auto_wjd(True)
    try:
        x, info = rt.mixed_precision_dc(A, b, **MPDC_KW)
    finally:
        rt.set_auto_wjd(None)
    A_low = A._mpdc_cache[2]
    assert A_low.dtype == torch.float32
    assert A_low._wjd_cache.dtype == torch.float32
    assert int(info.status) == 2 and int(info.iterations) <= 4


def test_mpdc_with_gmres_inner_solver():
    A = rt.convection_diffusion_2d(16)
    b = torch.from_numpy(_b(256))
    x, info = rt.mixed_precision_dc(A, b, inner_solver=rt.gmres, **MPDC_KW)
    assert int(info.status) == 2
    r = b - rt.spmv(A, x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-10


# ---------------------------------------------------------------------------
# bench.py's rows at their own sizes, on the CPU (run as a script)
# ---------------------------------------------------------------------------

def _bench_rows(pkg, is_jax, dtype=None, perturb=0.0):
    """bench.py's cg_ic0, gmres_ilu0, fem_ilu0 and mpdc recipes (the
    sections at bench.py:248-348 and :687-717) through `pkg`, with its
    plans off (the CPU default). `dtype` replaces the rows' f32 (mpdc stays
    f64); `perturb` scales every rhs by 1 + perturb. Returns {row: a
    function that solves it and returns its SolverInfo}."""
    from importlib import import_module

    precond = import_module(pkg.__name__ + ".precond")
    f32 = np.dtype(dtype or np.float32)

    def arr(v, dt):
        """The rhs v, scaled by 1 + perturb in f64, in dtype dt."""
        v = (np.asarray(v, np.float64) * (1 + perturb)).astype(dt)
        return v if is_jax else torch.from_numpy(np.ascontiguousarray(v))

    def cg_ic0():
        A2 = pkg.laplacian_2d(256, dtype=f32)
        d, _, p = A2.numpy_triplet()
        rows = A2.numpy_rows()
        b = np.bincount(rows, weights=d, minlength=A2.shape[0])
        M = precond.ic(A2, method="jacobi", sweeps=8)
        return pkg.cg(pkg.convert(A2, "DIA"), arr(b, f32), M=M,
                      rel_tol=1e-8, max_iter=1000)[1]

    def gmres_ilu0():
        Acd = pkg.convection_diffusion_2d(192, dtype=f32)
        b = np.random.default_rng(4).standard_normal(Acd.shape[0])
        M = precond.ilu(Acd, 0, method="jacobi", sweeps=8)
        return pkg.gmres(Acd, arr(b, f32), M=M, basis_size=30,
                         rel_tol=1e-8, max_iter=600)[1]

    def fem_ilu0():
        Af = pkg.fem_2d_unstructured(120_000, dtype=f32, parabolic=True)
        ones = np.ones(Af.shape[0], f32)
        b = np.asarray(pkg.spmv(Af, ones if is_jax
                                else torch.from_numpy(ones)))
        M = precond.ilu(Af, 0, method="levels")
        return pkg.cg(Af, arr(b, f32), M=M, rel_tol=1e-4, max_iter=200)[1]

    def mpdc():
        A = pkg.laplacian_2d(128, dtype=np.float64)
        b = np.random.default_rng(5).standard_normal(A.shape[0])
        return pkg.mixed_precision_dc(
            A, arr(b, np.float64), rel_tol=1e-10, max_iter=20,
            inner_kwargs={"rel_tol": 1e-4, "max_iter": 2000})[1]

    return {f.__name__: f for f in (cg_ic0, gmres_ilu0, fem_ilu0, mpdc)}


def main(argv=None):
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*",
                    default=["cg_ic0", "gmres_ilu0", "fem_ilu0", "mpdc"])
    ap.add_argument("--side", choices=("jax", "torch", "both"),
                    default="both")
    ap.add_argument("--dtype", default=None,
                    help="in place of the rows' f32, e.g. float64")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="scale every rhs by 1 + this")
    args = ap.parse_args(argv)
    sides = ("jax", "torch") if args.side == "both" else (args.side,)
    rt.set_default_device("cpu")
    for side in sides:
        if side == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            import rocalution_tpu as pkg
        else:
            pkg = rt
        rows = _bench_rows(pkg, side == "jax", args.dtype, args.perturb)
        for name in args.rows:
            t0 = time.perf_counter()
            info = rows[name]()
            print(f"{side} {pkg.__name__} {name} dtype "
                  f"{args.dtype or 'bench'} perturb {args.perturb:g}: status "
                  f"{int(info.status)}, {int(info.iterations)} iterations, "
                  f"final residual {float(info.final_res):.3e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
