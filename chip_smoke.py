"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Builds the WJD kernels (rocalution_tpu_torch/csrc/*.cu) from the checkout
and holds each against its plain PyTorch version on the card at full size,
then drives the main paths through the public entry points and checks that
each went through its kernels:

  A-B  the card, the toolchain, the build (one nvcc per source, together)
  C    the four direct single-RHS kernels at 1M rows (gather mode on the
       compact slice form, with its padding and the seconds it took)
  D-F  CG + Jacobi at 1M rows (f64 and f32, roll and gather plans)
  G    profile of the 1M-row f64 CG loop (host clock against
       torch.profiler's device time) and the host cost of one apply
  H    blocked right-hand sides: rt.spmv(A, X), X of 16 and 20 columns
  I    operators in the windowed regime (2.1M rows f64, 5.8M and 4.2M rows
       f32): the windowed kernels, then CG + Jacobi through them
  J    ELL, HYB and BCSR operands routed through a WJD plan; COO, MCSR and
       DENSE plain applies
  K    CG + SA-AMG: the bench's 65k row (f64 host setup, f32 hierarchy,
       6 iterations); laplacian_3d(128) f64, 2,097,152 rows (5 levels):
       setup, how each level operator and transfer is served, the solve
       through the WJD kernels and the same solve plain, each transfer's
       kernel held against its plain version, a profile of one V-cycle
       (device, and the host's time by function) and one CG iteration;
       then its f32 conversion and the same again, with a third path
       planned by the JAX package's f32 DIA split
  L    IC(0) and ILU(0) with CG and GMRES(30): bench.py's cg_ic0,
       gmres_ilu0 (in f32, and in f64) and fem_ilu0 rows at their own
       sizes, then CG + IC(0) and GMRES(30) + ILU(0) at a million rows in
       f64; the kernel apply of each row's operator and factors held
       against its plain versions, then each solve through the kernels
       and plain, held to its status and error bound, timed in turns
  M    MixedPrecisionDC: bench.py's mpdc row (3 outer iterations), then
       laplacian_3d(100) f64: the outer residual through the f64 kernel,
       the inner CG through the f32 copy's
  N    bfloat16 values and the rest of the Krylov family. N1: the six bf16
       kernels on bf16 plans of the f32 operators of C, H and I (direct,
       blocked right-hand sides, windowed), each against its plain
       version, against the f32 plan's product, its bound and the library
       call, through rt.spmv. N2: BiCGStab, BiCGStab(2), QMRCGStab, IDR(4)
       on convection_diffusion_2d(1024) f64 and CR, FCG, the power method
       and Chebyshev on laplacian_3d(100) f64, through the kernels and
       plain, their launches held to their iterations. N3: MixedPrecisionDC
       on random_banded_spd(1<<20) f64 with an inner CG over a bf16 plan,
       beside the same solve over the f32 plan

The gather-mode kernels of C, H and I read the plan's row-compacted slice
form (window-relative in I, where the kernel reads x through each step's
window); they are held against the plain version over that form and against
the padded slot product over the plan's planes.

Each kernel row carries its time, the plain version's, `bound_ms` (the least
time the card could take for the product, whatever layout serves it: the
operator's values, x and y once, or its flops), `own_bytes_ms` (the bytes of
the layout the kernel streams, over the same rate) and the time of the one
PyTorch call that computes the same product (`library_ms`:
torch.sparse_csr_tensor @ x, which the port never calls). Each phase prints
one line; any failure raises, so the exit code
is non-zero. Without a CUDA device it fails at once. The last three lines
are the card as nvidia-smi reports it, the per-kernel JSON, and the result
JSON.
"""

import contextlib
import dataclasses
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LAP_N = 100                 # laplacian_3d(100): 1,000,000 rows
RAND_N = 1 << 20            # random_banded_spd(1<<20): 1,048,576 rows
J_RAND_N = 1 << 18          # phase J's HYB and BCSR operands: 262,144 rows
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# phase N1: a bf16 kernel against its plain version (the same f32 products,
# summed in another order), and its product against the f32 plan's (the
# bf16 rounding of the values), both norm-wise
BF16_TOL = 1e-5
BF16_VS_F32_TOL = 1e-2
N_COLS = 16                 # phase N1: columns of the blocked products
N2_CD_N = 1024              # phase N2: convection_diffusion_2d(1024) f64
N2_LAP_N = 100              # and laplacian_3d(100) f64
N2_MAX_ITER = 1000          # the samples' settings (Chebyshev: 2000)
N2_POWER_ITERS = 200
REPS = 20
SPIN_CYCLES = 20_000_000    # ~10 ms at ~2 GHz: outlasts one call's launches
PROF_WALL_ITERS = 256       # phase G: CG iterations timed on the host clock
PROF_ITERS = 64             # phase G: CG iterations under torch.profiler
WIN_LAP64_N = 128           # laplacian_3d(128) f64: 2,097,152 rows
WIN_LAP32_N = 180           # laplacian_3d(180) f32: 5,832,000 rows
WIN_RAND_N = 1 << 22        # random_banded_spd(1<<22) f32: 4,194,304 rows
MRHS_COLS = (16, 20)        # phase H: one full chunk, and one that crosses
HOST_CALLS = 200            # phase G: applies timed on the host clock
AMG_65K_N = 256             # phase K: laplacian_2d(256), 65,536 rows
AMG_3D_N = 128              # phase K: laplacian_3d(128), 2,097,152 rows
AMG_3D_LEVELS = 5           # BENCH_r05.json amg_setup_2m_levels
AMG_CHECK_EVERY = 4         # phase K: CG steps between host reads of the
                            # stop flag; each masked step costs a V-cycle
AMG_PROF_CYCLES = (20, 5)   # phase K: V-cycles timed unprofiled, profiled
AMG_PROF_ITERS = (8, 4)     # phase K: CG iterations timed the same ways
HOST_TOP = 8                # host_profile: rows shown of each table
L1_IC_N = 256               # phase L1: bench.py's rows at their own sizes:
L1_CD_N = 192               # laplacian_2d(256), convection_diffusion_2d(192)
L1_FEM_N = 120_000          # and fem_2d_unstructured(120_000) f32
L2_LAP_N = 100              # phase L2: laplacian_3d(100) f64, 1,000,000 rows
L2_CD_N = 1024              # convection_diffusion_2d(1024) f64, 1,048,576
L2_CD_STATUS = 4            # its GMRES(30) stops at 600 steps short of 1e-6
M1_N = 128                  # phase M1: bench.py's mpdc row, laplacian_2d(128)
M2_N = 100                  # phase M2: laplacian_3d(100) f64
FACTOR_CHECK_EVERY = 8      # phases L, M: solver steps between host reads
FACTOR_PROF = (8, 4)        # phases L, M: iterations timed, profiled (a
                            # solver call of k iterations also applies the
                            # preconditioner once at its start: the numbers
                            # a step read (k+1)/k of an iteration's)
APPLY_REPS = 5              # phase L: preconditioner applies timed
# phase L1: the iterations both packages take on the CPU (`python
# tests/test_torch_gmres.py`, also with --dtype=float64 and with
# --perturb=1e-7 and -1e-7, which move neither): cg_ic0 179, gmres_ilu0 in
# f64 205. The f32 gmres_ilu0 and fem_ilu0 rows have no such count: on the
# CPU a 1e-7 scaling of b moves them by tens of iterations in both packages
L1_WANT = {"cg_ic0": 179, "gmres_ilu0_f64": 205}
# phase L: a row whose b is not A 1 holds its true relative residual to
# (factor x the residual its solver reported, or the dtype's floor, if
# larger): a solve that converged on another operator than A fails it
RES_BOUND = (10.0, {torch.float32: 1e-5, torch.float64: 1e-10})
# torch.profiler CPU rows that wait for the device
SYNC_ROWS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
             "cudaDeviceSynchronize", "cudaMemcpy", "cudaEventSynchronize")
# published peaks of one H100 SXM: HBM bytes/s, and flop/s outside the
# tensor cores by value type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
CSRC = "rocalution_tpu_torch/csrc/"
TPU = "rocalution_tpu/ops/pallas/spmv_wjd.py:"
# launch counter -> (entry point, source, line of the TPU kernel it replaces:
# _kernel_roll_ff, _kernel_ff, _kernel_roll, _kernel; _kernel_mrhs;
# _kernel_roll_ff_hbm, _kernel_roll_hbm, _kernel_hbm). The bf16 entry points
# replace the same kernels run on bfloat16 values.
KERNELS = {
    "roll_f64": ("wjd_spmv_roll_f64", "spmv_wjd.cu", 206),
    "gather_f64": ("wjd_spmv_gather_f64", "spmv_wjd.cu", 480),
    "roll_f32": ("wjd_spmv_roll_f32", "spmv_wjd.cu", 183),
    "gather_f32": ("wjd_spmv_gather_f32", "spmv_wjd.cu", 137),
    "spmm_roll_f64": ("wjd_spmm_roll_f64", "spmm_wjd.cu", 448),
    "spmm_gather_f64": ("wjd_spmm_gather_f64", "spmm_wjd.cu", 448),
    "spmm_roll_f32": ("wjd_spmm_roll_f32", "spmm_wjd.cu", 448),
    "spmm_gather_f32": ("wjd_spmm_gather_f32", "spmm_wjd.cu", 448),
    "win_roll_f64": ("wjd_spmv_win_roll_f64", "spmv_wjd_win.cu", 375),
    "win_roll_f32": ("wjd_spmv_win_roll_f32", "spmv_wjd_win.cu", 233),
    "win_gather_f32": ("wjd_spmv_win_gather_f32", "spmv_wjd_win.cu", 310),
    "roll_bf16": ("wjd_spmv_roll_bf16", "spmv_wjd.cu", 183),
    "gather_bf16": ("wjd_spmv_gather_bf16", "spmv_wjd.cu", 137),
    "spmm_roll_bf16": ("wjd_spmm_roll_bf16", "spmm_wjd.cu", 448),
    "spmm_gather_bf16": ("wjd_spmm_gather_bf16", "spmm_wjd.cu", 448),
    "win_roll_bf16": ("wjd_spmv_win_roll_bf16", "spmv_wjd_win.cu", 233),
    "win_gather_bf16": ("wjd_spmv_win_gather_bf16", "spmv_wjd_win.cu", 310),
}
TAG = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def run(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])


def median_ms(fn):
    """Median of REPS CUDA-event timings of fn() in device time, after one
    warm-up. Each rep first queues a spin of the device, so the host has
    queued all of fn() before the device reaches it: the events then time
    the device's work, not the Python wrapper's launch latency."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rhs_of_ones(A):
    """b = A @ 1 from the host triplet (no device SpMV involved)."""
    d, _, p = A.numpy_triplet()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(p))
    b = np.bincount(rows, weights=d, minlength=A.shape[0]).astype(d.dtype)
    return torch.from_numpy(b).to(A.device)


class Counted:
    """The launches of one main path: every count is set to 0 on entry and
    added to the run's totals on exit."""

    def __init__(self, kernels, totals):
        self.kernels, self.totals, self.got = kernels, totals, {}

    def __enter__(self):
        for key in self.kernels.launches:
            self.kernels.launches[key] = 0
        return self

    def __exit__(self, *exc):
        self.got = dict(self.kernels.launches)
        for key, n in self.got.items():
            self.totals[key] = self.totals.get(key, 0) + n


def rel_err(got, want, tag, tol):
    """max|got - want| and the same over max|want|; raises beyond tol."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{tag}: output is not finite")
    max_abs = float((got - want).abs().max())
    rel = max_abs / float(want.abs().max())
    if rel > tol:
        raise RuntimeError(f"{tag}: disagrees with its reference: "
                           f"{rel:.3e} > {tol}")
    return max_abs, rel


def bounds(W, kernels, cols=1, compact=False, through_windows=False):
    """{"bound_ms", "bound_by", "own_bytes_ms"} of one slot product on
    `cols` columns. The bound is the product's, whatever layout serves it:
    the values of the nonzeros the slots hold, x and y, each once, over the
    HBM rate, or 2 flops per nonzero and column over the peak rate,
    whichever is larger (indices are a layout's choice and are left out).
    Values count in their own type (2 bytes in bf16), x and y in theirs
    (f32 for bf16 values, whose products are f32 flops).
    own_bytes_ms: the bytes of the layout the kernel streams (the slot
    planes with brow and diag_u, or the compact slice form; padded x; y),
    over the HBM rate."""
    vsz, xsz = W.dtype.itemsize, W.x_dtype.itemsize
    n, m = W.shape
    nnz = W.nnz - W.spill_row.numel()
    t_bytes = (nnz * vsz + (n + m) * cols * xsz) / PEAK_BYTES * 1e3
    t_ops = 2 * nnz * cols / PEAK_FLOPS[W.x_dtype] * 1e3
    own = (kernels.slot_bytes(W, compact, through_windows)
           + (W.xp_len + W.brow.shape[0] * 1024) * xsz * cols)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "own_bytes_ms": own / PEAK_BYTES * 1e3}


def bounds_text(b):
    return (f"bound {b['bound_ms'] * 1e3:.1f} us ({b['bound_by']} of the "
            f"product), own bytes {b['own_bytes_ms'] * 1e3:.1f} us")


def with_planes(rt, A, attach_kw, ordered=True):
    """A gather-mode plan on the card is served from its compact form and
    carries no slot planes. Plan A once more on the host and return the
    attached plan with the padded planes beside its compact form, so that
    the padded slot product can be computed on the card; with `ordered`,
    the same plan with the rows of each tile ordered by length before
    compacting (else None), for timing only (its offsets belong to the
    rows' old places, so its product is not A's): what the padding that is
    left costs; the seconds the plan took and the seconds compacting
    took."""
    from rocalution_tpu_torch.formats.wjd import (compact_slices,
                                                  csr_to_wjd_plan)

    def on_card(fields):
        return {k: torch.from_numpy(v).cuda() if isinstance(v, np.ndarray)
                else v for k, v in fields.items()}

    t0 = time.perf_counter()
    plan = csr_to_wjd_plan(*A.numpy_triplet(), A.shape, **attach_kw)
    t1 = time.perf_counter()
    compact_slices(plan)
    t2 = time.perf_counter()
    W = A._wjd_cache
    W_pad = dataclasses.replace(W, **on_card(
        {"data": plan["data"], "uloc": plan["uloc"]}))
    if not ordered:
        return W_pad, None, t1 - t0, t2 - t1
    Tp, K = plan["brow"].shape
    data = plan["data"].reshape(Tp, K, 1024)
    order = np.argsort(-(data != 0).sum(axis=1), axis=1,
                       kind="stable")[:, None, :]
    W_ordered = dataclasses.replace(W, **on_card(compact_slices(dict(
        plan, data=np.take_along_axis(data, order, 2),
        uloc=np.take_along_axis(plan["uloc"].reshape(Tp, K, 1024), order,
                                2)))))
    return W_pad, W_ordered, t1 - t0, t2 - t1


def library_ms(A, x):
    """Time of the one PyTorch call for the same product: a sparse CSR
    tensor (cuSPARSE) times x. Used for comparison only."""
    S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    return median_ms(lambda: S @ x)


def random_x(rt, A, dtype, cols=None):
    shape = (A.shape[1],) if cols is None else (A.shape[1], cols)
    x = np.random.default_rng(1234).standard_normal(shape)
    return torch.from_numpy(x.astype(rt.config.numpy_dtype(dtype))).cuda()


def plan_line(A, W):
    Tp, K = W.brow.shape
    return (f"n={A.shape[0]} nnz={A.nnz} plan {W.kernel_mode} (Tp,K)=({Tp},"
            f"{K}) wlog={W.wlog} group={W.group} padding "
            f"{W.padding_ratio:.2f}x spill={W.spill_row.numel()} "
            f"dia={len(W.dia_offsets)} win_rows={W.win_rows}")


def phase_a():
    say("A", f"card (nvidia-smi name, power.limit): {card_line()}")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = f"{CUDA_HOME}/bin/nvcc"
    nvcc_ver = run([nvcc, "--version"]).splitlines()[-1]
    has_triton = importlib.util.find_spec("triton") is not None
    say("A", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | nvcc: {nvcc_ver} | "
        f"triton importable: {has_triton}")


def phase_b(kernels):
    t0 = time.perf_counter()
    kernels.build()
    sources = sorted({src for _, src, _ in KERNELS.values()})
    say("B", f"built {CSRC}{' '.join(sources)} for sm_90a, one nvcc each, "
        f"in {time.perf_counter() - t0:.1f} s")


def phase_c(rt, kernels, ops):
    """Direct kernel against plain version on the card, per entry point.
    Roll mode: the slot product over the planes. Gather mode: the product
    over the compact slice form, against its plain version and against the
    padded slot product. Returns the rows and, per gather key, what
    `with_planes` built on the card (phase H uses it again)."""
    results, padded = {}, {}
    for key, (A, attach_kw) in ops.items():
        t0 = time.perf_counter()
        rt.attach_wjd(A, **attach_kw)
        W = A._wjd_cache
        attach_s = time.perf_counter() - t0
        if not key.startswith(W.kernel_mode):
            raise RuntimeError(f"{key}: plan chose {W.kernel_mode} mode")
        gather = W.kernel_mode == "gather"
        if gather and W.data is not None:
            raise RuntimeError(f"{key}: the plan keeps its slot planes on "
                               "the card")
        tol = TOL[W.dtype]
        x = random_x(rt, A, W.dtype)
        xp = kernels.pad_x(W, x)
        plain = kernels.slots_plain_compact if gather else kernels.slots_plain
        y = kernels.slots_kernel(W, xp)
        max_abs, rel = rel_err(y, plain(W, xp), key, tol)
        rel_err(kernels.wjd_spmv(W, x), kernels.wjd_reference(W, x),
                f"{key} full op", tol)
        extra = ""
        if gather:
            W_pad, W_ordered, plan_s, compact_s = with_planes(rt, A,
                                                              attach_kw)
            _, rel_p = rel_err(y, kernels.slots_plain(W_pad, xp),
                               f"{key} vs padded slot product", tol)
            rel_err(kernels.wjd_spmv(W, x), kernels.wjd_reference(W_pad, x),
                    f"{key} full op vs padded", tol)
            padded[key] = (W_pad, W_ordered)
            o_ms = median_ms(lambda: kernels.slots_kernel(W_ordered, xp))
            extra = (f" ({plan_s:.1f} s planning, {compact_s:.1f} s "
                     f"compacting when done again) | compact form "
                     f"{W.cval.numel()} elements, padding "
                     f"{W.compact_padding_ratio:.3f}x, "
                     f"{W.coff.element_size()}-byte offsets | vs padded slot "
                     f"product {rel_p:.3e} | timing only, rows of a tile "
                     f"ordered by length: padding "
                     f"{W_ordered.compact_padding_ratio:.3f}x, kernel "
                     f"{o_ms * 1e3:.1f} us")
        del y
        k_ms = median_ms(lambda: kernels.slots_kernel(W, xp))
        p_ms = median_ms(lambda: plain(W, xp))
        op_ms = median_ms(lambda: kernels.wjd_spmv(W, x))
        ref_ms = median_ms(lambda: kernels.wjd_reference(W, x))
        lib_ms = library_ms(A, x)
        b = bounds(W, kernels, compact=gather)
        ref_gbs = (W.dtype.itemsize + 4) * A.nnz / (op_ms * 1e-3) / 1e9
        say("C", f"{key}: {plan_line(A, W)} attach {attach_s:.1f} s{extra} | "
            f"max|dy|/max|y|={rel:.3e} (tol {tol:g}) | kernel "
            f"{k_ms * 1e3:.1f} us, {bounds_text(b)}, plain "
            f"{p_ms * 1e3:.1f} us, sparse-CSR library call "
            f"{lib_ms * 1e3:.1f} us | full op {op_ms * 1e3:.1f} us vs plain "
            f"{ref_ms * 1e3:.1f} us | {ref_gbs:.0f} GB/s by "
            f"(sizeof(T)+4)*nnz")
        results[key] = {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                        "library_ms": lib_ms, **b}
    return results, padded


def solve(rt, A, b, **kw):
    """rt.cg with a Jacobi preconditioner; the wall time covers cg only
    (with its WJD auto-attach when A has none yet)."""
    M = rt.jacobi(A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = rt.cg(A, b, M=M, **kw)
    torch.cuda.synchronize()
    return x, info, time.perf_counter() - t0


def check_solve(tag, x, info, want_status, err_tol):
    it, status = int(info.iterations), int(info.status)
    err = float(torch.linalg.norm(x.double() - 1.0)
                / np.sqrt(x.shape[0]))
    if status != want_status or not err < err_tol:
        raise RuntimeError(f"{tag}: status {status} (want {want_status}), "
                           f"|x-1|/|1| = {err:.3e} (want < {err_tol:g})")
    return it, err


def need_launches(kernels, key, before, iters):
    got = kernels.launches[key] - before
    if got < iters + 1:
        raise RuntimeError(f"{key}: {got} launches for {iters} iterations")
    return got


def phase_d(rt, kernels):
    """CG + Jacobi on laplacian_3d(100) f64: WJD auto-attaches."""
    A = rt.laplacian_3d(LAP_N)
    b = rhs_of_ones(A)
    before = kernels.launches["roll_f64"]
    x, info, first_s = solve(rt, A, b, rel_tol=1e-8, max_iter=2000)
    if getattr(A, "_wjd_cache", None) is None:
        raise RuntimeError("D: WJD did not auto-attach to a CUDA operand")
    it, err = check_solve("D", x, info, 2, 1e-6)
    n_l = need_launches(kernels, "roll_f64", before, it)
    x, info, wjd_s = solve(rt, A, b, rel_tol=1e-8, max_iter=2000)
    check_solve("D re-solve", x, info, 2, 1e-6)
    # the same solve through the plain CSR apply on the card
    A_plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    rt.set_auto_wjd(False)
    try:
        xp, info_p, plain_s = solve(rt, A_plain, b, rel_tol=1e-8,
                                    max_iter=2000)
    finally:
        rt.set_auto_wjd(None)
    if getattr(A_plain, "_wjd_cache", None) is not None:
        raise RuntimeError("D: auto_wjd=False still attached WJD")
    it_p, _ = check_solve("D plain", xp, info_p, 2, 1e-6)
    if abs(it_p - it) > 1:
        raise RuntimeError(f"D: WJD {it} vs plain CSR {it_p} iterations")
    say("D", f"laplacian_3d({LAP_N}) f64 CG+Jacobi rel_tol 1e-8: WJD "
        f"{it} iters (status 2, |x-1|/|1|={err:.2e}, {n_l} roll_f64 "
        f"launches; first solve with plan {first_s:.2f} s) "
        f"{wjd_s / it * 1e3:.3f} ms/iter | plain CSR {it_p} iters "
        f"{plain_s / it_p * 1e3:.3f} ms/iter")
    return A, A_plain, b


def phase_solve(rt, kernels, phase, tag, A, key, rel_tol, err_tol):
    b = rhs_of_ones(A)
    before = kernels.launches[key]
    x, info, s = solve(rt, A, b, rel_tol=rel_tol, max_iter=2000)
    it, err = check_solve(f"{phase} {tag}", x, info, 2, err_tol)
    n_l = need_launches(kernels, key, before, it)
    say(phase, f"{tag} CG+Jacobi rel_tol {rel_tol:g}: {it} iters (status "
        f"2, |x-1|/|1|={err:.2e}, {n_l} {key} launches) "
        f"{s / it * 1e3:.3f} ms/iter")


def device_profile(run, n_wall, n_prof):
    """Where the time of `run(k)` (k repetitions of one step) goes: the
    host clock over n_wall unprofiled steps against the device time that
    torch.profiler records over n_prof. Only CUDA rows of key_averages()
    are summed (CPU-op rows carry the same device time again); one stream,
    so busy = the sum of their self device times. Returns a line of text:
    wall and busy ms a step, device ops a step, idle share, top ops."""
    from torch.profiler import ProfilerActivity, profile

    run(min(n_wall, n_prof))                                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n_wall)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n_wall * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n_prof)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in rows) / n_prof
    if not busy_us > 0:
        raise RuntimeError("the profiler saw no device time")
    n_ops = sum(e.count for e in rows) / n_prof
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    top_s = "; ".join(
        f"{e.self_device_time_total / n_prof:.1f} us x"
        f"{e.count / n_prof:.1f} {e.key[:48]}" for e in top)
    return (f"wall {wall_ms:.3f} ms ({n_wall} unprofiled) | device busy "
            f"{busy_us / 1e3:.3f} ms, {n_ops:.1f} device ops (CUDA rows, "
            f"{n_prof} profiled) | idle share "
            f"{1 - busy_us / 1e3 / wall_ms:.3f} | top: {top_s}")


def phase_g(rt, ops):
    """Where one CG + Jacobi iteration's time goes (`device_profile`)."""
    for tag, (A, b, auto) in ops.items():
        rt.set_auto_wjd(auto)
        try:
            M = rt.jacobi(A)
            text = device_profile(
                lambda k: rt.cg(A, b, M=M, rel_tol=1e-30, max_iter=k),
                PROF_WALL_ITERS, PROF_ITERS)
        finally:
            rt.set_auto_wjd(None)
        say("G", f"{tag}, per iteration: {text}")


def host_us(fn, arg):
    """Host-clock microseconds one fn(arg) call takes to enqueue (the
    queue is drained before and after, not between), and per call to
    finish."""
    fn(arg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn(arg)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / HOST_CALLS * 1e6, (t2 - t0) / HOST_CALLS * 1e6


def phase_g_host(rt, kernels, A, A_plain):
    """What one apply costs the host: `wjd_spmv` (checks, the padded copy
    of x, a ctypes call) against the plain CSR apply (`index_select`,
    multiply, `index_add_`), HOST_CALLS calls each, in turns."""
    W = A._wjd_cache
    x = random_x(rt, A, W.dtype)
    cells = []
    for _ in range(2):
        cells.append((host_us(lambda v: kernels.wjd_spmv(W, v), x),
                      host_us(lambda v: rt.spmv(A_plain, v), x)))
    say("G", "host cost of one apply, enqueue us (enqueue + device us): "
        + "; ".join(f"wjd_spmv {w[0]:.1f} ({w[1]:.1f}) vs plain CSR "
                    f"{p[0]:.1f} ({p[1]:.1f})" for w, p in cells))


def phase_h(rt, kernels, totals, ops, single, padded):
    """Blocked right-hand sides: the SpMM kernel against its plain version
    on 16 columns, then the entry point rt.spmv(A, X) on 16 and 20 columns
    against the plain version and against 16 single-RHS applies. X is
    row-major. Roll mode is held column by column against the single-RHS
    kernel, bit for bit; gather mode (the compact slice form) against the
    padded slot product too."""
    results = {}
    for key, (A, _) in ops.items():
        W = A._wjd_cache
        gather = W.kernel_mode == "gather"
        tol = TOL[W.dtype]
        X = {k: random_x(rt, A, W.dtype, k) for k in MRHS_COLS}
        xp = kernels.pad_x(W, X[16], 16)             # (xp_len, 16) row-major
        plain = (kernels.slots_plain_compact_mrhs if gather
                 else kernels.slots_plain_mrhs)
        y_k = kernels.slots_kernel_mrhs(W, xp)
        max_abs, rel = rel_err(y_k, plain(W, xp), f"spmm_{key}", tol)
        k_ms = median_ms(lambda: kernels.slots_kernel_mrhs(W, xp))
        p_ms = median_ms(lambda: plain(W, xp))
        lib_ms = library_ms(A, X[16])
        n, m = A.shape
        if gather:
            W_pad, W_ordered = padded[key]
            _, rel_p = rel_err(y_k, kernels.slots_plain_mrhs(W_pad, xp),
                               f"spmm_{key} vs padded slot product", tol)
            o_ms = median_ms(lambda: kernels.slots_kernel_mrhs(W_ordered, xp))
            layouts = (f"vs padded slot product {rel_p:.3e}; timing only, "
                       f"rows of a tile ordered by length: {o_ms * 1e3:.1f} "
                       "us")
        else:
            # a column is the single-RHS roll kernel's sum, bit for bit
            for j in range(16):
                y_j = kernels.slots_kernel(W, xp[:, j].contiguous())
                if not torch.equal(y_k[:, j], y_j.reshape(-1)):
                    raise RuntimeError(f"spmm_{key}: column {j} is not the "
                                       "single-RHS kernel's, bit for bit")
            layouts = ("every column bit for bit the single-RHS roll "
                       "kernel's")
        del y_k
        b = bounds(W, kernels, 16, compact=gather)
        with Counted(kernels, totals) as c:
            Y = {k: rt.spmv(A, X[k]) for k in MRHS_COLS}
        if c.got[f"spmm_{key}"] != 3:                # 1 chunk + 2 chunks
            raise RuntimeError(f"H {key}: {c.got} launches for X of 16 and "
                               "20 columns")
        for k in MRHS_COLS:
            if tuple(Y[k].shape) != (A.shape[0], k):
                raise RuntimeError(f"H {key}: Y has shape {Y[k].shape}")
            rel_err(Y[k], kernels.wjd_reference(W, X[k]), f"H {key} k={k}",
                    tol)
            if gather:
                rel_err(Y[k], kernels.wjd_reference(W_pad, X[k]),
                        f"H {key} k={k} vs padded slot product", tol)
        singles = torch.stack([kernels.wjd_spmv(W, X[16][:, j].contiguous())
                               for j in range(16)], dim=1)
        _, rel_s = rel_err(Y[16], singles, f"H {key} vs single applies", tol)
        op_ms = median_ms(lambda: rt.spmv(A, X[16]))
        say("H", f"spmm_{key}: n={A.shape[0]} k=16 max|dY|/max|Y|={rel:.3e} "
            f"vs plain, {rel_s:.3e} vs 16 single applies (tol {tol:g}) | "
            f"kernel {k_ms * 1e3:.1f} us with X row-major (as rt.spmv "
            f"lays it out; {k_ms * 1e3 / 16:.1f} us/column against "
            f"{single[key]['ms'] * 1e3:.1f} us for the single-RHS kernel), "
            f"{layouts} | {bounds_text(b)}, plain {p_ms * 1e3:.1f} us, "
            f"sparse-CSR library call "
            f"{lib_ms * 1e3:.1f} us | rt.spmv(A, X) {op_ms * 1e3:.1f} us; "
            f"k=20 agrees too; {c.got[f'spmm_{key}']} launches")
        results[f"spmm_{key}"] = {
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, **b}
    return results


def phase_i(rt, kernels, totals, tag, make, key, attach_kw, rel_tol,
            err_tol):
    """One operator in the windowed regime: CG + Jacobi through rt.cg (with
    attach_kw=None the plan comes from the solver's auto-attach alone),
    then the windowed kernel against its plain version, timed beside the
    direct kernel on the same plan. Returns the kernel row and the
    operator (phase N1 plans it again with bf16 values)."""
    from rocalution_tpu_torch.formats.wjd import windowed

    t0 = time.perf_counter()
    A = make()
    gen_s = time.perf_counter() - t0
    b = rhs_of_ones(A)
    t0 = time.perf_counter()
    if attach_kw is not None:
        rt.attach_wjd(A, **attach_kw)
    with Counted(kernels, totals) as c:
        x, info, _ = solve(rt, A, b, rel_tol=rel_tol, max_iter=3000)
    first_s = time.perf_counter() - t0          # plan + Jacobi + first solve
    W = getattr(A, "_wjd_cache", None)
    if W is None:
        raise RuntimeError(f"I {tag}: WJD did not attach")
    if not (key == f"win_{W.kernel_mode}_{TAG[W.dtype]}"
            and windowed(W, W.dtype)):
        raise RuntimeError(f"I {tag}: plan ({W.kernel_mode}, xp_len="
                           f"{W.xp_len}) is not in the windowed regime")
    it, err = check_solve(f"I {tag}", x, info, 2, err_tol)
    if c.got[key] < it + 1:
        raise RuntimeError(f"I {tag}: {c.got[key]} {key} launches for {it} "
                           "iterations")
    x, info, s = solve(rt, A, b, rel_tol=rel_tol, max_iter=3000)
    check_solve(f"I {tag} re-solve", x, info, 2, err_tol)
    line = (f"{tag} CG+Jacobi rel_tol {rel_tol:g}: {it} iters (status 2, "
            f"|x-1|/|1|={err:.2e}, {c.got[key]} {key} launches) "
            f"{s / it * 1e3:.3f} ms/iter; generate {gen_s:.1f} s, plan + "
            f"first solve {first_s:.1f} s")
    if attach_kw is None:
        # the same solve through the plain CSR apply
        A_plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
        rt.set_auto_wjd(False)
        try:
            xp_, info_p, plain_s = solve(rt, A_plain, b, rel_tol=rel_tol,
                                         max_iter=3000)
        finally:
            rt.set_auto_wjd(None)
        it_p, _ = check_solve(f"I {tag} plain", xp_, info_p, 2, err_tol)
        if abs(it_p - it) > 1:
            raise RuntimeError(f"I {tag}: WJD {it} vs plain CSR {it_p} "
                               "iterations")
        line += (f" | plain CSR {it_p} iters "
                 f"{plain_s / it_p * 1e3:.3f} ms/iter")
        del A_plain, xp_
    say("I", line)

    tol = TOL[W.dtype]
    gather = W.kernel_mode == "gather"
    xv = random_x(rt, A, W.dtype)
    xp = kernels.pad_x(W, xv)
    plain = (kernels.slots_plain_compact_windowed if gather
             else kernels.slots_plain_windowed)
    y_k = kernels.slots_kernel_windowed(W, xp)
    max_abs, rel = rel_err(y_k, plain(W, xp), key, tol)
    rel_err(kernels.wjd_spmv(W, xv), kernels.wjd_reference(W, xv),
            f"{key} full op", tol)
    extra = ""
    if gather:
        # the plan on the card: its window-relative compact form alone
        if W.data is not None or W.uloc is not None or not W.window_relative:
            raise RuntimeError(f"I {tag}: the plan keeps its slot planes on "
                               "the card")
        W_pad, _, plan_s, compact_s = with_planes(rt, A, attach_kw,
                                                  ordered=False)
        _, rel_p = rel_err(y_k, kernels.slots_plain(W_pad, xp),
                           f"{key} vs padded slot product", tol)
        del W_pad
        if not torch.equal(y_k, kernels.slots_kernel(W, xp)):
            raise RuntimeError(f"{key}: not the direct compact kernel's "
                               "sums, bit for bit")
        extra = (f" | compact form {W.cval.numel()} elements, padding "
                 f"{W.compact_padding_ratio:.3f}x, {W.coff.element_size()}"
                 f"-byte window-relative offsets ({plan_s:.1f} s planning, "
                 f"{compact_s:.1f} s compacting when done again); vs padded "
                 f"slot product {rel_p:.3e}; bit for bit the direct compact "
                 f"kernel's | window {W.win_rows * 128 * 4} bytes, read "
                 f"through the cache")
    del y_k
    k_ms = median_ms(lambda: kernels.slots_kernel_windowed(W, xp))
    d_ms = median_ms(lambda: kernels.slots_kernel(W, xp))
    k2_ms = median_ms(lambda: kernels.slots_kernel_windowed(W, xp))
    p_ms = median_ms(lambda: plain(W, xp))
    lib_ms = library_ms(A, xv)
    b = bounds(W, kernels, compact=gather, through_windows=gather)
    direct = ("direct compact kernel on the same form" if gather
              else "direct kernel on the same plan")
    say("I", f"{key}: {plan_line(A, W)} steps="
        f"{W.win_base.numel()}{extra} | max|dy|/max|y|={rel:.3e} (tol "
        f"{tol:g}) | windowed kernel {k_ms * 1e3:.1f} us (again "
        f"{k2_ms * 1e3:.1f}), {direct} {d_ms * 1e3:.1f} us | "
        f"{bounds_text(b)}, plain {p_ms * 1e3:.1f} us, sparse-CSR library "
        f"call {lib_ms * 1e3:.1f} us")
    return {key: {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, **b}}, A


def phase_j(rt, kernels, totals, lap):
    """ELL, HYB and BCSR operands on the card go through a WJD plan once a
    solver's `as_operator` has seen them, and agree with the plain CSR
    apply; so do the plain COO and MCSR applies, and DENSE at a small
    size. ELL is shown on the Laplacian: two columns of the random banded
    matrix collect about 3,000 entries each (the generator clips columns
    at the border), so its ELL form would be 3,093 wide, 26 GB. HYB and
    BCSR are shown on random_banded_spd(J_RAND_N): converting and planning
    the 1M-row one twice took 70 s of host time, and the routing does not
    depend on its depth."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    tol = TOL[torch.float64]
    rand = rt.random_banded_spd(J_RAND_N)
    for fmt, kw, A, tag, key in (
            ("ELL", {}, lap, f"laplacian_3d({LAP_N})", "roll_f64"),
            ("HYB", {}, rand, f"random_banded_spd({J_RAND_N})",
             "gather_f64"),
            ("BCSR", {"block_dim": 4}, rand,
             f"random_banded_spd({J_RAND_N})", "gather_f64")):
        A_plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
        x = random_x(rt, A, torch.float64)
        want = rt.spmv(A_plain, x)                 # no plan: plain CSR apply
        t0 = time.perf_counter()
        B = rt.convert(A_plain, fmt, **kw)
        conv_s = time.perf_counter() - t0
        if B.device.type != "cuda":
            raise RuntimeError(f"J {fmt}: built on {B.device}")
        _, rel_u = rel_err(rt.spmv(B, x), want, f"J {fmt} unrouted", tol)
        u_ms = median_ms(lambda: rt.spmv(B, x))
        t0 = time.perf_counter()
        op = as_operator(B)
        plan_s = time.perf_counter() - t0
        with Counted(kernels, totals) as c:
            y, y2 = op(x), rt.spmv(B, x)
        if c.got[key] != 2:
            raise RuntimeError(f"J {fmt}: routed applies launched {c.got}")
        _, rel_r = rel_err(y, want, f"J {fmt} routed", tol)
        rel_err(y2, want, f"J {fmt} routed", tol)
        r_ms = median_ms(lambda: rt.spmv(B, x))
        say("J", f"{fmt} of {tag} f64: convert {conv_s:.1f} s, to_csr + "
            f"plan {plan_s:.1f} s | unrouted apply {u_ms * 1e3:.1f} us "
            f"(max|dy|/max|y|={rel_u:.1e} vs CSR) | routed through {key}: "
            f"{r_ms * 1e3:.1f} us ({rel_r:.1e}), 2 launches")
        del B, op
    for fmt in ("COO", "MCSR"):
        B = rt.convert(A_plain, fmt)
        _, rel = rel_err(rt.spmv(B, x), want, f"J {fmt}", tol)
        say("J", f"{fmt} plain apply agrees with CSR: {rel:.1e}, "
            f"{median_ms(lambda: rt.spmv(B, x)) * 1e3:.1f} us")
    S = rt.laplacian_2d(32)
    xs = random_x(rt, S, torch.float64, 3)
    _, rel = rel_err(rt.spmv(rt.convert(S, "DENSE"), xs), rt.spmv(S, xs),
                     "J DENSE", tol)
    say("J", f"DENSE 1024 x 1024 with 3 columns agrees with CSR: {rel:.1e}")


class PlanTimer:
    """Seconds spent in the WJD planner and in the compact builder, and in
    the module functions named in `extra` ((module, name) pairs), while the
    context is open (the functions are wrapped, then put back)."""

    def __init__(self, extra=()):
        import rocalution_tpu_torch.formats.wjd as wjd

        self.targets = [(wjd, "csr_to_wjd_plan"), (wjd, "compact_slices"),
                        *extra]

    def __enter__(self):
        self.saved, self.s = [], {name: 0.0 for _, name in self.targets}
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s[name] += time.perf_counter() - t0
        return call

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def served_by(M):
    """How the card serves one level operator or transfer: its format, the
    entry point, and the plan's padding and spill."""
    from rocalution_tpu_torch.formats.wjd import windowed

    W = getattr(M, "_wjd_cache", None)
    if W is None:
        return f"{type(M).__name__}, plain torch ops"
    key = (f"{'win_' if windowed(W, W.x_dtype) else ''}{W.kernel_mode}_"
           f"{TAG[W.dtype]}")
    Tp, K = W.brow.shape
    text = (f"CSR nnz={M.nnz} -> WJD {W.kernel_mode} (Tp,K)=({Tp},{K}) "
            f"wlog={W.wlog}, {KERNELS[key][0]}, padding "
            f"{W.padding_ratio:.2f}x")
    if W.dia_offsets:
        text += f", {len(W.dia_offsets)} diagonals split off to plain DIA"
    spill = W.spill_row.numel()
    if W.kernel_mode == "gather":
        text += (f", compact form {W.cval.numel() / max(W.nnz - spill, 1):.3f}"
                 f" elements a slot entry, {W.coff.element_size()}-byte "
                 "offsets")
    return text + f", spill {spill} ({spill / max(M.nnz, 1):.3f} of nnz)"


def amg_cg(rt, A0, b, M, rel_tol, err_tol, tag):
    """rt.cg with the cycle as preconditioner, AMG_CHECK_EVERY steps a host
    read. Returns iterations, error, seconds, and the masked steps (each a
    whole V-cycle whose result is thrown away)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = rt.cg(A0, b, M=M, rel_tol=rel_tol, max_iter=200,
                    check_every=AMG_CHECK_EVERY)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    it, err = check_solve(tag, x, info, 2, err_tol)
    return it, err, s, -(-it // AMG_CHECK_EVERY) * AMG_CHECK_EVERY - it


def plain_hierarchy(rt, mg, h, A0_plain):
    """The same hierarchy with fresh copies of every CSR (no device copy,
    no plan) over a plain fine operator, for a solve with auto_wjd off."""
    from rocalution_tpu_torch.formats.base import get_host

    def fresh(M):
        if not isinstance(M, rt.CSR):
            return M
        return rt.CSR.from_arrays(*(get_host(M, f) for f in (
            "data", "indices", "indptr")), M.shape, device="cpu")

    lv = h.levels
    return mg.build_hierarchy([A0_plain] + [fresh(v.A) for v in lv[1:]],
                              [fresh(v.P) for v in lv[:-1]],
                              [fresh(v.R) for v in lv[:-1]])


def split_closure(rt, mg, h, A0):
    """A fresh copy of A0 on the card and a cycle closure over it and fresh
    copies of h's CSRs, each planned with split_dia=True, the JAX
    package's f32 rule: every globally dense diagonal leaves its level's or
    transfer's slot plan for a plain DIA part (on the card the port plans
    without the split). A0 itself keeps its plan."""
    A0s = rt.CSR.from_arrays(*A0.numpy_triplet(), A0.shape)
    hp = mg.place_hierarchy(plain_hierarchy(rt, mg, h, A0s))
    for lv in hp.levels:
        for M in (lv.A, lv.P, lv.R):
            if isinstance(M, rt.CSR):
                rt.attach_wjd(M, split_dia=True)
    return A0s, mg.cycle_closure(hp)


def hold_transfers(rt, kernels, h, tag):
    """Every transfer's kernel against its plain version on that operand
    (the plan's plain product, and the plain CSR apply), at full size; the
    finest P and R timed beside both and the library call."""
    lines = []
    for l, lv in enumerate(h.levels[:-1]):
        for name, M in (("P", lv.P), ("R", lv.R)):
            W = M._wjd_cache
            tol = TOL[W.dtype]
            x = random_x(rt, M, W.dtype)
            y = kernels.wjd_spmv(W, x)
            _, rel = rel_err(y, kernels.wjd_reference(W, x),
                             f"K {tag} {name}{l}", tol)
            plain_csr = rt.CSR.from_arrays(*M.numpy_triplet(), M.shape)
            _, rel_c = rel_err(y, rt.spmv(plain_csr, x),
                               f"K {tag} {name}{l} vs plain CSR", tol)
            text = f"{name}{l} {rel:.1e}/{rel_c:.1e}"
            if l == 0:
                k_ms = median_ms(lambda: kernels.wjd_spmv(W, x))
                p_ms = median_ms(lambda: kernels.wjd_reference(W, x))
                lib_ms = library_ms(plain_csr, x)
                text += (f" (apply {k_ms * 1e3:.1f} us, plain "
                         f"{p_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} "
                         "us)")
            lines.append(text)
            del plain_csr
    say("K", f"{tag}: each transfer's kernel vs the plan's plain product / "
        f"the plain CSR apply, max|dy|/max|y| (tol {tol:g}): "
        + "; ".join(lines))


def amg_levels(mg, h, tag):
    M = mg.cycle_closure(h)
    for l, lv in enumerate(M.hierarchy.levels):
        for name, Op in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
            if Op is not None:
                if Op.device.type != "cuda":
                    raise RuntimeError(f"K {tag}: {name}{l} on {Op.device}")
                say("K", f"{tag} {name}{l} {tuple(Op.shape)}: "
                    f"{served_by(Op)}")
        if lv.smooth is not None and lv.smooth.inv_d.device.type != "cuda":
            raise RuntimeError(f"K {tag}: smoother {l} off the card")
    return M


class Plain:
    """auto_wjd off while open: the plain path's solves neither attach nor
    launch."""

    def __init__(self, rt):
        self.rt = rt

    def __enter__(self):
        self.rt.set_auto_wjd(False)

    def __exit__(self, *exc):
        self.rt.set_auto_wjd(None)


def host_profile(run, n):
    """Where the host's time in run(n) goes, per step: cProfile's Python
    functions by their own time, and torch.profiler's CPU rows (aten ops
    and CUDA runtime calls: cudaLaunchKernel, cudaMalloc, synchronizations)
    by self CPU time. Device-to-host syncs are counted apart. Returns a
    line of text."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile

    run(n)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run(n)
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) / n * 1e3
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:HOST_TOP]
    py = "; ".join(
        f"{tt / n * 1e3:.3f} ms x{nc / n:.1f} {fn[2]} "
        f"({fn[0].rsplit('/', 1)[-1]}:{fn[1]})"
        for fn, (_, nc, tt, _, _) in top)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        run(n)
        torch.cuda.synchronize()
    rows = [e for e in tp.key_averages() if e.device_type.name == "CPU"]
    syncs = sum(e.count for e in rows if e.key in SYNC_ROWS) / n - 1 / n
    cpu = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:HOST_TOP]
    aten = "; ".join(f"{e.self_cpu_time_total / n / 1e3:.3f} ms "
                     f"x{e.count / n:.1f} {e.key[:40]}" for e in cpu)
    return (f"wall under cProfile {wall:.3f} ms | {syncs:.1f} device-to-host "
            f"syncs a step | Python, own time: {py} | torch CPU rows, self "
            f"time: {aten}")


def amg_phase(rt, kernels, mg, totals, h, A0, b, tag, rel_tol, err_tol,
              A0_plain, split=False, h_plain=None):
    """One hierarchy on the card: closure (placement, plans, coarse QR),
    how each operator is served, CG through the kernels, the same solve
    plain (fresh plan-free copies of the levels, auto_wjd off), both timed
    in turns, the transfers held against their plain versions, and where
    the time of a V-cycle (device, and the host's share by function) and of
    a CG iteration goes on both paths. With `split`, a third path plans
    every CSR with the JAX package's f32 DIA split and is solved, timed and
    profiled beside the other two. `h_plain`: the hierarchy the plain
    path copies (default: h)."""
    with PlanTimer() as pt:
        t0 = time.perf_counter()
        M = amg_levels(mg, h, tag)
        closure_s = time.perf_counter() - t0
    with Counted(kernels, totals) as c:
        it, err, _, masked = amg_cg(rt, A0, b, M, rel_tol, err_tol, tag)
    used = {k: n for k, n in c.got.items() if n}
    if not used:
        raise RuntimeError(f"K {tag}: the solve launched no kernel")
    paths = {"WJD": (A0, M, contextlib.nullcontext())}
    with Plain(rt), Counted(kernels, {}) as cp:
        Mp = mg.cycle_closure(plain_hierarchy(rt, mg, h_plain or h,
                                              A0_plain))
        it_p = amg_cg(rt, A0_plain, b, Mp, rel_tol, err_tol,
                      f"{tag} plain")[0]
    paths["plain"] = (A0_plain, Mp, Plain(rt))
    if any(cp.got.values()):
        raise RuntimeError(f"K {tag} plain: launched {cp.got}")
    if abs(it_p - it) > 1:
        raise RuntimeError(f"K {tag}: WJD {it} vs plain {it_p} iterations")
    turns = ("WJD", "plain", "plain", "WJD")
    split_text = ""
    if split:
        with Counted(kernels, {}) as cu:
            A0s, Mu = split_closure(rt, mg, h, A0)
            it_u = amg_cg(rt, A0s, b, Mu, rel_tol, err_tol,
                          f"{tag} WJD split")[0]
        if abs(it_u - it) > 1:
            raise RuntimeError(f"K {tag}: WJD {it} vs split {it_u} "
                               "iterations")
        paths["WJD split"] = (A0s, Mu, contextlib.nullcontext())
        turns = ("WJD", "plain", "WJD split", "WJD split", "plain", "WJD")
        n_split = sum(len(M._wjd_cache.dia_offsets)
                      for lv in Mu.hierarchy.levels
                      for M in (lv.A, lv.P, lv.R) if isinstance(M, rt.CSR))
        split_text = (f" | WJD split (split_dia=True on every CSR, "
                      f"{n_split} diagonals split off): {it_u} iters, "
                      f"launches { {k: n for k, n in cu.got.items() if n} }")
    ms = []
    for path in turns:                                      # in turns
        A_, M_, ctx = paths[path]
        with ctx:
            got = amg_cg(rt, A_, b, M_, rel_tol, err_tol, f"{tag} {path}")
        ms.append(f"{path} {got[2] / got[0] * 1e3:.3f}")
    say("K", f"{tag}: cycle closure {closure_s:.1f} s (WJD planning "
        f"{pt.s['csr_to_wjd_plan']:.1f} s, compacting "
        f"{pt.s['compact_slices']:.1f} s) | CG+SA-AMG rel_tol {rel_tol:g}: "
        f"{it} iters (status 2, |x-1|/|1|={err:.2e}), {masked} masked steps "
        f"(check_every={AMG_CHECK_EVERY}), launches {used} | plain {it_p} "
        f"iters, no launch{split_text} | ms/iter in turns "
        + ", ".join(ms))
    hold_transfers(rt, kernels, M.hierarchy, tag)
    for path, (A_, M_, ctx) in paths.items():
        def cycles(k):
            for _ in range(k):
                M_(b)

        with ctx:
            text = device_profile(cycles, *AMG_PROF_CYCLES)
            say("K", f"{tag} {path}, one V-cycle: {text}")
            say("K", f"{tag} {path}, one V-cycle's host time: "
                f"{host_profile(cycles, AMG_PROF_CYCLES[1])}")
            text = device_profile(
                lambda k: rt.cg(A_, b, M=M_, rel_tol=1e-30, max_iter=k,
                                check_every=k), *AMG_PROF_ITERS)
            say("K", f"{tag} {path}, one CG iteration: {text}")


def phase_k(rt, kernels, totals):
    from rocalution_tpu_torch import native
    from rocalution_tpu_torch.solvers import multigrid as mg

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("K: the native setup layer did not build")
    say("K", f"native setup layer available ({native.library_path().name}, "
        f"built or loaded in {time.perf_counter() - t0:.1f} s)")

    # K1: bench.py's cg_saamg row
    A = rt.laplacian_2d(AMG_65K_N)
    t0 = time.perf_counter()
    h32 = mg.convert_hierarchy(mg.amg_hierarchy(A, "sa", coarse_size=300),
                               dtype=np.float32)
    setup_s = time.perf_counter() - t0
    M = mg.cycle_closure(h32)
    b = rhs_of_ones(A).float()
    with Counted(kernels, totals) as c:
        it, err, _, masked = amg_cg(rt, h32.levels[0].A, b, M, 1e-6, 1e-3,
                                    "K1")
    s = amg_cg(rt, h32.levels[0].A, b, M, 1e-6, 1e-3, "K1 re-solve")[2]
    if it != 6:
        raise RuntimeError(f"K1: {it} iterations, the bench records 6")
    say("K", f"K1 laplacian_2d({AMG_65K_N}) SA f64 setup + f32 conversion "
        f"{setup_s:.2f} s, levels {h32.operator_sizes()} "
        f"{[type(lv.A).__name__ for lv in h32.levels]} | CG rel_tol 1e-6: "
        f"{it} iters (|x-1|/|1|={err:.2e}), {s / it * 1e3:.3f} ms/iter, "
        f"{masked} masked steps | launches "
        f"{ {k: n for k, n in c.got.items() if n} }")
    del A, h32, M, b

    # K2: the bench's amg_setup_2m operator in f64
    t0 = time.perf_counter()
    A = rt.laplacian_3d(AMG_3D_N)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = mg.amg_hierarchy(A, "sa", coarse_size=300)
    setup_s = time.perf_counter() - t0
    if h.num_levels != AMG_3D_LEVELS:
        raise RuntimeError(f"K2: {h.num_levels} levels, the bench records "
                           f"{AMG_3D_LEVELS}")
    say("K", f"K2 laplacian_3d({AMG_3D_N}) f64 n={A.shape[0]}: generate "
        f"{gen_s:.1f} s, SA setup {setup_s:.1f} s, {h.num_levels} levels "
        f"{h.operator_sizes()}")
    b = rhs_of_ones(A)
    A_plain = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    amg_phase(rt, kernels, mg, totals, h, A, b, "K2 f64", 1e-8, 1e-6,
              A_plain)
    del A_plain
    torch.cuda.empty_cache()

    # K3: its f32 conversion. On the card every level stays CSR, for the
    # kernels; the plain path converts with auto_wjd off, which gives the
    # JAX package's formats (DIA where a level has few diagonals)
    t0 = time.perf_counter()
    h32 = mg.convert_hierarchy(h, dtype=np.float32)
    conv_s = time.perf_counter() - t0
    with Plain(rt):
        h32p = mg.convert_hierarchy(h, dtype=np.float32)
    say("K", f"K3 f32 conversion {conv_s:.1f} s, levels "
        f"{[type(lv.A).__name__ for lv in h32.levels]}; with auto_wjd off "
        f"(the plain path) {[type(lv.A).__name__ for lv in h32p.levels]}")
    del h
    amg_phase(rt, kernels, mg, totals, h32, h32.levels[0].A, b.float(),
              "K3 f32", 1e-6, 1e-3, h32p.levels[0].A, split=True,
              h_plain=h32p)


def true_residual(A, x, b):
    """||b - A x|| / ||b|| in f64 on the host, from A's host triplet."""
    import scipy.sparse as sp

    S = sp.csr_matrix(A.numpy_triplet(), shape=A.shape)
    bh = b.double().cpu().numpy()
    return float(np.linalg.norm(bh - S @ x.double().cpu().numpy())
                 / np.linalg.norm(bh))


def error_of(A, x, b, ones):
    """||x - 1|| / ||1|| where b = A 1, else the true relative residual."""
    if ones:
        return "|x-1|/|1|", float(torch.linalg.norm(x.double() - 1.0)
                                  / np.sqrt(x.shape[0]))
    return "|b-Ax|/|b|", true_residual(A, x, b)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def factor_served(M, got):
    """How the card serves each factor's sweeps or level solves: the
    off-diagonal part's plan and its launches, or the schedule's levels."""
    names = ("lower", "upper")
    if M.schedules is not None:
        out = [f"{name}: level schedule, {sch.nlev} levels of up to "
               f"{sch.rows.shape[1]} rows, plain torch ops"
               for name, sch in zip(names, M.schedules)]
    else:
        out = [f"{name} off-diagonal part: {served_by(T._offd_cache)}"
               for name, T in zip(names, M.factors)]
    return "; ".join(out) + f" | launches of the solve {got}"


def hold_row_kernels(rt, kernels, phase, tag, Op, M):
    """The kernel apply of a row's operator and of each factor's
    off-diagonal part (where the plan serves them) against the plan's
    plain product and the plain CSR apply of the same triplet, on the same
    x, at TOL; raises on a disagreement, or if no part has a plan. These
    launches are not the main path's."""
    parts = [("operator", Op)]
    if M.schedules is None:
        parts += [(f"{name} off-diagonal part", T._offd_cache)
                  for name, T in zip(("lower", "upper"), M.factors)]
    lines = []
    for name, N in parts:
        W = getattr(N, "_wjd_cache", None)
        if W is None:
            continue
        x = random_x(rt, N, W.dtype)
        y = kernels.wjd_spmv(W, x)
        _, rel = rel_err(y, kernels.wjd_reference(W, x),
                         f"{phase} {tag} {name}", TOL[W.dtype])
        plain_csr = rt.CSR.from_arrays(*N.numpy_triplet(), N.shape)
        _, rel_c = rel_err(y, rt.spmv(plain_csr, x),
                           f"{phase} {tag} {name} vs plain CSR", TOL[W.dtype])
        lines.append(f"{name} {rel:.1e}/{rel_c:.1e}")
        del plain_csr
    if not lines:
        raise RuntimeError(f"{phase} {tag}: no part of the row has a plan")
    return "; ".join(lines)


def check_row(phase, tag, A, x, b, ones, info, spec):
    """A factorization row's solve: the status the row wants, and |x-1|/|1|
    under spec["err"] where b = A 1, else the true relative residual
    (f64, from A's host triplet) under RES_BOUND. Returns (name, value)."""
    status = int(info.status)
    name, err = error_of(A, x, b, ones)
    if ones:
        bound = spec["err"]
    else:
        reported = float(info.final_res) / float(info.init_res)
        bound = max(RES_BOUND[0] * reported, RES_BOUND[1][A.dtype])
    if status != spec["status"] or not err <= bound:
        raise RuntimeError(f"{phase} {tag}: status {status} (want "
                           f"{spec['status']}), {name} {err:.3e} (bound "
                           f"{bound:.1e})")
    return name, err


def factor_row(rt, kernels, totals, phase, tag, spec):
    """One factorization row on the card: setup (factorization, schedules
    or off-diagonal plans, planning and compacting seconds), the solve
    through the WJD kernels, the same solve plain (a fresh plan-free copy,
    auto_wjd off), both timed in turns, one profiled iteration of each,
    one preconditioner apply of each, and what served the operator and
    each factor. `spec`: make() -> A on the card; rhs(A) -> (b, b is A 1);
    precond(A) -> M; operator(A, wjd) -> the solver's operand; solver;
    kw; status = the status both paths must reach; err = the bound on
    |x-1|/|1| where b = A 1 (else the true relative residual is held to
    RES_BOUND); tol = the iterations the two paths may differ by (None: a
    row whose count rounding alone moves, held to the same status only);
    want = the iterations the row must take, or None; prof = the
    iterations timed and profiled (default FACTOR_PROF); turns = the
    paths timed in turns after the counted solves (default WJD, plain,
    plain, WJD). Before the solve,
    the kernel apply of the operator and of each factor's off-diagonal
    part is held against its plain versions (`hold_row_kernels`). Returns
    the iterations."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    # the module, not the function `ilu` that precond/__init__ exports
    ilu_mod = importlib.import_module("rocalution_tpu_torch.precond.ilu")

    (A, gen_s) = timed(spec["make"])
    b, ones = spec["rhs"](A)
    solver, kw = spec["solver"], dict(spec["kw"],
                                      check_every=FACTOR_CHECK_EVERY)
    extra = [(ilu_mod, n) for n in ("ilu0", "ic0", "build_schedule",
                                    "prepare_offd")]
    with PlanTimer(extra) as pt:
        def setup():
            Op = spec["operator"](A, True)
            as_operator(Op)                 # its plan, now
            return spec["precond"](A), Op
        (M, Op), setup_s = timed(setup)
    held = hold_row_kernels(rt, kernels, phase, tag, Op, M)
    with Counted(kernels, totals) as c:
        (x, info), first_s = timed(lambda: solver(Op, b, M=M, **kw))
    it, status = int(info.iterations), int(info.status)
    err_name, err = check_row(phase, f"{tag} WJD", A, x, b, ones, info, spec)
    if spec.get("want") is not None and it != spec["want"]:
        raise RuntimeError(f"{phase} {tag}: {it} iterations, want "
                           f"{spec['want']}")
    used = {k: n for k, n in c.got.items() if n}
    if not used:
        raise RuntimeError(f"{phase} {tag}: the solve launched no kernel")
    with Plain(rt), Counted(kernels, {}) as cp:
        A_p = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
        M_p = spec["precond"](A_p)
        Op_p = spec["operator"](A_p, False)
        x_p, info_p = solver(Op_p, b, M=M_p, **kw)
    if any(cp.got.values()):
        raise RuntimeError(f"{phase} {tag} plain: launched {cp.got}")
    it_p, status_p = int(info_p.iterations), int(info_p.status)
    _, err_p = check_row(phase, f"{tag} plain", A, x_p, b, ones, info_p,
                         spec)
    if status_p != status or (spec["tol"] is not None
                              and abs(it_p - it) > spec["tol"]):
        raise RuntimeError(f"{phase} {tag}: WJD {it} iterations status "
                           f"{status}, plain {it_p} status {status_p}")
    paths = {"WJD": (Op, M, contextlib.nullcontext()),
             "plain": (Op_p, M_p, Plain(rt))}
    ms = []
    for path in spec.get("turns", ("WJD", "plain", "plain", "WJD")):
        Op_, M_, ctx = paths[path]
        with ctx:
            (_, inf_), s = timed(lambda: solver(Op_, b, M=M_, **kw))
        ms.append(f"{path} {s / int(inf_.iterations) * 1e3:.3f}")
    served = (f"operator: {served_by(Op)} | factors: "
              f"{factor_served(M, used)}")
    say(phase, f"{tag}: n={A.shape[0]} nnz={A.nnz} {A.dtype} generate "
        f"{gen_s:.1f} s | setup {setup_s:.2f} s (factorization "
        f"{pt.s['ilu0'] + pt.s['ic0']:.2f} s, schedules "
        f"{pt.s['build_schedule']:.2f} s, off-diagonal parts "
        f"{pt.s['prepare_offd']:.2f} s of which WJD planning "
        f"{pt.s['csr_to_wjd_plan']:.2f} s and compacting "
        f"{pt.s['compact_slices']:.2f} s) | WJD: status {status}, {it} "
        f"iters, {err_name} {err:.3e}, first solve {first_s:.2f} s | plain: "
        f"status {status_p}, {it_p} iters, {err_p:.3e}"
        + (" (a count rounding moves: not held to the WJD one)"
           if spec["tol"] is None else "") + " | ms/iter in turns "
        + ", ".join(ms))
    say(phase, f"{tag} served by: {served}")
    say(phase, f"{tag}: each kernel apply vs the plan's plain product / the "
        f"plain CSR apply, max|dy|/max|y| (tol {TOL[A.dtype]:g}): {held}")
    r = b.clone()
    for path, (Op_, M_, ctx) in paths.items():
        with ctx:
            apply_ms = median_host_ms(lambda: M_(r))
            text = device_profile(
                lambda k: solver(Op_, b, M=M_, rel_tol=1e-30, max_iter=k,
                                 check_every=k, **{
                                     k_: v for k_, v in spec["kw"].items()
                                     if k_ not in ("rel_tol", "max_iter")}),
                *spec.get("prof", FACTOR_PROF))
        say(phase, f"{tag} {path}: preconditioner apply {apply_ms:.3f} ms "
            f"(host clock) | one iteration: {text}")
    return it


def median_host_ms(fn):
    """Median host-clock ms of APPLY_REPS synchronized calls of fn()."""
    fn()
    times = []
    for _ in range(APPLY_REPS):
        times.append(timed(fn)[1] * 1e3)
    return statistics.median(times)


def phase_l(rt, kernels, totals):
    """IC(0) and ILU(0) with CG and GMRES(30): bench.py's three rows at
    their own sizes (L1), then the two solvers at about a million rows in
    f64 (L2)."""

    def ones_rhs(A):
        return rhs_of_ones(A), True

    def rng4_rhs(A):
        b = np.random.default_rng(4).standard_normal(A.shape[0])
        return torch.from_numpy(b.astype(A.numpy_triplet()[0].dtype)).to(
            A.device), False

    def fem_rhs(A):
        # bench.py's b = spmv(Af, 1), made by the port's plain CPU apply
        Ah = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape, device="cpu")
        return rt.spmv(Ah, torch.ones(A.shape[1], dtype=Ah.dtype)).to(
            A.device), True

    def as_is(A, wjd):
        return A

    def attached(A, wjd):
        return rt.attach_wjd(A) if wjd else A

    f32 = np.float32
    # err: about ten times the |x-1|/|1| both paths reach on the H100
    rows = [
        ("L1", f"cg_ic0 laplacian_2d({L1_IC_N}) f32, ic jacobi 8 sweeps, CG "
         "on the DIA operator, rel_tol 1e-8", dict(
             make=lambda: rt.laplacian_2d(L1_IC_N, dtype=f32), rhs=ones_rhs,
             precond=lambda A: rt.ic(A, method="jacobi", sweeps=8),
             operator=lambda A, wjd: rt.convert(A, "DIA"), solver=rt.cg,
             kw=dict(rel_tol=1e-8, max_iter=1000), status=2, err=1e-5,
             tol=1,
             want=L1_WANT["cg_ic0"])),
        ("L1", f"gmres_ilu0 convection_diffusion_2d({L1_CD_N}) f32, ilu(0) "
         "jacobi 8 sweeps, GMRES(30), rel_tol 1e-8", dict(
             make=lambda: rt.convection_diffusion_2d(L1_CD_N, dtype=f32),
             rhs=rng4_rhs,
             precond=lambda A: rt.ilu(A, 0, method="jacobi", sweeps=8),
             operator=attached, solver=rt.gmres,
             kw=dict(basis_size=30, rel_tol=1e-8, max_iter=600), status=2,
             tol=None)),
        ("L1", f"gmres_ilu0_f64 convection_diffusion_2d({L1_CD_N}) f64, "
         "the same recipe in f64", dict(
             make=lambda: rt.convection_diffusion_2d(L1_CD_N),
             rhs=rng4_rhs,
             precond=lambda A: rt.ilu(A, 0, method="jacobi", sweeps=8),
             operator=attached, solver=rt.gmres,
             kw=dict(basis_size=30, rel_tol=1e-8, max_iter=600), status=2,
             tol=2,
             want=L1_WANT["gmres_ilu0_f64"])),
        ("L1", f"fem_ilu0 fem_2d_unstructured({L1_FEM_N}) f32 parabolic, "
         "ilu(0) levels, CG, rel_tol 1e-4", dict(
             make=lambda: rt.fem_2d_unstructured(L1_FEM_N, dtype=f32,
                                                 parabolic=True),
             rhs=fem_rhs, precond=lambda A: rt.ilu(A, 0, method="levels"),
             operator=as_is, solver=rt.cg,
             # CG amplifies a rounding difference about tenfold a step on
             # this operator with ILU(0) (tests/test_torch_ilu.py)
             kw=dict(rel_tol=1e-4, max_iter=200), status=2, err=2e-4,
             tol=None,
             # an iteration is ~8,600 device ops: profile two; and time
             # one solve a path in turns (~10 s each), so that the whole
             # run keeps its time with phase N added
             prof=(4, 2), turns=("WJD", "plain"))),
        ("L2", f"laplacian_3d({L2_LAP_N}) f64, ic jacobi 8 sweeps, CG, "
         "rel_tol 1e-8", dict(
             make=lambda: rt.laplacian_3d(L2_LAP_N), rhs=ones_rhs,
             precond=lambda A: rt.ic(A, method="jacobi", sweeps=8),
             operator=as_is, solver=rt.cg,
             kw=dict(rel_tol=1e-8, max_iter=2000), status=2, err=1e-7,
             tol=1)),
        ("L2", f"convection_diffusion_2d({L2_CD_N}) f64, ilu(0) jacobi 8 "
         "sweeps, GMRES(30), rel_tol 1e-6", dict(
             make=lambda: rt.convection_diffusion_2d(L2_CD_N), rhs=rng4_rhs,
             precond=lambda A: rt.ilu(A, 0, method="jacobi", sweeps=8),
             operator=as_is, solver=rt.gmres,
             kw=dict(basis_size=30, rel_tol=1e-6, max_iter=600),
             status=L2_CD_STATUS,
             tol=2)),
    ]
    for phase, tag, spec in rows:
        t0 = time.perf_counter()
        factor_row(rt, kernels, totals, phase, tag, spec)
        say(phase, f"{tag.split(',')[0]}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()


def phase_m(rt, kernels, totals):
    """MixedPrecisionDC: bench.py's mpdc row (M1: 3 outer iterations, and
    the f32 inner operator keeps its host cache), then the same settings at
    a million rows (M2). The outer residual goes through the f64 operator's
    plan, the inner CG through the f32 copy's."""
    kw = dict(rel_tol=1e-10, max_iter=20,
              inner_kwargs={"rel_tol": 1e-4, "max_iter": 2000,
                            "check_every": FACTOR_CHECK_EVERY})
    for phase, tag, make in (
            ("M1", f"laplacian_2d({M1_N}) f64", lambda: rt.laplacian_2d(M1_N)),
            ("M2", f"laplacian_3d({M2_N}) f64",
             lambda: rt.laplacian_3d(M2_N))):
        t0 = time.perf_counter()
        A = make()
        b = torch.from_numpy(np.random.default_rng(5).standard_normal(
            A.shape[0])).to(A.device)
        with Counted(kernels, totals) as c:
            (x, info), first_s = timed(
                lambda: rt.mixed_precision_dc(A, b, **kw))
        it, status = int(info.iterations), int(info.status)
        res = true_residual(A, x, b)
        # bench.py's mpdc_inner_fast, read off the f32 operator the solve
        # used: it kept its host arrays, so it planned without a device read
        A_low = A._mpdc_cache[2]
        cache = getattr(A_low, "_host_cache", None)
        inner_fast = float(bool(cache) and cache["data"].dtype == np.float32)
        if phase == "M1" and (it != 3 or inner_fast != 1.0):
            raise RuntimeError(f"M1: {it} outer iterations, mpdc_inner_fast "
                               f"{inner_fast}; the bench records 3 and 1")
        if status != 2 or not res < 1e-9:
            raise RuntimeError(f"{phase}: status {status}, |b-Ax|/|b| "
                               f"{res:.3e}")
        used = {k: n for k, n in c.got.items() if n}
        with Plain(rt), Counted(kernels, {}) as cp:
            A_p = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
            x_p, info_p = rt.mixed_precision_dc(A_p, b, **kw)
        if any(cp.got.values()):
            raise RuntimeError(f"{phase} plain: launched {cp.got}")
        if int(info_p.status) != 2 or abs(int(info_p.iterations) - it) > 1:
            raise RuntimeError(f"{phase}: WJD {it} outer iterations, plain "
                               f"{int(info_p.iterations)}")
        paths = {"WJD": (A, contextlib.nullcontext()),
                 "plain": (A_p, Plain(rt))}
        ms = []
        for path in ("WJD", "plain", "plain", "WJD"):
            A_, ctx = paths[path]
            with ctx:
                (_, inf_), s = timed(
                    lambda: rt.mixed_precision_dc(A_, b, **kw))
            ms.append(f"{path} {s * 1e3 / int(inf_.iterations):.2f}")
        it_p = int(info_p.iterations)
        say(phase, f"mpdc {tag} rel_tol 1e-10, inner CG f32 rel_tol 1e-4: "
            f"status {status}, {it} outer iterations (plain {it_p}), "
            f"|b-Ax|/|b| {res:.3e}, mpdc_inner_fast "
            f"{inner_fast:.0f}, first solve (with the f32 copy's plan) "
            f"{first_s:.2f} s | ms per outer iteration in turns "
            + ", ".join(ms))
        say(phase, f"{tag} served by: outer residual {served_by(A)} | inner "
            f"f32 operator {served_by(A_low)} | launches {used}")
        r32 = b.float()
        for path, (A_, ctx) in paths.items():
            with ctx:
                op = A_._mpdc_cache[2]
                text = device_profile(
                    lambda k: rt.cg(op, r32, rel_tol=1e-30, max_iter=k,
                                    check_every=k), *FACTOR_PROF)
            say(phase, f"{tag} {path}, one inner CG iteration: {text}")
        say(phase, f"{tag}: {time.perf_counter() - t0:.1f} s")
        del A, A_p, A_low
        torch.cuda.empty_cache()

def norm_err(got, want, tag, tol):
    """max|got - want| and ||got - want|| / ||want|| (in f64); raises
    beyond tol or on a value that is not finite."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{tag}: output is not finite")
    d = got.double() - want.double()
    rel = float(torch.linalg.norm(d) / torch.linalg.norm(want.double()))
    if not rel <= tol:
        raise RuntimeError(f"{tag}: disagrees with its reference: "
                           f"{rel:.3e} > {tol}")
    return float(d.abs().max()), rel


def library_bf16_ms(A, x):
    """The library call on bf16 values and a bf16 x (the same function as
    a bf16 kernel, whose x is that x widened), where torch serves it on
    the card; where it raises, the f32 call's time, and a note that says
    so."""
    S = torch.sparse_csr_tensor(A.indptr, A.indices,
                                A.data.to(torch.bfloat16), size=A.shape)
    xb = x.to(torch.bfloat16)
    try:
        S @ xb
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        why = str(exc).strip().splitlines()[0][:90]
        return library_ms(A, x), (f"library: the bf16 call raised ({why}); "
                                  "the f32 call's time")
    return median_ms(lambda: S @ xb), "library: bf16 values and x"


def bf16_copy(rt, A, attach_kw):
    """A CSR on A's arrays (device tensors and host cache shared) with a
    bf16 plan attached through rt.attach_wjd; the seconds it took. A keeps
    its f32 plan."""
    from rocalution_tpu_torch.formats.base import set_host_cache

    B = dataclasses.replace(A)
    set_host_cache(B, **A._host_cache)
    t0 = time.perf_counter()
    rt.attach_wjd(B, values_dtype="bfloat16", **attach_kw)
    return B, time.perf_counter() - t0


def bf16_row(rt, kernels, totals, tag, A, B, key, plan_s):
    """One bf16 single-RHS kernel (direct or windowed) on B's plan: against
    its plain version and the f32 plan's product (A's), timed beside the
    f32 kernel on the same x, its bound and the library call; then the
    main path, rt.spmv(B, x) with an f32 and a bf16 x."""
    from rocalution_tpu_torch.formats.wjd import windowed

    W, W32 = B._wjd_cache, A._wjd_cache
    win = windowed(W, W.x_dtype)
    if (W.dtype != torch.bfloat16 or key != f"{'win_' if win else ''}"
            f"{W.kernel_mode}_bf16"):
        raise RuntimeError(f"N1 {tag}: the bf16 plan ({W.dtype}, "
                           f"{W.kernel_mode}, windowed {win}) is not {key}'s")
    gather = W.kernel_mode == "gather"
    if win:
        launch = kernels.slots_kernel_windowed
        plain = (kernels.slots_plain_compact_windowed if gather
                 else kernels.slots_plain_windowed)
    else:
        launch = kernels.slots_kernel
        plain = kernels.slots_plain_compact if gather else kernels.slots_plain
    x = random_x(rt, A, torch.float32)
    xp, xp32 = kernels.pad_x(W, x), kernels.pad_x(W32, x)
    max_abs, rel_p = norm_err(launch(W, xp), plain(W, xp), key, BF16_TOL)
    _, rel_32 = norm_err(kernels.wjd_spmv(W, x), kernels.wjd_spmv(W32, x),
                         f"{key} vs the f32 plan", BF16_VS_F32_TOL)
    k_ms = median_ms(lambda: launch(W, xp))
    k32_ms = median_ms(lambda: launch(W32, xp32))
    p_ms = median_ms(lambda: plain(W, xp))
    lib_ms, lib_note = library_bf16_ms(A, x)
    b = bounds(W, kernels, compact=gather, through_windows=win and gather)
    with Counted(kernels, totals) as c:
        y1 = rt.spmv(B, x)
        y2 = rt.spmv(B, x.to(torch.bfloat16))
    if c.got[key] != 2 or sum(c.got.values()) != 2:
        raise RuntimeError(f"N1 {key}: rt.spmv launched {c.got}")
    if y1.dtype != torch.float32 or y2.dtype != torch.float32:
        raise RuntimeError(f"N1 {key}: y is {y1.dtype}, {y2.dtype}")
    norm_err(y1, kernels.wjd_spmv(W32, x), f"N1 {key} rt.spmv",
             BF16_VS_F32_TOL)
    _, rel_x = norm_err(y2, y1, f"N1 {key} rt.spmv of a bf16 x",
                        BF16_VS_F32_TOL)
    Tp, K = W.brow.shape
    form = (f"compact {W.cval.numel()} elements ({W.compact_padding_ratio:.3f}"
            f"x), {W.coff.element_size()}-byte offsets" if gather
            else f"planes (Tp,K)=({Tp},{K})")
    say("N1", f"{key}: {tag} n={A.shape[0]} nnz={A.nnz} bf16 plan {form}, "
        f"planned in {plan_s:.1f} s | vs plain {rel_p:.3e} (tol {BF16_TOL:g}),"
        f" vs the f32 plan {rel_32:.3e} (tol {BF16_VS_F32_TOL:g}), a bf16 x "
        f"vs an f32 one {rel_x:.3e} (norm-wise) | kernel {k_ms * 1e3:.1f} us "
        f"(the f32 plan's kernel on the same x {k32_ms * 1e3:.1f} us), "
        f"{bounds_text(b)}, plain {p_ms * 1e3:.1f} us, {lib_note} "
        f"{lib_ms * 1e3:.1f} us | rt.spmv(B, x): {c.got[key]} launches")
    return {key: {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, **b}}


def bf16_spmm_row(rt, kernels, totals, tag, A, B, key):
    """The bf16 SpMM kernel on N_COLS columns of row-major X, as bf16_row
    holds the single-RHS ones; the main path rt.spmv(B, X)."""
    W, W32 = B._wjd_cache, A._wjd_cache
    gather = W.kernel_mode == "gather"
    if W.dtype != torch.bfloat16 or key != f"spmm_{W.kernel_mode}_bf16":
        raise RuntimeError(f"N1 {tag}: the bf16 plan is not {key}'s")
    plain = (kernels.slots_plain_compact_mrhs if gather
             else kernels.slots_plain_mrhs)
    X = random_x(rt, A, torch.float32, N_COLS)
    xp, xp32 = kernels.pad_x(W, X, N_COLS), kernels.pad_x(W32, X, N_COLS)
    max_abs, rel_p = norm_err(kernels.slots_kernel_mrhs(W, xp), plain(W, xp),
                              key, BF16_TOL)
    _, rel_32 = norm_err(kernels.wjd_spmm(W, X), kernels.wjd_spmm(W32, X),
                         f"{key} vs the f32 plan", BF16_VS_F32_TOL)
    k_ms = median_ms(lambda: kernels.slots_kernel_mrhs(W, xp))
    k32_ms = median_ms(lambda: kernels.slots_kernel_mrhs(W32, xp32))
    p_ms = median_ms(lambda: plain(W, xp))
    lib_ms, lib_note = library_bf16_ms(A, X)
    b = bounds(W, kernels, N_COLS, compact=gather)
    with Counted(kernels, totals) as c:
        Y = rt.spmv(B, X)
    if c.got[key] != 1 or sum(c.got.values()) != 1:
        raise RuntimeError(f"N1 {key}: rt.spmv launched {c.got}")
    norm_err(Y, kernels.wjd_spmm(W32, X), f"N1 {key} rt.spmv",
             BF16_VS_F32_TOL)
    say("N1", f"{key}: {tag} k={N_COLS}, X row-major | vs plain {rel_p:.3e} "
        f"(tol {BF16_TOL:g}), vs the f32 plan {rel_32:.3e} (tol "
        f"{BF16_VS_F32_TOL:g}) | kernel {k_ms * 1e3:.1f} us (the f32 plan's "
        f"{k32_ms * 1e3:.1f} us), {bounds_text(b)}, plain "
        f"{p_ms * 1e3:.1f} us, {lib_note} {lib_ms * 1e3:.1f} us | "
        f"rt.spmv(B, X): {c.got[key]} launch")
    return {key: {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, **b}}


def phase_n1(rt, kernels, totals, direct, windowed_ops):
    """The six bf16 kernels on bf16 plans of f32 operators that earlier
    phases built and planned in f32: `direct` {tag: (A, attach_kw)} of C
    and H (one roll, one gather), `windowed_ops` {tag: (A, attach_kw)} of
    I. Returns the kernel rows and the bf16 copies of `direct`."""
    rows, copies = {}, {}
    for tag, (A, kw) in direct.items():
        B, plan_s = bf16_copy(rt, A, kw)
        mode = B._wjd_cache.kernel_mode
        rows.update(bf16_row(rt, kernels, totals, tag, A, B, f"{mode}_bf16",
                             plan_s))
        rows.update(bf16_spmm_row(rt, kernels, totals, tag, A, B,
                                  f"spmm_{mode}_bf16"))
        copies[tag] = B
    for tag, (A, kw) in windowed_ops.items():
        B, plan_s = bf16_copy(rt, A, kw)
        rows.update(bf16_row(rt, kernels, totals, tag, A, B,
                             f"win_{B._wjd_cache.kernel_mode}_bf16", plan_s))
        del B
        torch.cuda.empty_cache()
    return rows, copies


def krylov_applies(solver, kw, it, check_every):
    """(operator applies, preconditioner applies) of a solve that stopped
    after `it` iterations. A step checks the residual `checks` times (the
    count moves by one a check); run_chunked runs whole chunks of
    check_every steps, the masked ones too, and a masked step applies the
    operator and the preconditioner as a live one does."""
    l, s = kw.get("order", 2), kw.get("shadow_space", 4)
    # checks a step; operator applies at the start, a step; preconditioner
    # applies at the start, a step, at the end
    checks, op0, op1, pre0, pre1, pre_end = {
        "cr": (1, 2, 1, 1, 1, 0),
        "fcg": (1, 1, 1, 1, 1, 0),
        "bicgstab": (1, 1, 2, 0, 2, 0),
        "qmrcgstab": (2, 1, 2, 0, 2, 0),
        "bicgstabl": (l + 1, 1, 2 * l, 0, 2 * l, 1),
        "idr": (s + 1, 1, s + 1, 0, s + 1, 0),
        "chebyshev": (1, 1, 1, 1, 1, 0),
    }[solver]
    steps = -(-it // checks)
    steps = -(-steps // check_every) * check_every
    return op0 + op1 * steps, pre0 + pre1 * steps + pre_end


def want_launches(kernels, A, M, n_op, n_pre):
    """The launches n_op applies of A and n_pre of M make: A's plan's
    entry point once an apply, and what one apply of M launches (counted
    on a second apply: the first may finish its setup)."""
    from rocalution_tpu_torch.formats.wjd import windowed

    W = A._wjd_cache
    key = (f"{'win_' if windowed(W, W.x_dtype) else ''}{W.kernel_mode}_"
           f"{TAG[W.dtype]}")
    want = {key: n_op}
    if M is not None and n_pre:
        r = rhs_of_ones(A)
        M(r)
        with Counted(kernels, {}) as c:
            M(r)
        for k, n in c.got.items():
            if n:
                want[k] = want.get(k, 0) + n * n_pre
    return want


def res_bound(solver, info):
    """The bound on a row's true relative residual: RES_BOUND's factor
    times the residual the solver reported (QMRCGStab reports its
    quasi-residual tau, which bounds the true one up to sqrt(k+1), the QMR
    bound), or the f64 floor, whichever is larger."""
    reported = float(info.final_res) / float(info.init_res)
    factor = RES_BOUND[0]
    if solver == "qmrcgstab":
        factor = max(factor, float(np.sqrt(int(info.iterations) + 1)))
    return max(factor * reported, RES_BOUND[1][torch.float64])


def phase_n2(rt, kernels, totals):
    """The rest of the Krylov family at a million rows in f64, through
    roll_f64: the samples' solvers and settings (rel_tol 1e-8, max_iter
    1000, 2000 for Chebyshev), b = A 1, on phase L2's operators and
    preconditioners (ILU(0) and IC(0) with 8 Jacobi sweeps). Each row runs
    through the kernels (counted) and plain (auto_wjd off, fresh copies),
    once each, in turns, and plain twice more with b scaled by 1 + 1e-15
    and 1 - 1e-15. It must reach the plain path's status, its true
    residual must lie within `res_bound` and its launches must be what
    its iterations apply (`krylov_applies`). Its count must lie within 2
    of the plain one's (Chebyshev and the power method: equal), unless
    rounding rules the count: where the three plain counts spread by more
    than 2 (a BiCG-type solve of hundreds of iterations amplifies
    rounding, and the plain apply's atomics sum in another order from
    call to call), the row is held to the same status, and the kernel
    path is solved under the two scalings too, so that the two paths'
    counts show their spreads side by side. One iteration of BiCGStab +
    ILU(0) is profiled on both paths."""
    kw0 = dict(rel_tol=1e-8, max_iter=N2_MAX_ITER,
               check_every=FACTOR_CHECK_EVERY)
    (cd, gen_cd), (lap, gen_lap) = (
        timed(lambda: rt.convection_diffusion_2d(N2_CD_N)),
        timed(lambda: rt.laplacian_3d(N2_LAP_N)))
    ops = {"cd": cd, "lap": lap}
    with Plain(rt):
        plain_ops = {k: rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
                     for k, A in ops.items()}
    makers = {"ilu0": lambda A: rt.ilu(A, 0, method="jacobi", sweeps=8),
              "ic0": lambda A: rt.ic(A, method="jacobi", sweeps=8),
              "jacobi": rt.jacobi, None: lambda A: None}
    setup_s = {}

    def preconds(path_ops, names, ctx):
        out = {}
        with ctx:
            for op, name in names:
                t0 = time.perf_counter()
                out[(op, name)] = makers[name](path_ops[op])
                setup_s[(op, name)] = time.perf_counter() - t0
        return out

    from rocalution_tpu_torch.ops.spmv import as_operator

    for A in ops.values():
        as_operator(A)                               # the plans, now
    names = [("cd", "ilu0"), ("cd", "jacobi"), ("lap", "jacobi"),
             ("lap", "ic0"), ("lap", None)]
    Ms = preconds(ops, names, contextlib.nullcontext())
    Ms_p = preconds(plain_ops, names, Plain(rt))
    say("N2", f"convection_diffusion_2d({N2_CD_N}) f64 n={cd.shape[0]} "
        f"generated in {gen_cd:.1f} s, served by {served_by(cd)}; "
        f"laplacian_3d({N2_LAP_N}) f64 generated in {gen_lap:.1f} s, "
        f"{served_by(lap)} | preconditioner setup s (WJD path): "
        + ", ".join(f"{op} {name} {setup_s[(op, name)]:.2f}"
                    for op, name in names if name))
    b = {k: rhs_of_ones(A) for k, A in ops.items()}

    # the power method first: its estimate bounds Chebyshev's spectrum
    lam = {}
    for path, A, ctx, tot in (("WJD", lap, contextlib.nullcontext(), totals),
                              ("plain", plain_ops["lap"], Plain(rt), {})):
        with ctx, Counted(kernels, tot) as c:
            (lam_, _), s = timed(lambda: rt.power_method(
                A, iters=N2_POWER_ITERS))
        lam[path] = (float(lam_), s, {k: n for k, n in c.got.items() if n})
    if lam["WJD"][2] != want_launches(kernels, lap, None, N2_POWER_ITERS,
                                      0) or \
            lam["plain"][2]:
        raise RuntimeError(f"N2 power method: launches {lam['WJD'][2]}, "
                           f"plain {lam['plain'][2]}")
    if abs(lam["WJD"][0] - lam["plain"][0]) > 1e-12 * lam["plain"][0]:
        raise RuntimeError(f"N2 power method: {lam['WJD'][0]!r} through the "
                           f"kernel, {lam['plain'][0]!r} plain")
    lo, hi = rt.gershgorin(lap)
    cheb_kw = dict(lambda_min=max(float(lo), 1e-3),
                   lambda_max=1.05 * lam["WJD"][0])
    say("N2", f"power_method(iters={N2_POWER_ITERS}) laplacian_3d("
        f"{N2_LAP_N}): lambda {lam['WJD'][0]:.12f} through the kernel, "
        f"{lam['plain'][0]:.12f} plain | {lam['WJD'][1] * 1e3:.1f} ms vs "
        f"{lam['plain'][1] * 1e3:.1f} ms | {lam['WJD'][2]} | Gershgorin "
        f"[{float(lo):.3f}, {float(hi):.3f}] -> Chebyshev on "
        f"[{cheb_kw['lambda_min']:g}, {cheb_kw['lambda_max']:.6f}]")

    rows = [  # tag, operator, solver, preconditioner, solver kwargs
        ("BiCGStab + ILU(0)", "cd", "bicgstab", "ilu0", {}),
        ("BiCGStab(2) + ILU(0)", "cd", "bicgstabl", "ilu0", {"order": 2}),
        ("QMRCGStab + Jacobi", "cd", "qmrcgstab", "jacobi", {}),
        ("IDR(4) + Jacobi", "cd", "idr", "jacobi", {"shadow_space": 4}),
        ("CR + Jacobi", "lap", "cr", "jacobi", {}),
        ("FCG + IC(0)", "lap", "fcg", "ic0", {}),
        ("Chebyshev", "lap", "chebyshev", None,
         dict(cheb_kw, max_iter=2 * N2_MAX_ITER)),
    ]
    for tag, op, solver, pre, kw in rows:
        kw = {**kw0, **kw}
        fn = getattr(rt, solver)
        A, M = ops[op], Ms[(op, pre)]
        with Counted(kernels, totals) as c:
            (x, info), s = timed(lambda: fn(A, b[op], M=M, **kw))
        with Plain(rt), Counted(kernels, {}) as cp:
            (x_p, info_p), s_p = timed(lambda: fn(
                plain_ops[op], b[op], M=Ms_p[(op, pre)], **kw))
            nudged = [int(fn(plain_ops[op], b[op] * (1 + e),
                             M=Ms_p[(op, pre)], **kw)[1].iterations)
                      for e in (1e-15, -1e-15)]
        it, status = int(info.iterations), int(info.status)
        it_p, status_p = int(info_p.iterations), int(info_p.status)
        plain_counts = [it_p] + nudged
        ruled = max(plain_counts) - min(plain_counts) > 2
        wjd_counts = [it] + ([int(fn(A, b[op] * (1 + e), M=M, **kw)[1]
                                  .iterations) for e in (1e-15, -1e-15)]
                             if ruled else [])
        tol_it = 0 if solver == "chebyshev" else 2
        if status != status_p or (not ruled and abs(it - it_p) > tol_it):
            raise RuntimeError(f"N2 {tag}: WJD {it} iterations status "
                               f"{status}, plain {it_p} status {status_p} "
                               f"(plain, b scaled by 1 +- 1e-15: {nudged})")
        res = [true_residual(A, x, b[op]), true_residual(A, x_p, b[op])]
        bound = [res_bound(solver, info), res_bound(solver, info_p)]
        if not (res[0] <= bound[0] and res[1] <= bound[1]):
            raise RuntimeError(f"N2 {tag}: true residual {res} over {bound}")
        got = {k: n for k, n in c.got.items() if n}
        want = want_launches(kernels, A, M, *krylov_applies(
            solver, kw, it, kw["check_every"]))
        if got != want or any(cp.got.values()):
            raise RuntimeError(f"N2 {tag}: launches {got}, want {want}; "
                               f"plain path {cp.got}")
        err = float(torch.linalg.norm(x - 1.0) / np.sqrt(x.shape[0]))
        say("N2", f"{tag} on {op}: WJD status {status}, {it} iters, "
            f"|b-Ax|/|b| {res[0]:.3e} (bound {bound[0]:.1e}), |x-1|/|1| "
            f"{err:.2e}, {s / max(it, 1) * 1e3:.3f} ms/iter | plain status "
            f"{status_p}, {it_p} iters | counts at b, b(1 + 1e-15), "
            f"b(1 - 1e-15): plain {plain_counts}"
            + (f", WJD {wjd_counts}: ruled by rounding, held to the status"
               if ruled else f": held within {tol_it}") + " | plain "
            f"{res[1]:.3e}, {s_p / max(it_p, 1) * 1e3:.3f} ms/iter | "
            f"launches {got} (what the iterations apply)")
        if solver == "bicgstab":
            for path, (A_, M_, ctx) in {
                    "WJD": (A, M, contextlib.nullcontext()),
                    "plain": (plain_ops[op], Ms_p[(op, pre)],
                              Plain(rt))}.items():
                with ctx:
                    text = device_profile(
                        lambda k: fn(A_, b[op], M=M_, rel_tol=1e-30,
                                     max_iter=k, check_every=k),
                        *FACTOR_PROF)
                say("N2", f"{tag} {path}, one iteration: {text}")


def phase_n3(rt, kernels, totals, A, A32, B32):
    """MixedPrecisionDC on A = random_banded_spd(RAND_N) f64, whose
    outer residual goes through its f64 plan (gather_f64), with an inner
    CG over B32, the f32 copy with a bf16 plan (gather_bf16); beside the
    same solve with the inner CG over A32, the f32 copy with an f32 plan
    (gather_f32). Outer iterations, the final true relative residual (at
    most rel_tol), ms per outer iteration in turns, launches."""
    kw = dict(rel_tol=1e-10, max_iter=20)
    ikw = {"rel_tol": 1e-4, "max_iter": 2000,
           "check_every": FACTOR_CHECK_EVERY}
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.shape[0])).to(A.device)
    inner = {"bf16": B32, "f32": A32}

    def solve_with(name):
        low = inner[name]
        return rt.mixed_precision_dc(
            A, b, inner_solver=lambda _, r, **k: rt.cg(low, r, **k),
            inner_kwargs=ikw, **kw)

    out = {}
    for name in ("bf16", "f32"):
        with Counted(kernels, totals) as c:
            (x, info), first_s = timed(lambda: solve_with(name))
        it, status = int(info.iterations), int(info.status)
        res = true_residual(A, x, b)
        if status != 2 or not res <= kw["rel_tol"]:
            raise RuntimeError(f"N3 {name}: status {status}, |b-Ax|/|b| "
                               f"{res:.3e}")
        got = {k: n for k, n in c.got.items() if n}
        inner_key = f"gather_{name}"
        if (got.get("gather_f64") != it + 1 or not got.get(inner_key)
                or set(got) != {"gather_f64", inner_key}):
            raise RuntimeError(f"N3 {name}: launches {got} for {it} outer "
                               "iterations")
        out[name] = (it, res, first_s, got)
    ms = []
    for name in ("bf16", "f32", "f32", "bf16"):
        (_, inf_), s = timed(lambda: solve_with(name))
        ms.append(f"{name} {s * 1e3 / int(inf_.iterations):.2f}")
    say("N3", f"mpdc random_banded_spd({RAND_N}) f64 rel_tol 1e-10, "
        "inner CG f32 rel_tol 1e-4 over a bf16 plan: "
        f"{out['bf16'][0]} outer iterations, |b-Ax|/|b| "
        f"{out['bf16'][1]:.3e}, launches {out['bf16'][3]} | over the f32 "
        f"plan: {out['f32'][0]} outer iterations, {out['f32'][1]:.3e}, "
        f"launches {out['f32'][3]} | ms per outer iteration in turns "
        + ", ".join(ms) + " | inner operators: bf16 "
        f"{served_by(B32)}; f32 {served_by(A32)}")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU and has no CPU mode")
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels

    t_start = time.perf_counter()
    mark = [t_start]

    def lap(name):
        """Print the seconds since the last mark: one phase's seconds."""
        now = time.perf_counter()
        say(name, f"phase {name}: {now - mark[0]:.0f} s")
        mark[0] = now

    phase_a()
    phase_b(kernels)
    lap("A-B")

    # no device is named anywhere below: the port builds on the card
    lap64 = rt.laplacian_3d(LAP_N)
    lap32 = rt.laplacian_3d(LAP_N, dtype=np.float32)
    rand64 = rt.random_banded_spd(RAND_N)
    d, i, p = rand64.numpy_triplet()
    rand32 = rt.CSR.from_arrays(d.astype(np.float32), i, p, rand64.shape)
    ops = {
        "roll_f64": (lap64, {}),
        "gather_f64": (rand64, {}),
        "roll_f32": (lap32, {}),
        "gather_f32": (rand32, {}),
    }
    measured, padded = phase_c(rt, kernels, ops)
    lap("C")

    # main paths: each runs with the counts set to 0 just before it and
    # read just after; `totals` adds them up per entry point
    totals = {}
    with Counted(kernels, totals):
        A, A_plain, b = phase_d(rt, kernels)
        phase_solve(rt, kernels, "E", f"random_banded_spd({RAND_N}) f64",
                    rand64, "gather_f64", 1e-8, 1e-6)
        phase_solve(rt, kernels, "F", f"random_banded_spd({RAND_N}) f32",
                    rand32, "gather_f32", 1e-5, 1e-3)
        phase_solve(rt, kernels, "F", f"laplacian_3d({LAP_N}) f32 unsplit",
                    lap32, "roll_f32", 1e-5, 1e-3)
    lap("D-F")
    phase_g(rt, {f"laplacian_3d({LAP_N}) f64 WJD": (A, b, None),
                 f"laplacian_3d({LAP_N}) f64 plain CSR": (A_plain, b, False)})
    phase_g_host(rt, kernels, A, A_plain)
    del A_plain, b
    lap("G")

    measured.update(phase_h(rt, kernels, totals, ops, measured, padded))
    lap("H")
    phase_j(rt, kernels, totals, lap64)
    lap("J")
    # phase N plans lap32 and rand32 again with bf16 values, and solves on
    # rand64
    del ops, padded, lap64, A
    torch.cuda.empty_cache()

    row, A = phase_i(
        rt, kernels, totals, f"laplacian_3d({WIN_LAP64_N}) f64 auto-attach",
        lambda: rt.laplacian_3d(WIN_LAP64_N), "win_roll_f64", None, 1e-8,
        1e-6)
    measured.update(row)
    del A
    torch.cuda.empty_cache()
    win_ops = {}
    for tag, make, key, rel_tol in (
            (f"laplacian_3d({WIN_LAP32_N}) f32 unsplit",
             lambda: rt.laplacian_3d(WIN_LAP32_N, dtype=np.float32),
             "win_roll_f32", 1e-6),
            (f"random_banded_spd({WIN_RAND_N}) f32",
             lambda: rt.random_banded_spd(WIN_RAND_N, dtype=np.float32),
             "win_gather_f32", 1e-5)):
        row, A = phase_i(rt, kernels, totals, tag, make, key, {}, rel_tol,
                         1e-3)
        measured.update(row)
        win_ops[tag] = (A, {})
        torch.cuda.empty_cache()
    lap("I")

    for name, phase in (("K", phase_k), ("L", phase_l), ("M", phase_m)):
        phase(rt, kernels, totals)
        lap(name)

    rows, bf16 = phase_n1(rt, kernels, totals, {
        f"laplacian_3d({LAP_N}) f32 unsplit": (lap32, {}),
        f"random_banded_spd({RAND_N}) f32": (rand32, {})}, win_ops)
    measured.update(rows)
    del win_ops
    torch.cuda.empty_cache()
    lap("N1")
    phase_n3(rt, kernels, totals, rand64, rand32,
             bf16[f"random_banded_spd({RAND_N}) f32"])
    del bf16, lap32, rand64, rand32
    torch.cuda.empty_cache()
    lap("N3")
    phase_n2(rt, kernels, totals)
    lap("N2")

    idle = [k for k in KERNELS if not totals.get(k)]
    if idle:
        raise RuntimeError(f"the main paths never launched {idle}")
    rows = [{"name": name, "route": "cuda", "source": CSRC + src,
             "replaces": f"{TPU}{line}", "launches": totals[key],
             **measured[key]} for key, (name, src, line) in KERNELS.items()]
    say("end", f"{time.perf_counter() - t_start:.0f} s in all")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
