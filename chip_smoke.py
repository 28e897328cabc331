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
       kernel held against its plain version, a profile of one V-cycle and
       one CG iteration; then its f32 conversion and the same again

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
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
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
# published peaks of one H100 SXM: HBM bytes/s, and flop/s outside the
# tensor cores by value type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
CSRC = "rocalution_tpu_torch/csrc/"
TPU = "rocalution_tpu/ops/pallas/spmv_wjd.py:"
# launch counter -> (entry point, source, line of the TPU kernel it replaces:
# _kernel_roll_ff, _kernel_ff, _kernel_roll, _kernel; _kernel_mrhs;
# _kernel_roll_ff_hbm, _kernel_roll_hbm, _kernel_hbm)
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
}
TAG = {torch.float64: "f64", torch.float32: "f32"}


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
    own_bytes_ms: the bytes of the layout the kernel streams (the slot
    planes with brow and diag_u, or the compact slice form; padded x; y),
    over the HBM rate."""
    isz = W.dtype.itemsize
    n, m = W.shape
    nnz = W.nnz - W.spill_row.numel()
    t_bytes = (nnz + (n + m) * cols) * isz / PEAK_BYTES * 1e3
    t_ops = 2 * nnz * cols / PEAK_FLOPS[W.dtype] * 1e3
    own = (kernels.slot_bytes(W, compact, through_windows)
           + (W.xp_len + W.brow.shape[0] * 1024) * isz * cols)
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
    direct kernel on the same plan."""
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
                  "library_ms": lib_ms, **b}}


def phase_j(rt, kernels, totals, lap, rand):
    """ELL, HYB and BCSR operands on the card go through a WJD plan once a
    solver's `as_operator` has seen them, and agree with the plain CSR
    apply; so do the plain COO and MCSR applies, and DENSE at a small
    size. ELL is shown on the Laplacian: two columns of the random banded
    matrix collect about 3,000 entries each (the generator clips columns
    at the border), so its ELL form would be 3,093 wide, 26 GB."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    tol = TOL[torch.float64]
    for fmt, kw, A, tag, key in (
            ("ELL", {}, lap, f"laplacian_3d({LAP_N})", "roll_f64"),
            ("HYB", {}, rand, f"random_banded_spd({RAND_N})", "gather_f64"),
            ("BCSR", {"block_dim": 4}, rand, f"random_banded_spd({RAND_N})",
             "gather_f64")):
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
    """Seconds spent in the WJD planner and in the compact builder while
    the context is open (the module functions are wrapped, then put back)."""

    NAMES = ("csr_to_wjd_plan", "compact_slices")

    def __enter__(self):
        import rocalution_tpu_torch.formats.wjd as wjd

        self.mod, self.saved, self.s = wjd, {}, dict.fromkeys(self.NAMES, 0.0)
        for name in self.NAMES:
            fn = self.saved[name] = getattr(wjd, name)
            setattr(wjd, name, self._timed(name, fn))
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
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def served_by(M):
    """How the card serves one level operator or transfer: its format, the
    entry point, and the plan's padding and spill."""
    from rocalution_tpu_torch.formats.wjd import windowed

    W = getattr(M, "_wjd_cache", None)
    if W is None:
        return f"{type(M).__name__}, plain torch ops"
    key = (f"{'win_' if windowed(W, W.dtype) else ''}{W.kernel_mode}_"
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


def unsplit_closure(rt, mg, h, A0):
    """A cycle closure over fresh copies of h's CSRs, placed on the card and
    each planned with split_dia=False: no diagonal leaves a level's or a
    transfer's slot plan for a plain DIA part."""
    hp = mg.place_hierarchy(plain_hierarchy(rt, mg, h, A0))
    for lv in hp.levels:
        for M in (lv.A, lv.P, lv.R):
            if isinstance(M, rt.CSR):
                rt.attach_wjd(M, split_dia=False)
    return mg.cycle_closure(hp)


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


def amg_phase(rt, kernels, mg, totals, h, A0, b, tag, rel_tol, err_tol,
              A0_plain, unsplit=False):
    """One hierarchy on the card: closure (placement, plans, coarse QR),
    how each operator is served, CG through the kernels, the same solve
    plain (fresh plan-free copies of the levels, auto_wjd off), both timed
    in turns, the transfers held against their plain versions, and where
    the time of a V-cycle and of a CG iteration goes on both paths. With
    `unsplit`, a third path plans every CSR with split_dia=False and is
    solved, timed and profiled beside the other two."""
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
        Mp = mg.cycle_closure(plain_hierarchy(rt, mg, h, A0_plain))
        it_p = amg_cg(rt, A0_plain, b, Mp, rel_tol, err_tol,
                      f"{tag} plain")[0]
    paths["plain"] = (A0_plain, Mp, Plain(rt))
    if any(cp.got.values()):
        raise RuntimeError(f"K {tag} plain: launched {cp.got}")
    if abs(it_p - it) > 1:
        raise RuntimeError(f"K {tag}: WJD {it} vs plain {it_p} iterations")
    turns = ("WJD", "plain", "plain", "WJD")
    unsplit_text = ""
    if unsplit:
        with Counted(kernels, {}) as cu:
            Mu = unsplit_closure(rt, mg, h, A0)
            it_u = amg_cg(rt, A0, b, Mu, rel_tol, err_tol,
                          f"{tag} WJD unsplit")[0]
        if abs(it_u - it) > 1:
            raise RuntimeError(f"K {tag}: WJD {it} vs unsplit {it_u} "
                               "iterations")
        paths["WJD unsplit"] = (A0, Mu, contextlib.nullcontext())
        turns = ("WJD", "plain", "WJD unsplit", "WJD unsplit", "plain",
                 "WJD")
        split = sum(len(M._wjd_cache.dia_offsets)
                    for lv in Mu.hierarchy.levels for M in (lv.A, lv.P, lv.R)
                    if isinstance(M, rt.CSR))
        unsplit_text = (f" | WJD unsplit (split_dia=False on every CSR, "
                        f"{split} diagonals split off): {it_u} iters, "
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
        f"iters, no launch{unsplit_text} | ms/iter in turns "
        + ", ".join(ms))
    hold_transfers(rt, kernels, M.hierarchy, tag)
    for path, (A_, M_, ctx) in paths.items():
        def cycles(k):
            for _ in range(k):
                M_(b)

        with ctx:
            text = device_profile(cycles, *AMG_PROF_CYCLES)
            say("K", f"{tag} {path}, one V-cycle: {text}")
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
    torch.cuda.empty_cache()

    # K3: its f32 conversion (the fine level becomes DIA)
    t0 = time.perf_counter()
    h32 = mg.convert_hierarchy(h, dtype=np.float32)
    say("K", f"K3 f32 conversion {time.perf_counter() - t0:.1f} s, levels "
        f"{[type(lv.A).__name__ for lv in h32.levels]}")
    del h, A_plain
    amg_phase(rt, kernels, mg, totals, h32, h32.levels[0].A, b.float(),
              "K3 f32", 1e-6, 1e-3, h32.levels[0].A, unsplit=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU and has no CPU mode")
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels

    t_start = time.perf_counter()
    phase_a()
    phase_b(kernels)

    # no device is named anywhere below: the port builds on the card
    lap64 = rt.laplacian_3d(LAP_N)
    lap32 = rt.laplacian_3d(LAP_N, dtype=np.float32)
    rand64 = rt.random_banded_spd(RAND_N)
    d, i, p = rand64.numpy_triplet()
    rand32 = rt.CSR.from_arrays(d.astype(np.float32), i, p, rand64.shape)
    ops = {
        "roll_f64": (lap64, {}),
        "gather_f64": (rand64, {}),
        "roll_f32": (lap32, {"split_dia": False}),
        "gather_f32": (rand32, {}),
    }
    measured, padded = phase_c(rt, kernels, ops)

    # main paths: each runs with the counts set to 0 just before it and
    # read just after; `totals` adds them up per entry point
    totals = {}
    with Counted(kernels, totals):
        A, A_plain, b = phase_d(rt, kernels)
        phase_solve(rt, kernels, "E", f"random_banded_spd({RAND_N}) f64",
                    rand64, "gather_f64", 1e-8, 1e-6)
        phase_solve(rt, kernels, "F", f"random_banded_spd({RAND_N}) f32",
                    rand32, "gather_f32", 1e-5, 1e-3)
        phase_solve(rt, kernels, "F", f"laplacian_3d({LAP_N}) f32 split_dia="
                    "False", lap32, "roll_f32", 1e-5, 1e-3)
    phase_g(rt, {f"laplacian_3d({LAP_N}) f64 WJD": (A, b, None),
                 f"laplacian_3d({LAP_N}) f64 plain CSR": (A_plain, b, False)})
    phase_g_host(rt, kernels, A, A_plain)
    del A_plain, b

    measured.update(phase_h(rt, kernels, totals, ops, measured, padded))
    phase_j(rt, kernels, totals, lap64, rand64)
    del ops, padded, lap64, lap32, rand64, rand32, A
    torch.cuda.empty_cache()

    measured.update(phase_i(
        rt, kernels, totals, f"laplacian_3d({WIN_LAP64_N}) f64 auto-attach",
        lambda: rt.laplacian_3d(WIN_LAP64_N), "win_roll_f64", None, 1e-8,
        1e-6))
    torch.cuda.empty_cache()
    measured.update(phase_i(
        rt, kernels, totals, f"laplacian_3d({WIN_LAP32_N}) f32 split_dia="
        "False", lambda: rt.laplacian_3d(WIN_LAP32_N, dtype=np.float32),
        "win_roll_f32", {"split_dia": False}, 1e-6, 1e-3))
    torch.cuda.empty_cache()
    measured.update(phase_i(
        rt, kernels, totals, f"random_banded_spd({WIN_RAND_N}) f32",
        lambda: rt.random_banded_spd(WIN_RAND_N, dtype=np.float32),
        "win_gather_f32", {}, 1e-5, 1e-3))
    torch.cuda.empty_cache()

    phase_k(rt, kernels, totals)

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
