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
  N    bfloat16 values and the rest of the Krylov family. N1: every
       bf16 kernel on bf16 plans of the f32 operators of C, H and I
       (direct, blocked right-hand sides, windowed; each gather plan, the
       direct and the windowed one, in the packed form, then in the
       compact form with 4-byte offsets, then with its offsets moved past
       16 bits in the packed24 form, held to the compact kernel on the
       same product too; single and 16 columns, each row naming the form
       and the kernel), each against its plain version,
       against the f32 plan's product, its bound and the library call,
       through rt.spmv. N2: BiCGStab, BiCGStab(2),
       QMRCGStab, IDR(4) on convection_diffusion_2d(1024) f64 and CR, FCG,
       the power method and Chebyshev on laplacian_3d(100) f64, through the
       kernels and plain, their launches held to their iterations. N3:
       MixedPrecisionDC on random_banded_spd(1<<20) f64 with an inner CG
       over a bf16 plan, beside the same solve over the f32 plan
  O    the rest of the preconditioner stack and Ruge-Stüben AMG in f64,
       through the kernels and plain. O1: CG + RS-AMG (greedy/direct on
       laplacian_2d(1024), a million rows, pmis/extpi on
       laplacian_2d(512)) and the device PMIS C/F split of
       laplacian_2d(1024)'s strength graph against the CPU's. O2: CG on
       laplacian_3d(80) with SGS, SSOR, multicoloured SGS and ILU(0, 1),
       FSAI, SPAI, TNS, AIChebyshev, BlockJacobi, AS, RAS and BSR-IC(0).
       O3: GMRES(30) on convection_diffusion_2d(724) with ILU(1), ILUT and
       BSR-ILU(0) (Jacobi-swept factors), FGMRES with ME(3) and a
       VariablePreconditioner. Each preconditioner's apply on the card is
       first held against the same preconditioner built and applied on the
       CPU, on a smaller operator of the row's family; then, at full size,
       the kernel apply of the operator and of every operand of the
       preconditioner with a plan against its plain versions, and one
       apply of the preconditioner against its plain path's. The two
       paths are timed in turns over a fixed count of iterations
  P    IO, the plan cache, complex operators and stencils. P1:
       laplacian_3d(100) and random_banded_spd(1<<20) f64
       written with write_csr and write_rocsparseio (the first with
       write_mtx too), read back onto the card bit for bit and solved with
       CG + Jacobi at phase D's and E's counts; the repo's fixtures (the
       golden rocsparseio file, CG + IC(0) and GMRES(30) + ILU(0) on the
       two MatrixMarket files to 1e-8). P2: laplacian_3d(128) planned cold
       and warm through a fresh plan cache, the warm plan through its
       kernels. P3: both operators plus 0.05j*T (T symmetric on the
       pattern) in complex128 and complex64 as ComplexWJDs: the product
       against its plain versions, the two layouts of a complex product
       timed, complex CG, GMRES(30) and BiCGStab through the kernels and
       plain. P4: CG on laplace3d_stencil(100), matrix-free, beside the
       same CG on the assembled operator
  Q    the distributed layer (rocalution_tpu_torch/parallel), its parts
       on the one card. Q1: laplacian_3d(100) over 8 and 4 parts in both
       halo modes: each part's interior kernel and the halo-exchange
       SpMV against their plain versions and the serial product, one
       launch a part an apply, CG + BlockJacobi(diagonal) at phase D's
       count through the kernels and plain, timed in turns, and an f32
       copy. Q2: the JAX dryrun's flagship, laplacian_3d_block(101) over
       8 parts (1,030,301 rows, never assembled), distributed SA-AMG
       setup with planned interiors and CG + V-cycle to 1e-5. Q3:
       laplacian_2d_block(256), V- and K-cycle, then RS and pairwise on
       16k rows against the serial hierarchy. Q4: BlockJacobi with local
       SPAI, FSAI, ILU(0), ILUT at 1M rows. Q5: CG over 4 processes on
       the card, one part each, over torch.distributed (gloo). Q6: the
       windowed branch of the stacked plan at full size:
       laplacian_3d(186) f64 (6,434,856 rows) over 2 parts from per-part
       row blocks, each part past the stacked rule's 3,145,728 columns:
       one win_roll_f64 launch a part an apply, held to plain, then CG +
       BlockJacobi(diagonal) through the kernels and plain
  R    the bench CLI and the client samples. R1: bench_cli.main on
       laplacian_3d(100) f64 (CG, BiCGStab, GMRES + Jacobi, then SA-AMG),
       its plan read back from the run's plan cache; each case's engine
       must name kernel entry points, and its count and status are held
       to the same case with auto-attach off. R2: every sample of
       clients/samples_torch run in this process at its own size
       (poisson3d_large at 1M rows, poisson3d_dist at 2.1M rows over 8
       parts: its 256^3 default is cut for time), each held to its own
       check and, where it solves a CSR operator on the card, to at
       least one kernel launch

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
import inspect
import io
import json
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
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
WIDEN = 1 << 16             # N1: a direct slice's base lowered by this many
WIDEN_ROWS = 512            # elements, a step window widened by this many
                            # rows below: offsets past 16 bits (packed24)
N2_CD_N = 1024              # phase N2: convection_diffusion_2d(1024) f64
N2_LAP_N = 100              # and laplacian_3d(100) f64
N2_MAX_ITER = 1000          # the samples' settings (Chebyshev: 2000)
N2_POWER_ITERS = 200
O_RS_N = 1024               # phase O1: laplacian_2d(1024), 1,048,576 rows
O_RS_PMIS_N = 512           # pmis/extpi on laplacian_2d(512) (its levels
                            # stall near 8.7k rows, a large coarse solve)
# phases O2 and O3 at half a million rows: their setups and level-scheduled
# sweeps are host work, and at a million rows (laplacian_3d(100),
# convection_diffusion_2d(1024)) phase O alone took 342 s of a 1268 s run
# on a slow host, past the run's 1200 s limit
O_LAP_N = 80                # phase O2: laplacian_3d(80) f64, 512,000 rows
O_CD_N = 724                # phase O3: convection_diffusion_2d(724) f64,
                            # 524,176 rows
O_CHECK_LAP_N = 24          # phase O: the card-against-CPU apply of each
O_CHECK_CD_N = 96           # preconditioner, on laplacian_3d(24) (13,824
                            # rows) or convection_diffusion_2d(96) (9,216)
O_CG = dict(rel_tol=1e-8, max_iter=2000)
CARD = "cuda"               # the device of phase O's card-side builds
O_GMRES = dict(basis_size=30, rel_tol=1e-6, max_iter=600)
O_VAR_MAX_ITER = 30         # the variable row: its SGS branch sweeps the
                            # 2 x (2 O_CD_N - 1) levels of its schedules
O_RS_PMIS_MAX_ITER = 100    # pmis/extpi: CG stalls on its inexact coarse
                            # solve (status 4 at 200 too)
O_ERR = 1e-6                # |x-1|/|1| bound of the CG rows (phase D's)
O_STALL_TOL = 1e-6          # a row stopping at max_iter on both paths: its
                            # two final relative residuals, relative apart
O_TIME_ITERS = 24           # phases O, P3, P4: iterations a timed solve (a
                            # multiple of FACTOR_CHECK_EVERY and of the
                            # variable preconditioner's 3 branches; at 12
                            # a solve's fixed start-up costs showed in
                            # ms/iter)
TURNS = ("WJD", "plain", "plain", "WJD")  # phases K-Q: timed solves in turns
P_LAP_N = 100               # phase P: laplacian_3d(100) f64, 1,000,000 rows
P_RAND_N = 1 << 20          # and random_banded_spd(1<<20) f64, 1,048,576
P_CACHE_N = 128             # P2: laplacian_3d(128), 2,097,152 rows
P_IMAG = 0.05               # P3: A = S + 1j*P_IMAG*T (samples complex_solve)
# P3: ||y - y_csr|| / ||y_csr|| of a ComplexWJD product (the JAX test's
# bars), the solves' rel_tol and the CG rows' |x-1|/|1| bound
P_TOL = {torch.complex128: 1e-13, torch.complex64: 2e-5}
P_REL_TOL = {torch.complex128: 1e-8, torch.complex64: 1e-5}
P_ERR = {torch.complex128: 1e-6, torch.complex64: 1e-3}
P_MAX_ITER = {"cg": 2000, "gmres": 600, "bicgstab": 1000}
# P3: the relative change of b that shows a count's own rounding (N2's
# 1e-15 in f64; a few units of the last place in f32)
P_NUDGE = {torch.complex128: 1e-15, torch.complex64: 1e-6}
P_HIST_TOL = 1e-10          # P4: the stencil CG's history against the CSR's
Q_LAP_N = 100               # Q1, Q4, Q5: laplacian_3d(100), 1,000,000 rows
Q_PARTS = (8, 4)            # Q1: parts (Q2-Q4: the first)
Q_APPLY_TOL = 1e-14         # Q1: shard_spmv against plain and serial
Q_AMG_N = 101               # Q2: laplacian_3d_block(101), 1,030,301 rows
Q_2D_N = 256                # Q3: laplacian_2d_block(256), 65,536 rows
Q3_N = 128                  # Q3: RS and pairwise on 16,384 rows
Q_CHECK_N = 24              # Q4: the card-against-CPU BlockJacobi apply
Q_PROCS = 4                 # Q5: processes (one part each) on the card
Q5_TIMEOUT_S = 300
Q5_WORKER = [sys.executable, os.path.abspath(__file__), "--q5-worker"]
Q_WIN_N = 186               # Q6: laplacian_3d(186), 6,434,856 rows, over
Q_WIN_PARTS = 2             # 2 parts of 3,217,428 columns: windowed
R_LAP_N = 100               # R1: bench_cli on laplacian_3d(100) f64
R1_CASES = (("cg,bicgstab,gmres", "jacobi"), ("saamg", "none"))
# R1: iterations the kernel path may differ from plain (phase N2's rule:
# BiCGStab's count is ruled by rounding, so only its status is held)
R1_SLACK = {"cg": 1, "gmres": 2, "saamg": 1, "bicgstab": None}
SAMPLES = "clients/samples_torch/"
# R2: env of the samples not run at their own default size
R2_ENV = {"poisson3d_large": {"POISSON_N": "100"},
          "poisson3d_dist": {"POISSON_N": "128", "PARTS": "8"}}
# R2: samples that demonstrate something other than a convergent solve
# (tests/test_clients.py): their own printed check is the check
R2_NO_CONVERGENCE_CHECK = {
    "key", "simple_spmv", "power_method", "benchmark", "benchmark_dist",
    "async_transfer", "cmk", "global_io", "laplace_2d_weak_scaling",
    "laplace_3d_weak_scaling"}
# R2: samples that solve no CSR operator through a solver in this process
# (or turn the plans off), so no kernel counter need move
R2_NO_KERNEL = {
    "key": "no solve", "simple_spmv": "rt.spmv without a solver",
    "benchmark": "rt.spmv of DIA/ELL/HYB without a solver",
    "direct": "dense solvers", "stencil": "matrix-free operator",
    "global_cg_amg": "wjd=False, as the JAX sample",
    "global_io": "read_global_csr gives a GlobalCSR without interior plans",
    "multiprocess_cg": "its solves run in its worker processes"}
PLAN_CACHE_ENV = "ROCALUTION_TPU_TORCH_PLAN_CACHE"
FIXTURES = "tests/fixtures/"
REPS = 10
SPIN_CYCLES = 20_000_000    # ~10 ms at ~2 GHz: outlasts one call's launches
PROF_WALL_ITERS = 128       # phases G, Q1: CG iterations timed on the host
PROF_ITERS = 32             # clock, and under torch.profiler
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
AMG_PROF_CYCLES = (10, 3)   # phase K: V-cycles timed unprofiled, profiled
AMG_PROF_ITERS = (4, 2)     # phase K: CG iterations timed the same ways
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
FACTOR_PROF = (4, 2)        # phases L, M: iterations timed, profiled (a
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
# replace the same kernels run on bfloat16 values. The bf16 gather kernels
# go by form: gather_bf16, spmm_gather_bf16 and win_gather_bf16 are the
# packed form's (a bf16 plan with 2-byte offsets, direct or windowed), the
# *_packed24 rows the packed24 form's (offsets below 2**24: a high byte a
# word), the *_compact rows the compact form's (4-byte offsets).
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
    "roll_bf16": ("wjd_spmv_roll_bf16", "spmv_wjd_win.cu", 183),
    "gather_bf16": ("wjd_spmv_gather_bf16_packed", "wjd_bf16_packed.cu", 137),
    "spmm_roll_bf16": ("wjd_spmm_roll_bf16", "spmm_wjd.cu", 448),
    "spmm_gather_bf16": ("wjd_spmm_gather_bf16_packed", "wjd_bf16_packed.cu",
                         448),
    "gather_bf16_compact": ("wjd_spmv_gather_bf16", "spmv_wjd.cu", 137),
    "spmm_gather_bf16_compact": ("wjd_spmm_gather_bf16", "spmm_wjd.cu", 448),
    "win_roll_bf16": ("wjd_spmv_win_roll_bf16", "spmv_wjd_win.cu", 233),
    "win_gather_bf16": ("wjd_spmv_win_gather_bf16_packed",
                        "wjd_bf16_packed.cu", 310),
    "win_gather_bf16_compact": ("wjd_spmv_win_gather_bf16",
                                "spmv_wjd_win.cu", 310),
    "gather_bf16_packed24": ("wjd_spmv_gather_bf16_packed24",
                             "wjd_bf16_packed.cu", 137),
    "spmm_gather_bf16_packed24": ("wjd_spmm_gather_bf16_packed24",
                                  "wjd_bf16_packed.cu", 448),
    "win_gather_bf16_packed24": ("wjd_spmv_win_gather_bf16_packed24",
                                 "wjd_bf16_packed.cu", 310),
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
    """b = A @ 1 from the host triplet (no device SpMV involved); complex
    values too."""
    d, _, p = A.numpy_triplet()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(p))
    b = np.bincount(rows, weights=d.real, minlength=A.shape[0])
    if np.iscomplexobj(d):
        b = b + 1j * np.bincount(rows, weights=d.imag, minlength=A.shape[0])
    return torch.from_numpy(b.astype(d.dtype)).to(A.device)


def host64(v):
    """A tensor on the host as f64, or complex128 for a complex one."""
    return v.cpu().numpy().astype(np.complex128 if v.is_complex()
                                  else np.float64)


@contextlib.contextmanager
def plan_cache(path):
    """The port's on-disk plan cache at `path` while open (off after)."""
    os.environ[PLAN_CACHE_ENV] = path
    try:
        yield
    finally:
        os.environ[PLAN_CACHE_ENV] = "0"


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


def with_planes(rt, A, attach_kw):
    """A gather-mode plan on the card is served from its compact form and
    carries no slot planes. Plan A once more on the host and return the
    attached plan with the padded planes beside its compact form, so that
    the padded slot product can be computed on the card; the seconds the
    plan took (a read of the plan cache, where the attach wrote it) and
    the seconds compacting took."""
    from rocalution_tpu_torch.formats.wjd import (compact_slices,
                                                  csr_to_wjd_plan)

    t0 = time.perf_counter()
    plan = csr_to_wjd_plan(*A.numpy_triplet(), A.shape, **attach_kw)
    t1 = time.perf_counter()
    compact_slices(plan)
    t2 = time.perf_counter()
    W_pad = dataclasses.replace(A._wjd_cache, **{
        k: torch.from_numpy(plan[k]).cuda() for k in ("data", "uloc")})
    return W_pad, t1 - t0, t2 - t1


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


def phase_c(rt, kernels, ops, plans):
    """Direct kernel against plain version on the card, per entry point.
    Roll mode: the slot product over the planes. Gather mode: the product
    over the compact slice form, against its plain version and against the
    padded slot product. The plans go through the plan cache at `plans`,
    so `with_planes` reads back what the attach planned. Returns the rows
    and, per gather key, what `with_planes` built on the card (phase H
    uses it again)."""
    results, padded = {}, {}
    for key, (A, attach_kw) in ops.items():
        t0 = time.perf_counter()
        with plan_cache(plans):
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
            with plan_cache(plans):
                W_pad, plan_s, compact_s = with_planes(rt, A, attach_kw)
            _, rel_p = rel_err(y, kernels.slots_plain(W_pad, xp),
                               f"{key} vs padded slot product", tol)
            rel_err(kernels.wjd_spmv(W, x), kernels.wjd_reference(W_pad, x),
                    f"{key} full op vs padded", tol)
            padded[key] = W_pad
            extra = (f" (when done again: the plan read back from the plan "
                     f"cache in {plan_s:.1f} s, {compact_s:.1f} s compacting)"
                     f" | compact form "
                     f"{W.cval.numel()} elements, padding "
                     f"{W.compact_padding_ratio:.3f}x, "
                     f"{W.coff.element_size()}-byte offsets | vs padded slot "
                     f"product {rel_p:.3e}")
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
    err = float(np.linalg.norm(host64(x) - 1.0) / np.sqrt(x.shape[0]))
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
    return A, A_plain, b, (int(info.status), it)


def phase_solve(rt, kernels, phase, tag, A, key, rel_tol, err_tol):
    b = rhs_of_ones(A)
    before = kernels.launches[key]
    x, info, s = solve(rt, A, b, rel_tol=rel_tol, max_iter=2000)
    it, err = check_solve(f"{phase} {tag}", x, info, 2, err_tol)
    n_l = need_launches(kernels, key, before, it)
    say(phase, f"{tag} CG+Jacobi rel_tol {rel_tol:g}: {it} iters (status "
        f"2, |x-1|/|1|={err:.2e}, {n_l} {key} launches) "
        f"{s / it * 1e3:.3f} ms/iter")
    return int(info.status), it


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
            _, rel_p = rel_err(y_k, kernels.slots_plain_mrhs(padded[key], xp),
                               f"spmm_{key} vs padded slot product", tol)
            layouts = f"vs padded slot product {rel_p:.3e}"
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
                rel_err(Y[k], kernels.wjd_reference(padded[key], X[k]),
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
            err_tol, plans):
    """One operator in the windowed regime: CG + Jacobi through rt.cg (with
    attach_kw=None the plan comes from the solver's auto-attach alone),
    then the windowed kernel against its plain version, timed beside the
    direct kernel on the same plan. An attach goes through the plan cache
    at `plans`, so `with_planes` reads back what it planned. Returns the
    kernel row and the operator (phase N1 plans it again with bf16
    values)."""
    from rocalution_tpu_torch.formats.wjd import windowed

    t0 = time.perf_counter()
    A = make()
    gen_s = time.perf_counter() - t0
    b = rhs_of_ones(A)
    t0 = time.perf_counter()
    if attach_kw is not None:
        with plan_cache(plans):
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
        with plan_cache(plans):
            W_pad, plan_s, compact_s = with_planes(rt, A, attach_kw)
        _, rel_p = rel_err(y_k, kernels.slots_plain(W_pad, xp),
                           f"{key} vs padded slot product", tol)
        del W_pad
        if not torch.equal(y_k, kernels.slots_kernel(W, xp)):
            raise RuntimeError(f"{key}: not the direct compact kernel's "
                               "sums, bit for bit")
        extra = (f" | compact form {W.cval.numel()} elements, padding "
                 f"{W.compact_padding_ratio:.3f}x, {W.coff.element_size()}"
                 f"-byte window-relative offsets (when done again: the plan "
                 f"read back from the plan cache in {plan_s:.1f} s, "
                 f"{compact_s:.1f} s compacting); vs padded "
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


def plan_key(W, family=None):
    """The launch counter of the entry point that serves the plan W (a
    single right-hand side, or `family` "spmm_"); a bf16 gather plan's
    goes by its form (KERNELS)."""
    from rocalution_tpu_torch.formats.wjd import windowed

    if family is None:
        family = "win_" if windowed(W, W.x_dtype) else ""
    key = f"{family}{W.kernel_mode}_{TAG[W.dtype]}"
    if W.dtype == torch.bfloat16 and W.compact_form in ("compact",
                                                         "packed24"):
        key += "_" + W.compact_form
    return key


def served_by(M):
    """How the card serves one level operator or transfer: its format, the
    entry point, and the plan's padding and spill."""
    W = getattr(M, "_wjd_cache", None)
    if W is None:
        return f"{type(M).__name__}, plain torch ops"
    Tp, K = W.brow.shape
    text = (f"CSR nnz={M.nnz} -> WJD {W.kernel_mode} (Tp,K)=({Tp},{K}) "
            f"wlog={W.wlog}, {KERNELS[plan_key(W)][0]}, padding "
            f"{W.padding_ratio:.2f}x")
    if W.dia_offsets:
        text += f", {len(W.dia_offsets)} diagonals split off to plain DIA"
    spill = W.spill_row.numel()
    if W.kernel_mode == "gather":
        text += ", " + form_text(W)
    return text + f", spill {spill} ({spill / max(M.nnz, 1):.3f} of nnz)"


def form_text(W):
    """Which form a gather plan's direct kernels read, and its stored
    elements (words of the packed form) a slot entry."""
    stored = W.cval if W.cpack is None else W.cpack
    per = stored.numel() / max(W.nnz - W.spill_row.numel(), 1)
    if W.chi is not None:
        return (f"packed24 form {stored.numel()} words and high bytes, "
                f"{per:.3f} a slot entry (bf16 value | offset bits 0-15, "
                "a byte of bits 16-23)")
    if W.cpack is not None:
        return (f"packed form {stored.numel()} words, {per:.3f} a slot "
                "entry (bf16 value | 2-byte offset)")
    return (f"compact form {stored.numel()} elements, {per:.3f} a slot "
            f"entry, {W.coff.element_size()}-byte offsets")


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


def hold_parts(rt, kernels, phase, tag, parts):
    """The kernel apply of each (name, operand) in `parts` that carries a
    WJD plan against the plan's plain product and the plain CSR apply of
    the same triplet, on the same x, at TOL; raises on a disagreement, or
    if no part has a plan. These launches are not the main path's. Returns
    the agreements as text."""
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


def hold_transfers(rt, kernels, h, tag):
    """Every transfer's kernel against its plain version on that operand
    (`hold_parts`), at full size; the finest P and R timed beside the
    plan's plain product and the library call."""
    lv = h.levels
    held = hold_parts(rt, kernels, "K", tag, [
        (f"{name}{l}", M) for l in range(len(lv) - 1)
        for name, M in (("P", lv[l].P), ("R", lv[l].R))])
    times = []
    for name, M in (("P0", lv[0].P), ("R0", lv[0].R)):
        W = M._wjd_cache
        x = random_x(rt, M, W.dtype)
        k_ms = median_ms(lambda: kernels.wjd_spmv(W, x))
        p_ms = median_ms(lambda: kernels.wjd_reference(W, x))
        plain_csr = rt.CSR.from_arrays(*M.numpy_triplet(), M.shape)
        lib_ms = library_ms(plain_csr, x)
        times.append(f"{name} apply {k_ms * 1e3:.1f} us, plain "
                     f"{p_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us")
        del plain_csr
    say("K", f"{tag}: each transfer's kernel vs the plan's plain product / "
        f"the plain CSR apply, max|dy|/max|y| (tol "
        f"{TOL[lv[0].P._wjd_cache.dtype]:g}): {held} | " + "; ".join(times))


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
    bh = host64(b)
    return float(np.linalg.norm(bh - S @ host64(x)) / np.linalg.norm(bh))


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
    """`hold_parts` over a factorization row's operator and each factor's
    off-diagonal part (where the factors are swept)."""
    parts = [("operator", Op)]
    if M.schedules is None:
        parts += [(f"{name} off-diagonal part", T._offd_cache)
                  for name, T in zip(("lower", "upper"), M.factors)]
    return hold_parts(rt, kernels, phase, tag, parts)


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
    iterations timed and profiled (default FACTOR_PROF); time_iters = the
    iterations of each timed solve (default: the whole solve); the paths
    are timed in turns (TURNS) after the counted solves. Before the solve,
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
    time_kw = kw if spec.get("time_iters") is None else dict(
        kw, rel_tol=1e-30, max_iter=spec["time_iters"])
    ms = []
    for path in TURNS:
        Op_, M_, ctx = paths[path]
        with ctx:
            (_, inf_), s = timed(lambda: solver(Op_, b, M=M_, **time_kw))
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
           if spec["tol"] is None else "")
        + " | ms/iter in turns"
        + (f" over {spec['time_iters']} iterations"
           if spec.get("time_iters") else "") + " " + ", ".join(ms))
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
             # an iteration is ~8,600 device ops (~150 ms): profile two;
             # and time 12 iterations a solve in turns, not whole solves
             # (~10 s each), so that the whole run keeps its time with
             # phases N and Q added
             prof=(2, 1), time_iters=12)),
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


def bf16_row(rt, kernels, totals, tag, A, B, key, made, twin=None):
    """One bf16 single-RHS kernel (direct or windowed) on B's plan: against
    its plain version and the f32 plan's product (A's), timed beside the
    f32 kernel on the same x, its bound and the library call; then the
    main path, rt.spmv(B, x) with an f32 and a bf16 x. `made` says how
    B's plan was made. `twin`, a CSR whose plan is the same product in
    another form: its kernel too, held to this one and timed."""
    from rocalution_tpu_torch.formats.wjd import windowed

    W, W32 = B._wjd_cache, A._wjd_cache
    win = windowed(W, W.x_dtype)
    if W.dtype != torch.bfloat16 or key != plan_key(W):
        raise RuntimeError(f"N1 {tag}: the bf16 plan ({W.dtype}, "
                           f"{W.kernel_mode}, windowed {win}, form "
                           f"{W.compact_form}) is not {key}'s")
    gather = W.kernel_mode == "gather"
    launch = kernels.slots_kernel_windowed if win else kernels.slots_kernel
    if gather:
        plain = kernels.plain_gather(W)
    else:
        plain = kernels.slots_plain_windowed if win else kernels.slots_plain
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
    twin_text = "" if twin is None else twin_line(
        kernels, key, twin._wjd_cache, launch, launch(W, xp), x)
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
    form = (f"{form_text(W)} ({W.compact_padding_ratio:.3f}x of nnz)"
            if gather else f"planes (Tp,K)=({Tp},{K})")
    say("N1", f"{key}: {tag} n={A.shape[0]} nnz={A.nnz} bf16 plan {form}, "
        f"kernel {KERNELS[key][0]}, "
        f"{made} | vs plain {rel_p:.3e} (tol {BF16_TOL:g}),"
        f" vs the f32 plan {rel_32:.3e} (tol {BF16_VS_F32_TOL:g}), a bf16 x "
        f"vs an f32 one {rel_x:.3e} (norm-wise) | kernel {k_ms * 1e3:.1f} us "
        f"(the f32 plan's kernel on the same x {k32_ms * 1e3:.1f} us), "
        f"{bounds_text(b)}, plain {p_ms * 1e3:.1f} us, {lib_note} "
        f"{lib_ms * 1e3:.1f} us{twin_text} | rt.spmv(B, x): {c.got[key]} "
        "launches")
    return {key: {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, **b}}


def twin_line(kernels, key, Wt, launch, y, X):
    """Text of a kernel on the same product in another form (Wt) than the
    row's: launched on X padded for Wt, held to the row's kernel's y at
    BF16_TOL, and timed."""
    cols = X.shape[1] if X.dim() == 2 else 0
    xt = kernels.pad_x(Wt, X, cols)
    fam = "spmm_" if cols else None
    _, rel = norm_err(y, launch(Wt, xt), f"{key} vs {plan_key(Wt, fam)}",
                      BF16_TOL)
    t_ms = median_ms(lambda: launch(Wt, xt))
    return (f" | the same product through {KERNELS[plan_key(Wt, fam)][0]} "
            f"({form_text(Wt)}): vs this kernel {rel:.3e} (tol "
            f"{BF16_TOL:g}), {t_ms * 1e3:.1f} us")


def bf16_spmm_row(rt, kernels, totals, tag, A, B, key, twin=None):
    """The bf16 SpMM kernel on N_COLS columns of row-major X, as bf16_row
    holds the single-RHS ones; the main path rt.spmv(B, X)."""
    W, W32 = B._wjd_cache, A._wjd_cache
    gather = W.kernel_mode == "gather"
    if W.dtype != torch.bfloat16 or key != plan_key(W, "spmm_"):
        raise RuntimeError(f"N1 {tag}: the bf16 plan is not {key}'s")
    plain = (kernels.plain_gather(W, mrhs=True) if gather
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
    twin_text = "" if twin is None else twin_line(
        kernels, key, twin._wjd_cache, kernels.slots_kernel_mrhs,
        kernels.slots_kernel_mrhs(W, xp), X)
    with Counted(kernels, totals) as c:
        Y = rt.spmv(B, X)
    if c.got[key] != 1 or sum(c.got.values()) != 1:
        raise RuntimeError(f"N1 {key}: rt.spmv launched {c.got}")
    norm_err(Y, kernels.wjd_spmm(W32, X), f"N1 {key} rt.spmv",
             BF16_VS_F32_TOL)
    form = form_text(W) if gather else "slot planes"
    say("N1", f"{key}: {tag} k={N_COLS}, X row-major, {form}, kernel "
        f"{KERNELS[key][0]} | vs plain {rel_p:.3e} "
        f"(tol {BF16_TOL:g}), vs the f32 plan {rel_32:.3e} (tol "
        f"{BF16_VS_F32_TOL:g}) | kernel {k_ms * 1e3:.1f} us (the f32 plan's "
        f"{k32_ms * 1e3:.1f} us), {bounds_text(b)}, plain "
        f"{p_ms * 1e3:.1f} us, {lib_note} {lib_ms * 1e3:.1f} us{twin_text} "
        f"| rt.spmv(B, X): {c.got[key]} launch")
    return {key: {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, **b}}


def unpacked(W):
    """The compact arrays (`compact_slices`' bit for bit) of W's packed
    form, unpacked on the host (`unpack_bf16_slices`), and the seconds it
    took."""
    from rocalution_tpu_torch.formats.wjd import unpack_bf16_slices

    t0 = time.perf_counter()
    c = unpack_bf16_slices(*(t.cpu().numpy() for t in (
        W.cpack, W.slice_ptr, W.xbase)))
    return c, time.perf_counter() - t0


def copy_with(A, W):
    """A CSR on A's arrays (device tensors and host cache shared) whose
    plan is W."""
    from rocalution_tpu_torch.formats.base import set_host_cache

    B = dataclasses.replace(A)
    set_host_cache(B, **A._host_cache)
    object.__setattr__(B, "_wjd_cache", W)
    return B


def window_fields(W, wb, win_rows, xp_len):
    """The plan fields `_check_compact_windows` reads, for step windows wb
    of win_rows rows in padded x of xp_len."""
    return {"win_base": wb, "win_rows": win_rows, "group": W.group,
            "xp_len": xp_len}


def compact_copy(W, c):
    """W's packed bf16 plan in the compact form with 4-byte offsets, c
    (`unpacked`): the form, and so the kernels, that a bf16 plan whose
    offsets pass 24 bits takes (formats/wjd.py), here at the size of the
    packed plan; the seconds it took. A window-relative plan stays
    window-relative, and its compact form is held to its step windows as
    at upload (`_check_compact_windows`)."""
    from rocalution_tpu_torch.formats.wjd import _check_compact_windows

    t0 = time.perf_counter()
    if W.window_relative:
        _check_compact_windows(c, window_fields(
            W, W.win_base.cpu().numpy(), W.win_rows, W.xp_len))
    dev = W.cpack.device
    Wc = dataclasses.replace(
        W, cpack=None, slice_ptr=torch.from_numpy(c["slice_ptr"]).to(dev),
        cval=torch.from_numpy(c["cval"]).to(dev).to(torch.bfloat16),
        coff=torch.from_numpy(c["coff"].astype(np.int32)).to(dev))
    return Wc, time.perf_counter() - t0


def widened(W, c):
    """W's packed bf16 plan with its offsets moved past 16 bits: the same
    product in the packed24 form (formats/wjd.py), which a natural plan of
    this size would take where its slices or windows were wider. A direct
    slice's base xbase is lowered by WIDEN elements where it stays >= 0, a
    step's window by up to WIDEN_ROWS rows (win_base lowered, win_rows
    raised by WIDEN_ROWS, xp_len where the last window would pass it), and
    each real entry's offset raised by as much. From W's compact arrays c
    (`unpacked`), packed by `pack_bf16_slices` and held, as at upload, to
    padded x and its step windows; the seconds it took."""
    from rocalution_tpu_torch.formats.wjd import (_check_compact_reach,
                                                  _check_compact_windows,
                                                  pack_bf16_slices)

    t0 = time.perf_counter()
    per = np.diff(c["slice_ptr"])
    fields, xp_len = {}, W.xp_len
    if W.window_relative:
        wb = W.win_base.cpu().numpy().astype(np.int64)
        low = np.minimum(wb, WIDEN_ROWS)
        wb = wb - low
        win_rows = W.win_rows + WIDEN_ROWS
        xp_len = max(xp_len, (int(wb.max()) + win_rows) * 128)
        steps = W.group * 32
        shift = np.repeat(low * 128, steps)
        fields = {"win_base": torch.from_numpy(wb.astype(np.int32)).to(
            W.win_base.device), "win_rows": win_rows, "xp_len": xp_len}
    else:
        shift = np.where(c["xbase"] >= WIDEN, WIDEN, 0)
    coff = c["coff"].astype(np.int32) + np.repeat(shift, per).astype(
        np.int32)
    coff[c["cval"] == 0] = 0                           # padding of short rows
    wide = {**c, "coff": coff, "xbase": c["xbase"] - shift}
    packed = pack_bf16_slices(wide)
    if "chi" not in packed:
        raise RuntimeError("N1: the widened plan's offsets stay in 16 bits")
    if W.window_relative:
        _check_compact_windows(packed, window_fields(
            W, fields["win_base"].cpu().numpy(), win_rows, xp_len))
    _check_compact_reach(packed, xp_len)
    dev = W.cpack.device
    Ww = dataclasses.replace(W, **fields, **{
        k: torch.from_numpy(packed[k].view(np.int32) if k == "cpack"
                            else packed[k]).to(dev)
        for k in ("cpack", "chi", "slice_ptr", "xbase")})
    return Ww, time.perf_counter() - t0


def phase_n1(rt, kernels, totals, direct, windowed_ops, plans):
    """Every bf16 kernel on bf16 plans of f32 operators that earlier
    phases built and planned in f32: `direct` {tag: (A, attach_kw)} of C
    and H (one roll, one gather), `windowed_ops` {tag: (A, attach_kw)} of
    I. The bf16 plans go through the plan cache at `plans`, where C and I
    left the f32 plans: each is the f32 plan with its values rounded
    (formats/wjd.py), so the layout is not planned again. A gather plan
    takes the packed form (2-byte offsets; window-relative in I's regime);
    its compact form with 4-byte offsets then holds the compact bf16
    kernels of the same regime, and the same plan with its offsets moved
    past 16 bits (`widened`) the packed24 kernels, each also held
    to the compact kernel on the same product. Each form of a gather plan
    holds its single product and its SpMM (N_COLS columns; the windowed
    plan's through xbase, which holds its step windows); a roll plan its
    single product, and its SpMM where it is direct. Returns the kernel
    rows (an SpMM's row is the direct plan's; the windowed plan's SpMMs
    are printed) and the bf16 copies of `direct`."""
    rows, copies = {}, {}
    for tag, (A, kw) in {**direct, **windowed_ops}.items():
        with plan_cache(plans):
            B, plan_s = bf16_copy(rt, A, kw)
        win = tag in windowed_ops
        forms = [(B, f"planned in {plan_s:.1f} s", None)]
        if B._wjd_cache.compact_form == "packed":
            c, unpack_s = unpacked(B._wjd_cache)
            Wc, copy_s = compact_copy(B._wjd_cache, c)
            Ww, wide_s = widened(B._wjd_cache, c)
            Bc, Bw = copy_with(A, Wc), copy_with(A, Ww)
            del c, Wc, Ww
            forms += [(Bc, f"its packed plan unpacked, offsets widened, "
                           f"in {unpack_s + copy_s:.1f} s", None),
                      (Bw, f"its packed plan with offsets moved past 16 "
                           f"bits (a slice base lowered by {WIDEN} "
                           f"elements, or a window by up to {WIDEN_ROWS} "
                           f"rows), in {unpack_s + wide_s:.1f} s", Bc)]
        for Bf, made, twin in forms:
            Wf = Bf._wjd_cache
            if plan_key(Wf).startswith("win_") != win:
                raise RuntimeError(f"N1 {tag}: the bf16 plan's kernel "
                                   f"{plan_key(Wf)} is not in the f32 "
                                   "plan's regime")
            rows.update(bf16_row(rt, kernels, totals, tag, A, Bf,
                                 plan_key(Wf), made, twin))
            if win and Wf.kernel_mode == "roll":
                continue
            spmm = bf16_spmm_row(rt, kernels, totals, tag, A, Bf,
                                 plan_key(Wf, "spmm_"), twin)
            if not win:
                rows.update(spmm)
        if not win:
            copies[tag] = B
        del forms, B
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
    want = {plan_key(A._wjd_cache): n_op}
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


def o_check(phase, tag, make_small, build, applies):
    """One apply (`applies` for a variable preconditioner: each branch) of
    the preconditioner built on the card against the same preconditioner
    built and applied on the CPU, on make_small(device), at TOL. These
    launches are not the main path's."""
    A_card, A_cpu = make_small(CARD), make_small("cpu")
    M_card, M_cpu = build(A_card), build(A_cpu)
    r = np.random.default_rng(11).standard_normal(A_cpu.shape[0])
    r_cpu = torch.from_numpy(r)
    worst = 0.0
    for _ in range(applies):
        want = M_cpu(r_cpu).to(CARD)
        _, rel = rel_err(M_card(r_cpu.to(CARD)), want,
                         f"{phase} {tag} card vs CPU apply",
                         TOL[torch.float64])
        worst = max(worst, rel)
    return f"n={A_cpu.shape[0]} {worst:.1e}"


def o_launches(kernels, M, n, applies):
    """{kernel: launches} of `applies` applies of M (one cycle of a
    variable preconditioner) to a vector of n, after one warm-up cycle."""
    r = torch.ones(n, dtype=torch.float64, device=CARD)
    for _ in range(applies):
        M(r)
    with Counted(kernels, {}) as c:
        for _ in range(applies):
            M(r)
    torch.cuda.synchronize()
    return {k: n for k, n in c.got.items() if n}


def plan_parts(M):
    """(path, operand) for every operand with a WJD plan that the
    preconditioner closure M reaches: through its closure cells (named by
    their variables), function attributes (`matrices`, `factors`,
    `hierarchy`), lists, tuples and dicts, the port's own objects
    (hierarchy levels, smoothers) and each factor's off-diagonal part
    (`_offd_cache`). Each operand once."""
    parts, seen = [], set()
    stack = [("M", M)]
    leaves = (torch.Tensor, np.ndarray, str, bytes, int, float, type(None),
              type)
    while stack:
        path, obj = stack.pop()
        if id(obj) in seen or isinstance(obj, leaves):
            continue
        seen.add(id(obj))
        if getattr(obj, "_wjd_cache", None) is not None:
            parts.append((path, obj))
        if isinstance(obj, (list, tuple)):
            kids = [(f"{path}[{i}]", v) for i, v in enumerate(obj)]
        elif isinstance(obj, dict):
            kids = [(f"{path}[{k!r}]", v) for k, v in obj.items()]
        elif inspect.isfunction(obj):
            kids = [(f"{path}.{k}", v) for k, v in vars(obj).items()]
            kids += [(f"{path}.{name}", cell.cell_contents) for name, cell in
                     zip(obj.__code__.co_freevars, obj.__closure__ or ())
                     if cell.cell_contents is not None]
        elif inspect.ismethod(obj):
            kids = [(path, obj.__self__)]
        elif type(obj).__module__.startswith("rocalution_tpu_torch."):
            kids = [(f"{path}.{k}", v)
                    for k, v in getattr(obj, "__dict__", {}).items()]
        else:
            kids = []
        stack.extend(reversed(kids))
    return parts


def o_solve(phase, tag, A, b, x, info, cg):
    """One path's solve of a phase O row: its true relative residual under
    RES_BOUND, and |x-1|/|1| under O_ERR where a CG row converged. Returns
    (iterations, status, |x-1|/|1|, |b-Ax|/|b|, reported residual)."""
    it, st = int(info.iterations), int(info.status)
    err = error_of(A, x, b, True)[1]
    res = true_residual(A, x, b)
    reported = float(info.final_res) / float(info.init_res)
    bound = max(RES_BOUND[0] * reported, RES_BOUND[1][torch.float64])
    if not res <= bound or (cg and st == 2 and not err < O_ERR):
        raise RuntimeError(f"{phase} {tag}: status {st}, |x-1|/|1| "
                           f"{err:.3e}, |b-Ax|/|b| {res:.3e} (bound "
                           f"{bound:.1e})")
    return it, st, err, res, reported


def o_row(rt, kernels, totals, phase, tag, A, b, build, small, *, solver,
          kw, plain=None, applies=1):
    """One row of phase O on the operator A (on the card) and b = A 1,
    with the preconditioner M = build(A) (timed: the row's setup):
    1. build's apply on the card against the same built and applied on
       the CPU, on small(device) (`o_check`);
    2. the kernel apply of A and of every operand of M with a plan
       (`plan_parts`) against the plan's plain product and the plain CSR
       apply (`hold_parts`);
    3. the plain path: a fresh plan-free copy A_p of A and M_p = plain(A_p,
       M), both made with auto_wjd off; where plain is None, M_p is M (its
       apply holds no SpMV). Where M_p is not M, one apply of each (a
       cycle of `applies` for a variable preconditioner) at full size is
       held to the other at TOL;
    4. the solve through the kernels (counted), then plain (no launch):
       each held by `o_solve`, both at one status, the iterations within
       1 (CG) or 2 of each other; where both stop at max_iter, their final
       relative residuals within O_STALL_TOL of each other;
    5. the launches at least what the iterations apply (`o_launches`);
    6. ms/iter over O_TIME_ITERS iterations a solve, the paths in turns
       (TURNS), the solves of 4 being their warm-up.
    Returns M."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    t_row = time.perf_counter()
    f64_tol = TOL[torch.float64]
    checked = o_check(phase, tag, small, build, applies)
    as_operator(A)                                  # its plan, now
    M, setup_s = timed(lambda: build(A))
    parts = [("A", A)] + [p for p in plan_parts(M) if p[1] is not A]
    held = hold_parts(rt, kernels, phase, tag, parts)
    solver_kw = dict(kw, check_every=FACTOR_CHECK_EVERY)
    plain_got = {}
    with Plain(rt), Counted(kernels, plain_got):
        A_p = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
        M_p = M if plain is None else plain(A_p, M)
    same = "the plain path applies M itself"
    if M_p is not M:
        r = torch.from_numpy(np.random.default_rng(12).standard_normal(
            A.shape[0])).to(CARD)
        z = [M(r) for _ in range(applies)]
        with Plain(rt), Counted(kernels, plain_got):
            z_p = [M_p(r) for _ in range(applies)]
        worst = max(rel_err(z_, zp_, f"{phase} {tag} M vs plain M at full "
                            "size", f64_tol)[1] for z_, zp_ in zip(z, z_p))
        same = f"M vs plain M, max|dz|/max|z| {worst:.1e}"
    with Counted(kernels, totals) as c:
        (x, info), wjd_s = timed(lambda: solver(A, b, M=M, **solver_kw))
    with Plain(rt), Counted(kernels, plain_got):
        (x_p, info_p), plain_s = timed(lambda: solver(A_p, b, M=M_p,
                                                      **solver_kw))
    if any(plain_got.values()):
        raise RuntimeError(f"{phase} {tag} plain: launched {plain_got}")
    cg = solver is rt.cg
    it, st, err, res, rep = o_solve(phase, f"{tag} WJD", A, b, x, info, cg)
    it_p, st_p, err_p, res_p, rep_p = o_solve(phase, f"{tag} plain", A, b,
                                              x_p, info_p, cg)
    if st != st_p or abs(it - it_p) > (1 if cg else 2):
        raise RuntimeError(f"{phase} {tag}: WJD {it} iterations status {st}"
                           f", plain {it_p} status {st_p}")
    stall = ""
    if it == it_p == kw["max_iter"]:
        d = abs(rep - rep_p) / rep_p
        if not d <= O_STALL_TOL:
            raise RuntimeError(f"{phase} {tag}: both stop at max_iter with "
                               f"final residuals {rep:.12e} and "
                               f"{rep_p:.12e}")
        stall = (f" | both at max_iter: final residuals {rep:.6e} / "
                 f"{rep_p:.6e}, apart {d:.1e} (tol {O_STALL_TOL:g})")
    per = o_launches(kernels, M, A.shape[0], applies)
    want = {plan_key(A._wjd_cache): it}
    for k, n in per.items():
        want[k] = want.get(k, 0) + n * (it // applies)
    short = {k: (c.got.get(k, 0), n) for k, n in want.items()
             if c.got.get(k, 0) < n}
    if short:
        raise RuntimeError(f"{phase} {tag}: launches (got, want) {short}")
    paths = {"WJD": (A, M, contextlib.nullcontext()),
             "plain": (A_p, M_p, Plain(rt))}
    time_kw = dict(solver_kw, rel_tol=1e-30, max_iter=O_TIME_ITERS)
    ms = []
    for path in TURNS:
        A_, M_, ctx = paths[path]
        with ctx:
            (_, inf_), s = timed(lambda: solver(A_, b, M=M_, **time_kw))
        ms.append(f"{path} {s / max(int(inf_.iterations), 1) * 1e3:.3f}")
    levels = [sch.nlev for sch in getattr(M, "schedules", None) or ()]
    say(phase, f"{tag}: setup {setup_s:.2f} s"
        + (f" (level schedules of {levels} levels)" if levels else "")
        + f" | card vs CPU apply max|dz|/max|z| {checked} | {same} | WJD: "
        f"status {st}, {it} iters, |x-1|/|1| {err:.3e}, |b-Ax|/|b| "
        f"{res:.3e}, first solve {wjd_s:.2f} s | plain: status {st_p}, "
        f"{it_p} iters, {err_p:.3e}, {res_p:.3e}, first solve "
        f"{plain_s:.2f} s{stall} | ms/iter over {O_TIME_ITERS} iterations "
        "in turns " + ", ".join(ms) + " | launches "
        f"{ {k: n for k, n in c.got.items() if n} } (one apply of M: "
        f"{per if applies == 1 else f'{per} over {applies}'}) | row "
        f"{time.perf_counter() - t_row:.1f} s")
    say(phase, f"{tag}: each kernel apply vs the plan's plain product / "
        f"the plain CSR apply, max|dy|/max|y| (tol {f64_tol:g}): {held}")
    return M


def phase_o1(rt, kernels, totals):
    """CG + RS-AMG as cg_rsamg.py (coarse_size 200, rel_tol 1e-8,
    max_iter 200): greedy coarsening with direct interpolation at a
    million rows, PMIS with ExtPI at a quarter million (max_iter
    O_RS_PMIS_MAX_ITER); then the device PMIS C/F split of the million-row
    strength graph on the card against the CPU."""
    from rocalution_tpu_torch.solvers import multigrid as mg
    from rocalution_tpu_torch.solvers.multigrid import aggregation_device
    from rocalution_tpu_torch.solvers.multigrid import rs

    def plain(A_p, M):
        return mg.cycle_closure(plain_hierarchy(rt, mg, M.hierarchy, A_p))

    for n, coarsening, interp, max_iter in (
            (O_RS_N, "greedy", "direct", 200),
            (O_RS_PMIS_N, "pmis", "extpi", O_RS_PMIS_MAX_ITER)):
        kw = dict(coarse_size=200, coarsening=coarsening,
                  interpolation=interp)
        tag = f"CG + RS-AMG({coarsening}/{interp}) laplacian_2d({n})"
        A = rt.laplacian_2d(n)
        M = o_row(rt, kernels, totals, "O1", tag, A, rhs_of_ones(A),
                  lambda Aop, kw=kw: mg.cycle_closure(mg.rsamg(Aop, **kw)),
                  lambda d: rt.laplacian_2d(64, device=d), solver=rt.cg,
                  kw=dict(rel_tol=1e-8, max_iter=max_iter), plain=plain)
        h = M.hierarchy
        say("O1", f"{tag}: levels {h.operator_sizes()}; " + "; ".join(
            f"{name}{l} {served_by(T)}" for l, lv in enumerate(h.levels)
            for name, T in (("A", lv.A), ("P", lv.P)) if T is not None))
        del A, h, M
        torch.cuda.empty_cache()
    A = rt.laplacian_2d(O_RS_N, device="cpu")
    Sg = rs.classical_strength(rs._scipy(A))
    cf_card, card_s = timed(
        lambda: aggregation_device.pmis_coarsening_device(Sg, 1, CARD))
    t0 = time.perf_counter()
    cf_cpu = aggregation_device.pmis_coarsening_device(Sg, 1, "cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(cf_card, cf_cpu):
        diff = int((cf_card != cf_cpu).sum())
        raise RuntimeError("O1: the device PMIS C/F map on the card differs "
                           f"from the CPU's in {diff} points")
    say("O1", f"pmis-device C/F split of laplacian_2d({O_RS_N})'s strength "
        f"graph ({Sg.nnz} edges): {int(cf_card.sum())} C points, equal to "
        f"the CPU's element for element; card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s")


def phase_o(rt, kernels, totals):
    """Phase O: O1 (RS-AMG), O2 (CG on laplacian_3d(O_LAP_N) with the
    preconditioners of the rest of the stack), O3 (GMRES(30) and FGMRES on
    convection_diffusion_2d(O_CD_N))."""
    from rocalution_tpu_torch import precond as P

    t0 = time.perf_counter()
    phase_o1(rt, kernels, totals)
    say("O1", f"phase O1: {time.perf_counter() - t0:.0f} s")

    def lap_small(d):
        return rt.laplacian_3d(O_CHECK_LAP_N, device=d)

    def cd_small(d):
        return rt.convection_diffusion_2d(O_CHECK_CD_N, device=d)

    def bsr(A):
        return rt.convert(A, "BCSR", block_dim=2)

    def rebuilt(build):
        """The plain path's M: the same build on the plain operator."""
        return lambda A_p, M: build(A_p)

    # name -> (build(A), whether the plain path applies the same M: its
    # apply holds no SpMV)
    o2 = {
        "SGS": (P.sgs, True),
        "SSOR(1.5)": (lambda A: P.ssor(A, 1.5), True),
        "multicoloured SGS": (P.multicolored_sgs, True),
        "multicoloured ILU(0, 1)": (lambda A: P.multicolored_ilu(A, 0, 1),
                                    True),
        "FSAI(1)": (P.fsai, False),
        "SPAI": (P.spai, False),
        "TNS(2)": (lambda A: P.tns(A, 2), False),
        "AIChebyshev(4)": (lambda A: P.aichebyshev(A, 4), False),
        "BlockJacobi(n/64)": (lambda A: P.block_jacobi(A, A.shape[0] // 64),
                              True),
        "AS(n/64, 8)": (lambda A: P.additive_schwarz(A, A.shape[0] // 64, 8),
                        True),
        "RAS(n/64, 8)": (lambda A: P.restricted_additive_schwarz(
            A, A.shape[0] // 64, 8), True),
        # 8 Jacobi sweeps: at laplacian_3d(100) the flattened factor's level
        # schedules (496 levels each) took 82-137 ms an iteration
        "BSR-IC(0) block_dim 2, 8 sweeps": (
            lambda A: P.bsr_ic0(bsr(A), method="jacobi", sweeps=8), False),
    }
    t0 = time.perf_counter()
    A = rt.laplacian_3d(O_LAP_N)
    b = rhs_of_ones(A)
    for name, (build, shared) in o2.items():
        o_row(rt, kernels, totals, "O2", f"CG + {name} laplacian_3d("
              f"{O_LAP_N}) f64", A, b, build, lap_small, solver=rt.cg,
              kw=O_CG, plain=None if shared else rebuilt(build))
        torch.cuda.empty_cache()
    del A, b
    say("O2", f"phase O2: {time.perf_counter() - t0:.0f} s")

    def swept(make):
        return lambda A: make(A, method="jacobi", sweeps=8)

    # name -> (solver, build(A), applies a cycle of M)
    o3 = {
        "GMRES(30) + ILU(1)": (rt.gmres, swept(lambda A, **k: P.ilu(A, 1,
                                                                     **k)),
                               1),
        "GMRES(30) + ILUT(1e-3, 32)": (rt.gmres, swept(
            lambda A, **k: P.ilut_precond(A, 1e-3, 32, **k)), 1),
        "GMRES(30) + BSR-ILU(0) block_dim 2": (rt.gmres, swept(
            lambda A, **k: P.bsr_ilu0(bsr(A), **k)), 1),
        # the last Schur block (~10^5 rows) by ILU(0) with Jacobi sweeps:
        # its level schedule costs ~0.5 s an apply
        "FGMRES(30) + ME(3, 1e-3, last ILU(0) 8 sweeps)": (
            rt.fgmres, lambda A: P.multi_elimination(
                A, 3, 1e-3, last_solver=swept(lambda M, **k: P.ilu(M, 0,
                                                                    **k))),
            1),
        f"FGMRES(30) + Variable[Jacobi, SGS, TNS], max_iter "
        f"{O_VAR_MAX_ITER}": (
            rt.fgmres, lambda A: P.variable_precond(
                [P.jacobi(A), P.sgs(A), P.tns(A)]), 3),
    }
    t0 = time.perf_counter()
    A = rt.convection_diffusion_2d(O_CD_N)
    b = rhs_of_ones(A)
    for name, (solver, build, applies) in o3.items():
        kw = (dict(O_GMRES, max_iter=O_VAR_MAX_ITER) if applies > 1
              else O_GMRES)
        o_row(rt, kernels, totals, "O3", f"{name} convection_diffusion_2d("
              f"{O_CD_N}) f64", A, b, build, cd_small, solver=solver, kw=kw,
              plain=rebuilt(build), applies=applies)
        torch.cuda.empty_cache()
    say("O3", f"phase O3: {time.perf_counter() - t0:.0f} s")


def same_triplet(tag, A, B):
    """Raise unless B's host triplet equals A's bit for bit."""
    if tuple(A.shape) != tuple(B.shape):
        raise RuntimeError(f"{tag}: shape {B.shape} != {A.shape}")
    for name, a, b in zip(("data", "indices", "indptr"), A.numpy_triplet(),
                          B.numpy_triplet()):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"{tag}: {name} differs from the written "
                               "operator's")


def p1_operator(rt, kernels, totals, tag, B, want, plan_s):
    """CG + Jacobi through the kernels on an operator read from a file:
    phase D's or E's status and count (within 1 where the plan spills: the
    spill's index_add_ sums in no fixed order), |x-1|/|1| < 1e-6, launches
    of the plan's entry point at least one an iteration, and the plan's
    kernel held against its plain versions."""
    key = plan_key(B._wjd_cache)
    b = rhs_of_ones(B)
    with Counted(kernels, totals) as c:
        x, info, s = solve(rt, B, b, rel_tol=1e-8, max_iter=2000)
    it, err = check_solve(f"P1 {tag}", x, info, want[0], 1e-6)
    slack = 1 if B._wjd_cache.spill_row.numel() else 0
    if abs(it - want[1]) > slack or c.got[key] < it + 1:
        raise RuntimeError(f"P1 {tag}: {it} iterations (want {want[1]}), "
                           f"{c.got[key]} {key} launches")
    held = hold_parts(rt, kernels, "P1", tag, [("A", B)])
    return (f"plan {plan_s:.2f} s | CG+Jacobi status {want[0]}, {it} iters "
            f"(want {want[1]}), |x-1|/|1| {err:.2e}, {s / it * 1e3:.3f} "
            f"ms/iter, {c.got[key]} {key} launches | kernel vs plain / plain "
            f"CSR {held}")


def phase_p1(rt, kernels, totals, want, tmp, plans):
    """IO at a million rows: laplacian_3d(P_LAP_N) and
    random_banded_spd(P_RAND_N) f64 written with write_csr and
    write_rocsparseio (the first with write_mtx too), each file read back
    onto the card (the triplet bit for bit) and solved with CG + Jacobi
    through the kernels at phase D's and E's status and count. The plans
    go through the plan cache at `plans`, where phase C left these two
    operators' plans. Then the repo's fixtures: the golden rocsparseio
    file's values, CG + IC(0) on gr_30_30_like.mtx and GMRES(30) + ILU(0)
    on convdiff_24.mtx to 1e-8 (tests/test_fixtures.py). Returns the
    laplacian read back from its binary file, with its plan."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    io = rt.io
    ops = (("lap", f"laplacian_3d({P_LAP_N})",
            lambda: rt.laplacian_3d(P_LAP_N), want["D"]),
           ("rand", f"random_banded_spd({P_RAND_N})",
            lambda: rt.random_banded_spd(P_RAND_N), want["E"]))
    kept = None
    with plan_cache(plans):
        for key, name, make, want_op in ops:
            A, gen_s = timed(make)
            formats = [("binary", io.write_csr, io.read_csr, ".npz"),
                       ("rocsparseio", io.write_rocsparseio,
                        io.read_rocsparseio, "")]
            if key == "lap":
                formats.append(("mtx", io.write_mtx, io.read_mtx, ""))
            for fmt, write, read, suffix in formats:
                path = os.path.join(tmp, f"{key}.{fmt}")
                _, write_s = timed(lambda: write(path, A))
                size = os.path.getsize(path + suffix)
                B, read_s = timed(lambda: read(path + suffix))
                os.unlink(path + suffix)
                same_triplet(f"P1 {name} {fmt}", A, B)
                _, plan_s = timed(lambda: as_operator(B))
                text = p1_operator(rt, kernels, totals, f"{name} {fmt}", B,
                                   want_op, plan_s)
                say("P1", f"{name} f64 nnz={A.nnz} (generated in "
                    f"{gen_s:.1f} s): {fmt} file {size / 2**20:.1f} MiB, "
                    f"written in {write_s:.2f} s, read onto the card in "
                    f"{read_s:.2f} s, triplet bit for bit | {text}")
                if key == "lap" and fmt == "binary":
                    kept = B
                del B
            del A
            torch.cuda.empty_cache()
    golden = io.read_rocsparseio(FIXTURES + "golden_csr.rocsparseio")
    d, i, p = golden.numpy_triplet()
    if (golden.shape != (4, 5) or list(p) != [0, 2, 3, 3, 5]
            or list(i) != [0, 3, 1, 2, 4]
            or list(d) != [1.5, -2.0, 3.25, 0.5, 7.0]):
        raise RuntimeError("P1: the golden rocsparseio file reads wrong")
    for fname, solver, make_m, kw in (
            ("gr_30_30_like.mtx", rt.cg, rt.ic, {}),
            ("convdiff_24.mtx", rt.gmres, lambda A: rt.ilu(A, 0),
             {"basis_size": 30})):
        A = io.read_mtx(FIXTURES + fname)
        b = rhs_of_ones(A)
        with Counted(kernels, totals) as c:
            (x, info), s = timed(lambda: solver(A, b, M=make_m(A),
                                                rel_tol=1e-8, max_iter=500,
                                                **kw))
        res = true_residual(A, x, b)
        if int(info.status) not in (1, 2) or not res <= 1.1e-8:
            raise RuntimeError(f"P1 {fname}: status {int(info.status)}, "
                               f"|b-Ax|/|b| {res:.3e}")
        held = hold_parts(rt, kernels, "P1", fname, [("A", A)])
        say("P1", f"{fname} n={A.shape[0]} nnz={A.nnz}, "
            f"{solver.__name__}: status {int(info.status)}, "
            f"{int(info.iterations)} iters, |b-Ax|/|b| {res:.2e} in "
            f"{s:.2f} s | launches { {k: n for k, n in c.got.items() if n} } "
            f"| kernel vs plain / plain CSR {held}")
    say("P1", "golden_csr.rocsparseio: (4, 5), its five values as written")
    return kept


def phase_p2(rt, kernels, totals, tmp):
    """The plan cache: laplacian_3d(P_CACHE_N) planned twice with the cache
    at a fresh directory, cold then warm; every array of the two plans
    equal; the warm plan on the card through its direct (roll_f64) and
    windowed (win_roll_f64) kernels, each held against its plain version,
    and a CG + Jacobi through it."""
    from rocalution_tpu_torch.formats.wjd import (_plan_to_wjd,
                                                  csr_to_wjd_plan)

    A, gen_s = timed(lambda: rt.laplacian_3d(P_CACHE_N))
    trip = A.numpy_triplet()
    d = os.path.join(tmp, "p2_plans")
    with plan_cache(d):
        cold, cold_s = timed(lambda: csr_to_wjd_plan(*trip, A.shape))
        warm, warm_s = timed(lambda: csr_to_wjd_plan(*trip, A.shape))
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    if set(cold) != set(warm) or warm is cold:
        raise RuntimeError("P2: the warm plan is not a plan read back")
    for k in cold:
        a, b = cold[k], warm[k]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise RuntimeError(f"P2: warm plan's {k} differs")
        elif a != b:
            raise RuntimeError(f"P2: warm plan's {k} {b!r} != {a!r}")
    W, up_s = timed(lambda: _plan_to_wjd(warm, A.device))
    object.__setattr__(A, "_wjd_cache", W)
    key = plan_key(W)
    if key != "win_roll_f64" or W.kernel_mode != "roll":
        raise RuntimeError(f"P2: the plan takes {key}")
    x = random_x(rt, A, W.dtype)
    xp = kernels.pad_x(W, x)
    _, rel_d = rel_err(kernels.slots_kernel(W, xp),
                       kernels.slots_plain(W, xp), "P2 roll_f64", TOL[W.dtype])
    _, rel_w = rel_err(kernels.wjd_spmv(W, x), kernels.wjd_reference(W, x),
                       "P2 win_roll_f64", TOL[W.dtype])
    b = rhs_of_ones(A)
    with Counted(kernels, totals) as c:
        x, info, s = solve(rt, A, b, rel_tol=1e-8, max_iter=2000)
    it, err = check_solve("P2", x, info, 2, 1e-6)
    if c.got[key] < it + 1:
        raise RuntimeError(f"P2: {c.got[key]} {key} launches, {it} iters")
    say("P2", f"laplacian_3d({P_CACHE_N}) f64 n={A.shape[0]} nnz={A.nnz} "
        f"(generated in {gen_s:.1f} s): plan cold {cold_s:.2f} s (planning "
        f"and writing {size / 2**20:.1f} MiB), warm {warm_s:.2f} s (read "
        f"back), every array equal; upload {up_s:.2f} s | roll_f64 vs plain "
        f"{rel_d:.1e}, win_roll_f64 vs plain {rel_w:.1e} (tol "
        f"{TOL[W.dtype]:g}) | CG+Jacobi status 2, {it} iters, |x-1|/|1| "
        f"{err:.2e}, {s / it * 1e3:.3f} ms/iter, {c.got[key]} {key} "
        "launches")


def complex_of(rt, A, mirror, cdt):
    """A + 1j*P_IMAG*T on A's pattern, T symmetric from a seeded draw
    (`mirror` maps each entry to its transposed one), of type cdt."""
    d, i, p = A.numpy_triplet()
    v = np.random.default_rng(21).standard_normal(len(d))
    vals = (d + 1j * P_IMAG * (v + v[mirror])).astype(cdt)
    return rt.CSR.from_arrays(vals, i, p, A.shape)


def four_spmv(kernels, C, x):
    """The other layout of a complex product, for timing: four real
    products, x.real and x.imag each padded into the planes' buffers."""
    xr, xi = x.real, x.imag
    return torch.complex(
        kernels.wjd_spmv(C.re, xr) - kernels.wjd_spmv(C.im, xi),
        kernels.wjd_spmv(C.re, xi) + kernels.wjd_spmv(C.im, xr))


def p3_product(rt, kernels, tag, A, A_p, C):
    """A ComplexWJD's product through the kernels (two SpMM launches)
    against the reference's formula over the planes' plain products (TOL
    of the planes' type, max-norm) and the plain complex CSR product
    (P_TOL, norm-wise); the four-product layout held as well. The two
    layouts side by side: device time of a product (beside the plain
    versions, the library call and the bound: the two value planes, x and
    y once), host time of a call, and CG + Jacobi ms/iter over
    O_TIME_ITERS iterations in turns after a warm-up solve of each (the
    four-product layout as a matrix-free operator)."""
    rng = np.random.default_rng(5)
    n = A.shape[0]
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(
        n)).astype(rt.config.numpy_dtype(A.dtype))).cuda()
    tol = TOL[C.re.dtype]
    y = kernels.cwjd_spmv(C, x)
    _, rel = rel_err(y, kernels.cwjd_reference(C, x), f"P3 {tag}", tol)
    _, rel4 = rel_err(four_spmv(kernels, C, x), y, f"P3 {tag} four", tol)
    y_p = rt.spmv(A_p, x)
    nrel = float(torch.linalg.norm(y - y_p) / torch.linalg.norm(y_p))
    if not nrel <= P_TOL[A.dtype]:
        raise RuntimeError(f"P3 {tag}: ||y - y_csr||/||y_csr|| {nrel:.3e}")
    layouts = {"two SpMM": lambda v: kernels.cwjd_spmv(C, v),
               "four SpMV": lambda v: four_spmv(kernels, C, v)}
    dev = {k: median_ms(lambda: f(x)) for k, f in layouts.items()}
    host = {k: host_us(f, x)[0] for k, f in layouts.items()}
    p_ms = median_ms(lambda: kernels.cwjd_reference(C, x))
    c_ms = median_ms(lambda: rt.spmv(A_p, x))
    lib = library_ms(A_p, x)
    vsz, xsz = C.re.dtype.itemsize, A.dtype.itemsize
    bound = (2 * C.re.nnz * vsz + 2 * n * xsz) / PEAK_BYTES * 1e6
    b, M = rhs_of_ones(A), rt.jacobi(A)
    kw = dict(rel_tol=1e-30, max_iter=O_TIME_ITERS,
              check_every=FACTOR_CHECK_EVERY)
    ops = {"two SpMM": A, "four SpMV": layouts["four SpMV"]}
    for op in ops.values():                     # warm-up
        rt.cg(op, b, M=M, **kw)
    cg_ms = []
    for name in ("two SpMM", "four SpMV", "four SpMV", "two SpMM"):
        (_, inf_), t = timed(lambda: rt.cg(ops[name], b, M=M, **kw))
        cg_ms.append(f"{name} {t / int(inf_.iterations) * 1e3:.3f}")
    return (f"vs plain planes {rel:.1e} (tol {tol:g}), vs plain complex CSR "
            f"{nrel:.1e} (tol {P_TOL[A.dtype]:g}), four-product layout vs "
            f"it {rel4:.1e} | device us: "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in dev.items())
            + f", plain planes {p_ms * 1e3:.1f}, plain complex CSR "
            f"{c_ms * 1e3:.1f}, library {lib * 1e3:.1f}, bound {bound:.1f} "
            "(bytes) | host us a call: "
            + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
            + f" | CG + Jacobi ms/iter over {O_TIME_ITERS} iterations in "
            "turns " + ", ".join(cg_ms))


def p3_solve(rt, kernels, totals, tag, name, A, A_p, b):
    """One complex solve with Jacobi through the kernels (counted) and
    plain: the same status, counts within 1 (CG) or 2 (GMRES, BiCGStab)
    unless rounding rules them (BiCGStab and complex64 rows: where the
    plain counts at b and b(1 +- P_NUDGE) spread by more than 2, as in
    phase N2, the row is held to its status), |x-1|/|1| (CG) or the true
    residual (`res_bound`) under its bound, two launches a product;
    ms/iter in turns (TURNS) over O_TIME_ITERS iterations."""
    fn = getattr(rt, name)
    M, M_p = rt.jacobi(A), rt.jacobi(A_p)
    kw = dict(rel_tol=P_REL_TOL[A.dtype], max_iter=P_MAX_ITER[name],
              check_every=FACTOR_CHECK_EVERY)
    if name == "gmres":
        kw["basis_size"] = 30
    with Counted(kernels, totals) as c:
        (x, info), s = timed(lambda: fn(A, b, M=M, **kw))
    with Plain(rt), Counted(kernels, {}) as cp:
        (x_p, info_p), s_p = timed(lambda: fn(A_p, b, M=M_p, **kw))
        nudged = []
        if name == "bicgstab" or A.dtype == torch.complex64:
            e = P_NUDGE[A.dtype]
            nudged = [int(fn(A_p, b * (1 + e), M=M_p, **kw)[1].iterations)
                      for e in (e, -e)]
    it, st = int(info.iterations), int(info.status)
    it_p, st_p = int(info_p.iterations), int(info_p.status)
    counts = [it_p] + nudged
    ruled = max(counts) - min(counts) > 2
    slack = 1 if name == "cg" else 2
    if st != st_p or (not ruled and abs(it - it_p) > slack):
        raise RuntimeError(f"P3 {tag} {name}: {it} iterations status {st}, "
                           f"plain {it_p} status {st_p} (plain counts "
                           f"{counts})")
    rdt = torch.float64 if A.dtype == torch.complex128 else torch.float32
    errs = []
    for path, x_, info_ in (("WJD", x, info), ("plain", x_p, info_p)):
        if name == "cg":
            e = float(np.linalg.norm(host64(x_) - 1.0) / np.sqrt(x_.shape[0]))
            bound = P_ERR[A.dtype]
        else:
            e = true_residual(A, x_, b)
            bound = max(RES_BOUND[0] * float(info_.final_res)
                        / float(info_.init_res), RES_BOUND[1][rdt])
        if st == 2 and not e <= bound:
            raise RuntimeError(f"P3 {tag} {name} {path}: error {e:.3e} over "
                               f"{bound:.1e}")
        errs.append(e)
    key = plan_key(A._wjd_cache.re, "spmm_")
    applies = {"cg": it + 1, "gmres": it, "bicgstab": 2 * it}[name]
    if c.got[key] < 2 * applies or any(cp.got.values()):
        raise RuntimeError(f"P3 {tag} {name}: {c.got[key]} {key} launches "
                           f"for {it} iterations; plain {cp.got}")
    paths = {"WJD": (A, M, contextlib.nullcontext()),
             "plain": (A_p, M_p, Plain(rt))}
    time_kw = dict(kw, rel_tol=1e-30, max_iter=O_TIME_ITERS)
    ms = []
    for path in TURNS:
        A_, M_, ctx = paths[path]
        with ctx:
            (_, inf_), t = timed(lambda: fn(A_, b, M=M_, **time_kw))
        ms.append(f"{path} {t / max(int(inf_.iterations), 1) * 1e3:.3f}")
    what = "|x-1|/|1|" if name == "cg" else "|b-Ax|/|b|"
    say("P3", f"{tag} {name.upper()} + Jacobi rel_tol {kw['rel_tol']:g}: "
        f"WJD status {st}, {it} iters, {what} {errs[0]:.2e}, {s:.2f} s | "
        f"plain status {st_p}, {it_p} iters, {errs[1]:.2e}, {s_p:.2f} s"
        + (f" | plain counts at b, b(1 +- {P_NUDGE[A.dtype]:g}) {counts}"
           + (": ruled by rounding, held to the status" if ruled else "")
           if nudged else "")
        + f" | {c.got[key]} {key} launches ({c.got[key] / max(it, 1):.2f} "
        f"an iteration) | ms/iter over {O_TIME_ITERS} iterations in turns "
        + ", ".join(ms))


def phase_p3(rt, kernels, totals):
    """Complex operators at a million rows: laplacian_3d(P_LAP_N) (roll
    planes) and random_banded_spd(P_RAND_N) (gather planes), each plus
    1j*P_IMAG*T with T a seeded symmetric matrix on its pattern, in
    complex128 (f64 planes) and complex64 (f32 planes): the ComplexWJD
    product held against its plain versions and timed (`p3_product`), then
    complex CG, GMRES(30) and BiCGStab with Jacobi through the kernels and
    plain (`p3_solve`)."""
    from rocalution_tpu_torch.ops.spmv import as_operator

    for name, make, mode in (
            (f"laplacian_3d({P_LAP_N})", lambda: rt.laplacian_3d(P_LAP_N),
             "roll"),
            (f"random_banded_spd({P_RAND_N})",
             lambda: rt.random_banded_spd(P_RAND_N), "gather")):
        S = make()
        d, i, p = S.numpy_triplet()
        rows = np.repeat(np.arange(S.shape[0]), np.diff(p))
        # the pattern is symmetric: entry mirror[k] of the CSR order holds
        # the transposed place of entry k
        mirror = np.lexsort((rows, i))
        del rows
        for cdt in (np.complex128, np.complex64):
            A = complex_of(rt, S, mirror, cdt)
            _, plan_s = timed(lambda: as_operator(A))
            C = A._wjd_cache
            if (not isinstance(C, rt.ComplexWJD) or C.re.kernel_mode != mode
                    or C.im.kernel_mode != mode):
                raise RuntimeError(f"P3 {name}: {type(C).__name__} "
                                   f"{getattr(C, 're', C)}")
            with Plain(rt):
                A_p = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
            tag = f"{name} {np.dtype(cdt).name}"
            say("P3", f"{tag}: ComplexWJD of two {TAG[C.re.dtype]} {mode} "
                f"planes, planned in {plan_s:.1f} s (re: {plan_line(A, C.re)}"
                f"; im: spill {C.im.spill_row.numel()}) | "
                + p3_product(rt, kernels, tag, A, A_p, C))
            b = rhs_of_ones(A)
            for solver in ("cg", "gmres", "bicgstab"):
                p3_solve(rt, kernels, totals, tag, solver, A, A_p, b)
            del A, A_p, C, b
            torch.cuda.empty_cache()
        del S, mirror


def phase_p4(rt, kernels, totals, A):
    """The stencil: CG + Jacobi on laplace3d_stencil(P_LAP_N), matrix-free,
    beside the same CG on laplacian_3d(P_LAP_N) through roll_f64 (A, read
    back in P1): the same status and count, histories within P_HIST_TOL;
    the stencil apply against the plain CSR apply; ms/iter of each in
    turns after the counted solves, and of spmv_add."""
    St = rt.laplace3d_stencil(P_LAP_N)
    b = rhs_of_ones(A)
    kw = dict(rel_tol=1e-8, max_iter=2000, record_history=True)
    x = random_x(rt, A, torch.float64)
    with Plain(rt):
        A_p = rt.CSR.from_arrays(*A.numpy_triplet(), A.shape)
    _, rel = rel_err(rt.spmv(St, x), rt.spmv(A_p, x), "P4 stencil apply",
                     TOL[torch.float64])
    held = hold_parts(rt, kernels, "P4", "laplacian_3d", [("A", A)])
    runs = {}
    for path, Op in (("stencil", St), ("CSR", A)):
        with Counted(kernels, totals) as c:
            (xs, info), s = timed(lambda: rt.cg(Op, b, M=rt.jacobi(Op),
                                                **kw))
        check_solve(f"P4 {path}", xs, info, 2, 1e-6)
        runs[path] = (int(info.iterations), info.history.cpu().numpy(), s,
                      {k: n for k, n in c.got.items() if n})
    (it_s, h_s, s_s, got_s), (it_a, h_a, s_a, got_a) = runs.values()
    k = int((~np.isnan(h_a)).sum())
    hist = float(np.max(np.abs(h_s[:k] - h_a[:k]) / np.abs(h_a[:k])))
    if (it_s != it_a or got_s or got_a.get(plan_key(A._wjd_cache), 0)
            < it_a + 1
            or not hist <= P_HIST_TOL or not np.isnan(h_s[k:]).all()):
        raise RuntimeError(f"P4: stencil {it_s} iterations (launches "
                           f"{got_s}), CSR {it_a} ({got_a}), histories "
                           f"apart {hist:.2e}")
    time_kw = dict(kw, rel_tol=1e-30, max_iter=O_TIME_ITERS,
                   record_history=False)
    ms = []
    Ms = {"stencil": rt.jacobi(St), "CSR": rt.jacobi(A)}
    for path in ("stencil", "CSR", "CSR", "stencil"):
        Op = St if path == "stencil" else A
        (_, inf_), t = timed(lambda: rt.cg(Op, b, M=Ms[path], **time_kw))
        ms.append(f"{path} {t / int(inf_.iterations) * 1e3:.3f}")
    y = random_x(rt, A, torch.float64)
    add = {name: median_ms(lambda: rt.spmv_add(Op, x, y, -1.0))
           for name, Op in (("stencil", St), ("roll_f64", A),
                            ("plain CSR", A_p))}
    say("P4", f"laplace3d_stencil({P_LAP_N}) CG+Jacobi: status 2, {it_s} "
        f"iters, {s_s:.2f} s, no kernel launched | laplacian_3d({P_LAP_N}) "
        f"through {plan_key(A._wjd_cache)}: {it_a} iters, {s_a:.2f} s, "
        f"{got_a} | histories "
        f"apart {hist:.1e} (tol {P_HIST_TOL:g}); stencil apply vs plain "
        f"CSR {rel:.1e}; roll_f64 vs plain / plain CSR {held} | ms/iter "
        f"over {O_TIME_ITERS} iterations in turns " + ", ".join(ms)
        + " | spmv_add " + ", ".join(f"{k} {v * 1e3:.1f} us"
                                     for k, v in add.items()))


def phase_p(rt, kernels, totals, want, plans):
    """IO (P1), the plan cache (P2), complex operators (P3) and the
    stencil (P4), in f64 unless a row says otherwise."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lap = phase_p1(rt, kernels, totals, want, tmp, plans)
        say("P1", f"phase P1: {time.perf_counter() - t0:.0f} s")
        t0 = time.perf_counter()
        phase_p2(rt, kernels, totals, tmp)
        torch.cuda.empty_cache()
        say("P2", f"phase P2: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    phase_p3(rt, kernels, totals)
    say("P3", f"phase P3: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    phase_p4(rt, kernels, totals, lap)
    say("P4", f"phase P4: {time.perf_counter() - t0:.0f} s")


def q_plain(Ag):
    """The same distributed operator without its interior plans (the
    arrays shared): the plain segment-sum interior apply."""
    return dataclasses.replace(Ag, int_wjd=None)


def q_apply(tpar, Ag, x):
    """Global y = A x through `shard_spmv`, all parts on the card."""
    nloc = Ag.n_local_col or Ag.n_local
    xp = tpar.distribute_vector(x, Ag.nparts, nloc)
    return tpar.gather_vector(
        tpar.shard_spmv(Ag, xp, tpar.make_comm(Ag.nparts)), Ag.n_global)


def q_hold_interiors(kernels, tpar, phase, tag, Ag):
    """Each part's interior kernel against its plain version, and the
    whole apply through the kernels against the plain interior path, on
    one x, at TOL; and the launches of that apply, by counter, which must
    be one a part (the interior kernel runs once per part). Launches not
    counted as the main path's. Returns the worst agreements and the
    launches an apply as text, and the launches an apply."""
    W = Ag.int_wjd
    if W is None:
        raise RuntimeError(f"{phase} {tag}: the interiors carry no plan")
    worst = 0.0
    for q, Wq in enumerate(W.parts):
        x = torch.from_numpy(np.random.default_rng(q).standard_normal(
            Wq.shape[1])).to(device=Wq.device, dtype=Wq.x_dtype)
        _, rel = rel_err(kernels.wjd_spmv(Wq, x),
                         kernels.wjd_reference(Wq, x),
                         f"{phase} {tag} part {q}", TOL[Wq.dtype])
        worst = max(worst, rel)
    x = torch.from_numpy(np.random.default_rng(99).standard_normal(
        Ag.shape[1])).to(device=Ag.device, dtype=Ag.dtype)
    before = dict(kernels.launches)
    y = q_apply(tpar, Ag, x)
    per_apply = {k: n - before[k] for k, n in kernels.launches.items()
                 if n != before[k]}
    want = {}
    for Wq in W.parts:
        want[plan_key(Wq)] = want.get(plan_key(Wq), 0) + 1
    if per_apply != want:
        raise RuntimeError(f"{phase} {tag}: launches of one apply "
                           f"{per_apply}, want {want}")
    _, rel_all = rel_err(y, q_apply(tpar, q_plain(Ag), x),
                         f"{phase} {tag} apply vs plain", TOL[Ag.dtype])
    return (f"{W.nparts} parts {W.kernel_mode} "
            f"({KERNELS[plan_key(W.parts[0])][0]}): parts {worst:.1e}, "
            f"apply vs plain {rel_all:.1e}, launches an apply "
            f"{per_apply}"), per_apply


def q_solve(tpar, solver, Ag, b, M, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = tpar.dist_solve(solver, Ag, b, M=M, **kw)
    torch.cuda.synchronize()
    return x, info, time.perf_counter() - t0


def q_turns(tpar, solver, paths, b, **kw):
    """ms/iter of each path ({name: (Ag, M)}) in turns (TURNS), after one
    warm-up solve each; returns {name: [ms/iter, ...]} and the last solve
    of each path."""
    last = {}
    for name, (Ag, M) in paths.items():
        last[name] = q_solve(tpar, solver, Ag, b, M, **kw)
    ms = {name: [] for name in paths}
    for name in TURNS:
        Ag, M = paths[name]
        x, info, s = q_solve(tpar, solver, Ag, b, M, **kw)
        ms[name].append(s / max(int(info.iterations), 1) * 1e3)
        last[name] = (x, info, s)
    return ms, last


def turns_text(ms):
    return ", ".join(f"{k} " + "/".join(f"{v:.3f}" for v in vals)
                     for k, vals in ms.items())


def phase_q1(rt, tpar, kernels, totals, want):
    """CG + BlockJacobi(diagonal) on laplacian_3d(Q_LAP_N) over 8 and 4
    parts on the card, in both halo modes, through roll_f64 (one launch a
    part an apply) and plain; then an f32 copy through roll_f32."""
    A = rt.laplacian_3d(Q_LAP_N)
    b = rhs_of_ones(A)
    x = random_x(rt, A, torch.float64)
    y_serial = rt.spmv(A, x)                   # A has no plan: plain CSR
    want_status, want_it = want
    cg_kw = dict(rel_tol=1e-8, max_iter=2000)
    counts = {}
    for parts in Q_PARTS:
        for shifts, mode in ((6, "ppermute"), (0, "allgather")):
            tag = f"{parts} parts {mode}"
            t0 = time.perf_counter()
            Ag = tpar.distribute_csr(A, parts, max_neighbor_shifts=shifts)
            setup_s = time.perf_counter() - t0
            if Ag.mode != mode:
                raise RuntimeError(f"Q1 {tag}: halo mode {Ag.mode}")
            if Ag.int_wjd.kernel_mode != "roll":
                raise RuntimeError(f"Q1 {tag}: plan chose "
                                   f"{Ag.int_wjd.kernel_mode} mode")
            held, _ = q_hold_interiors(kernels, tpar, "Q1", tag, Ag)
            y = q_apply(tpar, Ag, x)
            _, rel_s = rel_err(y, y_serial, f"Q1 {tag} vs serial rt.spmv",
                               Q_APPLY_TOL)
            _, rel_p = rel_err(y, q_apply(tpar, q_plain(Ag), x),
                               f"Q1 {tag} vs plain", Q_APPLY_TOL)
            M = tpar.block_jacobi_diag(Ag)
            paths = {"WJD": (Ag, M), "plain": (q_plain(Ag), M)}
            with Counted(kernels, totals) as c:
                ms, last = q_turns(tpar, rt.cg, paths, b, **cg_kw)
            its = {}
            for name, (xs, info, _) in last.items():
                it, err = check_solve(f"Q1 {tag} {name}", xs, info,
                                      want_status, 1e-6)
                if abs(it - want_it) > 1:
                    raise RuntimeError(f"Q1 {tag} {name}: {it} iterations, "
                                       f"serial CG (phase D) {want_it}")
                its[name] = it
            solves = len(paths) + len(TURNS)
            n_l = c.got["roll_f64"]
            if n_l < (its["WJD"] + 1) * parts * (solves // 2):
                raise RuntimeError(f"Q1 {tag}: {n_l} roll_f64 launches")
            counts[(parts, mode)] = its["WJD"]
            say("Q1", f"laplacian_3d({Q_LAP_N}) f64 {tag} (shifts "
                f"{Ag.shifts}): distribute_csr {setup_s:.1f} s | {held} | "
                f"apply vs serial rt.spmv {rel_s:.1e}, vs plain {rel_p:.1e}"
                f" (tol {Q_APPLY_TOL:g}) | CG + block_jacobi_diag: WJD {its['WJD']} iters, "
                f"plain {its['plain']} (serial phase D {want_it}), "
                f"{n_l} roll_f64 launches in {solves} solves | ms/iter in "
                f"turns: {turns_text(ms)}")
            if (parts, mode) == (Q_PARTS[0], "ppermute"):
                q1_profile(rt, tpar, Ag, M, b)
            del Ag, M, paths, last
    # the f32 copy through roll_f32
    d, i, p = A.numpy_triplet()
    A32 = rt.CSR.from_arrays(d.astype(np.float32), i, p, A.shape)
    b32 = b.float()
    Ag = tpar.distribute_csr(A32, Q_PARTS[0])
    held, _ = q_hold_interiors(kernels, tpar, "Q1", "f32", Ag)
    M = tpar.block_jacobi_diag(Ag)
    kw32 = dict(rel_tol=1e-5, max_iter=2000)
    with Counted(kernels, totals) as c:
        ms, last = q_turns(tpar, rt.cg,
                           {"WJD": (Ag, M), "plain": (q_plain(Ag), M)}, b32,
                           **kw32)
    (xw, iw, _), (xp_, ip, _) = last["WJD"], last["plain"]
    it_w, err_w = check_solve("Q1 f32 WJD", xw, iw, int(ip.status), 1e-3)
    it_p, _ = check_solve("Q1 f32 plain", xp_, ip, int(ip.status), 1e-3)
    if abs(it_w - it_p) > 1:
        raise RuntimeError(f"Q1 f32: WJD {it_w} vs plain {it_p} iterations")
    if not c.got["roll_f32"]:
        raise RuntimeError("Q1 f32: no roll_f32 launch")
    say("Q1", f"laplacian_3d({Q_LAP_N}) f32 copy, {Q_PARTS[0]} parts "
        f"{Ag.mode}: {held} | CG rel_tol 1e-5: WJD {it_w} iters (status "
        f"{int(iw.status)}, |x-1|/|1|={err_w:.1e}), plain {it_p}, "
        f"{c.got['roll_f32']} roll_f32 launches | ms/iter in turns: "
        f"{turns_text(ms)}")
    return counts


def q1_profile(rt, tpar, Ag, M, b):
    """Where one distributed CG iteration's time goes (`device_profile`):
    rel_tol 0, so a solve of k iterations is k steps."""

    def run(k):
        tpar.dist_solve(rt.cg, Ag, b, M=M, rel_tol=0.0, max_iter=k)

    say("Q1", f"profile of one CG iteration, {Ag.nparts} parts {Ag.mode}: "
        f"{device_profile(run, PROF_WALL_ITERS, PROF_ITERS)}")


def q_blocks(rt, gen, n, nparts):
    """Per-part row blocks of a generator (never assembled globally), the
    offsets and b = A 1 from the blocks alone."""
    from rocalution_tpu_torch.parallel.amg_setup import _offsets

    N = n ** (3 if gen == "3d" else 2)
    make = (rt.utils.generators.laplacian_3d_block if gen == "3d"
            else rt.utils.generators.laplacian_2d_block)
    offs = _offsets(nparts, N)
    blocks = [make(n, int(offs[q]), int(offs[q + 1])) for q in range(nparts)]
    b = np.zeros(N)
    for q, (r, _, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    return blocks, N, b


def q_levels(dl):
    return " / ".join(f"{G.shape[0]} {G.mode}" for G in dl.As)


def q_amg_solve(tpar, solver, dl, b, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = tpar.dist_amg_solve_sharded(solver, dl, b, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    err = float(np.linalg.norm(host64(x) - 1.0) / np.sqrt(x.shape[0]))
    return x, info, s, err


def q_hold_levels(kernels, tpar, phase, tag, dl):
    """`q_hold_interiors` on every level operator of dl, each of which
    must carry a plan. Returns the text and each level's launches an
    apply."""
    texts, levels = [], []
    for l, G in enumerate(dl.As):
        text, per_apply = q_hold_interiors(kernels, tpar, phase,
                                           f"{tag} L{l}", G)
        texts.append(f"L{l} {text}")
        levels.append(per_apply)
    return "; ".join(texts), levels


def q_check_launches(phase, tag, got, levels, its):
    """Raise where a solve of `its` iterations launched fewer kernels
    than its levels need: each level applies its operator at least once
    an iteration, and an apply launches `per_apply` ({counter: n} of each
    of `levels`, from `q_hold_interiors`)."""
    least = {}
    for per_apply in levels:
        for k, n in per_apply.items():
            least[k] = least.get(k, 0) + n * its
    short = {k: (got.get(k, 0), n) for k, n in least.items()
             if got.get(k, 0) < n}
    if short:
        raise RuntimeError(f"{phase} {tag}: launches (got, least) {short}")


def phase_q2(rt, tpar, kernels, totals):
    """The dryrun's flagship at full size: laplacian_3d_block(Q_AMG_N)
    over 8 parts, distributed SA-AMG setup with planned interiors, CG
    rel_tol 1e-5 with the V-cycle."""
    t0 = time.perf_counter()
    blocks, N, b = q_blocks(rt, "3d", Q_AMG_N, Q_PARTS[0])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dl = tpar.distributed_amg_setup(blocks, (N, N), coarse_size=300)
    setup_s = time.perf_counter() - t0
    del blocks
    held, levels = q_hold_levels(kernels, tpar, "Q2", "level", dl)
    with Counted(kernels, totals) as c:
        x, info, s, err = q_amg_solve(tpar, rt.cg, dl, b, rel_tol=1e-5,
                                      max_iter=30)
    status, it = int(info.status), int(info.iterations)
    if status not in (1, 2) or not err < 1e-4:
        raise RuntimeError(f"Q2: status {status}, rms {err:.3e}")
    launched = {k: n for k, n in c.got.items() if n}
    q_check_launches("Q2", "CG + V-cycle", launched, levels, it)
    say("Q2", f"laplacian_3d_block({Q_AMG_N}) f64, {N} rows over "
        f"{Q_PARTS[0]} parts: blocks {gen_s:.1f} s, distributed_amg_setup "
        f"(coarse_size 300, interiors planned) {setup_s:.1f} s, "
        f"{len(dl.As)} levels: {q_levels(dl)} | interior kernels vs plain: "
        f"{held} | CG + V-cycle rel_tol 1e-5: status {status}, {it} iters "
        f"over {len(dl.As)} levels (reference: 8 over 5), rms "
        f"{err:.2e}, {s:.2f} s, {s / max(it, 1) * 1e3:.1f} ms/iter | "
        f"launches {launched}")
    return it


def phase_q3(rt, tpar, kernels, totals):
    """laplacian_2d_block(Q_2D_N) over 8 parts: SA V- and K-cycle; then RS
    and pairwise on laplacian_2d(Q3_N) against the serial hierarchy."""
    from rocalution_tpu_torch.solvers.multigrid import (amg_hierarchy,
                                                        cycle_closure)

    blocks, N, b = q_blocks(rt, "2d", Q_2D_N, Q_PARTS[0])
    t0 = time.perf_counter()
    dl = tpar.distributed_amg_setup(blocks, (N, N), coarse_size=200)
    setup_s = time.perf_counter() - t0
    if dl.As[0].mode != "ppermute":
        raise RuntimeError(f"Q3: fine halo mode {dl.As[0].mode}")
    held, levels = q_hold_levels(kernels, tpar, "Q3", "65k", dl)
    out = []
    for cycle, ref in (("V", 10), ("K", 6)):
        with Counted(kernels, totals) as c:
            _, info, s, err = q_amg_solve(tpar, rt.cg, dl, b, rel_tol=1e-8,
                                          max_iter=100, cycle=cycle)
        it = int(info.iterations)
        if int(info.status) not in (1, 2) or not err < 1e-6:
            raise RuntimeError(f"Q3 {cycle}: status {int(info.status)}, "
                               f"rms {err:.3e}")
        launched = {k: n for k, n in c.got.items() if n}
        q_check_launches("Q3", f"{cycle}-cycle", launched, levels, it)
        out.append(f"{cycle}-cycle {it} iters (reference {ref}), "
                   f"{s / max(it, 1) * 1e3:.1f} ms/iter, launches "
                   f"{launched}")
    say("Q3", f"laplacian_2d_block({Q_2D_N}) f64 over {Q_PARTS[0]} parts: "
        f"setup {setup_s:.1f} s, {len(dl.As)} levels: {q_levels(dl)} | "
        f"{held} | " + "; ".join(out))
    blocks3, N3, b3 = q_blocks(rt, "2d", Q3_N, Q_PARTS[0])
    A3 = rt.laplacian_2d(Q3_N)
    b3_t = torch.from_numpy(b3).to(A3.device)
    for kind, ref in (("rs", "46/18"), ("pairwise", None)):
        t0 = time.perf_counter()
        dl3 = tpar.distributed_amg_setup(blocks3, (N3, N3), kind=kind,
                                         coarse_size=100)
        setup_s = time.perf_counter() - t0
        held3, levels3 = q_hold_levels(kernels, tpar, "Q3", kind, dl3)
        with Counted(kernels, totals) as c:
            _, info, s, err = q_amg_solve(tpar, rt.cg, dl3, b3,
                                          rel_tol=1e-8, max_iter=200)
        h_ser = amg_hierarchy(A3, kind, coarse_size=100)
        _, info_ser = rt.cg(A3, b3_t, M=cycle_closure(h_ser), rel_tol=1e-8,
                            max_iter=200)
        it_d, it_s = int(info.iterations), int(info_ser.iterations)
        if int(info.status) not in (1, 2) or not err < 1e-6 \
                or it_d > 3 * it_s + 5:
            raise RuntimeError(f"Q3 {kind}: status {int(info.status)}, rms "
                               f"{err:.3e}, {it_d} iters vs 3*{it_s}+5")
        launched = {k: n for k, n in c.got.items() if n}
        q_check_launches("Q3", kind, launched, levels3, it_d)
        say("Q3", f"laplacian_2d({Q3_N}) {kind} over {Q_PARTS[0]} parts: "
            f"setup {setup_s:.1f} s, levels {q_levels(dl3)} | {held3} | "
            f"distributed {it_d} iters vs serial {it_s} (bound "
            f"3*serial+5" + (f"; reference {ref}" if ref else "")
            + f"), rms {err:.2e}, {s / max(it_d, 1) * 1e3:.1f} ms/iter, "
            f"launches {launched}")


def phase_q4(rt, tpar, kernels, totals):
    """BlockJacobi with local SPAI, FSAI, ILU(0), ILUT on
    laplacian_3d(Q_LAP_N) over 8 parts: cg for spai and fsai, fgmres for
    ilu0 and ilut, each against the unpreconditioned solve's count."""
    rows = (("spai", "cg"), ("fsai", "cg"), ("ilu0", "fgmres"),
            ("ilut", "fgmres"))
    # the card's apply against the CPU's, at a small size
    checks = []
    for kind, _ in rows:
        worst = 0.0
        small = {}
        for dev in (CARD, "cpu"):
            A_s = rt.laplacian_3d(Q_CHECK_N, device=dev)
            Ag_s = tpar.distribute_csr(A_s, Q_PARTS[0])
            M_s = tpar.block_jacobi_precond(Ag_s, kind)
            r = torch.from_numpy(np.random.default_rng(11).standard_normal(
                Ag_s.nparts * Ag_s.n_local)).to(dev)
            small[dev] = M_s.operator(Ag_s.nparts)(r)
        _, worst = rel_err(small[CARD], small["cpu"].to(CARD),
                           f"Q4 {kind} card vs CPU apply", TOL[torch.float64])
        checks.append(f"{kind} {worst:.1e}")
    say("Q4", f"BlockJacobi apply on the card vs the CPU, laplacian_3d("
        f"{Q_CHECK_N}) over {Q_PARTS[0]} parts: " + ", ".join(checks))
    A = rt.laplacian_3d(Q_LAP_N)
    b = rhs_of_ones(A)
    Ag = tpar.distribute_csr(A, Q_PARTS[0])
    held, per_apply = q_hold_interiors(kernels, tpar, "Q4", "operator", Ag)
    say("Q4", f"laplacian_3d({Q_LAP_N}) f64 over {Q_PARTS[0]} parts: "
        f"{held}")
    kw = dict(rel_tol=1e-8, max_iter=2000)
    base = {}
    for solver in ("cg", "fgmres"):
        with Counted(kernels, totals) as c:
            _, info, _ = q_solve(tpar, getattr(rt, solver), Ag, b, None,
                                 **kw)
        base[solver] = int(info.iterations)
        q_check_launches("Q4", f"{solver} unpreconditioned", c.got,
                         [per_apply], base[solver])
        say("Q4", f"{solver} unpreconditioned: status {int(info.status)}, "
            f"{base[solver]} iters")
    for kind, solver in rows:
        t0 = time.perf_counter()
        M = tpar.block_jacobi_precond(Ag, kind)
        build_s = time.perf_counter() - t0
        with Counted(kernels, totals) as c:
            x, info, s = q_solve(tpar, getattr(rt, solver), Ag, b, M, **kw)
        it, err = check_solve(f"Q4 {kind}", x, info, 2, 1e-6)
        if it > base[solver]:
            raise RuntimeError(f"Q4 {kind}: {it} iterations, "
                               f"unpreconditioned {base[solver]}")
        launched = {k: n for k, n in c.got.items() if n}
        q_check_launches("Q4", kind, launched, [per_apply], it)
        say("Q4", f"laplacian_3d({Q_LAP_N}) f64 over {Q_PARTS[0]} parts, "
            f"{solver} + BlockJacobi({kind}): build {build_s:.1f} s | "
            f"{it} iters (unpreconditioned {base[solver]}), status 2, "
            f"|x-1|/|1|={err:.1e}, {s:.2f} s, "
            f"{s / max(it, 1) * 1e3:.3f} ms/iter, launches {launched}")
        del M


def q5_worker(address, rank, world):
    """One process of phase Q5: its row block of laplacian_3d(Q_LAP_N),
    its part of the operator planned on the card, CG + Jacobi over
    gloo. Prints one JSON line."""
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels
    from rocalution_tpu_torch.parallel.multiproc import (
        dist_solve_spmd, global_csr_multiproc, process_comm)

    os.environ[PLAN_CACHE_ENV] = "0"
    torch.set_num_threads(1)     # processes sharing the host's cores
    comm = process_comm(address, world, rank)
    N = Q_LAP_N ** 3
    nl = -(-N // world)
    lo, hi = rank * nl, min(N, (rank + 1) * nl)
    t0 = time.perf_counter()
    block = rt.utils.generators.laplacian_3d_block(Q_LAP_N, lo, hi)
    Ag = global_csr_multiproc(block, (N, N), comm)
    setup_s = time.perf_counter() - t0
    r, c, d = block
    b = np.zeros(Ag.n_local)
    np.add.at(b, r, d)
    diag = np.ones(Ag.n_local)
    own = c - lo == r
    np.add.at(diag, r[own], d[own] - 1.0)
    x_true = np.zeros(Ag.n_local)
    x_true[: hi - lo] = 1.0
    kw = dict(inv_diag_local=1.0 / diag, x_true_local=x_true, rel_tol=1e-8,
              max_iter=2000)
    dist_solve_spmd(rt.cg, Ag, b, comm, **kw)               # warm-up
    for key in kernels.launches:
        kernels.launches[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info, err = dist_solve_spmd(rt.cg, Ag, b, comm, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    print(json.dumps({
        "rank": rank, "mode": Ag.mode, "status": int(info.status),
        "iterations": int(info.iterations), "err": err, "seconds": s,
        "setup_s": setup_s, "kernel": plan_key(Ag.int_wjd.parts[0]),
        "launches": {k: n for k, n in kernels.launches.items() if n}}),
        flush=True)
    torch.distributed.destroy_process_group()


def phase_q5(totals, want_it):
    """dist_solve_spmd CG + Jacobi on laplacian_3d(Q_LAP_N), one part per
    process (Q_PROCS processes on the one card, gloo): the count must
    equal Q1's at as many parts."""
    import socket

    from rocalution_tpu_torch.parallel.comm import BACKEND

    s = socket.socket()
    s.bind(("localhost", 0))
    address = f"tcp://localhost:{s.getsockname()[1]}"
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        Q5_WORKER + [address, str(rank), str(Q_PROCS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(Q_PROCS)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=Q5_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("Q5: a process failed:\n" + "\n".join(outs))
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    its = {g["iterations"] for g in got}
    if its != {want_it} or any(g["status"] != 2 for g in got):
        raise RuntimeError(f"Q5: counts {sorted(its)}, statuses "
                           f"{[g['status'] for g in got]}; Q1 at "
                           f"{Q_PROCS} parts: {want_it}")
    err = got[0]["err"] / np.sqrt(Q_LAP_N ** 3)
    if not err < 1e-6:
        raise RuntimeError(f"Q5: |x-1|/|1| = {err:.3e}")
    for g in got:
        for key, n in g["launches"].items():
            totals[key] = totals.get(key, 0) + n
    it = got[0]["iterations"]
    slowest = max(g["seconds"] for g in got)
    say("Q5", f"laplacian_3d({Q_LAP_N}) f64, dist_solve_spmd CG + Jacobi, "
        f"{Q_PROCS} processes on one card over {BACKEND} "
        f"({got[0]['mode']}, {got[0]['kernel']}): {it} iters (Q1 at "
        f"{Q_PROCS} parts: {want_it}), |x-1|/|1|={err:.1e} | per process: "
        f"setup {max(g['setup_s'] for g in got):.1f} s, solve "
        f"{slowest:.2f} s, {slowest / it * 1e3:.3f} ms/iter, launches "
        f"{got[0]['launches']} | {time.perf_counter() - t0:.0f} s in all")


def phase_q6(rt, tpar, kernels, totals):
    """Fault 12 at full size: laplacian_3d(Q_WIN_N) f64 from per-part row
    blocks over Q_WIN_PARTS parts, each part's x plane past the stacked
    rule (m * 4 > 12 MiB), so its interior is planned windowed:
    `q_hold_interiors` (one win_roll_f64 launch a part an apply, held to
    plain), then CG + block_jacobi_diag through the kernels and plain."""
    from rocalution_tpu_torch.formats.wjd import X_VMEM_BUDGET, windowed

    t0 = time.perf_counter()
    blocks, N, b = q_blocks(rt, "3d", Q_WIN_N, Q_WIN_PARTS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ag = tpar.global_csr_from_blocks(blocks, (N, N))
    setup_s = time.perf_counter() - t0
    del blocks
    W = Ag.int_wjd
    cols = W.parts[0].shape[1]
    if not (cols * 4 > X_VMEM_BUDGET and all(
            windowed(Wq, Wq.x_dtype) for Wq in W.parts)):
        raise RuntimeError(f"Q6: parts of {cols} columns are not windowed")
    tag = f"{Q_WIN_PARTS} parts {Ag.mode}"
    held, per_apply = q_hold_interiors(kernels, tpar, "Q6", tag, Ag)
    if set(per_apply) != {"win_roll_f64"}:
        raise RuntimeError(f"Q6: launches of one apply {per_apply}")
    M = tpar.block_jacobi_diag(Ag)
    cg_kw = dict(rel_tol=1e-8, max_iter=4000)
    with Counted(kernels, totals) as c:
        xw, iw, sw = q_solve(tpar, rt.cg, Ag, b, M, **cg_kw)
    xp_, ip, sp_ = q_solve(tpar, rt.cg, q_plain(Ag), b, M, **cg_kw)
    it_w, err_w = check_solve("Q6 WJD", xw, iw, 2, 1e-6)
    it_p, _ = check_solve("Q6 plain", xp_, ip, 2, 1e-6)
    if abs(it_w - it_p) > 1:
        raise RuntimeError(f"Q6: WJD {it_w} vs plain {it_p} iterations")
    launched = {k: n for k, n in c.got.items() if n}
    q_check_launches("Q6", "CG", launched, [per_apply], it_w)
    say("Q6", f"laplacian_3d({Q_WIN_N}) f64, {N} rows over {tag} "
        f"({cols} columns a part): blocks {gen_s:.1f} s, "
        f"global_csr_from_blocks (interiors planned, windowed: win_rows "
        f"{W.parts[0].win_rows}, {len(W.parts[0].win_base)} windows a part) "
        f"{setup_s:.1f} s | {held} | CG + block_jacobi_diag: WJD {it_w} "
        f"iters (|x-1|/|1|={err_w:.1e}) {sw:.2f} s, "
        f"{sw / max(it_w, 1) * 1e3:.3f} ms/iter; plain {it_p} iters "
        f"{sp_:.2f} s, {sp_ / max(it_p, 1) * 1e3:.3f} ms/iter | launches "
        f"{launched}")


def phase_q(rt, kernels, totals, want_d):
    """The distributed layer on the card (module docstring)."""
    from rocalution_tpu_torch import parallel as tpar

    t0 = time.perf_counter()

    def lap(name):
        torch.cuda.empty_cache()
        say(name, f"phase {name}: {time.perf_counter() - t0:.0f} s")

    counts = phase_q1(rt, tpar, kernels, totals, want_d)
    lap("Q1")
    t0 = time.perf_counter()
    phase_q2(rt, tpar, kernels, totals)
    lap("Q2")
    t0 = time.perf_counter()
    phase_q3(rt, tpar, kernels, totals)
    lap("Q3")
    t0 = time.perf_counter()
    phase_q4(rt, tpar, kernels, totals)
    lap("Q4")
    t0 = time.perf_counter()
    phase_q5(totals, counts[(Q_PROCS, "ppermute")])
    lap("Q5")
    t0 = time.perf_counter()
    phase_q6(rt, tpar, kernels, totals)
    lap("Q6")


def r1_rows(bench_cli, argv):
    """bench_cli.main(argv) in this process, its JSON lines kept off this
    script's output; the rows it wrote with --out."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r1_") as tmp:
        out = os.path.join(tmp, "rows.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            bench_cli.main(argv + ["--out", out])
        with open(out) as f:
            return [json.loads(line) for line in f]


def phase_r1(rt, kernels, totals, plans):
    """The bench CLI at full size on the card: each case through the
    kernels (auto-attach, the plan read back from the run's plan cache)
    and with auto-attach off, held to each other."""
    from rocalution_tpu_torch import bench_cli

    base = ["--matrix", "laplacian3d", "--size", str(R_LAP_N)]
    rows = {"WJD": [], "plain": []}
    for solvers, pre in R1_CASES:
        argv = base + ["--solver", solvers, "--precond", pre]
        with plan_cache(plans), Counted(kernels, totals):
            rows["WJD"] += r1_rows(bench_cli, argv)
        rt.set_auto_wjd(False)
        try:
            rows["plain"] += r1_rows(bench_cli, argv)
        finally:
            rt.set_auto_wjd(None)
    for w, p in zip(rows["WJD"], rows["plain"]):
        tag = f"R1 {w['solver']}+{w['precond']} {w['matrix']}"
        if "error" in w or "error" in p:
            raise RuntimeError(f"{tag}: {w.get('error')} {p.get('error')}")
        engine = set(w["engine"].split("+"))
        need = {"roll_f64"} | ({"gather_f64"} if w["solver"] == "saamg"
                               else set())
        if not need <= engine or p["engine"] != "plain":
            raise RuntimeError(f"{tag}: engine {w['engine']} (need {need}),"
                               f" plain path {p['engine']}")
        slack = R1_SLACK[w["solver"]]
        if (w["convergence"], p["convergence"]) != (True, True) or (
                slack is not None and abs(w["iter"] - p["iter"]) > slack):
            raise RuntimeError(f"{tag}: WJD {w['iter']} iters converged "
                               f"{w['convergence']}, plain {p['iter']} "
                               f"converged {p['convergence']}")
        if not w["nrmmax_err"] < 1e-5:
            raise RuntimeError(f"{tag}: max|x-1| {w['nrmmax_err']:.3e}")
        say("R1", f"{w['solver']}+{w['precond']} {w['matrix']} n={w['n']}: "
            f"engine {w['engine']}, {w['iter']} iters (plain {p['iter']}, "
            f"held {'to the status' if slack is None else f'within {slack}'}"
            f"), max|x-1| {w['nrmmax_err']:.1e} | import / analyze / solve "
            f"s: WJD {w['time_import_s']} / {w['time_analyze_s']} / "
            f"{w['time_solve_s']}, plain {p['time_import_s']} / "
            f"{p['time_analyze_s']} / {p['time_solve_s']} | ms/iter WJD "
            f"{w['time_solve_s'] / max(w['iter'], 1) * 1e3:.3f}, plain "
            f"{p['time_solve_s'] / max(p['iter'], 1) * 1e3:.3f}")


def r2_check(name, out):
    """tests/test_clients.py's check of a sample's output; the counts it
    printed."""
    counts = [int(v) for v in re.findall(r"iters=(\d+)", out)]
    if name not in R2_NO_CONVERGENCE_CHECK:
        errs = re.findall(r"err(?:or)?[=:]\s*([0-9.e+-]+)", out)
        if not ("status=1" in out or "status=2" in out
                or "converged" in out.lower()
                or (errs and float(errs[-1]) < 1e-3)):
            raise RuntimeError(f"R2 {name}: no convergence in\n{out}")
        return f"converged, iters {counts}"
    return f"own check passed, iters {counts}"


def phase_r2(kernels, totals):
    """Every sample of SAMPLES in this process at its own size (R2_ENV
    for the two scale demos): its own check, and a launch on the card
    where it solves a CSR operator."""
    names = sorted(f[:-3] for f in os.listdir(SAMPLES) if f.endswith(".py"))
    for name in names:
        path = os.path.join(SAMPLES, f"{name}.py")
        env = R2_ENV.get(name, {})
        saved = (list(sys.argv), list(sys.path),
                 {k: os.environ.get(k) for k in env})
        os.environ.update(env)
        sys.argv = [path]
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with Counted(kernels, totals) as c, \
                    contextlib.redirect_stdout(out):
                runpy.run_path(path, run_name="__main__")
            torch.cuda.synchronize()
        finally:
            sys.argv, sys.path = saved[0], saved[1]
            for k, v in saved[2].items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        s = time.perf_counter() - t0
        check = r2_check(name, out.getvalue())
        moved = {k: n for k, n in c.got.items() if n}
        if not moved and name not in R2_NO_KERNEL:
            raise RuntimeError(f"R2 {name}: no kernel launch")
        why = f" ({R2_NO_KERNEL[name]})" if name in R2_NO_KERNEL else ""
        size = f" at {env}" if env else ""
        say("R2", f"{name}{size}: {s:.1f} s | {check} | launches "
            f"{moved}{why}")
        torch.cuda.empty_cache()


def phase_r(rt, kernels, totals, plans):
    t0 = time.perf_counter()
    phase_r1(rt, kernels, totals, plans)
    say("R1", f"phase R1: {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    dist = R2_ENV["poisson3d_dist"]
    say("R2", f"poisson3d_dist at POISSON_N={dist['POISSON_N']}, "
        f"PARTS={dist['PARTS']}: its 256^3 default is cut for time (the "
        "JAX sample's docstring gives 412 s of setup alone)")
    phase_r2(kernels, totals)
    say("R2", f"phase R2: {time.perf_counter() - t0:.0f} s")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU and has no CPU mode")
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as kernels

    # no phase writes under ~: the plan cache is off but where a phase
    # points it at this run's directory (C, I, P1 and R1: an operator planned
    # again is read back) or at a fresh one (P2)
    os.environ[PLAN_CACHE_ENV] = "0"
    plans = tempfile.TemporaryDirectory(prefix="chip_smoke_plans_")
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
    measured, padded = phase_c(rt, kernels, ops, plans.name)
    lap("C")

    # main paths: each runs with the counts set to 0 just before it and
    # read just after; `totals` adds them up per entry point
    totals = {}
    with Counted(kernels, totals):
        A, A_plain, b, want_d = phase_d(rt, kernels)
        want_e = phase_solve(rt, kernels, "E",
                             f"random_banded_spd({RAND_N}) f64", rand64,
                             "gather_f64", 1e-8, 1e-6)
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
        1e-6, plans.name)
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
                         1e-3, plans.name)
        measured.update(row)
        win_ops[tag] = (A, {})
        torch.cuda.empty_cache()
    lap("I")

    for name, phase in (("K", phase_k), ("L", phase_l), ("M", phase_m)):
        phase(rt, kernels, totals)
        lap(name)

    rows, bf16 = phase_n1(rt, kernels, totals, {
        f"laplacian_3d({LAP_N}) f32 unsplit": (lap32, {}),
        f"random_banded_spd({RAND_N}) f32": (rand32, {})}, win_ops,
        plans.name)
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
    phase_o(rt, kernels, totals)
    lap("O")
    phase_p(rt, kernels, totals, {"D": want_d, "E": want_e}, plans.name)
    lap("P")
    phase_q(rt, kernels, totals, want_d)
    lap("Q")
    phase_r(rt, kernels, totals, plans.name)
    plans.cleanup()
    lap("R")

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
    if sys.argv[1:2] == ["--q5-worker"]:
        q5_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
