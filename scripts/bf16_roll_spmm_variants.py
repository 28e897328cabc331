"""Time the direct bf16 roll SpMV and the compact bf16 SpMM beside the
kernels they replace and the shapes tried on the way, on one NVIDIA GPU.

    python scripts/bf16_roll_spmm_variants.py [--lap-n 100] [--rand-n 1048576]
                                              [--turns 8]

The operators are chip_smoke.py phase N1's direct ones: the bf16 plans (the
f32 plans with their values rounded) of laplacian_3d(lap_n) f32 in roll
mode, and of random_banded_spd(rand_n) f32 in gather mode, whose compact
form is taken with 4-byte offsets (the form a bf16 plan whose offsets pass
16 bits keeps; at this size its offsets fit 16 bits, so the package uploads
it packed and N1 unpacks it). On each, in one process and on the same x (X
of 16 columns for the blocked products), this times with CUDA events (one
warm-up, then `turns` rounds in alternating order, each the mean of 20
back-to-back launches, 200 for the roll kernels, which take ~10 us, after
a spin of the device long enough for the host to queue them all; the
median is printed):

  roll  the package's roll_f32 (the f32 plan) and roll_bf16 (the windowed
        bf16 roll body with no window: 4 rows a thread, one slot a step,
        blocks that fill an SM); not shipped: the f32 template on bf16
        values, one thread a row (the kernel before, from the source
        below), the direct body at 2 rows a thread, and at 4 with no bound
        on its registers (the windowed kernel over one window at base 0);
        each entry point called by ctypes alone, since a call through the
        package costs the host more than these kernels take;
  spmm  k = 16, through the package: spmm_gather_f32 (the f32 plan's
        compact form), spmm_gather_bf16 (values held raw, 4 ranks a group)
        and the packed SpMM of the same bf16 plan; not shipped: the f32
        template on bf16 values (the kernel before), the raw body at 1, 2,
        4 and 8 ranks a group, the raw body on the f32 plan (4 ranks), and
        the raw body with X gathered 16 bytes a lane (KC/4 lanes a row).

The designs not shipped are built from the package's own sources with
-DWJD_VARIANTS, and the roll kernel before from the source in this file
(nvcc, sm_90a, into rocalution_tpu_torch/_build/variants/). Every product
is held to the plain version over its form (1e-5, norm-wise). Prints one
line a kernel, the card's name and its power limit.
"""

import argparse
import ctypes
import dataclasses
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROLL_BEFORE_CU = r"""
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// csrc/spmv_wjd.cu's roll template as its bf16 instantiation was: one
// thread a row, 256 rows a block, brow and diag_u loaded a slot
__global__ void __launch_bounds__(256)
roll_before(const __nv_bfloat16* __restrict__ data,
            const int32_t* __restrict__ brow,
            const int32_t* __restrict__ diag_u, const float* __restrict__ xp,
            float* __restrict__ y, int K) {
  const int64_t t = blockIdx.x / 4;
  const int r = (blockIdx.x % 4) * 256 + threadIdx.x;
  const int s = r >> 7;
  const int l = r & 127;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int64_t slot = t * K + k;
    const int u = __ldg(diag_u + slot);
    const int64_t xi =
        (static_cast<int64_t>(__ldg(brow + slot)) + s) * 128 + l + u;
    acc += __bfloat162float(__ldg(data + slot * 1024 + r)) * __ldg(xp + xi);
  }
  y[t * 1024 + r] = acc;
}

extern "C" int v_roll_before(const void* data, const void* brow,
                             const void* diag_u, const void* xp, void* y,
                             int64_t tp, int k, void* stream) {
  roll_before<<<static_cast<unsigned>(tp * 4), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(data),
      static_cast<const int32_t*>(brow), static_cast<const int32_t*>(diag_u),
      static_cast<const float*>(xp), static_cast<float*>(y), k);
  return static_cast<int>(cudaGetLastError());
}
"""
TOL = 1e-5
COLS = 16
AHEADS = (1, 2, 4, 8)


def build_variants(build_dir):
    """spmm_wjd.cu and spmv_wjd_win.cu with -DWJD_VARIANTS, and
    ROLL_BEFORE_CU, one nvcc each, together; their entry points with
    argument types set."""
    from rocalution_tpu_torch.ops.cuda import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    (build_dir / "roll_before.cu").write_text(ROLL_BEFORE_CU)
    srcs = {"spmm_wjd": _build.CSRC / "spmm_wjd.cu",
            "spmv_wjd_win": _build.CSRC / "spmv_wjd_win.cu",
            "roll_before": build_dir / "roll_before.cu"}
    jobs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-DWJD_VARIANTS", "-o",
         str(build_dir / f"lib{name}_variants.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    libs = {name: ctypes.CDLL(str(build_dir / f"lib{name}_variants.so"))
            for name in srcs}
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    compact = [P, P, INT, P, P, P, P, I64, INT, P]
    fns = {"roll_before": (libs["roll_before"], "v_roll_before",
                           [P, P, P, P, P, I64, INT, P]),
           "roll": (libs["spmv_wjd_win"], "wjd_spmv_win_roll_bf16_variant",
                    [INT, INT, P, P, P, P, P, P, I64, INT, INT, INT, P]),
           "roll_direct": (libs["spmv_wjd_win"], "wjd_spmv_roll_bf16_variant",
                           [INT, P, P, P, P, P, I64, INT, P]),
           "spmm_before": (libs["spmm_wjd"], "wjd_spmm_gather_bf16_before",
                           compact),
           "spmm_raw": (libs["spmm_wjd"], "wjd_spmm_gather_raw_variant",
                        [INT, INT] + compact),
           "spmm_x4": (libs["spmm_wjd"], "wjd_spmm_gather_bf16_x4_variant",
                       compact)}
    out = {}
    for key, (lib, name, argtypes) in fns.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, INT
        out[key] = fn
    return out


def timed(fns, turns, launches):
    """{name: median ms} of fns {name: fn}: one warm-up each, then `turns`
    rounds in alternating order, each the mean of `launches` launches
    queued behind a spin of ~30 us a launch, so that the events time the
    device and not the host's calls."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    for t in range(turns):
        for name in (names if t % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000 * launches)
            start.record()
            for _ in range(launches):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / launches)
    return {name: statistics.median(v) for name, v in times.items()}


def norm_rel(got, want):
    d = got.double().reshape(-1) - want.double().reshape(-1)
    return float(torch.linalg.norm(d) / torch.linalg.norm(
        want.double().reshape(-1)))


def run(title, runs, turns, launches=20):
    """Hold each of runs {name: (fn, want)} to its plain version, then time
    them in turns; print a line each."""
    for name, (fn, want) in runs.items():
        rel = norm_rel(fn(), want)
        assert rel <= TOL, (name, rel)
        print(f"  {name}: vs plain {rel:.2e}")
    for name, ms in timed({n: f for n, (f, _) in runs.items()}, turns,
                          launches).items():
        print(f"{title} {name}: {ms * 1e3:.1f} us")


def plans(fw, A, **kw):
    """The f32 plan of A on the card, its bf16 plan (the f32 plan with its
    values rounded) on the card, and the bf16 host plan."""
    plan32 = fw.csr_to_wjd_plan(*A.numpy_triplet(), A.shape, cache=False,
                                **kw)
    plan16 = fw._rounded_to_bf16(plan32)
    return (fw._plan_to_wjd(plan32, "cuda"), fw._plan_to_wjd(plan16, "cuda"),
            plan16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lap-n", type=int, default=100)
    ap.add_argument("--rand-n", type=int, default=1 << 20)
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.formats import wjd as fw
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as k

    os.environ["ROCALUTION_TPU_TORCH_PLAN_CACHE"] = "0"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    k.build()
    v = build_variants(ROOT / "rocalution_tpu_torch" / "_build" /
                       "variants")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(1234)

    # ---- roll: laplacian_3d, direct ----
    A = rt.laplacian_3d(args.lap_n, dtype=np.float32, device="cpu")
    W32, W, _ = plans(fw, A, kernel_mode="roll", split_dia=False)
    assert W.kernel_mode == "roll" and not fw.windowed(W, torch.float32)
    Tp, K = W.brow.shape
    print(f"laplacian_3d({args.lap_n}) f32 -> bf16: nnz={A.nnz}, (Tp,K)="
          f"({Tp},{K}) | {card}")
    x = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).cuda()
    xp, xp32 = k.pad_x(W, x), k.pad_x(W32, x)
    yr = torch.empty(Tp * 1024, dtype=torch.float32, device="cuda")
    plain = k.slots_plain(W, xp)
    planes = (W.data.data_ptr(), W.brow.data_ptr(), W.diag_u.data_ptr())

    lib = {name: k._build.load(name) for name in ("spmv_wjd", "spmv_wjd_win")}

    def thin(fn, *head, planes=planes, x=xp, tail=()):
        """A roll entry point called by ctypes alone: the calls through the
        package cost the host ~25 us each, more than these kernels."""
        def go():
            assert fn(*head, *planes, *tail[:1], x.data_ptr(), yr.data_ptr(),
                      Tp, K, *tail[1:], stream) == 0
            return yr
        return go

    for name in ("wjd_spmv_roll_f32", "wjd_spmv_roll_bf16"):
        lib_of = lib["spmv_wjd" if name.endswith("f32") else "spmv_wjd_win"]
        getattr(lib_of, name).argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        getattr(lib_of, name).restype = ctypes.c_int
    # the whole plan as one window at base 0: the windowed kernel, whose
    # registers are unbounded, as a direct one
    wb0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    runs = {"roll_f32 (f32 plan)": (
                thin(lib["spmv_wjd"].wjd_spmv_roll_f32, x=xp32, planes=(
                    W32.data.data_ptr(), W32.brow.data_ptr(),
                    W32.diag_u.data_ptr())),
                k.slots_plain(W32, xp32)),
            "roll_bf16, the f32 template (before)": (
                thin(v["roll_before"]), plain),
            "roll_bf16, 4 rows a thread, full SM (shipped)": (
                thin(lib["spmv_wjd_win"].wjd_spmv_roll_bf16), plain),
            "2 rows a thread, full SM": (thin(v["roll_direct"], 2), plain),
            "4 rows a thread, registers unbounded (the windowed kernel, one "
            "window)": (thin(v["roll"], 4, 1, tail=(
                wb0.data_ptr(), Tp, W.xp_len // 128)), plain)}
    run("roll", runs, args.turns, launches=200)
    del A, W32, W, plain, xp, xp32, yr
    torch.cuda.empty_cache()

    # ---- spmm: random_banded_spd, the compact form on 4-byte offsets ----
    A = rt.random_banded_spd(args.rand_n, dtype=np.float32, device="cpu")
    W32, W, plan16 = plans(fw, A)
    assert W.kernel_mode == "gather" and not W.window_relative
    comp = fw.compact_slices(plan16)
    Wc = dataclasses.replace(
        W, cpack=None, slice_ptr=torch.from_numpy(comp["slice_ptr"]).cuda(),
        cval=torch.from_numpy(comp["cval"]).cuda().to(torch.bfloat16),
        coff=torch.from_numpy(comp["coff"].astype(np.int32)).cuda())
    assert Wc.compact_form == "compact"
    print(f"random_banded_spd({args.rand_n}) f32 -> bf16: nnz={A.nnz}, "
          f"compact {Wc.cval.numel()} elements "
          f"({Wc.cval.numel() / W.nnz:.4f} a nonzero), 4-byte offsets; "
          f"the f32 plan's offsets {W32.coff.dtype} | {card}")
    X = torch.from_numpy(rng.standard_normal((A.shape[1], COLS)).astype(
        np.float32)).cuda()
    Xp, Xp32 = k.pad_x(W, X, COLS), k.pad_x(W32, X, COLS)
    nsl = Wc.xbase.numel()
    Y = torch.empty((nsl * 32, COLS), dtype=torch.float32, device="cuda")
    plain = k.slots_plain_compact_mrhs(Wc, Xp)
    plain32 = k.slots_plain_compact_mrhs(W32, Xp32)

    def compact(fn, head, Wf, Xf):
        ops = (Wf.cval.data_ptr(), Wf.coff.data_ptr(),
               Wf.coff.element_size(), Wf.slice_ptr.data_ptr(),
               Wf.xbase.data_ptr(), Xf.data_ptr(), Y.data_ptr(), nsl, COLS,
               stream)

        def go():
            assert fn(*head, *ops) == 0
            return Y
        return go

    runs = {"spmm_gather_f32 (f32 plan)": (
                lambda: k.slots_kernel_mrhs(W32, Xp32), plain32),
            "spmm_gather_bf16 packed (the same plan packed)": (
                lambda: k.slots_kernel_mrhs(W, Xp),
                k.slots_plain_packed_mrhs(W, Xp)),
            "spmm_gather_bf16, the template (before)": (
                compact(v["spmm_before"], (), Wc, Xp), plain),
            "spmm_gather_bf16 (shipped)": (
                lambda: k.slots_kernel_mrhs(Wc, Xp), plain)}
    for d in AHEADS:
        runs[f"raw, {d} ranks a group"] = (
            compact(v["spmm_raw"], (0, d), Wc, Xp), plain)
    runs["spmm_gather_f32 raw, 4 ranks a group (f32 plan)"] = (
        compact(v["spmm_raw"], (1, 4), W32, Xp32), plain32)
    runs["raw, 4 ranks a group, X 16 bytes a lane"] = (
        compact(v["spmm_x4"], (), Wc, Xp), plain)
    run(f"spmm k={COLS}", runs, args.turns)
    print(card)


if __name__ == "__main__":
    main()
