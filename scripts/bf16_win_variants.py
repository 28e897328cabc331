"""Time the two windowed bf16 kernels beside the kernels they replace and
the designs tried on the way that the package does not ship, on one
NVIDIA GPU.

    python scripts/bf16_win_variants.py [--rand-n 4194304] [--lap-n 180]
                                        [--turns 8]

The operators are chip_smoke.py phase N1's windowed ones: the bf16 plans
(the f32 plans with their values rounded) of random_banded_spd(rand_n) f32
in gather mode and laplacian_3d(lap_n) f32 in roll mode, both in the
windowed regime at the default sizes. On each, in one process and on the
same x (X of 16 columns for the blocked products), this times with CUDA
events (one warm-up, then `turns` rounds in alternating order, each the
mean of 20 back-to-back launches; the median is printed):

  gather  through the package: win_gather_f32 (the f32 plan), the compact
          bf16 windowed kernel on the window-relative form with 2-byte
          offsets (the kernel before the packed form), and the packed
          windowed kernel (csrc/wjd_bf16_packed.cu: one block a grid
          step); not shipped: the same body in blocks of one tile, as the
          direct kernel (wjd_spmv_win_gather_bf16_packed_tile), and a
          layout of 2 ranks a lane, one 8-byte load of two words, its
          width padded to 2 ranks in place of 4, in blocks of one tile
          (spmv_pack2, the source below);
  spmm    k = 16: the f32 plan's, the compact bf16 SpMM on the same
          2-byte offsets, and the packed SpMM through xbase, which holds
          the step windows;
  roll    through the package: win_roll_f32 and win_roll_bf16 (4 rows a
          thread, 1 slot a batch); not shipped: the f32 template on bf16
          values (the kernel before), and the new body at 2 or 4 rows a
          thread and 1, 2, 4 or 8 slots a batch.

The designs not shipped are built from the package's own sources with
-DWJD_VARIANTS, and spmv_pack2 from the source in this file (nvcc, sm_90a,
into rocalution_tpu_torch/_build/variants/). Every product is held to the
plain version over its form (1e-5, norm-wise). Prints one line a kernel,
the card's name and its power limit.
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

PACK2_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

// the windowed packed SpMV over words of 2 ranks a lane: word (j, lane) of
// slice i at ptr[i] + (j / 2)*64 + lane*2 + j % 2; one 8-byte load a step,
// unrolled by 4 (8 gathers in flight, as the shipped kernel)
__global__ void __launch_bounds__(1024)
spmv_pack2(const uint2* __restrict__ cpack, const int64_t* __restrict__ ptr,
           const int32_t* __restrict__ win_base,
           const float* __restrict__ xp, float* __restrict__ y,
           int64_t nslices, int slices_per_step) {
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * 32 +
                        threadIdx.x / 32;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % 32;
  const float* __restrict__ xs =
      xp + static_cast<int64_t>(__ldg(win_base + slice / slices_per_step)) *
               128;
  const int64_t end = __ldg(ptr + slice + 1) / 2;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t g = __ldg(ptr + slice) / 2 + lane; g < end; g += 32) {
    const uint2 w = __ldcs(cpack + g);
    const float x0 = __ldg(xs + (w.x >> 16));
    const float x1 = __ldg(xs + (w.y >> 16));
    acc = fmaf(__uint_as_float(w.x << 16), x0, acc);
    acc = fmaf(__uint_as_float(w.y << 16), x1, acc);
  }
  y[slice * 32 + lane] = acc;
}

extern "C" int v_pack2(const void* cpack, const void* ptr,
                       const void* win_base, const void* xp, void* y,
                       int64_t nslices, int slices_per_step, void* stream) {
  spmv_pack2<<<static_cast<unsigned>((nslices + 31) / 32), 1024, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(cpack), static_cast<const int64_t*>(ptr),
      static_cast<const int32_t*>(win_base), static_cast<const float*>(xp),
      static_cast<float*>(y), nslices, slices_per_step);
  return static_cast<int>(cudaGetLastError());
}
"""
TOL = 1e-5
COLS = 16
ROLL_SHAPES = [(rows, unroll) for rows in (2, 4) for unroll in (1, 2, 4, 8)]


def build_variants(build_dir):
    """The package's two sources with -DWJD_VARIANTS, and PACK2_CU, one
    nvcc each, together; their libraries with argument types set."""
    from rocalution_tpu_torch.ops.cuda import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    (build_dir / "pack2.cu").write_text(PACK2_CU)
    srcs = {"wjd_bf16_packed": _build.CSRC / "wjd_bf16_packed.cu",
            "spmv_wjd_win": _build.CSRC / "spmv_wjd_win.cu",
            "pack2": build_dir / "pack2.cu"}
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
    fns = {"tile": (libs["wjd_bf16_packed"],
                    "wjd_spmv_win_gather_bf16_packed_tile",
                    [P, P, P, P, P, I64, INT, P]),
           "pack2": (libs["pack2"], "v_pack2", [P, P, P, P, P, I64, INT, P]),
           "before": (libs["spmv_wjd_win"], "wjd_spmv_win_roll_bf16_before",
                      [P, P, P, P, P, P, I64, INT, INT, INT, P]),
           "roll": (libs["spmv_wjd_win"], "wjd_spmv_win_roll_bf16_variant",
                    [INT, INT, P, P, P, P, P, P, I64, INT, INT, INT, P])}
    out = {}
    for key, (lib, name, argtypes) in fns.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, INT
        out[key] = fn
    return out


def pack2(comp):
    """The 2-rank layout of a window-relative compact form with uint16
    offsets: uint32 words (bf16 bits | offset << 16), word (j, lane) of a
    slice at ptr + (j // 2)*64 + lane*2 + j % 2, widths padded to 2."""
    cval, coff, ptr = comp["cval"], comp["coff"], comp["slice_ptr"]
    width = np.diff(ptr) // 32
    pptr = np.zeros_like(ptr)
    np.cumsum(-(-width // 2) * 64, out=pptr[1:])
    per = width * 32
    r = np.arange(len(cval), dtype=np.int64) - np.repeat(ptr[:-1], per)
    j, lane = r >> 5, r & 31
    dest = np.repeat(pptr[:-1], per) + ((j >> 1) << 6) + (lane << 1) + (j & 1)
    words = np.zeros(int(pptr[-1]), np.uint32)
    words[dest] = (cval.view(np.uint32) >> 16) | (coff.astype(np.uint32)
                                                 << 16)
    return words, pptr


def timed(fns, turns):
    """{name: median ms} of fns {name: fn}: one warm-up each, then `turns`
    rounds in alternating order, each the mean of 20 launches."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    for t in range(turns):
        for name in (names if t % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            start.record()
            for _ in range(20):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 20)
    return {name: statistics.median(v) for name, v in times.items()}


def norm_rel(got, want):
    d = got.double().reshape(-1) - want.double().reshape(-1)
    return float(torch.linalg.norm(d) / torch.linalg.norm(
        want.double().reshape(-1)))


def run(title, runs, turns):
    """Hold each of runs {name: (fn, want)} to its plain version, then time
    them in turns; print a line each."""
    for name, (fn, want) in runs.items():
        rel = norm_rel(fn(), want)
        assert rel <= TOL, (name, rel)
        print(f"  {name}: vs plain {rel:.2e}")
    for name, ms in timed({n: f for n, (f, _) in runs.items()},
                          turns).items():
        print(f"{title} {name}: {ms * 1e3:.1f} us")


def plans(fw, A, **kw):
    """The f32 plan of A on the card and its bf16 plan (the f32 plan with
    its values rounded), and the bf16 host plan."""
    plan32 = fw.csr_to_wjd_plan(*A.numpy_triplet(), A.shape, cache=False,
                                **kw)
    plan16 = fw._rounded_to_bf16(plan32)
    return (fw._plan_to_wjd(plan32, "cuda"), fw._plan_to_wjd(plan16, "cuda"),
            plan16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rand-n", type=int, default=1 << 22)
    ap.add_argument("--lap-n", type=int, default=180)
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

    # ---- gather: random_banded_spd, windowed ----
    A = rt.random_banded_spd(args.rand_n, dtype=np.float32, device="cpu")
    W32, W, plan16 = plans(fw, A)
    assert W.compact_form == "packed" and fw.windowed(W, torch.float32)
    comp = fw.compact_slices(plan16, window_relative=True)
    Wc = dataclasses.replace(W, cpack=None, slice_ptr=torch.from_numpy(
        comp["slice_ptr"]).cuda(), cval=torch.from_numpy(comp["cval"]).cuda()
        .to(torch.bfloat16), coff=torch.from_numpy(comp["coff"]).cuda())
    words, pptr = pack2(comp)
    w2 = torch.from_numpy(words.view(np.int32)).cuda()
    p2 = torch.from_numpy(pptr).cuda()
    nsteps, sps = W.win_base.numel(), W.group * 32
    print(f"random_banded_spd({args.rand_n}) f32 -> bf16: nnz={A.nnz}, "
          f"{nsteps} steps of {W.group} tiles, win_rows={W.win_rows} | "
          f"compact {len(comp['cval'])} elements "
          f"({len(comp['cval']) / W.nnz:.4f} a nonzero), packed "
          f"{W.cpack.numel()} words ({W.compact_padding_ratio:.4f}), "
          f"2-rank {len(words)} words ({len(words) / W.nnz:.4f}) | {card}")
    x = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).cuda()
    X = torch.from_numpy(rng.standard_normal((A.shape[1], COLS)).astype(
        np.float32)).cuda()
    xp, Xp = k.pad_x(W, x), k.pad_x(W, X, COLS)
    xp32, Xp32 = k.pad_x(W32, x), k.pad_x(W32, X, COLS)
    y = torch.empty(W.xbase.numel() * 32, dtype=torch.float32, device="cuda")
    plain = k.slots_plain_packed_windowed(W, xp)

    def launcher(fn, words, ptr, count):
        def go():
            assert fn(words.data_ptr(), ptr.data_ptr(),
                      W.win_base.data_ptr(), xp.data_ptr(), y.data_ptr(),
                      count, sps, stream) == 0
            return y
        return go

    tile = launcher(v["tile"], W.cpack, W.slice_ptr, nsteps)
    two = launcher(v["pack2"], w2, p2, W.xbase.numel())
    run("win gather", {
        "win_gather_f32 (f32 plan)": (
            lambda: k.slots_kernel_windowed(W32, xp32),
            k.slots_plain_compact_windowed(W32, xp32)),
        "win_gather_bf16 compact, 2-byte offsets (before)": (
            lambda: k.slots_kernel_windowed(Wc, xp),
            k.slots_plain_compact_windowed(Wc, xp)),
        "win_gather_bf16 packed, a block a grid step (shipped)": (
            lambda: k.slots_kernel_windowed(W, xp), plain),
        "packed, a block a tile": (tile, plain),
        "2 ranks a lane, 8-byte loads": (two, plain)}, args.turns)
    del plain
    run(f"spmm k={COLS}", {
        "spmm_gather_f32 (f32 plan)": (
            lambda: k.slots_kernel_mrhs(W32, Xp32),
            k.slots_plain_compact_mrhs(W32, Xp32)),
        "spmm_gather_bf16 compact, 2-byte offsets": (
            lambda: k.slots_kernel_mrhs(Wc, Xp),
            k.slots_plain_compact_mrhs(Wc, Xp)),
        "spmm_gather_bf16 packed (shipped)": (
            lambda: k.slots_kernel_mrhs(W, Xp),
            k.slots_plain_packed_mrhs(W, Xp))}, args.turns)
    del A, W32, W, Wc, plan16, comp, w2, X, Xp, Xp32
    torch.cuda.empty_cache()

    # ---- roll: laplacian_3d, windowed ----
    A = rt.laplacian_3d(args.lap_n, dtype=np.float32, device="cpu")
    W32, W, _ = plans(fw, A, kernel_mode="roll", split_dia=False)
    assert fw.windowed(W, torch.float32) and W.kernel_mode == "roll"
    Tp, K = W.brow.shape
    print(f"laplacian_3d({args.lap_n}) f32 -> bf16: nnz={A.nnz}, (Tp,K)="
          f"({Tp},{K}), {W.win_base.numel()} steps of {W.group} tiles, "
          f"win_rows={W.win_rows} | {card}")
    x = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).cuda()
    xp, xp32 = k.pad_x(W, x), k.pad_x(W32, x)
    yr = torch.empty(Tp * 1024, dtype=torch.float32, device="cuda")
    plain = k.slots_plain_windowed(W, xp)
    args_of = (W.data.data_ptr(), W.brow.data_ptr(), W.diag_u.data_ptr(),
               W.win_base.data_ptr(), xp.data_ptr(), yr.data_ptr(), Tp, K,
               W.group, W.win_rows, stream)

    def roll(*head, fn):
        def go():
            assert fn(*head, *args_of) == 0
            return yr
        return go

    runs = {"win_roll_f32 (f32 plan)": (
                lambda: k.slots_kernel_windowed(W32, xp32),
                k.slots_plain_windowed(W32, xp32)),
            "win_roll_bf16, the f32 template (before)": (
                roll(fn=v["before"]), plain),
            "win_roll_bf16 (shipped)": (
                lambda: k.slots_kernel_windowed(W, xp), plain)}
    for rows, unroll in ROLL_SHAPES:
        runs[f"{rows} rows a thread, {unroll} slots a batch"] = (
            roll(rows, unroll, fn=v["roll"]), plain)
    run("win roll", runs, args.turns)
    print(card)


if __name__ == "__main__":
    main()
