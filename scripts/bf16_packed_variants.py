"""Time the packed bf16 gather kernels beside the kernels they replace and
the two designs tried on the way that the package does not ship, on one
NVIDIA GPU.

    python scripts/bf16_packed_variants.py [--n 1048576] [--turns 8]

The operator is chip_smoke.py phase N1's: random_banded_spd(n) in f32,
its bf16 plan (the f32 plan with its values rounded), gather mode. On it,
each in the same process and on the same x (X of 16 columns for the
blocked products), this times with CUDA events (one warm-up, then `turns`
rounds in alternating order, each the mean of 20 back-to-back launches;
the median is printed):

  SpMV  through the package: gather_f32 (the f32 plan, compact form),
        gather_bf16 compact (the bf16 kernel of csrc/spmv_wjd.cu on the
        compact form with 2-byte offsets: the kernel before the packed
        form) and gather_bf16 packed (csrc/wjd_bf16_packed.cu); and
        spmv_ring, the packed SpMV with x served from a shared-memory ring
        of 32768 floats: a persistent block of 1024 threads walks a
        contiguous run of waves (a wave: 32 consecutive slices, one a warp)
        and fills the ring ahead with cp.async.bulk (TMA, 1-D) and two
        mbarriers, so each line of x comes from L2 once a block and the
        gathers hit shared memory (needs every two consecutive waves' x
        span to fit the ring);
  SpMM  KC = 16, the same three through the package (the compact bf16
        SpMM is csrc/spmm_wjd.cu's raw-value body, 4 ranks a group, since
        it replaced the template's bf16 instantiation), and spmm_scalar, the
        packed SpMM with X gathered as the compact kernel gathers it: one
        lane a column, 2 rows a pass, 4-byte loads of X (one shuffle a row:
        the packed word).

The two variants are compiled from the source in this file (nvcc, sm_90a,
into rocalution_tpu_torch/_build/variants/). Every product is held to the
plain version over its form (1e-5, norm-wise). Prints one line a kernel
and the card's name and power limit.
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

VARIANTS_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float value_of(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ uint32_t offset_of(uint32_t w) { return w >> 16; }

// ---- x from a shared-memory ring, filled by TMA bulk copies ----
constexpr int kRing = 32768;                     // floats, 128 KB

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x[lo, hi) into ring[g % kRing], completing on mbarrier `bar`
__device__ __forceinline__ void fill(float* ring, uint32_t bar,
                                     const float* xp, int64_t lo,
                                     int64_t hi) {
  const uint32_t bytes = static_cast<uint32_t>((hi - lo) * 4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  for (int64_t g = lo; g < hi;) {
    const int64_t r = g & (kRing - 1);
    const int64_t n = (hi - g < kRing - r) ? hi - g : kRing - r;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem(ring + r)), "l"(xp + g),
           "r"(static_cast<uint32_t>(n * 4)), "r"(bar) : "memory");
    g += n;
  }
}

__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

template <int T>
__global__ void __launch_bounds__(T, 1)
spmv_ring(const uint4* __restrict__ cpack, const int64_t* __restrict__ ptr,
          const int64_t* __restrict__ xbase, const float* __restrict__ xp,
          float* __restrict__ y, const int64_t* __restrict__ wlo,
          const int64_t* __restrict__ whi, int64_t nwaves, int64_t nslices,
          int per_block) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t bars[2];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t w1 = (w0 + per_block < nwaves) ? w0 + per_block : nwaves;
  if (w0 >= w1) return;
  const uint32_t bar0 = smem(&bars[0]), bar1 = smem(&bars[1]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fill(ring, bar0, xp, wlo[w0], whi[w0]);
    if (w0 + 1 < w1) fill(ring, bar1, xp, whi[w0], whi[w0 + 1]);
  }
  const int lane = threadIdx.x % 32;
  for (int64_t w = w0; w < w1; ++w) {
    const int k = static_cast<int>(w - w0);
    wait((k & 1) ? bar1 : bar0, (k >> 1) & 1);
    const int64_t slice = w * (T / 32) + threadIdx.x / 32;
    if (slice < nslices) {
      const int64_t end = __ldg(ptr + slice + 1) / 4;
      const int64_t base = __ldg(xbase + slice);
      float acc = 0.f;
#pragma unroll 2
      for (int64_t g = __ldg(ptr + slice) / 4 + lane; g < end; g += 32) {
        const uint4 wd = __ldcs(cpack + g);
        const float x0 = ring[(base + offset_of(wd.x)) & (kRing - 1)];
        const float x1 = ring[(base + offset_of(wd.y)) & (kRing - 1)];
        const float x2 = ring[(base + offset_of(wd.z)) & (kRing - 1)];
        const float x3 = ring[(base + offset_of(wd.w)) & (kRing - 1)];
        acc = fmaf(value_of(wd.x), x0, acc);
        acc = fmaf(value_of(wd.y), x1, acc);
        acc = fmaf(value_of(wd.z), x2, acc);
        acc = fmaf(value_of(wd.w), x3, acc);
      }
      y[slice * 32 + lane] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0 && w + 2 < w1) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill(ring, (k & 1) ? bar1 : bar0, xp, whi[w + 1], whi[w + 2]);
    }
  }
}

template <int T>
int go_ring(const void* cpack, const void* ptr, const void* xbase,
            const void* xp, void* y, const void* wlo, const void* whi,
            int64_t nwaves, int64_t nslices, int blocks, cudaStream_t s) {
  const int bytes = kRing * 4;
  static const cudaError_t set = cudaFuncSetAttribute(
      spmv_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int per_block = static_cast<int>((nwaves + blocks - 1) / blocks);
  spmv_ring<T><<<blocks, T, bytes, s>>>(
      static_cast<const uint4*>(cpack), static_cast<const int64_t*>(ptr),
      static_cast<const int64_t*>(xbase), static_cast<const float*>(xp),
      static_cast<float*>(y), static_cast<const int64_t*>(wlo),
      static_cast<const int64_t*>(whi), nwaves, nslices, per_block);
  return static_cast<int>(cudaGetLastError());
}

// ---- blocked products, KC = 16 ----
template <int T>
__global__ void __launch_bounds__(T)
spmm_scalar(const uint4* __restrict__ cpack, const int64_t* __restrict__ ptr,
            const int64_t* __restrict__ xbase, const float* __restrict__ xp,
            float* __restrict__ y, int64_t nslices) {
  constexpr int KC = 16, kRowsPerPass = 32 / KC;
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * (T / 32) +
                        threadIdx.x / 32;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % 32;
  const int h = lane / KC, c = lane % KC;
  const float* __restrict__ xs = xp + __ldg(xbase + slice) * KC + c;
  float acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0.f;
  const int64_t end = __ldg(ptr + slice + 1) / 4;
  int64_t g = __ldg(ptr + slice) / 4 + lane;
  uint4 w_next = g < end ? __ldcs(cpack + g) : make_uint4(0u, 0u, 0u, 0u);
  for (; g < end; g += 32) {
    const uint4 w = w_next;
    if (g + 32 < end) w_next = __ldcs(cpack + g + 32);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const uint32_t wi =
            __shfl_sync(0xffffffffu, words[r], i * kRowsPerPass + h);
        acc[i] = fmaf(value_of(wi), __ldg(xs + offset_of(wi) * KC), acc[i]);
      }
    }
  }
  float* __restrict__ ys = y + (slice * 32 + h) * KC + c;
#pragma unroll
  for (int i = 0; i < KC; ++i) ys[i * kRowsPerPass * KC] = acc[i];
}

template <int T>
int go_scalar(const void* a, const void* b, const void* c, const void* d,
              void* e, int64_t n, cudaStream_t s) {
  spmm_scalar<T><<<static_cast<unsigned>((n + T / 32 - 1) / (T / 32)), T, 0,
                   s>>>(static_cast<const uint4*>(a),
                        static_cast<const int64_t*>(b),
                        static_cast<const int64_t*>(c),
                        static_cast<const float*>(d), static_cast<float*>(e),
                        n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a persistent block of 1024 threads an SM (blocks)
int v_ring(const void* cpack, const void* ptr, const void* xbase,
           const void* xp, void* y, const void* wlo, const void* whi,
           int64_t nwaves, int64_t nslices, int blocks, void* stream) {
  return go_ring<1024>(cpack, ptr, xbase, xp, y, wlo, whi, nwaves, nslices,
                       blocks, static_cast<cudaStream_t>(stream));
}

int v_spmm_scalar(const void* cpack, const void* ptr, const void* xbase,
                  const void* xp, void* y, int64_t nslices, void* stream) {
  return go_scalar<128>(cpack, ptr, xbase, xp, y, nslices,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
"""

RING = 32768                   # floats of x in the ring (kRing)
THREADS = 1024                 # the ring's block
TOL = 1e-5
COLS = 16


def build_variants(build_dir):
    from rocalution_tpu_torch.ops.cuda import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "bf16_variants.cu"
    src.write_text(VARIANTS_CU)
    lib = build_dir / "libbf16_variants.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    lib = ctypes.CDLL(str(lib))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.v_ring.argtypes = [P, P, P, P, P, P, P, I64, I64, INT, P]
    lib.v_spmm_scalar.argtypes = [P, P, P, P, P, I64, P]
    lib.v_ring.restype = lib.v_spmm_scalar.restype = INT
    return lib


def ring_windows(cpack, ptr, xbase, threads):
    """Per wave of threads/32 slices: [lo, hi) of the x it reads, 16-byte
    aligned, made monotone (suffix min of lo, prefix max of hi); and the
    largest span of two consecutive waves (must fit the ring)."""
    off = (cpack.view(np.uint32) >> 16).astype(np.int64)
    nsl = len(xbase)
    used = np.diff(ptr) > 0
    hi = np.full(nsl, -1, np.int64)
    lo = np.full(nsl, np.iinfo(np.int64).max, np.int64)
    hi[used] = xbase[used] + np.maximum.reduceat(off, ptr[:-1][used]) + 1
    lo[used] = xbase[used]
    per = threads // 32
    nw = -(-nsl // per)
    pad = nw * per - nsl
    lo = np.concatenate([lo, np.full(pad, lo.max(), np.int64)])
    hi = np.concatenate([hi, np.full(pad, -1, np.int64)])
    wlo = lo.reshape(nw, per).min(axis=1) // 4 * 4
    whi = -(-hi.reshape(nw, per).max(axis=1) // 4) * 4
    whi = np.maximum.accumulate(whi)
    wlo = np.minimum.accumulate(wlo[::-1])[::-1]
    wlo = np.minimum(wlo, whi)
    span = int((whi[1:] - wlo[:-1]).max()) if nw > 1 else int(whi[0] - wlo[0])
    return wlo, whi, span


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
    d = got.double() - want.double()
    return float(torch.linalg.norm(d) / torch.linalg.norm(want.double()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.formats import wjd as fw
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as k

    os.environ["ROCALUTION_TPU_TORCH_PLAN_CACHE"] = "0"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    k.build()
    lib = build_variants(ROOT / "rocalution_tpu_torch" / "_build" /
                         "variants")

    A = rt.random_banded_spd(args.n, dtype=np.float32, device="cpu")
    plan32 = fw.csr_to_wjd_plan(*A.numpy_triplet(), A.shape, cache=False)
    plan16 = fw._rounded_to_bf16(plan32)
    W32 = fw._plan_to_wjd(plan32, "cuda")
    W = fw._plan_to_wjd(plan16, "cuda")              # packed
    assert W.compact_form == "packed", W.compact_form
    comp = fw.compact_slices(plan16)
    Wc = dataclasses.replace(W, cpack=None, slice_ptr=torch.from_numpy(
        comp["slice_ptr"]).cuda(), cval=torch.from_numpy(comp["cval"]).cuda()
        .to(torch.bfloat16), coff=torch.from_numpy(comp["coff"]).cuda())
    print(f"n={args.n} nnz={A.nnz} | compact {len(comp['cval'])} elements "
          f"({len(comp['cval']) / W.nnz:.4f} a nonzero), packed "
          f"{W.cpack.numel()} words ({W.compact_padding_ratio:.4f} a "
          f"nonzero) | {card}")

    rng = np.random.default_rng(1234)
    x = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).cuda()
    X = torch.from_numpy(rng.standard_normal((A.shape[1], COLS)).astype(
        np.float32)).cuda()
    xp, Xp = k.pad_x(W, x), k.pad_x(W, X, COLS)
    xp32, Xp32 = k.pad_x(W32, x), k.pad_x(W32, X, COLS)
    nsl = W.xbase.numel()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (W.cpack.data_ptr(), W.slice_ptr.data_ptr(), W.xbase.data_ptr())

    # ---- SpMV ----
    y = torch.empty(nsl * 32, dtype=torch.float32, device="cuda")
    packed_plain = k.slots_plain_packed(W, xp)
    runs = {"gather_f32 compact (f32 plan)": (
                lambda: k.slots_kernel(W32, xp32),
                k.slots_plain_compact(W32, xp32)),
            "gather_bf16 compact (before)": (
                lambda: k.slots_kernel(Wc, xp),
                k.slots_plain_compact(Wc, xp)),
            "gather_bf16 packed (shipped)": (
                lambda: k.slots_kernel(W, xp), packed_plain)}
    wlo, whi, span = ring_windows(W.cpack.cpu().numpy(),
                                  W.slice_ptr.cpu().numpy(),
                                  W.xbase.cpu().numpy(), THREADS)
    wl, wh = torch.from_numpy(wlo).cuda(), torch.from_numpy(whi).cuda()
    print(f"spmv_ring: {wl.numel()} waves, two consecutive waves span at "
          f"most {span} floats of the ring's {RING}")
    if span <= RING:
        def ring():
            rc = lib.v_ring(*ptrs, xp.data_ptr(), y.data_ptr(),
                            wl.data_ptr(), wh.data_ptr(), wl.numel(), nsl,
                            min(sms, wl.numel()), stream)
            assert rc == 0, rc
            return y
        runs["spmv_ring"] = (ring, packed_plain)
    for name, (fn, want) in runs.items():
        rel = norm_rel(fn().reshape(-1), want.reshape(-1))
        assert rel <= TOL, (name, rel)
        print(f"  {name}: vs plain {rel:.2e}")
    times = timed({name: fn for name, (fn, _) in runs.items()}, args.turns)
    for name, ms in times.items():
        print(f"SpMV {name}: {ms * 1e3:.1f} us")

    # ---- SpMM, KC = 16 ----
    Y = torch.empty((nsl * 32, COLS), dtype=torch.float32, device="cuda")

    def scalar():
        rc = lib.v_spmm_scalar(*ptrs, Xp.data_ptr(), Y.data_ptr(), nsl,
                               stream)
        assert rc == 0, rc
        return Y

    packed_plain = k.slots_plain_packed_mrhs(W, Xp)
    runs = {"spmm_gather_f32 compact (f32 plan)": (
                lambda: k.slots_kernel_mrhs(W32, Xp32),
                k.slots_plain_compact_mrhs(W32, Xp32)),
            "spmm_gather_bf16 compact": (
                lambda: k.slots_kernel_mrhs(Wc, Xp),
                k.slots_plain_compact_mrhs(Wc, Xp)),
            "spmm_gather_bf16 packed (shipped)": (
                lambda: k.slots_kernel_mrhs(W, Xp), packed_plain),
            "spmm_scalar": (scalar, packed_plain)}
    for name, (fn, want) in runs.items():
        rel = norm_rel(fn(), want)
        assert rel <= TOL, (name, rel)
        print(f"  {name}: vs plain {rel:.2e}")
    times = timed({name: fn for name, (fn, _) in runs.items()}, args.turns)
    for name, ms in times.items():
        print(f"SpMM k={COLS} {name}: {ms * 1e3:.1f} us")
    print(card)


if __name__ == "__main__":
    main()
