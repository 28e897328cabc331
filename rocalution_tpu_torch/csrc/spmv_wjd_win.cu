// WJD single-RHS SpMV with per-step x windows, for NVIDIA Hopper (sm_90a),
// and the direct roll SpMV on bfloat16 values, which shares the windowed
// one's body.
//
// Replaces the three Pallas kernels of the JAX package that leave x in
// device memory and copy one (win_rows, 128) window of it per grid step:
//
//   wjd_spmv_win_gather_f32  rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_hbm
//   wjd_spmv_win_gather_bf16 the same, on bfloat16 values with 4-byte
//                            offsets (a bfloat16 plan whose window-relative
//                            offsets fit 16 bits takes the packed form and
//                            wjd_spmv_win_gather_bf16_packed,
//                            csrc/wjd_bf16_packed.cu)
//   wjd_spmv_win_roll_f32    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_hbm
//   wjd_spmv_win_roll_bf16   the same, on bfloat16 values (a kernel of its
//                            own, wjd_roll_win_bf16_kernel, below)
//   wjd_spmv_win_roll_f64    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_ff_hbm
//
// and, with no window, the direct Pallas kernel on bfloat16 values:
//
//   wjd_spmv_roll_bf16       rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll
//                            on bfloat16 values (wjd_roll_bf16_kernel; the
//                            f32 and f64 direct roll kernels are in
//                            csrc/spmv_wjd.cu)
//
// As in csrc/spmv_wjd.cu, the type V of the values is apart from the type T
// of x, the sums and y: the bf16 entry points widen bfloat16 values into f32
// sums over an f32 x, as the JAX kernels do.
//
// Semantics: those of the direct kernels (csrc/spmv_wjd.cu), with x read
// only through the window of the tile's grid step. Step i = t / group owns
// rows [win_base[i], win_base[i] + win_rows) of padded x.
//
// Roll mode (wjd_slots_win_kernel, f32 and f64) walks the slot planes, one
// thread a row: element (t, k, s, l) multiplies
//   xw[(brow[t,k] - win_base[i] + s) * 128 + l + u],  xw = xp + win_base[i]*128.
// The host checks, when the plan is built, that every such offset lies in
// [0, win_rows*128) and that the last window ends inside xp
// (formats/wjd.py:_check_windows), so the kernel reads without bounds checks.
// Bound: bytes, as for the direct roll kernels: the slot values are streamed
// once and x is small beside them. A roll operator's window is large (1048
// rows, 0.5 MB, at 5.8M rows of a 7-point stencil in f32), more than a
// block's 227 KB of shared memory, and its loads are contiguous anyway, so
// this kernel leaves the copy that the TPU kernels make to the cache.
//
// Roll mode on bfloat16 values (wjd_roll_win_bf16_kernel). As the f32
// template's instantiation, one thread a row, it took 83.2 us at 5.8M rows
// (laplacian_3d(180), 0.46 of its bound, where the f32 one stands at 0.65):
// a 2-byte value load a slot is a 64-byte warp load, the loop over K waits
// on the scalar loads of brow and diag_u before its gather of x, and x is
// read 4 bytes a row a slot, twice the value stream. Now:
//   * a thread owns 4 consecutive rows of a sublane, which share s and the
//     slot's offset: their values come in one 8-byte streaming load (a
//     warp load of 256 bytes), y goes out as one float4;
//   * their 4 x values are contiguous, at (brow - win_base + s)*128 + l + u
//     with l a multiple of 4, so aligned to u mod 4, which is uniform over
//     a slot: one float4 load where u = 0 mod 4, else the two aligned
//     float4s that hold them and a select (each holds a checked element, so
//     neither leaves padded x);
//   * a block owns one tile (256 threads) and stages its slots' offsets
//     (brow - win_base)*128 + u in shared memory first, 128 at a time, so
//     no value or x load waits on a dependent scalar load;
//   * one slot a step: batches of U slots (their loads issued together,
//     the ragged last batch under a uniform predicate) were slower, since
//     their registers (64 at U = 4) cut the threads an SM holds, and those
//     threads, not a thread's own batch, keep the loads in flight;
//   * each row adds its slots in ascending order with fmaf, as the slot
//     product does.
// 58.5 us in place of 80.7 on the same operator, beside 92.8 for the f32
// kernel (one H100 80GB HBM3 at 700 W, scripts/bf16_win_variants.py; the
// designs tried, with their times, are listed at the end of this file).
//
// The direct bf16 roll SpMV (wjd_roll_bf16_kernel) is the same body,
// roll_bf16_tile, with no window (a template switch: the window's base is
// 0 and win_base is not read), so a direct plan needs no win_base. A
// direct plan's padded x is at most 12 MiB (the regime rule,
// formats/wjd.py:X_VMEM_BUDGET), so its staged offsets brow*128 + u hold
// in 32 bits; the wrapper checks that xp_len does. The two kernels differ
// in their launch bounds alone: the direct one asks for blocks that fill
// an SM (32 registers a thread at 4 rows, 100 bytes of spill), since a
// direct plan is small (at 1M rows, 984 tiles) and at the 40 registers the
// body takes unbounded an SM holds 6 of its 8 blocks, so the tiles take a
// second, partial wave. The windowed kernel keeps its bounds as they were:
// naming a minimum of 1 block in them moved ptxas to 72-86 registers and
// the windowed kernel from 60.7 to 107.7 us at 5.8M rows.
// The direct kernel replaced the f32 template's bf16 instantiation
// (csrc/spmv_wjd.cu, one thread a row). On one H100 80GB HBM3 at 700 W,
// laplacian_3d(100) f32 rounded to bf16 (1M rows, K = 7), us a launch, the
// mean of 200 back-to-back launches, the median of 12 rounds
// (scripts/bf16_roll_spmm_variants.py): the template 11.0; this body at a
// full SM 7.7 (shipped), at 2 rows a thread 8.7, with its registers
// unbounded (the windowed kernel over one window at base 0, 48 registers)
// 8.9; the f32 plan's kernel 14.1. chip_smoke.py's single launch after a
// spin reads 12.5 against 15.0 for the template: ~4-5 us of it is the
// launch itself at this size.
//
// Gather mode (wjd_compact_win_kernel) reads the plan's window-relative
// compact slice form (formats/wjd.py:compact_slices): slices of 32 rows,
// rank-major, each entry a value and an offset into its step's window. Its
// first version walked the padded slot planes (6x the nonzeros at 15 a row)
// and lost 2.3x to a CSR product. Now:
//   * one block owns one grid step and reads x from xp + win_base[step]*128;
//   * one warp a slice and one thread a row, as in the direct compact
//     kernel: values and offsets are streamed coalesced (ld.global.cs), x is
//     gathered through the cache. A slice is about 21 ranks wide, so a warp
//     takes its ranks 8 at a time and sends the loads of the ragged last
//     batch off together too, under a predicate: a remainder loop would pay
//     a memory latency for each;
//   * a row's terms are added in ascending slot order, so its sum is bit for
//     bit the direct compact kernel's;
//   * the host checks that every offset lies in [0, win_rows*128) and every
//     window inside xp (formats/wjd.py:_check_compact_windows).
// Bound: bytes. The kernel streams 6 bytes a stored element in f32. On the
// H100 at 4.2M rows it takes 216 to 226 us for bytes that take 160 us at the
// card's rate. A scattered operator's window is small (216 rows, 110,592
// bytes in f32, at 4.2M rows and a band of +-8192) and fits a block's shared
// memory; copying it there first (cp.async.bulk and an mbarrier) was tried
// and bought 1 to 2 %, less than one card differs from the next, so it was
// not kept: the streaming sets the pace, not the gather, and what a layout
// could still save is its padding (1.43 stored elements a nonzero).
// Blocks of 1024 threads held to 32 registers, so that two fit an SM, were
// the fastest shape tried; walking a warp's slices as one stream of ranks,
// with a single ragged batch a warp, gave the same time for twice the
// registers and was not kept. Its bf16 instantiation serves a bfloat16 plan
// with 4-byte offsets only: it issues a 2-byte value load, a 2-byte offset
// load and a gather an element, so load instructions, not bytes, set its
// pace (188.8 us at 4.2M rows on 2-byte offsets, one H100 80GB HBM3 at
// 700 W: 61 % of its own stream); the packed form's windowed kernel serves
// the rest.
// Element offsets are 64-bit.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// a value in the type of the sums: bfloat16 widens to float (exact)
template <typename V>
__device__ __forceinline__ V widen(V v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kTile = 1024;                       // rows per tile
constexpr int kThreads = 256;                     // rows per block
constexpr int kBlocksPerTile = kTile / kThreads;

template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
wjd_slots_win_kernel(const V* __restrict__ data,
                     const int32_t* __restrict__ brow,
                     const int32_t* __restrict__ diag_u,
                     const int32_t* __restrict__ win_base,
                     const T* __restrict__ xp, T* __restrict__ y, int K,
                     int group) {
  const int64_t t = blockIdx.x / kBlocksPerTile;
  const int r = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int s = r >> 7;          // sublane of the row within its tile
  const int l = r & 127;         // lane of the row
  const int step = static_cast<int>(t / group);
  const int wb = __ldg(win_base + step);
  const T* __restrict__ xw = xp + static_cast<int64_t>(wb) * 128;

  const int64_t slot0 = t * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t slot = slot0 + k;
    const int64_t e = slot * kTile + r;
    const int u = __ldg(diag_u + slot);
    const int64_t xi =
        (static_cast<int64_t>(__ldg(brow + slot) - wb) + s) * 128 + l + u;
    acc += widen(__ldg(data + e)) * __ldg(xw + xi);
  }
  y[t * kTile + r] = acc;
}

template <typename V, typename T>
int launch(const void* data, const void* brow, const void* diag_u,
           const void* win_base, const void* xp, void* y, int64_t tp, int k,
           int group, int win_rows, void* stream) {
  if (tp <= 0 || k <= 0 || group <= 0 || win_rows <= 0 || tp % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = tp * kBlocksPerTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wjd_slots_win_kernel<V, T>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(data), static_cast<const int32_t*>(brow),
          static_cast<const int32_t*>(diag_u),
          static_cast<const int32_t*>(win_base), static_cast<const T*>(xp),
          static_cast<T*>(y), k, group);
  return static_cast<int>(cudaGetLastError());
}

// ---- roll mode on bfloat16 values: R rows a thread ----

constexpr int kRollRows = 4;               // rows a thread
constexpr int kRollUnroll = 1;             // slots whose loads go together
constexpr int kSmThreads = 2048;           // threads an SM holds
constexpr int kStage = 128;                // slot offsets staged at a time

// R bfloat16 values of R consecutive rows: one load of 2R bytes
template <int R>
using RowBits = std::conditional_t<R == 4, uint2, uint32_t>;

template <int R>
__device__ __forceinline__ void widen_rows(RowBits<R> w, float (&v)[R]) {
  // bfloat16 is the high half of an f32; the lower address is the low half
  if constexpr (R == 4) {
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// x[0, R) = xr[o, o + R), xr aligned to R floats: one aligned vector load
// where o = 0 mod R, else the two that hold them and a select (a is
// uniform over a slot, so the branch is uniform over the block)
template <int R>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int o,
                                       float (&x)[R]) {
  const int a = o & (R - 1);
  const float* __restrict__ q = xr + (o - a);
  if constexpr (R == 4) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(q));
    if (a == 0) {
      x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
      return;
    }
    const float4 hi = __ldg(reinterpret_cast<const float4*>(q) + 1);
    if (a == 1) {
      x[0] = lo.y; x[1] = lo.z; x[2] = lo.w; x[3] = hi.x;
    } else if (a == 2) {
      x[0] = lo.z; x[1] = lo.w; x[2] = hi.x; x[3] = hi.y;
    } else {
      x[0] = lo.w; x[1] = hi.x; x[2] = hi.y; x[3] = hi.z;
    }
  } else {
    const float2 lo = __ldg(reinterpret_cast<const float2*>(q));
    if (a == 0) {
      x[0] = lo.x; x[1] = lo.y;
      return;
    }
    const float2 hi = __ldg(reinterpret_cast<const float2*>(q) + 1);
    x[0] = lo.y; x[1] = hi.x;
  }
}

// One tile (the block's): x through the window of the tile's grid step
// (kWin), or from padded x itself (the direct kernel: wb = 0, and win_base
// and group are not read).
template <int R, int U, bool kWin>
__device__ __forceinline__ void roll_bf16_tile(
    const __nv_bfloat16* __restrict__ data, const int32_t* __restrict__ brow,
    const int32_t* __restrict__ diag_u, const int32_t* __restrict__ win_base,
    const float* __restrict__ xp, float* __restrict__ y, int K, int group) {
  constexpr int kRollThreads = kTile / R;
  __shared__ int off[kStage];    // (brow - win_base)*128 + u of a slot
  const int64_t t = blockIdx.x;
  // rows r .. r+R-1 of the tile: (s, l .. l+R-1) with r = s*128 + l, so
  // their x lies at (brow - wb)*128 + u + r on, from the window's start
  const int r = threadIdx.x * R;
  const int wb = kWin ? __ldg(win_base + t / group) : 0;
  const float* __restrict__ xr = xp + static_cast<int64_t>(wb) * 128 + r;
  const __nv_bfloat16* __restrict__ vr = data + t * K * kTile + r;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStage) {
    const int n = min(kStage, K - k0);
    __syncthreads();             // the last batch's offsets are read
    for (int i = threadIdx.x; i < n; i += kRollThreads) {
      const int64_t slot = t * K + k0 + i;
      off[i] = (__ldg(brow + slot) - wb) * 128 + __ldg(diag_u + slot);
    }
    __syncthreads();
    for (int k = 0; k < n; k += U) {
      RowBits<R> w[U];
      float xv[U][R];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (k + j < n) {
          w[j] = __ldcs(reinterpret_cast<const RowBits<R>*>(
              vr + static_cast<int64_t>(k0 + k + j) * kTile));
          load_x<R>(xr, off[k + j], xv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (k + j < n) {
          float v[R];
          widen_rows<R>(w[j], v);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = fmaf(v[i], xv[j][i], acc[i]);
        }
      }
    }
  }
  float* __restrict__ yr = y + t * kTile + r;
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2],
                                                 acc[3]);
  } else {
    *reinterpret_cast<float2*>(yr) = make_float2(acc[0], acc[1]);
  }
}

template <int R, int U>
__global__ void __launch_bounds__(kTile / R)
wjd_roll_win_bf16_kernel(const __nv_bfloat16* __restrict__ data,
                         const int32_t* __restrict__ brow,
                         const int32_t* __restrict__ diag_u,
                         const int32_t* __restrict__ win_base,
                         const float* __restrict__ xp, float* __restrict__ y,
                         int K, int group) {
  roll_bf16_tile<R, U, true>(data, brow, diag_u, win_base, xp, y, K, group);
}

// The direct kernel asks for blocks that fill an SM's threads (32
// registers a thread): at the registers the body takes unbounded (40 at
// R = 4) an SM holds 6 of 8 blocks, and the 984 tiles of a million rows
// take a second, partial wave.
template <int R>
__global__ void __launch_bounds__(kTile / R, kSmThreads / (kTile / R))
wjd_roll_bf16_kernel(const __nv_bfloat16* __restrict__ data,
                     const int32_t* __restrict__ brow,
                     const int32_t* __restrict__ diag_u,
                     const float* __restrict__ xp, float* __restrict__ y,
                     int K) {
  roll_bf16_tile<R, kRollUnroll, false>(data, brow, diag_u, nullptr, xp, y,
                                        K, 1);
}

template <int R>
bool roll_bf16_args_ok(const void* data, const void* xp, const void* y,
                       int64_t tp, int k) {
  return tp > 0 && tp <= 0x7fffffffLL && k > 0 &&
         reinterpret_cast<uintptr_t>(xp) % (4 * R) == 0 &&
         reinterpret_cast<uintptr_t>(y) % (4 * R) == 0 &&
         reinterpret_cast<uintptr_t>(data) % (2 * R) == 0;
}

template <int R, int U>
int launch_roll_bf16(const void* data, const void* brow, const void* diag_u,
                     const void* win_base, const void* xp, void* y,
                     int64_t tp, int k, int group, int win_rows,
                     void* stream) {
  if (!roll_bf16_args_ok<R>(data, xp, y, tp, k) || group <= 0 ||
      win_rows <= 0 || tp % group)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_roll_win_bf16_kernel<R, U>
      <<<static_cast<unsigned>(tp), kTile / R, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(data),
          static_cast<const int32_t*>(brow),
          static_cast<const int32_t*>(diag_u),
          static_cast<const int32_t*>(win_base),
          static_cast<const float*>(xp), static_cast<float*>(y), k, group);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_roll_bf16_direct(const void* data, const void* brow,
                            const void* diag_u, const void* xp, void* y,
                            int64_t tp, int k, void* stream) {
  if (!roll_bf16_args_ok<R>(data, xp, y, tp, k))
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_roll_bf16_kernel<R><<<static_cast<unsigned>(tp), kTile / R, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(data),
      static_cast<const int32_t*>(brow), static_cast<const int32_t*>(diag_u),
      static_cast<const float*>(xp), static_cast<float*>(y), k);
  return static_cast<int>(cudaGetLastError());
}

// ---- gather mode: the window-relative compact form ----

constexpr int kSlice = 32;                 // rows per compact slice
constexpr int kWinThreads = 1024;          // 32 warps walk a step's slices
constexpr int kWinMinBlocks = 2;           // blocks an SM should hold
constexpr int kUnroll = 8;                 // ranks in flight a thread
static_assert(kWinThreads % kSlice == 0, "a block holds whole warps");

template <typename V, typename T, typename O>
__global__ void __launch_bounds__(kWinThreads, kWinMinBlocks)
wjd_compact_win_kernel(const V* __restrict__ cval, const O* __restrict__ coff,
                       const int64_t* __restrict__ slice_ptr,
                       const int32_t* __restrict__ win_base,
                       const T* __restrict__ xp, T* __restrict__ y,
                       int slices_per_step) {
  const int64_t step = blockIdx.x;
  const T* __restrict__ xw =
      xp + static_cast<int64_t>(__ldg(win_base + step)) * 128;

  const int lane = threadIdx.x % kSlice;
  const int64_t slice0 = step * slices_per_step;
  for (int i = threadIdx.x / kSlice; i < slices_per_step;
       i += kWinThreads / kSlice) {
    const int64_t slice = slice0 + i;
    const int64_t end = __ldg(slice_ptr + slice + 1);
    T acc = T(0);
    // kUnroll ranks at a time, the ragged last batch too: its loads go off
    // together under a predicate (uniform over the warp), not one after the
    // other as in a remainder loop
    for (int64_t p = __ldg(slice_ptr + slice) + lane; p < end;
         p += kUnroll * kSlice) {
      T v[kUnroll];
      int o[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t q = p + j * kSlice;
        v[j] = q < end ? widen(__ldcs(cval + q)) : T(0);
        o[j] = q < end ? static_cast<int>(__ldcs(coff + q)) : 0;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (p + j * kSlice < end) acc += v[j] * __ldg(xw + o[j]);
      }
    }
    y[slice * kSlice + lane] = acc;
  }
}

template <typename V, typename T, typename O>
int launch_compact_win(const void* cval, const void* coff,
                       const void* slice_ptr, const void* win_base,
                       const void* xp, void* y, int64_t nsteps,
                       int slices_per_step, void* stream) {
  if (nsteps <= 0 || nsteps > 0x7fffffffLL || slices_per_step <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_compact_win_kernel<V, T, O>
      <<<static_cast<unsigned>(nsteps), kWinThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(cval), static_cast<const O*>(coff),
          static_cast<const int64_t*>(slice_ptr),
          static_cast<const int32_t*>(win_base), static_cast<const T*>(xp),
          static_cast<T*>(y), slices_per_step);
  return static_cast<int>(cudaGetLastError());
}

// the gather kernel for values V over an f32 x, by width of offset
template <typename V>
int launch_gather_win(const void* cval, const void* coff, int coff_bytes,
                      const void* slice_ptr, const void* win_base,
                      const void* xp, void* y, int64_t nsteps,
                      int slices_per_step, void* stream) {
  if (coff_bytes == 2)
    return launch_compact_win<V, float, uint16_t>(
        cval, coff, slice_ptr, win_base, xp, y, nsteps, slices_per_step,
        stream);
  if (coff_bytes == 4)
    return launch_compact_win<V, float, int32_t>(
        cval, coff, slice_ptr, win_base, xp, y, nsteps, slices_per_step,
        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. The gather entry point takes the
// window-relative compact slice form: values, offsets of coff_bytes (2 or 4)
// each, slice_ptr (nsteps*slices_per_step + 1, int64), win_base (nsteps,
// int32); y has nsteps*slices_per_step*32 rows. The bf16 entry points take
// bfloat16 values and an f32 x and y.
extern "C" {

int wjd_spmv_win_roll_f64(const void* data, const void* brow,
                          const void* diag_u, const void* win_base,
                          const void* xp, void* y, int64_t tp, int k,
                          int group, int win_rows, void* stream) {
  return launch<double, double>(data, brow, diag_u, win_base, xp, y, tp, k,
                                group, win_rows, stream);
}

int wjd_spmv_win_roll_f32(const void* data, const void* brow,
                          const void* diag_u, const void* win_base,
                          const void* xp, void* y, int64_t tp, int k,
                          int group, int win_rows, void* stream) {
  return launch<float, float>(data, brow, diag_u, win_base, xp, y, tp, k,
                              group, win_rows, stream);
}

// xp and y 16-byte aligned (the bf16 kernel reads x and writes y 16 bytes
// a thread)
int wjd_spmv_win_roll_bf16(const void* data, const void* brow,
                           const void* diag_u, const void* win_base,
                           const void* xp, void* y, int64_t tp, int k,
                           int group, int win_rows, void* stream) {
  return launch_roll_bf16<kRollRows, kRollUnroll>(
      data, brow, diag_u, win_base, xp, y, tp, k, group, win_rows, stream);
}

// the direct bf16 roll SpMV (csrc/spmv_wjd.cu's roll signature): the same
// body with no window; xp and y 16-byte aligned, y of tp*1024 rows
int wjd_spmv_roll_bf16(const void* data, const void* brow, const void* diag_u,
                       const void* xp, void* y, int64_t tp, int k,
                       void* stream) {
  return launch_roll_bf16_direct<kRollRows>(data, brow, diag_u, xp, y, tp,
                                            k, stream);
}

int wjd_spmv_win_gather_f32(const void* cval, const void* coff,
                            int coff_bytes, const void* slice_ptr,
                            const void* win_base, const void* xp, void* y,
                            int64_t nsteps, int slices_per_step,
                            void* stream) {
  return launch_gather_win<float>(cval, coff, coff_bytes, slice_ptr, win_base,
                                  xp, y, nsteps, slices_per_step, stream);
}

int wjd_spmv_win_gather_bf16(const void* cval, const void* coff,
                             int coff_bytes, const void* slice_ptr,
                             const void* win_base, const void* xp, void* y,
                             int64_t nsteps, int slices_per_step,
                             void* stream) {
  return launch_gather_win<__nv_bfloat16>(cval, coff, coff_bytes, slice_ptr,
                                          win_base, xp, y, nsteps,
                                          slices_per_step, stream);
}

}  // extern "C"

#ifdef WJD_VARIANTS
// The designs tried for wjd_spmv_win_roll_bf16, compiled only with
// -DWJD_VARIANTS by scripts/bf16_win_variants.py, which times them beside
// the shipped one: the f32 template on bfloat16 values (the kernel before),
// and the new body at 2 or 4 rows a thread and 1, 2, 4 or 8 slots a batch;
// and the direct kernel at 2 rows a thread, for
// scripts/bf16_roll_spmm_variants.py.
// On one H100 80GB HBM3 at 700 W, laplacian_3d(180) f32 rounded to bf16
// (5,832,000 rows, K = 7, 89 steps of 64 tiles, win_rows 1048), us a
// launch, the median of 8 rounds of 20: the f32 template 80.7; 2 rows a
// thread 82.9, 65.8, 81.6, 108.9 and 4 rows 58.5 (shipped), 66.1, 68.5,
// 109.9 at 1, 2, 4 and 8 slots a batch; the f32 plan's kernel 92.8.
extern "C" {

int wjd_spmv_win_roll_bf16_before(const void* data, const void* brow,
                                  const void* diag_u, const void* win_base,
                                  const void* xp, void* y, int64_t tp, int k,
                                  int group, int win_rows, void* stream) {
  return launch<__nv_bfloat16, float>(data, brow, diag_u, win_base, xp, y,
                                      tp, k, group, win_rows, stream);
}

int wjd_spmv_win_roll_bf16_variant(int rows, int unroll, const void* data,
                                   const void* brow, const void* diag_u,
                                   const void* win_base, const void* xp,
                                   void* y, int64_t tp, int k, int group,
                                   int win_rows, void* stream) {
#define WJD_ROLL_CASE(R, U)                                                 \
  if (rows == R && unroll == U)                                             \
    return launch_roll_bf16<R, U>(data, brow, diag_u, win_base, xp, y, tp, \
                                  k, group, win_rows, stream);
  WJD_ROLL_CASE(2, 1) WJD_ROLL_CASE(2, 2) WJD_ROLL_CASE(2, 4)
  WJD_ROLL_CASE(2, 8) WJD_ROLL_CASE(4, 1) WJD_ROLL_CASE(4, 2)
  WJD_ROLL_CASE(4, 4) WJD_ROLL_CASE(4, 8)
#undef WJD_ROLL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int wjd_spmv_roll_bf16_variant(int rows, const void* data, const void* brow,
                               const void* diag_u, const void* xp, void* y,
                               int64_t tp, int k, void* stream) {
  if (rows == 2)
    return launch_roll_bf16_direct<2>(data, brow, diag_u, xp, y, tp, k,
                                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
#endif  // WJD_VARIANTS
