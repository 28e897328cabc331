// WJD single-RHS SpMV with per-step x windows, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the JAX package that leave x in
// device memory and copy one (win_rows, 128) window of it per grid step:
//
//   wjd_spmv_win_gather_f32  rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_hbm
//   wjd_spmv_win_gather_bf16 the same, on bfloat16 values
//   wjd_spmv_win_roll_f32    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_hbm
//   wjd_spmv_win_roll_bf16   the same, on bfloat16 values
//   wjd_spmv_win_roll_f64    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_ff_hbm
//
// As in csrc/spmv_wjd.cu, the type V of the values is apart from the type T
// of x, the sums and y: the bf16 entry points widen bfloat16 values into f32
// sums over an f32 x, as the JAX kernels do.
//
// Semantics: those of the direct kernels (csrc/spmv_wjd.cu), with x read
// only through the window of the tile's grid step. Step i = t / group owns
// rows [win_base[i], win_base[i] + win_rows) of padded x.
//
// Roll mode (wjd_slots_win_kernel) walks the slot planes: element
// (t, k, s, l) multiplies
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
// registers and was not kept.
// Element offsets are 64-bit.

#include <cstdint>
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

int wjd_spmv_win_roll_bf16(const void* data, const void* brow,
                           const void* diag_u, const void* win_base,
                           const void* xp, void* y, int64_t tp, int k,
                           int group, int win_rows, void* stream) {
  return launch<__nv_bfloat16, float>(data, brow, diag_u, win_base, xp, y,
                                      tp, k, group, win_rows, stream);
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
