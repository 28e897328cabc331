// WJD single-RHS SpMV with per-step x windows, for NVIDIA Hopper (sm_90a).
//
// One templated kernel over the value type and the column mode replaces the
// three Pallas kernels of the JAX package that leave x in device memory and
// copy one (win_rows, 128) window of it per grid step:
//
//   wjd_spmv_win_gather_f32  rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_hbm
//   wjd_spmv_win_roll_f32    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_hbm
//   wjd_spmv_win_roll_f64    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_ff_hbm
//
// Semantics: those of the direct kernels (csrc/spmv_wjd.cu), with x read
// only through the window of the tile's grid step. Step i = t / group owns
// rows [win_base[i], win_base[i] + win_rows) of padded x; element
// (t, k, s, l) multiplies
//   xw[(brow[t,k] - win_base[i] + s) * 128 + l + u],  xw = xp + win_base[i]*128.
// The host checks, when the plan is built, that every such offset lies in
// [0, win_rows*128) and that the last window ends inside xp
// (formats/wjd.py:_check_windows), so the kernel reads without bounds checks.
//
// Bound: bytes, as for the direct kernels: slot values (+ offsets in gather
// mode) are streamed once; x is small beside them. What the TPU kernels do
// with a double-buffered copy into on-chip memory, this kernel leaves to the
// cache: x at these sizes (tens of MB) fits Hopper's 50 MB L2, and a whole
// step window (0.1 to 0.5 MB) does not fit a block's 227 KB of shared
// memory. A per-block, per-slot staging of the 1024+win elements a slot
// touches, with TMA (cp.async.bulk + mbarrier), is the redesign to try next
// and to measure against this direct form; the window-relative addressing
// and the host check are what it needs.
// Element offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;                       // rows per tile
constexpr int kThreads = 256;                     // rows per block
constexpr int kBlocksPerTile = kTile / kThreads;

template <typename T, typename U, bool kRoll>
__global__ void __launch_bounds__(kThreads)
wjd_slots_win_kernel(const T* __restrict__ data,
                     const int32_t* __restrict__ brow,
                     const int32_t* __restrict__ diag_u,
                     const U* __restrict__ uloc,
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
    int u;
    if constexpr (kRoll) {
      u = __ldg(diag_u + slot);
    } else {
      u = static_cast<int>(__ldg(uloc + e));
    }
    const int64_t xi =
        (static_cast<int64_t>(__ldg(brow + slot) - wb) + s) * 128 + l + u;
    acc += __ldg(data + e) * __ldg(xw + xi);
  }
  y[t * kTile + r] = acc;
}

template <typename T, typename U, bool kRoll>
int launch(const void* data, const void* brow, const void* diag_u,
           const void* uloc, const void* win_base, const void* xp, void* y,
           int64_t tp, int k, int group, int win_rows, void* stream) {
  if (tp <= 0 || k <= 0 || group <= 0 || win_rows <= 0 || tp % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = tp * kBlocksPerTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wjd_slots_win_kernel<T, U, kRoll>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(data), static_cast<const int32_t*>(brow),
          static_cast<const int32_t*>(diag_u), static_cast<const U*>(uloc),
          static_cast<const int32_t*>(win_base), static_cast<const T*>(xp),
          static_cast<T*>(y), k, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" {

int wjd_spmv_win_roll_f64(const void* data, const void* brow,
                          const void* diag_u, const void* win_base,
                          const void* xp, void* y, int64_t tp, int k,
                          int group, int win_rows, void* stream) {
  return launch<double, uint8_t, true>(data, brow, diag_u, nullptr, win_base,
                                       xp, y, tp, k, group, win_rows, stream);
}

int wjd_spmv_win_roll_f32(const void* data, const void* brow,
                          const void* diag_u, const void* win_base,
                          const void* xp, void* y, int64_t tp, int k,
                          int group, int win_rows, void* stream) {
  return launch<float, uint8_t, true>(data, brow, diag_u, nullptr, win_base,
                                      xp, y, tp, k, group, win_rows, stream);
}

int wjd_spmv_win_gather_f32(const void* data, const void* brow,
                            const void* uloc, int uloc_bytes,
                            const void* win_base, const void* xp, void* y,
                            int64_t tp, int k, int group, int win_rows,
                            void* stream) {
  if (uloc_bytes == 1)
    return launch<float, uint8_t, false>(data, brow, nullptr, uloc, win_base,
                                         xp, y, tp, k, group, win_rows,
                                         stream);
  if (uloc_bytes == 2)
    return launch<float, int16_t, false>(data, brow, nullptr, uloc, win_base,
                                         xp, y, tp, k, group, win_rows,
                                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
