// WJD blocked-right-hand-side SpMM (Y = A X, X of KC columns) for NVIDIA
// Hopper (sm_90a).
//
// Replaces rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_mrhs, the Pallas
// kernel that loads every slot value once for a chunk of at most 16 columns:
//
//   wjd_spmm_roll_f32, wjd_spmm_gather_f32   the kernel's f32 path
//   wjd_spmm_roll_f64, wjd_spmm_gather_f64   the same template in fp64, where
//       the JAX package loops over columns through its float-float kernels;
//       the function Y = A X is the same.
//
// Semantics per column j (wjd_reference): element (t, k, s, l) of slot (t, k)
// multiplies X_padded[(brow[t,k] + s) * 128 + l + u, j], with u = diag_u[t,k]
// in roll mode and u = uloc[t,k,s,l] in gather mode, summed over k into row
// t*1024 + s*128 + l of column j. The TPU kernel always gathers through a
// materialised offset plane; on Hopper both modes are one index formula, so
// roll plans read diag_u and no plane is built. The COO spill, the DIA part
// and the column chunking are the Python wrapper's
// (rocalution_tpu_torch/ops/cuda/spmv_wjd.py). The result does not depend on
// how the columns are chunked: every column is summed over k in the same
// order whatever KC is, and the columns a chunk pads with zeros are dropped.
//
// Bound: bytes through HBM are the slot values (+ offsets) once, plus X and
// Y: one sixteenth per column of what sixteen single applies stream. What
// then sets the pace is the gather of X: Tp*K*1024*KC elements through L1
// and L2. The design serves both:
//   * one thread owns one row (t, s, l), loops over k, loads the value, brow
//     and u once per slot and updates KC register accumulators (KC = 4, 8 or
//     16 is a template parameter; a ragged chunk is padded up by the wrapper);
//   * two layouts of padded X are instantiated. Row-major (xp_len, KC): a
//     thread's KC values are contiguous (16-byte vector loads, whole sectors
//     used even when the rows of a warp scatter), and neither X nor Y needs a
//     transpose. Planes (KC, xp_len), the reference's layout: each column's
//     loads coalesce along the lane, at the price of two transposes a call.
//     Measured on the H100 at 1M rows and 16 columns, the row-major kernel
//     wins in f32 and the planes kernel in f64 (a thread's 16 doubles are a
//     whole 128-byte line, so a warp's vector load touches 32 lines), but
//     the transposes cost more than the f64 kernel gains, so the wrapper uses
//     row-major throughout; the planes instantiation is kept so that a run
//     on the card can time both on the same operands. See PERF.md.
// Staging X tiles in shared memory (TMA) is left for later work.
// Element offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;                       // rows per tile
constexpr int kThreads = 256;                     // rows per block
constexpr int kBlocksPerTile = kTile / kThreads;

template <typename T> struct Vec16;               // 16-byte vector of T
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T, typename U, bool kRoll, int KC, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
wjd_spmm_kernel(const T* __restrict__ data, const int32_t* __restrict__ brow,
                const int32_t* __restrict__ diag_u,
                const U* __restrict__ uloc, const T* __restrict__ xp,
                T* __restrict__ y, int K, int64_t xp_len, int64_t nrows) {
  using V = typename Vec16<T>::type;
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kVecs = KC / kPerVec;
  static_assert(KC % kPerVec == 0, "KC columns must fill 16-byte vectors");

  const int64_t t = blockIdx.x / kBlocksPerTile;
  const int r = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int s = r >> 7;          // sublane of the row within its tile
  const int l = r & 127;         // lane of the row
  const int64_t slot0 = t * K;
  T acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = T(0);

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
        (static_cast<int64_t>(__ldg(brow + slot)) + s) * 128 + l + u;
    const T v = __ldg(data + e);
    if constexpr (kRowMajor) {
      const V* __restrict__ xv = reinterpret_cast<const V*>(xp + xi * KC);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        union { V vec; T elem[kPerVec]; } w;
        w.vec = __ldg(xv + q);
#pragma unroll
        for (int i = 0; i < kPerVec; ++i) acc[q * kPerVec + i] += v * w.elem[i];
      }
    } else {
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] += v * __ldg(xp + j * xp_len + xi);
    }
  }

  const int64_t row = t * kTile + r;
  if constexpr (kRowMajor) {
    V* __restrict__ yv = reinterpret_cast<V*>(y + row * KC);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      union { V vec; T elem[kPerVec]; } w;
#pragma unroll
      for (int i = 0; i < kPerVec; ++i) w.elem[i] = acc[q * kPerVec + i];
      yv[q] = w.vec;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KC; ++j) y[j * nrows + row] = acc[j];
  }
}

struct Args {
  const void *data, *brow, *diag_u, *uloc, *xp;
  void* y;
  int64_t tp;
  int k;
  int64_t xp_len;
  void* stream;
};

template <typename T, typename U, bool kRoll, int KC, bool kRowMajor>
int go(const Args& a) {
  const int64_t blocks = a.tp * kBlocksPerTile;
  wjd_spmm_kernel<T, U, kRoll, KC, kRowMajor>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const T*>(a.data), static_cast<const int32_t*>(a.brow),
          static_cast<const int32_t*>(a.diag_u),
          static_cast<const U*>(a.uloc), static_cast<const T*>(a.xp),
          static_cast<T*>(a.y), a.k, a.xp_len, a.tp * kTile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U, bool kRoll, int KC>
int by_layout(const Args& a, int row_major) {
  return row_major ? go<T, U, kRoll, KC, true>(a)
                   : go<T, U, kRoll, KC, false>(a);
}

template <typename T, typename U, bool kRoll>
int launch(const Args& a, int kc, int row_major) {
  if (a.tp <= 0 || a.k <= 0 || a.xp_len <= 0 ||
      a.tp * kBlocksPerTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kc) {
    case 4: return by_layout<T, U, kRoll, 4>(a, row_major);
    case 8: return by_layout<T, U, kRoll, 8>(a, row_major);
    case 16: return by_layout<T, U, kRoll, 16>(a, row_major);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_gather(const Args& a, int uloc_bytes, int kc, int row_major) {
  if (uloc_bytes == 1) return launch<T, uint8_t, false>(a, kc, row_major);
  if (uloc_bytes == 2) return launch<T, int16_t, false>(a, kc, row_major);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). xp holds kc columns of padded X
// and y kc columns of Tp*1024 rows, both row-major (rows, kc) when row_major
// is set, else planes (kc, rows). Each returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" {

int wjd_spmm_roll_f64(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      int row_major, int64_t xp_len, void* stream) {
  return launch<double, uint8_t, true>(
      Args{data, brow, diag_u, nullptr, xp, y, tp, k, xp_len, stream}, kc,
      row_major);
}

int wjd_spmm_roll_f32(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      int row_major, int64_t xp_len, void* stream) {
  return launch<float, uint8_t, true>(
      Args{data, brow, diag_u, nullptr, xp, y, tp, k, xp_len, stream}, kc,
      row_major);
}

int wjd_spmm_gather_f64(const void* data, const void* brow, const void* uloc,
                        int uloc_bytes, const void* xp, void* y, int64_t tp,
                        int k, int kc, int row_major, int64_t xp_len,
                        void* stream) {
  return launch_gather<double>(
      Args{data, brow, nullptr, uloc, xp, y, tp, k, xp_len, stream},
      uloc_bytes, kc, row_major);
}

int wjd_spmm_gather_f32(const void* data, const void* brow, const void* uloc,
                        int uloc_bytes, const void* xp, void* y, int64_t tp,
                        int k, int kc, int row_major, int64_t xp_len,
                        void* stream) {
  return launch_gather<float>(
      Args{data, brow, nullptr, uloc, xp, y, tp, k, xp_len, stream},
      uloc_bytes, kc, row_major);
}

}  // extern "C"
