// WJD blocked-right-hand-side SpMM (Y = A X, X of KC columns) for NVIDIA
// Hopper (sm_90a).
//
// Replaces rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_mrhs, the Pallas
// kernel that loads every slot value once for a chunk of at most 16 columns:
//
//   wjd_spmm_roll_f32, wjd_spmm_gather_f32   the kernel's f32 path
//   wjd_spmm_roll_f64, wjd_spmm_gather_f64   the same in fp64, where the JAX
//       package loops over columns through its float-float kernels; the
//       function Y = A X is the same.
//
// Semantics per column j (wjd_reference): element (t, k, s, l) of slot (t, k)
// multiplies X_padded[(brow[t,k] + s) * 128 + l + u, j], with u = diag_u[t,k]
// in roll mode and u = uloc[t,k,s,l] in gather mode, summed over k into row
// t*1024 + s*128 + l of column j. The COO spill, the DIA part and the column
// chunking are the Python wrapper's
// (rocalution_tpu_torch/ops/cuda/spmv_wjd.py). The result does not depend on
// how the columns are chunked: every column is summed over k in the same
// order whatever KC is, and the columns a chunk pads with zeros are dropped.
//
// Bound: bytes through HBM are the operator's values (+ offsets) once, plus
// X and Y: one sixteenth per column of what sixteen single applies stream.
// What then sets the pace is the gather of X through L1 and L2.
//
// Roll mode (wjd_spmm_roll_kernel) streams the slot planes, which a banded
// operator fills:
//   * one thread owns one row (t, s, l), loops over k, loads the value, brow
//     and diag_u once per slot and updates KC register accumulators (KC = 4,
//     8 or 16 is a template parameter; a ragged chunk is padded up by the
//     wrapper);
//   * two layouts of padded X are instantiated. Row-major (xp_len, KC): a
//     thread's KC values are contiguous (16-byte vector loads), and neither X
//     nor Y needs a transpose; the wrapper uses it. Planes (KC, xp_len), the
//     reference's layout: each column's loads coalesce along the lane, at the
//     price of two transposes a call. Measured on the H100 at 1M rows and 16
//     columns, row-major won in f32 and planes in f64 (a thread's 16 doubles
//     are a whole 128-byte line, so a warp's vector load touches 32 lines),
//     but the transposes cost more than the f64 kernel gained; the planes
//     instantiation is kept so that a run on the card can time both on the
//     same operands. See PERF.md.
//
// Gather mode (wjd_compact_spmm_kernel) reads the plan's row-compacted slice
// form (formats/wjd.py:compact_slices; csrc/spmv_wjd.cu says why). Its first
// version walked the padded slot planes with one thread a row, as roll mode
// does, and had a planes instantiation too; it streamed 5.6x the operator in
// padding, gathered X for all of it, and in f64 each thread's row of X was a
// line of its own. This one puts the lanes across the columns:
//   * one warp owns one slice of 32 rows. Per rank it loads the 32 values and
//     32 offsets of the slice coalesced (streamed, ld.global.cs), one a lane;
//   * it then walks the slice's rows 32/KC at a time, broadcasting a row's
//     (value, offset) with __shfl_sync: with KC = 16, lanes 0-15 take the 16
//     columns of one row and lanes 16-31 those of the next, so every access
//     to row-major X is one full line (f64) or half a line (f32) read by 16
//     adjacent lanes, and Y's rows are written as whole lines;
//   * each lane keeps KC accumulators: rows i*(32/KC) + lane/KC, i < KC, of
//     its column lane%KC. A row's terms are added in ascending slot order,
//     as the single-RHS kernel adds them, whatever KC is;
//   * the next rank's values and offsets are loaded before this rank's KC
//     gathers of X are issued; without that the two latencies add up in every
//     rank, which on the H100 at 1M rows and 16 columns cost about half the
//     kernel's time in f64. Blocks of 128 threads (4 slices) were the fastest
//     of 128, 256 and 512.
// Element offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;                       // rows per tile
constexpr int kThreads = 256;                     // rows per block
constexpr int kBlocksPerTile = kTile / kThreads;
constexpr int kSlice = 32;                        // rows per compact slice
constexpr int kCompactThreads = 128;              // 4 slices per block
constexpr int kSlicesPerBlock = kCompactThreads / kSlice;

template <typename T> struct Vec16;               // 16-byte vector of T
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T, int KC, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
wjd_spmm_roll_kernel(const T* __restrict__ data,
                     const int32_t* __restrict__ brow,
                     const int32_t* __restrict__ diag_u,
                     const T* __restrict__ xp, T* __restrict__ y, int K,
                     int64_t xp_len, int64_t nrows) {
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
    const int u = __ldg(diag_u + slot);
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

struct RollArgs {
  const void *data, *brow, *diag_u, *xp;
  void* y;
  int64_t tp;
  int k;
  int64_t xp_len;
  void* stream;
};

template <typename T, int KC, bool kRowMajor>
int go_roll(const RollArgs& a) {
  const int64_t blocks = a.tp * kBlocksPerTile;
  wjd_spmm_roll_kernel<T, KC, kRowMajor>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const T*>(a.data), static_cast<const int32_t*>(a.brow),
          static_cast<const int32_t*>(a.diag_u), static_cast<const T*>(a.xp),
          static_cast<T*>(a.y), a.k, a.xp_len, a.tp * kTile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC>
int roll_by_layout(const RollArgs& a, int row_major) {
  return row_major ? go_roll<T, KC, true>(a) : go_roll<T, KC, false>(a);
}

template <typename T>
int launch_roll(const RollArgs& a, int kc, int row_major) {
  if (a.tp <= 0 || a.k <= 0 || a.xp_len <= 0 ||
      a.tp * kBlocksPerTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kc) {
    case 4: return roll_by_layout<T, 4>(a, row_major);
    case 8: return roll_by_layout<T, 8>(a, row_major);
    case 16: return roll_by_layout<T, 16>(a, row_major);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename O, int KC>
__global__ void __launch_bounds__(kCompactThreads)
wjd_compact_spmm_kernel(const T* __restrict__ cval, const O* __restrict__ coff,
                        const int64_t* __restrict__ slice_ptr,
                        const int64_t* __restrict__ xbase,
                        const T* __restrict__ xp, T* __restrict__ y,
                        int64_t nslices) {
  constexpr int kRowsPerPass = kSlice / KC;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock + threadIdx.x / kSlice;
  if (slice >= nslices) return;                   // uniform over the warp
  const int lane = threadIdx.x % kSlice;
  const int h = lane / KC;       // which row of a pass this lane serves
  const int c = lane % KC;       // which column
  const int64_t end = __ldg(slice_ptr + slice + 1);
  const T* __restrict__ xs = xp + __ldg(xbase + slice) * KC + c;
  T acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = T(0);

  // the next rank's value and offset are loaded before this rank's gathers
  // of X are issued, so that the two latencies overlap
  int64_t p = __ldg(slice_ptr + slice) + lane;
  T v_next = T(0);
  int o_next = 0;
  if (p < end) {
    v_next = __ldcs(cval + p);
    o_next = static_cast<int>(__ldcs(coff + p));
  }
  for (; p < end; p += kSlice) {
    const T v = v_next;
    const int o = o_next;
    if (p + kSlice < end) {
      v_next = __ldcs(cval + p + kSlice);
      o_next = static_cast<int>(__ldcs(coff + p + kSlice));
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int src = i * kRowsPerPass + h;
      const T vi = __shfl_sync(0xffffffffu, v, src);
      const int64_t oi = __shfl_sync(0xffffffffu, o, src);
      acc[i] += vi * __ldg(xs + oi * KC);
    }
  }

  T* __restrict__ ys = y + (slice * kSlice + h) * KC + c;
#pragma unroll
  for (int i = 0; i < KC; ++i) ys[i * kRowsPerPass * KC] = acc[i];
}

struct CompactArgs {
  const void *cval, *coff, *slice_ptr, *xbase, *xp;
  void* y;
  int64_t nslices;
  void* stream;
};

template <typename T, typename O, int KC>
int go_compact(const CompactArgs& a) {
  const int64_t blocks = (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  wjd_compact_spmm_kernel<T, O, KC>
      <<<static_cast<unsigned>(blocks), kCompactThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const T*>(a.cval), static_cast<const O*>(a.coff),
          static_cast<const int64_t*>(a.slice_ptr),
          static_cast<const int64_t*>(a.xbase), static_cast<const T*>(a.xp),
          static_cast<T*>(a.y), a.nslices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int compact_by_width(const CompactArgs& a, int kc) {
  switch (kc) {
    case 4: return go_compact<T, O, 4>(a);
    case 8: return go_compact<T, O, 8>(a);
    case 16: return go_compact<T, O, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_gather(const CompactArgs& a, int coff_bytes, int kc) {
  if (a.nslices <= 0 ||
      (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (coff_bytes == 2) return compact_by_width<T, uint16_t>(a, kc);
  if (coff_bytes == 4) return compact_by_width<T, int32_t>(a, kc);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success.
//
// Roll: xp holds kc columns of padded X and y kc columns of Tp*1024 rows,
// both row-major (rows, kc) when row_major is set, else planes (kc, rows).
// Gather: the compact slice form (values, offsets of coff_bytes 2 or 4 each,
// slice_ptr of nslices + 1 and xbase of nslices int64 entries); xp and y are
// row-major, y of nslices*32 rows.
extern "C" {

int wjd_spmm_roll_f64(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      int row_major, int64_t xp_len, void* stream) {
  return launch_roll<double>(
      RollArgs{data, brow, diag_u, xp, y, tp, k, xp_len, stream}, kc,
      row_major);
}

int wjd_spmm_roll_f32(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      int row_major, int64_t xp_len, void* stream) {
  return launch_roll<float>(
      RollArgs{data, brow, diag_u, xp, y, tp, k, xp_len, stream}, kc,
      row_major);
}

int wjd_spmm_gather_f64(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices, int kc,
                        void* stream) {
  return launch_gather<double>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

int wjd_spmm_gather_f32(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices, int kc,
                        void* stream) {
  return launch_gather<float>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

}  // extern "C"
