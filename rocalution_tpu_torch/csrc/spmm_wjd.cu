// WJD blocked-right-hand-side SpMM (Y = A X, X of KC columns) for NVIDIA
// Hopper (sm_90a).
//
// Replaces rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_mrhs, the Pallas
// kernel that loads every slot value once for a chunk of at most 16 columns:
//
//   wjd_spmm_roll_f32, wjd_spmm_gather_f32   the kernel's f32 path
//   wjd_spmm_roll_bf16, wjd_spmm_gather_bf16 its bfloat16-values path: the
//       values are widened into f32 sums over an f32 X, as the JAX kernel
//       widens them to its f32 accumulator (acc_dt); the gather one is a
//       kernel of its own (below)
//   wjd_spmm_roll_f64, wjd_spmm_gather_f64   the same in fp64, where the JAX
//       package loops over columns through its float-float kernels; the
//       function Y = A X is the same.
//
// The type V of the values is apart from the type T of X, the sums and Y
// (V = T but for bf16). In the templated kernels a lane widens the value it
// loads to T at once, so that the shuffles and the products are in T; the
// bf16 gather kernel holds its values raw (below).
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
// Both kernels put the lanes of a warp across the columns. Their first
// versions gave one thread a row and KC register accumulators; a thread's 16
// doubles of row-major X are then a 128-byte line of its own, so one warp
// load touched 32 lines, and the f64 kernels ran at a third of their bound.
//
// Roll mode (wjd_spmm_roll_kernel) streams the slot planes, which a banded
// operator fills. A slot's loads are regular: rows r .. r+31 of slot (t, k)
// read the 32 consecutive rows of X from brow[t,k]*128 + r + diag_u[t,k] on,
// one contiguous piece of 32*KC values.
//   * one warp owns 32 consecutive rows of a tile. Per slot it loads their 32
//     values coalesced (streamed, ld.global.cs), one a lane;
//   * it then walks the rows 32/KC at a time, broadcasting a row's value with
//     __shfl_sync: with KC = 16, lanes 0-15 take the 16 columns of one row
//     and lanes 16-31 those of the next, so every access to X is whole
//     128-byte lines read by adjacent lanes, and Y is written as whole lines;
//   * each lane keeps KC accumulators: rows i*(32/KC) + lane/KC, i < KC, of
//     its column lane%KC. A column is summed over k in ascending slot order,
//     as the single-RHS roll kernel sums it, whatever KC is;
//   * the next slot's value, brow and diag_u are loaded before this slot's
//     reads of X start;
//   * X is read once a slot (K times in all) through L1 and L2; that, not
//     HBM, sets the pace. Blocks of 256 rows were the fastest of 128, 256,
//     512 and 1024 on the H100 at 1M rows and 16 columns; a whole tile a
//     block, meant to let slots with close diagonals share lines of X in L1,
//     was the slowest in f32.
//
// Gather mode (wjd_compact_spmm_kernel) reads the plan's row-compacted slice
// form (formats/wjd.py:compact_slices; csrc/spmv_wjd.cu says why). Its first
// version walked the padded slot planes with one thread a row, as roll mode
// did; it streamed 5.6x the operator in padding and gathered X for all of
// it. This one:
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
//
// Gather mode on bfloat16 values (wjd_compact_spmm_raw_kernel) serves a
// bfloat16 plan whose offsets pass 16 bits: one with 2-byte offsets takes
// the packed form and csrc/wjd_bf16_packed.cu (formats/wjd.py chooses by
// offset width alone), though this kernel takes both widths. As the
// template's bf16 instantiation it took 424.8 us at 1M rows and 16 columns,
// above the f32 twin's 375.0 on fewer bytes (one H100 80GB HBM3 at 700 W):
// its SASS widens the prefetched value as soon as the load is issued, so
// every rank waits out the stream's latency before its gathers. Now:
//   * the same warp, lane and column map as the template, so X and Y
//     accesses stay whole lines;
//   * a lane holds its values raw (the bfloat16 bits) from the load through
//     the shuffle, and widens them with one shift after the rank's gathers
//     of X are issued;
//   * ranks go in groups of kAhead: the coalesced value and offset loads of
//     the next group are issued before the shuffles and gathers of this one,
//     so a group's KC gathers a rank never wait on the stream; the ragged
//     last group runs under a predicate uniform over the warp;
//   * a row's terms are added in ascending rank order with fmaf, so a column
//     is the single-RHS compact kernel's sum bit for bit.
// On one H100 80GB HBM3 at 700 W, random_banded_spd(1<<20) f32 rounded to
// bf16, its compact form on 4-byte offsets (21.9M stored elements), 16
// columns, us a launch, the mean of 20 back-to-back launches, the median
// of 12 rounds (scripts/bf16_roll_spmm_variants.py): the template 421.0;
// this body at 1, 2, 4 and 8 ranks a group 243.3, 249.2, 243.5 (shipped)
// and 272.4 (96 registers a thread at 4, 106 at 8). The depth moves little:
// what the template lost was the order within a rank, not the stream's
// latency. This body issues a rank's KC gathers before its first FMA and
// widens after the shuffle; on the f32 plan the same body takes 240.9
// against the f32 template's 370.8. Not kept: X gathered 16 bytes a lane
// (the packed SpMM's map, KC/4 lanes a row, X 16-byte aligned) 194.6; the
// packed SpMM of the same plan takes 173.6.
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
constexpr int kSlice = 32;                        // rows per warp / slice
constexpr int kRollThreads = 256;                 // rows per block
static_assert(kTile % kRollThreads == 0 && kRollThreads % kSlice == 0,
              "a block holds whole warps of one tile");
constexpr int kCompactThreads = 128;              // 4 slices per block
constexpr int kSlicesPerBlock = kCompactThreads / kSlice;

template <typename V, typename T, int KC>
__global__ void __launch_bounds__(kRollThreads)
wjd_spmm_roll_kernel(const V* __restrict__ data,
                     const int32_t* __restrict__ brow,
                     const int32_t* __restrict__ diag_u,
                     const T* __restrict__ xp, T* __restrict__ y, int K) {
  constexpr int kRowsPerPass = kSlice / KC;
  // the warp's first row, its tile, and the row's place in the tile
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRollThreads +
                       threadIdx.x / kSlice * kSlice;
  const int64_t slot0 = row0 / kTile * K;
  const int r0 = static_cast<int>(row0 % kTile);
  const int lane = threadIdx.x % kSlice;
  const int h = lane / KC;       // which row of a pass this lane serves
  const int c = lane % KC;       // which column
  T acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = T(0);

  // slot (t, k) reads X rows brow*128 + s*128 + l + u = brow*128 + r + u.
  // The next slot's operands are loaded before this slot's reads of X
  // start, so that the two latencies overlap.
  T v_next = widen(__ldcs(data + slot0 * kTile + r0 + lane));
  int64_t x_next =
      static_cast<int64_t>(__ldg(brow + slot0)) * 128 + r0 + __ldg(diag_u + slot0);
  for (int k = 0; k < K; ++k) {
    const T v = v_next;
    const T* __restrict__ xs = xp + (x_next + h) * KC + c;
    if (k + 1 < K) {
      const int64_t slot = slot0 + k + 1;
      v_next = widen(__ldcs(data + slot * kTile + r0 + lane));
      x_next = static_cast<int64_t>(__ldg(brow + slot)) * 128 + r0 +
               __ldg(diag_u + slot);
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const T vi = __shfl_sync(0xffffffffu, v, i * kRowsPerPass + h);
      acc[i] += vi * __ldg(xs + i * kRowsPerPass * KC);
    }
  }

  T* __restrict__ ys = y + (row0 + h) * KC + c;
#pragma unroll
  for (int i = 0; i < KC; ++i) ys[i * kRowsPerPass * KC] = acc[i];
}

struct RollArgs {
  const void *data, *brow, *diag_u, *xp;
  void* y;
  int64_t tp;
  int k;
  void* stream;
};

template <typename V, typename T, int KC>
int go_roll(const RollArgs& a) {
  const int64_t blocks = a.tp * (kTile / kRollThreads);
  wjd_spmm_roll_kernel<V, T, KC>
      <<<static_cast<unsigned>(blocks), kRollThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const V*>(a.data), static_cast<const int32_t*>(a.brow),
          static_cast<const int32_t*>(a.diag_u), static_cast<const T*>(a.xp),
          static_cast<T*>(a.y), a.k);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int launch_roll(const RollArgs& a, int kc) {
  if (a.tp <= 0 || a.k <= 0 ||
      a.tp * (kTile / kRollThreads) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kc) {
    case 4: return go_roll<V, T, 4>(a);
    case 8: return go_roll<V, T, 8>(a);
    case 16: return go_roll<V, T, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename V, typename T, typename O, int KC>
__global__ void __launch_bounds__(kCompactThreads)
wjd_compact_spmm_kernel(const V* __restrict__ cval, const O* __restrict__ coff,
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
    v_next = widen(__ldcs(cval + p));
    o_next = static_cast<int>(__ldcs(coff + p));
  }
  for (; p < end; p += kSlice) {
    const T v = v_next;
    const int o = o_next;
    if (p + kSlice < end) {
      v_next = widen(__ldcs(cval + p + kSlice));
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

template <typename V, typename T, typename O, int KC>
int go_compact(const CompactArgs& a) {
  const int64_t blocks = (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  wjd_compact_spmm_kernel<V, T, O, KC>
      <<<static_cast<unsigned>(blocks), kCompactThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const V*>(a.cval), static_cast<const O*>(a.coff),
          static_cast<const int64_t*>(a.slice_ptr),
          static_cast<const int64_t*>(a.xbase), static_cast<const T*>(a.xp),
          static_cast<T*>(a.y), a.nslices);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T, typename O>
int compact_by_width(const CompactArgs& a, int kc) {
  switch (kc) {
    case 4: return go_compact<V, T, O, 4>(a);
    case 8: return go_compact<V, T, O, 8>(a);
    case 16: return go_compact<V, T, O, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename V, typename T>
int launch_gather(const CompactArgs& a, int coff_bytes, int kc) {
  if (a.nslices <= 0 ||
      (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (coff_bytes == 2) return compact_by_width<V, T, uint16_t>(a, kc);
  if (coff_bytes == 4) return compact_by_width<V, T, int32_t>(a, kc);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- gather mode on bfloat16 values: raw values, kAhead ranks ahead ----

constexpr int kAhead = 4;                         // ranks a group

// What a lane holds of a stored value until its row's lanes sum it: a
// bfloat16 value's bits, widened to f32 by one shift after the shuffle.
template <typename V>
struct Held;
template <>
struct Held<__nv_bfloat16> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float widen(uint32_t b) {
    return __uint_as_float(b << 16);
  }
};

// ranks p, p + 32, ..., p + (D-1)*32 of a lane's row, as loaded: the value
// held raw and the offset; past `end` (a uniform predicate: a slice is a
// whole number of ranks) a zero, which is never summed
template <typename V, typename O, int D>
__device__ __forceinline__ void load_group(
    const V* __restrict__ cval, const O* __restrict__ coff, int64_t p,
    int64_t end, typename Held<V>::type (&v)[D], int (&o)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int64_t q = p + j * kSlice;
    v[j] = q < end ? Held<V>::load(cval + q) : typename Held<V>::type(0);
    o[j] = q < end ? static_cast<int>(__ldcs(coff + q)) : 0;
  }
}

template <typename V, typename O, int KC, int D>
__global__ void __launch_bounds__(kCompactThreads)
wjd_compact_spmm_raw_kernel(const V* __restrict__ cval,
                            const O* __restrict__ coff,
                            const int64_t* __restrict__ slice_ptr,
                            const int64_t* __restrict__ xbase,
                            const float* __restrict__ xp,
                            float* __restrict__ y, int64_t nslices) {
  using H = Held<V>;
  constexpr int kRowsPerPass = kSlice / KC;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock + threadIdx.x / kSlice;
  if (slice >= nslices) return;                   // uniform over the warp
  const int lane = threadIdx.x % kSlice;
  const int h = lane / KC;       // which row of a pass this lane serves
  const int c = lane % KC;       // which column
  const int64_t end = __ldg(slice_ptr + slice + 1);
  const float* __restrict__ xs = xp + __ldg(xbase + slice) * KC + c;
  float acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0.f;

  typename H::type v[D];
  int o[D];
  int64_t p = __ldg(slice_ptr + slice) + lane;
  load_group<V, O, D>(cval, coff, p, end, v, o);
  for (; p < end; p += D * kSlice) {
    // the next group's loads go out before this group's gathers of X
    typename H::type v_next[D];
    int o_next[D];
    load_group<V, O, D>(cval, coff, p + D * kSlice, end, v_next, o_next);
    // ranks in ascending order; the ragged last group under a predicate
    // that is uniform over the warp
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (p + j * kSlice < end) {
        float xv[KC];
        typename H::type vi[KC];
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          const int src = i * kRowsPerPass + h;
          const int64_t oi = __shfl_sync(0xffffffffu, o[j], src);
          vi[i] = __shfl_sync(0xffffffffu, v[j], src);
          xv[i] = __ldg(xs + oi * KC);
        }
        // widened only now, after this rank's gathers are issued
#pragma unroll
        for (int i = 0; i < KC; ++i)
          acc[i] = fmaf(H::widen(vi[i]), xv[i], acc[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      v[j] = v_next[j];
      o[j] = o_next[j];
    }
  }

  float* __restrict__ ys = y + (slice * kSlice + h) * KC + c;
#pragma unroll
  for (int i = 0; i < KC; ++i) ys[i * kRowsPerPass * KC] = acc[i];
}

template <typename V, typename O, int KC, int D>
int go_compact_raw(const CompactArgs& a) {
  const int64_t blocks = (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  wjd_compact_spmm_raw_kernel<V, O, KC, D>
      <<<static_cast<unsigned>(blocks), kCompactThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const V*>(a.cval), static_cast<const O*>(a.coff),
          static_cast<const int64_t*>(a.slice_ptr),
          static_cast<const int64_t*>(a.xbase),
          static_cast<const float*>(a.xp), static_cast<float*>(a.y),
          a.nslices);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int D>
int launch_gather_raw(const CompactArgs& a, int coff_bytes, int kc) {
  if (a.nslices <= 0 ||
      (a.nslices + kSlicesPerBlock - 1) / kSlicesPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
#define WJD_RAW_CASE(O, KC)                                                 \
  if (kc == KC) return go_compact_raw<V, O, KC, D>(a);
  if (coff_bytes == 2) {
    WJD_RAW_CASE(uint16_t, 4) WJD_RAW_CASE(uint16_t, 8)
    WJD_RAW_CASE(uint16_t, 16)
  } else if (coff_bytes == 4) {
    WJD_RAW_CASE(int32_t, 4) WJD_RAW_CASE(int32_t, 8)
    WJD_RAW_CASE(int32_t, 16)
  }
#undef WJD_RAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. xp holds kc columns of padded X and y kc
// columns, both row-major (rows, kc).
// Roll: the slot planes; y has tp*1024 rows.
// Gather: the compact slice form (values, offsets of coff_bytes 2 or 4 each,
// slice_ptr of nslices + 1 and xbase of nslices int64 entries); y has
// nslices*32 rows.
// The bf16 entry points take bfloat16 values and an f32 xp and y.
extern "C" {

int wjd_spmm_roll_f64(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      void* stream) {
  return launch_roll<double, double>(
      RollArgs{data, brow, diag_u, xp, y, tp, k, stream}, kc);
}

int wjd_spmm_roll_f32(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k, int kc,
                      void* stream) {
  return launch_roll<float, float>(
      RollArgs{data, brow, diag_u, xp, y, tp, k, stream}, kc);
}

int wjd_spmm_roll_bf16(const void* data, const void* brow, const void* diag_u,
                       const void* xp, void* y, int64_t tp, int k, int kc,
                       void* stream) {
  return launch_roll<__nv_bfloat16, float>(
      RollArgs{data, brow, diag_u, xp, y, tp, k, stream}, kc);
}

int wjd_spmm_gather_f64(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices, int kc,
                        void* stream) {
  return launch_gather<double, double>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

int wjd_spmm_gather_f32(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices, int kc,
                        void* stream) {
  return launch_gather<float, float>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

int wjd_spmm_gather_bf16(const void* cval, const void* coff, int coff_bytes,
                         const void* slice_ptr, const void* xbase,
                         const void* xp, void* y, int64_t nslices, int kc,
                         void* stream) {
  return launch_gather_raw<__nv_bfloat16, kAhead>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

}  // extern "C"

#ifdef WJD_VARIANTS
// The designs timed for wjd_spmm_gather_bf16, compiled only with
// -DWJD_VARIANTS by scripts/bf16_roll_spmm_variants.py: the f32 template on
// bfloat16 values (the kernel before), the raw body at 1, 2, 4 or 8 ranks a
// group, the raw body on f32 values (the f32 twin on the same pipeline),
// and the raw body with X gathered 16 bytes a lane (the packed SpMM's map:
// KC/4 lanes a row, 4 columns a lane; X 16-byte aligned).
namespace {

// an f32 value is held as it is
template <>
struct Held<float> {
  using type = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
};

template <typename O, int KC, int D>
__global__ void __launch_bounds__(kCompactThreads)
wjd_compact_spmm_x4_kernel(const __nv_bfloat16* __restrict__ cval,
                           const O* __restrict__ coff,
                           const int64_t* __restrict__ slice_ptr,
                           const int64_t* __restrict__ xbase,
                           const float* __restrict__ xp,
                           float* __restrict__ y, int64_t nslices) {
  using H = Held<__nv_bfloat16>;
  constexpr int kLanesPerRow = KC / 4;
  constexpr int kRowsPerPass = kSlice / kLanesPerRow;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock + threadIdx.x / kSlice;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % kSlice;
  const int h = lane / kLanesPerRow;
  const int c = lane % kLanesPerRow;
  const int64_t end = __ldg(slice_ptr + slice + 1);
  const float4* __restrict__ xs =
      reinterpret_cast<const float4*>(xp + __ldg(xbase + slice) * KC) + c;
  float4 acc[kLanesPerRow];
#pragma unroll
  for (int i = 0; i < kLanesPerRow; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t v[D];
  int o[D];
  int64_t p = __ldg(slice_ptr + slice) + lane;
  load_group<__nv_bfloat16, O, D>(cval, coff, p, end, v, o);
  for (; p < end; p += D * kSlice) {
    uint32_t v_next[D];
    int o_next[D];
    load_group<__nv_bfloat16, O, D>(cval, coff, p + D * kSlice, end, v_next,
                                    o_next);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (p + j * kSlice < end) {
        float4 xv[kLanesPerRow];
        uint32_t vi[kLanesPerRow];
#pragma unroll
        for (int i = 0; i < kLanesPerRow; ++i) {
          const int src = i * kRowsPerPass + h;
          const int64_t oi = __shfl_sync(0xffffffffu, o[j], src);
          vi[i] = __shfl_sync(0xffffffffu, v[j], src);
          xv[i] = __ldg(xs + oi * kLanesPerRow);
        }
#pragma unroll
        for (int i = 0; i < kLanesPerRow; ++i) {
          const float w = H::widen(vi[i]);
          acc[i].x = fmaf(w, xv[i].x, acc[i].x);
          acc[i].y = fmaf(w, xv[i].y, acc[i].y);
          acc[i].z = fmaf(w, xv[i].z, acc[i].z);
          acc[i].w = fmaf(w, xv[i].w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      v[j] = v_next[j];
      o[j] = o_next[j];
    }
  }
  float4* __restrict__ ys =
      reinterpret_cast<float4*>(y + slice * kSlice * KC) + c;
#pragma unroll
  for (int i = 0; i < kLanesPerRow; ++i)
    ys[(i * kRowsPerPass + h) * kLanesPerRow] = acc[i];
}

}  // namespace

extern "C" {

int wjd_spmm_gather_bf16_x4_variant(const void* cval, const void* coff,
                                    int coff_bytes, const void* slice_ptr,
                                    const void* xbase, const void* xp,
                                    void* y, int64_t nslices, int kc,
                                    void* stream) {
  if (coff_bytes != 4 || kc != 16 || nslices <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_compact_spmm_x4_kernel<int32_t, 16, kAhead>
      <<<static_cast<unsigned>((nslices + kSlicesPerBlock - 1) /
                               kSlicesPerBlock),
         kCompactThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(cval),
          static_cast<const int32_t*>(coff),
          static_cast<const int64_t*>(slice_ptr),
          static_cast<const int64_t*>(xbase), static_cast<const float*>(xp),
          static_cast<float*>(y), nslices);
  return static_cast<int>(cudaGetLastError());
}

int wjd_spmm_gather_bf16_before(const void* cval, const void* coff,
                                int coff_bytes, const void* slice_ptr,
                                const void* xbase, const void* xp, void* y,
                                int64_t nslices, int kc, void* stream) {
  return launch_gather<__nv_bfloat16, float>(
      CompactArgs{cval, coff, slice_ptr, xbase, xp, y, nslices, stream},
      coff_bytes, kc);
}

int wjd_spmm_gather_raw_variant(int f32, int ahead, const void* cval,
                                const void* coff, int coff_bytes,
                                const void* slice_ptr, const void* xbase,
                                const void* xp, void* y, int64_t nslices,
                                int kc, void* stream) {
  const CompactArgs a{cval, coff, slice_ptr, xbase, xp, y, nslices, stream};
#define WJD_AHEAD_CASE(D)                                                   \
  if (ahead == D)                                                           \
    return f32 ? launch_gather_raw<float, D>(a, coff_bytes, kc)             \
               : launch_gather_raw<__nv_bfloat16, D>(a, coff_bytes, kc);
  WJD_AHEAD_CASE(1) WJD_AHEAD_CASE(2) WJD_AHEAD_CASE(4) WJD_AHEAD_CASE(8)
#undef WJD_AHEAD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
#endif  // WJD_VARIANTS
