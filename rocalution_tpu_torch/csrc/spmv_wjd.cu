// WJD (windowed jagged-diagonal) single-RHS SpMV for NVIDIA Hopper (sm_90a).
//
// Two templated kernels replace four Pallas kernels of the JAX package:
//
//   wjd_spmv_roll_f64    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll_ff
//   wjd_spmv_roll_f32    rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_roll
//                        (on bfloat16 values: wjd_spmv_roll_bf16, 4 rows a
//                        thread, csrc/spmv_wjd_win.cu)
//   wjd_spmv_gather_f64  rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel_ff
//   wjd_spmv_gather_f32  rocalution_tpu/ops/pallas/spmv_wjd.py:_kernel
//   wjd_spmv_gather_bf16 the same, on bfloat16 values
//
// Each kernel takes the type V of the values apart from the type T of x,
// the sums and y: V = T for f64 and f32; V = bfloat16 with T = float for
// the bf16 gather entry point, as the JAX kernels widen bfloat16 values to
// their f32 accumulator (acc_dt). Such a plan streams 2 bytes a value where
// f32 streams 4; its x and y are f32.
//
// Semantics (wjd_reference): element (t, k, s, l) of slot (t, k) multiplies
// xp[(brow[t,k] + s) * 128 + l + u], with u = diag_u[t,k] in roll mode and
// u = uloc[t,k,s,l] in gather mode, and the products sum over k into row
// t*1024 + s*128 + l of y. The COO spill and the DIA part are added by the
// Python wrapper (rocalution_tpu_torch/ops/cuda/spmv_wjd.py).
//
// Bound: bytes, two flops per element read.
//
// Roll mode (wjd_roll_kernel) streams the slot planes: a slot of a banded
// operator is nearly full (padding 1.02x on a 7-point stencil), so
// Tp*K*1024*sizeof(T) bytes are the operator's own. The design serves that:
//   * one thread owns one row (t, s, l) and loops over k; for a fixed (t, k)
//     the 1024 values are contiguous, so a warp's loads coalesce along l
//     into full 128-byte lines;
//   * a block of 256 threads covers a quarter tile, so brow[t,k] and
//     diag_u[t,k] are uniform per block (one broadcast load per warp);
//   * x is read through the read-only path (__ldg); neighbouring rows hit
//     the same lines, which stay in L2 for banded operators.
//
// Gather mode (wjd_compact_kernel) does not stream the slot planes. A slot
// exists for every (tile, window, rank) that any of 1024 rows occupies, so
// on a scattered operator the planes are mostly padding: 5.6x the nonzeros
// at 15 a row, and a kernel that walked all K slots of every row (this
// file's first gather kernel) ran at 0.8 of those bytes and still lost 2.4x
// to a CSR product. The planes' shape is a TPU's, whose (8, 128) vector unit
// wants dense 1024-element slots; a warp wants 32. So the kernel reads the
// plan's row-compacted slice form (formats/wjd.py:compact_slices): a slice
// is 32 consecutive rows, as wide as its longest row, stored rank-major
// (element (j, lane) at slice_ptr[slice] + j*32 + lane), each entry a value
// and a 2-byte (or 4-byte) offset into padded x relative to xbase[slice].
// That is 10 bytes a stored element in f64 and 6 in f32, at a padding of
// about 1.4x. The design:
//   * one warp owns one slice and one thread one row; the loop over ranks
//     loads values and offsets coalesced, and streams them (ld.global.cs) so
//     that x, which is gathered, keeps the cache;
//   * the rank loop is unrolled by 8 so that several gathers of x are in
//     flight, in blocks of 512 threads (16 slices): the fastest of the
//     shapes tried on the H100 at 1M rows (128 to 1024 threads, unrolled by
//     1 to 16);
//   * a row's terms are added in ascending slot order, as the slot product
//     adds them, less the padding's zero terms.
//
// fp64 is native on Hopper: accumulation is in the value type, with no
// float-float arithmetic and no FMA caveat. Element offsets are 64-bit:
// Tp*K*1024 passes 2^31 at about 16M rows.

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
constexpr int kSlice = 32;                        // rows per compact slice
constexpr int kCompactThreads = 512;              // 16 slices per block
constexpr int kSlicesPerBlock = kCompactThreads / kSlice;

template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
wjd_roll_kernel(const V* __restrict__ data, const int32_t* __restrict__ brow,
                const int32_t* __restrict__ diag_u, const T* __restrict__ xp,
                T* __restrict__ y, int K) {
  const int64_t t = blockIdx.x / kBlocksPerTile;
  const int r = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int s = r >> 7;          // sublane of the row within its tile
  const int l = r & 127;         // lane of the row
  const int64_t slot0 = t * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t slot = slot0 + k;
    const int64_t e = slot * kTile + r;
    const int u = __ldg(diag_u + slot);
    const int64_t xi =
        (static_cast<int64_t>(__ldg(brow + slot)) + s) * 128 + l + u;
    acc += widen(__ldg(data + e)) * __ldg(xp + xi);
  }
  y[t * kTile + r] = acc;
}

template <typename V, typename T>
int launch_roll(const void* data, const void* brow, const void* diag_u,
                const void* xp, void* y, int64_t tp, int k, void* stream) {
  if (tp <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = tp * kBlocksPerTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wjd_roll_kernel<V, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(data), static_cast<const int32_t*>(brow),
      static_cast<const int32_t*>(diag_u), static_cast<const T*>(xp),
      static_cast<T*>(y), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T, typename O>
__global__ void __launch_bounds__(kCompactThreads)
wjd_compact_kernel(const V* __restrict__ cval, const O* __restrict__ coff,
                   const int64_t* __restrict__ slice_ptr,
                   const int64_t* __restrict__ xbase,
                   const T* __restrict__ xp, T* __restrict__ y,
                   int64_t nslices) {
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock + threadIdx.x / kSlice;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % kSlice;
  const int64_t end = __ldg(slice_ptr + slice + 1);
  const T* __restrict__ xs = xp + __ldg(xbase + slice);
  T acc = T(0);
#pragma unroll 8
  for (int64_t p = __ldg(slice_ptr + slice) + lane; p < end; p += kSlice)
    acc += widen(__ldcs(cval + p)) * __ldg(xs + __ldcs(coff + p));
  y[slice * kSlice + lane] = acc;
}

template <typename V, typename T, typename O>
int launch_compact(const void* cval, const void* coff, const void* slice_ptr,
                   const void* xbase, const void* xp, void* y,
                   int64_t nslices, void* stream) {
  const int64_t blocks = (nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  if (nslices <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_compact_kernel<V, T, O><<<static_cast<unsigned>(blocks),
                                kCompactThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(cval), static_cast<const O*>(coff),
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int64_t*>(xbase), static_cast<const T*>(xp),
      static_cast<T*>(y), nslices);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename T>
int launch_gather(const void* cval, const void* coff, int coff_bytes,
                  const void* slice_ptr, const void* xbase, const void* xp,
                  void* y, int64_t nslices, void* stream) {
  if (coff_bytes == 2)
    return launch_compact<V, T, uint16_t>(cval, coff, slice_ptr, xbase, xp,
                                          y, nslices, stream);
  if (coff_bytes == 4)
    return launch_compact<V, T, int32_t>(cval, coff, slice_ptr, xbase, xp,
                                         y, nslices, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. The gather entry points take the compact
// slice form: values, offsets of coff_bytes (2 or 4) each, slice_ptr
// (nslices + 1, int64), xbase (nslices, int64); y has nslices*32 rows.
// The bf16 entry point takes bfloat16 values and an f32 x and y.
extern "C" {

int wjd_spmv_roll_f64(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k,
                      void* stream) {
  return launch_roll<double, double>(data, brow, diag_u, xp, y, tp, k,
                                     stream);
}

int wjd_spmv_roll_f32(const void* data, const void* brow, const void* diag_u,
                      const void* xp, void* y, int64_t tp, int k,
                      void* stream) {
  return launch_roll<float, float>(data, brow, diag_u, xp, y, tp, k, stream);
}

int wjd_spmv_gather_f64(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices,
                        void* stream) {
  return launch_gather<double, double>(cval, coff, coff_bytes, slice_ptr,
                                       xbase, xp, y, nslices, stream);
}

int wjd_spmv_gather_f32(const void* cval, const void* coff, int coff_bytes,
                        const void* slice_ptr, const void* xbase,
                        const void* xp, void* y, int64_t nslices,
                        void* stream) {
  return launch_gather<float, float>(cval, coff, coff_bytes, slice_ptr,
                                     xbase, xp, y, nslices, stream);
}

int wjd_spmv_gather_bf16(const void* cval, const void* coff, int coff_bytes,
                         const void* slice_ptr, const void* xbase,
                         const void* xp, void* y, int64_t nslices,
                         void* stream) {
  return launch_gather<__nv_bfloat16, float>(cval, coff, coff_bytes,
                                             slice_ptr, xbase, xp, y,
                                             nslices, stream);
}

}  // extern "C"
