// WJD gather SpMV and SpMM on bfloat16 values for NVIDIA Hopper (sm_90a),
// over the packed form of the compact slice layout.
//
// Three kernels replace three Pallas kernels of the JAX package, run on
// bfloat16 values with f32 x, sums and y (the JAX kernels' acc_dt), each
// with an entry point for each of the two packed forms:
//
//   wjd_spmv_gather_bf16_packed[24]      spmv_wjd.py:_kernel (:137)
//   wjd_spmm_gather_bf16_packed[24]      spmv_wjd.py:_kernel_mrhs (:448)
//   wjd_spmv_win_gather_bf16_packed[24]  spmv_wjd.py:_kernel_hbm (:310)
//
// (spmv_wjd.py: rocalution_tpu/ops/pallas/spmv_wjd.py)
//
// They serve a bfloat16 gather-mode plan whose offsets lie below 2^24,
// direct or window-relative: the offset width alone chooses the form when
// the plan is uploaded (formats/wjd.py:_plan_to_wjd): 16-bit offsets the
// packed form, wider ones below 2^24 the packed24 form (the packed words
// and a high byte a word, below). A bfloat16 plan whose offsets pass 24
// bits keeps the compact form and the bf16 instantiations of
// csrc/spmv_wjd.cu, csrc/spmm_wjd.cu and csrc/spmv_wjd_win.cu. A
// window-relative plan's xbase holds its step windows, win_base[step]*128
// repeated, so the direct SpMV and the SpMM read it unchanged; the windowed
// SpMV reads win_base itself, as the TPU kernel does.
//
// Semantics: those of the compact kernels (csrc/spmv_wjd.cu): element (j,
// lane) of slice i multiplies xp[xbase[i] + offset] and adds to row
// i*32 + lane, ranks in ascending order, which is the slot product's order
// less its zero padding; in the windowed SpMV the base of slice i is
// win_base[i / slices_per_step]*128, the window of its grid step. The COO
// spill and the DIA part are the Python wrapper's
// (rocalution_tpu_torch/ops/cuda/spmv_wjd.py).
//
// The packed form (formats/wjd.py:pack_bf16_slices): one 32-bit word a
// stored element, the value's bfloat16 bits in its low half and its offset
// in its high half; word (j, lane) of slice i at
// slice_ptr[i] + (j / 4)*128 + lane*4 + j % 4, a slice's width padded to a
// multiple of 4 with zero words (value 0, offset 0). So one 16-byte load
// brings a lane 4 ranks of its row, a warp load is 512 contiguous bytes, and
// a word widens to its f32 value with one shift (bfloat16 is the high half
// of an f32) and to its offset with another.
//
// Why a form of its own. The compact bf16 kernels are the f32/f64 templates
// instantiated with V = __nv_bfloat16: per stored element a lane issues a
// 2-byte load of the value, a 2-byte load of the offset (each warp load half
// a line) and the gather of x. With 2-byte values the stream is a third
// smaller than f32's, yet on the H100 at 1M rows (random_banded_spd(1<<20),
// band +-8192, 21.9M stored elements, 1.40 a nonzero) the bf16 SpMV took
// 63.1 us against 66.2 us for f32, and the bf16 SpMM (16 columns) 423.1 us
// against 374.6 us for f32: load instructions a stored element, not bytes,
// set their pace.
//
// Bound: bytes, two flops a stored element and column. The packed form
// streams 4 bytes a stored element (the compact form's value and offset in
// one word), x and y; the packed24 form 5.
//
// The packed24 form (formats/wjd.py: pack_bf16_slices with `chi`): the
// same words, each holding its offset's low 16 bits, and a plane chi of one
// byte a word at the word's own index (padding words 0) holding bits
// 16-23. It serves a bf16 plan whose offsets pass 16 bits: a direct slice
// that spans 65,536 elements of x or more (a direct plan's x is at most
// X_VMEM_BUDGET bytes of f32, ~3.1M elements, under 2^24), or a window of
// more than 512 rows. Before it, such a plan took the compact kernels'
// bf16 instantiations, 6 bytes a stored element and three loads a lane per
// element (a 2-byte value, a 4-byte offset, the gather of x; a warp's
// value or offset load covering part of a line): the direct one ran at
// 0.62 of its own bytes, 68.0 us at 1M rows where its f32 twin, on the same
// 6 bytes, took 66.7, so load instructions set its pace; the windowed one
// at 0.80, 209.9 us at 4.2M rows, so bytes set its pace. The packed24
// kernels are the packed ones under a template switch: per 4 ranks a lane
// issues one streaming 16-byte load of words and one streaming 4-byte load
// of their 4 high bytes (a warp reads 512 and 128 contiguous bytes), 2
// load instructions for 4 elements where the compact kernel issues 8, and
// 5 bytes a stored element where it streams 6. A lane splits its 4 high
// bytes into two words with a zero byte each (2 byte permutes), then joins
// each word's offset, (w >> 16) | (byte << 16), with one byte permute a
// rank; the 4 gathers of x are issued before the 4 products are added in
// rank order with fmaf, as on the packed form. The SpMM loads the same 4
// high bytes beside its 4 words and broadcasts them once per 4 ranks, one
// shuffle beside the 4 of the words.
//
// SpMV (wjd_packed_kernel direct, wjd_packed_win_kernel windowed; both
// sum a row with packed_row):
//   * one warp owns one slice and one thread one row, as in the compact
//     kernel; a lane's loop takes 4 ranks a step from one streaming 16-byte
//     load (ld.global.cs.v4) and issues their 4 gathers of x (read-only
//     path) before it adds the 4 products, in rank order, with fmaf, so a
//     row's sum is the same in both kernels;
//   * the loop is unrolled by 2, so 8 gathers a lane are in flight;
//   * direct: blocks of 1024 threads, the 32 slices of one tile, whose
//     gathers of x share lines in the SM's L1;
//   * windowed: blocks of 1024 threads, one grid step each (as
//     wjd_compact_win_kernel of csrc/spmv_wjd_win.cu), whose 32 warps walk
//     the step's slices, so that every gather of a step reads its window
//     (216 rows, 110,592 bytes, at 4.2M rows) through one SM's L1.
//
// SpMM (wjd_packed_spmm_kernel, X and Y row-major (rows, KC), KC 4, 8, 16):
//   * one warp owns one slice; a lane loads 4 ranks of its row with one
//     16-byte load, the next 4 before this group's gathers of X are issued;
//   * per rank, the row's word is broadcast with one __shfl_sync (the compact
//     kernel needs two: the value and the offset);
//   * X is gathered 16 bytes a lane: KC/4 lanes cover a row's KC columns, so
//     a pass serves 128/KC rows and a rank takes KC/4 passes, each lane
//     keeping 4 columns of KC/4 rows (KC accumulators); Y is written 16
//     bytes a lane;
//   * each column is summed in rank order with fmaf, as the SpMV kernel sums
//     it, so a column of a blocked product is the single product bit for bit
//     whatever KC is;
//   * blocks of 128 threads (4 slices).
//
// What was tried (one H100 80GB HBM3 at 700 W, random_banded_spd(1<<20) f32
// with its values rounded to bf16, 23.5M words, 1.50 a nonzero; us a launch
// by scripts/bf16_packed_variants.py, the mean of 20 back-to-back launches,
// the median of 8 rounds; the script keeps the two designs not shipped):
//   * SpMV. The compact bf16 kernel 59.6 (the f32 plan's 63.0); packed,
//     42.6. Smaller blocks (128 to 512 threads) and unrolls by 1 or 4 were
//     slower and are not kept. Then x from shared memory: a ring of 32768
//     floats a persistent block of 1024 threads, filled ahead with
//     cp.async.bulk (TMA, 1-D) and two mbarriers, 40.8. The ring bought 4 %:
//     not kept, for its 128 KB of shared memory, the per-wave windows it
//     needs from the plan and a second path for operators whose windows pass
//     it. Staging each block's x span by one bulk copy bought nothing. The
//     packed stream (30.7 us of bytes), not the gathers, sets the pace.
//   * SpMM, KC = 16. The compact bf16 kernel 420.2, slower than its f32
//     twin's 370.8 on fewer bytes. Its SASS (cuobjdump) says why: the bf16
//     instantiation widens the prefetched next value (IMAD.U32 by 0x10000)
//     right after its load is issued, before this rank's shuffles and
//     gathers, so every rank waits for the stream's full latency and the
//     prefetch buys nothing; the f32 instantiation only moves the loaded
//     register at the loop's end, and the two count alike instructions.
//     Packed, widened after the shuffle, one shuffle a row, X still
//     gathered 4 bytes a lane (one lane a column): 239.9; X gathered 16
//     bytes a lane: 172.9.
//   * Windowed SpMV (scripts/bf16_win_variants.py, the same card and
//     limit, random_banded_spd(1<<22) f32 rounded to bf16, 512 steps of 8
//     tiles, 94.1M words, 1.496 a nonzero; the median of 8 rounds). The
//     compact bf16 windowed kernel on 2-byte offsets 188.1 (the f32 plan's
//     210.5); packed, a block a tile (the direct kernel's shape, the base
//     read per step) 157.8; packed, a block a grid step 144.1, shipped; 2
//     ranks a lane from one 8-byte load, widths padded to 2 ranks (1.433
//     words a nonzero), a block a tile, 158.6: its 4 % fewer bytes did
//     not pay for twice the load instructions. The blocked product of the
//     same plan (k = 16) through xbase: packed 622.9, the compact bf16
//     SpMM on 2-byte offsets 1460.8, the f32 plan's 1336.5.
//   * The packed24 form (scripts/bf16_wide_variants.py, the same card and
//     limit; the plans above with their offsets moved past 16 bits: a
//     direct slice's base lowered by 65,536 elements, a window widened by
//     up to 512 rows; the median of 8 rounds). Direct SpMV: the packed
//     kernel on the plan before 43.0, packed24 49.6, a high half a word (6
//     bytes an element, every int32 offset) 55.8, the compact bf16 kernel
//     on int32 offsets 65.2. Windowed: 143.8, 176.5, 206.5 and 210.3, each
//     in step with its bytes (0.85 of the HBM rate on its own for
//     packed24). SpMM, k = 16: 176.9, 181.5 and 242.4 (compact); on the
//     windowed plan 624.5, 652.1 and 872.9. On natural wide plans
//     (random_banded_spd(n, bandwidth=32768), whose own plans take packed24
//     and whose gathers spread past an SM's L1): direct 78.5, 81.4 and
//     108.2; windowed 369.2, 383.8 and 359.8: there the gathers set the
//     pace, not the stream, and the compact kernel comes out 2.6 % ahead
//     (not yet explained); SpMM 175.4 against 265.2, windowed 640.3
//     against 910.3. Held to 32 registers so that two blocks fit an SM: the same
//     times, since the shipped SpMVs already take 32. The high byte is
//     shipped; the high half stays under -DWJD_VARIANTS.
//
// Element offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;                 // rows per slice / warp
constexpr int kPack = 4;                   // ranks per 16-byte load
constexpr int kThreads = 1024;             // SpMV: 32 slices per block
constexpr int kSlicesPerBlock = kThreads / kSlice;
constexpr int kSpmmThreads = 128;          // SpMM: 4 slices per block
constexpr int kSpmmSlicesPerBlock = kSpmmThreads / kSlice;

// a packed word's value, widened to f32 (exact), and its offset
__device__ __forceinline__ float value_of(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ uint32_t offset_of(uint32_t w) { return w >> 16; }

// The high bytes of 4 words, a 4-byte word (byte k: word k's bits 16-23),
// split into two words with zero high halves: [h0, h1, 0, 0], [h2, h3, 0, 0]
__device__ __forceinline__ uint2 split_hi(uint32_t h) {
  return make_uint2(__byte_perm(h, 0u, 0x4410), __byte_perm(h, 0u, 0x4432));
}

// the offset of rank K (0..3) of a group: word w's high half, and byte K % 2
// of the split high bytes hs as its bits 16-23: bytes w.2, w.3, hs.(K % 2),
// then a zero byte of hs
template <int K>
__device__ __forceinline__ uint32_t join_offset(uint32_t w, uint2 hs) {
  return __byte_perm(w, K < 2 ? hs.x : hs.y, K % 2 ? 0x6532 : 0x6432);
}

#ifdef WJD_VARIANTS
// a variant kept for measurement (below): the offsets of 4 ranks whose
// high halves come from a uint16 plane, one 8-byte load of 4 halves (6
// bytes an element)
__device__ __forceinline__ uint4 hi16_offsets(uint4 w, const void* hi,
                                              int64_t g) {
  const uint2 h = __ldcs(static_cast<const uint2*>(hi) + g);
  return make_uint4(__byte_perm(w.x, h.x, 0x5432),
                    __byte_perm(w.y, h.x, 0x7632),
                    __byte_perm(w.z, h.y, 0x5432),
                    __byte_perm(w.w, h.y, 0x7632));
}
#endif

// the offsets of a lane's 4 ranks in group g: 16-bit ones from the words
// alone (kHiBytes 0), or with the packed24 form's high bytes (1: one 4-byte
// load of 4 bytes)
template <int kHiBytes>
__device__ __forceinline__ uint4 group_offsets(uint4 w, const void* hi,
                                               int64_t g) {
  if constexpr (kHiBytes == 0) {
    return make_uint4(offset_of(w.x), offset_of(w.y), offset_of(w.z),
                      offset_of(w.w));
#ifdef WJD_VARIANTS
  } else if constexpr (kHiBytes == 2) {
    return hi16_offsets(w, hi, g);
#endif
  } else {
    static_assert(kHiBytes == 1, "a high byte a word, or none");
    const uint2 hs =
        split_hi(__ldcs(static_cast<const unsigned int*>(hi) + g));
    return make_uint4(join_offset<0>(w.x, hs), join_offset<1>(w.y, hs),
                      join_offset<2>(w.z, hs), join_offset<3>(w.w, hs));
  }
}

// one row of a slice: lane `lane` of the words [begin, end) (in groups of
// 4 ranks, 32 uint4 a group), their high bytes in hi (kHiBytes a word), x
// from xs
template <int kHiBytes>
__device__ __forceinline__ float packed_row(const uint4* __restrict__ cpack,
                                            const void* __restrict__ hi,
                                            int64_t begin, int64_t end,
                                            const float* __restrict__ xs,
                                            int lane) {
  float acc = 0.f;
#pragma unroll 2
  for (int64_t g = begin + lane; g < end; g += kSlice) {
    const uint4 w = __ldcs(cpack + g);
    const uint4 o = group_offsets<kHiBytes>(w, hi, g);
    const float x0 = __ldg(xs + o.x);
    const float x1 = __ldg(xs + o.y);
    const float x2 = __ldg(xs + o.z);
    const float x3 = __ldg(xs + o.w);
    acc = fmaf(value_of(w.x), x0, acc);
    acc = fmaf(value_of(w.y), x1, acc);
    acc = fmaf(value_of(w.z), x2, acc);
    acc = fmaf(value_of(w.w), x3, acc);
  }
  return acc;
}

// slice_ptr counts words; a group of 4 ranks of a slice is 32 uint4
template <int kHiBytes>
__device__ __forceinline__ float slice_row(const uint4* __restrict__ cpack,
                                           const void* __restrict__ hi,
                                           const int64_t* __restrict__ ptr,
                                           int64_t slice,
                                           const float* __restrict__ xs,
                                           int lane) {
  return packed_row<kHiBytes>(cpack, hi, __ldg(ptr + slice) / kPack,
                              __ldg(ptr + slice + 1) / kPack, xs, lane);
}

template <int kHiBytes>
__global__ void __launch_bounds__(kThreads)
wjd_packed_kernel(const uint4* __restrict__ cpack,
                  const void* __restrict__ hi,
                  const int64_t* __restrict__ slice_ptr,
                  const int64_t* __restrict__ xbase,
                  const float* __restrict__ xp, float* __restrict__ y,
                  int64_t nslices) {
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock +
                        threadIdx.x / kSlice;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % kSlice;
  y[slice * kSlice + lane] = slice_row<kHiBytes>(
      cpack, hi, slice_ptr, slice, xp + __ldg(xbase + slice), lane);
}

// one block a grid step: x from the step's window, win_base[step]*128
template <int kHiBytes>
__global__ void __launch_bounds__(kThreads)
wjd_packed_win_kernel(const uint4* __restrict__ cpack,
                      const void* __restrict__ hi,
                      const int64_t* __restrict__ slice_ptr,
                      const int32_t* __restrict__ win_base,
                      const float* __restrict__ xp, float* __restrict__ y,
                      int slices_per_step) {
  const int64_t step = blockIdx.x;
  const float* __restrict__ xs =
      xp + static_cast<int64_t>(__ldg(win_base + step)) * 128;
  const int lane = threadIdx.x % kSlice;
  for (int i = threadIdx.x / kSlice; i < slices_per_step;
       i += kSlicesPerBlock) {
    const int64_t slice = step * slices_per_step + i;
    y[slice * kSlice + lane] =
        slice_row<kHiBytes>(cpack, hi, slice_ptr, slice, xs, lane);
  }
}

// one rank (K of its group) of the slice: the word of row
// i*kRowsPerPass + h, from the lane that owns the row, times 4 columns of X
// of that row; with a high byte a word (kHiBytes 1), that lane's split high
// bytes hs[i]
template <int KC, int kHiBytes, int K>
__device__ __forceinline__ void spmm_rank(uint32_t word, int h,
                                          const uint2 (&hs)[KC / 4],
                                          const float4* __restrict__ xs,
                                          float4 (&acc)[KC / 4]) {
  constexpr int kLanesPerRow = KC / 4;
  constexpr int kRowsPerPass = kSlice / kLanesPerRow;
#pragma unroll
  for (int i = 0; i < kLanesPerRow; ++i) {
    const uint32_t wi = __shfl_sync(0xffffffffu, word, i * kRowsPerPass + h);
    const float v = value_of(wi);
    const uint32_t off =
        kHiBytes ? join_offset<K>(wi, hs[i]) : offset_of(wi);
    const float4 xv = __ldg(xs + off * kLanesPerRow);
    acc[i].x = fmaf(v, xv.x, acc[i].x);
    acc[i].y = fmaf(v, xv.y, acc[i].y);
    acc[i].z = fmaf(v, xv.z, acc[i].z);
    acc[i].w = fmaf(v, xv.w, acc[i].w);
  }
}

template <int KC, int kHiBytes>
__global__ void __launch_bounds__(kSpmmThreads)
wjd_packed_spmm_kernel(const uint4* __restrict__ cpack,
                       const unsigned int* __restrict__ chi,
                       const int64_t* __restrict__ slice_ptr,
                       const int64_t* __restrict__ xbase,
                       const float* __restrict__ xp, float* __restrict__ y,
                       int64_t nslices) {
  static_assert(kHiBytes == 0 || kHiBytes == 1, "a high byte a word");
  constexpr bool kHi = kHiBytes == 1;
  constexpr int kLanesPerRow = KC / 4;     // lanes across a row's columns
  constexpr int kRowsPerPass = kSlice / kLanesPerRow;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kSpmmSlicesPerBlock +
      threadIdx.x / kSlice;
  if (slice >= nslices) return;            // uniform over the warp
  const int lane = threadIdx.x % kSlice;
  const int h = lane / kLanesPerRow;       // which row of a pass
  const int c = lane % kLanesPerRow;       // which 4 columns
  const float4* __restrict__ xs =
      reinterpret_cast<const float4*>(xp + __ldg(xbase + slice) * KC) + c;
  float4 acc[kLanesPerRow];
#pragma unroll
  for (int i = 0; i < kLanesPerRow; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the next 4 ranks (and their high bytes) are loaded before this group's
  // gathers of X are issued
  const int64_t end = __ldg(slice_ptr + slice + 1) / kPack;
  int64_t g = __ldg(slice_ptr + slice) / kPack + lane;
  uint4 w_next = g < end ? __ldcs(cpack + g) : make_uint4(0u, 0u, 0u, 0u);
  unsigned int h_next = kHi && g < end ? __ldcs(chi + g) : 0u;
  for (; g < end; g += kSlice) {
    const uint4 w = w_next;
    const unsigned int hb = h_next;
    if (g + kSlice < end) {
      w_next = __ldcs(cpack + g + kSlice);
      if (kHi) h_next = __ldcs(chi + g + kSlice);
    }
    // the high bytes of each source lane, broadcast once per 4 ranks
    uint2 hs[kLanesPerRow];
#pragma unroll
    for (int i = 0; i < kLanesPerRow; ++i)
      hs[i] = kHi ? split_hi(__shfl_sync(0xffffffffu, hb,
                                         i * kRowsPerPass + h))
                  : make_uint2(0u, 0u);
    spmm_rank<KC, kHiBytes, 0>(w.x, h, hs, xs, acc);
    spmm_rank<KC, kHiBytes, 1>(w.y, h, hs, xs, acc);
    spmm_rank<KC, kHiBytes, 2>(w.z, h, hs, xs, acc);
    spmm_rank<KC, kHiBytes, 3>(w.w, h, hs, xs, acc);
  }

  float4* __restrict__ ys =
      reinterpret_cast<float4*>(y + slice * kSlice * KC) + c;
#pragma unroll
  for (int i = 0; i < kLanesPerRow; ++i)
    ys[(i * kRowsPerPass + h) * kLanesPerRow] = acc[i];
}

struct PackedArgs {
  const void *cpack, *chi, *slice_ptr, *xbase, *xp;
  void* y;
  int64_t nslices;
  void* stream;
};

template <int KC, int kHiBytes>
int go_spmm(const PackedArgs& a) {
  const int64_t blocks =
      (a.nslices + kSpmmSlicesPerBlock - 1) / kSpmmSlicesPerBlock;
  wjd_packed_spmm_kernel<KC, kHiBytes>
      <<<static_cast<unsigned>(blocks), kSpmmThreads, 0,
         static_cast<cudaStream_t>(a.stream)>>>(
          static_cast<const uint4*>(a.cpack),
          static_cast<const unsigned int*>(a.chi),
          static_cast<const int64_t*>(a.slice_ptr),
          static_cast<const int64_t*>(a.xbase),
          static_cast<const float*>(a.xp), static_cast<float*>(a.y),
          a.nslices);
  return static_cast<int>(cudaGetLastError());
}

template <int kHiBytes>
int spmm(const PackedArgs& a, int kc) {
  if (a.nslices <= 0 ||
      (a.nslices + kSpmmSlicesPerBlock - 1) / kSpmmSlicesPerBlock >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kc) {
    case 4: return go_spmm<4, kHiBytes>(a);
    case 8: return go_spmm<8, kHiBytes>(a);
    case 16: return go_spmm<16, kHiBytes>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kHiBytes>
int spmv(const void* cpack, const void* hi, const void* slice_ptr,
         const void* xbase, const void* xp, void* y, int64_t nslices,
         void* stream) {
  const int64_t blocks = (nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  if (nslices <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_packed_kernel<kHiBytes><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(cpack), hi,
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int64_t*>(xbase), static_cast<const float*>(xp),
      static_cast<float*>(y), nslices);
  return static_cast<int>(cudaGetLastError());
}

template <int kHiBytes>
int spmv_win(const void* cpack, const void* hi, const void* slice_ptr,
             const void* win_base, const void* xp, void* y, int64_t nsteps,
             int slices_per_step, void* stream) {
  if (nsteps <= 0 || nsteps > 0x7fffffffLL || slices_per_step <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wjd_packed_win_kernel<kHiBytes><<<static_cast<unsigned>(nsteps), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(cpack), hi,
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(win_base), static_cast<const float*>(xp),
      static_cast<float*>(y), slices_per_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. cpack is the packed form's words (16-byte
// aligned), slice_ptr (nslices + 1 int64, in words) and xbase (nslices
// int64); xp and y are f32: (xp_len,) and (nslices*32,) for the SpMV,
// row-major (xp_len, kc) and (nslices*32, kc) for the SpMM, kc 4, 8 or 16.
// The packed24 entry points take chi after cpack: one uint8 a word, 4-byte
// aligned.
extern "C" {

int wjd_spmv_gather_bf16_packed(const void* cpack, const void* slice_ptr,
                                const void* xbase, const void* xp, void* y,
                                int64_t nslices, void* stream) {
  return spmv<0>(cpack, nullptr, slice_ptr, xbase, xp, y, nslices, stream);
}

int wjd_spmv_gather_bf16_packed24(const void* cpack, const void* chi,
                                  const void* slice_ptr, const void* xbase,
                                  const void* xp, void* y, int64_t nslices,
                                  void* stream) {
  return spmv<1>(cpack, chi, slice_ptr, xbase, xp, y, nslices, stream);
}

// the windowed SpMV of a window-relative packed form: win_base (nsteps
// int32), slice_ptr (nsteps*slices_per_step + 1 int64, in words)
int wjd_spmv_win_gather_bf16_packed(const void* cpack, const void* slice_ptr,
                                    const void* win_base, const void* xp,
                                    void* y, int64_t nsteps,
                                    int slices_per_step, void* stream) {
  return spmv_win<0>(cpack, nullptr, slice_ptr, win_base, xp, y, nsteps,
                     slices_per_step, stream);
}

int wjd_spmv_win_gather_bf16_packed24(const void* cpack, const void* chi,
                                      const void* slice_ptr,
                                      const void* win_base, const void* xp,
                                      void* y, int64_t nsteps,
                                      int slices_per_step, void* stream) {
  return spmv_win<1>(cpack, chi, slice_ptr, win_base, xp, y, nsteps,
                     slices_per_step, stream);
}

int wjd_spmm_gather_bf16_packed(const void* cpack, const void* slice_ptr,
                                const void* xbase, const void* xp, void* y,
                                int64_t nslices, int kc, void* stream) {
  return spmm<0>({cpack, nullptr, slice_ptr, xbase, xp, y, nslices, stream},
                 kc);
}

int wjd_spmm_gather_bf16_packed24(const void* cpack, const void* chi,
                                  const void* slice_ptr, const void* xbase,
                                  const void* xp, void* y, int64_t nslices,
                                  int kc, void* stream) {
  return spmm<1>({cpack, chi, slice_ptr, xbase, xp, y, nslices, stream}, kc);
}

}  // extern "C"

#ifdef WJD_VARIANTS
// Designs tried and not shipped, compiled only with -DWJD_VARIANTS by the
// scripts that time them beside the shipped kernels:
//   * scripts/bf16_win_variants.py: the windowed SpMV in blocks of one
//     tile, as the direct kernel, its base read per grid step (157.8 us
//     against 144.1, header);
//   * scripts/bf16_wide_variants.py: the two SpMVs over a high half a word
//     in place of a high byte (hi a uint16 plane, 6 bytes a stored
//     element, every int32 offset covered); and the two SpMVs (16-bit
//     offsets or a high byte) held to 32 registers so that two blocks fit
//     an SM, as wjd_compact_win_kernel of csrc/spmv_wjd_win.cu is.
namespace {

template <int kHiBytes>
__global__ void __launch_bounds__(kThreads, 2)
wjd_packed_mb2_kernel(const uint4* __restrict__ cpack,
                      const void* __restrict__ hi,
                      const int64_t* __restrict__ slice_ptr,
                      const int64_t* __restrict__ xbase,
                      const float* __restrict__ xp, float* __restrict__ y,
                      int64_t nslices) {
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock +
                        threadIdx.x / kSlice;
  if (slice >= nslices) return;
  const int lane = threadIdx.x % kSlice;
  y[slice * kSlice + lane] = slice_row<kHiBytes>(
      cpack, hi, slice_ptr, slice, xp + __ldg(xbase + slice), lane);
}

template <int kHiBytes>
__global__ void __launch_bounds__(kThreads, 2)
wjd_packed_win_mb2_kernel(const uint4* __restrict__ cpack,
                          const void* __restrict__ hi,
                          const int64_t* __restrict__ slice_ptr,
                          const int32_t* __restrict__ win_base,
                          const float* __restrict__ xp,
                          float* __restrict__ y, int slices_per_step) {
  const int64_t step = blockIdx.x;
  const float* __restrict__ xs =
      xp + static_cast<int64_t>(__ldg(win_base + step)) * 128;
  const int lane = threadIdx.x % kSlice;
  for (int i = threadIdx.x / kSlice; i < slices_per_step;
       i += kSlicesPerBlock) {
    const int64_t slice = step * slices_per_step + i;
    y[slice * kSlice + lane] =
        slice_row<kHiBytes>(cpack, hi, slice_ptr, slice, xs, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
wjd_packed_win_tile_kernel(const uint4* __restrict__ cpack,
                           const int64_t* __restrict__ slice_ptr,
                           const int32_t* __restrict__ win_base,
                           const float* __restrict__ xp,
                           float* __restrict__ y, int64_t nslices,
                           int slices_per_step) {
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * kSlicesPerBlock +
                        threadIdx.x / kSlice;
  if (slice >= nslices) return;
  const float* __restrict__ xs =
      xp + static_cast<int64_t>(__ldg(win_base + slice / slices_per_step)) *
               128;
  y[slice * kSlice + threadIdx.x % kSlice] =
      slice_row<0>(cpack, nullptr, slice_ptr, slice, xs,
                   threadIdx.x % kSlice);
}

}  // namespace

extern "C" int wjd_spmv_win_gather_bf16_packed_tile(
    const void* cpack, const void* slice_ptr, const void* win_base,
    const void* xp, void* y, int64_t nsteps, int slices_per_step,
    void* stream) {
  const int64_t nslices = nsteps * slices_per_step;
  wjd_packed_win_tile_kernel<<<
      static_cast<unsigned>((nslices + kSlicesPerBlock - 1) /
                            kSlicesPerBlock),
      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(cpack),
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(win_base), static_cast<const float*>(xp),
      static_cast<float*>(y), nslices, slices_per_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wjd_spmv_gather_bf16_packed_hi16(
    const void* cpack, const void* hi, const void* slice_ptr,
    const void* xbase, const void* xp, void* y, int64_t nslices,
    void* stream) {
  return spmv<2>(cpack, hi, slice_ptr, xbase, xp, y, nslices, stream);
}

// the packed SpMVs, two blocks an SM: hi null for 16-bit offsets, else chi
extern "C" int wjd_spmv_gather_bf16_packed_mb2(
    const void* cpack, const void* hi, const void* slice_ptr,
    const void* xbase, const void* xp, void* y, int64_t nslices,
    void* stream) {
  const auto grid = static_cast<unsigned>((nslices + kSlicesPerBlock - 1) /
                                          kSlicesPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint4*>(cpack);
  const auto* ptr = static_cast<const int64_t*>(slice_ptr);
  const auto* xb = static_cast<const int64_t*>(xbase);
  const auto* x = static_cast<const float*>(xp);
  auto* out = static_cast<float*>(y);
  if (hi)
    wjd_packed_mb2_kernel<1><<<grid, kThreads, 0, s>>>(w, hi, ptr, xb, x,
                                                       out, nslices);
  else
    wjd_packed_mb2_kernel<0><<<grid, kThreads, 0, s>>>(w, hi, ptr, xb, x,
                                                       out, nslices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wjd_spmv_win_gather_bf16_packed_mb2(
    const void* cpack, const void* hi, const void* slice_ptr,
    const void* win_base, const void* xp, void* y, int64_t nsteps,
    int slices_per_step, void* stream) {
  const auto grid = static_cast<unsigned>(nsteps);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint4*>(cpack);
  const auto* ptr = static_cast<const int64_t*>(slice_ptr);
  const auto* wb = static_cast<const int32_t*>(win_base);
  const auto* x = static_cast<const float*>(xp);
  auto* out = static_cast<float*>(y);
  if (hi)
    wjd_packed_win_mb2_kernel<1><<<grid, kThreads, 0, s>>>(
        w, hi, ptr, wb, x, out, slices_per_step);
  else
    wjd_packed_win_mb2_kernel<0><<<grid, kThreads, 0, s>>>(
        w, hi, ptr, wb, x, out, slices_per_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wjd_spmv_win_gather_bf16_packed_hi16(
    const void* cpack, const void* hi, const void* slice_ptr,
    const void* win_base, const void* xp, void* y, int64_t nsteps,
    int slices_per_step, void* stream) {
  return spmv_win<2>(cpack, hi, slice_ptr, win_base, xp, y, nsteps,
                     slices_per_step, stream);
}
#endif  // WJD_VARIANTS
