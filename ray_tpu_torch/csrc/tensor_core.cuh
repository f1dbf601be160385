// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), as inline PTX for sm_90a:
//
// - mma.sync m16n8k16, bf16 operands, float32 accumulators;
// - ldmatrix x4 (plain and .trans) to load operand fragments from shared
//   memory;
// - cp.async (16 B, cache-global; 4 B for one float) with commit/wait
//   groups, zero-filling rows past the sequence (src-size 0);
// - the shared-memory layout of a tile of kW-element bf16 rows (kW = 64,
//   128 B, or 128, 256 B: the head dim): chunk c (16 B) of row r lives at
//   chunk c ^ (r & 7), so the eight rows an ldmatrix phase reads, and the
//   eight chunks of a row that cp.async writes, fall on eight different
//   bank groups.  A 256-byte row spans the 32 banks twice; the XOR of the
//   low three chunk bits spreads each 128-byte half the same way.
//
// Fragment layouts (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16 (row):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 2t+8..)
//                   a3 (g+8, 2t+8..)
//   B 16x8  (col):  b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   C 16x8  (f32):  c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent n8 tiles, packed to bf16 pairs, are
// exactly the A fragment of one k16 step (pack_a below): a probability
// tile goes from one product's accumulators into the next product's A
// operand without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace rtt {

using bf16 = __nv_bfloat16;

// Elements in a tile row (the head dim) unless a caller names another
// width kW; every helper below takes kW as its last template parameter.
constexpr int kRow = 64;

// Element offset of chunk `chunk` (8 elements) of row `row` in a tile.
template <int kW = kRow>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(kW % 64 == 0, "whole 128-byte halves a row");
  return row * kW + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared without passing through registers; 16 zero bytes
// when !valid (the source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// One float global -> shared; 0 when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b, one m16n8k16 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even, as .astype does);
// `lo` in the low half, the lower column of a fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one k16 step from the C fragments of n8 tiles 2j and
// 2j + 1, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix addresses into a swizzled tile `s` (lane = this thread's lane).
//
// ld_rows: rows r0..r0+15, chunks c0, c0+1.  Plain, it is the A fragment
// of a row-major 16x16 block (rows = M, columns = K).  With .trans on a
// tile stored [K][N], it is the B fragments of the n8 tiles at chunk c0
// (r[0], r[1]) and c0 + 1 (r[2], r[3]).
template <int kW = kRow>
__device__ __forceinline__ uint32_t ld_rows(const bf16* s, int r0, int c0,
                                            int lane) {
  return smem_u32(s + swz<kW>(r0 + (lane & 15), c0 + (lane >> 4)));
}

// ld_nk: on a tile stored [N][K] (rows = N), the B fragments of the n8
// tiles at rows n0 (r[0], r[1]) and n0 + 8 (r[2], r[3]), for the k16 step
// at chunks c0, c0 + 1.
template <int kW = kRow>
__device__ __forceinline__ uint32_t ld_nk(const bf16* s, int n0, int c0,
                                          int lane) {
  return smem_u32(s + swz<kW>(n0 + (lane & 7) + ((lane >> 4) << 3),
                              c0 + ((lane >> 3) & 1)));
}

// cp.async moves 16 B: every row of a (B, T, H, D) operand starts
// 16-byte aligned when its base is and its element strides for B, T and H
// are multiples of 8.
__host__ __device__ inline bool rows_aligned(const void* p, long long sb,
                                             long long st, long long sh) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && sb % 8 == 0 &&
         st % 8 == 0 && sh % 8 == 0;
}

// Copy rows [row0, row0 + kRows) of a (T, kW) bf16 operand with row
// stride `ld` (elements) into the swizzled tile `s`, 16 B per thread per
// step; rows at or past T are zero-filled.  Every thread of the block
// calls it.
template <int kRows, int kThreads, int kW = kRow>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int row0, int T, int tid) {
  constexpr int kShift = kW == 64 ? 3 : 4;  // log2 of 16-byte chunks a row
  static_assert(kW == 64 || kW == 128, "rows of 64 or 128 elements");
  static_assert((kRows << kShift) % kThreads == 0,
                "whole steps of 16 B a thread");
#pragma unroll
  for (int i = 0; i < (kRows << kShift) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> kShift, ch = c & ((1 << kShift) - 1);
    const int pos = row0 + r;
    const bool ok = pos < T;
    cp_async16(s + swz<kW>(r, ch),
               g + (long long)(ok ? pos : 0) * ld + ch * 8, ok);
  }
}

// 2^x on the SFU, one MUFU.EX2: results below 2^-126 flush to 0 (exp2f
// spends three more instructions a call on them).  A probability that
// small is a zero to every sum it enters: l >= 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_add(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

}  // namespace rtt
