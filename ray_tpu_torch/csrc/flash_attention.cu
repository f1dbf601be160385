// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py, `_flash_kernel` (reached
// through `_flash_forward_lse_flat`'s pl.pallas_call).  Same arithmetic:
// tiled online softmax with float32 running (m, l, acc); scores are
// multiplied by scale*log2(e) so probabilities are exp2(s - m); masked
// scores are float32's lowest finite value (NEG_INF), not -inf; p is
// rounded to the storage type before the p.v product (the reference's
// p.astype(v.dtype)); l sums the unrounded p and is clamped to 1e-30
// before the divide; the optional lse is base 2, m + log2(l), one float32
// per (batch*head, query).
//
// Two kernels, chosen by dtype:
//
// bf16 (every main path: the engine's prefill, the train step) runs on the
// tensor cores, flash_fwd_tc_kernel.  What bounds it on this card: at the
// training shape (32, 1024, 12, 64) causal the two products are 51.6 GFLOP
// (~52 us at 989 TFLOP/s) against 201 MB of q, k, v and o (~60 us at 3.35
// TB/s), so the data-sheet bound is bytes, with operations close behind.
// In practice the 128-row kernel's registers (Q 32, O 64, S 64 a thread)
// allow two blocks an SM, and every warp reads the whole K/V tile by
// ldmatrix (mma.sync's B operand is per warp): wgmma, which reads B once
// per warpgroup, is the way past both.  What the design does about it:
// - Grid (batch*head, query tiles), the query tiles of each head issued
//   longest first (in the causal triangle the last tile sees every key),
//   so the long tiles of every head start in the first wave.
// - A block is four warps and owns kBM query rows: 16 rows a warp at
//   kBM = 64, 32 (two m16 tiles) at kBM = 128.  The wrapper takes 128 when
//   that still gives the card at least two blocks per SM.
// - Q is loaded once and kept in registers as mma A fragments.  K and V
//   tiles of 64 keys go through a three-stage cp.async ring: the copies
//   of the next two tiles run under this tile's products.  Rows of 64
//   bf16 are XOR-swizzled in shared memory (tensor_core.cuh), so ldmatrix
//   and cp.async are free of bank conflicts.
// - S = Q K^T takes K by ldmatrix; the online softmax runs on the S
//   accumulators (row max and sum over the four lanes of a row; each p
//   is one FFMA and one MUFU.EX2); P is
//   rounded to bf16 pairs in registers, the reference's rounding point,
//   and those registers are the A operand of O += P V, with V by
//   ldmatrix .trans.  Nothing of S or P goes through shared memory.
// - Only the diagonal tiles and the ragged last tile pay for the mask;
//   tiles above the diagonal are never loaded, and a warp skips a tile
//   whose every key lies past its own rows.
// - q, k and v are read through their (batch, seq, head) strides with the
//   head dim contiguous, so the strided views of the qkv projection need
//   no copy.  cp.async moves 16 B, so each base pointer must be 16-byte
//   aligned and each stride a multiple of 8 elements (the wrapper checks,
//   and so does the entry point).
//
// float32 (not a main-path dtype: tests and callers that ask for it) runs
// the first, scalar kernel, flash_fwd_kernel<float>: four lanes share a
// query row, products are float32 FMAs on the CUDA cores, K/V tiles of 32
// keys are staged in shared memory.  It keeps its own launch counter in
// the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;     // NEG_INF = finfo(float32).min

struct Strides {
  long long b, t, h;
};

// ------------------------------------------------- float32: scalar kernel
constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile
constexpr int kLanesPerRow = 4;
constexpr int kThreads = kBQ * kLanesPerRow;   // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int T_len, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal,
                 float s_scale) {
  constexpr int kPer = D / kLanesPerRow;   // head-dim values per lane
  __shared__ float k_s[kBK][D];
  __shared__ float v_s[kBK][D];

  const int tid = threadIdx.x;
  const int r = tid / kLanesPerRow;        // query row within the tile
  const int part = tid % kLanesPerRow;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  const int qpos = q0 + r;
  const bool q_ok = qpos < T_len;

  float qv[kPer];
  float acc[kPer];
  {
    const T* qp = q + b * qs.b + (long long)qpos * qs.t + h * qs.h;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = q_ok ? to_f32(qp[part + kLanesPerRow * i]) : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int kv_end = causal ? min(T_len, q0 + kBQ) : T_len;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int kpos = k0 + j;
      const bool ok = kpos < T_len;
      k_s[j][d] = ok ? to_f32(kbase[(long long)kpos * ks.t + d]) : 0.f;
      v_s[j][d] = ok ? to_f32(vbase[(long long)kpos * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // The tile needs the mask if any key in it can be invisible to any
    // row of this block: it reaches past T, or (causal) past q0.
    const bool masked = (k0 + kBK > T_len) || (causal && k0 + kBK - 1 > q0);
    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part_dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        part_dot = fmaf(qv[i], k_s[j][part + kLanesPerRow * i], part_dot);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 1);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 2);
      float sj = part_dot * s_scale;
      if (masked) {
        const int kpos = k0 + j;
        if (kpos >= T_len || (causal && kpos > qpos)) sj = kNegInf;
      }
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(p, v_s[j][part + kLanesPerRow * i], acc[i]);
    }
    m = m_new;
  }

  if (!q_ok) return;
  l = fmaxf(l, 1e-30f);
  const float inv_l = 1.0f / l;
  T* op = o + b * os.b + (long long)qpos * os.t + h * os.h;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    op[part + kLanesPerRow * i] = from_f32<T>(acc[i] * inv_l);
  if (lse != nullptr && part == 0)
    lse[(long long)bh * T_len + qpos] = m + log2f(l);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int T_len, int H, Strides qs, Strides ks, Strides vs,
            Strides os, int causal, float s_scale, cudaStream_t stream) {
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, T_len, qs, ks, vs,
      os, causal, s_scale);
}

// --------------------------------------------------- bf16: tensor cores
using rtt::bf16;
constexpr int kTcThreads = 128;          // four warps
constexpr int kBN = 64;                  // keys per tile
constexpr int kTile = kBN * rtt::kRow;   // elements of one 64-row tile
constexpr int kStages = 3;               // K/V tiles in flight or in use

// One K/V tile for one warp: S = Q K^T, the online softmax on its
// accumulators, O += bf16(P) V.  Two instantiations: kMasked for the
// diagonal and ragged tiles, and one with no mask code at all (a mask test
// on a runtime flag is if-converted into every tile, a third of the
// loop's instructions).
template <int kMT, bool kMasked>
__device__ __forceinline__ void fwd_tile(
    const uint32_t (&qf)[kMT][4][4], float (&acc)[kMT][8][4],
    float (&m)[kMT][2], float (&l)[kMT][2], const bf16* k_s,
    const bf16* v_s, int k0, int wq0, int T_len, int causal, float s_scale,
    int lane) {
  // S = Q K^T: 16 * kMT rows x 64 keys a warp.
  float s[kMT][8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kf[4];
      rtt::ldsm_x4(kf, rtt::ld_nk(k_s, 16 * np, 2 * kk, lane));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        rtt::mma(s[mt][2 * np], qf[mt][kk], kf[0], kf[1]);
        rtt::mma(s[mt][2 * np + 1], qf[mt][kk], kf[2], kf[3]);
      }
    }

  // Online softmax on the accumulators; s becomes p.  The row max is
  // taken on the unscaled scores: scale * log2(e) > 0 and rounding are
  // monotonic, so max(s) * scale is the max of the scaled scores, and
  // each p = exp2(s * scale - m) is one FFMA and one MUFU.EX2.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kMasked) {    // lane = 4 g + t: row g, key 2 t
            const int row = wq0 + 16 * mt + (lane >> 2) + 8 * hr;
            const int key = k0 + 8 * nt + 2 * (lane & 3) + e;
            if (key >= T_len || (causal && key > row))
              s[mt][nt][2 * hr + e] = kNegInf;
          }
          mx = fmaxf(mx, s[mt][nt][2 * hr + e]);
        }
      mx = rtt::quad_max(mx);
      const float m_new =
          fmaxf(m[mt][hr], mx == kNegInf ? kNegInf : mx * s_scale);
      const float corr = rtt::exp2_ftz(m[mt][hr] - m_new);
      m[mt][hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              rtt::exp2_ftz(fmaf(s[mt][nt][2 * hr + e], s_scale, -m_new));
          s[mt][nt][2 * hr + e] = p;
          sum += p;
        }
      l[mt][hr] = l[mt][hr] * corr + sum;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][2 * hr] *= corr;
        acc[mt][nt][2 * hr + 1] *= corr;
      }
    }

  // O += bf16(P) V: P from registers, V by ldmatrix .trans.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {       // keys 16 kk .. 16 kk + 15
    uint32_t pa[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      rtt::pack_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {     // head dims 16 dp .. 16 dp + 15
      uint32_t vf[4];
      rtt::ldsm_x4_t(vf, rtt::ld_rows(v_s, 16 * kk, 2 * dp, lane));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        rtt::mma(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
        rtt::mma(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
      }
    }
  }
}

template <int kBM>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int T_len, Strides qs,
                    Strides ks, Strides vs, Strides os, int causal,
                    float s_scale) {
  constexpr int kMT = kBM / 64;            // m16 tiles per warp
  constexpr int kWarpRows = 16 * kMT;
  static_assert(kBM * rtt::kRow <= 2 * kTile, "Q is staged in one stage");
  // kStages ring stages of [K tile | V tile] (48 KB).  Q is staged in the
  // last stage and moved to registers before a K/V tile goes there.
  __shared__ __align__(128) bf16 smem[kStages * 2 * kTile];
  bf16* const q_stage = smem + (kStages - 1) * 2 * kTile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBM;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int kv_end = causal ? min(T_len, q0 + kBM) : T_len;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  // One commit group a tile (an empty one past the last tile), so that
  // "tile j has landed" is always "at most kStages - 2 groups in flight".
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      bf16* st = smem + (j % kStages) * 2 * kTile;
      rtt::load_tile<kBN, kTcThreads>(st, kb, ks.t, j * kBN, T_len, tid);
      rtt::load_tile<kBN, kTcThreads>(st + kTile, vb, vs.t, j * kBN, T_len,
                                      tid);
    }
    rtt::cp_async_commit();
  };

  rtt::load_tile<kBM, kTcThreads>(q_stage, qb, qs.t, q0, T_len, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);   // Q rides with tile 0
  rtt::cp_async_wait<kStages - 2>();
  __syncthreads();

  const int wr0 = warp * kWarpRows;        // the warp's first row in the block
  uint32_t qf[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rtt::ldsm_x4(qf[mt][kk],
                   rtt::ld_rows(q_stage, wr0 + 16 * mt, 2 * kk, lane));

  float acc[kMT][8][4];
  float m[kMT][2], l[kMT][2];   // per row g and g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;   // this lane's share; joined at the end
  }

  const int wq0 = q0 + wr0, wq1 = wq0 + kWarpRows - 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    rtt::cp_async_wait<kStages - 2>();
    // Tile j is visible to all; every warp is done with the stage that
    // tile j + kStages - 1 goes to (tile j - 1's, or Q's when j = 0).
    __syncthreads();
    load_kv(j + kStages - 1);
    if (causal && k0 > wq1) continue;      // every key lies past this warp
    const bf16* k_s = smem + (j % kStages) * 2 * kTile;
    const bf16* v_s = k_s + kTile;
    if ((k0 + kBN > T_len) || (causal && k0 + kBN - 1 > wq0))
      fwd_tile<kMT, true>(qf, acc, m, l, k_s, v_s, k0, wq0, T_len, causal,
                          s_scale, lane);
    else
      fwd_tile<kMT, false>(qf, acc, m, l, k_s, v_s, k0, wq0, T_len, causal,
                           s_scale, lane);
  }

  // O = acc / l, rounded once; lse = m + log2(l).
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wq0 + 16 * mt + g + 8 * hr;
      const float lsum = fmaxf(rtt::quad_add(l[mt][hr]), 1e-30f);
      if (row >= T_len) continue;
      bf16* op = o + b * os.b + (long long)row * os.t + h * os.h + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        rtt::store_bf16x2(op + 8 * nt, acc[mt][nt][2 * hr] / lsum,
                          acc[mt][nt][2 * hr + 1] / lsum);
      if (lse != nullptr && t == 0)
        lse[(long long)bh * T_len + row] = m[mt][hr] + log2f(lsum);
    }
}

template <int kBM>
void launch_tc(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int T_len, int H, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, float s_scale,
               cudaStream_t stream) {
  const dim3 grid(B * H, (T_len + kBM - 1) / kBM);
  flash_fwd_tc_kernel<kBM><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, T_len, qs,
      ks, vs, os, causal, s_scale);
}

bool tc_aligned(const void* p, const Strides& s) {
  return rtt::rows_aligned(p, s.b, s.t, s.h);
}

}  // namespace

// q, k, v, o: (B, T, H, D) with the given element strides for B, T and H
// and a contiguous D.  lse: (B*H, T) float32 or null.  dtype: 0 = float32
// (the scalar kernel), 1 = bfloat16 (the tensor-core kernel, with
// block_m = 64 or 128 query rows a block; bf16 operands must be 16-byte
// aligned with strides that are multiples of 8).  s_scale = softmax scale
// * log2(e).  D = 64, the head dim of every GPT-2 preset; other head dims
// are refused.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, with nothing launched, for what it refuses.
extern "C" int rtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int T_len, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, float s_scale, int dtype, int block_m,
    void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float, 64>(q, k, v, o, lse, B, T_len, H, qs, ks, vs, os, causal,
                      s_scale, s);
  } else if (dtype == 1) {
    if (!tc_aligned(q, qs) || !tc_aligned(k, ks) || !tc_aligned(v, vs) ||
        !tc_aligned(o, os))
      return (int)cudaErrorInvalidValue;
    if (block_m == 64)
      launch_tc<64>(q, k, v, o, lse, B, T_len, H, qs, ks, vs, os, causal,
                    s_scale, s);
    else if (block_m == 128)
      launch_tc<128>(q, k, v, o, lse, B, T_len, H, qs, ks, vs, os, causal,
                     s_scale, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
