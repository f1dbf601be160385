// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py, `_flash_kernel` (reached
// through `_flash_forward_lse_flat`'s pl.pallas_call).  Same arithmetic:
// tiled online softmax with float32 running (m, l, acc); scores are
// multiplied by scale*log2(e) so probabilities are exp2(s - m); masked
// scores are float32's lowest finite value (NEG_INF), not -inf; l is
// clamped to 1e-30 before the divide; the optional lse is base 2,
// m + log2(l), one float32 per (batch*head, query).
//
// What bounds it on this card: at the serving shapes (D = 64, T <= 1024,
// one sequence, 12 heads) the data-sheet bound is bytes (q, k, v read
// once and o written once: ~6.3 MB, ~1.9 us, against ~1.6 GFLOP, ~1.6 us
// of bf16 tensor-core work).  This first kernel does its products with
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), so in practice the
// FMA and exp2 rate bounds it, well above either data-sheet time.
// Moving the two products onto the tensor cores (mma.sync / wgmma) is
// the next step; this kernel is the simple, correct baseline.
//
// What the design does about it:
// - Grid (query tiles, batch*head).  A block owns kBQ = 32 query rows
//   and walks the key tiles in order; nothing carries between blocks.
//   Query tiles are issued longest-first (the last tile of a causal
//   sequence sees every key), so the triangle's long tiles start early.
// - Each query row is owned by four adjacent lanes; lane p of the four
//   holds head-dim elements p, p+4, ...  A score is four partial dots
//   joined by two shuffles.  The interleave keeps the four lanes on four
//   neighbouring shared-memory banks (no bank conflicts).
// - K and V tiles (kBK = 32 keys) are staged in shared memory as float32
//   (16 KB at D = 64), converted once from the storage type.
// - q, k and v are read through their (batch, seq, head) strides with
//   the head dim contiguous, so the strided views that come out of the
//   qkv projection need no copy into a (B*H, T, D) layout.
// - Only tiles that straddle the diagonal or the ragged end of the
//   sequence pay for the mask; any T is taken, rows past T are computed
//   and not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>

namespace {

constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile
constexpr int kLanesPerRow = 4;
constexpr int kThreads = kBQ * kLanesPerRow;   // 128
constexpr float kNegInf = -FLT_MAX;     // NEG_INF = finfo(float32).min

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, t, h;
};

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

}  // namespace

// q, k, v, o: (B, T, H, D) with the given element strides for B, T and H
// and a contiguous D.  lse: (B*H, T) float32 or null.  dtype: 0 = float32,
// 1 = bfloat16.  s_scale = softmax scale * log2(e).  D = 64, the head
// dim of every GPT-2 preset; other head dims are refused.
// Returns cudaGetLastError() after the launch.
extern "C" int rtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int T_len, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, int causal, float s_scale, int dtype, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return (int)cudaGetLastError();
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float, 64>(q, k, v, o, lse, B, T_len, H, qs, ks, vs, os, causal,
                      s_scale, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, T_len, H, qs, ks, vs, os,
                              causal, s_scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
