// Flash-attention backward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py, `_bwd_kernel` (reached
// through `_flash_backward_flat`'s pl.pallas_call).  Same arithmetic, with
// the reference's rounding points for a storage type T (bf16 or float32):
//   s  = q k^T * scale * log2(e), masked to NEG_INF (float32's lowest)
//   p  = exp2(s - lse)              (lse: the forward's base-2 residual)
//   dv = sum_q T(p) do              dp = do v^T
//   ds = p * (dp - delta)           (delta = sum_D do * o, from the caller)
//   dk = scale * sum_q T(ds) q      dq = sum_k T(ds) T(k * scale)
// with every product accumulated in float32 and dq, dk, dv rounded to T
// once at the end.
//
// What bounds it on this card: at the training shape (B*H = 384, T = 1024,
// D = 64, causal) the data-sheet bound is operations: five products of
// 2*D FLOP per visible (query, key) pair, ~129 GFLOP, ~0.13 ms of bf16
// tensor-core work, against ~350 MB of traffic (~0.1 ms).  This first
// kernel does its products with float32 FMAs on the CUDA cores and reads
// its operands from shared memory one float at a time, so in practice the
// shared-memory and FMA rates bound it, far above either data-sheet time.
// Moving the products onto mma.sync / wgmma is later work.
//
// What the design does about it:
// - The reference walks key blocks once and keeps dq in an f32 VMEM
//   scratch across the grid.  Blocks on this card run in parallel, so that
//   scratch would become float atomics to device memory, whose order (and
//   so whose rounding) changes from run to run.  Instead there are two
//   deterministic launches: a dK/dV pass over (key tile, batch*head) that
//   walks the query tiles at or past the diagonal, and a dQ pass over
//   (query tile, batch*head) that walks the key tiles up to the diagonal.
//   Both recompute p from the lse; the dQ pass recomputes s and dp too.
//   The cost is two extra products per pair; what it buys is a gradient
//   that does not depend on how the blocks were scheduled.
// - The forward's layout: a block owns 32 rows (keys in the dK/dV pass,
//   queries in the dQ pass), four adjacent lanes share a row, and lane p of
//   the four holds head-dim elements p, p+4, ... (no shared-memory bank
//   conflicts).  The other side's tiles (32 rows) are staged in shared
//   memory as float32, converted once from T.
// - q, k, v and do are read through their (batch, seq, head) strides with
//   the head dim contiguous, so the strided views of the qkv projection go
//   in with no copy; dq, dk, dv are written contiguous (B, T, H, D).
// - Only tiles that straddle the diagonal or the ragged end of the
//   sequence pay for the mask; any T is taken.  In the dK/dV pass the
//   first key tile sees every query, and tiles are issued in that order;
//   in the dQ pass the last query tile is the longest and goes first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>

namespace {

constexpr int kBQ = 32;                 // query rows per tile
constexpr int kBK = 32;                 // key rows per tile
constexpr int kLanesPerRow = 4;
constexpr int kThreads = 32 * kLanesPerRow;   // 128: 32 rows of 4 lanes
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
// The value a float32 takes once stored in T (the reference's .astype).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;            // (B*H, T) float32
  void *dq, *dk, *dv;                  // contiguous (B, T, H, D)
  int H, T_len;
  Strides qs, ks, vs, dos;
  int causal;
  float s_scale, scale;
};

// dK/dV: grid (key tiles, B*H).  A thread row is one key.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(Args a) {
  constexpr int kPer = D / kLanesPerRow;
  __shared__ float q_s[kBQ][D];
  __shared__ float do_s[kBQ][D];
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int tid = threadIdx.x;
  const int r = tid / kLanesPerRow;
  const int part = tid % kLanesPerRow;
  const int kt = blockIdx.x;                 // key tile 0 sees every query
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int T_len = a.T_len;
  const int k0 = kt * kBK;
  const int kpos = k0 + r;
  const bool k_ok = kpos < T_len;

  float kv[kPer], vv[kPer], dk_acc[kPer], dv_acc[kPer];
  {
    const T* kp = static_cast<const T*>(a.k) + b * a.ks.b +
                  (long long)kpos * a.ks.t + h * a.ks.h;
    const T* vp = static_cast<const T*>(a.v) + b * a.vs.b +
                  (long long)kpos * a.vs.t + h * a.vs.h;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      kv[i] = k_ok ? to_f32(kp[part + kLanesPerRow * i]) : 0.f;
      vv[i] = k_ok ? to_f32(vp[part + kLanesPerRow * i]) : 0.f;
      dk_acc[i] = dv_acc[i] = 0.f;
    }
  }
  const T* qbase = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dobase =
      static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* lse_row = a.lse + (long long)bh * T_len;
  const float* delta_row = a.delta + (long long)bh * T_len;
  const int n_q_tiles = (T_len + kBQ - 1) / kBQ;
  // a query sees these keys only at or past the first of them
  const int qt_begin = a.causal ? k0 / kBQ : 0;

  for (int qt = qt_begin; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBQ * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int qp = q0 + j;
      const bool ok = qp < T_len;
      q_s[j][d] = ok ? to_f32(qbase[(long long)qp * a.qs.t + d]) : 0.f;
      do_s[j][d] = ok ? to_f32(dobase[(long long)qp * a.dos.t + d]) : 0.f;
    }
    if (tid < kBQ) {
      const int qp = q0 + tid;
      const bool ok = qp < T_len;
      lse_s[tid] = ok ? lse_row[qp] : 0.f;
      delta_s[tid] = ok ? delta_row[qp] : 0.f;
    }
    __syncthreads();

    // Some query of the tile cannot see some key of this block: it lies
    // past T, or (causal) before the block's last key.
    const bool masked =
        (q0 + kBQ > T_len) || (a.causal && q0 < k0 + kBK - 1);
#pragma unroll 4
    for (int j = 0; j < kBQ; ++j) {
      float sd = 0.f, dpd = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        sd = fmaf(q_s[j][part + kLanesPerRow * i], kv[i], sd);
        dpd = fmaf(do_s[j][part + kLanesPerRow * i], vv[i], dpd);
      }
      float s = quad_sum(sd) * a.s_scale;
      const float dp = quad_sum(dpd);
      if (masked) {
        const int qp = q0 + j;
        if (qp >= T_len || (a.causal && qp < kpos)) s = kNegInf;
      }
      const float p = exp2f(s - lse_s[j]);
      const float ds = p * (dp - delta_s[j]);
      const float pl = round_to<T>(p);
      const float dsl = round_to<T>(ds);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        dv_acc[i] = fmaf(pl, do_s[j][part + kLanesPerRow * i], dv_acc[i]);
        dk_acc[i] = fmaf(dsl, q_s[j][part + kLanesPerRow * i], dk_acc[i]);
      }
    }
  }

  if (!k_ok) return;
  const long long row = (((long long)b * T_len + kpos) * a.H + h) * D;
  T* dkp = static_cast<T*>(a.dk) + row;
  T* dvp = static_cast<T*>(a.dv) + row;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dkp[part + kLanesPerRow * i] = from_f32<T>(dk_acc[i] * a.scale);
    dvp[part + kLanesPerRow * i] = from_f32<T>(dv_acc[i]);
  }
}

// dQ: grid (query tiles, B*H).  A thread row is one query.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int kPer = D / kLanesPerRow;
  __shared__ float k_s[kBK][D];
  __shared__ float ks_s[kBK][D];    // T(k * scale), the dq operand
  __shared__ float v_s[kBK][D];

  const int tid = threadIdx.x;
  const int r = tid / kLanesPerRow;
  const int part = tid % kLanesPerRow;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int T_len = a.T_len;
  const int q0 = qt * kBQ;
  const int qpos = q0 + r;
  const bool q_ok = qpos < T_len;

  float qv[kPer], dov[kPer], dq_acc[kPer];
  {
    const T* qp = static_cast<const T*>(a.q) + b * a.qs.b +
                  (long long)qpos * a.qs.t + h * a.qs.h;
    const T* dp = static_cast<const T*>(a.dout) + b * a.dos.b +
                  (long long)qpos * a.dos.t + h * a.dos.h;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = q_ok ? to_f32(qp[part + kLanesPerRow * i]) : 0.f;
      dov[i] = q_ok ? to_f32(dp[part + kLanesPerRow * i]) : 0.f;
      dq_acc[i] = 0.f;
    }
  }
  const float lse = q_ok ? a.lse[(long long)bh * T_len + qpos] : 0.f;
  const float delta = q_ok ? a.delta[(long long)bh * T_len + qpos] : 0.f;

  const int kv_end = a.causal ? min(T_len, q0 + kBQ) : T_len;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const T* kbase = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      const bool ok = kp < T_len;
      const float kf = ok ? to_f32(kbase[(long long)kp * a.ks.t + d]) : 0.f;
      k_s[j][d] = kf;
      ks_s[j][d] = round_to<T>(kf * a.scale);
      v_s[j][d] = ok ? to_f32(vbase[(long long)kp * a.vs.t + d]) : 0.f;
    }
    __syncthreads();

    const bool masked =
        (k0 + kBK > T_len) || (a.causal && k0 + kBK - 1 > q0);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float sd = 0.f, dpd = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        sd = fmaf(qv[i], k_s[j][part + kLanesPerRow * i], sd);
        dpd = fmaf(dov[i], v_s[j][part + kLanesPerRow * i], dpd);
      }
      float s = quad_sum(sd) * a.s_scale;
      const float dp = quad_sum(dpd);
      if (masked) {
        const int kp = k0 + j;
        if (kp >= T_len || (a.causal && kp > qpos)) s = kNegInf;
      }
      const float p = exp2f(s - lse);
      const float dsl = round_to<T>(p * (dp - delta));
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        dq_acc[i] = fmaf(dsl, ks_s[j][part + kLanesPerRow * i], dq_acc[i]);
    }
  }

  if (!q_ok) return;
  T* dqp = static_cast<T*>(a.dq) +
           (((long long)b * T_len + qpos) * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    dqp[part + kLanesPerRow * i] = from_f32<T>(dq_acc[i]);
}

template <typename T, int D>
void launch(const Args& a, int B, cudaStream_t stream) {
  const int tiles = (a.T_len + kBQ - 1) / kBQ;   // kBQ == kBK
  const dim3 grid(tiles, B * a.H);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// q, k, v, dout: (B, T, H, D) with the given element strides for B, T and
// H and a contiguous D.  lse, delta: (B*H, T) float32.  dq, dk, dv:
// contiguous (B, T, H, D) outputs of the same dtype (0 = float32,
// 1 = bfloat16).  s_scale = scale * log2(e), scale = 1/sqrt(D).  D = 64
// only.  Two launches on `stream`; returns cudaGetLastError() after them.
extern "C" int rtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int B, int T_len, int H, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long do_sb,
    long long do_st, long long do_sh, int causal, float s_scale, float scale,
    int dtype, void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return (int)cudaGetLastError();
  if (D != 64) return (int)cudaErrorInvalidValue;
  Args a{q,     k,     v,  dout, lse, delta, dq, dk, dv, H, T_len,
         {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
         {do_sb, do_st, do_sh}, causal, s_scale, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float, 64>(a, B, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, 64>(a, B, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
