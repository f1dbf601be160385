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
// Both dtypes keep two deterministic launches.  The reference walks key
// blocks once and keeps dq in an f32 VMEM scratch across the grid.
// Blocks on this card run in parallel, so that scratch would become float
// atomics to device memory, whose order (and so whose rounding) changes
// from run to run.  Instead a dK/dV pass over (key tile, batch*head) walks
// the query tiles at or past the diagonal, and a dQ pass over (query
// tile, batch*head) walks the key tiles up to the diagonal.  Both
// recompute p from the lse; the dQ pass recomputes s and dp too.  The cost
// is two extra products per pair; what it buys is a gradient that does
// not depend on how the blocks were scheduled.
//
// bf16 (the train step's dtype) runs on the tensor cores.  What bounds it
// on this card: at the training shape (B*H = 384, T = 1024, D = 64,
// causal) the seven products of the two passes are 180 GFLOP (~0.18 ms
// at 989 TFLOP/s; five of them, 129 GFLOP, are the function's own work)
// against ~360 MB of traffic (~0.11 ms), so operations bound it.  What
// the design does about it:
// - Grid (batch*head, tiles of 64).  A block is four warps of 16 rows:
//   keys in the dK/dV pass, queries in the dQ pass.  The block's own rows
//   stay in registers as mma A fragments (K and V; Q and dO), loaded once.
// - The other side's tiles (Q, dO, lse, delta; K, V) go through a
//   two-stage cp.async ring, so the next tile's copy runs under this
//   tile's products; rows of 64 bf16 are XOR-swizzled (tensor_core.cuh).
// - dK/dV computes in the transposed orientation, so that every operand
//   comes from registers or from ldmatrix and nothing goes back through
//   shared memory: S^T = K Q^T (Q by ldmatrix), P^T = exp2(S^T s - lse),
//   dV += T(P^T) dO (P^T from the accumulators, dO by .trans),
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += T(dS^T) Q (Q by
//   .trans).  Four products a pair; dK is scaled once at the end.
// - dQ: S = Q K^T, P = exp2(S s - lse), dP = dO V^T, dS = P (dP - delta),
//   dQ += T(dS) K (K by .trans).  Three products a pair.  The reference
//   rounds k * scale to bf16 before its dq product; at D = 64 the scale is
//   1/8, a power of two, so that rounding is exact for every normal value
//   and sum T(ds) T(k * scale) = scale * sum T(ds) k exactly: the pass
//   reads K as it is and multiplies dq by the scale in its epilogue.  This
//   instantiation takes D = 64 without KV groups only.
// - Only the diagonal tile and the ragged last tile pay for the mask.
// - q, k, v and do are read through their (batch, seq, head) strides with
//   the head dim contiguous (16-byte aligned, strides multiples of 8
//   elements); dq, dk, dv are written contiguous (B, T, H, D).  In the
//   dK/dV pass key tile 0 sees every query and goes first; in the dQ pass
//   the last query tile is the longest and goes first.
//
// bf16 at D = 128 with grouped K/V (Llama: 32 query heads over 8 KV heads)
// is its own pair of kernels, flash_bwd_{dkdv,dq}_gqa_kernel.  K and V keep
// their KV heads; query head h reads KV head h / G (G = H / KV, the order
// of the reference's jnp.repeat).  The reference expands K/V, gets bf16 dK
// and dV per query head and sums each group through jnp.repeat's
// transpose; here dK and dV are summed over the group in float32 and
// rounded once.  What bounds it: at the train shape (4, 2048, 32 over 8,
// 128) causal the five products of the function's own work are 344 GFLOP
// (0.35 ms at 989 TFLOP/s) against ~270 MB (0.08 ms), so operations; the
// two passes do seven.  What the design does about it:
// - dK/dV over (batch * KV head, key tile): the block walks the G query
//   heads of its group and their query tiles as one sequence of steps
//   through the two-stage ring, keeping dK and dV (64 + 64 floats a
//   thread) in registers across the whole group, and writes (B, T, KV, D)
//   once: no G-fold writes, no separate reduction.  At D = 128 the D = 64
//   design (K and V held as A fragments, 32 + 32 registers more, and S^T,
//   dP^T 32 + 32) would pass 255 registers, so K and V stay in shared
//   memory and are read by ldmatrix at each product, and each 64-query
//   tile is taken in two halves of 32 queries (S^T, dP^T 16 + 16 floats).
//   Shared memory: K, V 32 KB + two stages of [Q | dO | lse | delta] 65 KB.
// - dQ over (batch * query head, query tile), longest first: Q and dO
//   tiles stay in shared memory, K/V tiles of KV head h / G go through
//   the two-stage ring.  1/sqrt(128) is not a power of two, so the D = 64
//   epilogue trick is not exact here: each K tile, once landed, is copied
//   by the block to T(k * scale) in a shared buffer (the reference's ks,
//   rounded to nearest even), which is the dq product's B operand.
//   Shared memory: Q, dO, T(K scale) 48 KB + ring 64 KB = 112 KB.
// Both run two blocks (eight warps) an SM; rows are 256 bytes, swizzled
// as in the forward's D = 128 tiles (tensor_core.cuh).
//
// float32 (not a main-path dtype) runs the first, scalar kernels: a block
// owns 32 rows, four adjacent lanes share a row and hold head-dim elements
// p, p+4, ..., the other side's tiles are staged in shared memory as
// float32, products are FMAs on the CUDA cores.

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;            // (B*H, T) float32
  void *dq, *dk, *dv;                  // contiguous (B, T, H or KV, D)
  int H, T_len;
  Strides qs, ks, vs, dos;
  int causal;
  float s_scale, scale;
  int group;                           // H / KV: query heads a KV head serves
};

// ------------------------------------------------ float32: scalar kernels
constexpr int kBQ = 32;                 // query rows per tile
constexpr int kBK = 32;                 // key rows per tile
constexpr int kLanesPerRow = 4;
constexpr int kThreads = 32 * kLanesPerRow;   // 128: 32 rows of 4 lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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

// --------------------------------------------------- bf16: tensor cores
using rtt::bf16;
constexpr int kTcThreads = 128;          // four warps of 16 rows
constexpr int kB = 64;                   // rows a block owns; rows a tile
constexpr int kTile = kB * rtt::kRow;    // elements of one 64-row tile

// dK/dV on the tensor cores: grid (B*H, key tiles).  Warp w owns keys
// k0 + 16 w .. k0 + 16 w + 15.
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(Args a) {
  // Two ring stages of [Q tile | dO tile | lse[64] | delta[64]]; K and V
  // are staged in stage 1 and moved to registers before the first query
  // tile goes there.
  constexpr int kStage = 2 * kTile * 2 + 2 * kB * 4;   // bytes
  __shared__ __align__(128) unsigned char smem[2 * kStage];
  auto q_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * kStage);
  };
  auto do_tile = [&](int st) { return q_tile(st) + kTile; };
  auto lse_s = [&](int st) {
    return reinterpret_cast<float*>(smem + st * kStage + 4 * kTile);
  };
  auto delta_s = [&](int st) { return lse_s(st) + kB; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;                 // key tile 0 sees every query
  const int b = bh / a.H, h = bh % a.H;
  const int T_len = a.T_len;
  const int k0 = kt * kB;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* lse_row = a.lse + (long long)bh * T_len;
  const float* delta_row = a.delta + (long long)bh * T_len;
  const int n_q_tiles = (T_len + kB - 1) / kB;
  const int qt_begin = a.causal ? kt : 0;    // the diagonal tile first

  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * kB;
    rtt::load_tile<kB, kTcThreads>(q_tile(st), qb, a.qs.t, q0, T_len, tid);
    rtt::load_tile<kB, kTcThreads>(do_tile(st), dob, a.dos.t, q0, T_len,
                                   tid);
    const int i = tid & (kB - 1), qp = q0 + i;
    const bool ok = qp < T_len;
    const float* src = (tid < kB ? lse_row : delta_row) + (ok ? qp : 0);
    rtt::cp_async4((tid < kB ? lse_s(st) : delta_s(st)) + i, src, ok);
  };

  rtt::load_tile<kB, kTcThreads>(q_tile(1), static_cast<const bf16*>(a.k) +
                                                b * a.ks.b + h * a.ks.h,
                                 a.ks.t, k0, T_len, tid);
  rtt::load_tile<kB, kTcThreads>(do_tile(1), static_cast<const bf16*>(a.v) +
                                                 b * a.vs.b + h * a.vs.h,
                                 a.vs.t, k0, T_len, tid);
  if (qt_begin < n_q_tiles) load_q_tile(qt_begin, 0);
  rtt::cp_async_commit();
  rtt::cp_async_wait<0>();
  __syncthreads();

  const int wk0 = k0 + 16 * warp;            // the warp's first key
  uint32_t kf[4][4], vf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    rtt::ldsm_x4(kf[kk], rtt::ld_rows(q_tile(1), 16 * warp, 2 * kk, lane));
    rtt::ldsm_x4(vf[kk], rtt::ld_rows(do_tile(1), 16 * warp, 2 * kk, lane));
  }

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int qt = qt_begin; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kB, st = (qt - qt_begin) & 1;
    rtt::cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < n_q_tiles) {
      load_q_tile(qt + 1, st ^ 1);
      rtt::cp_async_commit();
    }
    const bf16* q_s = q_tile(st);
    const bf16* do_s = do_tile(st);
    const float* lse_t = lse_s(st);
    const float* delta_t = delta_s(st);

    // S^T = K Q^T: 16 keys x 64 queries a warp.
    float pt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t qf[4];
        rtt::ldsm_x4(qf, rtt::ld_nk(q_s, 16 * np, 2 * kk, lane));
        rtt::mma(pt[2 * np], kf[kk], qf[0], qf[1]);
        rtt::mma(pt[2 * np + 1], kf[kk], qf[2], qf[3]);
      }
    // P^T = exp2(S^T * s_scale - lse[query]), one FFMA and one MUFU.EX2
    // (tensor_core.cuh); masked entries give 0.
    const bool masked =
        (q0 + kB > T_len) || (a.causal && q0 < wk0 + 15);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * nt + 2 * t + (e & 1);
        float x = pt[nt][e];
        if (masked) {
          const int qp = q0 + qi, kp = wk0 + g + 8 * (e >> 1);
          if (qp >= T_len || (a.causal && qp < kp)) x = kNegInf;
        }
        pt[nt][e] = rtt::exp2_ftz(fmaf(x, a.s_scale, -lse_t[qi]));
      }
    // dV += bf16(P^T) dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {         // queries 16 kk .. 16 kk + 15
      uint32_t pa[4];
      rtt::pack_a(pa, pt[2 * kk], pt[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t df[4];
        rtt::ldsm_x4_t(df, rtt::ld_rows(do_s, 16 * kk, 2 * dp, lane));
        rtt::mma(dv[2 * dp], pa, df[0], df[1]);
        rtt::mma(dv[2 * dp + 1], pa, df[2], df[3]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta[query]) in place.
    float dst[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t df[4];
        rtt::ldsm_x4(df, rtt::ld_nk(do_s, 16 * np, 2 * kk, lane));
        rtt::mma(dst[2 * np], vf[kk], df[0], df[1]);
        rtt::mma(dst[2 * np + 1], vf[kk], df[2], df[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[nt][e] =
            pt[nt][e] * (dst[nt][e] - delta_t[8 * nt + 2 * t + (e & 1)]);
    // dK += bf16(dS^T) Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      rtt::pack_a(sa, dst[2 * kk], dst[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t qf[4];
        rtt::ldsm_x4_t(qf, rtt::ld_rows(q_s, 16 * kk, 2 * dp, lane));
        rtt::mma(dk[2 * dp], sa, qf[0], qf[1]);
        rtt::mma(dk[2 * dp + 1], sa, qf[2], qf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = wk0 + g + 8 * hr;
    if (kp >= T_len) continue;
    const long long row = (((long long)b * T_len + kp) * a.H + h) * rtt::kRow;
    bf16* dkp = static_cast<bf16*>(a.dk) + row + 2 * t;
    bf16* dvp = static_cast<bf16*>(a.dv) + row + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      rtt::store_bf16x2(dkp + 8 * nt, dk[nt][2 * hr] * a.scale,
                        dk[nt][2 * hr + 1] * a.scale);
      rtt::store_bf16x2(dvp + 8 * nt, dv[nt][2 * hr], dv[nt][2 * hr + 1]);
    }
  }
}

// dQ on the tensor cores: grid (B*H, query tiles), longest tiles first.
// Warp w owns queries q0 + 16 w .. q0 + 16 w + 15.
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(Args a) {
  // Two ring stages of [K tile | V tile]; Q and dO are staged in stage 1
  // and moved to registers before the first key tile goes there.
  __shared__ __align__(128) bf16 smem[2 * 2 * kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int b = bh / a.H, h = bh % a.H;
  const int T_len = a.T_len;
  const int q0 = qt * kB;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const int kv_end = a.causal ? min(T_len, q0 + kB) : T_len;
  const int n_tiles = (kv_end + kB - 1) / kB;

  rtt::load_tile<kB, kTcThreads>(smem + 2 * kTile,
                                 static_cast<const bf16*>(a.q) + b * a.qs.b +
                                     h * a.qs.h,
                                 a.qs.t, q0, T_len, tid);
  rtt::load_tile<kB, kTcThreads>(smem + 3 * kTile,
                                 static_cast<const bf16*>(a.dout) +
                                     b * a.dos.b + h * a.dos.h,
                                 a.dos.t, q0, T_len, tid);
  rtt::load_tile<kB, kTcThreads>(smem, kb, a.ks.t, 0, T_len, tid);
  rtt::load_tile<kB, kTcThreads>(smem + kTile, vb, a.vs.t, 0, T_len, tid);
  rtt::cp_async_commit();

  const int wq0 = q0 + 16 * warp;            // the warp's first query
  float lse[2], delta[2];                    // rows g and g + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = wq0 + g + 8 * hr;
    const bool ok = qp < T_len;
    lse[hr] = ok ? a.lse[(long long)bh * T_len + qp] : 0.f;
    delta[hr] = ok ? a.delta[(long long)bh * T_len + qp] : 0.f;
  }
  rtt::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    rtt::ldsm_x4(qf[kk], rtt::ld_rows(smem + 2 * kTile, 16 * warp, 2 * kk,
                                      lane));
    rtt::ldsm_x4(dof[kk], rtt::ld_rows(smem + 3 * kTile, 16 * warp, 2 * kk,
                                       lane));
  }

  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kB;
    rtt::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      bf16* nxt = smem + ((j + 1) & 1) * 2 * kTile;
      rtt::load_tile<kB, kTcThreads>(nxt, kb, a.ks.t, k0 + kB, T_len, tid);
      rtt::load_tile<kB, kTcThreads>(nxt + kTile, vb, a.vs.t, k0 + kB, T_len,
                                     tid);
      rtt::cp_async_commit();
    }
    const bf16* k_s = smem + (j & 1) * 2 * kTile;
    const bf16* v_s = k_s + kTile;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp.
    float p[8][4], ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        rtt::ldsm_x4(kf, rtt::ld_nk(k_s, 16 * np, 2 * kk, lane));
        rtt::mma(p[2 * np], qf[kk], kf[0], kf[1]);
        rtt::mma(p[2 * np + 1], qf[kk], kf[2], kf[3]);
        rtt::ldsm_x4(vf, rtt::ld_nk(v_s, 16 * np, 2 * kk, lane));
        rtt::mma(ds[2 * np], dof[kk], vf[0], vf[1]);
        rtt::mma(ds[2 * np + 1], dof[kk], vf[2], vf[3]);
      }
    // P = exp2(S * s_scale - lse), dS = P (dP - delta).
    const bool masked =
        (k0 + kB > T_len) || (a.causal && k0 + kB - 1 > wq0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float x = p[nt][e];
        if (masked) {
          const int kp = k0 + 8 * nt + 2 * t + (e & 1);
          const int qp = wq0 + g + 8 * hr;
          if (kp >= T_len || (a.causal && kp > qp)) x = kNegInf;
        }
        const float pv = rtt::exp2_ftz(fmaf(x, a.s_scale, -lse[hr]));
        ds[nt][e] = pv * (ds[nt][e] - delta[hr]);
      }
    // dQ += bf16(dS) K  (the scale comes in the epilogue)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {         // keys 16 kk .. 16 kk + 15
      uint32_t sa[4];
      rtt::pack_a(sa, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t kf[4];
        rtt::ldsm_x4_t(kf, rtt::ld_rows(k_s, 16 * kk, 2 * dp, lane));
        rtt::mma(dq[2 * dp], sa, kf[0], kf[1]);
        rtt::mma(dq[2 * dp + 1], sa, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = wq0 + g + 8 * hr;
    if (qp >= T_len) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) +
                (((long long)b * T_len + qp) * a.H + h) * rtt::kRow + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      rtt::store_bf16x2(dqp + 8 * nt, dq[nt][2 * hr] * a.scale,
                        dq[nt][2 * hr + 1] * a.scale);
  }
}

void launch_tc(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + kB - 1) / kB);
  flash_bwd_dkdv_tc_kernel<<<grid, kTcThreads, 0, stream>>>(a);
  flash_bwd_dq_tc_kernel<<<grid, kTcThreads, 0, stream>>>(a);
}

// ------------------------------- bf16, head dim 128, grouped K/V: tensor cores
constexpr int kGD = 128;                      // the head dim
constexpr int kGTile = kB * kGD;              // elements of one 64-row tile
constexpr int kQHalf = 32;                    // queries a dK/dV sub-step
// dK/dV: K and V tiles, then two ring stages of [Q | dO | lse | delta].
constexpr int kGStage = 2 * kGTile * 2 + 2 * kB * 4;         // bytes
constexpr int kDkdvSmem = 2 * kGTile * 2 + 2 * kGStage;      // 99,328
// dQ: Q, dO and T(K scale) tiles, then two ring stages of [K | V].
constexpr int kDqSmem = 3 * kGTile * 2 + 2 * 2 * kGTile * 2;  // 114,688

// dK/dV, D = 128, grouped: grid (B * KV, key tiles).  Warp w owns keys
// k0 + 16 w .. k0 + 16 w + 15; the block walks (query head of the group,
// query tile) steps, the diagonal tile first for each head.
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkdv_gqa_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char gqa_smem[];
  bf16* const k_s = reinterpret_cast<bf16*>(gqa_smem);
  bf16* const v_s = k_s + kGTile;
  unsigned char* const ring = gqa_smem + 2 * kGTile * 2;
  auto q_tile = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * kGStage);
  };
  auto do_tile = [&](int st) { return q_tile(st) + kGTile; };
  auto lse_s = [&](int st) {
    return reinterpret_cast<float*>(ring + st * kGStage + 4 * kGTile);
  };
  auto delta_s = [&](int st) { return lse_s(st) + kB; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.group, KV = a.H / G;
  const int b = blockIdx.x / KV, hk = blockIdx.x % KV;
  const int kt = blockIdx.y;                 // key tile 0 sees every query
  const int T_len = a.T_len;
  const int k0 = kt * kB;
  const int n_q_tiles = (T_len + kB - 1) / kB;
  const int qt_begin = a.causal ? kt : 0;
  const int per_head = n_q_tiles - qt_begin;
  const int n_steps = G * per_head;          // (query head, query tile)

  auto load_step = [&](int i, int st) {
    const int h = hk * G + i / per_head;
    const int q0 = (qt_begin + i % per_head) * kB;
    rtt::load_tile<kB, kTcThreads, kGD>(
        q_tile(st), static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h,
        a.qs.t, q0, T_len, tid);
    rtt::load_tile<kB, kTcThreads, kGD>(
        do_tile(st),
        static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h,
        a.dos.t, q0, T_len, tid);
    const long long row = (long long)(b * a.H + h) * T_len;
    const int r = tid & (kB - 1), qp = q0 + r;
    const bool ok = qp < T_len;
    const float* src = (tid < kB ? a.lse : a.delta) + row + (ok ? qp : 0);
    rtt::cp_async4((tid < kB ? lse_s(st) : delta_s(st)) + r, src, ok);
  };

  rtt::load_tile<kB, kTcThreads, kGD>(
      k_s, static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h, a.ks.t,
      k0, T_len, tid);
  rtt::load_tile<kB, kTcThreads, kGD>(
      v_s, static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h, a.vs.t,
      k0, T_len, tid);
  if (n_steps > 0) load_step(0, 0);
  rtt::cp_async_commit();

  const int wk0 = k0 + 16 * warp;            // the warp's first key
  float dk[kGD / 8][4], dv[kGD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kGD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int q0 = (qt_begin + i % per_head) * kB;
    rtt::cp_async_wait<0>();
    __syncthreads();   // step i landed; every warp is done with step i - 1
    if (i + 1 < n_steps) {
      load_step(i + 1, st ^ 1);
      rtt::cp_async_commit();
    }
    const bf16* q_s = q_tile(st);
    const bf16* do_s = do_tile(st);
    const float* lse_t = lse_s(st);
    const float* delta_t = delta_s(st);

#pragma unroll
    for (int half = 0; half < kB / kQHalf; ++half) {
      const int qh = kQHalf * half;          // the half's first query
      // every query of the half lies before the warp's keys: p = 0
      if (a.causal && q0 + qh + kQHalf - 1 < wk0) continue;
      // S^T = K Q^T: 16 keys x 32 queries a warp, K by ldmatrix.
      float pt[kQHalf / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQHalf / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kGD / 16; ++kk) {
        uint32_t kf[4];
        rtt::ldsm_x4(kf, rtt::ld_rows<kGD>(k_s, 16 * warp, 2 * kk, lane));
#pragma unroll
        for (int np = 0; np < kQHalf / 16; ++np) {
          uint32_t qf[4];
          rtt::ldsm_x4(qf, rtt::ld_nk<kGD>(q_s, qh + 16 * np, 2 * kk, lane));
          rtt::mma(pt[2 * np], kf, qf[0], qf[1]);
          rtt::mma(pt[2 * np + 1], kf, qf[2], qf[3]);
        }
      }
      // P^T = exp2(S^T * s_scale - lse[query]); masked entries give 0.
      const bool masked = (q0 + qh + kQHalf > T_len) ||
                          (a.causal && q0 + qh < wk0 + 15);
#pragma unroll
      for (int nt = 0; nt < kQHalf / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qh + 8 * nt + 2 * t + (e & 1);
          float x = pt[nt][e];
          if (masked) {
            const int qp = q0 + qi, kp = wk0 + g + 8 * (e >> 1);
            if (qp >= T_len || (a.causal && qp < kp)) x = kNegInf;
          }
          pt[nt][e] = rtt::exp2_ftz(fmaf(x, a.s_scale, -lse_t[qi]));
        }
      // dV += bf16(P^T) dO
#pragma unroll
      for (int kk = 0; kk < kQHalf / 16; ++kk) {
        uint32_t pa[4];
        rtt::pack_a(pa, pt[2 * kk], pt[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kGD / 16; ++dp) {
          uint32_t df[4];
          rtt::ldsm_x4_t(df,
                         rtt::ld_rows<kGD>(do_s, qh + 16 * kk, 2 * dp, lane));
          rtt::mma(dv[2 * dp], pa, df[0], df[1]);
          rtt::mma(dv[2 * dp + 1], pa, df[2], df[3]);
        }
      }
      // dP^T = V dO^T, V by ldmatrix; then dS^T = P^T (dP^T - delta).
      float dst[kQHalf / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQHalf / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kGD / 16; ++kk) {
        uint32_t vf[4];
        rtt::ldsm_x4(vf, rtt::ld_rows<kGD>(v_s, 16 * warp, 2 * kk, lane));
#pragma unroll
        for (int np = 0; np < kQHalf / 16; ++np) {
          uint32_t df[4];
          rtt::ldsm_x4(df,
                       rtt::ld_nk<kGD>(do_s, qh + 16 * np, 2 * kk, lane));
          rtt::mma(dst[2 * np], vf, df[0], df[1]);
          rtt::mma(dst[2 * np + 1], vf, df[2], df[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kQHalf / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[nt][e] = pt[nt][e] *
                       (dst[nt][e] - delta_t[qh + 8 * nt + 2 * t + (e & 1)]);
      // dK += bf16(dS^T) Q
#pragma unroll
      for (int kk = 0; kk < kQHalf / 16; ++kk) {
        uint32_t sa[4];
        rtt::pack_a(sa, dst[2 * kk], dst[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kGD / 16; ++dp) {
          uint32_t qf[4];
          rtt::ldsm_x4_t(qf,
                         rtt::ld_rows<kGD>(q_s, qh + 16 * kk, 2 * dp, lane));
          rtt::mma(dk[2 * dp], sa, qf[0], qf[1]);
          rtt::mma(dk[2 * dp + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }

  // dK = scale * sum, dV: summed over the group in float32, rounded once.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = wk0 + g + 8 * hr;
    if (kp >= T_len) continue;
    const long long row = (((long long)b * T_len + kp) * KV + hk) * kGD;
    bf16* dkp = static_cast<bf16*>(a.dk) + row + 2 * t;
    bf16* dvp = static_cast<bf16*>(a.dv) + row + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kGD / 8; ++nt) {
      rtt::store_bf16x2(dkp + 8 * nt, dk[nt][2 * hr] * a.scale,
                        dk[nt][2 * hr + 1] * a.scale);
      rtt::store_bf16x2(dvp + 8 * nt, dv[nt][2 * hr], dv[nt][2 * hr + 1]);
    }
  }
}

// dQ, D = 128, grouped: grid (B * H, query tiles), longest tiles first.
// Warp w owns queries q0 + 16 w .. q0 + 16 w + 15; query head h reads the
// K/V tiles of KV head h / G.
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_gqa_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char gqa_smem[];
  bf16* const q_s = reinterpret_cast<bf16*>(gqa_smem);
  bf16* const do_s = q_s + kGTile;
  bf16* const ks_s = do_s + kGTile;          // T(k * scale), the dq operand
  bf16* const ring = ks_s + kGTile;          // two stages of [K | V]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int b = bh / a.H, h = bh % a.H, hk = h / a.group;
  const int T_len = a.T_len;
  const int q0 = qt * kB;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const int kv_end = a.causal ? min(T_len, q0 + kB) : T_len;
  const int n_tiles = (kv_end + kB - 1) / kB;

  rtt::load_tile<kB, kTcThreads, kGD>(
      q_s, static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h, a.qs.t,
      q0, T_len, tid);
  rtt::load_tile<kB, kTcThreads, kGD>(
      do_s, static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h,
      a.dos.t, q0, T_len, tid);
  rtt::load_tile<kB, kTcThreads, kGD>(ring, kb, a.ks.t, 0, T_len, tid);
  rtt::load_tile<kB, kTcThreads, kGD>(ring + kGTile, vb, a.vs.t, 0, T_len,
                                      tid);
  rtt::cp_async_commit();

  const int wq0 = q0 + 16 * warp;            // the warp's first query
  float lse[2], delta[2];                    // rows g and g + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = wq0 + g + 8 * hr;
    const bool ok = qp < T_len;
    lse[hr] = ok ? a.lse[(long long)bh * T_len + qp] : 0.f;
    delta[hr] = ok ? a.delta[(long long)bh * T_len + qp] : 0.f;
  }

  float dq[kGD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kGD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kB;
    rtt::cp_async_wait<0>();
    // tile j landed; every warp is done with tile j - 1 and its T(K scale)
    __syncthreads();
    if (j + 1 < n_tiles) {
      bf16* nxt = ring + ((j + 1) & 1) * 2 * kGTile;
      rtt::load_tile<kB, kTcThreads, kGD>(nxt, kb, a.ks.t, k0 + kB, T_len,
                                          tid);
      rtt::load_tile<kB, kTcThreads, kGD>(nxt + kGTile, vb,
                                          a.vs.t, k0 + kB, T_len, tid);
      rtt::cp_async_commit();
    }
    const bf16* k_s = ring + (j & 1) * 2 * kGTile;
    const bf16* v_s = k_s + kGTile;
    // T(K * scale): 16 bytes (8 elements) a thread a step; the swizzle
    // moves whole 16-byte chunks, so the copy keeps the tile's layout.
#pragma unroll
    for (int i = 0; i < kGTile / 8 / kTcThreads; ++i) {
      const int c = tid + i * kTcThreads;
      const uint4 raw = *reinterpret_cast<const uint4*>(k_s + 8 * c);
      uint4 out;
      const __nv_bfloat162* in2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* out2 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(in2[e]);
        out2[e] = rtt::pack_bf16(f.x * a.scale, f.y * a.scale);
      }
      *reinterpret_cast<uint4*>(ks_s + 8 * c) = out;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp, Q and dO by
    // ldmatrix from their resident tiles.
    float p[8][4], ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kGD / 16; ++kk) {
      uint32_t qf[4], dof[4];
      rtt::ldsm_x4(qf, rtt::ld_rows<kGD>(q_s, 16 * warp, 2 * kk, lane));
      rtt::ldsm_x4(dof, rtt::ld_rows<kGD>(do_s, 16 * warp, 2 * kk, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        rtt::ldsm_x4(kf, rtt::ld_nk<kGD>(k_s, 16 * np, 2 * kk, lane));
        rtt::mma(p[2 * np], qf, kf[0], kf[1]);
        rtt::mma(p[2 * np + 1], qf, kf[2], kf[3]);
        rtt::ldsm_x4(vf, rtt::ld_nk<kGD>(v_s, 16 * np, 2 * kk, lane));
        rtt::mma(ds[2 * np], dof, vf[0], vf[1]);
        rtt::mma(ds[2 * np + 1], dof, vf[2], vf[3]);
      }
    }
    // P = exp2(S * s_scale - lse), dS = P (dP - delta).
    const bool masked =
        (k0 + kB > T_len) || (a.causal && k0 + kB - 1 > wq0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float x = p[nt][e];
        if (masked) {
          const int kp = k0 + 8 * nt + 2 * t + (e & 1);
          const int qp = wq0 + g + 8 * hr;
          if (kp >= T_len || (a.causal && kp > qp)) x = kNegInf;
        }
        const float pv = rtt::exp2_ftz(fmaf(x, a.s_scale, -lse[hr]));
        ds[nt][e] = pv * (ds[nt][e] - delta[hr]);
      }
    // dQ += bf16(dS) T(K * scale)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {         // keys 16 kk .. 16 kk + 15
      uint32_t sa[4];
      rtt::pack_a(sa, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < kGD / 16; ++dp) {
        uint32_t kf[4];
        rtt::ldsm_x4_t(kf, rtt::ld_rows<kGD>(ks_s, 16 * kk, 2 * dp, lane));
        rtt::mma(dq[2 * dp], sa, kf[0], kf[1]);
        rtt::mma(dq[2 * dp + 1], sa, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = wq0 + g + 8 * hr;
    if (qp >= T_len) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) +
                (((long long)b * T_len + qp) * a.H + h) * kGD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kGD / 8; ++nt)
      rtt::store_bf16x2(dqp + 8 * nt, dq[nt][2 * hr], dq[nt][2 * hr + 1]);
  }
}

// Opt both kernels in to their dynamic shared memory, once per device.
cudaError_t gqa_prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_gqa_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkdvSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_gqa_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

cudaError_t launch_gqa(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = gqa_prepare();
  if (err != cudaSuccess) return err;
  const int tiles = (a.T_len + kB - 1) / kB;
  flash_bwd_dkdv_gqa_kernel<<<dim3(B * (a.H / a.group), tiles), kTcThreads,
                              kDkdvSmem, stream>>>(a);
  flash_bwd_dq_gqa_kernel<<<dim3(B * a.H, tiles), kTcThreads, kDqSmem,
                            stream>>>(a);
  return cudaGetLastError();
}

// The dynamic shared memory of the dK/dV (pass 0) or dQ (pass 1) kernel
// and the blocks an SM the occupancy calculator allows it.
cudaError_t gqa_occupancy(int pass, int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t err = gqa_prepare();
  if (err != cudaSuccess) return err;
  *smem_bytes = pass == 0 ? kDkdvSmem : kDqSmem;
  return pass == 0
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, flash_bwd_dkdv_gqa_kernel, kTcThreads,
                   kDkdvSmem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, flash_bwd_dq_gqa_kernel, kTcThreads,
                   kDqSmem);
}

bool tc_aligned(const void* p, const Strides& s) {
  return rtt::rows_aligned(p, s.b, s.t, s.h);
}

}  // namespace

// q, dout: (B, T, H, D) and k, v: (B, T, KV, D), with the given element
// strides for B, T and the head axis and a contiguous D; KV divides H and
// query head h reads KV head h / (H / KV).  lse, delta: (B*H, T) float32.
// dq: contiguous (B, T, H, D); dk, dv: contiguous (B, T, KV, D); all of
// the inputs' dtype.  dtype 0 = float32 (the scalar kernels: D = 64,
// KV = H); 1 = bfloat16 (the tensor-core kernels: D = 64 with KV = H, or
// D = 128 with any KV dividing H; q, k, v, dout 16-byte aligned with
// strides that are multiples of 8).  s_scale = scale * log2(e), scale =
// 1/sqrt(D).  Two launches on `stream`; returns cudaGetLastError() after
// them, or cudaErrorInvalidValue, with nothing launched, for what it
// refuses.
extern "C" int rtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int B, int T_len, int H, int KV, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long do_sb,
    long long do_st, long long do_sh, int causal, float s_scale, float scale,
    int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0 || H == 0) return (int)cudaGetLastError();
  const int group = H / KV;
  Args a{q,     k,     v,  dout, lse, delta, dq, dk, dv, H, T_len,
         {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
         {do_sb, do_st, do_sh}, causal, s_scale, scale, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D != 64 || group != 1) return (int)cudaErrorInvalidValue;
    launch<float, 64>(a, B, s);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!tc_aligned(q, a.qs) || !tc_aligned(k, a.ks) || !tc_aligned(v, a.vs) ||
      !tc_aligned(dout, a.dos))
    return (int)cudaErrorInvalidValue;
  if (D == 64 && group == 1) {
    launch_tc(a, B, s);
    return (int)cudaGetLastError();
  }
  if (D == 128) return (int)launch_gqa(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The head-dim-128 bf16 kernels: the dynamic shared memory of the dK/dV
// (pass 0) or dQ (pass 1) kernel and the blocks an SM the occupancy
// calculator allows it.  cudaErrorInvalidValue for another pass.
extern "C" int rtt_flash_attention_bwd_occupancy(int pass, int* smem_bytes,
                                                 int* blocks_per_sm) {
  if (pass != 0 && pass != 1) return (int)cudaErrorInvalidValue;
  return (int)gqa_occupancy(pass, smem_bytes, blocks_per_sm);
}
