// Fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Forward.
// Replaces: ray_tpu/ops/layer_norm.py, `_fwd_kernel` (reached through
// `_ln_fwd`'s pl.pallas_call).  Same arithmetic: two-pass statistics in
// float32 (the mean first, then the mean of (x - mu)^2, never
// E[x^2] - mu^2), y = (x - mu) * rstd * scale + bias in float32, cast to
// the input type.  The per-row mu and rstd are optional float32 outputs
// (the backward's residuals).
//
// Backward.
// Replaces: ray_tpu/ops/layer_norm.py, `_bwd_kernel` (reached through
// `_ln_bwd`'s pl.pallas_call).  Same arithmetic, all in float32:
// xhat = (x - mu) * rstd, gs = g * scale,
// dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)) in x's type, and
// dscale = sum_rows g * xhat, dbias = sum_rows g as float32 partial rows,
// one per block, that a second launch sums in a fixed order (the
// reference sums its per-block partials outside the kernel too).
//
// What bounds both on this card: device memory.  The forward reads and
// writes each row once (2 * N * E * 2 bytes in bf16: ~101 MB, ~30 us at
// the training shape N = 32768, E = 768); the backward reads x and g and
// writes dx (~151 MB, ~45 us).  Both do a few operations per element, far
// below the card's ~295 operations per byte.  At decode (N = 16) the
// launch and one memory round trip are all there is.
//
// What the design does about it.
// - Vector I/O.  Lane l owns whole chunks of 8 columns, chunk j being
//   columns 8 * (l + 32 j) .. + 7, moved with 16-byte loads and stores
//   (one uint4 of bf16, two of float32).  At E = 768 a lane holds three
//   chunks and a warp instruction moves 512 contiguous bytes.
// - The affine in registers.  Each warp loads its columns' scale (and,
//   forward, bias) as float4 once, issued beside its first rows' loads,
//   and keeps them for every row it walks: a row costs one memory round
//   trip, not two.
// - Rows in flight.  A warp walks rows with a grid stride over a grid
//   that the SMs hold in one wave (the caller sizes it).  It keeps a ring
//   of rows in registers (Io<T>::kFwdStages / kBwdStages) and refills a
//   row's registers with the row a ring's length ahead as soon as it has
//   unpacked them, before the row's reductions, so the ring's rows are in
//   flight while it reduces.  At decode each warp takes one row and
//   nothing is refilled.
// - Registers and residency.  4-warp blocks.  The forward keeps to 128
//   registers, so an SM holds 4 blocks (16 warps) with two bf16 rows a
//   warp in flight.  The backward holds scale, both column sums and the
//   row's xhat and g (96 floats a lane) beside a one-row ring: 168
//   registers in bf16, 3 blocks an SM (12 warps), and 218 in float32, 2
//   blocks.  On the card more warps beat a deeper ring: at the training
//   shape 8 warps an SM with two rows each measured slower.
// - Deterministic dscale/dbias.  A lane sees the same columns in every
//   row and sums them in registers across the rows it walks; the block's
//   warps then add their sums into shared memory one warp at a time and
//   the block writes one partial row.  The fold kernel sums the partial
//   rows column by column, each of its 32 warps a fixed stride of rows,
//   then the 32 warp sums in warp order: the result does not depend on
//   scheduling.
//
// Wider rows, up to E = 2048 (GPT-2 medium, large and xl), take the
// wide-row kernels below: the same vector I/O with 8 chunks a lane, the
// affine (and, backward, the dscale/dbias sums) in shared memory.
//
// Rows neither layout takes (E not a multiple of 8 or above 2048, a row
// stride not a multiple of 8 elements, a base not 16-byte aligned) take
// the scalar-I/O kernels: one warp per row, lane l reading columns
// l + 32 i one element at a time and re-reading the row from L1/L2 for
// each pass.  No width is refused by the forward; the backward's scalar
// kernel keeps its partial rows in 48 KB of shared memory, so E <= 6144.
//
// The reference takes its Pallas kernel only when E % 128 == 0
// (ray_tpu/models/gpt2.py:159-171, a TPU lane-tiling limit), so at
// E = 1600 it computes the plain branch; the port computes the same
// function with these kernels at every E (ray_tpu_torch/models/gpt2.py,
// _layer_norm).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 8;                          // columns a vector moves
constexpr int kChunks = 3;                         // chunks a lane holds
constexpr int kVecMaxE = kChunk * kChunks * kWarp;  // 768
constexpr int kFwdWarps = 4;                       // rows a block takes at once
constexpr int kFwdBlocksPerSm = 4;
constexpr int kBwdWarps = 4;
constexpr int kFoldGroups = 32;                    // warps of the fold kernel
// The wide-row kernels: a lane holds up to 8 chunks, the affine lives in
// shared memory; the forward runs 3 blocks an SM (168 registers a
// thread), the backward 2 (255).
constexpr int kWideChunks = 8;
constexpr int kWideMaxE = kChunk * kWideChunks * kWarp;  // 2048
constexpr int kWideFwdBlocksPerSm = 3;
constexpr int kWideBwdBlocksPerSm = 2;

// Per element type: the 16-byte vectors a chunk takes, the rows a warp
// keeps in registers, and the backward blocks an SM holds (what fits the
// register budgets above).
template <typename T> struct Io;
template <> struct Io<__nv_bfloat16> {
  static constexpr int kVecs = 1;
  static constexpr int kFwdStages = 2;
  static constexpr int kBwdStages = 1;
  static constexpr int kBwdBlocksPerSm = 3;
  static constexpr int kWideFwdStages = 2;
};
template <> struct Io<float> {
  static constexpr int kVecs = 2;
  static constexpr int kFwdStages = 1;
  static constexpr int kBwdStages = 1;
  static constexpr int kBwdBlocksPerSm = 2;
  static constexpr int kWideFwdStages = 1;
};

template <typename T> struct Chunk {
  uint4 v[Io<T>::kVecs];
};

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

// A chunk's 8 values in float32 (exact: bf16 is float32's top half).
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float (&f)[kChunk]) {
  const unsigned w[4] = {c.v[0].x, c.v[0].y, c.v[0].z, c.v[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const Chunk<float>& c,
                                       float (&f)[kChunk]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(c.v[i].x);
    f[4 * i + 1] = __uint_as_float(c.v[i].y);
    f[4 * i + 2] = __uint_as_float(c.v[i].z);
    f[4 * i + 3] = __uint_as_float(c.v[i].w);
  }
}

// Round to T once (round to nearest even, as PyTorch's cast).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}
__device__ __forceinline__ void pack(const float (&f)[kChunk],
                                     Chunk<__nv_bfloat16>& c) {
  c.v[0] = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}
__device__ __forceinline__ void pack(const float (&f)[kChunk],
                                     Chunk<float>& c) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c.v[i] = make_uint4(__float_as_uint(f[4 * i]),
                        __float_as_uint(f[4 * i + 1]),
                        __float_as_uint(f[4 * i + 2]),
                        __float_as_uint(f[4 * i + 3]));
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, Chunk<T>& c) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < Io<T>::kVecs; ++i) c.v[i] = __ldg(q + i);
}
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T>& c) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < Io<T>::kVecs; ++i) q[i] = c.v[i];
}

// 8 float32 values from a 16-byte-aligned float pointer, as two float4.
__device__ __forceinline__ void load_f32x8(const float* p,
                                           float (&f)[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The same from shared memory (16-byte aligned).
__device__ __forceinline__ void lds_f32x8(const float* p,
                                          float (&f)[kChunk]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void sts_f32x8(float* p,
                                          const float (&f)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The columns a lane owns, kC chunks at most: chunk j starts at col[j]
// and exists if own[j].
template <int kC> struct LaneOf {
  int col[kC];
  bool own[kC];
  __device__ __forceinline__ explicit LaneOf(int lane, int E) {
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      col[j] = kChunk * (lane + j * kWarp);
      own[j] = col[j] < E;
    }
  }
};
using Lane = LaneOf<kChunks>;

template <typename T, int kC>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         long long stride, int r, int n_rows,
                                         const LaneOf<kC>& ln,
                                         Chunk<T> (&b)[kC]) {
  if (r >= n_rows) return;
  const T* xr = x + (long long)r * stride;
#pragma unroll
  for (int j = 0; j < kC; ++j)
    if (ln.own[j]) load_chunk(xr + ln.col[j], b[j]);
}

// ------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kWarp * kFwdWarps, kFwdBlocksPerSm)
layer_norm_fwd_vec_kernel(const T* __restrict__ x, long long x_row_stride,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int n_rows, int E,
                          float eps) {
  constexpr int S = Io<T>::kFwdStages;
  const int lane = threadIdx.x % kWarp;
  const int first = blockIdx.x * kFwdWarps + threadIdx.x / kWarp;
  const int step = gridDim.x * kFwdWarps;
  const float inv_e = 1.0f / (float)E;
  const Lane ln(lane, E);

  Chunk<T> buf[S][kChunks];
#pragma unroll
  for (int s = 0; s < S; ++s)
    load_row(x, x_row_stride, first + s * step, n_rows, ln, buf[s]);
  float sc[kChunks][kChunk], bi[kChunks][kChunk];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (ln.own[j]) {
      load_f32x8(scale + ln.col[j], sc[j]);
      load_f32x8(bias + ln.col[j], bi[j]);
    }
  }

  for (int row = first; row < n_rows; row += S * step) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = row + s * step;
      if (r >= n_rows) break;           // the whole warp leaves together
      float v[kChunks][kChunk];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
          unpack(buf[s][j], v[j]);
#pragma unroll
          for (int k = 0; k < kChunk; ++k) sum += v[j][k];
        }
      }
      // the row's registers are free: the row S strides ahead goes in flight
      load_row(x, x_row_stride, r + S * step, n_rows, ln, buf[s]);
      const float mu = warp_sum(sum) * inv_e;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const float d = v[j][k] - mu;
            ss += d * d;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(ss) * inv_e + eps);
      T* yr = y + (long long)r * E;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
          float o[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            o[k] = (v[j][k] - mu) * rstd * sc[j][k] + bi[j][k];
          Chunk<T> c;
          pack(o, c);
          store_chunk(yr + ln.col[j], c);
        }
      }
      if (lane == 0) {
        if (mu_out) mu_out[r] = mu;
        if (rstd_out) rstd_out[r] = rstd;
      }
    }
  }
}

// Any width, any alignment: one warp per row of a grid-stride walk, the
// row re-read from L1/L2 for each pass.
template <typename T>
__global__ void __launch_bounds__(kWarp * kFwdWarps)
layer_norm_fwd_scalar_kernel(const T* __restrict__ x, long long x_row_stride,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ y, float* __restrict__ mu_out,
                             float* __restrict__ rstd_out, int n_rows, int E,
                             float eps) {
  const int lane = threadIdx.x % kWarp;
  const int step = gridDim.x * kFwdWarps;
  const float inv_e = 1.0f / (float)E;
  for (int row = blockIdx.x * kFwdWarps + threadIdx.x / kWarp;
       row < n_rows; row += step) {
    const T* xr = x + (long long)row * x_row_stride;
    T* yr = y + (long long)row * E;
    float s = 0.f;
    for (int c = lane; c < E; c += kWarp) s += to_f32(xr[c]);
    const float mu = warp_sum(s) * inv_e;
    float ss = 0.f;
    for (int c = lane; c < E; c += kWarp) {
      const float d = to_f32(xr[c]) - mu;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_e + eps);
    for (int c = lane; c < E; c += kWarp)
      yr[c] = from_f32<T>((to_f32(xr[c]) - mu) * rstd * scale[c] + bias[c]);
    if (lane == 0) {
      if (mu_out) mu_out[row] = mu;
      if (rstd_out) rstd_out[row] = rstd;
    }
  }
}

// ------------------------------------------------------------ backward
// parts: one row of 2E float32 a block, its dscale sums then its dbias.
template <typename T>
__global__ void __launch_bounds__(kWarp * kBwdWarps, Io<T>::kBwdBlocksPerSm)
layer_norm_bwd_vec_kernel(const T* __restrict__ x, long long x_row_stride,
                          const float* __restrict__ scale,
                          const T* __restrict__ g, long long g_row_stride,
                          const float* __restrict__ mu,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          float* __restrict__ parts, int n_rows, int E) {
  constexpr int S = Io<T>::kBwdStages;
  __shared__ float s_ds[kVecMaxE], s_db[kVecMaxE];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int first = blockIdx.x * kBwdWarps + warp;
  const int step = gridDim.x * kBwdWarps;
  const float inv_e = 1.0f / (float)E;
  const Lane ln(lane, E);

  Chunk<T> xb[S][kChunks], gb[S][kChunks];
  float mb[S], rb[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = first + s * step;
    load_row(x, x_row_stride, r, n_rows, ln, xb[s]);
    load_row(g, g_row_stride, r, n_rows, ln, gb[s]);
    if (r < n_rows) {
      mb[s] = __ldg(mu + r);
      rb[s] = __ldg(rstd + r);
    }
  }
  float sc[kChunks][kChunk], acc_ds[kChunks][kChunk], acc_db[kChunks][kChunk];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (ln.own[j]) load_f32x8(scale + ln.col[j], sc[j]);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc_ds[j][k] = acc_db[j][k] = 0.f;
  }
  for (int c = threadIdx.x; c < kVecMaxE; c += blockDim.x)
    s_ds[c] = s_db[c] = 0.f;

  for (int row = first; row < n_rows; row += S * step) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = row + s * step;
      if (r >= n_rows) break;           // the whole warp leaves together
      const float m = mb[s], rs = rb[s];
      float xh[kChunks][kChunk], gv[kChunks][kChunk];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
          unpack(xb[s][j], xh[j]);
          unpack(gb[s][j], gv[j]);
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            xh[j][k] = (xh[j][k] - m) * rs;
            const float gs = gv[j][k] * sc[j][k];
            s1 += gs;
            s2 += gs * xh[j][k];
          }
        }
      }
      // the row's registers are free: the row S strides ahead goes in flight
      const int nr = r + S * step;
      load_row(x, x_row_stride, nr, n_rows, ln, xb[s]);
      load_row(g, g_row_stride, nr, n_rows, ln, gb[s]);
      if (nr < n_rows) {
        mb[s] = __ldg(mu + nr);
        rb[s] = __ldg(rstd + nr);
      }
      const float m1 = warp_sum(s1) * inv_e;
      const float m2 = warp_sum(s2) * inv_e;
      T* dxr = dx + (long long)r * E;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
          float o[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const float gs = gv[j][k] * sc[j][k];
            o[k] = rs * (gs - m1 - xh[j][k] * m2);
            acc_ds[j][k] += gv[j][k] * xh[j][k];
            acc_db[j][k] += gv[j][k];
          }
          Chunk<T> c;
          pack(o, c);
          store_chunk(dxr + ln.col[j], c);
        }
      }
    }
  }
  __syncthreads();                      // shared sums zeroed
  for (int w = 0; w < kBwdWarps; ++w) {   // one warp at a time
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (ln.own[j]) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            s_ds[ln.col[j] + k] += acc_ds[j][k];
            s_db[ln.col[j] + k] += acc_db[j][k];
          }
        }
      }
    }
    __syncthreads();
  }
  float* part = parts + (long long)blockIdx.x * 2 * E;
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    part[c] = s_ds[c];
    part[E + c] = s_db[c];
  }
}

// Any width up to 6144, any alignment.  Shared memory holds the block's
// two partial rows, s_ds[E] and s_db[E]; each warp takes one row of the
// round, then the warps fold their rows into shared memory in turn.
template <typename T>
__global__ void __launch_bounds__(kWarp * kBwdWarps)
layer_norm_bwd_scalar_kernel(const T* __restrict__ x, long long x_row_stride,
                             const float* __restrict__ scale,
                             const T* __restrict__ g, long long g_row_stride,
                             const float* __restrict__ mu,
                             const float* __restrict__ rstd,
                             T* __restrict__ dx,
                             float* __restrict__ parts, int n_rows, int E) {
  extern __shared__ float smem[];
  float* s_ds = smem;
  float* s_db = smem + E;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int c = threadIdx.x; c < 2 * E; c += blockDim.x) smem[c] = 0.f;
  __syncthreads();
  const float inv_e = 1.0f / (float)E;
  const int row_step = gridDim.x * kBwdWarps;
  for (int base = blockIdx.x * kBwdWarps; base < n_rows; base += row_step) {
    const int row = base + warp;
    const bool ok = row < n_rows;
    const T* xr = x + (long long)row * x_row_stride;
    const T* gr = g + (long long)row * g_row_stride;
    float m = 0.f, rs = 0.f;
    if (ok) {
      T* dxr = dx + (long long)row * E;
      m = mu[row];
      rs = rstd[row];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < E; c += kWarp) {
        const float gs = to_f32(gr[c]) * scale[c];
        s1 += gs;
        s2 += gs * (to_f32(xr[c]) - m) * rs;
      }
      const float m1 = warp_sum(s1) * inv_e;
      const float m2 = warp_sum(s2) * inv_e;
      for (int c = lane; c < E; c += kWarp) {
        const float xh = (to_f32(xr[c]) - m) * rs;
        const float gs = to_f32(gr[c]) * scale[c];
        dxr[c] = from_f32<T>(rs * (gs - m1 - xh * m2));
      }
    }
    for (int w = 0; w < kBwdWarps; ++w) {
      if (warp == w && ok) {
        for (int c = lane; c < E; c += kWarp) {
          const float gv = to_f32(gr[c]);
          s_ds[c] += gv * ((to_f32(xr[c]) - m) * rs);
          s_db[c] += gv;
        }
      }
      __syncthreads();
    }
  }
  // every warp's adds are visible after the last turn's barrier
  float* part = parts + (long long)blockIdx.x * 2 * E;
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    part[c] = s_ds[c];
    part[E + c] = s_db[c];
  }
}

// out[c] = sum over the n_parts rows of parts[:, c], in a fixed order:
// warp w of a block sums rows w, w + 32, ... of 32 columns (lane =
// column), then one warp adds the 32 warps' sums in warp order.
__global__ void __launch_bounds__(kWarp * kFoldGroups)
layer_norm_fold_kernel(const float* __restrict__ parts, int n_parts,
                       int width, float* __restrict__ out) {
  __shared__ float s[kFoldGroups][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int grp = threadIdx.x / kWarp;
  const int c = blockIdx.x * kWarp + lane;
  float acc = 0.f;
  if (c < width) {
#pragma unroll 4
    for (int r = grp; r < n_parts; r += kFoldGroups)
      acc += parts[(long long)r * width + c];
  }
  s[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && c < width) {
    float t = s[0][lane];
    for (int i = 1; i < kFoldGroups; ++i) t += s[i][lane];
    out[c] = t;
  }
}

// --------------------------------------------------------- wide rows
// E up to 2048 (GPT-2 medium, large and xl: 1024, 1280, 1600).  The
// vector layout as above with 8 chunks a lane, 7 at E = 1600 (200 chunks
// over 32 lanes), which leaves no room for the affine in registers:
// 7 x 8 x 2 floats of scale and bias would pass 255 beside the row.  So
// the block copies scale (and bias) to shared memory once, with 16-byte
// loads, and each lane reads its columns' 8 floats there as two 16-byte
// shared loads where it uses them (12.8 KB at E = 1600).  At GPT-2 xl's
// training rows, (8192, 1600) bf16, the forward must move 52.5 MB (15.7
// us at 3.35 TB/s) and the backward 78.7 MB (23.5 us): bytes-bound, as
// the vector kernels.
//
// Forward: a warp holds the row it reduces in float32 (64 registers)
// and Io<T>::kWideFwdStages rows in flight as packed 16-byte vectors (2
// in bf16, 1 in float32: 64 registers either way), a row's refilled as
// soon as it is unpacked, as in the vector kernel; 3 blocks an SM (168
// registers).
template <typename T>
__global__ void __launch_bounds__(kWarp * kFwdWarps, kWideFwdBlocksPerSm)
layer_norm_fwd_wide_kernel(const T* __restrict__ x, long long x_row_stride,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           T* __restrict__ y, float* __restrict__ mu_out,
                           float* __restrict__ rstd_out, int n_rows, int E,
                           float eps) {
  constexpr int S = Io<T>::kWideFwdStages;
  constexpr int C = kWideChunks;
  __shared__ __align__(16) float s_sc[kWideMaxE];
  __shared__ __align__(16) float s_bi[kWideMaxE];
  const int lane = threadIdx.x % kWarp;
  const int first = blockIdx.x * kFwdWarps + threadIdx.x / kWarp;
  const int step = gridDim.x * kFwdWarps;
  const float inv_e = 1.0f / (float)E;
  const LaneOf<C> ln(lane, E);

  Chunk<T> buf[S][C];
#pragma unroll
  for (int s = 0; s < S; ++s)
    load_row(x, x_row_stride, first + s * step, n_rows, ln, buf[s]);
  for (int c = 4 * threadIdx.x; c < E; c += 4 * blockDim.x) {
    *reinterpret_cast<float4*>(s_sc + c) =
        __ldg(reinterpret_cast<const float4*>(scale + c));
    *reinterpret_cast<float4*>(s_bi + c) =
        __ldg(reinterpret_cast<const float4*>(bias + c));
  }
  __syncthreads();

  for (int row = first; row < n_rows; row += S * step) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = row + s * step;
      if (r >= n_rows) break;           // the whole warp leaves together
      float v[C][kChunk];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (ln.own[j]) {
          unpack(buf[s][j], v[j]);
#pragma unroll
          for (int k = 0; k < kChunk; ++k) sum += v[j][k];
        }
      }
      // the row's registers are free: the row S strides ahead goes in flight
      load_row(x, x_row_stride, r + S * step, n_rows, ln, buf[s]);
      const float mu = warp_sum(sum) * inv_e;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (ln.own[j]) {
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const float d = v[j][k] - mu;
            ss += d * d;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(ss) * inv_e + eps);
      T* yr = y + (long long)r * E;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (ln.own[j]) {
          float sc[kChunk], bi[kChunk], o[kChunk];
          lds_f32x8(s_sc + ln.col[j], sc);
          lds_f32x8(s_bi + ln.col[j], bi);
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            o[k] = (v[j][k] - mu) * rstd * sc[k] + bi[k];
          Chunk<T> c;
          pack(o, c);
          store_chunk(yr + ln.col[j], c);
        }
      }
      if (lane == 0) {
        if (mu_out) mu_out[r] = mu;
        if (rstd_out) rstd_out[r] = rstd;
      }
    }
  }
}

// Backward: a warp loads a row of x and g as 16-byte vectors, unpacks
// them to xhat and g in float32 (128 registers; the packed copies die as
// they unpack, so no row is prefetched) and reads scale from shared
// memory.  With the shared-memory sums' temporaries that passes the 168
// registers of 3 blocks an SM (ptxas spilled 356 bytes there on the
// card), so the backward runs 2 blocks an SM, 255 registers.  dscale/dbias cannot stay in registers either (another 128
// floats a lane): each warp sums its rows into a slice of its own in
// shared memory, 2E floats, where each lane reads and writes only its
// own columns (no races, no barrier in the row loop).  At the end the
// block adds its 4 slices in warp order into its partial row; the fold
// kernel sums the partial rows as for the vector kernel.  Dynamic shared
// memory: (1 + 2 x 4) E floats, 57.6 KB at E = 1600, 72 KB at 2048.
template <typename T>
__global__ void __launch_bounds__(kWarp * kBwdWarps, kWideBwdBlocksPerSm)
layer_norm_bwd_wide_kernel(const T* __restrict__ x, long long x_row_stride,
                           const float* __restrict__ scale,
                           const T* __restrict__ g, long long g_row_stride,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           T* __restrict__ dx, float* __restrict__ parts,
                           int n_rows, int E) {
  constexpr int C = kWideChunks;
  extern __shared__ float4 wide_smem[];
  float* const smem = reinterpret_cast<float*>(wide_smem);
  float* s_sc = smem;                             // E
  float* s_acc = smem + E;                        // kBwdWarps x 2E
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int first = blockIdx.x * kBwdWarps + warp;
  const int step = gridDim.x * kBwdWarps;
  const float inv_e = 1.0f / (float)E;
  const LaneOf<C> ln(lane, E);
  float* my_ds = s_acc + warp * 2 * E;
  float* my_db = my_ds + E;

  for (int c = 4 * threadIdx.x; c < E; c += 4 * blockDim.x)
    *reinterpret_cast<float4*>(s_sc + c) =
        __ldg(reinterpret_cast<const float4*>(scale + c));
  for (int c = 4 * threadIdx.x; c < kBwdWarps * 2 * E; c += 4 * blockDim.x)
    *reinterpret_cast<float4*>(s_acc + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int r = first; r < n_rows; r += step) {
    float xh[C][kChunk], gv[C][kChunk];
    {
      Chunk<T> xb[C], gb[C];
      load_row(x, x_row_stride, r, n_rows, ln, xb);
      load_row(g, g_row_stride, r, n_rows, ln, gb);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (ln.own[j]) {
          unpack(xb[j], xh[j]);
          unpack(gb[j], gv[j]);
        }
      }
    }
    const float m = __ldg(mu + r), rs = __ldg(rstd + r);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (ln.own[j]) {
        float sc[kChunk];
        lds_f32x8(s_sc + ln.col[j], sc);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          xh[j][k] = (xh[j][k] - m) * rs;
          const float gs = gv[j][k] * sc[k];
          s1 += gs;
          s2 += gs * xh[j][k];
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_e;
    const float m2 = warp_sum(s2) * inv_e;
    T* dxr = dx + (long long)r * E;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (ln.own[j]) {
        float sc[kChunk], ads[kChunk], adb[kChunk], o[kChunk];
        lds_f32x8(s_sc + ln.col[j], sc);
        lds_f32x8(my_ds + ln.col[j], ads);
        lds_f32x8(my_db + ln.col[j], adb);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const float gs = gv[j][k] * sc[k];
          o[k] = rs * (gs - m1 - xh[j][k] * m2);
          ads[k] += gv[j][k] * xh[j][k];
          adb[k] += gv[j][k];
        }
        sts_f32x8(my_ds + ln.col[j], ads);
        sts_f32x8(my_db + ln.col[j], adb);
        Chunk<T> c;
        pack(o, c);
        store_chunk(dxr + ln.col[j], c);
      }
    }
  }
  __syncthreads();                      // every warp's slice is complete
  float* part = parts + (long long)blockIdx.x * 2 * E;
  for (int c = threadIdx.x; c < 2 * E; c += blockDim.x) {
    float t = s_acc[c];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) t += s_acc[w * 2 * E + c];
    part[c] = t;
  }
}

size_t wide_bwd_smem_bytes(int E) {
  return (size_t)(1 + 2 * kBwdWarps) * E * sizeof(float);
}

// The wide backward's dynamic shared memory above the default 48 KB, at
// its widest, opted in once per device.
template <typename T>
cudaError_t wide_bwd_prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(layer_norm_bwd_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wide_bwd_smem_bytes(kWideMaxE));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Routes: which instantiation a call takes (ops/layer_norm.py ROUTES).
enum Route { kScalar = 0, kVector = 1, kWide = 2 };

// What the vector kernels take: E a multiple of 8 up to 768 (vector) or
// 2048 (wide), row strides that are multiples of 8 elements, every
// pointer 16-byte aligned.
bool vector_ok(int route, int E, long long stride_or, std::uintptr_t ptr_or) {
  const int max_e = route == kWide ? kWideMaxE : kVecMaxE;
  return E > 0 && E % kChunk == 0 && E <= max_e && stride_or % kChunk == 0
         && ptr_or % 16 == 0;
}

template <typename T>
int launch_fwd(const void* x, long long x_row_stride, const float* scale,
               const float* bias, void* y, float* mu, float* rstd,
               int n_rows, int E, float eps, int route, int n_blocks,
               cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (route == kVector || route == kWide) {
    const std::uintptr_t ptrs = reinterpret_cast<std::uintptr_t>(x)
        | reinterpret_cast<std::uintptr_t>(scale)
        | reinterpret_cast<std::uintptr_t>(bias)
        | reinterpret_cast<std::uintptr_t>(y);
    if (!vector_ok(route, E, x_row_stride, ptrs))
      return (int)cudaErrorInvalidValue;
    if (route == kVector)
      layer_norm_fwd_vec_kernel<T>
          <<<n_blocks, kWarp * kFwdWarps, 0, stream>>>(
              xp, x_row_stride, scale, bias, yp, mu, rstd, n_rows, E, eps);
    else
      layer_norm_fwd_wide_kernel<T>
          <<<n_blocks, kWarp * kFwdWarps, 0, stream>>>(
              xp, x_row_stride, scale, bias, yp, mu, rstd, n_rows, E, eps);
  } else if (route == kScalar) {
    layer_norm_fwd_scalar_kernel<T>
        <<<n_blocks, kWarp * kFwdWarps, 0, stream>>>(
            xp, x_row_stride, scale, bias, yp, mu, rstd, n_rows, E, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
int launch_bwd(const void* x, long long x_row_stride, const float* scale,
               const void* g, long long g_row_stride, const float* mu,
               const float* rstd, void* dx, float* parts, float* sums,
               int n_rows, int E, int route, int n_blocks,
               cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  if (route == kVector || route == kWide) {
    const std::uintptr_t ptrs = reinterpret_cast<std::uintptr_t>(x)
        | reinterpret_cast<std::uintptr_t>(scale)
        | reinterpret_cast<std::uintptr_t>(g)
        | reinterpret_cast<std::uintptr_t>(dx);
    if (!vector_ok(route, E, x_row_stride | g_row_stride, ptrs))
      return (int)cudaErrorInvalidValue;
    if (route == kVector) {
      layer_norm_bwd_vec_kernel<T>
          <<<n_blocks, kWarp * kBwdWarps, 0, stream>>>(
              xp, x_row_stride, scale, gp, g_row_stride, mu, rstd, dxp,
              parts, n_rows, E);
    } else {
      const cudaError_t err = wide_bwd_prepare<T>();
      if (err != cudaSuccess) return (int)err;
      layer_norm_bwd_wide_kernel<T>
          <<<n_blocks, kWarp * kBwdWarps, wide_bwd_smem_bytes(E), stream>>>(
              xp, x_row_stride, scale, gp, g_row_stride, mu, rstd, dxp,
              parts, n_rows, E);
    }
  } else if (route == kScalar) {
    const size_t smem = 2 * (size_t)E * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    layer_norm_bwd_scalar_kernel<T>
        <<<n_blocks, kWarp * kBwdWarps, smem, stream>>>(
            xp, x_row_stride, scale, gp, g_row_stride, mu, rstd, dxp, parts,
            n_rows, E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int width = 2 * E;
  layer_norm_fold_kernel<<<(width + kWarp - 1) / kWarp, kWarp * kFoldGroups,
                           0, stream>>>(parts, n_blocks, width, sums);
  return 0;
}

}  // namespace

// x: (n_rows, E) with a row stride and contiguous rows; y: (n_rows, E)
// contiguous; scale, bias: (E,) float32.  dtype: 0 = float32,
// 1 = bfloat16 (x and y share it).  mu / rstd may be null.  route: 1 for
// the vector-I/O kernel, 2 for the wide-row one (each refused, with
// nothing launched, when the layout does not allow it), 0 for the
// scalar-I/O one.  n_blocks: the grid; each warp walks rows n_blocks * 4
// apart.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int rtt_layer_norm_fwd(const void* x, long long x_row_stride,
                                  const float* scale, const float* bias,
                                  void* y, float* mu, float* rstd,
                                  int n_rows, int E, float eps, int dtype,
                                  int route, int n_blocks, void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  if (n_blocks <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_fwd<float>(x, x_row_stride, scale, bias, y, mu, rstd, n_rows,
                           E, eps, route, n_blocks, s);
  else if (dtype == 1)
    rc = launch_fwd<__nv_bfloat16>(x, x_row_stride, scale, bias, y, mu, rstd,
                                   n_rows, E, eps, route, n_blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x, g: (n_rows, E) with row strides and contiguous rows, dtype as above;
// mu, rstd: (n_rows,) float32 from the forward; dx: (n_rows, E)
// contiguous.  parts: (n_blocks, 2E) float32 scratch, one partial row of
// dscale then dbias per block; sums: (2, E) float32, dscale then dbias,
// the partial rows summed in a fixed order by a second launch on the same
// stream.  route as above; the scalar kernel takes E <= 6144 (its
// partial rows live in 48 KB of shared memory).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// what it does not take.
extern "C" int rtt_layer_norm_bwd(const void* x, long long x_row_stride,
                                  const float* scale, const void* g,
                                  long long g_row_stride, const float* mu,
                                  const float* rstd, void* dx, float* parts,
                                  float* sums, int n_rows, int E,
                                  int n_blocks, int dtype, int route,
                                  void* stream) {
  if (n_blocks <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_bwd<float>(x, x_row_stride, scale, g, g_row_stride, mu, rstd,
                           dx, parts, sums, n_rows, E, route, n_blocks, s);
  else if (dtype == 1)
    rc = launch_bwd<__nv_bfloat16>(x, x_row_stride, scale, g, g_row_stride,
                                   mu, rstd, dx, parts, sums, n_rows, E,
                                   route, n_blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
