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
// What bounds it on this card: device memory.  A row is read once and
// written once (N*E*2 bytes each way in bf16); the arithmetic is a few
// operations per element, far below the card's ~295 operations per byte.
// At decode (N <= 16 rows) the launch itself dominates.
//
// What the design does about it: one warp per row, four rows per block.
// The row is loaded once into registers (E = 768 is 24 values a lane),
// both reductions are warp shuffles with no shared memory and no
// __syncthreads, and the output is written once.  Neighbouring lanes
// touch neighbouring elements, so every load and store is coalesced.
// Rows wider than the register tile (E > 768) take a loop that re-reads
// the row from L1/L2 instead; no width is refused.
//
// Backward.
// Replaces: ray_tpu/ops/layer_norm.py, `_bwd_kernel` (reached through
// `_ln_bwd`'s pl.pallas_call).  Same arithmetic, all in float32:
// xhat = (x - mu) * rstd, gs = g * scale,
// dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)) in x's type, and
// float32 partial sums of dscale = sum_rows g * xhat and dbias = sum_rows g
// that the caller sums outside (the reference sums its per-block partials
// outside the kernel too).
//
// What bounds it on this card: device memory.  x and g are read once and
// dx written once (3 * N * E * 2 bytes in bf16: ~151 MB, ~45 us at the
// training shape N = 32768, E = 768); a few operations per element.
//
// What the design does about it: the forward's layout, one warp per row,
// lane l owning columns l + 32 j, so a lane sees the same columns in every
// row and keeps its dscale/dbias columns in registers across all the rows
// it walks.  About two blocks per SM (the caller picks the grid); each
// block walks a stripe of rows, then its warps add their register sums
// into shared memory one warp at a time (a fixed order: the result does
// not depend on scheduling) and the block writes ONE float32 partial row
// of each sum.  At the training shape that is ~264 partial rows (~1.6 MB),
// not one per few rows.  Rows wider than the register tile take a loop
// whose warps fold each row into shared memory in turn.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
// The register tile: E <= 768 (GPT-2 124M's width) in registers, 24
// values a lane.  Wider rows take the generic loop.
constexpr int kTilePerLane = 24;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// PER_LANE > 0: the row lives in registers, PER_LANE values per lane.
// PER_LANE == 0: any width; the row is read three times (L1/L2 hits).
template <typename T, int PER_LANE>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, long long x_row_stride,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, int n_rows, int E,
                      float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // whole warp leaves together
  const T* xr = x + (long long)row * x_row_stride;
  T* yr = y + (long long)row * E;
  const float inv_e = 1.0f / (float)E;

  float mu, rstd;
  if constexpr (PER_LANE > 0) {
    float v[PER_LANE];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + j * kWarp;
      v[j] = c < E ? to_f32(xr[c]) : 0.f;
      s += v[j];
    }
    mu = warp_sum(s) * inv_e;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + j * kWarp;
      const float d = c < E ? v[j] - mu : 0.f;
      ss += d * d;
    }
    rstd = rsqrtf(warp_sum(ss) * inv_e + eps);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + j * kWarp;
      if (c < E)
        yr[c] = from_f32<T>((v[j] - mu) * rstd * scale[c] + bias[c]);
    }
  } else {
    float s = 0.f;
    for (int c = lane; c < E; c += kWarp) s += to_f32(xr[c]);
    mu = warp_sum(s) * inv_e;
    float ss = 0.f;
    for (int c = lane; c < E; c += kWarp) {
      const float d = to_f32(xr[c]) - mu;
      ss += d * d;
    }
    rstd = rsqrtf(warp_sum(ss) * inv_e + eps);
    for (int c = lane; c < E; c += kWarp)
      yr[c] = from_f32<T>((to_f32(xr[c]) - mu) * rstd * scale[c] + bias[c]);
  }
  if (lane == 0) {
    if (mu_out) mu_out[row] = mu;
    if (rstd_out) rstd_out[row] = rstd;
  }
}

template <typename T>
void launch(const void* x, long long x_row_stride, const float* scale,
            const float* bias, void* y, float* mu, float* rstd, int n_rows,
            int E, float eps, cudaStream_t stream) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kWarp * kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int per_lane = (E + kWarp - 1) / kWarp;
#define RTT_LN_CASE(P)                                                    \
  layer_norm_fwd_kernel<T, P><<<grid, block, 0, stream>>>(                \
      xp, x_row_stride, scale, bias, yp, mu, rstd, n_rows, E, eps)
  if (per_lane <= kTilePerLane) RTT_LN_CASE(kTilePerLane);
  else RTT_LN_CASE(0);
#undef RTT_LN_CASE
}

constexpr int kBwdWarps = 8;

// Shared memory holds the block's two partial rows, s_ds[E] and s_db[E].
template <typename T, int PER_LANE>
__global__ void __launch_bounds__(kWarp * kBwdWarps)
layer_norm_bwd_kernel(const T* __restrict__ x, long long x_row_stride,
                      const float* __restrict__ scale,
                      const T* __restrict__ g, long long g_row_stride,
                      const float* __restrict__ mu,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ dscale_part,
                      float* __restrict__ dbias_part, int n_rows, int E) {
  extern __shared__ float smem[];
  float* s_ds = smem;
  float* s_db = smem + E;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int c = threadIdx.x; c < 2 * E; c += blockDim.x) smem[c] = 0.f;
  __syncthreads();
  const float inv_e = 1.0f / (float)E;
  const int first = blockIdx.x * kBwdWarps;
  const int row_step = gridDim.x * kBwdWarps;

  if constexpr (PER_LANE > 0) {
    float acc_ds[PER_LANE], acc_db[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc_ds[j] = acc_db[j] = 0.f;
    for (int row = first + warp; row < n_rows; row += row_step) {
      const T* xr = x + (long long)row * x_row_stride;
      const T* gr = g + (long long)row * g_row_stride;
      T* dxr = dx + (long long)row * E;
      const float m = mu[row], rs = rstd[row];
      float xh[PER_LANE], gv[PER_LANE];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + j * kWarp;
        xh[j] = c < E ? (to_f32(xr[c]) - m) * rs : 0.f;
        gv[j] = c < E ? to_f32(gr[c]) : 0.f;
        const float gs = c < E ? gv[j] * scale[c] : 0.f;
        s1 += gs;
        s2 += gs * xh[j];
      }
      const float m1 = warp_sum(s1) * inv_e;
      const float m2 = warp_sum(s2) * inv_e;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + j * kWarp;
        if (c < E) {
          const float gs = gv[j] * scale[c];
          dxr[c] = from_f32<T>(rs * (gs - m1 - xh[j] * m2));
          acc_ds[j] += gv[j] * xh[j];
          acc_db[j] += gv[j];
        }
      }
    }
    for (int w = 0; w < kBwdWarps; ++w) {   // one warp at a time
      if (warp == w) {
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int c = lane + j * kWarp;
          if (c < E) {
            s_ds[c] += acc_ds[j];
            s_db[c] += acc_db[j];
          }
        }
      }
      __syncthreads();
    }
  } else {
    // Any width: each warp takes one row of the round, then the warps
    // fold their rows into shared memory in turn.
    for (int base = first; base < n_rows; base += row_step) {
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
  }
  // every warp's adds are visible after the last turn's barrier
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    dscale_part[(long long)blockIdx.x * E + c] = s_ds[c];
    dbias_part[(long long)blockIdx.x * E + c] = s_db[c];
  }
}

template <typename T>
int launch_bwd(const void* x, long long x_row_stride, const float* scale,
               const void* g, long long g_row_stride, const float* mu,
               const float* rstd, void* dx, float* dscale_part,
               float* dbias_part, int n_rows, int E, int n_blocks,
               cudaStream_t stream) {
  const size_t smem = 2 * (size_t)E * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  const int per_lane = (E + kWarp - 1) / kWarp;
#define RTT_LN_BWD_CASE(P)                                                \
  layer_norm_bwd_kernel<T, P><<<n_blocks, kWarp * kBwdWarps, smem,         \
                                stream>>>(xp, x_row_stride, scale, gp,     \
                                          g_row_stride, mu, rstd, dxp,     \
                                          dscale_part, dbias_part, n_rows, \
                                          E)
  if (per_lane <= kTilePerLane) RTT_LN_BWD_CASE(kTilePerLane);
  else RTT_LN_BWD_CASE(0);
#undef RTT_LN_BWD_CASE
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it).
// mu / rstd may be null.  Returns cudaGetLastError() after the launch.
extern "C" int rtt_layer_norm_fwd(const void* x, long long x_row_stride,
                                  const float* scale, const float* bias,
                                  void* y, float* mu, float* rstd,
                                  int n_rows, int E, float eps, int dtype,
                                  void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, x_row_stride, scale, bias, y, mu, rstd, n_rows, E, eps,
                  s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, x_row_stride, scale, bias, y, mu, rstd, n_rows,
                          E, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, g: (n_rows, E) with row strides and contiguous rows, dtype as above;
// mu, rstd: (n_rows,) float32 from the forward; dx: (n_rows, E)
// contiguous.  dscale_part, dbias_part: (n_blocks, E) float32, one
// partial row per block, summed by the caller.  E <= 6144 (the partial
// rows live in 48 KB of shared memory).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int rtt_layer_norm_bwd(const void* x, long long x_row_stride,
                                  const float* scale, const void* g,
                                  long long g_row_stride, const float* mu,
                                  const float* rstd, void* dx,
                                  float* dscale_part, float* dbias_part,
                                  int n_rows, int E, int n_blocks, int dtype,
                                  void* stream) {
  if (n_blocks <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_bwd<float>(x, x_row_stride, scale, g, g_row_stride, mu, rstd,
                           dx, dscale_part, dbias_part, n_rows, E, n_blocks,
                           s);
  else if (dtype == 1)
    rc = launch_bwd<__nv_bfloat16>(x, x_row_stride, scale, g, g_row_stride,
                                   mu, rstd, dx, dscale_part, dbias_part,
                                   n_rows, E, n_blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
