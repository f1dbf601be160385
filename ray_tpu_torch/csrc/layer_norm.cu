// Fused LayerNorm forward for Hopper (sm_90a).
//
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
