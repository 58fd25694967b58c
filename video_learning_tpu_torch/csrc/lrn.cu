// AlexNet local response normalization, forward, for Hopper (sm_90a).
//
// Replaces: video_learning_tpu/ops/pallas_kernels.py, function `lrn`
// (kernel body `_lrn_fwd_kernel`, launched through `_tile_call`).
//
// Computes, over the trailing channel axis of a channels-last tensor
// viewed as (rows, C):
//   out[c] = x[c] * (bias + alpha * sum_{|k-c| <= r} x[k]^2) ^ (-beta)
// with the square taken in the tensor's own dtype (as the reference
// `layers._lrn_slide` does), the window sum and the power in float32, the
// power rounded to the tensor's dtype and the product written in it.
//
// Bound on this card: memory by the arithmetic (one read and one write
// of each element, 2 bytes each way in bf16, against about ten float
// operations), but in practice the instructions spent per element: an
// earlier version of this kernel that indexed the tile as a flat array
// spent ~130 (an integer division by C per element, a runtime window
// loop) and ran at a quarter of the bandwidth whatever its loads did.
//
// Design: each warp owns one pixel row at a time (rows are contiguous C
// values) and walks the rows of its block.  Lane l handles channels
// l, l + 32, ...: loads and stores are coalesced, no index needs a
// division, and the warp stages the row in its own slice of shared
// memory -- each value as float32, and its square with an r-wide zero
// halo on both sides -- so the window sums read neighbouring addresses
// (no bank conflicts) after a __syncwarp, with no block-wide barrier.
// The window is unrolled for the AlexNet radius 2.  The TPU kernel ran
// the window sum as a banded (C x C) matrix product so that it landed
// on the MXU; here that would only multiply the operation count by
// C / (2r+1).  d^-0.75 is rsqrt(d) * sqrt(rsqrt(d)); other betas use powf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using vlt::from_f32;
using vlt::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kUnroll = 8;
constexpr int kSmemBudget = 48 * 1024;

// R > 0: the window radius fixed at compile time; R == 0: `radius`.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows,
               int C, int radius, float bias, float alpha, float beta) {
  extern __shared__ float smem[];
  const int rad = R > 0 ? R : radius;
  const int width = C + 2 * rad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sq = smem + warp * (width + C);        // squares, with the halo
  float* xs = sq + width;                       // values
  for (int k = lane; k < 2 * rad; k += 32) sq[k < rad ? k : C + k] = 0.f;

  const bool beta_075 = (beta == 0.75f);
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;
  const long long last = min(first + kRowsPerWarp, rows);
  for (long long row = first; row < last; ++row) {
    const T* xr = x + row * C;
    T* yr = y + row * C;
    for (int base = lane; base < C; base += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + 32 * u;
        v[u] = c < C ? to_f32(xr[c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + 32 * u;
        if (c < C) {
          xs[c] = v[u];
          sq[rad + c] = to_f32(from_f32<T>(v[u] * v[u]));
        }
      }
    }
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float* s = sq + c;
      float acc = s[0];
      if (R > 0) {
#pragma unroll
        for (int k = 1; k <= 2 * R; ++k) acc = __fadd_rn(acc, s[k]);
      } else {
        for (int k = 1; k <= 2 * rad; ++k) acc = __fadd_rn(acc, s[k]);
      }
      const float d = __fadd_rn(bias, __fmul_rn(alpha, acc));
      float p;
      if (beta_075) {
        const float q = rsqrtf(d);
        p = q * sqrtf(q);
      } else {
        p = powf(d, -beta);
      }
      yr[c] = from_f32<T>(__fmul_rn(xs[c], to_f32(from_f32<T>(p))));
    }
    __syncwarp();          // the next row reuses this warp's buffers
  }
}

template <typename T>
int launch(const void* x, void* y, long long rows, int C, int radius,
           float bias, float alpha, float beta, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kWarps) * (2 * C + 2 * radius) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemBudget))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kWarps) * kRowsPerWarp;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (radius == 2) {
    lrn_fwd_kernel<T, 2><<<grid, kThreads, smem, stream>>>(
        xt, yt, rows, C, radius, bias, alpha, beta);
  } else {
    lrn_fwd_kernel<T, 0><<<grid, kThreads, smem, stream>>>(
        xt, yt, rows, C, radius, bias, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous (rows, C) in float32 (dtype 0) or bfloat16 (dtype 1).
// Returns cudaGetLastError() after the launch.
extern "C" int vlt_lrn_fwd(const void* x, void* y, long long rows, int C,
                           int dtype, int radius, float bias, float alpha,
                           float beta, void* stream) {
  if (rows <= 0) return 0;
  if (C <= 0 || radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, rows, C, radius, bias, alpha, beta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, rows, C, radius, bias, alpha, beta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
