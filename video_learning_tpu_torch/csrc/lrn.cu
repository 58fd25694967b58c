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
// Bound on this card: memory.  One read and one write of each element (2
// bytes each way in bf16) against about ten float operations: 0.763 ms
// for the bf16 (2048, 57, 57, 96) training site and 0.491 ms for (2048,
// 28, 28, 256) at 3.35 TB/s.  What keeps a kernel from it is the
// instructions spent per element: an early version that indexed the tile
// as a flat array spent ~130 (an integer division by C per element, a
// runtime window loop) and ran at a quarter of the bandwidth.
//
// Two designs; `vlt_lrn_fwd` picks one by shape and reports which.
//
// "vector" (the training and serving sites): C a multiple of a 16-byte
// chunk (8 bf16 or 4 float32 channels), radius <= half a chunk, 16-byte
// aligned pointers; the design of lrn_vec.cuh, which the backward
// (lrn_bwd.cu) shares.  Each lane loads one 16-byte chunk of x and stores
// one of y; the squares come from the neighbouring lanes' registers for
// the halos.  Each warp issues the loads of kTiles tiles (4 KB) before it
// computes them.
//
// "staged" (every other shape: C not a multiple of a chunk, wider radii,
// unaligned pointers): each warp owns one pixel row at a time (rows are
// contiguous C values) and walks the rows of its block.  Lane l handles
// channels l, l + 32, ...: loads and stores are coalesced, no index needs
// a division, and the warp stages the row in its own slice of shared
// memory -- each value as float32, and its square with an r-wide zero
// halo on both sides -- so the window sums read neighbouring addresses
// (no bank conflicts) after a __syncwarp, with no block-wide barrier.  It
// takes C up to 766 at radius 2 (48 KB of shared memory).
//
// Both designs take the same rounding points and sum the window left to
// right, so they give the same bits.  The TPU kernel ran the window sum
// as a banded (C x C) matrix product so that it landed on the MXU; here
// that would only multiply the operation count by C / (2r+1).  d^-0.75 is
// rsqrt(d) * sqrt(rsqrt(d)); other betas use powf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "lrn_vec.cuh"

namespace {

using vlt::Chunk;
using vlt::from_f32;
using vlt::to_f32;

// ------------------------------------------------------------- staged
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
      const float acc = vlt::window_sum<R>(sq + c, rad);
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
int launch_staged(const void* x, void* y, long long rows, int C, int radius,
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

// ------------------------------------------------------------- vector
constexpr int kVecWarps = 8;
constexpr int kVecThreads = 32 * kVecWarps;
constexpr int kTiles = 8;          // warp tiles whose loads go out together

// y of one chunk from its x (lanes of a warp hold neighbouring chunks;
// every lane of the warp calls it together)
template <typename T, int R>
__device__ __forceinline__ uint4 chunk_y(const uint4& xw, bool first,
                                         bool last, float bias, float alpha,
                                         float beta) {
  constexpr int V = Chunk<T>::V;
  float xf[V], d[V], p[V];
  Chunk<T>::unpack(xw, xf);
  bool fast;
  vlt::chunk_denominator<T, R>(xf, first, last, bias, alpha, beta, d, p,
                               &fast);
  Chunk<T>::round(p);
#pragma unroll
  for (int i = 0; i < V; ++i) p[i] = __fmul_rn(xf[i], p[i]);
  return Chunk<T>::pack(p);
}

// x, y as 16-byte chunks, cut as `grid` says (lrn_vec.cuh)
template <typename T, int R>
__global__ void __launch_bounds__(kVecThreads)
lrn_fwd_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                   vlt::VecGrid grid, float bias, float alpha, float beta) {
  vlt::VecLane l;
  if (!vlt::vec_lane(grid, kVecWarps, kTiles, &l)) return;
  uint4 xw[kTiles];
  vlt::load_tiles<kTiles>(x, l.q, l.step, grid.chunks, xw);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const uint4 out = chunk_y<T, R>(xw[t], l.j == 0, l.j == grid.cpr - 1,
                                    bias, alpha, beta);
    const long long qt = l.q + t * l.step;
    if (l.stores && qt < grid.chunks) y[qt] = out;
    vlt::vec_advance(grid, &l);
  }
}

// The vector kernel instantiated for R == radius (0 <= R <= half a chunk:
// a wider radius, or a grid of more than 2^31 - 1 blocks, returns
// cudaErrorInvalidValue).
template <typename T, int R = 0>
int launch_vector(const void* x, void* y, long long rows, int C, int radius,
                  float bias, float alpha, float beta, cudaStream_t stream) {
  if constexpr (2 * R > Chunk<T>::V) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (radius != R)
      return launch_vector<T, R + 1>(x, y, rows, C, radius, bias, alpha,
                                     beta, stream);
    const vlt::VecGrid grid = vlt::vec_grid<T>(rows, C, kVecWarps, kTiles);
    if (grid.blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    lrn_fwd_vec_kernel<T, R>
        <<<static_cast<unsigned>(grid.blocks), kVecThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), grid, bias,
        alpha, beta);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const void* x, void* y, long long rows, int C, int radius,
           float bias, float alpha, float beta, int* variant,
           cudaStream_t stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (vlt::vector_takes<T>(addr, C, radius)) {
    *variant = 1;
    return launch_vector<T>(x, y, rows, C, radius, bias, alpha, beta,
                            stream);
  }
  *variant = 0;
  return launch_staged<T>(x, y, rows, C, radius, bias, alpha, beta, stream);
}

}  // namespace

// x, y: contiguous (rows, C) in float32 (dtype 0) or bfloat16 (dtype 1).
// Launches the vector kernel where C is a multiple of 16 bytes,
// 2 * radius * (element size) <= 16 and both pointers are 16-byte aligned,
// and the staged kernel otherwise (a C past its shared memory returns
// cudaErrorInvalidValue).  Writes the variant it chose to *variant (1
// vector, 0 staged; -1 if none) and returns cudaGetLastError() after the
// launch.
extern "C" int vlt_lrn_fwd(const void* x, void* y, long long rows, int C,
                           int dtype, int radius, float bias, float alpha,
                           float beta, int* variant, void* stream) {
  *variant = -1;
  if (rows <= 0) return 0;
  if (C <= 0 || radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, rows, C, radius, bias, alpha, beta, variant,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, rows, C, radius, bias, alpha, beta,
                                 variant, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
