// Weight gradient of the AlexNet stem conv (11x11, stride 4, SAME, 3 -> 96
// channels), for Hopper (sm_90a).  Two entry points, one per TPU kernel:
//
//   vlt_conv1_dw          replaces video_learning_tpu/ops/pallas_kernels.py
//                         `conv1_dw` (kernel body `_conv1_dw_kernel`)
//   vlt_conv1_dw_shifted  replaces `conv1_dw_shifted` (kernel body
//                         `_conv1_dw_shift_kernel`)
//
// Computes, in the space-to-depth domain where the conv has stride 1 and
// 3 x 3 taps over 48 = 4 x 4 x 3 channels (the rearrangement and the map
// back to (11, 11, 3, 96) are torch code outside the kernel, as they are
// outside the Pallas call):
//   dW[(ky*3 + kx)*48 + ch, co] = sum_{n,p,q} X[n, p+ky, q+kx, ch] * G[n, p, q, co]
// X is (N, OH+2, OW+2, 48); once flattened per image to rows of 48
// channels, with G laid out on the same (OH+2) x (OW+2) grid, tap
// (ky, kx) pairs G row r with X row r + ky*(OW+2) + kx.  The products run
// in the input dtype and accumulate in float32.
//
// Bound on this card: memory.  At the training shape (2048 frames of
// 227x227x3 and a 2048x57x57x96 gradient, bf16) the function must read
// 1.9 GB (0.57 ms at 3.35 TB/s) and does 2*363*96*2048*57*57 = 4.6e11
// operations (0.47 ms at the 989 TFLOP/s bf16 tensor-core peak).  On the
// CUDA cores the same products would take ~8 ms, so bf16 runs on the
// tensor cores (ldmatrix, mma.sync); float32 runs on the CUDA cores, for
// the float32 checks only.
//
// Design.  Both entry points take the same operands, X and the unpadded
// G (N, OH, OW, 96), and differ only in how positions are split across
// blocks: conv1_dw gives each block whole images, conv1_dw_shifted a range
// of flattened rows.  A block walks its range in tiles of kTile positions.
// Per tile it stages the G rows of its positions (zero on the two pad rows
// and columns of each image, by bounds tests, so G is never copied into
// a padded buffer) and the X rows [r0, r0 + kTile + 2*(OW+2) + 2) in
// shared memory: in memory a shifted tap is an offset into that window, so
// the side array of row heads the TPU kernel gathered is not needed.  Two
// stages: cp.async copies the next tile while the current one is
// multiplied.  G rows are padded by
// 16 bytes in shared memory, so the eight rows one ldmatrix reads fall in
// different banks (unpadded, 192-byte rows put four of them on the same
// banks, and the B loads ran at a quarter of the shared-memory rate).
// The bf16 X rows are padded the same way; ldmatrix needs 16-byte
// alignment only, so any tap offset may start a fragment (WMMA's loads
// need 32 bytes, and compiled to generic loads here).  bf16: each of the
// 27 warps owns one (tap, 16-channel) slice of the 432 output rows and all
// 96 columns, i.e. twelve m16n8 float32 accumulators held in registers
// across the whole range; per 16 positions it loads its A fragment (X rows
// at its tap's offset, transposed by ldmatrix) once and multiplies it by
// the twelve B fragments of G.  float32: each thread owns one output row
// and half of its columns.  The TPU kept one (432, 96) accumulator
// resident across a grid that runs in order; blocks here run in no order,
// so each block
// writes its own (432, 96) float32 partial, and a second kernel adds the
// partials in block order.  No atomics: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kCin = 48;                // s2d channels: 4 x 4 pixels x 3
constexpr int kCout = 96;
constexpr int kTaps = 9;                // 3 x 3 s2d taps
constexpr int kRows = kTaps * kCin;     // 432 rows of the s2d gradient
constexpr int kOut = kRows * kCout;     // floats in one partial
constexpr int kTile = 128;              // positions per staged tile
constexpr int kWarps = 27;              // bf16: one (tap, m tile) per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kFrags = kCout / 16;      // bf16: 16-column slices a warp owns
constexpr int kCols = kCout / 2;        // float32: columns a thread owns
static_assert(kWarps == kTaps * (kCin / 16), "one warp per (tap, m tile)");
static_assert(kThreads == 2 * kRows, "float32: two threads per output row");

struct Geometry {
  long long k;      // positions: images x (oh + 2) x (ow + 2)
  long long s;      // positions per image
  int oh, ow, w2;   // conv output height and width; w2 = ow + 2
};

// Shared-memory row strides (elements).  G rows, and the bf16 X rows, are
// staged with 16 bytes of padding, so the eight 16-byte rows that one
// ldmatrix (or a float4 load) reads from 8 consecutive positions fall in
// different banks.  float32 X is read one channel per lane: no padding.
template <typename T>
__host__ __device__ constexpr int g_stride() {
  return kCout + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int x_stride() {
  return sizeof(T) == 2 ? kCin + 8 : kCin;
}

__device__ __forceinline__ int tap_offset(int tap, int w2) {
  return (tap / 3) * w2 + tap % 3;
}

__host__ __device__ __forceinline__ int window_rows(int w2) {
  return kTile + 2 * w2 + 2;
}

// elements of one pipeline stage: the X window, then the G tile
template <typename T>
__host__ __device__ __forceinline__ int stage_elems(int w2) {
  return window_rows(w2) * x_stride<T>() + kTile * g_stride<T>();
}

// Positions [begin, end) of this block: per_block images (conv1_dw) or
// per_block flattened rows (conv1_dw_shifted, kByRows).
template <bool kByRows>
__device__ __forceinline__ void block_range(const Geometry& geo,
                                            long long per_block,
                                            long long* begin,
                                            long long* end) {
  const long long units = kByRows ? per_block : per_block * geo.s;
  *begin = static_cast<long long>(blockIdx.x) * units;
  *end = min(*begin + units, geo.k);
}

// 16-byte asynchronous copy global -> shared; zeros when !valid (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying X rows [r0, r0 + window) (zero past the last row) and the
// G rows of positions [r0, r0 + kTile) (zero at and past `end`, and on the
// two pad rows and columns of each image) into one stage.
template <typename T>
__device__ __forceinline__ void stage_tile(T* stage,
                                           const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           long long r0, long long end,
                                           const Geometry& geo) {
  constexpr int kVec = 16 / sizeof(T);     // elements in one 16-byte copy
  constexpr int kXVecs = kCin / kVec;      // copies per X row
  constexpr int kGVecs = kCout / kVec;     // copies per G row
  T* xs = stage;
  T* gs = stage + window_rows(geo.w2) * x_stride<T>();
  const int xn = window_rows(geo.w2) * kXVecs;
  for (int i = threadIdx.x; i < xn; i += kThreads) {
    const int row = i / kXVecs;
    const int v = i - row * kXVecs;
    const long long r = r0 + row;
    const bool ok = r < geo.k;
    cp_async16(xs + row * x_stride<T>() + v * kVec,
               ok ? x + r * kCin + v * kVec : x, ok);
  }
  const long long n0 = r0 / geo.s;   // image and offset of the tile's start
  const int rem0 = static_cast<int>(r0 - n0 * geo.s);
  for (int i = threadIdx.x; i < kTile * kGVecs; i += kThreads) {
    const int row = i / kGVecs;
    const int v = i - row * kGVecs;
    bool ok = r0 + row < end;
    const T* src = g;
    if (ok) {
      long long n = n0;
      int rem = rem0 + row;
      while (rem >= geo.s) {         // at most once when s > kTile
        rem -= static_cast<int>(geo.s);
        ++n;
      }
      const int p = rem / geo.w2;
      const int q = rem - p * geo.w2;
      ok = p < geo.oh && q < geo.ow;
      if (ok) src = g + ((n * geo.oh + p) * geo.ow + q) * kCout + v * kVec;
    }
    cp_async16(gs + row * g_stride<T>() + v * kVec, src, ok);
  }
}

// Walk the block's positions in tiles, two stages deep: the copies of
// tile t + 1 run while tile t is multiplied.  compute(xs, gs) reads one
// staged tile.
template <typename T, bool kByRows, typename Compute>
__device__ __forceinline__ void pipeline(T* smem, const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         const Geometry& geo,
                                         long long per_block,
                                         Compute compute) {
  long long begin, end;
  block_range<kByRows>(geo, per_block, &begin, &end);
  const int stage = stage_elems<T>(geo.w2);
  if (begin < end) stage_tile<T>(smem, x, g, begin, end, geo);
  cp_async_commit();
  int s = 0;
  for (long long r0 = begin; r0 < end; r0 += kTile, s ^= 1) {
    if (r0 + kTile < end)
      stage_tile<T>(smem + (s ^ 1) * stage, x, g, r0 + kTile, end, geo);
    cp_async_commit();
    cp_async_wait_all_but_one();     // this thread's copies of tile r0
    __syncthreads();                 // everyone's
    T* xs = smem + s * stage;
    compute(xs, xs + window_rows(geo.w2) * x_stride<T>());
    __syncthreads();                 // done reading before it is refilled
  }
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 tiles, transposed on the way: lane i gives the address of
// row i % 8 of tile i / 8; tile j lands in r[j].
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kByRows>
__global__ void __launch_bounds__(kThreads, 1)
conv1_dw_bf16(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ g, float* __restrict__ partial,
              Geometry geo, long long per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kX = x_stride<__nv_bfloat16>();
  constexpr int kG = g_stride<__nv_bfloat16>();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tap = warp / 3;
  const int mt = warp % 3;
  const int off = tap_offset(tap, geo.w2);
  // The warp's A (16 channels x 16 positions) is its tap's X rows, stored
  // position-major: tile j of the x4 load covers positions (j / 2) * 8
  // and channels (j % 2) * 8, so the transposed tiles are a0..a3 of the
  // m16n8k16 fragment.  Each x4 load of G covers positions (j % 2) * 8
  // and columns (j / 2) * 8: the b fragments of two 8-column tiles.
  const int a_off = ((off + (lane / 16) * 8 + lane % 8) * kX + mt * 16 +
                     ((lane / 8) % 2) * 8) * 2;
  const int b_off = ((((lane / 8) % 2) * 8 + lane % 8) * kG +
                     (lane / 16) * 8) * 2;

  float acc[2 * kFrags][4];
#pragma unroll
  for (int t = 0; t < 2 * kFrags; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  pipeline<__nv_bfloat16, kByRows>(
      reinterpret_cast<__nv_bfloat16*>(smem), x, g, geo, per_block,
      [&](const __nv_bfloat16* xs, const __nv_bfloat16* gs) {
        const unsigned xa = shared_addr(xs) + a_off;
        const unsigned ga = shared_addr(gs) + b_off;
#pragma unroll 2
        for (int ks = 0; ks < kTile / 16; ++ks) {
          unsigned a[4];
          ldmatrix_x4_trans(a, xa + ks * 16 * kX * 2);
#pragma unroll
          for (int nb = 0; nb < kFrags; ++nb) {
            unsigned b[4];
            ldmatrix_x4_trans(b, ga + (ks * 16 * kG + nb * 16) * 2);
            mma_bf16(acc[2 * nb], a, b[0], b[1]);
            mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
          }
        }
      });
  // c0, c1: row lane / 4, columns 2 * (lane % 4) + {0, 1}; c2, c3: row + 8
  float* out = partial + static_cast<long long>(blockIdx.x) * kOut +
               (tap * kCin + mt * 16 + lane / 4) * kCout + 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 2 * kFrags; ++t) {
    *reinterpret_cast<float2*>(out + t * 8) = make_float2(acc[t][0],
                                                          acc[t][1]);
    *reinterpret_cast<float2*>(out + 8 * kCout + t * 8) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

template <bool kByRows>
__global__ void __launch_bounds__(kThreads, 1)
conv1_dw_f32(const float* __restrict__ x, const float* __restrict__ g,
             float* __restrict__ partial, Geometry geo, long long per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row = threadIdx.x / 2;            // tap * 48 + channel
  const int half = threadIdx.x % 2;           // columns half * 48 ...
  const int tap = row / kCin;
  const int ch = row - tap * kCin;
  const int off = tap_offset(tap, geo.w2);
  constexpr int kG = g_stride<float>();

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  pipeline<float, kByRows>(
      reinterpret_cast<float*>(smem), x, g, geo, per_block,
      [&](const float* xs, const float* gs) {
        const float* xcol = xs + off * kCin + ch;
        for (int k = 0; k < kTile; ++k) {
          const float a = xcol[k * kCin];
          const float4* gv =
              reinterpret_cast<const float4*>(gs + k * kG + half * kCols);
#pragma unroll
          for (int j = 0; j < kCols / 4; ++j) {
            const float4 b = gv[j];
            acc[4 * j] = fmaf(a, b.x, acc[4 * j]);
            acc[4 * j + 1] = fmaf(a, b.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(a, b.z, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(a, b.w, acc[4 * j + 3]);
          }
        }
      });
  float* out = partial + static_cast<long long>(blockIdx.x) * kOut +
               row * kCout + half * kCols;
#pragma unroll
  for (int j = 0; j < kCols; ++j) out[j] = acc[j];
}

// out[i] = sum over blocks b, in order, of partial[b][i]
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out, int nblocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kOut) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b)
    s = __fadd_rn(s, partial[static_cast<long long>(b) * kOut + i]);
  out[i] = s;
}

template <typename T, bool kByRows>
constexpr auto kernel_for() {
  if constexpr (std::is_same<T, float>::value)
    return &conv1_dw_f32<kByRows>;
  else
    return &conv1_dw_bf16<kByRows>;
}

template <typename T, bool kByRows>
int launch(const void* x, const void* g, void* partial, void* out,
           long long n, int oh, int ow, long long per_block, int nblocks,
           cudaStream_t stream) {
  Geometry geo;
  geo.oh = oh;
  geo.ow = ow;
  geo.w2 = ow + 2;
  geo.s = static_cast<long long>(oh + 2) * geo.w2;
  geo.k = n * geo.s;
  const long long units = kByRows ? geo.k : n;
  if (per_block <= 0 || nblocks <= 0 ||
      (units + per_block - 1) / per_block != nblocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_for<T, kByRows>();
  // two stages exceed the default 48 KB: opt in once to what the device
  // allows a block
  static int smem_limit = -1;
  if (smem_limit < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kernel),
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
    if (err != cudaSuccess) {
      smem_limit = -1;
      return static_cast<int>(err);
    }
  }
  const size_t smem = 2 * static_cast<size_t>(stage_elems<T>(geo.w2)) *
                      sizeof(T);
  if (smem > static_cast<size_t>(smem_limit))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(partial), geo, per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<(kOut + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kByRows>
int dispatch(const void* x, const void* g, void* partial, void* out,
             long long n, int oh, int ow, int dtype, long long per_block,
             int nblocks, void* stream) {
  if (n <= 0 || oh <= 0 || ow <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kByRows>(x, g, partial, out, n, oh, ow, per_block,
                                  nblocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kByRows>(x, g, partial, out, n, oh, ow,
                                          per_block, nblocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xp: contiguous (n, oh+2, ow+2, 48) space-to-depth frames; g: contiguous
// (n, oh, ow, 96), both float32 (dtype 0) or bfloat16 (dtype 1).  Blocks
// own images_per_block images each; nblocks = ceil(n / images_per_block).
// partial: (nblocks, 432, 96) float32 scratch; out: (432, 96) float32.
// Returns cudaGetLastError() after the launches.
extern "C" int vlt_conv1_dw(const void* xp, const void* g, void* partial,
                            void* out, long long n, int oh, int ow,
                            int dtype, long long images_per_block,
                            int nblocks, void* stream) {
  return dispatch<false>(xp, g, partial, out, n, oh, ow, dtype,
                         images_per_block, nblocks, stream);
}

// The same operands, read as n*(oh+2)*(ow+2) flattened rows of xp; blocks
// own rows_per_block rows each; nblocks = ceil(rows / rows_per_block).
// partial and out as above.
extern "C" int vlt_conv1_dw_shifted(const void* xp, const void* g,
                                    void* partial, void* out, long long n,
                                    int oh, int ow, int dtype,
                                    long long rows_per_block, int nblocks,
                                    void* stream) {
  return dispatch<true>(xp, g, partial, out, n, oh, ow, dtype,
                        rows_per_block, nblocks, stream);
}
