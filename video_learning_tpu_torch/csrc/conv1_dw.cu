// Weight gradient of the AlexNet stem conv (11x11, stride 4, SAME, 3 -> 96
// channels), for Hopper (sm_90a).  Two entry points, one per TPU kernel:
//
//   vlt_conv1_dw          replaces video_learning_tpu/ops/pallas_kernels.py
//                         `conv1_dw` (kernel body `_conv1_dw_kernel`)
//   vlt_conv1_dw_shifted  replaces `conv1_dw_shifted` (kernel body
//                         `_conv1_dw_shift_kernel`)
//
// Computes, in the space-to-depth (s2d) domain where the conv has stride 1
// and 3 x 3 taps over 48 = 4 x 4 x 3 channels,
//   dW[(ky*3 + kx)*48 + ch, co] = sum_{n,p,q} X[n, p+ky, q+kx, ch] * G[n, p, q, co]
// over the gradient's real positions (p < OH, q < OW), where s2d position
// (n, P, Q), channel (di*4 + dj)*3 + c is frame pixel (4P + di - top,
// 4Q + dj - left, c), zero outside the frame.  The kernel reads the raw
// (N, H, W, 3) frames and builds the s2d rows itself: no s2d tensor exists
// in device memory.  The products run in the input dtype and accumulate in
// float32; the map back to (11, 11, 3, 96) is torch code outside.
//
// Bound on this card.  At the training shape (2048 frames of 227x227x3 and
// a 2048x57x57x96 gradient, bf16) the function must read 1.91 GB (0.570 ms
// at 3.35 TB/s) and does 2*432*96*2048*57*57 = 5.5e11 operations in this
// s2d form (0.56 ms at the 989 TFLOP/s bf16 tensor-core peak): it is bound
// by bytes and by the tensor cores about equally, so the bf16 contraction
// runs on wgmma; float32 runs on the CUDA cores, for float32 checks only.
//
// Design.  Blocks own ranges of gradient rows (n, p), flattened over the
// batch (one block per SM by default): conv1_dw_shifted splits the rows
// evenly, conv1_dw in whole images; the kernel is the same.  A block walks
// its range in tiles of up to R gradient rows of one image (R*OW
// positions, padded to a multiple of 16 with positions that read a zero
// s2d row; R = 5 at OW = 57).  Per tile it stages in shared memory:
//  - the G rows, laid out for the contraction: bf16 by TMA, from a 2-D
//    tensor map over G's (positions, 96) with boxes of 32 columns in its
//    64-byte swizzle, which is wgmma's N-major 64-byte swizzled layout (at
//    2048 frames the copies and rearrangement alone take 0.63 ms so; 0.78
//    ms with boxes of 8 columns in 16-byte core matrices; per-thread
//    16-byte cp.async copies streamed at about 1.2 TB/s beside the
//    multiplications); float32 by 16-byte cp.async copies;
//  - the s2d rows the tile's taps read, p .. p + R + 1, in a ring of
//    R + 2 rows: a tile after another in the same image keeps the last
//    two and stages R new ones, so each frame row crosses L2 once per
//    block.  The new rows' frame rows are one contiguous byte range,
//    copied (bf16: by one bulk copy) as the 16-byte aligned range that
//    covers it (a bf16 frame row is 1,362 bytes: neither rows nor images
//    are 16-byte aligned), then rearranged by the threads into s2d
//    positions: a thread reads a position's 4 x 12 elements (4 pixels x 3
//    channels of each of its 4 frame rows), shifting by 2 bytes where a
//    row's range is not 4-byte aligned, and writes it as 6 whole 16-byte
//    chunks (narrower stores of 12-element runs ran 4-way bank-conflicted
//    and 20% slower).  bf16 positions are 96 bytes with their chunks
//    swizzled (chunk ^ bit 2 of the position), so that the eight positions
//    one ldmatrix reads fall in different banks;
//  - once per block, a table of the ring row each position of a tile
//    reads at each tap row, relative to the tile's first row.
// Tile t + 1's G copies start before tile t's rearrangement, its frame
// rows after it, and both land while tile t is multiplied (bf16: one
// thread issues them and an mbarrier counts their bytes in).  Spreading
// the rearrangement between the wgmmas of the tile before, over a ring of
// two tiles' rows, ran 5% slower: it contends for shared memory.
//
// bf16 contraction on wgmma.  Of the 432 s2d rows the (11, 11) kernel
// needs 363; with the channels of a position in the bf16 slot order,
// they fill 48 chunks of 8 (`kPairs`), 384 rows: 6 m64 tiles.  A m64n96
// float32 accumulator takes 48 registers a thread (a wgmma needs 78 at
// least), so the block has 3 warpgroups of up to 168 registers a thread
// and warpgroup i owns tiles 2i and 2i + 1.  Each warp's 16 rows of a tile
// are two (tap, chunk) pairs: per 16 positions it loads its A fragment
// with ldmatrix.trans from the ring rows of each pair's tap (a row address
// per lane, so any tap shift and any position walk work), and the
// warpgroup issues one wgmma m64n96k16 per tile with A from registers and
// G as B from shared memory (N-major: transposed B).  The tensor cores
// read G once per tile, 6 times per 16 positions, where the mma.sync
// design this replaces re-read it in each of its 27 warps.  Two sets of A
// fragments alternate, so the next loads while the wgmmas run.  wgmma's
// float32 sums do not round to nearest, and their error grows with the
// accumulator (at 2048 frames a block's 50,000 positions in one
// accumulator missed the plain version by 5x its tolerance), so every
// kFlush tiles each warp adds its accumulators into the block's partial
// (round to nearest, in order) and starts again from zero; the tile before
// a flush prefetches that partial into L2.
//
// float32 contraction: each of 864 threads owns one of the 432 rows and
// half of its columns, on the CUDA cores (the channels in natural order).
//
// The TPU kept one (432, 96) accumulator resident across a grid that runs
// in order; blocks here run in no order, so each block writes its own
// float32 partial, and a second kernel adds the partials in block order.
// No atomics: two runs give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCin = 48;                // s2d channels: 4 x 4 pixels x 3
constexpr int kCout = 96;
constexpr int kTaps = 9;                // 3 x 3 s2d taps
constexpr int kRows = kTaps * kCin;     // 432 rows of the s2d gradient
constexpr int kOut = kRows * kCout;     // floats in one partial
constexpr int kWarpsBf16 = 12;          // 3 warpgroups of 2 m64 tiles
constexpr int kThreadsBf16 = 32 * kWarpsBf16;
constexpr int kThreadsF32 = 2 * kRows;  // two threads per output row
constexpr int kCols = kCout / 2;        // float32: columns a thread owns

// bf16 s2d positions hold their 48 channels in the "bf16 slot" order, so
// that the channels each tap needs fill whole 16-byte chunks: the
// kernel's taps reach rows and columns 0..11 of a 12 x 12 kernel, and the
// (11, 11) kernel leaves out row 11 (di = 3 of tap row 2) and column 11
// (dj = 3 of tap column 2).  Slots 0..11: pixels (3, 0..3) of frame row
// di = 3; 12..14: pixel (2, 2); 15..23: pixels (0..2, 3); 24..47: pixels
// (di, dj) with 3 di + dj = 0..7 (each pixel's 3 channels in order).
// Chunk 0 is pixels (3, 0..2) only, chunk 2 pixels (0..2, 3) only, chunks
// 3..5 pixels with di, dj <= 2.  slot_word writes this order, and
// ops/conv1_dw.py (_bf16_slot) reads it.

// The (tap, chunk) pairs whose channels the (11, 11) kernel needs, as tap
// * 6 + chunk: chunks 0..5 of taps with ky, kx < 2, all but chunk 0 (di =
// 3) of tap row 2, all but chunk 2 (dj = 3) of tap column 2.  48 chunks of
// 8 channels: 384 rows, 6 wgmma m64 tiles, against 432 rows (7 tiles) for
// all 9 x 48.  Warp slice s is pairs 2s and 2s + 1.  ops/conv1_dw.py maps
// the rows back to (11, 11, 3, 96) from the same layout.
__constant__ unsigned char kPairs[48] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 33,
    34, 35, 37, 38, 39, 40, 41, 43, 44, 45, 46, 47, 49, 51, 52, 53};
constexpr int kRowsBf16 = 384;

// Positions a tile may hold (before rounding to 16), by dtype: the bf16
// tiles are as large as shared memory allows at the training shape (5
// rows of 57), the float32 ones one row.
template <typename T>
constexpr int max_tile_positions() {
  return sizeof(T) == 2 ? 288 : 64;
}

struct Geometry {
  int h, w;           // frame height and width
  int oh, ow;         // gradient height and width
  int top, left;      // SAME padding above and left of the frame
  int xrow;           // ow + 2: positions in a staged s2d row
  int rows_tile;      // R: gradient rows per tile
  int kp;             // positions per G stage: R*ow rounded up to 16
                      // (to 32 past 256, for two TMA boxes)
  int ring;           // R + 2 staged s2d rows
  int raw_bytes;      // capacity of the frame-row buffer
  int q_bits;         // 2^q_bits >= xrow: threads per staged row
  int box;            // bf16: positions per TMA box (kp / box boxes)
  long long g_rows;   // n * oh
  long long per_block;  // gradient rows per block
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory, in bytes from its start (every part a multiple of 16):
// two G stages, the s2d ring and after it one zero position (the row
// padding positions read), the frame-row buffer, the tap table, an
// mbarrier.
struct Layout {
  int ring, raw, tab, bar, total;
};

template <typename T>
__host__ __device__ int g_stage_bytes(const Geometry& geo) {
  return geo.kp * kCout * static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ Layout layout(const Geometry& geo) {
  constexpr int pos = kCin * static_cast<int>(sizeof(T));
  Layout l;
  l.ring = 2 * g_stage_bytes<T>(geo);
  l.raw = l.ring + (geo.ring * geo.xrow + 1) * pos;
  l.tab = l.raw + geo.raw_bytes;
  l.bar = l.tab + round16(3 * geo.kp * 4);
  l.total = l.bar + 16;
  return l;
}

// One tile: gradient rows p .. p + nr - 1 of image n, the first at
// flattened row g; its s2d rows p .. p + nr + 1, of which rows from
// `fresh` on are staged for it (the others the previous tile left).
struct Tile {
  long long g;
  int n, p, nr, fresh;
};

__device__ __forceinline__ Tile make_tile(const Geometry& geo, long long g,
                                          long long begin, long long end) {
  Tile t;
  t.g = g;
  t.n = static_cast<int>(g / geo.oh);
  t.p = static_cast<int>(g - static_cast<long long>(t.n) * geo.oh);
  t.nr = static_cast<int>(min(static_cast<long long>(geo.rows_tile),
                              min(static_cast<long long>(geo.oh - t.p),
                                  end - g)));
  t.fresh = (g == begin || t.p == 0) ? t.p : t.p + 2;
  return t;
}

// Frame rows [r0, r1) of the s2d rows a tile stages, and where their bytes
// start in the frame-row buffer (the copy starts at the 16-byte boundary
// at or below the first byte).
struct RawRange {
  int r0, r1, shift;
  const unsigned char* aligned;
  int chunks;
};

template <typename T>
__device__ __forceinline__ RawRange raw_range(const Geometry& geo,
                                              const T* x, const Tile& t) {
  RawRange rr;
  rr.r0 = max(4 * t.fresh - geo.top, 0);
  rr.r1 = min(4 * (t.p + t.nr + 2) - geo.top, geo.h);
  const long long row_bytes = 3LL * geo.w * sizeof(T);
  const unsigned char* first = reinterpret_cast<const unsigned char*>(x) +
                               (static_cast<long long>(t.n) * geo.h + rr.r0) *
                                   row_bytes;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15);
  rr.aligned = reinterpret_cast<const unsigned char*>(lo);
  rr.shift = static_cast<int>(reinterpret_cast<uintptr_t>(first) - lo);
  rr.chunks = rr.r1 > rr.r0
                  ? static_cast<int>((rr.shift + (rr.r1 - rr.r0) * row_bytes +
                                      15) / 16)
                  : 0;
  return rr;
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

// float32 staging: 16-byte cp.async copies by every thread of a tile's
// new frame rows and of its G rows (position-major rows of 96 values,
// zero past the tile) into G stage gs.
template <int kThreads>
struct AsyncCopies {
  __device__ void issue_g(const Geometry& geo, const float* __restrict__,
                          const float* __restrict__ g, const Tile& t,
                          unsigned char* gs) {
    const int npos = t.nr * geo.ow;
    const float* g0 = g + t.g * geo.ow * kCout;
    constexpr int kVecs = kCout / 4;              // chunks per position
    for (int c = threadIdx.x; c < geo.kp * kVecs; c += kThreads) {
      const int k = c / kVecs;
      const bool ok = k < npos;
      cp_async16(gs + 16 * c, ok ? g0 + k * kCout + (c - k * kVecs) * 4 : g,
                 ok);
    }
  }
  __device__ void issue_raw(const Geometry& geo, const float* __restrict__ x,
                            const Tile& t, unsigned char* raw) {
    const RawRange rr = raw_range<float>(geo, x, t);
    for (int i = threadIdx.x; i < rr.chunks; i += kThreads)
      cp_async16(raw + 16 * i, rr.aligned + 16 * i, true);
    cp_async_commit();
  }
  // this thread's copies have landed
  __device__ void wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bf16 staging: thread 0 asks an mbarrier for the tile's bytes and starts
// TMA loads of its G rows (box b, column third c: positions b * box ..,
// columns 32c .. 32c + 31, landing at gs + (b * 3 + c) * box * 64 in rows
// of 64 bytes, swizzled; positions past the tile are the next rows' G, or
// zeros past the tensor, and meet the zero s2d row), later one bulk copy
// of its new frame rows.  Every thread then waits for the barrier's
// phase.
struct TmaCopies {
  const CUtensorMap* map;
  unsigned bar;
  unsigned phase;
  __device__ void issue_g(const Geometry& geo,
                          const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__, const Tile& t,
                          unsigned char* gs) {
    if (threadIdx.x != 0) return;
    const unsigned bytes = geo.kp * kCout * 2 +
                           raw_range<__nv_bfloat16>(geo, x, t).chunks * 16;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    const int first = static_cast<int>(t.g * geo.ow);
    for (int b = 0; b < geo.kp / geo.box; ++b)
      for (int c = 0; c < kCout / 32; ++c)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                shared_addr(gs + (b * 3 + c) * geo.box * 64)),
            "l"(reinterpret_cast<uint64_t>(map)), "r"(32 * c),
            "r"(first + b * geo.box), "r"(bar)
            : "memory");
  }
  __device__ void issue_raw(const Geometry& geo,
                            const __nv_bfloat16* __restrict__ x, const Tile& t,
                            unsigned char* raw) {
    if (threadIdx.x != 0) return;
    const RawRange rr = raw_range<__nv_bfloat16>(geo, x, t);
    if (rr.chunks > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(raw)),
          "l"(rr.aligned), "r"(rr.chunks * 16), "r"(bar)
          : "memory");
  }
  __device__ void wait() {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    phase ^= 1u;
  }
};

// The 24 words (48 slots) of a bf16 position, in the bf16 slot order,
// from its 4 frame rows' 12 elements each (w[di][i]: elements 2i and
// 2i + 1 of row di, the first in the low half).
__device__ __forceinline__ unsigned slot_word(const unsigned (&w)[4][6],
                                              int k) {
  auto mid = [](unsigned lo, unsigned hi) {    // lo's high, hi's low half
    return __byte_perm(lo, hi, 0x5432);
  };
  switch (k) {
    case 6: return w[2][3];                        // 12, 13: (2, 2) c0 c1
    case 7: return __byte_perm(w[2][4], w[0][4], 0x7610);  // (2,2) c2, (0,3) c0
    case 8: return w[0][5];                        // 16, 17: (0, 3) c1 c2
    case 9: return mid(w[1][4], w[1][5]);          // 18, 19: (1, 3) c0 c1
    case 10: return __byte_perm(w[1][5], w[2][4], 0x7632); // (1,3) c2, (2,3) c0
    case 11: return w[2][5];                       // 22, 23: (2, 3) c1 c2
    case 16: return __byte_perm(w[0][4], w[1][0], 0x5410); // (0,2) c2, (1,0) c0
    case 17: case 18: case 19: case 20:            // 34 .. 41: row 1
      return mid(w[1][k - 17], w[1][k - 16]);
    default:
      if (k < 6) return w[3][k];                   // 0 .. 11: row 3
      if (k < 16) return w[0][k - 12];             // 24 .. 31: row 0
      return w[2][k - 21];                         // 42 .. 47: row 2
  }
}

// Rearranging a tile's new frame rows (landed in `raw`) into its new s2d
// rows of the ring, as items (row, q): position q of an s2d row, its 4
// frame rows di one after another (2^q_bits items to a row, so no index
// needs a division).
template <typename T>
struct Rearrange {
  Tile t;
  RawRange rr;
  int items;
  int slot0;                     // ring slot of row `fresh`

  __device__ Rearrange(const Geometry& geo, const T* x, const Tile& tile)
      : t(tile), rr(raw_range<T>(geo, x, tile)),
        items((tile.p + tile.nr + 2 - tile.fresh) << geo.q_bits),
        slot0((tile.n * (geo.oh + 2) + tile.fresh) % geo.ring) {}

  // the 12 elements (pixels 4q - left .. + 3, 3 channels) of frame row
  // 4P + di - top, as words (element 2i the low half of word i in bf16)
  __device__ __forceinline__ void segment(const Geometry& geo, int P, int q,
                                          int di, const unsigned char* raw,
                                          unsigned* words) const {
    const int ry = 4 * P + di - geo.top;
    const int px0 = 4 * q - geo.left;
    const bool row_in = ry >= 0 && ry < geo.h;
    const int at = rr.shift +
                   ((ry - rr.r0) * geo.w + px0) * 3 * static_cast<int>(sizeof(T));
    if (!row_in) {
#pragma unroll
      for (int i = 0; i < (sizeof(T) == 2 ? 6 : 12); ++i) words[i] = 0u;
    } else if (px0 >= 0 && px0 + 4 <= geo.w) {
      const unsigned* src = reinterpret_cast<const unsigned*>(raw) + (at >> 2);
      if constexpr (sizeof(T) == 2) {
        if (at & 2) {
#pragma unroll
          for (int i = 0; i < 6; ++i)
            words[i] = __funnelshift_r(src[i], src[i + 1], 16);
        } else {
#pragma unroll
          for (int i = 0; i < 6; ++i) words[i] = src[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 12; ++i) words[i] = src[i];
      }
    } else {                          // the frame's left or right edge
      if constexpr (sizeof(T) == 2) {
        const unsigned short* src =
            reinterpret_cast<const unsigned short*>(raw + at);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          unsigned pair = 0u;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 2 * i + e;
            const int px = px0 + m / 3;
            if (px >= 0 && px < geo.w)
              pair |= static_cast<unsigned>(src[m]) << (16 * e);
          }
          words[i] = pair;
        }
      } else {
        const unsigned* src = reinterpret_cast<const unsigned*>(raw + at);
#pragma unroll
        for (int m = 0; m < 12; ++m) {
          const int px = px0 + m / 3;
          words[m] = px >= 0 && px < geo.w ? src[m] : 0u;
        }
      }
    }
  }

  __device__ void item(const Geometry& geo, int it, unsigned char* ring,
                       const unsigned char* raw) const {
    const int q = it & ((1 << geo.q_bits) - 1);
    if (q >= geo.xrow) return;
    const int r = it >> geo.q_bits;
    const int slot = slot0 + r < geo.ring ? slot0 + r : slot0 + r - geo.ring;
    const int row = slot * geo.xrow + q;
    if constexpr (sizeof(T) == 2) {
      // the position's 6 chunks, whole, in the bf16 slot order (chunk k
      // at k ^ swz)
      unsigned w[4][6];
#pragma unroll
      for (int di = 0; di < 4; ++di)
        segment(geo, t.fresh + r, q, di, raw, w[di]);
      unsigned char* pos = ring + row * 96;
      const int swz = (row >> 2) & 1;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        *reinterpret_cast<uint4*>(pos + ((k ^ swz) << 4)) =
            make_uint4(slot_word(w, 4 * k), slot_word(w, 4 * k + 1),
                       slot_word(w, 4 * k + 2), slot_word(w, 4 * k + 3));
    } else {
#pragma unroll
      for (int di = 0; di < 4; ++di) {
        unsigned w[12];
        segment(geo, t.fresh + r, q, di, raw, w);
        uint4* pos = reinterpret_cast<uint4*>(ring + row * 192 + di * 48);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          pos[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2],
                              w[4 * j + 3]);
      }
    }
  }

  template <int kThreads>
  __device__ void all(const Geometry& geo, unsigned char* ring,
                      const unsigned char* raw) const {
    for (int it = threadIdx.x; it < items; it += kThreads)
      item(geo, it, ring, raw);
  }
};

// The tap table: tab[ky * kp + k] is the ring row, counted from a tile's
// first s2d row, that position k of a full tile reads at tap row ky (for
// a tile whose first row sits in ring slot s0, add s0 * xrow modulo
// ring * xrow).  Positions past a tile's own read the zero row instead.
template <int kThreads>
__device__ __forceinline__ void build_table(const Geometry& geo, int* tab) {
  const int npos = geo.rows_tile * geo.ow;
  for (int e = threadIdx.x; e < 3 * geo.kp; e += kThreads) {
    const int ky = e / geo.kp;
    const int k = e - ky * geo.kp;
    const int i = k < npos ? k / geo.ow : 0;
    const int q = k < npos ? k - i * geo.ow : 0;
    tab[e] = (i + ky) * geo.xrow + q;
  }
}

// the ring row a table entry names for a tile whose first row is at
// s0x = s0 * xrow
__device__ __forceinline__ int ring_row(int entry, int s0x,
                                        const Geometry& geo) {
  const int row = entry + s0x;
  const int wrap = geo.ring * geo.xrow;
  return row >= wrap ? row - wrap : row;
}

// Gradient rows [begin, end) of this block: per_block rows (kByRows) or
// per_block images.
template <bool kByRows>
__device__ __forceinline__ void block_range(const Geometry& geo,
                                            long long* begin,
                                            long long* end) {
  const long long units = kByRows ? geo.per_block : geo.per_block * geo.oh;
  *begin = static_cast<long long>(blockIdx.x) * units;
  *end = min(*begin + units, geo.g_rows);
}

// Walk the block's tiles: tile t + 1's G copies start before tile t's
// rearrangement, its frame rows after it, and both run while tile t is
// multiplied (compute(tile, G stage, ring, tab, s0x), s0x the ring row of
// the tile's first s2d row).
template <typename T, bool kByRows, int kThreads, typename Copies,
          typename Compute>
__device__ __forceinline__ void walk_tiles(unsigned char* smem,
                                           const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           const Geometry& geo,
                                           Copies& copies, Compute compute) {
  long long begin, end;
  block_range<kByRows>(geo, &begin, &end);
  if (begin >= end) return;
  const Layout l = layout<T>(geo);
  unsigned char* gs = smem;
  unsigned char* ring = smem + l.ring;
  unsigned char* raw = smem + l.raw;
  int* tab = reinterpret_cast<int*>(smem + l.tab);
  const int stage = g_stage_bytes<T>(geo);
  // the zero position after the ring
  uint4* zero = reinterpret_cast<uint4*>(raw) - kCin * sizeof(T) / 16;
  for (int i = threadIdx.x; i < static_cast<int>(kCin * sizeof(T) / 16);
       i += kThreads)
    zero[i] = make_uint4(0u, 0u, 0u, 0u);
  build_table<kThreads>(geo, tab);
  Tile cur = make_tile(geo, begin, begin, end);
  copies.issue_g(geo, x, g, cur, gs);
  copies.issue_raw(geo, x, cur, raw);
  int s = 0;
  for (;;) {
    copies.wait();
    __syncthreads();               // tile t landed; tile t - 1 was read
    const long long next = cur.g + cur.nr;
    const Tile nt = make_tile(geo, next < end ? next : begin, begin, end);
    if (next < end) copies.issue_g(geo, x, g, nt, gs + (s ^ 1) * stage);
    Rearrange<T>(geo, x, cur).template all<kThreads>(geo, ring, raw);
    // the rearrangement's reads of `raw` come before the next copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (next < end) copies.issue_raw(geo, x, nt, raw);
    compute(cur, gs + s * stage, ring, tab,
            ((cur.n * (geo.oh + 2) + cur.p) % geo.ring) * geo.xrow);
    if (next >= end) break;
    cur = nt;
    s ^= 1;
  }
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

// wgmma shared-memory descriptor of an N-major B operand in the 64-byte
// swizzle: atoms of 8 K rows x 64 bytes (32 columns), 512 bytes apart
// along K (the stride byte offset) and `n_stride` apart along N (the
// leading byte offset); addr on a 512-byte boundary.
__device__ __forceinline__ uint64_t b_descriptor(unsigned addr,
                                                 unsigned n_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(n_stride >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (uint64_t{2} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define VLT_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 96, float32, accumulated) += a (64 x 16 bf16, registers) *
// b (16 x 96 bf16, shared memory, N-major)
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47},"
      "{%48,%49,%50,%51}, %52, p, 1, 1, 1;\n}\n"
      : VLT_ACC8(0), VLT_ACC8(8), VLT_ACC8(16), VLT_ACC8(24), VLT_ACC8(32),
        VLT_ACC8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef VLT_ACC8

// The 16 rows of the block's partial that this warp's accumulator u
// holds (slice 4 * (2 * warpgroup + u) + warp % 4).
__device__ __forceinline__ float* warp_rows(float* partial, int u) {
  const int warp = threadIdx.x / 32;
  const int slice = 4 * (2 * (warp / 4) + u) + warp % 4;
  return partial + static_cast<long long>(blockIdx.x) * kRowsBf16 * kCout +
         slice * 16 * kCout;
}

// Bring the warp's rows of the partial (2 x 6 KB) into L2.
__device__ __forceinline__ void prefetch_rows(float* partial) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    for (int line = lane; line < 16 * kCout / 32; line += 32)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(warp_rows(partial, u) +
                                                    line * 32));
}

// Add a warp's two accumulators into the block's partial (store them at
// the first flush) and zero them.  d[4t], d[4t+1]: row lane / 4 of the
// warp's 16, columns 8t + 2 * (lane % 4) + {0, 1}; d[4t+2], d[4t+3]:
// row + 8.  All of an accumulator's loads go out before its adds.
__device__ __forceinline__ void flush(float (&acc)[2][48], float* partial,
                                      bool first) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float2* out = reinterpret_cast<float2*>(
        warp_rows(partial, u) + (lane / 4) * kCout + 2 * (lane % 4));
    // pair i = 2t + h: row + 8h, columns 8t + ...
    float2 old[24];
    if (!first) {
#pragma unroll
      for (int i = 0; i < 24; ++i)
        old[i] = out[(i % 2) * 4 * kCout + (i / 2) * 4];
    }
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      float2 v = make_float2(acc[u][2 * i], acc[u][2 * i + 1]);
      if (!first)
        v = make_float2(__fadd_rn(old[i].x, v.x), __fadd_rn(old[i].y, v.y));
      out[(i % 2) * 4 * kCout + (i / 2) * 4] = v;
    }
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[u][i] = 0.f;
  }
}

template <bool kByRows>
__global__ void __launch_bounds__(kThreadsBf16, 1)
conv1_dw_wgmma(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ g,
               float* __restrict__ partial, Geometry geo,
               const __grid_constant__ CUtensorMap g_map) {
  extern __shared__ __align__(1024) unsigned char smem_base[];
  // the G stages' swizzle follows address bits: start them on 1 KB
  unsigned char* smem =
      smem_base + ((1024 - shared_addr(smem_base) % 1024) % 1024);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  TmaCopies copies{&g_map,
                   shared_addr(smem + layout<__nv_bfloat16>(geo).bar), 0u};
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(copies.bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The warp's 16 rows of each of its warpgroup's two m64 tiles are one
  // slice: pair 2s (rows 0..7) and pair 2s + 1 (rows 8..15).  Its A (16
  // channels x 16 positions) is read from the ring rows of each pair's
  // tap, stored position-major: tile j of the x4 load covers positions
  // (j / 2) * 8 and the pair j % 2, so the transposed tiles are a0..a3 of
  // the m16n8k16 fragment, which is wgmma's per warp.
  const int lane_pos = (lane / 16) * 8 + lane % 8;
  const int zero_row = geo.ring * geo.xrow;
  int tab_at[2], kx[2], chunk[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int slice = 4 * (2 * (warp / 4) + u) + warp % 4;
    const int pair = kPairs[2 * slice + (lane / 8) % 2];
    const int tap = pair / 6;
    tab_at[u] = (tap / 3) * geo.kp + lane_pos;
    kx[u] = tap % 3;
    chunk[u] = pair % 6;
  }

  float acc[2][48];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[u][i] = 0.f;
  // flush every kFlush tiles: 4,560 positions at the training shape
  constexpr int kFlush = 16;
  int tiles = 0;
  walk_tiles<__nv_bfloat16, kByRows, kThreadsBf16>(
      smem, x, g, geo, copies,
      [&](const Tile& t, const unsigned char* gs, const unsigned char* ring,
          const int* tab, int s0x) {
        const int npos = t.nr * geo.ow;
        const int steps = round16(npos) / 16;
        const unsigned ring_addr = shared_addr(ring);
        const unsigned g_addr = shared_addr(gs);
        if (tiles % kFlush == kFlush - 1 && tiles >= kFlush)
          prefetch_rows(partial);
        auto load_a = [&](unsigned (&a)[2][4], int j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int row =
                16 * j + lane_pos < npos
                    ? ring_row(tab[tab_at[u] + 16 * j], s0x, geo) + kx[u]
                    : zero_row;
            ldmatrix_x4_trans(a[u], ring_addr + row * 96 +
                                        ((chunk[u] ^ ((row >> 2) & 1)) << 4));
          }
        };
        // positions 16j .. 16j + 15 lie in box 0 or, from step box / 16 on,
        // box 1
        auto mma = [&](const unsigned (&a)[2][4], int j) {
          const int b = 16 * j >= geo.box ? 1 : 0;
          const uint64_t desc = b_descriptor(
              g_addr + (b * 2 * geo.box + 16 * j) * 64, geo.box * 64);
          wgmma_fence();
          wgmma_m64n96k16(acc[0], a[0], desc);
          wgmma_m64n96k16(acc[1], a[1], desc);
          wgmma_commit();
        };
        unsigned a0[2][4], a1[2][4];
        load_a(a0, 0);
        for (int j = 0; j < steps; j += 2) {
          mma(a0, j);
          wgmma_wait<1>();           // the wgmmas reading a1 are done
          if (j + 1 < steps) {
            load_a(a1, j + 1);
            mma(a1, j + 1);
          }
          wgmma_wait<1>();           // the wgmmas reading a0 are done
          if (j + 2 < steps) load_a(a0, j + 2);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 48; ++i)
            asm volatile("" : "+f"(acc[u][i])::"memory");
        if (++tiles % kFlush == 0) flush(acc, partial, tiles == kFlush);
      });
  flush(acc, partial, tiles < kFlush);
}

template <bool kByRows>
__global__ void __launch_bounds__(kThreadsF32, 1)
conv1_dw_f32(const float* __restrict__ x, const float* __restrict__ g,
             float* __restrict__ partial, Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row = threadIdx.x / 2;            // tap * 48 + channel
  const int half = threadIdx.x % 2;           // columns half * 48 ...
  const int tap = row / kCin;
  const int ch = row - tap * kCin;
  const int ky = tap / 3;
  const int kx = tap % 3;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  AsyncCopies<kThreadsF32> copies;
  walk_tiles<float, kByRows, kThreadsF32>(
      smem, x, g, geo, copies,
      [&](const Tile& t, const unsigned char* gs, const unsigned char* ring,
          const int* tab, int s0x) {
        const int npos = t.nr * geo.ow;
        const float* xs = reinterpret_cast<const float*>(ring) + ch;
        const int* tk = tab + ky * geo.kp;
        for (int k = 0; k < npos; ++k) {
          const float a = xs[(ring_row(tk[k], s0x, geo) + kx) * kCin];
          const float4* gv = reinterpret_cast<const float4*>(gs) +
                             k * (kCout / 4) + half * (kCols / 4);
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

// out[i] = sum over blocks b, in order, of partial[b][i], i < n
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out, int nblocks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b)
    s = __fadd_rn(s, partial[static_cast<long long>(b) * n + i]);
  out[i] = s;
}

template <typename T, bool kByRows>
constexpr auto kernel_for() {
  if constexpr (std::is_same<T, float>::value)
    return &conv1_dw_f32<kByRows>;
  else
    return &conv1_dw_wgmma<kByRows>;
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The bf16 kernel's tensor map of g: (positions, 96) bf16 rows of 192
// bytes, boxes of 32 columns x `box` positions in the 64-byte swizzle,
// zeros past the end.
int gradient_map(CUtensorMap* map, const void* g, long long positions,
                 int box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kCout),
                              static_cast<cuuint64_t>(positions)};
  const cuuint64_t strides[1] = {kCout * 2};
  const cuuint32_t box_dims[2] = {32, static_cast<cuuint32_t>(box)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(g), dims,
      strides, box_dims, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kByRows>
int launch(const void* x, const void* g, void* partial, void* out,
           long long n, int h, int w, int oh, int ow, int top, int left,
           long long per_block, int nblocks, cudaStream_t stream) {
  Geometry geo;
  geo.h = h;
  geo.w = w;
  geo.oh = oh;
  geo.ow = ow;
  geo.top = top;
  geo.left = left;
  geo.xrow = ow + 2;
  geo.rows_tile = max(1, min(max_tile_positions<T>() / ow, oh));
  geo.kp = round16(geo.rows_tile * ow);
  geo.box = geo.kp;
  if (geo.kp > 256) {             // a TMA box spans at most 256 positions
    geo.kp = (geo.rows_tile * ow + 31) / 32 * 32;
    geo.box = geo.kp / 2;
  }
  geo.ring = geo.rows_tile + 2;
  // the frame rows of ring rows, the bytes before the first one in its
  // 16-byte chunk, and a word read past the last by the 2-byte shift
  geo.raw_bytes = round16(4 * (geo.rows_tile + 2) * w * 3 *
                              static_cast<int>(sizeof(T)) + 32);
  geo.q_bits = 0;
  while ((1 << geo.q_bits) < geo.xrow) ++geo.q_bits;
  geo.g_rows = n * oh;
  geo.per_block = per_block;
  const long long units = kByRows ? geo.g_rows : n;
  if (per_block <= 0 || nblocks <= 0 ||
      (units + per_block - 1) / per_block != nblocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_for<T, kByRows>();
  // the stages exceed the default 48 KB: opt in once to what the device
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
  const int smem = layout<T>(geo).total + 1024;   // room to align
  if (smem > smem_limit || geo.kp > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<T, float>::value) {
    kernel<<<nblocks, kThreadsF32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(partial), geo);
  } else {
    CUtensorMap map;
    const int rc = gradient_map(&map, g, n * oh * ow, geo.box);
    if (rc != 0) return rc;
    kernel<<<nblocks, kThreadsBf16, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<float*>(partial), geo, map);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int outs = (std::is_same<T, float>::value ? kRows : kRowsBf16) *
                       kCout;
  reduce_partials<<<(outs + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nblocks,
      outs);
  return static_cast<int>(cudaGetLastError());
}

template <bool kByRows>
int dispatch(const void* x, const void* g, void* partial, void* out,
             long long n, int h, int w, int oh, int ow, int top, int left,
             int dtype, long long per_block, int nblocks, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || top < 0 ||
      left < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kByRows>(x, g, partial, out, n, h, w, oh, ow, top,
                                  left, per_block, nblocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kByRows>(x, g, partial, out, n, h, w, oh,
                                          ow, top, left, per_block, nblocks,
                                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: contiguous (n, h, w, 3) frames, aligned to their element; g:
// contiguous (n, oh, ow, 96) gradient, 16-byte aligned; both float32
// (dtype 0) or bfloat16 (dtype 1).  top, left: the SAME padding above and
// left of the frame (s2d position (P, Q) starts at pixel (4P - top,
// 4Q - left)).  Blocks own images_per_block images each; nblocks =
// ceil(n / images_per_block).  partial: (nblocks, rows, 96) float32
// scratch; out: (rows, 96) float32: float32 x gives the 432 s2d rows
// (tap * 48 + channel), bfloat16 x the 384 rows of its (tap, chunk)
// pairs (kPairs, the bf16 slot order).  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// geometry the kernel does not take or a frame too wide for its shared
// memory).
extern "C" int vlt_conv1_dw(const void* x, const void* g, void* partial,
                            void* out, long long n, int h, int w, int oh,
                            int ow, int top, int left, int dtype,
                            long long images_per_block, int nblocks,
                            void* stream) {
  return dispatch<false>(x, g, partial, out, n, h, w, oh, ow, top, left,
                         dtype, images_per_block, nblocks, stream);
}

// The same operands, split into ranges of rows_per_block gradient rows
// (n * oh rows in all); nblocks = ceil(n * oh / rows_per_block).
extern "C" int vlt_conv1_dw_shifted(const void* x, const void* g,
                                    void* partial, void* out, long long n,
                                    int h, int w, int oh, int ow, int top,
                                    int left, int dtype,
                                    long long rows_per_block, int nblocks,
                                    void* stream) {
  return dispatch<true>(x, g, partial, out, n, h, w, oh, ow, top, left,
                        dtype, rows_per_block, nblocks, stream);
}
