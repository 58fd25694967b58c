// One fused BasicLSTMCell step, for Hopper (sm_90a).
//
// Replaces: video_learning_tpu/ops/pallas_kernels.py:184-220, function
// `lstm_step` (kernel body `_lstm_step_kernel`).
//
// Computes, all in float32, for xproj (B, 4H), h and c (B, H),
// Wh (H, 4H) and b (4H):
//   gates = (xproj + h @ Wh) + b, split into i, j, f, o (each H wide)
//   c' = c * sigmoid(f + 1) + sigmoid(i) * tanh(j)
//   h' = tanh(c') * sigmoid(o)
// The recurrent product h @ Wh is computed here, in the kernel, as the
// TPU kernel computed it in its own body.
//
// Bound on this card, the larger of the bytes (xproj, h, c, Wh, b read
// once, h' and c' written once, at 3.35 TB/s) and the operations (the
// product's 2 * B * H * 4H and ~20 a cell, at the rate of the fastest
// float32-accurate route, 3xTF32 on the tensor cores: 495 / 3 TFLOP/s):
//   (B, H) = (32, 256)  1.31 MB, 17 MFLOP:  0.39 us, bytes
//            (128, 256) 2.10 MB, 68 MFLOP:  0.63 us, bytes
//            (64, 512)  5.25 MB, 135 MFLOP: 1.57 us, bytes
//            (256, 512) 8.40 MB, 540 MFLOP: 3.27 us, operations
// Wh (1 or 4 MiB) stays in L2 between steps, so a launch is latency: how
// long each SM waits for its slices, the tensor work, the cluster's
// exchange and the cell update, one after the other.
//
// Design: the step is a skinny GEMM (M = batch rows, N = 4 gates x H,
// K = H) with the cell update as its epilogue.  The plan (`plan()` in
// ops/lstm_step.py, which passes it here) gives each CTA
//   - a row group of 64 or 128 rows (one or two consumer warpgroups):
//     ALL rows where B <= 128, else ceil(B / 128) groups (2 at B = 256),
//   - a tile of JT = 8 * WJ columns j for each of the four gates (the
//     gate split is which columns a box loads; nothing is permuted),
//   - a slice of k; the `split` CTAs that share a row group and a j tile
//     form one thread block cluster along x.
// So each Wh element crosses from L2 to an SM once per row group, never
// more:
//   (32, 256)  1 group:  32 j tiles x 4 k slices, 128 CTAs: once
//   (128, 256) 1 group:  16 x 4, 64 CTAs:                   once
//   (64, 512)  1 group:  64 x 4, 256 CTAs:                  once
//   (256, 512) 2 groups: 32 x 2 x 2, 128 CTAs:              twice
// (A design that gives a block 4 rows reads it 8, 32, 16 and 64 times.)
// The split is the largest of 4, 2, 1 whose clusters the card holds at
// once (a second wave would double the time).
// Loads: a producer warp (beside the consumer warpgroups) brings each
// chunk of 32 k by TMA into a ring of up to 3 stages, full / empty
// mbarriers between it and the consumers: h's rows x 32 k as one box in
// the 128-byte swizzle, Wh's 32 k x 4 gates x JT j as one 3D box, and
// the cell update's xproj and c by two more boxes at the start.  TMA
// clips to (B, H) and fills zeros; the consumers zero k past the slice.
// Where H is not a multiple of 4 or a pointer is not 16-byte aligned
// (TMA needs both) the consumers bring the same layouts by 4-byte
// cp.async.
// Products: wgmma m64nNk8 TF32 (N = 4 * JT), A = h from registers (each
// warp's m16n8k8 fragment), B = Wh from shared memory.  TF32 wgmma takes
// K-major operands only and Wh (H, 4H) is N-major, so the consumers
// write Wh's chunk K-major (core matrices of 8 n x 4 k) while splitting
// it.  Float32 accuracy by 3xTF32: each operand is split as x = hi + lo
// (hi rounded to TF32 by two integer operations, lo = x - hi exact and
// truncated to TF32 by the tensor core: 2^-21 of |x|), and the
// accumulator takes lo*hi, hi*lo, then hi*hi, in float32; lo*lo is
// dropped.  One TF32 pass keeps ~3 digits and misses the 1e-5 tolerance
// (tests/test_torch_lstm_plan.py shows both on an emulation).  The B
// planes and A fragments are double-buffered: chunk c + 1's split runs
// while chunk c's wgmmas do.  mma.sync m16n8k8 TF32 needs no K-major
// copy and wastes no rows at B <= 32, but runs well below wgmma's rate on
// this card, so 3xTF32 on it gains little over float32 FMAs; its 16-row
// tiles would still win at B <= 32, where the launch is all fixed costs,
// but one design serves every shape here.
// The cluster's partial sums meet through distributed shared memory: each
// CTA owns ceil(rows / split) rows of the tile, and every CTA stores its
// partial i, j, f, o sums of those rows (float4 a pair) into the owner's
// receive buffer at its rank; one cluster barrier later the owner sums
// them in rank order 0..split-1, adds xproj and b in the same __fadd_rn
// order as before and writes h' and c'.  No atomics: two launches on the
// same inputs give the same bits.
// Shapes the plan cannot give (more than 8 CTAs a cluster, a layout
// past 227 KB of shared memory) are refused.  A persistent kernel over
// all T steps that keeps Wh on chip is later work.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kKChunk = 32;       // k per pipeline stage
constexpr int kStages = 3;        // stages of the ring at most
constexpr int kMaxSplit = 8;      // CTAs a cluster (portable limit)
constexpr int kAlign = 1024;      // alignment of each stage and plane

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared; zeros where !ok (nothing is read)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// this thread's cp.asyncs so far arrive on `bar` when they land
__device__ __forceinline__ void copies_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}

// A 2D / 3D box of a tensor map into shared memory, counted in at `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int x, int y, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int x, int y, int z, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// The consumer warpgroups' own barrier (the producer warp is not in it)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier in two halves: what a thread wrote to shared memory
// before arrive() is seen by every CTA of the cluster after wait().  The
// relaxed arrive orders nothing: it says that this CTA has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes into the shared memory of the cluster's CTA `rank`, at the
// offset of `p` in this CTA's
__device__ __forceinline__ void store_cluster(const void* p, int rank,
                                              float4 v) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest with
// ties away from zero, as cvt.rna.tf32.f32 rounds) by two integer
// operations; lo = x - hi is exact, and the tensor core reads its top 19
// bits (TF32 truncation of lo: 2^-21 of |x| at most)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(float4 x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// Keeps the register operands of issued wgmmas alive (and unchanged) up
// to this point: the compiler may not reuse their registers before
__device__ __forceinline__ void keep(unsigned (&a)[kKChunk / 8][2][4]) {
#pragma unroll
  for (int ks = 0; ks < kKChunk / 8; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("" : "+r"(a[ks][h][0]), "+r"(a[ks][h][1]),
                   "+r"(a[ks][h][2]), "+r"(a[ks][h][3])::"memory");
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

// Where a TF32 plane keeps element (n, k) of a chunk: K-major core
// matrices of 8 n x 4 k (16-byte rows), 128 bytes apart along k and 32 k
// / 4 * 128 = 1024 bytes apart along n
__device__ __forceinline__ int plane_at(int n, int kq) {
  return ((n >> 3) * (kKChunk / 4) + kq) * 32 + (n & 7) * 4;
}

// wgmma shared-memory descriptor of such a plane (the B operand, K-major,
// no swizzle): leading byte offset 128 (along k), stride byte offset
// 1024 (along n)
__device__ __forceinline__ uint64_t descriptor(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((kKChunk / 4 * 128) >> 4) << 32);
}

#define VLT_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, float32, accumulated) += a (64 x 8 TF32, registers: per warp
// the m16n8k8 A fragment of its 16 rows) * b (8 x N TF32, shared memory,
// K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const unsigned (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : VLT_ACC8(0), VLT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : VLT_ACC8(0), VLT_ACC8(8), VLT_ACC8(16), VLT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef VLT_ACC8

// The shared memory of a CTA with `rows` rows, 8 * wj j, `slots` stages
// and a share of `share` rows, in bytes from the (1024-byte aligned)
// start: the ring (each stage: h's rows x 32 k in the 128-byte swizzle,
// then Wh's 32 k x 4 gates x 8 * wj j); two buffers of Wh's TF32 planes
// (hi, lo); the stages' full and empty mbarriers and the cell update's;
// recv (split x share x 8 * wj float4: the partial i, j, f, o sums of
// the CTA's share of the tile's pairs, from each CTA of the cluster);
// the share's xproj (share x 4 gates x 8 * wj) and c (share x 8 * wj);
// the tile's b.
struct Smem {
  int stage, planes, bars, recv, xq, cq, bq, bytes;
  __host__ __device__ Smem(int rows, int wj, int slots, int split,
                           int share) {
    const int h_bytes = rows * kKChunk * 4;
    const int w_bytes = kKChunk * 32 * wj * 4;
    stage = (h_bytes + w_bytes + kAlign - 1) / kAlign * kAlign;
    planes = slots * stage;
    bars = planes + 2 * 2 * w_bytes;
    recv = (bars + (2 * kStages + 1) * 8 + 127) / 128 * 128;
    xq = recv + split * share * 8 * wj * 16;
    cq = xq + share * 32 * wj * 4;
    bq = cq + (share * 8 * wj * 4 + 127) / 128 * 128;
    bytes = bq + 32 * wj * 4;
  }
};

// grid (split, j tiles, row groups), cluster (split, 1, 1); WG consumer
// warpgroups of 64 rows, then one producer warp.  `tma`: the producer
// brings the chunks by TMA (h_map: h as (B, H) in boxes of 32 k x 64 *
// WG rows, 128-byte swizzle; w_map: Wh as (H, 4, H) in boxes of 32 k x 4
// gates x 8 * WJ j) and the cell update's xproj (x_map: (B, 4, H), boxes
// of share rows x 4 gates x 8 * WJ j) and c (c_map: (B, H), boxes of
// share rows x 8 * WJ j); else (H not a multiple of 4, or a pointer not
// 16-byte aligned) the consumers bring them by 4-byte cp.async, into the
// same layouts.
template <int WG, int WJ>
__global__ void __launch_bounds__(128 * WG + 32)
lstm_step_wgmma(const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap c_map,
                const float* __restrict__ xproj, const float* __restrict__ h,
                const float* __restrict__ c, const float* __restrict__ wh,
                const float* __restrict__ b, float* __restrict__ h_out,
                float* __restrict__ c_out, int B, int H, int k_cta,
                int slots, int share, int tma) {
  constexpr int ROWS = 64 * WG;
  constexpr int CONSUMERS = 128 * WG; // threads of the warpgroups
  constexpr int THREADS = CONSUMERS + 32;
  constexpr int JT = 8 * WJ;          // j of each gate in the tile
  constexpr int NCOL = 4 * JT;        // gate columns: i | j | f | o
  extern __shared__ __align__(kAlign) unsigned char smem_raw[];
  // the dynamic shared memory starts 16-byte aligned: align it
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) %
                                    kAlign);
  const int split = gridDim.x;
  const int rank = blockIdx.x;        // = the CTA's rank in its cluster
  const int j0 = blockIdx.y * JT;
  const int row0 = blockIdx.z * ROWS;
  const int k_begin = rank * k_cta;
  const int k_end = min(H, k_begin + k_cta);
  const int chunks = (k_end - k_begin + kKChunk - 1) / kKChunk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const Smem lay(ROWS, WJ, slots, split, share);
  float4* recv = reinterpret_cast<float4*>(smem + lay.recv);
  float* xq = reinterpret_cast<float*>(smem + lay.xq);   // [share][4][JT]
  float* cq = reinterpret_cast<float*>(smem + lay.cq);   // [share][JT]
  float* bq = reinterpret_cast<float*>(smem + lay.bq);   // [4][JT]
  const unsigned full = smem_addr(smem + lay.bars);      // + 8 * stage
  const unsigned empty = full + 8 * kStages;             // + 8 * stage
  const unsigned epi_bar = full + 16 * kStages;
  // this CTA's share of the tile: rows r_own .. r_own + share - 1
  const int r_own = rank * share;
  const int mine = max(0, min(share, ROWS - r_own)) * JT;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : CONSUMERS);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(epi_bar, tma ? 1 : CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();           // this CTA has started
  __syncthreads();

  // chunk `chunk` of the slice: h's rows x 32 k, 128-byte swizzled
  // (16-byte unit u of row r at u ^ (r % 8)), then Wh's 32 k x 4 gates x
  // JT j
  auto stage_of = [&](int chunk) {
    return reinterpret_cast<float*>(smem + (chunk % slots) * lay.stage);
  };
  auto copy_chunk = [&](int chunk) {  // the consumers, without TMA
    float* hs = stage_of(chunk);
    float* ws = hs + ROWS * kKChunk;
    const int kc = k_begin + chunk * kKChunk;
    for (int i = tid; i < ROWS * kKChunk; i += CONSUMERS) {
      const int r = i / kKChunk, k = i % kKChunk;
      const int row = row0 + r;
      const bool ok = row < B && kc + k < H;
      copy4(hs + r * kKChunk + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3)),
            ok ? h + static_cast<size_t>(row) * H + kc + k : h, ok);
    }
    for (int i = tid; i < kKChunk * NCOL; i += CONSUMERS) {
      const int k = i / NCOL, g = i % NCOL / JT, jl = i % JT;
      const bool ok = kc + k < H && j0 + jl < H;
      copy4(ws + i, ok ? wh + (kc + k) * H4 + g * H + j0 + jl : wh, ok);
    }
    copies_arrive(full + 8 * (chunk % slots));
  };

  if (warp == 4 * WG) {
    // the producer: with TMA, lane 0 brings the cell update's operands,
    // then each chunk once the consumers have emptied its stage
    if (tma && (tid & 31) == 0) {
      mbar_expect(epi_bar, 5 * share * JT * 4);
      tma_3d(xq, &x_map, j0, 0, row0 + r_own, epi_bar);
      tma_2d(cq, &c_map, j0, row0 + r_own, epi_bar);
      for (int chunk = 0; chunk < chunks; ++chunk) {
        if (chunk >= slots)
          mbar_wait(empty + 8 * (chunk % slots), (chunk / slots - 1) & 1);
        float* hs = stage_of(chunk);
        const unsigned bar = full + 8 * (chunk % slots);
        const int kc = k_begin + chunk * kKChunk;
        mbar_expect(bar, (ROWS + NCOL) * kKChunk * 4);
        tma_2d(hs, &h_map, kc, row0, bar);
        tma_3d(hs + ROWS * kKChunk, &w_map, j0, 0, kc, bar);
      }
    }
    __syncwarp();
  } else {
    if (!tma) {
      for (int i = tid; i < mine; i += CONSUMERS) {
        const int row = row0 + r_own + i / JT, j = j0 + i % JT;
        const bool ok = row < B && j < H;
        const float* x = ok ? xproj + row * H4 + j : xproj;
        for (int g = 0; g < 4; ++g)
          copy4(xq + (i / JT * 4 + g) * JT + i % JT, ok ? x + g * H : x, ok);
        copy4(cq + i, ok ? c + static_cast<size_t>(row) * H + j : c, ok);
      }
      copies_arrive(epi_bar);
      for (int s = 0; s < slots && s < chunks; ++s) copy_chunk(s);
    }
  }
  // b's column of this thread, kept in a register until the products are
  // done (NCOL <= CONSUMERS)
  const float b_val =
      tid < NCOL && j0 + tid % JT < H ? b[(tid / JT) * H + j0 + tid % JT]
                                      : 0.f;

  float acc[NCOL / 2];
#pragma unroll
  for (int i = 0; i < NCOL / 2; ++i) acc[i] = 0.f;

  // chunk c: its B planes (buffer c % 2) and A fragments (set c % 2)
  // are made while chunk c - 1's wgmmas run; after chunk c's are issued,
  // waiting for chunk c - 1's frees that buffer and set for chunk c + 1
  const int lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  auto step = [&](int chunk, unsigned (&a)[kKChunk / 8][2][4],
                  unsigned (&a_before)[kKChunk / 8][2][4]) {
    mbar_wait(full + 8 * (chunk % slots), (chunk / slots) & 1);
    const float* hs = stage_of(chunk);
    const float* ws = hs + ROWS * kKChunk;
    uint4* b_hi = reinterpret_cast<uint4*>(smem + lay.planes +
                                           (chunk & 1) * 2 * NCOL * kKChunk *
                                               4);
    uint4* b_lo = b_hi + NCOL * kKChunk / 4;
    const int k_left = k_end - (k_begin + chunk * kKChunk);
    // Wh's TF32 planes, zero past the k slice and past H's j (the next
    // gate's columns, in the last tile): each thread B_ITEMS 16-byte units
    // of neighbouring columns, all loads first
    constexpr int B_ITEMS = NCOL * (kKChunk / 4) / CONSUMERS;
    static_assert(B_ITEMS * CONSUMERS == NCOL * (kKChunk / 4),
                  "whole units a thread");
    float4 xb[B_ITEMS];
#pragma unroll
    for (int it = 0; it < B_ITEMS; ++it) {
      const int i = tid + it * CONSUMERS;
      const float* w = ws + 4 * (i / NCOL) * NCOL + i % NCOL;
      xb[it] = make_float4(w[0], w[NCOL], w[2 * NCOL], w[3 * NCOL]);
    }
    // the warp's A fragments: rows g8, g8 + 8 of its 16, k t4, t4 + 4 of
    // each 8 (h's unit u of row r sits at u ^ (r % 8))
    float xa[kKChunk / 8][4];
#pragma unroll
    for (int ks = 0; ks < kKChunk / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g8 + (e & 1) * 8;
        const int u = 2 * ks + (e >> 1);
        xa[ks][e] = hs[r * kKChunk + ((u ^ (r & 7)) << 2) + t4];
      }
    mbar_arrive(empty + 8 * (chunk % slots));   // the stage is read
#pragma unroll
    for (int it = 0; it < B_ITEMS; ++it) {
      const int i = tid + it * CONSUMERS;
      const int n = i % NCOL, kq = i / NCOL;
      float4 x = xb[it];
      if (j0 + n % JT >= H || 4 * kq >= k_left)
        x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * kq + 1 >= k_left) x.y = 0.f;
      if (4 * kq + 2 >= k_left) x.z = 0.f;
      if (4 * kq + 3 >= k_left) x.w = 0.f;
      split_tf32(x, b_hi[plane_at(n, kq) / 4], b_lo[plane_at(n, kq) / 4]);
    }
#pragma unroll
    for (int ks = 0; ks < kKChunk / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * ks + t4 + (e >> 1) * 4 < k_left ? xa[ks][e] : 0.f;
        split_tf32(x, a[ks][0][e], a[ks][1][e]);
      }
    // generic writes of the planes before the async proxy reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync<CONSUMERS>();
    if (!tma && chunk + slots < chunks) copy_chunk(chunk + slots);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKChunk / 8; ++ks) {
      const uint64_t bh =
          descriptor(smem_addr(reinterpret_cast<float*>(b_hi) + ks * 64));
      const uint64_t bl =
          descriptor(smem_addr(reinterpret_cast<float*>(b_lo) + ks * 64));
      wgmma_tf32(acc, a[ks][1], bh);
      wgmma_tf32(acc, a[ks][0], bl);
      wgmma_tf32(acc, a[ks][0], bh);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // chunk c - 1's products are done
    keep(a_before);
    consumers_sync<CONSUMERS>();      // every warpgroup's buffer c - 1 is free
  };
  if (warp < 4 * WG) {
    unsigned a0[kKChunk / 8][2][4], a1[kKChunk / 8][2][4] = {};
    for (int chunk = 0; chunk < chunks; chunk += 2) {
      step(chunk, a0, a1);
      if (chunk + 1 < chunks) step(chunk + 1, a1, a0);
    }
    wgmma_wait<0>();
    keep(a0);
    keep(a1);
  }
  if (tid < NCOL) bq[tid] = b_val;    // read after the cluster barrier
  cluster_wait();                     // every CTA of the cluster has started

  // each (row, j)'s i, j, f, o partial sums go to the CTA that owns the
  // row, at this CTA's rank in its recv; acc[4 * nb + e] is row
  // 16 * warp + lane / 4 + 8 * (e / 2), column 8 * nb + 2 * (lane % 4) +
  // e % 2
  if (warp < 4 * WG) {
#pragma unroll
    for (int jb = 0; jb < WJ; ++jb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g8 + (e & 2) * 4;
        const int q = r / share;
        const int lp = (r - q * share) * JT + jb * 8 + 2 * t4 + (e & 1);
        store_cluster(recv + rank * share * JT + lp, q,
                      make_float4(acc[4 * jb + e], acc[4 * (WJ + jb) + e],
                                  acc[4 * (2 * WJ + jb) + e],
                                  acc[4 * (3 * WJ + jb) + e]));
      }
    }
  }
  cluster_arrive();
  cluster_wait();                     // every partial of the share is here

  // the partials of each pair summed in rank order, then the cell update
  mbar_wait(epi_bar, 0);
#pragma unroll 4
  for (int lp = tid; lp < mine; lp += THREADS) {
    const int r = r_own + lp / JT, jl = lp % JT;
    const int row = row0 + r, jj = j0 + jl;
    if (row >= B || jj >= H) continue;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < split; ++q) {
      const float4 v = recv[q * share * JT + lp];
      dot[0] = __fadd_rn(dot[0], v.x);
      dot[1] = __fadd_rn(dot[1], v.y);
      dot[2] = __fadd_rn(dot[2], v.z);
      dot[3] = __fadd_rn(dot[3], v.w);
    }
    const float* x = xq + (lp / JT) * NCOL + jl;
    const float gi = __fadd_rn(__fadd_rn(x[0], dot[0]), bq[jl]);
    const float gj = __fadd_rn(__fadd_rn(x[JT], dot[1]), bq[JT + jl]);
    const float gf = __fadd_rn(__fadd_rn(x[2 * JT], dot[2]), bq[2 * JT + jl]);
    const float go = __fadd_rn(__fadd_rn(x[3 * JT], dot[3]), bq[3 * JT + jl]);
    const float new_c =
        __fadd_rn(__fmul_rn(cq[lp], sigmoid(gf + 1.f)),
                  __fmul_rn(sigmoid(gi), tanhf(gj)));
    const size_t cell = static_cast<size_t>(row) * H + jj;
    c_out[cell] = new_c;
    h_out[cell] = __fmul_rn(tanhf(new_c), sigmoid(go));
  }
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap, const float*,
                        const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, int, int,
                        int);

Kernel pick(int wg, int wj) {
  if (wg == 1 && wj == 1) return lstm_step_wgmma<1, 1>;
  if (wg == 1 && wj == 2) return lstm_step_wgmma<1, 2>;
  if (wg == 2 && wj == 1) return lstm_step_wgmma<2, 1>;
  if (wg == 2 && wj == 2) return lstm_step_wgmma<2, 2>;
  return nullptr;
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// The plan's stages (as many as the slice has chunks, at most kStages,
// fewer where the rest would not fit), rows a CTA's share (of the cell
// update, and of the tile's sums it gathers) and bytes of shared memory
// (with room to align its start), or 0 stages where not even one fits.
struct Layout {
  int slots, share;
  size_t bytes;
};

Layout layout(int rows, int wj, int k_cta, int split) {
  constexpr int kSmemMax = 227 * 1024;
  const int chunks = (k_cta + kKChunk - 1) / kKChunk;
  const int share = (rows + split - 1) / split;
  for (int slots = chunks < kStages ? chunks : kStages; slots > 0; --slots) {
    const int bytes = Smem(rows, wj, slots, split, share).bytes + kAlign;
    if (bytes <= kSmemMax)
      return {slots, share, static_cast<size_t>(bytes)};
  }
  return {0, share, 0};
}

// Raises the kernel's dynamic shared memory limit to `smem` once (the
// largest asked so far; a race only repeats the call).
cudaError_t allow_smem(Kernel fn, int wg, int wj, size_t smem) {
  static size_t allowed[3][3] = {};
  size_t& have = allowed[wg][wj];
  if (smem <= have) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) have = smem;
  return err;
}

cudaLaunchConfig_t cluster_config(int split, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan's threads a CTA, or 0 where the kernel does not take the plan.
int plan_threads(int H, int rows, int wj, int k_cta, int split) {
  if (H <= 0 || (rows != 64 && rows != 128) ||
      pick(rows / 64, wj) == nullptr || k_cta <= 0 || k_cta % 8 != 0 ||
      split < 1 || split > kMaxSplit ||
      static_cast<long long>(split) * k_cta < H ||
      static_cast<long long>(split - 1) * k_cta >= H ||
      layout(rows, wj, k_cta, split).slots == 0)
    return 0;
  return 2 * rows + 32;
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A float32 tensor of `rank` dims (innermost first, elements) and byte
// strides of the outer dims, in boxes of `box`, zeros past its end
int tensor_map(CUtensorMap* map, const void* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
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
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's four tensor maps (H a multiple of 4, 16-byte aligned
// pointers)
int make_maps(CUtensorMap (&maps)[4], const void* xproj, const void* h,
              const void* c, const void* wh, int B, int H, int rows, int wj,
              int share) {
  const cuuint64_t b = B, hh = H;
  const cuuint64_t h_dims[2] = {hh, b}, h_strides[1] = {hh * 4};
  const cuuint32_t h_box[2] = {kKChunk, static_cast<cuuint32_t>(rows)};
  const cuuint64_t w_dims[3] = {hh, 4, hh};
  const cuuint64_t w_strides[2] = {hh * 4, hh * 16};
  const cuuint32_t w_box[3] = {static_cast<cuuint32_t>(8 * wj), 4, kKChunk};
  const cuuint64_t x_dims[3] = {hh, 4, b};
  const cuuint32_t x_box[3] = {static_cast<cuuint32_t>(8 * wj), 4,
                               static_cast<cuuint32_t>(share)};
  const cuuint32_t c_box[2] = {static_cast<cuuint32_t>(8 * wj),
                               static_cast<cuuint32_t>(share)};
  int rc = tensor_map(&maps[0], h, 2, h_dims, h_strides, h_box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tensor_map(&maps[1], wh, 3, w_dims, w_strides, w_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = tensor_map(&maps[2], xproj, 3, x_dims, w_strides, x_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = tensor_map(&maps[3], c, 2, h_dims, h_strides, c_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  return rc;
}

}  // namespace

// All pointers: contiguous float32 device buffers.  h_out and c_out must
// not alias the inputs.  The plan (ops/lstm_step.py `plan`): `rows` rows
// a CTA (64 or 128: one warpgroup a 64), `wj` (1 or 2: 8 * wj j of each
// gate a CTA), `k_cta` k a CTA (a multiple of 8) and `split` CTAs a
// cluster along k, every one of them with k left.  Returns
// cudaGetLastError() after the launch.
extern "C" int vlt_lstm_step(const void* xproj, const void* h, const void* c,
                             const void* wh, const void* b, void* h_out,
                             void* c_out, int B, int H, int rows, int wj,
                             int k_cta, int split, void* stream) {
  if (B <= 0) return 0;
  const int threads = plan_threads(H, rows, wj, k_cta, split);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (static_cast<long long>(B) + rows - 1) / rows;
  const long long tiles = (static_cast<long long>(H) + 8 * wj - 1) / (8 * wj);
  if (groups > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel fn = pick(rows / 64, wj);
  const Layout lay = layout(rows, wj, k_cta, split);
  cudaError_t err = allow_smem(fn, rows / 64, wj, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tma = H % 4 == 0 && aligned16(xproj) && aligned16(h) &&
                  aligned16(c) && aligned16(wh);
  CUtensorMap maps[4] = {};
  if (tma) {
    const int rc = make_maps(maps, xproj, h, c, wh, B, H, rows, wj, lay.share);
    if (rc != 0) return rc;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(split, attr);
  cfg.gridDim = dim3(split, static_cast<unsigned>(tiles),
                     static_cast<unsigned>(groups));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(
      &cfg, fn, maps[0], maps[1], maps[2], maps[3],
      static_cast<const float*>(xproj), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wh),
      static_cast<const float*>(b), static_cast<float*>(h_out),
      static_cast<float*>(c_out), B, H, k_cta, lay.slots, lay.share, tma);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Thread block clusters of the plan's shape that can be resident at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t.
extern "C" int vlt_lstm_step_max_clusters(int H, int rows, int wj, int k_cta,
                                          int split) {
  const int threads = plan_threads(H, rows, wj, k_cta, split);
  if (threads == 0) return -static_cast<int>(cudaErrorInvalidValue);
  const Kernel fn = pick(rows / 64, wj);
  const Layout lay = layout(rows, wj, k_cta, split);
  cudaError_t err = allow_smem(fn, rows / 64, wj, lay.bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(split, attr);
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = lay.bytes;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}
