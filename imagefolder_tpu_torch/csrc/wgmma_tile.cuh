// Warpgroup building blocks for Hopper (sm_90a) shared by the kernels on
// wgmma: the bf16 attention backward (attention_bwd_sm90.cuh: #2, #5, #6),
// the attention forwards (attention_fwd_sm90.cuh: #1, #3, #4) and, for its
// fences and descriptor, the sublayers' GEMM (gemm_epilogue.cuh: #7, #8,
// #10). In the attention kernels one warpgroup (128 threads) owns 64-row
// tiles of a 64-wide head; tiles sit in shared memory in the 128-byte
// swizzle that wgmma reads (16-byte chunk c of row r at chunk c ^ (r % 8)),
// written by cp.async 16-byte copies with zero fill past the end, and feed
// m64n64k16 products (bf16 in, fp32 accumulate) with the A operand in
// registers. A narrower head (any multiple of 8 below 64: 48 for RAR-B and
// MaskGIT-B) keeps the same 64-wide tile and descriptor: its hd / 8 chunks
// of a row are copied and the chunks past them zero-filled, so a product
// over the head dim runs kD / 16 K-steps (kD = 48 for hd <= 48, else 64;
// the K-steps past ceil(hd / 16) add exact zeros) and a product whose N is
// the head dim computes zero columns past hd, which are never stored. A
// head of 72-128 is two such tiles side by side (load_head_async); the
// backward there reads both operands of its score products from shared
// memory (wgmma_ss) and runs the products whose N is the head dim over the
// second tile at the head's width past 64 (wgmma_rs_mn).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {
namespace sm90 {

using mma_tile::bf16;
using mma_tile::pack_bf16;
using mma_tile::smem_addr;

constexpr int kHd = 64;                    // a tile's width: the widest head dim
constexpr int kTile = 64;                  // q rows and keys per tile
constexpr int kThreads = 128;              // one warpgroup
constexpr int kTileBytes = kTile * kHd * 2;  // one bf16 tile, 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------ primitives ------------------------------ //

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// Keep the compiler from moving, reusing or reading registers that an
// asynchronous wgmma still owns: accumulators are fenced before the
// products start, right after, and after the wait; register A operands
// right after the products start and after the wait, which keeps them live
// (and their registers unreused) until the wgmma has read them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile whose
// rows are 128 bytes (64 values) and whose 8-row groups are 1024 bytes
// apart. Both byte offsets are 1024: the stride-dimension offset is the
// 8-row group stride in either major-ness, and the leading-dimension
// offset is never used at these shapes (a K-major row, or an MN-major run
// of 64 values, fits one swizzle atom).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define SM90_ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SM90_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, fp32) (+)= a (64 x 16, bf16 A fragments in registers) b (16 x
// 64, shared memory; kTB 0 = K-major, 1 = MN-major); accumulate = 0
// overwrites d
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
}

// d (64 x 64, fp32) (+)= a b^T with both operands read from shared memory,
// K-major (a: 64 x 16, b: 64 x 16, each row 16 values of the inner
// dimension); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, fp32) += a (64 x 16, bf16 A fragments in registers) b (16 x N,
// MN-major in shared memory), for N a multiple of 8 up to 64: the first N
// columns of a 64-wide swizzled tile. A product whose N is a head dim pays
// for that width rounded up to 8, not for the tile's 64.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  wgmma_rs<1>(d, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<8>(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<24>(float (&d)[12], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<40>(float (&d)[20], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<48>(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<56>(float (&d)[28], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// This warp's A fragments (rows 16w..16w+15 for warp w of its warpgroup,
// one set of four per 16-wide step) of a 64 x 64 swizzled tile, by ldmatrix.
__device__ __forceinline__ void tile_to_a(uint32_t (&a)[4][4], uint32_t tile) {
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t addr = tile + r * 128 + (((kk * 2 + (lane >> 4)) ^ (r & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

// The A fragments of a 64 x 64 accumulator (its columns the product's inner
// dimension), rounded to bf16: one set of four per 16-wide step. A wgmma
// accumulator holds, per warp, the same 16-row layout as mma.sync's, which
// is the register A operand's layout.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// rows [row0, row0 + 64) x hd values (hd a multiple of 8, at most kD; kD =
// 48 or 64) of one head's slice (row stride ld) into a swizzled 64-wide
// tile at `dst`; rows >= n and columns >= hd are zero. Each of the kN
// threads that share the copy (tid its index among them; by default the one
// warpgroup of the block) starts 512 / kN 16-byte copies.
template <int kN = kThreads, int kD = kHd>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, int row0, int n,
                                                int64_t ld, int tid, int hd = kD) {
  static_assert(kD % 16 == 0 && kD <= kHd, "a head dim of whole 16-wide K-steps, at most 64");
  const int chunks = hd >> 3;
#pragma unroll
  for (int j = 0; j < kTile * 8 / kN; ++j) {
    const int i = tid + j * kN;
    const int r = i >> 3, c = i & 7;
    const bool row_in = row0 + r < n;
    // chunks past a narrow head's width copy nothing from its first chunk;
    // at hd = kHd, known when compiled, both conditions fold away
    const bool in = row_in && c < chunks;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + static_cast<int64_t>(row_in ? row0 + r : 0) * ld + (c < chunks ? c * 8 : 0),
               in);
  }
}

// the same copy shared by the block's one warpgroup
template <int kD = kHd>
__device__ __forceinline__ void load_tile_wg(uint32_t dst, const bf16* src, int row0, int n,
                                             int64_t ld, int hd = kD) {
  load_tile_async<kThreads, kD>(dst, src, row0, n, ld, threadIdx.x, hd);
}

// 64-wide tiles side by side that hold one row block of a head of kD: 1,
// or 2 past 64
__host__ __device__ constexpr int head_tiles(int kD) { return kD > kHd ? 2 : 1; }

// rows [row0, row0 + 64) x hd values of one head's slice into the
// head_tiles(kD) 64-wide tiles at `dst` (the second at dst + kTileBytes
// holds columns 64 to hd); zero past n and hd. kN threads share the copy.
template <int kN, int kD>
__device__ __forceinline__ void load_head_async(uint32_t dst, const bf16* src, int row0, int n,
                                                int64_t ld, int tid, int hd) {
  if constexpr (kD <= kHd) {
    load_tile_async<kN, kD>(dst, src, row0, n, ld, tid, hd);
  } else {
    load_tile_async<kN, kHd>(dst, src, row0, n, ld, tid, hd < kHd ? hd : kHd);
    load_tile_async<kN, kHd>(dst + kTileBytes, src + kHd, row0, n, ld, tid,
                             hd > kHd ? hd - kHd : 0);
  }
}

}  // namespace sm90
}  // namespace
