// Warp-level tensor-core helpers shared by the attention kernels
// (attention_bwd_tile.cuh; the fp32 forwards of attention_fwd_tile.cuh and
// attention_bnhd.cu take its constants): ldmatrix
// loads from shared memory, mma.sync m16n8k16 with bf16 operands and fp32
// accumulators, a 64-row bf16 tile loader with zero rows past the end (and
// zero columns past a narrower head's end: a head of hd < 64 runs the same
// products on its zero-padded tiles, and its users store only its hd
// columns), and the three warp products the BNHD kernels are built from: a
// warp's 16 rows times a shared tile transposed (scores), fp32 accumulators
// packed back into bf16 A fragments, and A fragments times a shared tile.
// A tile is kW columns wide: 64 (every head up to 64), or 128 for heads of
// 72-128 (tile_width), whose padded 272-byte rows keep ldmatrix free of bank
// conflicts as the 144-byte rows do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mma_tile {

constexpr int kHd = 64;       // a tile's width: the widest head dim the kernels take
constexpr int kRows = 64;     // q rows per block, and k/v rows per tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kLd = kHd + 8;  // padded shared row: 144 bytes, free of ldmatrix bank conflicts

// the tile width that holds a head of kD: 64, or 128 past 64
__host__ __device__ constexpr int tile_width(int kD) { return kD > kHd ? 2 * kHd : kHd; }

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + kRows) x hd columns (hd a multiple of 8, at most kD;
// kD = 48, 64 or 128) of one head's q, k or v slice into a kW-wide shared
// tile (kW = tile_width(kD)); rows >= n and columns >= hd are zeros. `ld`
// is the row stride in elements. kVec: 16-byte loads (the caller has
// checked the base pointer and the row stride). Called by all kWarps * 32
// threads of the block.
template <bool kVec, int kD = kHd, int kW = tile_width(kD)>
__device__ __forceinline__ void load_tile(bf16 (*dst)[kW + 8], const bf16* src,
                                          int row0, int n, int64_t ld, int hd = kD) {
  static_assert(kD % 16 == 0 && kD <= kW, "a head dim of whole 16-wide K-steps, at most kW");
  constexpr int kChunks = kRows * kW / 8;
  for (int i = threadIdx.x; i < kChunks; i += kWarps * 32) {
    const int r = i / (kW / 8);
    const int col = (i % (kW / 8)) * 8;
    const int row = row0 + r;
    const bool in = row < n && col < hd;
    const bf16* s = src + static_cast<int64_t>(row) * ld + col;
    if (kVec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) v = *reinterpret_cast<const uint4*>(s);
      *reinterpret_cast<uint4*>(&dst[r][col]) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[r][col + e] = in ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// A fragments of this warp's 16 rows (warp w: rows 16w..16w+15) of a
// 64 x kW shared tile, one per 16-wide step of the inner dimension.
template <int kW = kHd>
__device__ __forceinline__ void load_a(uint32_t (&af)[kW / 16][4], bf16 (*src)[kW + 8]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks)
    ldmatrix_x4(af[ks], &src[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
}

// acc (16 x 64) = a (16 x kW, A fragments) * b^T, b a 64 x kW shared tile
// (its rows are acc's columns): acc[nt] holds columns nt*8..nt*8+7.
template <int kW = kHd>
__device__ __forceinline__ void mma_abt(float (&acc)[kRows / 8][4],
                                        const uint32_t (&af)[kW / 16][4],
                                        bf16 (*sb)[kW + 8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < kRows / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kW / 32; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &sb[nt * 8 + (lane & 7)][kk * 32 + (lane >> 3) * 8]);
      mma_16816(acc[nt], af[2 * kk], bf[0], bf[1]);
      mma_16816(acc[nt], af[2 * kk + 1], bf[2], bf[3]);
    }
  }
}

// s = scale * a b^T (+ bias) for one warp's 16 rows (row_lo, row_hi = this
// thread's two accumulator rows) against the 64 rows of the shared tile
// that start at c0; columns >= n_cols are -inf. The bias is read at
// [row][col] (row stride bq, column stride 1), or at [col][row] when kTrans
// (the backward's transposed scores, whose rows are keys), only where
// row < n_rows and col < n_cols. Each 8-column slice's bias loads follow its
// own products, so that they overlap the next slice's.
template <bool kBias, bool kTrans = false, int kW = kHd>
__device__ __forceinline__ void tile_scores(float (&s)[kRows / 8][4],
                                            const uint32_t (&af)[kW / 16][4],
                                            bf16 (*sb)[kW + 8], const float* bias,
                                            int64_t bq, int row_lo, int row_hi,
                                            int c0, int n_rows, int n_cols, float scale) {
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kRows / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kW / 32; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &sb[nt * 8 + (lane & 7)][kk * 32 + (lane >> 3) * 8]);
      mma_16816(s[nt], af[2 * kk], bf[0], bf[1]);
      mma_16816(s[nt], af[2 * kk + 1], bf[2], bf[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_lo : row_hi;
      const int col = c0 + nt * 8 + t4 * 2 + (e & 1);
      float v = s[nt][e] * scale;
      if (kBias && row < n_rows && col < n_cols)
        v += kTrans ? bias[col * bq + row] : bias[row * bq + col];
      s[nt][e] = col < n_cols ? v : -INFINITY;
    }
  }
}

// The A fragments of x (16 x 64 fp32 accumulators) rounded to bf16, for a
// product over x's 64 columns.
__device__ __forceinline__ void pack_a(uint32_t (&af)[kRows / 16][4],
                                       const float (&x)[kRows / 8][4]) {
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
    af[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    af[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    af[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    af[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// acc (16 x kW) += a (16 x 64 over the tile's rows, A fragments) * b, b a
// 64 x kW shared tile read transposed by ldmatrix.
template <int kW = kHd>
__device__ __forceinline__ void mma_ab(float (&acc)[kW / 8][4],
                                       const uint32_t (&af)[kRows / 16][4],
                                       bf16 (*sb)[kW + 8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRows / 16; ++j) {
#pragma unroll
    for (int dp = 0; dp < kW / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &sb[j * 16 + (lane & 15)][dp * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * dp], af[j], bf[0], bf[1]);
      mma_16816(acc[2 * dp + 1], af[j], bf[2], bf[3]);
    }
  }
}

}  // namespace mma_tile
