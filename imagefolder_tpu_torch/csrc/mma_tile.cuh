// Warp-level tensor-core helpers shared by the attention kernels
// (attention_qkv.cu, attention_bnhd.cu): ldmatrix loads from shared memory,
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators, and a 64-row,
// 64-column bf16 tile loader with zero rows past the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

constexpr int kHd = 64;       // head dim the kernels are built for
constexpr int kRows = 64;     // q rows per block, and k/v rows per tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kLd = kHd + 8;  // padded shared row: 144 bytes, free of ldmatrix bank conflicts

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

// Rows [row0, row0 + kRows) x kHd columns of one head's q, k or v slice into
// shared memory; rows >= n are zeros. `ld` is the row stride in elements.
// kVec: 16-byte loads (the caller has checked the base pointer and the row
// stride). Called by all kWarps * 32 threads of the block.
template <bool kVec>
__device__ __forceinline__ void load_tile(bf16 (*dst)[kLd], const bf16* src,
                                          int row0, int n, int64_t ld) {
  constexpr int kChunks = kRows * kHd / 8;
  for (int i = threadIdx.x; i < kChunks; i += kWarps * 32) {
    const int r = i / (kHd / 8);
    const int col = (i % (kHd / 8)) * 8;
    const int row = row0 + r;
    const bf16* s = src + static_cast<int64_t>(row) * ld + col;
    if (kVec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < n) v = *reinterpret_cast<const uint4*>(s);
      *reinterpret_cast<uint4*>(&dst[r][col]) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[r][col + e] = row < n ? s[e] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace mma_tile
