// Packed-qkv attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _attention_qkv_fwd_impl (kernel body _qkv_kernel_impl): per (batch, head),
// softmax(q k^T * scale + bias) v, with q, k and v read straight from the
// (B, N, 3C) output of the fused qkv projection (head h at columns h*hd,
// C + h*hd and 2C + h*hd) and the result written as (B, N, C), head h at
// columns h*hd. The optional bias is fp32 (N, N), shared by batches and heads,
// and may hold -inf.
//
// What bounds it on this card: at the tokenizer's N = 513/514 and hd = 64 a
// (b, h) pair does 4*N*N*hd = 67.6 MFLOP on 263 KB of compulsory bf16
// traffic (q, k, v in, o out), about 257 FLOP per byte: near the H100's
// bf16 ridge (989 TFLOP/s over 3.35 TB/s, ~295), and mma.sync reaches only
// part of the wgmma peak while the k/v tiles are re-read from L2 by every
// q tile, so in practice it is compute-bound on the two products q k^T, p v.
//
// What the design does about it: the TPU kernel kept one whole (Np, Np) fp32
// score tile per head in VMEM; a Hopper block has no room for that. Here one
// block of four warps owns 64 q rows of one (b, h). Its q fragments stay in
// registers, it streams 64-row k/v tiles through shared memory, and it keeps
// a running max and row sum (online softmax) with fp32 accumulators, so no
// score ever reaches device memory. Both products run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the score accumulator
// is reused in registers as the A operand of p v. Shared rows are padded to
// 144 bytes so that ldmatrix reads are free of bank conflicts. Ragged N:
// k/v rows >= N load as zeros and their scores are -inf before the max;
// q rows >= N are computed but never stored. wgmma, TMA and a pipelined
// k/v ring are later work.
//
// bf16 numerics follow the TPU kernel: fp32 scores and softmax, p rounded to
// bf16 before p v, the row sum taken on the fp32 p, o / l at the end.
// fp32 inputs (the ModelArgs default dtype) take a plain FMA kernel with the
// same tiling of rows and the same online softmax, exact to fp32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kNegInf = -INFINITY;

template <bool kVec, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
    attn_qkv_bf16_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         int n, int c, float scale) {
  __shared__ __align__(16) bf16 sq[kRows][kLd];
  __shared__ __align__(16) bf16 sk[kRows][kLd];
  __shared__ __align__(16) bf16 sv[kRows][kLd];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator row within the warp's 8-row half
  const int t4 = lane & 3;  // accumulator column pair
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t ld = 3 * static_cast<int64_t>(c);
  const bf16* base = qkv + static_cast<int64_t>(b) * n * ld;

  load_tile<kVec>(sq, base + h * kHd, q0, n, ld);
  __syncthreads();
  uint32_t qf[kHd / 16][4];  // A fragments, one per 16-wide k step
#pragma unroll
  for (int ks = 0; ks < kHd / 16; ++ks)
    ldmatrix_x4(qf[ks], &sq[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  float o[kHd / 8][4];
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < n; k0 += kRows) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<kVec>(sk, base + c + h * kHd, k0, n, ld);
    load_tile<kVec>(sv, base + 2 * c + h * kHd, k0, n, ld);
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kRows / 8][4];
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHd / 32; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &sk[nt * 8 + (lane & 7)][kk * 32 + (lane >> 3) * 8]);
        mma_16816(s[nt], qf[2 * kk], kf[0], kf[1]);
        mma_16816(s[nt], qf[2 * kk + 1], kf[2], kf[3]);
      }
    }

    // scale, bias, ragged-column mask; row max over the tile
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float v = s[nt][e] * scale;
        if (kBias && row < n && col < n)
          v += bias[static_cast<int64_t>(row) * n + col];
        if (col >= n) v = kNegInf;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row whose every score so far is -inf: exponentiate against 0 so
      // that exp(-inf - -inf) never makes a NaN; its p and alpha are 0
      mu[r] = m_new == kNegInf ? 0.f : m_new;
      const float alpha = __expf(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < kHd / 8; ++i) {
        o[i][2 * r] *= alpha;
        o[i][2 * r + 1] *= alpha;
      }
    }

    // p = exp(s - m): fp32 row sums, bf16 A fragments for p v
    uint32_t pf[kRows / 16][4];
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      pf[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }

    // o += p v: k steps of 16 keys, n-tiles of 8 head columns in pairs
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < kHd / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sv[j * 16 + (lane & 15)][dp * 16 + (lane >> 4) * 8]);
        mma_16816(o[2 * dp], pf[j], vf[0], vf[1]);
        mma_16816(o[2 * dp + 1], pf[j], vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* dst = out + static_cast<int64_t>(b) * n * c + h * kHd + t4 * 2;
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) {
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(row_lo) * c + i * 8) =
          __floats2bfloat162_rn(o[i][0] / l[0], o[i][1] / l[0]);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(row_hi) * c + i * 8) =
          __floats2bfloat162_rn(o[i][2] / l[1], o[i][3] / l[1]);
  }
}

// fp32: one thread per q row, 64 rows per block, 32-row k/v tiles in shared
// memory read by broadcast; q and o stay in registers.
constexpr int kF32Tile = 32;

template <bool kBias>
__global__ void __launch_bounds__(kRows)
    attn_qkv_f32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int n, int c, float scale) {
  __shared__ float sk[kF32Tile][kHd];
  __shared__ float sv[kF32Tile][kHd];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t ld = 3 * static_cast<int64_t>(c);
  const float* base = qkv + static_cast<int64_t>(b) * n * ld;
  const float* kp = base + c + h * kHd;
  const float* vp = base + 2 * c + h * kHd;

  float q[kHd], o[kHd];
#pragma unroll
  for (int d = 0; d < kHd; ++d) {
    q[d] = row < n ? base[static_cast<int64_t>(row) * ld + h * kHd + d] : 0.f;
    o[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * kHd; i += kRows) {
      const int r = i / kHd, d = i % kHd;
      const int64_t off = static_cast<int64_t>(k0 + r) * ld + d;
      sk[r][d] = k0 + r < n ? kp[off] : 0.f;
      sv[r][d] = k0 + r < n ? vp[off] : 0.f;
    }
    __syncthreads();

    float s[kF32Tile];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHd; ++d) acc = fmaf(q[d], sk[j][d], acc);
      const int col = k0 + j;
      float v = acc * scale;
      if (kBias && row < n && col < n) v += bias[static_cast<int64_t>(row) * n + col];
      if (col >= n) v = kNegInf;
      s[j] = v;
      mx = fmaxf(mx, v);
    }
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == kNegInf ? 0.f : m_new;  // see the bf16 kernel
    const float alpha = expf(m - mu);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHd; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float p = expf(s[j] - mu);
      l += p;
#pragma unroll
      for (int d = 0; d < kHd; ++d) o[d] = fmaf(p, sv[j][d], o[d]);
    }
  }
  if (row < n) {
    float* dst = out + (static_cast<int64_t>(b) * n + row) * c + h * kHd;
#pragma unroll
    for (int d = 0; d < kHd; ++d) dst[d] = o[d] / l;
  }
}

}  // namespace

// qkv (B, N, 3C) and out (B, N, C), contiguous, fp32 or bf16 (is_bf16);
// bias null or fp32 (N, N) contiguous. C must be heads * 64. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int attention_qkv_fwd(const void* qkv, const void* bias, void* out,
                                 int batch, int n, int c, int heads,
                                 float scale, int is_bf16, void* stream) {
  if (c != heads * kHd || n <= 0 || batch <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (is_bf16) {
    const bf16* x = static_cast<const bf16*>(qkv);
    bf16* y = static_cast<bf16*>(out);
    // head offsets are multiples of 64 elements; 16-byte loads need the base
    // and the row stride (3C elements of 2 bytes) on 16-byte boundaries
    const bool vec = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && (3 * c) % 8 == 0;
    const dim3 block(kWarps * 32);
    if (vec && bp)
      attn_qkv_bf16_kernel<true, true><<<grid, block, 0, st>>>(x, bp, y, n, c, scale);
    else if (vec)
      attn_qkv_bf16_kernel<true, false><<<grid, block, 0, st>>>(x, bp, y, n, c, scale);
    else if (bp)
      attn_qkv_bf16_kernel<false, true><<<grid, block, 0, st>>>(x, bp, y, n, c, scale);
    else
      attn_qkv_bf16_kernel<false, false><<<grid, block, 0, st>>>(x, bp, y, n, c, scale);
  } else {
    const float* x = static_cast<const float*>(qkv);
    float* y = static_cast<float*>(out);
    if (bp)
      attn_qkv_f32_kernel<true><<<grid, kRows, 0, st>>>(x, bp, y, n, c, scale);
    else
      attn_qkv_f32_kernel<false><<<grid, kRows, 0, st>>>(x, bp, y, n, c, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
