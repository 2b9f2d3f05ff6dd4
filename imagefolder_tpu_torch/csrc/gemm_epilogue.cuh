// One tiled GEMM with fused epilogues, y = x W^T, shared by the fused ViT
// sublayers (attn_sublayer.cu, kernel #7; mlp_sublayer.cu, kernels #8 and
// #10). x is row-major (M, K); W is in PyTorch's (out, in) layout, (N, K):
// both operands are K-major, the "NT" shape of q k^T, so the ldmatrix and
// mma.sync m16n8k16 helpers of mma_tile.cuh serve both. M is ragged (rows
// masked); N and K must be multiples of 64 (the callers check).
//
// The epilogue is a template parameter, applied to the fp32 accumulators in
// registers before the only store; "round" is a rounding to the activation
// type (bf16, or nothing in fp32), b the bias and res the residual stream:
//   kDense      y = round(round(acc) + round(b))           flax Dense: #7's qkv
//   kDenseGelu  h = round(gelu(y)), erf in fp32              #8's fc1
//   kDenseLsRes out = fp32(res) + ls * fp32(y), stored fp32  #7's proj, #8's fc2
//   kBias32Gelu h = round(gelu(acc + b)), b fp32             #10's first product
//   kBias32     o = round(acc + b), b fp32                   #10's second
// In kDenseLsRes the multiply and the add are two roundings (__fmul_rn,
// __fadd_rn), as PyTorch computes res.float() + ls * y.
//
// bf16: 128 x 128 block tiles, a k-step of 32, eight warps of 64 x 32, a
// four-stage cp.async ring into shared rows padded to 80 bytes (ldmatrix
// reads free of bank conflicts; 80 KB, two blocks an SM), fp32 accumulators
// in registers. Rows of x past M load as zeros (cp.async's zero fill) and
// are never stored. fp32:
// exact FFMA tiles (64 x 64 per block of 256 threads, 4 x 4 outputs a
// thread, a k-step of 16), never TF32, so that fp32 runs on the card stay
// within summation order of the CPU's. wgmma, TMA and a persistent schedule
// are later work. Each entry instantiates the kernels with its own number
// (kId), so that a profile attributes their time to the right one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using mma_tile::bf16;
using mma_tile::ldmatrix_x4;
using mma_tile::mma_16816;
using mma_tile::smem_addr;

enum Epilogue : int { kDense = 0, kDenseGelu = 1, kDenseLsRes = 2, kBias32Gelu = 3, kBias32 = 4 };

// What the epilogue reads and writes beside the accumulators.
struct EpiArgs {
  const void* bias;  // (N,): the activation type for kDense*, fp32 for kBias32*
  const void* res;   // (M, N) residual stream for kDenseLsRes, bf16 (res_bf16) or fp32
  const float* ls;   // (N,) LayerScale for kDenseLsRes
  void* out;         // (M, N): fp32 for kDenseLsRes, else the activation type
  int res_bf16;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <bool kBf16>
__device__ __forceinline__ float round_act(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// The epilogue of one output element: its final value, already rounded to
// the type it is stored in.
template <int kEpi, bool kBf16>
__device__ __forceinline__ float epi_value(const EpiArgs& ea, int64_t row, int col, int n,
                                           float acc) {
  if (kEpi == kBias32Gelu || kEpi == kBias32) {
    const float t = acc + static_cast<const float*>(ea.bias)[col];
    return round_act<kBf16>(kEpi == kBias32Gelu ? gelu_erf(t) : t);
  }
  const float b = kBf16 ? __bfloat162float(static_cast<const bf16*>(ea.bias)[col])
                        : static_cast<const float*>(ea.bias)[col];
  const float y = round_act<kBf16>(round_act<kBf16>(acc) + b);
  if (kEpi == kDense) return y;
  if (kEpi == kDenseGelu) return round_act<kBf16>(gelu_erf(y));
  const int64_t i = row * n + col;
  const float r = ea.res_bf16 ? __bfloat162float(static_cast<const bf16*>(ea.res)[i])
                              : static_cast<const float*>(ea.res)[i];
  return __fadd_rn(r, __fmul_rn(ea.ls[col], y));
}

// Two neighbouring elements (col even) of one row, stored together.
template <int kEpi, bool kBf16>
__device__ __forceinline__ void epi_store_pair(const EpiArgs& ea, int64_t row, int col, int n,
                                               float a0, float a1) {
  const float v0 = epi_value<kEpi, kBf16>(ea, row, col, n, a0);
  const float v1 = epi_value<kEpi, kBf16>(ea, row, col + 1, n, a1);
  const int64_t i = row * n + col;
  if (kEpi == kDenseLsRes || !kBf16)
    *reinterpret_cast<float2*>(static_cast<float*>(ea.out) + i) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ea.out) + i) =
        __floats2bfloat162_rn(v0, v1);
}

// ------------------------------- bf16 ---------------------------------- //

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kGemmThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int kLdS = kBK + 8;      // padded shared row: 80 bytes
constexpr int kStages = 4;         // cp.async ring depth
// one stage's x and W tiles; four stages take 80 KB of dynamic shared memory
constexpr int kStageBytes = (kBM + kBN) * kLdS * static_cast<int>(sizeof(bf16));

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [r0, r0 + 128) x columns [k0, k0 + 32) of a K-major (rows, K) operand
// into shared memory, rows >= rows_n as zeros: 512 chunks of 16 bytes, two
// per thread.
__device__ __forceinline__ void load_stage(bf16 (*dst)[kLdS], const bf16* src, int r0,
                                           int rows_n, int k, int k0) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = threadIdx.x + t * kGemmThreads;
    const int r = c >> 2, col = (c & 3) * 8;
    const bool in = r0 + r < rows_n;
    const bf16* s = in ? src + static_cast<int64_t>(r0 + r) * k + k0 + col : src;
    cp_async16(&dst[r][col], s, in);
  }
}

template <int kId, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, int m, int n,
                     int k, EpiArgs ea) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*sa)[kBM][kLdS] = reinterpret_cast<bf16(*)[kBM][kLdS]>(smem);
  bf16(*sb)[kBN][kLdS] =
      reinterpret_cast<bf16(*)[kBN][kLdS]>(smem + kStages * kBM * kLdS * sizeof(bf16));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // prologue: the first kStages - 1 tiles in flight
    if (s < nk) {
      load_stage(sa[s], x, m0, m, k, s * kBK);
      load_stage(sb[s], w, n0, n, k, s * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every warp is done with tile kt - 1
    const int next = kt + kStages - 1;  // refills the buffer that tile kt - 1 used
    if (next < nk) {
      load_stage(sa[next % kStages], x, m0, m, k, next * kBK);
      load_stage(sb[next % kStages], w, n0, n, k, next * kBK);
    }
    cp_async_commit();  // possibly empty, so that the group count stays uniform
    const int s = kt % kStages;

    uint32_t bfr[4][4];  // per n-tile: k 0-7, 8-15 (first k16 step), 16-23, 24-31
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldmatrix_x4(bfr[j], &sb[s][wn * 32 + j * 8 + (lane & 7)][(lane >> 3) * 8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, &sa[s][wm * 64 + i * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], af, bfr[j][2 * ks], bfr[j][2 * ks + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r_lo = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + t4 * 2;
      if (col >= n) continue;
      if (r_lo < m) epi_store_pair<kEpi, true>(ea, r_lo, col, n, acc[i][j][0], acc[i][j][1]);
      if (r_lo + 8 < m)
        epi_store_pair<kEpi, true>(ea, r_lo + 8, col, n, acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ------------------------------- fp32 ---------------------------------- //

constexpr int kFT = 64, kFK = 16;  // 64 x 64 block tiles, k-step 16

template <int kId, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, int m, int n,
                    int k, EpiArgs ea) {
  __shared__ float sa[kFK][kFT + 4];  // transposed: [k][row]
  __shared__ float sb[kFK][kFT + 4];  // [k][col]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kFT * kFK; e += kGemmThreads) {
      const int r = e / kFK, kk = e % kFK;
      sa[kk][r] = m0 + r < m ? x[static_cast<int64_t>(m0 + r) * k + k0 + kk] : 0.f;
      sb[kk][r] = n0 + r < n ? w[static_cast<int64_t>(n0 + r) * k + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        b[i] = sb[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int col = n0 + tx * 4 + j;
      if (col < n) epi_store_pair<kEpi, false>(ea, row, col, n, acc[i][j], acc[i][j + 1]);
    }
  }
}

// Launches y = x W^T with epilogue kEpi on `stream`: x (M, K) and w (N, K)
// contiguous, both bf16 (is_bf16; 16-byte aligned) or both fp32. Returns
// cudaGetLastError() as an int (0 = launched).
template <int kId, int kEpi>
int launch_gemm(const void* x, const void* w, int m, int n, int k, const EpiArgs& ea,
                int is_bf16, cudaStream_t stm) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 64 || k % 64) return cudaErrorInvalidValue;
  if (is_bf16) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    constexpr int kSmem = kStages * kStageBytes;
    static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
        gemm_bf16_kernel<kId, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    gemm_bf16_kernel<kId, kEpi><<<grid, kGemmThreads, kSmem, stm>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), m, n, k, ea);
  } else {
    const dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT);
    gemm_f32_kernel<kId, kEpi><<<grid, kGemmThreads, 0, stm>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, n, k, ea);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
