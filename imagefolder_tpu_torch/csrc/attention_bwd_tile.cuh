// Self-attention backward device code, in fp32 or when dbias is asked
// for, of the packed-qkv backward (attention_qkv_bwd.cu, kernel #2), the
// q-blocked backward (attention_qblk_bwd.cu, kernel #5) and the BNHD
// backward (attention_bnhd_bwd.cu, kernel #6), whose other bf16 calls run
// attention_bwd_sm90.cuh: the three compute the same per-head
// math (the TPU kernels' _bwd_head_math) and differ only in where q, k, v, g
// and the three gradients live, which the strides below carry. Each entry
// instantiates the kernels with its own number (kId), so that a profile
// attributes their time to the right one.
//
// Per (batch, head), with rows >= n masked:
//   p  = softmax(q k^T * scale + bias), fp32, divided by its row sum
//   dv = bf16(p)^T g            dp = g v^T (fp32)
//   ds = p (dp - rowsum(p dp)), on the fp32 p
//   dq = bf16(ds) k * scale     dk = bf16(ds)^T q * scale
//   dbias = the sum of ds over batches and heads (fp32), when asked for
// ("bf16" is the inputs' type). Two kernels each own their outputs, so no
// sum crosses blocks (a CUDA grid has no order, unlike the TPU grid that
// carried dbias from step to step):
//   A, per (b, h, 64 q rows): pass 1 gets each row's max m and sum l
//     (online); pass 2 gets delta = rowsum(p dp); pass 3 accumulates dq over
//     the k/v tiles in registers. It writes dq, and m, l and delta
//     (B*H*n fp32 each) to scratch.
//   B, per (b, h, 64 k rows): one pass over the q tiles recomputes the
//     transposed scores k q^T, p^T from m and l, dp^T = v g^T and ds^T from
//     delta, and accumulates dv += bf16(p^T) g and dk += bf16(ds^T) q in
//     registers; each block writes its dk and dv rows once.
// No score, probability or ds goes to device memory. The products run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with 64-row tiles through
// shared memory (mma_tile.cuh), four warps of 16 rows per block. dbias is an
// fp32 atomicAdd of every non-zero ds into a zeroed (n, n) buffer from
// kernel A: its summation order changes from run to run. fp32 inputs take
// FMA kernels with two threads per row (each owns 32 of the 64 columns,
// interleaved so that the pair reads two banks), with the same two-kernel
// split. Masked tiles are not skipped, and nothing is pipelined.
// Head dim kD: 64, or 48 and 128 for #5 and #6, and at run time st.hd, any
// multiple of 8 up to kD (#5 and #6 run hd <= 48 under kD = 48, 56 under 64
// and 72-128 under 128: there in bf16 only for a call that asks for dbias,
// and #6 at L = 1; every other bf16 call at 72-128 runs
// attention_bwd_sm90.cuh). The bf16 kernels run a narrower head on
// zero-padded 64-wide tiles, and a head of 72-128 on 128-wide ones
// (mma_tile.cuh: tile_width), and store its hd columns; the fp32 kernels
// hold kD columns, zero past hd, and store hd. At kD = 128 kernel A stages
// q and g through the k tile's buffer, which keeps its two 128-wide tiles
// within the 48 KB of static shared memory (three would not fit).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kBwdNegInf = -INFINITY;

// Element strides (hd stride 1) of the inputs q, k, v and g and of the
// outputs dq, dk and dv (one set, o*, shared by the three), each as batch,
// row and head strides; the shared bias's row stride (column stride 1); and
// the head dim hd (a multiple of 8, at most the kernel's kD).
struct BwdStrides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, gb, gl, gh, ob, ol, oh, bq;
  int hd = kHd;
};

// a warp's 16 accumulator rows (row_lo, row_hi per thread) times `mul`,
// rounded to bf16, into the output rows of (b, h): their first st.hd columns
template <int kD, int kW = tile_width(kD)>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kW / 8][4],
                                           int b, int h, int n, const BwdStrides& st,
                                           int row_lo, int row_hi, float mul) {
  bf16* dst = out + b * st.ob + h * st.oh + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    if (i * 8 >= st.hd) break;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_lo * st.ol + i * 8) =
          __floats2bfloat162_rn(acc[i][0] * mul, acc[i][1] * mul);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_hi * st.ol + i * 8) =
          __floats2bfloat162_rn(acc[i][2] * mul, acc[i][3] * mul);
  }
}

// sum over the four threads that hold one accumulator row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Kernel A, bf16: dq, and the row statistics m, l and delta, for 64 q rows
// of one (b, h); kDbias adds ds into dbias.
template <int kId, int kD, bool kVec, bool kBias, bool kDbias>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ g,
                            const float* __restrict__ bias, bf16* __restrict__ dq,
                            float* __restrict__ dbias, float* __restrict__ stats, int n,
                            int heads, float scale, BwdStrides st) {
  constexpr int kW = tile_width(kD);
  __shared__ __align__(16) bf16 sk[kRows][kW + 8];
  __shared__ __align__(16) bf16 sv[kRows][kW + 8];
  // the q tile, then the g tile: its own buffer up to 64 wide, k's past it
  __shared__ __align__(16) bf16 sa_own[kW > kHd ? 1 : kRows][kW + 8];
  bf16 (*sa)[kW + 8] = sa_own;
  if (kW > kHd) sa = sk;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;

  uint32_t qf[kW / 16][4], gf[kW / 16][4];
  load_tile<kVec, kD>(sa, q + b * st.qb + h * st.qh, q0, n, st.ql, st.hd);
  __syncthreads();
  load_a<kW>(qf, sa);
  __syncthreads();
  load_tile<kVec, kD>(sa, g + b * st.gb + h * st.gh, q0, n, st.gl, st.hd);
  __syncthreads();
  load_a<kW>(gf, sa);

  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;
  float s[kRows / 8][4], dp[kRows / 8][4];

  // pass 1: row max and row sum (online, as the forward's first pass)
  float m[2] = {kBwdNegInf, kBwdNegInf};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kRows) {
    __syncthreads();
    load_tile<kVec, kD>(sk, kp, k0, n, st.kl, st.hd);
    __syncthreads();
    tile_scores<kBias, false, kW>(s, qf, sk, bias, st.bq, row_lo, row_hi, k0, n, n, scale);
    float mx[2] = {kBwdNegInf, kBwdNegInf};
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == kBwdNegInf ? 0.f : m_new;
      l[r] *= __expf(m[r] - mu[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(s[nt][e] - mu[e >> 1]);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    mu[r] = m[r] == kBwdNegInf ? 0.f : m[r];
  }

  // pass 2: delta = rowsum(p dp)
  float delta[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kRows) {
    __syncthreads();
    load_tile<kVec, kD>(sk, kp, k0, n, st.kl, st.hd);
    load_tile<kVec, kD>(sv, vp, k0, n, st.vl, st.hd);
    __syncthreads();
    tile_scores<kBias, false, kW>(s, qf, sk, bias, st.bq, row_lo, row_hi, k0, n, n, scale);
    mma_abt<kW>(dp, gf, sv);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        delta[e >> 1] += __expf(s[nt][e] - mu[e >> 1]) / l[e >> 1] * dp[nt][e];
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  // pass 3: dq = bf16(ds) k, accumulated over the k tiles
  float acc[kW / 8][4];
#pragma unroll
  for (int i = 0; i < kW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kRows) {
    __syncthreads();
    load_tile<kVec, kD>(sk, kp, k0, n, st.kl, st.hd);
    load_tile<kVec, kD>(sv, vp, k0, n, st.vl, st.hd);
    __syncthreads();
    tile_scores<kBias, false, kW>(s, qf, sk, bias, st.bq, row_lo, row_hi, k0, n, n, scale);
    mma_abt<kW>(dp, gf, sv);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = __expf(s[nt][e] - mu[r]) / l[r];
        const float ds = p * (dp[nt][e] - delta[r]);
        s[nt][e] = ds;
        if (kDbias) {
          const int row = r ? row_hi : row_lo;
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          if (row < n && col < n && ds != 0.f)
            atomicAdd(dbias + static_cast<int64_t>(row) * n + col, ds);
        }
      }
    }
    uint32_t dsf[kRows / 16][4];
    pack_a(dsf, s);
    mma_ab<kW>(acc, dsf, sk);
  }
  store_rows<kD>(dq, acc, b, h, n, st, row_lo, row_hi, scale);

  if (t4 == 0) {
    const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
    float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_hi : row_lo;
      if (row < n) {
        row_stats[row] = mu[r];
        row_stats[plane + row] = l[r];
        row_stats[2 * plane + row] = delta[r];
      }
    }
  }
}

// Kernel B, bf16: dk and dv for 64 k rows of one (b, h), from the row
// statistics that kernel A wrote.
template <int kId, int kD, bool kVec, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ bias,
                              const float* __restrict__ stats, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int n, int heads, float scale,
                              BwdStrides st) {
  constexpr int kW = tile_width(kD);
  __shared__ __align__(16) bf16 sq[kRows][kW + 8];  // the k tile, then q tiles
  __shared__ __align__(16) bf16 sg[kRows][kW + 8];  // the v tile, then g tiles
  __shared__ float sm[kRows], sl[kRows], sd[kRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* gp = g + b * st.gb + h * st.gh;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
  const float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;

  uint32_t kf[kW / 16][4], vf[kW / 16][4];
  load_tile<kVec, kD>(sq, k + b * st.kb + h * st.kh, k0, n, st.kl, st.hd);
  load_tile<kVec, kD>(sg, v + b * st.vb + h * st.vh, k0, n, st.vl, st.hd);
  __syncthreads();
  load_a<kW>(kf, sq);
  load_a<kW>(vf, sg);

  const int row_lo = k0 + warp * 16 + (lane >> 2);  // key rows
  const int row_hi = row_lo + 8;
  float dk_acc[kW / 8][4], dv_acc[kW / 8][4];
#pragma unroll
  for (int i = 0; i < kW / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }
  float s[kRows / 8][4], dp[kRows / 8][4];
  for (int q0 = 0; q0 < n; q0 += kRows) {
    __syncthreads();
    load_tile<kVec, kD>(sq, qp, q0, n, st.ql, st.hd);
    load_tile<kVec, kD>(sg, gp, q0, n, st.gl, st.hd);
    for (int i = threadIdx.x; i < kRows; i += kWarps * 32) {
      const bool in = q0 + i < n;  // a row past the end gets p = 0 (its score is -inf)
      sm[i] = in ? row_stats[q0 + i] : 0.f;
      sl[i] = in ? row_stats[plane + q0 + i] : 1.f;
      sd[i] = in ? row_stats[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are keys, columns queries
    tile_scores<kBias, true, kW>(s, kf, sq, bias, st.bq, row_lo, row_hi, q0, n, n, scale);
    mma_abt<kW>(dp, vf, sg);  // dp^T = v g^T
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + t4 * 2 + (e & 1);
        const float p = __expf(s[nt][e] - sm[c]) / sl[c];
        dp[nt][e] = p * (dp[nt][e] - sd[c]);  // ds^T
        s[nt][e] = p;
      }
    }
    uint32_t af[kRows / 16][4];
    pack_a(af, s);
    mma_ab<kW>(dv_acc, af, sg);
    pack_a(af, dp);
    mma_ab<kW>(dk_acc, af, sq);
  }
  store_rows<kD>(dk, dk_acc, b, h, n, st, row_lo, row_hi, scale);
  store_rows<kD>(dv, dv_acc, b, h, n, st, row_lo, row_hi, 1.f);
}

// fp32: two threads per row, each holding the columns 2i + half of its
// row's vectors in registers (kD / 2 each); 32-row tiles of the other side
// in shared memory.
constexpr int kF32Tile = 32;

// the dot product of a row pair's registers with shared row `x`
template <int kHalf>
__device__ __forceinline__ float pair_dot(const float (&r)[kHalf], const float* x, int half) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) a = fmaf(r[i], x[2 * i + half], a);
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

template <int kId, int kD, bool kBias, bool kDbias>
__global__ void __launch_bounds__(2 * kRows)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ g,
                           const float* __restrict__ bias, float* __restrict__ dq,
                           float* __restrict__ dbias, float* __restrict__ stats, int n,
                           int heads, float scale, BwdStrides st) {
  constexpr int kHalf = kD / 2;
  __shared__ float sk[kF32Tile][kD];
  __shared__ float sv[kF32Tile][kD];

  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 1);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* qp = q + b * st.qb + h * st.qh + static_cast<int64_t>(in ? row : 0) * st.ql;
  const float* gp = g + b * st.gb + h * st.gh + static_cast<int64_t>(in ? row : 0) * st.gl;
  const float* brow = kBias ? bias + static_cast<int64_t>(in ? row : 0) * st.bq : nullptr;

  float qr[kHalf], gr[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const bool col = in && 2 * i + half < st.hd;
    qr[i] = col ? qp[2 * i + half] : 0.f;
    gr[i] = col ? gp[2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = kBwdNegInf, l = 0.f, delta = 0.f;
  for (int pass = 0; pass < 3; ++pass) {  // m and l; delta; dq
    const float mu = m == kBwdNegInf ? 0.f : m;
    for (int k0 = 0; k0 < n; k0 += kF32Tile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32Tile * kD; i += 2 * kRows) {
        const int r = i / kD, d = i % kD;
        const bool kin = k0 + r < n && d < st.hd;
        sk[r][d] = kin ? kp[(k0 + r) * st.kl + d] : 0.f;
        if (pass > 0) sv[r][d] = kin ? vp[(k0 + r) * st.vl + d] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kF32Tile; ++j) {
        const int col = k0 + j;
        float s = pair_dot(qr, sk[j], half) * scale;
        if (kBias && in && col < n) s += brow[col];
        if (col >= n) s = kBwdNegInf;
        if (pass == 0) {
          if (s > m) {
            l = l * expf(m - s) + 1.f;
            m = s;
          } else if (s != kBwdNegInf) {
            l += expf(s - m);
          }
          continue;
        }
        const float dpv = pair_dot(gr, sv[j], half);
        const float p = expf(s - mu) / l;
        if (pass == 1) {
          delta = fmaf(p, dpv, delta);
          continue;
        }
        const float ds = p * (dpv - delta);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) acc[i] = fmaf(ds, sk[j][2 * i + half], acc[i]);
        if (kDbias && half == 0 && in && col < n && ds != 0.f)
          atomicAdd(dbias + static_cast<int64_t>(row) * n + col, ds);
      }
    }
  }
  if (in) {
    float* dst = dq + b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + half;
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      if (2 * i + half < st.hd) dst[2 * i] = acc[i] * scale;
    if (half == 0) {
      const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
      float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n + row;
      row_stats[0] = m == kBwdNegInf ? 0.f : m;
      row_stats[plane] = l;
      row_stats[2 * plane] = delta;
    }
  }
}

template <int kId, int kD, bool kBias>
__global__ void __launch_bounds__(2 * kRows)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ g,
                             const float* __restrict__ bias,
                             const float* __restrict__ stats, float* __restrict__ dk,
                             float* __restrict__ dv, int n, int heads, float scale,
                             BwdStrides st) {
  constexpr int kHalf = kD / 2;
  __shared__ float sq[kF32Tile][kD];
  __shared__ float sg[kF32Tile][kD];
  __shared__ float sm[kF32Tile], sl[kF32Tile], sd[kF32Tile];

  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 1);  // a key row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* gp = g + b * st.gb + h * st.gh;
  const float* kp = k + b * st.kb + h * st.kh + static_cast<int64_t>(in ? row : 0) * st.kl;
  const float* vp = v + b * st.vb + h * st.vh + static_cast<int64_t>(in ? row : 0) * st.vl;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
  const float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;

  float kr[kHalf], vr[kHalf], dka[kHalf], dva[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const bool col = in && 2 * i + half < st.hd;
    kr[i] = col ? kp[2 * i + half] : 0.f;
    vr[i] = col ? vp[2 * i + half] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  for (int q0 = 0; q0 < n; q0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * kD; i += 2 * kRows) {
      const int r = i / kD, d = i % kD;
      const bool qin = q0 + r < n && d < st.hd;
      sq[r][d] = qin ? qp[(q0 + r) * st.ql + d] : 0.f;
      sg[r][d] = qin ? gp[(q0 + r) * st.gl + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32Tile; i += 2 * kRows) {
      const bool qin = q0 + i < n;
      sm[i] = qin ? row_stats[q0 + i] : 0.f;
      sl[i] = qin ? row_stats[plane + q0 + i] : 1.f;
      sd[i] = qin ? row_stats[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      const int col = q0 + j;  // a query
      float s = pair_dot(kr, sq[j], half) * scale;
      if (kBias && in && col < n) s += bias[static_cast<int64_t>(col) * st.bq + row];
      if (col >= n) s = kBwdNegInf;
      const float dpv = pair_dot(vr, sg[j], half);
      const float p = expf(s - sm[j]) / sl[j];
      const float ds = p * (dpv - sd[j]);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        dva[i] = fmaf(p, sg[j][2 * i + half], dva[i]);
        dka[i] = fmaf(ds, sq[j][2 * i + half], dka[i]);
      }
    }
  }
  if (in) {
    const int64_t off = b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + half;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if (2 * i + half >= st.hd) break;
      dk[off + 2 * i] = dka[i] * scale;
      dv[off + 2 * i] = dva[i];
    }
  }
}

template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *g;
  const float* bias;
  T *dq, *dk, *dv;
  float *dbias, *stats;
  int n, heads;
  float scale;
  BwdStrides st;
};

template <int kId, int kD, bool kVec>
void launch_bwd_bf16(const BwdArgs<bf16>& a, dim3 grid, cudaStream_t stm) {
  const dim3 block(kWarps * 32);
  if (a.dbias)
    attn_bwd_dq_bf16_kernel<kId, kD, kVec, true, true><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  else if (a.bias)
    attn_bwd_dq_bf16_kernel<kId, kD, kVec, true, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  else
    attn_bwd_dq_bf16_kernel<kId, kD, kVec, false, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  if (a.bias)
    attn_bwd_dkdv_bf16_kernel<kId, kD, kVec, true><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.stats, a.dk, a.dv, a.n, a.heads, a.scale, a.st);
  else
    attn_bwd_dkdv_bf16_kernel<kId, kD, kVec, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.stats, a.dk, a.dv, a.n, a.heads, a.scale, a.st);
}

template <int kId, int kD>
void launch_bwd_f32(const BwdArgs<float>& a, dim3 grid, cudaStream_t stm) {
  const dim3 block(2 * kRows);
  if (a.dbias)
    attn_bwd_dq_f32_kernel<kId, kD, true, true><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  else if (a.bias)
    attn_bwd_dq_f32_kernel<kId, kD, true, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  else
    attn_bwd_dq_f32_kernel<kId, kD, false, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.dq, a.dbias, a.stats, a.n, a.heads, a.scale, a.st);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  if (a.bias)
    attn_bwd_dkdv_f32_kernel<kId, kD, true><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.stats, a.dk, a.dv, a.n, a.heads, a.scale, a.st);
  else
    attn_bwd_dkdv_f32_kernel<kId, kD, false><<<grid, block, 0, stm>>>(
        a.q, a.k, a.v, a.g, a.bias, a.stats, a.dk, a.dv, a.n, a.heads, a.scale, a.st);
}

// Kernel A then kernel B on `stream` for q, k, v, g (inputs) and dq, dk, dv
// (outputs, (B, n, H, kD)) at the strides `st`, all fp32 or all bf16 (is_bf16); bias null or
// an fp32 (n, n) whose row stride is st.bq; dbias null (not wanted) or a
// zeroed fp32 (n, n); stats an fp32 scratch of 3 * batch * heads * n.
// Returns cudaGetLastError() as an int (0 = both launched). kId is the
// kernel's number (#2, #5, #6): it only names the instantiations, so that a
// profile tells the three entries apart.
template <int kId, int kD = kHd>
int launch_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                         const void* bias, void* dq, void* dk, void* dv, void* dbias,
                         void* stats, int batch, int n, int heads, const BwdStrides& st,
                         float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (dbias && !bias)) return cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  const float* bp = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(dbias);
  float* sp = static_cast<float*>(stats);
  if (is_bf16) {
    const BwdArgs<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(g), bp,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), dbp, sp, n, heads, scale, st};
    // 16-byte loads need every input base pointer and stride on a 16-byte
    // (8-element) boundary
    const int64_t in_strides[12] = {st.qb, st.ql, st.qh, st.kb, st.kl, st.kh,
                                    st.vb, st.vl, st.vh, st.gb, st.gl, st.gh};
    bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(g) % 16 == 0;
    for (int i = 0; i < 12; ++i) vec = vec && in_strides[i] % 8 == 0;
    if (vec)
      launch_bwd_bf16<kId, kD, true>(a, grid, stm);
    else
      launch_bwd_bf16<kId, kD, false>(a, grid, stm);
  } else {
    const BwdArgs<float> a{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(g), bp,
                           static_cast<float*>(dq), static_cast<float*>(dk),
                           static_cast<float*>(dv), dbp, sp, n, heads, scale, st};
    launch_bwd_f32<kId, kD>(a, grid, stm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
