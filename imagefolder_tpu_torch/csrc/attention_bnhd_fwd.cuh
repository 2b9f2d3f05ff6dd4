// The BNHD forward's launch at one compiled head dim kD (attention_bnhd.cu
// at kD = 48 and 64, attention_bnhd_hd128.cu at 128): the bf16 wgmma kernel
// of attention_fwd_sm90.cuh, or the fp32 FMA kernel below, which holds q
// and o in registers (at kD = 128 ptxas spills part of them: a first
// version, right before fast).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_sm90.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kNegInf = -INFINITY;

// element strides of a (B, L, H, hd) view (hd stride 1) and of the bias
// (1|B, 1|H, Lq, Lk) view (Lk stride 1; 0 on a broadcast axis)
using Strides = sm90::FwdStrides;

// fp32: one thread per q row, 64 rows per block, 32-row k/v tiles in shared
// memory read by broadcast; q and o stay in registers. Past a 64-wide head
// the loops over a tile's keys are not unrolled: q and o spill either way,
// and unrolled they made the kD = 128 source ptxas's longest.
constexpr int kF32Tile = 32;

template <int kD, bool kBias>
__global__ void __launch_bounds__(kRows)
    attn_bnhd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ out, int lq, int lk, int heads,
                         float scale, Strides st) {
  __shared__ float sk[kF32Tile][kD];
  __shared__ float sv[kF32Tile][kD];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh + row * st.bq : nullptr;

  float qr[kD], o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row < lq && d < st.hd ? qp[row * st.ql + d] : 0.f;
    o[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const float mu = m == kNegInf ? 0.f : m;  // pass 2: the final max
    for (int k0 = 0; k0 < lk; k0 += kF32Tile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32Tile * kD; i += kRows) {
        const int r = i / kD, d = i % kD;
        const bool in = k0 + r < lk && d < st.hd;
        sk[r][d] = in ? kp[(k0 + r) * st.kl + d] : 0.f;
        if (pass == 1) sv[r][d] = in ? vp[(k0 + r) * st.vl + d] : 0.f;
      }
      __syncthreads();

      float sc[kF32Tile];
      float mx = kNegInf;
#pragma unroll(kD > kHd ? 1 : kF32Tile)
      for (int j = 0; j < kF32Tile; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc = fmaf(qr[d], sk[j][d], acc);
        const int col = k0 + j;
        float x = acc * scale;
        if (kBias && row < lq && col < lk) x += bp[col];
        sc[j] = col < lk ? x : kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      if (pass == 0) {
        const float m_new = fmaxf(m, mx);
        const float mu_new = m_new == kNegInf ? 0.f : m_new;
        l *= expf(m - mu_new);
        m = m_new;
#pragma unroll(kD > kHd ? 1 : kF32Tile)
        for (int j = 0; j < kF32Tile; ++j) l += expf(sc[j] - mu_new);
      } else {
#pragma unroll(kD > kHd ? 1 : kF32Tile)
        for (int j = 0; j < kF32Tile; ++j) {
          const float p = expf(sc[j] - mu) / l;
#pragma unroll
          for (int d = 0; d < kD; ++d) o[d] = fmaf(p, sv[j][d], o[d]);
        }
      }
    }
  }
  if (row < lq) {
    float* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * st.hd;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d < st.hd) dst[d] = o[d];
  }
}

template <int kD>
int launch_bnhd_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
                    void* lse, int batch, int lq, int lk, int heads, const Strides& st,
                    float scale, int is_bf16, cudaStream_t stm) {
  if (is_bf16)
    return sm90::launch_attention_fwd_sm90<3, kD>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bias, static_cast<bf16*>(out), static_cast<float*>(lse), batch, lq, lk, heads, st, scale,
        stm);
  const dim3 grid((lq + kRows - 1) / kRows, heads, batch);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  if (bias)
    attn_bnhd_f32_kernel<kD, true><<<grid, kRows, 0, stm>>>(qp, kp, vp, bias, op, lq, lk, heads,
                                                            scale, st);
  else
    attn_bnhd_f32_kernel<kD, false><<<grid, kRows, 0, stm>>>(qp, kp, vp, bias, op, lq, lk, heads,
                                                             scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

