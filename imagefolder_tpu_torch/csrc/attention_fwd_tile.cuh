// Attention forward with o / l taken after p v, shared by the packed-qkv
// forward (attention_qkv.cu, kernel #1), the q-blocked BNHD forward
// (attention_qblk.cu, kernel #4) and #7's attention step (attn_sublayer.cu):
// the TPU kernels compute the same per-head math (_qkv_kernel_impl,
// _kernel_qblk) and differ only in where q, k and v live, which the strides
// carry. Each entry instantiates the kernels with its own number (kId), so
// that a profile attributes their time to the right one.
//
// Per (batch, head), with key columns >= Lk masked:
//   s = q k^T * scale + bias (fp32)     p = exp(s - rowmax(s)) (fp32)
//   o = (bf16(p) v) / rowsum(p)         ("bf16" is the inputs' type)
// The output is contiguous (B, Lq, H * hd), head h at columns h*hd: the
// (B, N, C) that the packed kernel's out projection reads, and the
// (B, Lq, H, hd) of a BNHD call. hd (st.hd) is 64, or for #4 alone any
// multiple of 8 up to 128, run under kD = 48 up to 48, kD = 64 at 56 and
// 64 and kD = 128 past it (the packed #1 and #7 serve the ViTs, whose
// heads are all 64 wide).
//
// bf16 runs the one-pass wgmma kernel of attention_fwd_sm90.cuh (its
// design, its bound and the blank-tile map are described there). This file
// holds the fp32 kernel and the dispatch: fp32 inputs take a plain FMA
// kernel with one thread per q row, 64 rows per block, and the same online
// softmax, exact to fp32 rounding. With kLse set, either kernel also stores
// its rows' lse = m + log(l) (fp32, B x H x Lq) for the backward of #2 and
// #5 (attention_bwd_sm90.cuh); the instantiations without it are the
// inference paths'.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_sm90.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kFwdNegInf = -INFINITY;

// Element strides of q, k and v (batch, row, head; hd stride 1) and of the
// bias (batch, head, row; column stride 1): the shared bias of #1 and #4 has
// bb = bh = 0.
using FwdStrides = sm90::FwdStrides;

// fp32: one thread per q row, 64 rows per block, 32-row k/v tiles in shared
// memory read by broadcast; q and o stay in registers. Past a 64-wide head
// the loops over a tile's keys are not unrolled (see attention_bnhd_fwd.cuh).
constexpr int kFwdF32Tile = 32;

template <int kId, int kD, bool kBias, bool kLse>
__global__ void __launch_bounds__(kRows)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                        int heads, float scale, FwdStrides st) {
  __shared__ float sk[kFwdF32Tile][kD];
  __shared__ float sv[kFwdF32Tile][kD];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < lq;
  const float* qp = q + b * st.qb + h * st.qh + static_cast<int64_t>(in ? row : 0) * st.ql;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* brow = kBias ? bias + static_cast<int64_t>(in ? row : 0) * st.bq : nullptr;

  float qr[kD], o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = in && d < st.hd ? qp[d] : 0.f;
    o[d] = 0.f;
  }
  float m = kFwdNegInf, l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kFwdF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFwdF32Tile * kD; i += kRows) {
      const int r = i / kD, d = i % kD;
      const bool kin = k0 + r < lk && d < st.hd;
      sk[r][d] = kin ? kp[(k0 + r) * st.kl + d] : 0.f;
      sv[r][d] = kin ? vp[(k0 + r) * st.vl + d] : 0.f;
    }
    __syncthreads();

    float s[kFwdF32Tile];
    float mx = kFwdNegInf;
#pragma unroll(kD > kHd ? 1 : kFwdF32Tile)
    for (int j = 0; j < kFwdF32Tile; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc = fmaf(qr[d], sk[j][d], acc);
      const int col = k0 + j;
      float x = acc * scale;
      if (kBias && in && col < lk) x += brow[col];
      if (col >= lk) x = kFwdNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == kFwdNegInf ? 0.f : m_new;  // -inf - -inf: no NaN
    const float alpha = expf(m - mu);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] *= alpha;
#pragma unroll(kD > kHd ? 1 : kFwdF32Tile)
    for (int j = 0; j < kFwdF32Tile; ++j) {
      const float p = expf(s[j] - mu);
      l += p;
#pragma unroll
      for (int d = 0; d < kD; ++d) o[d] = fmaf(p, sv[j][d], o[d]);
    }
  }
  if (in) {
    float* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * st.hd;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d < st.hd) dst[d] = o[d] / l;
    if (kLse)
      lse[(static_cast<int64_t>(b) * heads + h) * lq + row] = (m == kFwdNegInf ? 0.f : m) + logf(l);
  }
}

// Launches the forward on `stream` for q (B, Lq, H, st.hd) and k, v (B, Lk,
// H, st.hd) at the strides `st`, all fp32 or all bf16 (is_bf16); bias null or an
// fp32 (Lq, Lk) whose row stride is st.bq; blank null, or (bf16, with a bias
// and Lq == Lk) the bias's blank-tile map and map of all-zero tiles, whose
// blank tiles the kernel skips; out contiguous (B, Lq, H * st.hd) of the inputs'
// type; lse null, or an fp32 (B, H, Lq) that receives each row's m + log(l)
// for the backward (attention_bwd_sm90.cuh). bf16 needs every base pointer
// and stride of q, k and v on a 16-byte boundary. Returns cudaGetLastError()
// as an int (0 = launched). kId is the kernel's number (#1, #4, #7): it
// only names the instantiations, so that a profile tells the entries apart.
template <int kId, int kD = kHd>
int launch_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                         const uint8_t* blank, void* out, int batch, int lq, int lk, int heads,
                         const FwdStrides& st, float scale, int is_bf16, cudaStream_t stm,
                         float* lse = nullptr) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  if (is_bf16)
    return sm90::launch_attention_fwd_onepass<kId, kD>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        bp, blank, static_cast<bf16*>(out), lse, batch, lq, lk, heads, st, scale, stm);
  if (blank) return cudaErrorInvalidValue;
  const dim3 grid((lq + kRows - 1) / kRows, heads, batch);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
#define FWD_F32(kBias, kLse)                                                \
  attn_fwd_f32_kernel<kId, kD, kBias, kLse><<<grid, kRows, 0, stm>>>(      \
      qp, kp, vp, bp, op, lse, lq, lk, heads, scale, st)
  if (lse) {
    if (bp) FWD_F32(true, true);
    else FWD_F32(false, true);
  } else {
    if (bp) FWD_F32(true, false);
    else FWD_F32(false, false);
  }
#undef FWD_F32
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
