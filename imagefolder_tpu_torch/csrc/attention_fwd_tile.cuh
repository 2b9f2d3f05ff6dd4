// Attention forward device code with o / l taken after p v, shared by the
// packed-qkv forward (attention_qkv.cu, kernel #1) and the q-blocked BNHD
// forward (attention_qblk.cu, kernel #4): the two TPU kernels compute the
// same per-head math (_qkv_kernel_impl, _kernel_qblk) and differ only in
// where q, k and v live, which the strides below carry. Each entry
// instantiates the kernels with its own number (kId), so that a profile
// attributes their time to the right one.
//
// Per (batch, head), with key columns >= Lk masked:
//   s = q k^T * scale + bias (fp32)     p = exp(s - rowmax(s)) (fp32)
//   o = (bf16(p) v) / rowsum(p)         ("bf16" is the inputs' type)
// The output is contiguous (B, Lq, H * 64), head h at columns h*64: the
// (B, N, C) that the packed kernel's out projection reads, and the
// (B, Lq, H, hd) of a BNHD call.
//
// Design: one block of four warps owns 64 q rows of one (b, h). Its q
// fragments stay in registers; it streams 64-row k/v tiles through shared
// memory and keeps a running max and row sum (online softmax) with fp32
// accumulators, so no score reaches device memory. Both products run on
// the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// score accumulator is reused in registers as the A operand of p v. Shared
// rows are padded to 144 bytes so that ldmatrix reads are free of bank
// conflicts. Ragged lengths: k/v rows >= Lk load as zeros and their scores
// are -inf before the max; q rows >= Lq are computed but never stored.
// Rows whose every score so far is -inf exponentiate against 0, so that
// -inf - -inf never makes a NaN. Offsets are 64-bit, so that no stride
// times an index can wrap (the 512 px encoder's packed q view alone spans
// 453 M elements over 64 images). fp32 inputs take a plain FMA kernel with
// the same tiling of rows and the same online softmax, exact to fp32
// rounding. With kLse set, each kernel also stores its rows' lse = m +
// log(l) (fp32, B x H x Lq) from the m and l it already holds, for the
// backward of #2 and #5 (attention_bwd_sm90.cuh); the instantiations
// without it are the inference paths'. wgmma, TMA, a pipelined k/v ring and
// skipping tiles that a mask blanks are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kFwdNegInf = -INFINITY;

// Element strides (hd stride 1) of q, k and v, each as batch, row and head
// strides; and the shared bias's row stride (column stride 1).
struct FwdStrides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, bq;
};

template <int kId, bool kVec, bool kBias, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                         int heads, float scale, FwdStrides st) {
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
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;

  load_tile<kVec>(sq, q + b * st.qb + h * st.qh, q0, lq, st.ql);
  __syncthreads();
  uint32_t qf[kHd / 16][4];  // A fragments, one per 16-wide k step
  load_a(qf, sq);

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  float o[kHd / 8][4];
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kFwdNegInf, kFwdNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < lk; k0 += kRows) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<kVec>(sk, kp, k0, lk, st.kl);
    load_tile<kVec>(sv, vp, k0, lk, st.vl);
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
    float mx[2] = {kFwdNegInf, kFwdNegInf};
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (kBias && row < lq && col < lk) x += bias[row * st.bq + col];
        if (col >= lk) x = kFwdNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
      mu[r] = m_new == kFwdNegInf ? 0.f : m_new;
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
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - mu[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
    uint32_t pf[kRows / 16][4];
    pack_a(pf, s);
    mma_ab(o, pf, sv);  // o += p v
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (kLse && t4 == 0) {  // lse = m + log(l) per row, fp32 (B, H, Lq)
    float* row_lse = lse + (static_cast<int64_t>(b) * heads + h) * lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_hi : row_lo;
      if (row < lq) row_lse[row] = (m[r] == kFwdNegInf ? 0.f : m[r]) + logf(l[r]);
    }
  }
  const int64_t ldo = static_cast<int64_t>(heads) * kHd;
  bf16* dst = out + (static_cast<int64_t>(b) * lq * heads + h) * kHd + t4 * 2;
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) {
    if (row_lo < lq)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_lo * ldo + i * 8) =
          __floats2bfloat162_rn(o[i][0] / l[0], o[i][1] / l[0]);
    if (row_hi < lq)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_hi * ldo + i * 8) =
          __floats2bfloat162_rn(o[i][2] / l[1], o[i][3] / l[1]);
  }
}

// fp32: one thread per q row, 64 rows per block, 32-row k/v tiles in shared
// memory read by broadcast; q and o stay in registers.
constexpr int kFwdF32Tile = 32;

template <int kId, bool kBias, bool kLse>
__global__ void __launch_bounds__(kRows)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                        int heads, float scale, FwdStrides st) {
  __shared__ float sk[kFwdF32Tile][kHd];
  __shared__ float sv[kFwdF32Tile][kHd];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < lq;
  const float* qp = q + b * st.qb + h * st.qh + static_cast<int64_t>(in ? row : 0) * st.ql;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* brow = kBias ? bias + static_cast<int64_t>(in ? row : 0) * st.bq : nullptr;

  float qr[kHd], o[kHd];
#pragma unroll
  for (int d = 0; d < kHd; ++d) {
    qr[d] = in ? qp[d] : 0.f;
    o[d] = 0.f;
  }
  float m = kFwdNegInf, l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kFwdF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFwdF32Tile * kHd; i += kRows) {
      const int r = i / kHd, d = i % kHd;
      const bool kin = k0 + r < lk;
      sk[r][d] = kin ? kp[(k0 + r) * st.kl + d] : 0.f;
      sv[r][d] = kin ? vp[(k0 + r) * st.vl + d] : 0.f;
    }
    __syncthreads();

    float s[kFwdF32Tile];
    float mx = kFwdNegInf;
#pragma unroll
    for (int j = 0; j < kFwdF32Tile; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHd; ++d) acc = fmaf(qr[d], sk[j][d], acc);
      const int col = k0 + j;
      float x = acc * scale;
      if (kBias && in && col < lk) x += brow[col];
      if (col >= lk) x = kFwdNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == kFwdNegInf ? 0.f : m_new;  // see the bf16 kernel
    const float alpha = expf(m - mu);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHd; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kFwdF32Tile; ++j) {
      const float p = expf(s[j] - mu);
      l += p;
#pragma unroll
      for (int d = 0; d < kHd; ++d) o[d] = fmaf(p, sv[j][d], o[d]);
    }
  }
  if (in) {
    float* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * kHd;
#pragma unroll
    for (int d = 0; d < kHd; ++d) dst[d] = o[d] / l;
    if (kLse)
      lse[(static_cast<int64_t>(b) * heads + h) * lq + row] = (m == kFwdNegInf ? 0.f : m) + logf(l);
  }
}

// Launches the forward on `stream` for q (B, Lq, H, 64) and k, v (B, Lk, H,
// 64) at the strides `st`, all fp32 or all bf16 (is_bf16); bias null or an
// fp32 (Lq, Lk) whose row stride is st.bq; out contiguous (B, Lq, H * 64) of
// the inputs' type; lse null, or an fp32 (B, H, Lq) that receives each row's
// m + log(l) for the backward (attention_bwd_sm90.cuh). Returns
// cudaGetLastError() as an int (0 = launched). kId is the kernel's number
// (#1, #4, #7): it only names the instantiations, so that a profile tells
// the entries apart.
template <int kId>
int launch_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                         void* out, int batch, int lq, int lk, int heads,
                         const FwdStrides& st, float scale, int is_bf16, cudaStream_t stm,
                         float* lse = nullptr) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const dim3 grid((lq + kRows - 1) / kRows, heads, batch);
  const float* bp = static_cast<const float*>(bias);
  if (is_bf16) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    // 16-byte loads need every base pointer and every q/k/v stride on a
    // 16-byte (8-element) boundary
    const int64_t in_strides[9] = {st.qb, st.ql, st.qh, st.kb, st.kl, st.kh,
                                   st.vb, st.vl, st.vh};
    bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0;
    for (int i = 0; i < 9; ++i) vec = vec && in_strides[i] % 8 == 0;
    const dim3 block(kWarps * 32);
#define FWD_BF16(kVec, kBias, kLse)                                               \
  attn_fwd_bf16_kernel<kId, kVec, kBias, kLse><<<grid, block, 0, stm>>>(          \
      qp, kp, vp, bp, op, lse, lq, lk, heads, scale, st)
    if (lse) {
      if (vec && bp) FWD_BF16(true, true, true);
      else if (vec) FWD_BF16(true, false, true);
      else if (bp) FWD_BF16(false, true, true);
      else FWD_BF16(false, false, true);
    } else {
      if (vec && bp) FWD_BF16(true, true, false);
      else if (vec) FWD_BF16(true, false, false);
      else if (bp) FWD_BF16(false, true, false);
      else FWD_BF16(false, false, false);
    }
#undef FWD_BF16
  } else {
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    float* op = static_cast<float*>(out);
#define FWD_F32(kBias, kLse)                                                \
  attn_fwd_f32_kernel<kId, kBias, kLse><<<grid, kRows, 0, stm>>>(          \
      qp, kp, vp, bp, op, lse, lq, lk, heads, scale, st)
    if (lse) {
      if (bp) FWD_F32(true, true);
      else FWD_F32(false, true);
    } else {
      if (bp) FWD_F32(true, false);
      else FWD_F32(false, false);
    }
#undef FWD_F32
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
