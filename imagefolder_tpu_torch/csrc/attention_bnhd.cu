// BNHD attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// fused_attention (kernel bodies _kernel and _kernel_bias): per (batch,
// head), o = softmax(q k^T * scale + bias) v for q (B, Lq, H, hd) and k, v
// (B, Lk, H, hd), Lq <= Lk allowed, with an optional fp32 bias of shape
// (1|B, 1|H, Lq, Lk) that may hold -inf. q, k and v are strided views: the
// kernel takes each one's batch, row and head strides, so q can come straight
// from the (B, L, 3, H, hd) view of a fused qkv projection and k, v from a
// preallocated KV cache, with no transpose copies (the Pallas wrapper moved
// everything to (B*H, L, hd) first). A bias that is shared over batches or
// heads has stride 0 there and is read from its one copy. The output is
// contiguous (B, Lq, H, hd).
//
// Numerics follow the Pallas kernel, which differs from #1 and #4: fp32
// scores and softmax, and p divided by its row sum BEFORE it is rounded to
// the input type for p v. A streaming kernel does not know the row sum
// until it has seen every key, so each block makes two passes over the k
// tiles: the first keeps a running max m and row sum l (online softmax); the
// second recomputes the scores and accumulates (exp(s - m) / l) v, whose
// bf16 rounding is that of the Pallas kernel. The output then needs no
// rescale.
//
// bf16 runs on wgmma (attention_fwd_sm90.cuh, instantiated as kernel 3):
// two warpgroups per (b, h, 128 q rows), each with 64 q rows, sharing k and
// v, resident in shared memory when Lk <= 320 and streamed through a
// four-slot cp.async ring past that,
// and, when asked, each row's lse = m + log(l) for the backward (#6). What
// bounds it and why the design is so are in that header. fp32 inputs (VAR's
// default dtype, the full-width model checks) take an FMA kernel with one
// thread per q row and the same two passes; it has no lse store.
//
// Head dims 64 (VAR) and 48 (RAR-B's training forward, 768 / 16), each
// instantiated from the same code (kD): the wgmma kernel zero-pads a 48-wide
// head to its 64-wide tiles (attention_fwd_sm90.cuh). Any other multiple of
// 8 up to 64 runs under those two at run time (st.hd): up to 48 under kD =
// 48, 56 under 64, its columns past hd zero in every tile and never stored.

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
// memory read by broadcast; q and o stay in registers.
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
#pragma unroll
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
#pragma unroll
        for (int j = 0; j < kF32Tile; ++j) l += expf(sc[j] - mu_new);
      } else {
#pragma unroll
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

// q (B, Lq, H, hd), k and v (B, Lk, H, hd), hd a multiple of 8 up to 64,
// each with its own batch, row and head strides in elements (qs, ks, vs =
// {batch, row, head}; the head-dim stride is 1), all fp32 or all bf16
// (is_bf16); bias null or fp32 with strides bs = {batch, head, row} (column
// stride 1, 0 on a broadcast axis); out contiguous (B, Lq, H, hd) of q's type; lse null, or (bf16 only) an
// fp32 (B, H, Lq) that receives each row's log-sum-exp for the backward
// (#6). bf16 needs every base pointer and q/k/v stride on a 16-byte
// boundary. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched; cudaErrorInvalidValue for another head dim).
extern "C" int attention_bnhd_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* lse, int batch, int lq,
                                  int lk, int heads, const int64_t* qs,
                                  const int64_t* ks, const int64_t* vs,
                                  const int64_t* bs, float scale, int is_bf16, int hd,
                                  void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || (lse && !is_bf16) || hd < 8 ||
      hd > 64 || hd % 8)
    return cudaErrorInvalidValue;
  Strides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0, hd};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  return hd <= 48 ? launch_bnhd_fwd<48>(q, k, v, bp, out, lse, batch, lq, lk, heads, st, scale,
                                        is_bf16, stm)
                  : launch_bnhd_fwd<64>(q, k, v, bp, out, lse, batch, lq, lk, heads, st, scale,
                                        is_bf16, stm);
}
