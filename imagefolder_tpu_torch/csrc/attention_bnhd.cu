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
// Numerics follow the Pallas kernel, which differs from attention_qkv.cu:
// fp32 scores and softmax, and p divided by its row sum BEFORE it is rounded
// to the input type for p v. A streaming kernel does not know the row sum
// until it has seen every key, so each block makes two passes over the k
// tiles: the first keeps a running max m and row sum l (online softmax); the
// second recomputes the scores and accumulates (exp(s - m) / l) v, whose
// bf16 rounding is that of the Pallas kernel. The output then needs no
// rescale.
//
// What bounds it on this card: VAR's decode (KV-cached CFG sampling, B = 128
// rows with hd = 64 and 16 heads) has Lq = pn^2 <= 121 new rows against up to
// Lk = 286 cached ones, and the teacher-forcing forward has Lq = Lk = 286.
// Both are bound by memory: the last sampling stage moves 213 MB of q, k, v
// and o (64 us at 3.35 TB/s) for 18 GFLOP (18 us at 989 TFLOP/s).
//
// What the design does about it: as in attention_qkv.cu, a block of four
// warps owns 64 q rows of one (b, h), keeps its q fragments in registers and
// streams 64-row k/v tiles through shared memory (rows padded to 144 bytes
// for ldmatrix), with both products on mma.sync m16n8k16 (bf16 in, fp32
// accumulate) and no score ever in device memory. The second pass reads k
// again, mostly from L2. Ragged Lq and Lk: k/v rows >= Lk load as zeros and
// their scores are -inf; q rows >= Lq are computed and never stored, which
// also covers Lq = 1. Tiles whose scores are all -inf (the block-causal mask
// for the early rows) leave m at -inf; exponentials are then taken against 0
// so that -inf - -inf never makes a NaN. fp32 inputs (VAR's default dtype)
// take an FMA kernel with one thread per q row and the same two passes.
// wgmma, TMA, a pipelined k/v ring and several q heads per block for small
// Lq are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr float kNegInf = -INFINITY;

// element strides of a (B, L, H, hd) view (hd stride 1) and of the bias
// (1|B, 1|H, Lq, Lk) view (Lk stride 1; 0 on a broadcast axis)
struct Strides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, bb, bh, bq;
};

template <bool kVec, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bnhd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          bf16* __restrict__ out, int lq, int lk, int heads,
                          float scale, Strides st) {
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
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh : nullptr;

  load_tile<kVec>(sq, qp, q0, lq, st.ql);
  __syncthreads();
  uint32_t qf[kHd / 16][4];  // A fragments, one per 16-wide k step
  load_a(qf, sq);

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  float s[kRows / 8][4];

  // pass 1: row max and row sum
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  for (int k0 = 0; k0 < lk; k0 += kRows) {
    __syncthreads();  // every warp is done with the previous k tile
    load_tile<kVec>(sk, kp, k0, lk, st.kl);
    __syncthreads();
    tile_scores<kBias>(s, qf, sk, bp, st.bq, row_lo, row_hi, k0, lq, lk, scale);
    float mx[2] = {kNegInf, kNegInf};
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
      mu[r] = m_new == kNegInf ? 0.f : m_new;
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
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    mu[r] = m[r] == kNegInf ? 0.f : m[r];
  }

  // pass 2: o = sum over tiles of bf16(exp(s - m) / l) v
  float o[kHd / 8][4];
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int k0 = 0; k0 < lk; k0 += kRows) {
    __syncthreads();
    load_tile<kVec>(sk, kp, k0, lk, st.kl);
    load_tile<kVec>(sv, vp, k0, lk, st.vl);
    __syncthreads();
    tile_scores<kBias>(s, qf, sk, bp, st.bq, row_lo, row_hi, k0, lq, lk, scale);
    uint32_t pf[kRows / 16][4];
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      float p[2][4];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[hlf][e] = __expf(s[2 * j + hlf][e] - mu[e >> 1]) / l[e >> 1];
      pf[j][0] = pack_bf16(p[0][0], p[0][1]);
      pf[j][1] = pack_bf16(p[0][2], p[0][3]);
      pf[j][2] = pack_bf16(p[1][0], p[1][1]);
      pf[j][3] = pack_bf16(p[1][2], p[1][3]);
    }
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

  const int64_t ldo = static_cast<int64_t>(heads) * kHd;
  bf16* dst = out + (static_cast<int64_t>(b) * lq * heads + h) * kHd + t4 * 2;
#pragma unroll
  for (int i = 0; i < kHd / 8; ++i) {
    if (row_lo < lq)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_lo * ldo + i * 8) =
          __floats2bfloat162_rn(o[i][0], o[i][1]);
    if (row_hi < lq)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_hi * ldo + i * 8) =
          __floats2bfloat162_rn(o[i][2], o[i][3]);
  }
}

// fp32: one thread per q row, 64 rows per block, 32-row k/v tiles in shared
// memory read by broadcast; q and o stay in registers.
constexpr int kF32Tile = 32;

template <bool kBias>
__global__ void __launch_bounds__(kRows)
    attn_bnhd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ out, int lq, int lk, int heads,
                         float scale, Strides st) {
  __shared__ float sk[kF32Tile][kHd];
  __shared__ float sv[kF32Tile][kHd];

  const int row = blockIdx.x * kRows + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh + row * st.bq : nullptr;

  float qr[kHd], o[kHd];
#pragma unroll
  for (int d = 0; d < kHd; ++d) {
    qr[d] = row < lq ? qp[row * st.ql + d] : 0.f;
    o[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const float mu = m == kNegInf ? 0.f : m;  // pass 2: the final max
    for (int k0 = 0; k0 < lk; k0 += kF32Tile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32Tile * kHd; i += kRows) {
        const int r = i / kHd, d = i % kHd;
        const bool in = k0 + r < lk;
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
        for (int d = 0; d < kHd; ++d) acc = fmaf(qr[d], sk[j][d], acc);
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
          for (int d = 0; d < kHd; ++d) o[d] = fmaf(p, sv[j][d], o[d]);
        }
      }
    }
  }
  if (row < lq) {
    float* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * kHd;
#pragma unroll
    for (int d = 0; d < kHd; ++d) dst[d] = o[d];
  }
}

}  // namespace

// q (B, Lq, H, 64), k and v (B, Lk, H, 64), each with its own batch, row and
// head strides in elements (qs, ks, vs = {batch, row, head}; the head-dim
// stride is 1), all fp32 or all bf16 (is_bf16); bias null or fp32 with
// strides bs = {batch, head, row} (column stride 1, 0 on a broadcast axis);
// out contiguous (B, Lq, H, 64) of q's type. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int attention_bnhd_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int batch, int lq,
                                  int lk, int heads, const int64_t* qs,
                                  const int64_t* ks, const int64_t* vs,
                                  const int64_t* bs, float scale, int is_bf16,
                                  void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  Strides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0};
  const dim3 grid((lq + kRows - 1) / kRows, heads, batch);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (is_bf16) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    // 16-byte loads need every base pointer and every q/k/v stride on a
    // 16-byte (8-element) boundary
    bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0;
    for (int i = 0; i < 3; ++i) vec = vec && qs[i] % 8 == 0 && ks[i] % 8 == 0 && vs[i] % 8 == 0;
    const dim3 block(kWarps * 32);
    if (vec && bp)
      attn_bnhd_bf16_kernel<true, true><<<grid, block, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
    else if (vec)
      attn_bnhd_bf16_kernel<true, false><<<grid, block, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
    else if (bp)
      attn_bnhd_bf16_kernel<false, true><<<grid, block, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
    else
      attn_bnhd_bf16_kernel<false, false><<<grid, block, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
  } else {
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    float* op = static_cast<float*>(out);
    if (bp)
      attn_bnhd_f32_kernel<true><<<grid, kRows, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
    else
      attn_bnhd_f32_kernel<false><<<grid, kRows, 0, stm>>>(qp, kp, vp, bp, op, lq, lk, heads, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
