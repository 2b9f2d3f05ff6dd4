// The BNHD kernels #3-#6 at head dims 136-256, on kD = 256 instantiations
// of their own (attention_bnhd_hd256.cu, attention_qblk_hd256.cu,
// attention_bnhd_bwd_hd256.cu, attention_qblk_bwd_hd256.cu): the generator
// CLIs' --hidden and --heads reach these widths (hidden 1024 over 4 heads is
// 256), which the JAX router gives to the same fused kernels.
//
// A first version, right before fast, in fp32 and bf16 alike. The wgmma
// forward holds a 64 x 128 head in two swizzled tiles and O in two
// accumulators; at 256 that is four of each, past a thread's 255
// registers, and its resident k/v (five 64-key tiles) past shared memory.
// So these kernels are FMA kernels with kSplit = 8 threads a row: each
// thread holds the columns kSplit * c + part (c < 32) of its row's
// vectors in registers, a score is the sum of the eight threads' partial
// dot products (a butterfly of shuffles, which gives the eight the same
// bits), and the other side streams through shared memory in 16-row fp32
// tiles (2 x 16 KB). Inputs of either type are widened to fp32 on load;
// the plain versions' roundings to the inputs' type are made where they
// make them (bf16(p / l) v for #3, bf16(p) v then / l for #4, bf16(p) and
// bf16(ds) in the backward), so bf16 and fp32 share the code.
//
// Forward (#3 and #4): per (b, h, 32 q rows), pass 1 keeps the running max
// m and row sum l (online softmax), pass 2 accumulates p v with p from the
// final m; #3 divides p by l before its rounding, #4 divides o by l after p
// v (its one-pass TPU kernel's rounding point, from the final m rather
// than a running one). lse = m + log(l) is stored when asked for.
// Backward (#5 and #6): kernel A per (b, h, 32 q rows) gets m and l, then
// delta = rowsum(p dp), then dq (and dbias by fp32 atomicAdd); kernel B per
// (b, h, 32 key rows) recomputes p and ds from A's row statistics and
// accumulates dk and dv. Neither needs the forward's o or lse.
// A narrower head (136-248) runs over zero-filled columns past st.hd, and
// only st.hd columns are stored. The loops over a tile's keys are not
// unrolled: unrolled FMA key loops made ptxas take minutes at kD = 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "attention_fwd_sm90.cuh"

namespace {
namespace wide {

constexpr int kWD = 256;                    // the compiled head width
constexpr int kSplit = 8;                   // threads a row
constexpr int kCols = kWD / kSplit;         // columns a thread holds
constexpr int kWRows = 32;                  // rows a block
constexpr int kWThreads = kWRows * kSplit;  // 256
constexpr int kWTile = 16;                  // rows of the other side a shared tile
constexpr float kWNegInf = -INFINITY;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// x rounded to T and widened back (the plain versions' casts)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// the sum over the kSplit threads of a row (adjacent lanes); a butterfly,
// so every thread of the row gets the same bits
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the partial dot product of a thread's columns with shared row x
__device__ __forceinline__ float part_dot(const float (&r)[kCols], const float* x, int part) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) a = fmaf(r[c], x[kSplit * c + part], a);
  return a;
}

// rows r0.. r0 + kWTile of a (rows, st.hd) operand at row stride ld into
// the fp32 tile, zero past n and st.hd
template <typename T>
__device__ __forceinline__ void load_tile(float (&dst)[kWTile][kWD], const T* src, int r0, int n,
                                          int64_t ld, int hd) {
  for (int i = threadIdx.x; i < kWTile * kWD; i += kWThreads) {
    const int r = i / kWD, d = i % kWD;
    dst[r][d] = r0 + r < n && d < hd ? to_f(src[static_cast<int64_t>(r0 + r) * ld + d]) : 0.f;
  }
}

// a thread's columns of row `row` of src (zero if the row is out or past hd)
template <typename T>
__device__ __forceinline__ void load_row(float (&dst)[kCols], const T* src, bool in, int hd,
                                         int part) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = kSplit * c + part;
    dst[c] = in && d < hd ? to_f(src[d]) : 0.f;
  }
}

// the online softmax's step for one score
__device__ __forceinline__ void online(float s, float& m, float& l) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else if (s != kWNegInf) {
    l += expf(s - m);
  }
}

// #3 (kDivFirst: bf16(p / l) v) and #4 (bf16(p) v, then / l). bias at
// strides st.bb, st.bh, st.bq (column stride 1); out contiguous (B, Lq, H,
// st.hd); lse (B, H, Lq) when kLse.
template <int kId, typename T, bool kBias, bool kLse, bool kDivFirst>
__global__ void __launch_bounds__(kWThreads)
    attn_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, float* __restrict__ lse, int lq, int lk, int heads,
                         float scale, sm90::FwdStrides st) {
  __shared__ float sk[kWTile][kWD];
  __shared__ float sv[kWTile][kWD];

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kWRows + threadIdx.x / kSplit;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < lq;
  const int64_t r = in ? row : 0;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh + r * st.bq : nullptr;

  float qr[kCols], o[kCols];
  load_row(qr, q + b * st.qb + h * st.qh + r * st.ql, in, st.hd, part);
#pragma unroll
  for (int c = 0; c < kCols; ++c) o[c] = 0.f;
  float m = kWNegInf, l = 0.f;

  for (int pass = 0; pass < 2; ++pass) {  // m and l; p v
    const float mu = m == kWNegInf ? 0.f : m;
    for (int k0 = 0; k0 < lk; k0 += kWTile) {
      __syncthreads();
      load_tile(sk, kp, k0, lk, st.kl, st.hd);
      if (pass == 1) load_tile(sv, vp, k0, lk, st.vl, st.hd);
      __syncthreads();
      const int nj = lk - k0 < kWTile ? lk - k0 : kWTile;
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        float s = row_sum(part_dot(qr, sk[j], part)) * scale;
        if (kBias && in) s += bp[k0 + j];
        if (pass == 0) {
          online(s, m, l);
          continue;
        }
        float p = expf(s - mu);
        if (kDivFirst) p /= l;
        p = round_to<T>(p);
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[c] = fmaf(p, sv[j][kSplit * c + part], o[c]);
      }
    }
  }
  if (!in) return;
  T* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * st.hd + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (kSplit * c + part < st.hd) store(dst + kSplit * c, kDivFirst ? o[c] : o[c] / l);
  if (kLse && part == 0)
    lse[(static_cast<int64_t>(b) * heads + h) * lq + row] = (m == kWNegInf ? 0.f : m) + logf(l);
}

// kernel A: dq, and the row statistics m, l and delta into stats (three
// planes of B * H * n fp32); kDbias adds ds into dbias (n, n)
template <int kId, typename T, bool kBias, bool kDbias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const float* __restrict__ bias, T* __restrict__ dq,
                            float* __restrict__ dbias, float* __restrict__ stats, int n,
                            int heads, float scale, BwdStrides st) {
  __shared__ float sk[kWTile][kWD];
  __shared__ float sv[kWTile][kWD];

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kWRows + threadIdx.x / kSplit;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* brow = kBias ? bias + r * st.bq : nullptr;

  float qr[kCols], gr[kCols], acc[kCols];
  load_row(qr, q + b * st.qb + h * st.qh + r * st.ql, in, st.hd, part);
  load_row(gr, g + b * st.gb + h * st.gh + r * st.gl, in, st.hd, part);
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = kWNegInf, l = 0.f, delta = 0.f;
  for (int pass = 0; pass < 3; ++pass) {  // m and l; delta; dq
    const float mu = m == kWNegInf ? 0.f : m;
    for (int k0 = 0; k0 < n; k0 += kWTile) {
      __syncthreads();
      load_tile(sk, kp, k0, n, st.kl, st.hd);
      if (pass > 0) load_tile(sv, vp, k0, n, st.vl, st.hd);
      __syncthreads();
      const int nj = n - k0 < kWTile ? n - k0 : kWTile;
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        float s = row_sum(part_dot(qr, sk[j], part)) * scale;
        if (kBias && in) s += brow[k0 + j];
        if (pass == 0) {
          online(s, m, l);
          continue;
        }
        const float dpv = row_sum(part_dot(gr, sv[j], part));
        const float p = expf(s - mu) / l;
        if (pass == 1) {
          delta = fmaf(p, dpv, delta);
          continue;
        }
        const float ds = p * (dpv - delta);
        const float dsb = round_to<T>(ds);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(dsb, sk[j][kSplit * c + part], acc[c]);
        if (kDbias && part == 0 && in && ds != 0.f)
          atomicAdd(dbias + static_cast<int64_t>(row) * n + k0 + j, ds);
      }
    }
  }
  if (!in) return;
  T* dst = dq + b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (kSplit * c + part < st.hd) store(dst + kSplit * c, acc[c] * scale);
  if (part == 0) {
    const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
    float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n + row;
    row_stats[0] = m == kWNegInf ? 0.f : m;
    row_stats[plane] = l;
    row_stats[2 * plane] = delta;
  }
}

// kernel B: dk and dv for 32 key rows, over every q row
template <int kId, typename T, bool kBias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ bias, const float* __restrict__ stats,
                              T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                              float scale, BwdStrides st) {
  __shared__ float sq[kWTile][kWD];
  __shared__ float sg[kWTile][kWD];
  __shared__ float sm[kWTile], sl[kWTile], sd[kWTile];

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * kWRows + threadIdx.x / kSplit;  // a key row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* gp = g + b * st.gb + h * st.gh;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
  const float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;

  float kr[kCols], vr[kCols], dka[kCols], dva[kCols];
  load_row(kr, k + b * st.kb + h * st.kh + r * st.kl, in, st.hd, part);
  load_row(vr, v + b * st.vb + h * st.vh + r * st.vl, in, st.hd, part);
#pragma unroll
  for (int c = 0; c < kCols; ++c) dka[c] = dva[c] = 0.f;
  for (int q0 = 0; q0 < n; q0 += kWTile) {
    __syncthreads();
    load_tile(sq, qp, q0, n, st.ql, st.hd);
    load_tile(sg, gp, q0, n, st.gl, st.hd);
    for (int i = threadIdx.x; i < kWTile; i += kWThreads) {
      const bool qin = q0 + i < n;
      sm[i] = qin ? row_stats[q0 + i] : 0.f;
      sl[i] = qin ? row_stats[plane + q0 + i] : 1.f;
      sd[i] = qin ? row_stats[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
    const int nj = n - q0 < kWTile ? n - q0 : kWTile;
#pragma unroll 1
    for (int j = 0; j < nj; ++j) {  // a query
      float s = row_sum(part_dot(kr, sq[j], part)) * scale;
      if (kBias && in) s += bias[static_cast<int64_t>(q0 + j) * st.bq + row];
      const float dpv = row_sum(part_dot(vr, sg[j], part));
      const float p = expf(s - sm[j]) / sl[j];
      const float pb = round_to<T>(p);
      const float dsb = round_to<T>(p * (dpv - sd[j]));
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dva[c] = fmaf(pb, sg[j][kSplit * c + part], dva[c]);
        dka[c] = fmaf(dsb, sq[j][kSplit * c + part], dka[c]);
      }
    }
  }
  if (!in) return;
  const int64_t off = b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kSplit * c + part >= st.hd) break;
    store(dk + off + kSplit * c, dka[c] * scale);
    store(dv + off + kSplit * c, dva[c]);
  }
}

template <int kId, typename T, bool kDivFirst>
int launch_fwd_typed(const void* q, const void* k, const void* v, const float* bias, void* out,
                     float* lse, int batch, int lq, int lk, int heads,
                     const sm90::FwdStrides& st, float scale, cudaStream_t stm) {
  const dim3 grid((lq + kWRows - 1) / kWRows, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define WIDE_FWD(kBias, kLse)                                                           \
  attn_fwd_wide_kernel<kId, T, kBias, kLse, kDivFirst><<<grid, kWThreads, 0, stm>>>( \
      qp, kp, vp, bias, op, lse, lq, lk, heads, scale, st)
  if (lse) {
    if (bias) WIDE_FWD(true, true);
    else WIDE_FWD(false, true);
  } else {
    if (bias) WIDE_FWD(true, false);
    else WIDE_FWD(false, false);
  }
#undef WIDE_FWD
  return static_cast<int>(cudaGetLastError());
}

// The forward of #3 (kId 3: p divided by l before p v) or #4 (kId 4: o
// divided after) for q (B, Lq, H, st.hd) and k, v (B, Lk, H, st.hd) at the
// strides st (st.hd a multiple of 8, 136-256), all fp32 or all bf16
// (is_bf16); bias null or fp32 at st.bb, st.bh, st.bq; out contiguous (B,
// Lq, H, st.hd); lse null or an fp32 (B, H, Lq). Returns
// cudaGetLastError() as an int.
template <int kId>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
               float* lse, int batch, int lq, int lk, int heads, const sm90::FwdStrides& st,
               float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || st.hd > kWD) return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  return is_bf16 ? launch_fwd_typed<kId, bf16, kId == 3>(q, k, v, bp, out, lse, batch, lq, lk,
                                                         heads, st, scale, stm)
                 : launch_fwd_typed<kId, float, kId == 3>(q, k, v, bp, out, lse, batch, lq, lk,
                                                          heads, st, scale, stm);
}

template <int kId, typename T>
int launch_bwd_typed(const void* q, const void* k, const void* v, const void* g,
                     const float* bias, void* dq, void* dk, void* dv, float* dbias, float* stats,
                     int batch, int n, int heads, const BwdStrides& st, float scale,
                     cudaStream_t stm) {
  const dim3 grid((n + kWRows - 1) / kWRows, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
#define WIDE_DQ(kBias, kDbias)                                                  \
  attn_bwd_dq_wide_kernel<kId, T, kBias, kDbias><<<grid, kWThreads, 0, stm>>>( \
      qp, kp, vp, gp, bias, static_cast<T*>(dq), dbias, stats, n, heads, scale, st)
  if (dbias) WIDE_DQ(true, true);
  else if (bias) WIDE_DQ(true, false);
  else WIDE_DQ(false, false);
#undef WIDE_DQ
  if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
#define WIDE_DKDV(kBias)                                                        \
  attn_bwd_dkdv_wide_kernel<kId, T, kBias><<<grid, kWThreads, 0, stm>>>(        \
      qp, kp, vp, gp, bias, stats, static_cast<T*>(dk), static_cast<T*>(dv), n, \
      heads, scale, st)
  if (bias) WIDE_DKDV(true);
  else WIDE_DKDV(false);
#undef WIDE_DKDV
  return static_cast<int>(cudaGetLastError());
}

// Kernel A then kernel B of #5 or #6 (kId) for q, k, v, g and dq, dk, dv
// (B, n, H, st.hd) at the strides st (st.hd a multiple of 8, 136-256), all
// fp32 or all bf16 (is_bf16); bias null or an fp32 (n, n) of row stride
// st.bq; dbias null (not wanted) or a zeroed fp32 (n, n); stats an fp32
// scratch of 3 * batch * heads * n. Returns cudaGetLastError() as an int.
template <int kId>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* bias,
               void* dq, void* dk, void* dv, void* dbias, void* stats, int batch, int n,
               int heads, const BwdStrides& st, float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (dbias && !bias) || st.hd > kWD)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(dbias);
  float* sp = static_cast<float*>(stats);
  return is_bf16 ? launch_bwd_typed<kId, bf16>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch, n,
                                               heads, st, scale, stm)
                 : launch_bwd_typed<kId, float>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch, n,
                                                heads, st, scale, stm);
}

}  // namespace wide
}  // namespace
