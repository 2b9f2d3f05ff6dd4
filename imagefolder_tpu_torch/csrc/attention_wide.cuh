// The BNHD kernels #3-#6 at head dims 136-1024, on FMA instantiations at
// kD = 256, 512 and 1024, each width in sources of its own
// (attention_{bnhd,qblk,bnhd_bwd,qblk_bwd}_hd{256,512,1024}.cu): the
// generator CLIs' --hidden and --heads reach these widths (hidden 1024 over
// 4 heads is 256, over 2 heads 512), which the JAX router gives to the same
// fused kernels.
//
// A first version, right before fast, in fp32 and bf16 alike. The wgmma
// forward holds a 64 x 128 head in two swizzled tiles and O in two
// accumulators; at 256 that is four of each, past a thread's 255
// registers, and its resident k/v (five 64-key tiles) past shared memory.
// So these kernels are FMA kernels with kSplit = kD / 32 threads a row (8
// at 256, 16 at 512, a whole warp at 1024): each thread holds the columns
// kSplit * c + part (c < 32) of its row's vectors in registers, a score is
// the sum of the kSplit threads' partial dot products (a butterfly of
// log2(kSplit) shuffles, which gives them all the same bits), and the other
// side streams through dynamic shared memory in 16-row fp32 tiles (2 x 16
// rows x kD floats: 32 KB at 256, 64 KB at 512, 128 KB at 1024, opted in
// past 48 KB). A block is 256 threads at every width, so that a thread
// keeps the same 32 columns a vector and the same registers: 32 rows a
// block at 256, 16 at 512, 8 at 1024. Past 1024 a row would need more than
// a warp's threads or more columns a thread: those heads run the segmented
// kernels at the end of this file, on kD = 1024's geometry. Inputs of
// either type are widened to fp32 on load; the plain versions' roundings
// to the inputs' type are made where they make them (bf16(p / l) v for #3,
// bf16(p) v then / l for #4, bf16(p) and bf16(ds) in the backward), so
// bf16 and fp32 share the code.
//
// Forward (#3 and #4): per (b, h, block of q rows), pass 1 keeps the running
// max m and row sum l (online softmax), pass 2 accumulates p v with p from
// the final m; #3 divides p by l before its rounding, #4 divides o by l
// after p v (its one-pass TPU kernel's rounding point, from the final m
// rather than a running one). lse = m + log(l) is stored when asked for.
// Backward (#5 and #6): kernel A per (b, h, block of q rows) gets m and l,
// then delta = rowsum(p dp), then dq (and dbias by fp32 atomicAdd); kernel
// B per (b, h, block of key rows) recomputes p and ds from A's row
// statistics and accumulates dk and dv. Neither needs the forward's o or
// lse. A narrower head runs over zero-filled columns past st.hd, and only
// st.hd columns are stored. The loops over a tile's keys are not unrolled:
// unrolled FMA key loops made ptxas take minutes at kD = 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "attention_fwd_sm90.cuh"

namespace {
namespace wide {

constexpr int kCols = 32;      // columns a thread holds, at every width
constexpr int kWThreads = 256;  // threads a block, at every width
constexpr int kWTile = 16;     // rows of the other side a shared tile
constexpr int kMaxWD = 1024;   // the widest instantiation: a warp a row
constexpr float kWNegInf = -INFINITY;

// threads a row and rows a block of the kD instantiation
template <int kWD>
struct Geo {
  static_assert(kWD % kCols == 0 && kWD <= kMaxWD, "kD is 32 columns a thread, up to a warp");
  static constexpr int kSplit = kWD / kCols;
  static constexpr int kRows = kWThreads / kSplit;
  // the two fp32 tiles of the other side, in dynamic shared memory
  static constexpr int kSmem = 2 * kWTile * kWD * static_cast<int>(sizeof(float));
};

// the dynamic shared memory of every wide kernel, as two [kWTile][kWD] tiles
extern __shared__ float4 wide_smem4[];
template <int kWD>
__device__ __forceinline__ float (*wide_tile(int i))[kWD] {
  return reinterpret_cast<float(*)[kWD]>(reinterpret_cast<float*>(wide_smem4) +
                                         i * kWTile * kWD);
}

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
template <int kSplit>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the partial dot product of a thread's columns with shared row x
template <int kSplit>
__device__ __forceinline__ float part_dot(const float (&r)[kCols], const float* x, int part) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) a = fmaf(r[c], x[kSplit * c + part], a);
  return a;
}

// rows r0.. r0 + kWTile of a (rows, st.hd) operand at row stride ld into
// the fp32 tile, zero past n and st.hd
template <int kWD, typename T>
__device__ __forceinline__ void load_tile(float (*dst)[kWD], const T* src, int r0, int n,
                                          int64_t ld, int hd) {
  for (int i = threadIdx.x; i < kWTile * kWD; i += kWThreads) {
    const int r = i / kWD, d = i % kWD;
    dst[r][d] = r0 + r < n && d < hd ? to_f(src[static_cast<int64_t>(r0 + r) * ld + d]) : 0.f;
  }
}

// a thread's columns of row `row` of src (zero if the row is out or past hd)
template <int kSplit, typename T>
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
template <int kId, int kWD, typename T, bool kBias, bool kLse, bool kDivFirst>
__global__ void __launch_bounds__(kWThreads)
    attn_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         T* __restrict__ out, float* __restrict__ lse, int lq, int lk, int heads,
                         float scale, sm90::FwdStrides st) {
  constexpr int kSplit = Geo<kWD>::kSplit;
  float(*sk)[kWD] = wide_tile<kWD>(0);
  float(*sv)[kWD] = wide_tile<kWD>(1);

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * Geo<kWD>::kRows + threadIdx.x / kSplit;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < lq;
  const int64_t r = in ? row : 0;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh + r * st.bq : nullptr;

  float qr[kCols], o[kCols];
  load_row<kSplit>(qr, q + b * st.qb + h * st.qh + r * st.ql, in, st.hd, part);
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
        float s = row_sum<kSplit>(part_dot<kSplit>(qr, sk[j], part)) * scale;
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
template <int kId, int kWD, typename T, bool kBias, bool kDbias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const float* __restrict__ bias, T* __restrict__ dq,
                            float* __restrict__ dbias, float* __restrict__ stats, int n,
                            int heads, float scale, BwdStrides st) {
  constexpr int kSplit = Geo<kWD>::kSplit;
  float(*sk)[kWD] = wide_tile<kWD>(0);
  float(*sv)[kWD] = wide_tile<kWD>(1);

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * Geo<kWD>::kRows + threadIdx.x / kSplit;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* brow = kBias ? bias + r * st.bq : nullptr;

  float qr[kCols], gr[kCols], acc[kCols];
  load_row<kSplit>(qr, q + b * st.qb + h * st.qh + r * st.ql, in, st.hd, part);
  load_row<kSplit>(gr, g + b * st.gb + h * st.gh + r * st.gl, in, st.hd, part);
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
        float s = row_sum<kSplit>(part_dot<kSplit>(qr, sk[j], part)) * scale;
        if (kBias && in) s += brow[k0 + j];
        if (pass == 0) {
          online(s, m, l);
          continue;
        }
        const float dpv = row_sum<kSplit>(part_dot<kSplit>(gr, sv[j], part));
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
template <int kId, int kWD, typename T, bool kBias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ bias, const float* __restrict__ stats,
                              T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                              float scale, BwdStrides st) {
  constexpr int kSplit = Geo<kWD>::kSplit;
  float(*sq)[kWD] = wide_tile<kWD>(0);
  float(*sg)[kWD] = wide_tile<kWD>(1);
  __shared__ float sm[kWTile], sl[kWTile], sd[kWTile];

  const int part = threadIdx.x % kSplit;
  const int row = blockIdx.x * Geo<kWD>::kRows + threadIdx.x / kSplit;  // a key row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* gp = g + b * st.gb + h * st.gh;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
  const float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;

  float kr[kCols], vr[kCols], dka[kCols], dva[kCols];
  load_row<kSplit>(kr, k + b * st.kb + h * st.kh + r * st.kl, in, st.hd, part);
  load_row<kSplit>(vr, v + b * st.vb + h * st.vh + r * st.vl, in, st.hd, part);
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
      float s = row_sum<kSplit>(part_dot<kSplit>(kr, sq[j], part)) * scale;
      if (kBias && in) s += bias[static_cast<int64_t>(q0 + j) * st.bq + row];
      const float dpv = row_sum<kSplit>(part_dot<kSplit>(vr, sg[j], part));
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

// opt kernel `fn` in to `bytes` of dynamic shared memory (past 48 KB at
// kD = 512 and 1024); returns cudaGetLastError() as an int
template <typename F>
int allow_smem(F* fn, int bytes) {
  if (bytes > 48 * 1024) cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return static_cast<int>(cudaGetLastError());
}

template <int kId, int kWD, typename T, bool kDivFirst>
int launch_fwd_typed(const void* q, const void* k, const void* v, const float* bias, void* out,
                     float* lse, int batch, int lq, int lk, int heads,
                     const sm90::FwdStrides& st, float scale, cudaStream_t stm) {
  using G = Geo<kWD>;
  const dim3 grid((lq + G::kRows - 1) / G::kRows, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define WIDE_FWD(kBias, kLse)                                                                \
  do {                                                                                      \
    auto* fn = attn_fwd_wide_kernel<kId, kWD, T, kBias, kLse, kDivFirst>;                   \
    if (int err = allow_smem(fn, G::kSmem)) return err;                                     \
    fn<<<grid, kWThreads, G::kSmem, stm>>>(qp, kp, vp, bias, op, lse, lq, lk, heads, scale, \
                                           st);                                             \
  } while (0)
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
// divided after) on the kD = kWD instantiation for q (B, Lq, H, st.hd) and
// k, v (B, Lk, H, st.hd) at the strides st (st.hd a multiple of 8, up to
// kWD), all fp32 or all bf16 (is_bf16); bias null or fp32 at st.bb, st.bh,
// st.bq; out contiguous (B, Lq, H, st.hd); lse null or an fp32 (B, H, Lq).
// Returns cudaGetLastError() as an int.
template <int kId, int kWD>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
               float* lse, int batch, int lq, int lk, int heads, const sm90::FwdStrides& st,
               float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || st.hd > kWD) return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  return is_bf16 ? launch_fwd_typed<kId, kWD, bf16, kId == 3>(q, k, v, bp, out, lse, batch, lq,
                                                              lk, heads, st, scale, stm)
                 : launch_fwd_typed<kId, kWD, float, kId == 3>(q, k, v, bp, out, lse, batch, lq,
                                                               lk, heads, st, scale, stm);
}

template <int kId, int kWD, typename T>
int launch_bwd_typed(const void* q, const void* k, const void* v, const void* g,
                     const float* bias, void* dq, void* dk, void* dv, float* dbias, float* stats,
                     int batch, int n, int heads, const BwdStrides& st, float scale,
                     cudaStream_t stm) {
  using G = Geo<kWD>;
  const dim3 grid((n + G::kRows - 1) / G::kRows, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
#define WIDE_DQ(kBias, kDbias)                                                           \
  do {                                                                                   \
    auto* fn = attn_bwd_dq_wide_kernel<kId, kWD, T, kBias, kDbias>;                      \
    if (int err = allow_smem(fn, G::kSmem)) return err;                                  \
    fn<<<grid, kWThreads, G::kSmem, stm>>>(qp, kp, vp, gp, bias, static_cast<T*>(dq),    \
                                           dbias, stats, n, heads, scale, st);           \
  } while (0)
  if (dbias) WIDE_DQ(true, true);
  else if (bias) WIDE_DQ(true, false);
  else WIDE_DQ(false, false);
#undef WIDE_DQ
  if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
#define WIDE_DKDV(kBias)                                                                 \
  do {                                                                                   \
    auto* fn = attn_bwd_dkdv_wide_kernel<kId, kWD, T, kBias>;                            \
    if (int err = allow_smem(fn, G::kSmem)) return err;                                  \
    fn<<<grid, kWThreads, G::kSmem, stm>>>(qp, kp, vp, gp, bias, stats,                  \
                                           static_cast<T*>(dk), static_cast<T*>(dv), n,  \
                                           heads, scale, st);                            \
  } while (0)
  if (bias) WIDE_DKDV(true);
  else WIDE_DKDV(false);
#undef WIDE_DKDV
  return static_cast<int>(cudaGetLastError());
}

// Kernel A then kernel B of #5 or #6 (kId) on the kD = kWD instantiation
// for q, k, v, g and dq, dk, dv (B, n, H, st.hd) at the strides st (st.hd a
// multiple of 8, up to kWD), all fp32 or all bf16 (is_bf16); bias null or
// an fp32 (n, n) of row stride st.bq; dbias null (not wanted) or a zeroed
// fp32 (n, n); stats an fp32 scratch of 3 * batch * heads * n. Returns
// cudaGetLastError() as an int.
template <int kId, int kWD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* bias,
               void* dq, void* dk, void* dv, void* dbias, void* stats, int batch, int n,
               int heads, const BwdStrides& st, float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (dbias && !bias) || st.hd > kWD)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(dbias);
  float* sp = static_cast<float*>(stats);
  return is_bf16 ? launch_bwd_typed<kId, kWD, bf16>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch,
                                                    n, heads, st, scale, stm)
                 : launch_bwd_typed<kId, kWD, float>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch,
                                                     n, heads, st, scale, stm);
}

// ---------------------------------------------------------------------------
// Heads past 1024: the kD = 1024 geometry (a warp a row, 8 rows a block)
// over segments of kSeg = 1024 columns. A block owns one output segment
// (blockIdx.x = row block * nseg + segment) and computes each score over
// the whole head by walking q and k segment by segment: each segment's
// partial dot product is summed over the warp (the butterfly), and the
// segments' sums are added in order into a shared row of the tile's scores.
// Then it forms p v, or dq, dk and dv, for its own segment only; the
// backward's dp = g v^T is summed over every segment the same way. The
// registers and shared memory stay those of kD = 1024 at every width; the
// work grows with nseg^2 (each of the nseg blocks of a row walks all nseg
// segments), a first version for widths that no main path runs. Row
// statistics (lse, and the backward's m, l and delta) are stored by the
// blocks of segment 0, and dbias is added by them only.

constexpr int kSeg = kMaxWD;
using SegGeo = Geo<kSeg>;

// per-row scores of the current 16-row tile, summed over the segments:
// rows of the block x the tile's rows
struct SegScores {
  float s[SegGeo::kRows][kWTile];
  float d[SegGeo::kRows][kWTile];
};

template <int kId, typename T, bool kBias, bool kLse, bool kDivFirst>
__global__ void __launch_bounds__(kWThreads)
    attn_fwd_seg_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, float* __restrict__ lse, int lq, int lk, int heads,
                        float scale, sm90::FwdStrides st) {
  constexpr int kSplit = SegGeo::kSplit;
  float(*sk)[kSeg] = wide_tile<kSeg>(0);
  float(*sv)[kSeg] = wide_tile<kSeg>(1);
  __shared__ SegScores sc;

  const int nseg = (st.hd + kSeg - 1) / kSeg;
  const int os = blockIdx.x % nseg;  // the output segment
  const int part = threadIdx.x % kSplit;
  const int rl = threadIdx.x / kSplit;
  const int row = blockIdx.x / nseg * SegGeo::kRows + rl;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < lq;
  const int64_t r = in ? row : 0;
  const T* qp = q + b * st.qb + h * st.qh + r * st.ql;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh + os * kSeg;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh + r * st.bq : nullptr;

  float qr[kCols], o[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) o[c] = 0.f;
  float m = kWNegInf, l = 0.f;

  for (int pass = 0; pass < 2; ++pass) {  // m and l; p v
    const float mu = m == kWNegInf ? 0.f : m;
    for (int k0 = 0; k0 < lk; k0 += kWTile) {
      const int nj = lk - k0 < kWTile ? lk - k0 : kWTile;
      for (int sg = 0; sg < nseg; ++sg) {
        __syncthreads();
        load_tile(sk, kp + sg * kSeg, k0, lk, st.kl, st.hd - sg * kSeg);
        load_row<kSplit>(qr, qp + sg * kSeg, in, st.hd - sg * kSeg, part);
        __syncthreads();
#pragma unroll 1
        for (int j = 0; j < nj; ++j) {
          const float d = row_sum<kSplit>(part_dot<kSplit>(qr, sk[j], part));
          if (part == 0) sc.s[rl][j] = sg == 0 ? d : sc.s[rl][j] + d;
        }
      }
      __syncthreads();
      if (pass == 1) load_tile(sv, vp, k0, lk, st.vl, st.hd - os * kSeg);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        float s = sc.s[rl][j] * scale;
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
  const int hd = st.hd - os * kSeg;  // this segment's columns (up to kSeg)
  T* dst = out + ((static_cast<int64_t>(b) * lq + row) * heads + h) * st.hd + os * kSeg + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (kSplit * c + part < hd) store(dst + kSplit * c, kDivFirst ? o[c] : o[c] / l);
  if (kLse && os == 0 && part == 0)
    lse[(static_cast<int64_t>(b) * heads + h) * lq + row] = (m == kWNegInf ? 0.f : m) + logf(l);
}

// kernel A over segments: dq's segment, and (segment 0) the row statistics
template <int kId, typename T, bool kBias, bool kDbias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dq_seg_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           const float* __restrict__ bias, T* __restrict__ dq,
                           float* __restrict__ dbias, float* __restrict__ stats, int n,
                           int heads, float scale, BwdStrides st) {
  constexpr int kSplit = SegGeo::kSplit;
  float(*sk)[kSeg] = wide_tile<kSeg>(0);
  float(*sv)[kSeg] = wide_tile<kSeg>(1);
  __shared__ SegScores sc;

  const int nseg = (st.hd + kSeg - 1) / kSeg;
  const int os = blockIdx.x % nseg;
  const int part = threadIdx.x % kSplit;
  const int rl = threadIdx.x / kSplit;
  const int row = blockIdx.x / nseg * SegGeo::kRows + rl;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* qp = q + b * st.qb + h * st.qh + r * st.ql;
  const T* gp = g + b * st.gb + h * st.gh + r * st.gl;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* brow = kBias ? bias + r * st.bq : nullptr;

  float qr[kCols], gr[kCols], acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = kWNegInf, l = 0.f, delta = 0.f;
  for (int pass = 0; pass < 3; ++pass) {  // m and l; delta; dq
    const float mu = m == kWNegInf ? 0.f : m;
    for (int k0 = 0; k0 < n; k0 += kWTile) {
      const int nj = n - k0 < kWTile ? n - k0 : kWTile;
      for (int sg = 0; sg < nseg; ++sg) {  // s = q k^T and dp = g v^T over the head
        const int rest = st.hd - sg * kSeg;
        __syncthreads();
        load_tile(sk, kp + sg * kSeg, k0, n, st.kl, rest);
        load_row<kSplit>(qr, qp + sg * kSeg, in, rest, part);
        if (pass > 0) {
          load_tile(sv, vp + sg * kSeg, k0, n, st.vl, rest);
          load_row<kSplit>(gr, gp + sg * kSeg, in, rest, part);
        }
        __syncthreads();
#pragma unroll 1
        for (int j = 0; j < nj; ++j) {
          const float d = row_sum<kSplit>(part_dot<kSplit>(qr, sk[j], part));
          const float e = pass > 0 ? row_sum<kSplit>(part_dot<kSplit>(gr, sv[j], part)) : 0.f;
          if (part == 0) {
            sc.s[rl][j] = sg == 0 ? d : sc.s[rl][j] + d;
            sc.d[rl][j] = sg == 0 ? e : sc.d[rl][j] + e;
          }
        }
      }
      __syncthreads();
      if (pass == 2) load_tile(sk, kp + os * kSeg, k0, n, st.kl, st.hd - os * kSeg);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        float s = sc.s[rl][j] * scale;
        if (kBias && in) s += brow[k0 + j];
        if (pass == 0) {
          online(s, m, l);
          continue;
        }
        const float dpv = sc.d[rl][j];
        const float p = expf(s - mu) / l;
        if (pass == 1) {
          delta = fmaf(p, dpv, delta);
          continue;
        }
        const float ds = p * (dpv - delta);
        const float dsb = round_to<T>(ds);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(dsb, sk[j][kSplit * c + part], acc[c]);
        if (kDbias && os == 0 && part == 0 && in && ds != 0.f)
          atomicAdd(dbias + static_cast<int64_t>(row) * n + k0 + j, ds);
      }
    }
  }
  if (!in) return;
  const int hd = st.hd - os * kSeg;
  T* dst = dq + b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + os * kSeg + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (kSplit * c + part < hd) store(dst + kSplit * c, acc[c] * scale);
  if (os == 0 && part == 0) {
    const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
    float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n + row;
    row_stats[0] = m == kWNegInf ? 0.f : m;
    row_stats[plane] = l;
    row_stats[2 * plane] = delta;
  }
}

// kernel B over segments: dk's and dv's segment for 8 key rows, over every
// q row
template <int kId, typename T, bool kBias>
__global__ void __launch_bounds__(kWThreads)
    attn_bwd_dkdv_seg_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ bias, const float* __restrict__ stats,
                             T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                             float scale, BwdStrides st) {
  constexpr int kSplit = SegGeo::kSplit;
  float(*sq)[kSeg] = wide_tile<kSeg>(0);
  float(*sg)[kSeg] = wide_tile<kSeg>(1);
  __shared__ SegScores sc;
  __shared__ float sm[kWTile], sl[kWTile], sd[kWTile];

  const int nseg = (st.hd + kSeg - 1) / kSeg;
  const int os = blockIdx.x % nseg;
  const int part = threadIdx.x % kSplit;
  const int rl = threadIdx.x / kSplit;
  const int row = blockIdx.x / nseg * SegGeo::kRows + rl;  // a key row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool in = row < n;
  const int64_t r = in ? row : 0;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* gp = g + b * st.gb + h * st.gh;
  const T* kp = k + b * st.kb + h * st.kh + r * st.kl;
  const T* vp = v + b * st.vb + h * st.vh + r * st.vl;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * heads * n;
  const float* row_stats = stats + (static_cast<int64_t>(b) * heads + h) * n;

  float kr[kCols], vr[kCols], dka[kCols], dva[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dka[c] = dva[c] = 0.f;
  for (int q0 = 0; q0 < n; q0 += kWTile) {
    const int nj = n - q0 < kWTile ? n - q0 : kWTile;
    for (int s = 0; s < nseg; ++s) {  // s = k q^T and dp = v g^T over the head
      const int rest = st.hd - s * kSeg;
      __syncthreads();
      load_tile(sq, qp + s * kSeg, q0, n, st.ql, rest);
      load_tile(sg, gp + s * kSeg, q0, n, st.gl, rest);
      load_row<kSplit>(kr, kp + s * kSeg, in, rest, part);
      load_row<kSplit>(vr, vp + s * kSeg, in, rest, part);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < nj; ++j) {
        const float d = row_sum<kSplit>(part_dot<kSplit>(kr, sq[j], part));
        const float e = row_sum<kSplit>(part_dot<kSplit>(vr, sg[j], part));
        if (part == 0) {
          sc.s[rl][j] = s == 0 ? d : sc.s[rl][j] + d;
          sc.d[rl][j] = s == 0 ? e : sc.d[rl][j] + e;
        }
      }
    }
    __syncthreads();
    const int rest = st.hd - os * kSeg;
    load_tile(sq, qp + os * kSeg, q0, n, st.ql, rest);
    load_tile(sg, gp + os * kSeg, q0, n, st.gl, rest);
    for (int i = threadIdx.x; i < kWTile; i += kWThreads) {
      const bool qin = q0 + i < n;
      sm[i] = qin ? row_stats[q0 + i] : 0.f;
      sl[i] = qin ? row_stats[plane + q0 + i] : 1.f;
      sd[i] = qin ? row_stats[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < nj; ++j) {  // a query
      float s = sc.s[rl][j] * scale;
      if (kBias && in) s += bias[static_cast<int64_t>(q0 + j) * st.bq + row];
      const float dpv = sc.d[rl][j];
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
  const int hd = st.hd - os * kSeg;
  const int64_t off =
      b * st.ob + static_cast<int64_t>(row) * st.ol + h * st.oh + os * kSeg + part;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kSplit * c + part >= hd) break;
    store(dk + off + kSplit * c, dka[c] * scale);
    store(dv + off + kSplit * c, dva[c]);
  }
}

template <int kId, typename T, bool kDivFirst>
int launch_fwd_seg_typed(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, int batch, int lq, int lk, int heads,
                         const sm90::FwdStrides& st, float scale, cudaStream_t stm) {
  const int nseg = (st.hd + kSeg - 1) / kSeg;
  const dim3 grid((lq + SegGeo::kRows - 1) / SegGeo::kRows * nseg, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define SEG_FWD(kBias, kLse)                                                                   \
  do {                                                                                         \
    auto* fn = attn_fwd_seg_kernel<kId, T, kBias, kLse, kDivFirst>;                            \
    if (int err = allow_smem(fn, SegGeo::kSmem)) return err;                                   \
    fn<<<grid, kWThreads, SegGeo::kSmem, stm>>>(qp, kp, vp, bias, op, lse, lq, lk, heads,      \
                                                scale, st);                                    \
  } while (0)
  if (lse) {
    if (bias) SEG_FWD(true, true);
    else SEG_FWD(false, true);
  } else {
    if (bias) SEG_FWD(true, false);
    else SEG_FWD(false, false);
  }
#undef SEG_FWD
  return static_cast<int>(cudaGetLastError());
}

// launch_fwd for a head past kSeg (st.hd a multiple of 8): the segmented
// forward of #3 (kId 3) or #4 (kId 4), with launch_fwd's operands
template <int kId>
int launch_fwd_seg(const void* q, const void* k, const void* v, const void* bias, void* out,
                   float* lse, int batch, int lq, int lk, int heads, const sm90::FwdStrides& st,
                   float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || st.hd <= kSeg)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  return is_bf16 ? launch_fwd_seg_typed<kId, bf16, kId == 3>(q, k, v, bp, out, lse, batch, lq,
                                                             lk, heads, st, scale, stm)
                 : launch_fwd_seg_typed<kId, float, kId == 3>(q, k, v, bp, out, lse, batch, lq,
                                                              lk, heads, st, scale, stm);
}

template <int kId, typename T>
int launch_bwd_seg_typed(const void* q, const void* k, const void* v, const void* g,
                         const float* bias, void* dq, void* dk, void* dv, float* dbias,
                         float* stats, int batch, int n, int heads, const BwdStrides& st,
                         float scale, cudaStream_t stm) {
  const int nseg = (st.hd + kSeg - 1) / kSeg;
  const dim3 grid((n + SegGeo::kRows - 1) / SegGeo::kRows * nseg, heads, batch);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
#define SEG_DQ(kBias, kDbias)                                                                \
  do {                                                                                       \
    auto* fn = attn_bwd_dq_seg_kernel<kId, T, kBias, kDbias>;                                \
    if (int err = allow_smem(fn, SegGeo::kSmem)) return err;                                 \
    fn<<<grid, kWThreads, SegGeo::kSmem, stm>>>(qp, kp, vp, gp, bias, static_cast<T*>(dq),   \
                                                dbias, stats, n, heads, scale, st);          \
  } while (0)
  if (dbias) SEG_DQ(true, true);
  else if (bias) SEG_DQ(true, false);
  else SEG_DQ(false, false);
#undef SEG_DQ
  if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
#define SEG_DKDV(kBias)                                                                      \
  do {                                                                                       \
    auto* fn = attn_bwd_dkdv_seg_kernel<kId, T, kBias>;                                      \
    if (int err = allow_smem(fn, SegGeo::kSmem)) return err;                                 \
    fn<<<grid, kWThreads, SegGeo::kSmem, stm>>>(qp, kp, vp, gp, bias, stats,                 \
                                                static_cast<T*>(dk), static_cast<T*>(dv), n, \
                                                heads, scale, st);                           \
  } while (0)
  if (bias) SEG_DKDV(true);
  else SEG_DKDV(false);
#undef SEG_DKDV
  return static_cast<int>(cudaGetLastError());
}

// launch_bwd for a head past kSeg: kernel A then kernel B of #5 or #6
// (kId) over segments, with launch_bwd's operands
template <int kId>
int launch_bwd_seg(const void* q, const void* k, const void* v, const void* g, const void* bias,
                   void* dq, void* dk, void* dv, void* dbias, void* stats, int batch, int n,
                   int heads, const BwdStrides& st, float scale, int is_bf16, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (dbias && !bias) || st.hd <= kSeg)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  float* dbp = static_cast<float*>(dbias);
  float* sp = static_cast<float*>(stats);
  return is_bf16 ? launch_bwd_seg_typed<kId, bf16>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch,
                                                   n, heads, st, scale, stm)
                 : launch_bwd_seg_typed<kId, float>(q, k, v, g, bp, dq, dk, dv, dbp, sp, batch,
                                                    n, heads, st, scale, stm);
}

}  // namespace wide
}  // namespace
