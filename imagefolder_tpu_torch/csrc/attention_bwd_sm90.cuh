// Self-attention backward for Hopper (sm_90a) in bf16, FlashAttention-2's
// algorithm on wgmma: the device code of the packed-qkv backward
// (attention_qkv_bwd.cu, kernel #2), the q-blocked backward
// (attention_qblk_bwd.cu, kernel #5) and the BNHD backward
// (attention_bnhd_bwd.cu, kernel #6). All three compute the TPU kernels'
// per-head math (_bwd_head_math, _qblk_bwd_kernel_impl) and differ only in
// where q, k, v, g, o and the three gradients live, which the strides
// carry. Each entry instantiates the kernels with its own number (kId), so
// that a profile attributes their time to the right one. fp32 inputs keep
// the exact FMA kernels of attention_bwd_tile.cuh. The warpgroup
// primitives are wgmma_tile.cuh's.
//
// Per (batch, head), with lse = m + log(l) saved by the forward
// (attention_fwd_sm90.cuh with kLse: the one-pass kernel for #1 and #4,
// the two-pass kernel for #3) and o the forward's bf16 output:
//   delta = rowsum(fp32(o) fp32(g))            (prep)
//   p  = exp(q k^T * scale + bias - lse)        (fp32)
//   dp = g v^T (fp32)       ds = p (dp - delta)
//   dv = bf16(p)^T g        dk = bf16(ds)^T q * scale     (main)
//   dq = bf16(ds) k * scale                                (dq)
//   all sums fp32, each output cast to bf16 once.
// A call that asks for dbias (no main path does: VAR's bias is a constant,
// the GAN step has none) keeps the two-kernel design of
// attention_bwd_tile.cuh, which recomputes m, l and delta = rowsum(p dp)
// from the same products it differentiates: there, a row with one allowed
// key gets p = 1 and ds = 0 exactly, as the plain version does, so a dbias
// that is 0 comes out 0. Here p = exp(s - lse) and delta = rowsum(o g) are
// right to fp32 rounding only, which leaves ~1e-7 of |dp| in such a ds
// (a dbias of ~1e-6 where the plain one is 0); computing delta as
// rowsum(p dp) in a pre-pass would not remove it, p itself being 1 - 1e-7.
// Three launches per call:
//   prep, 8 threads per (b, h, row): delta, and lse * log2(e) into a buffer
//     padded to whole 64-row tiles (+inf past the end, so that p is 0
//     there); with a bias, the blank-tile map, one byte per (64 q rows, 64
//     keys) tile that is 1 when every bias entry of the tile is -inf (the
//     bias is shared by batches and heads, so one map serves the call), and
//     beside it a map of the tiles whose bias is all 0, for which the other
//     two kernels read no bias (most of VAR's allowed tiles: a block-causal
//     mask is 0 or -inf).
//   main, one warpgroup (128 threads) per (b, h, 64 keys): k and v are
//     loaded once and held as register A operands (kD <= 64); the q tiles
//     that the map leaves, with their g, lse and delta, stream through a two-stage
//     cp.async ring. Four wgmma products (m64n64k16) per tile: S^T = K Q^T
//     and dP^T = V G^T (Q and G read K-major), dV += bf16(P^T) G and dK +=
//     bf16(dS^T) Q (P^T and dS^T as register A operands, G and Q read
//     MN-major). dk and dv are written once, at the end.
//   dq, one warpgroup per (b, h, 64 q rows): the mirror image, q and g held
//     as A operands (kD <= 64) and the key tiles that the map leaves streaming past:
//     S = Q K^T, dP = G V^T, P and dS as in main, dQ += bf16(dS) K (three
//     products, K read MN-major); dq is written once, into dq's layout (the
//     q columns of the packed dqkv for #2).
// So seven products per allowed pair where FlashAttention-2 runs five and
// adds each key block's dQ into an fp32 buffer. Those adds bound that
// layout: on an NVIDIA H100 80GB HBM3 at 700 W it took 2.29 ms a call at
// #5's 512 px shape and 0.70 at #2's, against 2.03 and 0.52 for this one
// (chip_smoke.py), and neither bulk reduce-adds of whole rows, nor the adds
// deferred under the next tile's products, nor two warpgroups per 128 keys
// sharing one dQ made it faster. dq also needs no fp32 buffer (147 MB at
// #5's shape), no zeroing and no cast pass, and its sums run in a fixed
// order: the result is the same from run to run.
// Tiles sit in shared memory in the 128-byte swizzle that wgmma reads (16-
// byte chunk c of row r at chunk c ^ (r % 8)), written by cp.async 16-byte
// copies with zero fill past the end. The ring is cp.async, not TMA: every
// thread of the one warpgroup copies, no tensor map is needed (making one
// takes libcuda's cuTensorMapEncodeTiled; the library links the CUDA
// runtime only), and the ragged tail is the forward's zero fill. Rows past
// L need no masks: their k and v are zero, and lse is +inf for q rows past
// L, so p is 0 there.
//
// Numerics against the TPU kernel: the same rounding points (bf16(p) for
// dv, bf16(ds) for dq and dk, fp32 sums, one cast of each output). p comes
// from lse, not from exp(s - max) / sum (fp32 rounding), and delta from the
// bf16 o, not from rowsum(p dp).
// Head dim kD: 64, or 48 and 128 for #5 and #6 (RAR-B's training backward
// at 48, RAR-XL's 80 and RAR-XXL's 88 at 128), and at run time st.hd, any
// multiple of 8 up to kD (#5 and #6 run hd <= 48 under kD = 48, 56 under 64
// and 72-128 under 128). A narrower head keeps the 64-wide tiles with zero
// columns past hd (wgmma_tile.cuh): S^T, dP^T, S and dP run kD / 16
// K-steps, dV, dK and dQ compute zero columns past hd, which are never
// stored, and the prep pass reads hd / 8 of a row's chunks.
// kD = 128 (attn_bwd_wide_kernel, attn_bwd_dq_wide_kernel): each q, k, v
// and g row block is two 64-wide tiles side by side, as in the forward.
// Held as register A operands beside the dK and dV accumulators and S^T
// and dP^T, k and v would take about 256 registers a thread, past the 255
// a thread may have; so both operands of the score products are read from
// shared memory (wgmma with two descriptors), which leaves the
// accumulators and the P^T and dS^T fragments in registers. The score
// products run ceil(hd / 16) K-steps; the gradient products run n64 over
// the first half and n(hd - 64) over the second (one instantiation for
// each second-half width, 8 to 64), so 80 pays for 80 columns, not 128.
// Per tile both score products are waited for, then P^T and dS^T come
// (the bias read there, while no wgmma owns a register) and both gradient
// products are issued together; two blocks of 98 KB share an SM, so one
// block's exponentials overlap the other's products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "wgmma_tile.cuh"

namespace {
namespace sm90 {

constexpr int kStages = 2;                 // q/g ring depth
constexpr int kZeroTile = 1 << 30;  // flag on a q tile's list entry: its bias is all 0
// dynamic shared memory of the main kernel: k, v, the ring's q and g tiles,
// its lse and delta rows, then the list of q tiles (one int each); +1024 to
// align. The dq kernel takes less: q, g, the ring's k and v, its list.
constexpr int kSmemFixed = (2 + 2 * kStages) * kTileBytes + kStages * 2 * kTile * 4 + 1024;

// ------------------------------- kernels -------------------------------- //

// Element strides of o (the forward's output), as batch, row and head.
struct OStrides {
  int64_t b, l, h;
};

// prep: blocks [0, row_blocks) take 32 rows each (8 threads per (b, h, row)
// of the padded length lpad, 16-byte loads and stores); the next ntq * ntk
// blocks take one tile of the maps each (none when bias is null).
template <int kId, int kD>
__global__ void __launch_bounds__(256)
    attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ bias,
                         float* __restrict__ lse2, float* __restrict__ delta,
                         uint8_t* __restrict__ blank, int batch,
                         int n, int lpad, int heads, int row_blocks, BwdStrides st,
                         OStrides os) {
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * 32 + (threadIdx.x >> 3);
    const bool valid = idx < static_cast<int64_t>(batch) * heads * lpad;
    const int part = threadIdx.x & 7;  // this thread's chunks of 8 values: part, part + 8
    const int r = static_cast<int>(idx % lpad);
    const int64_t bh = idx / lpad;
    const int h = static_cast<int>(bh % heads), b = static_cast<int>(bh / heads);
    float d = 0.f;
    if (valid && r < n) {
      for (int c = part; c < st.hd / 8; c += 8) {  // past 64, two chunks a thread
        const uint4 ov = *reinterpret_cast<const uint4*>(
            o + b * os.b + static_cast<int64_t>(r) * os.l + h * os.h + c * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(
            g + b * st.gb + static_cast<int64_t>(r) * st.gl + h * st.gh + c * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(o2[j]), gf = __bfloat1622float2(g2[j]);
          d = fmaf(of.x, gf.x, fmaf(of.y, gf.y, d));
        }
      }
    }
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) d += __shfl_xor_sync(0xffffffffu, d, s);
    if (valid && part == 0) {
      delta[idx] = d;
      lse2[idx] = r < n ? lse[bh * n + r] * kLog2e : INFINITY;
    }
    return;
  }
  // a tile of the maps: blank[t] is 1 when every bias entry of the tile
  // within (n, n) is -inf, blank[ntk^2 + t] when every one is 0 (the main
  // kernel then reads none of them)
  const int ntk = (n + kTile - 1) / kTile;
  const int t = static_cast<int>(blockIdx.x) - row_blocks;
  const int q0 = (t / ntk) * kTile, k0 = (t % ntk) * kTile;
  bool all_blank = true, all_zero = true;
  for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
    const int qr = q0 + i / kTile, kc = k0 + i % kTile;
    if (qr < n && kc < n) {
      const float x = bias[static_cast<int64_t>(qr) * st.bq + kc];
      all_blank = all_blank && x == -INFINITY;
      all_zero = all_zero && x == 0.f;
    }
  }
  all_blank = __syncthreads_and(all_blank);
  all_zero = __syncthreads_and(all_zero);
  if (threadIdx.x == 0) {
    blank[t] = all_blank ? 1 : 0;
    blank[ntk * ntk + t] = all_zero ? 1 : 0;
  }
}

// The tiles that the blank-tile map leaves to one block, in order, into
// `list`: with over_q, the q tiles of key tile `fixed` (the main kernels),
// else the key tiles of q tile `fixed` (the dq kernels); each + kZeroTile
// where its bias is all 0. Returns their count. (map[q tile * nt + key tile])
template <bool kBias>
__device__ __forceinline__ int tile_list(int* list, const uint8_t* blank, int nt, int fixed,
                                         bool over_q) {
  int c = 0;
  for (int t = 0; t < nt; ++t) {
    const int i = over_q ? t * nt + fixed : fixed * nt + t;
    if (!kBias || !blank[i]) list[c++] = t | (kBias && blank[nt * nt + i] ? kZeroTile : 0);
  }
  return c;
}

// main: one warpgroup per (b, h, 64 keys), dk and dv; see the header comment.
template <int kId, int kD, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ bias, const uint8_t* __restrict__ blank,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int lpad,
                         int heads, float scale, BwdStrides st) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sk = raw + pad, sv = sk + kTileBytes;
  const uint32_t sq0 = sv + kTileBytes, sg0 = sq0 + kStages * kTileBytes;
  // [stage][lse2, delta][64]
  float* sstat = reinterpret_cast<float*>(base + (2 + 2 * kStages) * kTileBytes);
  int* qlist = reinterpret_cast<int*>(sstat + kStages * 2 * kTile);
  __shared__ int qcount;

  const int ntq = lpad / kTile;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;

  if (threadIdx.x == 0) qcount = tile_list<kBias>(qlist, blank, ntq, kt, true);
  __syncthreads();
  const int cnt = qcount;

  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* gp = g + b * st.gb + h * st.gh;
  auto load_stage = [&](int s, int qt) {
    load_tile_wg<kD>(sq0 + s * kTileBytes, qp, qt * kTile, n, st.ql, st.hd);
    load_tile_wg<kD>(sg0 + s * kTileBytes, gp, qt * kTile, n, st.gl, st.hd);
    if (threadIdx.x < 32) {  // lse2 and delta: 16 chunks each, padded rows
      const float* src = (threadIdx.x < 16 ? lse2 : delta) + bh * lpad + qt * kTile +
                         (threadIdx.x & 15) * 4;
      cp_async16(smem_addr(sstat + s * 2 * kTile) + threadIdx.x * 16, src, true);
    }
  };
  load_tile_wg<kD>(sk, k + b * st.kb + h * st.kh, k0, n, st.kl, st.hd);
  load_tile_wg<kD>(sv, v + b * st.vb + h * st.vh, k0, n, st.vl, st.hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) load_stage(s, qlist[s] & (kZeroTile - 1));
    cp_async_commit();
  }

  // k and v as register A operands for the whole block
  uint32_t kf[4][4], vf[4][4];
  cp_async_wait<0>();
  __syncthreads();
  tile_to_a(kf, sk);
  tile_to_a(vf, sv);
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // this thread's accumulator rows (keys, local) and the column offset of
  // each element within its 8-column slice
  const int row_lo = warp * 16 + gr;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage `it` has landed; every thread is done with stage it - 1
    {
      const int nx = it + kStages - 1;
      if (nx < cnt) load_stage(nx % kStages, qlist[nx] & (kZeroTile - 1));
      cp_async_commit();
    }
    const int s = it % kStages;
    const int q0 = (qlist[it] & (kZeroTile - 1)) * kTile;
    const bool tile_bias = kBias && !(qlist[it] & kZeroTile);
    const uint32_t sq = sq0 + s * kTileBytes, sg = sg0 + s * kTileBytes;
    const float* slse = sstat + s * 2 * kTile;
    const float* sdel = slse + kTile;

    // bias^T (0 where the tile's bias is all 0), loaded before the products
    // start: a branch while a wgmma owns registers lets the compiler
    // copy them before they are written (with the bias read under a branch
    // there, every gradient came out wrong, even for an all-zero bias)
    float bv[32];
    if (kBias) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kr = k0 + row_lo + 8 * ((i >> 1) & 1);
        const int qc = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        bv[i] = tile_bias && kr < n && qc < n
                    ? bias[static_cast<int64_t>(qc) * st.bq + kr] * kLog2e
                    : 0.f;
      }
    }

    float sacc[32], dpacc[32];
    fence_acc(sacc);
    fence_acc(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // S^T = K Q^T over the head dim
      wgmma_rs<0>(sacc, kf[kk], tile_desc(sq + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // dP^T = V G^T
      wgmma_rs<0>(dpacc, vf[kk], tile_desc(sg + kk * 32), kk);
    wgmma_commit();
    fence_acc(sacc);
    fence_acc(dpacc);

    wgmma_wait<1>();
    fence_acc(sacc);
    // P^T = exp(S^T * scale + bias^T - lse), in base 2; no branch from here
    // to the last wait
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = fmaf(sacc[i], scale2, -slse[c]);
      if (kBias) x += bv[i];
      sacc[i] = fast_exp2(x);
    }
    uint32_t pf[4][4];
    acc_to_a(pf, sacc);
    fence_frag(pf);
    fence_acc(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dV += bf16(P^T) G over the q rows
      wgmma_rs<1>(dv_acc, pf[kk], tile_desc(sg + kk * 2048), 1);
    wgmma_commit();
    fence_frag(pf);
    fence_acc(dv_acc);

    wgmma_wait<1>();
    fence_acc(dpacc);
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] *= dpacc[i] - sdel[8 * (i >> 2) + 2 * t4 + (i & 1)];
    uint32_t dsf[4][4];
    acc_to_a(dsf, sacc);
    fence_frag(dsf);
    fence_acc(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dK += bf16(dS^T) Q over the q rows
      wgmma_rs<1>(dk_acc, dsf[kk], tile_desc(sq + kk * 2048), 1);
    wgmma_commit();
    fence_frag(dsf);
    fence_acc(dk_acc);
    wgmma_wait<0>();
    fence_acc(dk_acc);
    fence_acc(dv_acc);
    fence_frag(pf);
    fence_frag(dsf);
  }
  cp_async_wait<0>();

  // dk and dv rows of this block, cast once
  bf16* dkp = dk + b * st.ob + h * st.oh + 2 * t4;
  bf16* dvp = dv + b * st.ob + h * st.oh + 2 * t4;
#pragma unroll
  for (int i = 0; i < kD / 2; i += 2) {  // columns 8 (i >> 2) + 2 t4 (+ 1) < kD
    const int kr = k0 + row_lo + 8 * ((i >> 1) & 1);
    if (kr >= n || 8 * (i >> 2) + 2 * t4 >= st.hd) continue;
    const int64_t off = static_cast<int64_t>(kr) * st.ol + 8 * (i >> 2);
    *reinterpret_cast<__nv_bfloat162*>(dkp + off) =
        __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dvp + off) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
  }
}

// dq: one warpgroup per (b, h, 64 q rows); q and g are loaded once and
// held as register A operands, the key tiles that the map leaves stream
// through a two-stage cp.async ring with their k and v. Per tile: S = Q K^T
// and dP = G V^T, P = exp(S * scale + bias - lse) and dS = P (dP - delta) as
// the main kernel computes them, dQ += bf16(dS) K (K read MN-major). dq is
// cast and written once, into dq's layout (the q columns of the packed dqkv
// for #2).
template <int kId, int kD, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ bias, const uint8_t* __restrict__ blank,
                       const float* __restrict__ lse2, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int n, int lpad, int heads, float scale,
                       BwdStrides st) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t sq = raw + pad, sg = sq + kTileBytes;
  const uint32_t sk0 = sg + kTileBytes, sv0 = sk0 + kStages * kTileBytes;
  int* klist = reinterpret_cast<int*>(smem_raw + pad + (2 + 2 * kStages) * kTileBytes);
  __shared__ int kcount;

  const int ntk = lpad / kTile;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;

  if (threadIdx.x == 0) kcount = tile_list<kBias>(klist, blank, ntk, qt, false);
  __syncthreads();
  const int cnt = kcount;

  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  auto load_stage = [&](int s, int kt) {
    load_tile_wg<kD>(sk0 + s * kTileBytes, kp, kt * kTile, n, st.kl, st.hd);
    load_tile_wg<kD>(sv0 + s * kTileBytes, vp, kt * kTile, n, st.vl, st.hd);
  };
  load_tile_wg<kD>(sq, q + b * st.qb + h * st.qh, q0, n, st.ql, st.hd);
  load_tile_wg<kD>(sg, g + b * st.gb + h * st.gh, q0, n, st.gl, st.hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) load_stage(s, klist[s] & (kZeroTile - 1));
    cp_async_commit();
  }

  const int row_lo = warp * 16 + gr;  // this thread's accumulator rows: q0 + row_lo (+ 8)
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse2[bh * lpad + q0 + row_lo + 8 * r];
    del_r[r] = delta[bh * lpad + q0 + row_lo + 8 * r];
  }
  uint32_t qf[4][4], gf[4][4];
  cp_async_wait<0>();
  __syncthreads();
  tile_to_a(qf, sq);
  tile_to_a(gf, sg);
  float dqacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage `it` has landed; every thread is done with stage it - 1
    {
      const int nx = it + kStages - 1;
      if (nx < cnt) load_stage(nx % kStages, klist[nx] & (kZeroTile - 1));
      cp_async_commit();
    }
    const int s = it % kStages;
    const int k0 = (klist[it] & (kZeroTile - 1)) * kTile;
    const bool tile_bias = kBias && !(klist[it] & kZeroTile);
    const uint32_t sk = sk0 + s * kTileBytes, sv = sv0 + s * kTileBytes;

    float bv[32];  // the bias tile, before the products (see the main kernel)
    if (kBias) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qr = q0 + row_lo + 8 * ((i >> 1) & 1);
        const int kc = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        bv[i] = tile_bias && qr < n && kc < n
                    ? bias[static_cast<int64_t>(qr) * st.bq + kc] * kLog2e
                    : 0.f;
      }
    }

    float sacc[32], dpacc[32];
    fence_acc(sacc);
    fence_acc(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // S = Q K^T over the head dim
      wgmma_rs<0>(sacc, qf[kk], tile_desc(sk + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)  // dP = G V^T
      wgmma_rs<0>(dpacc, gf[kk], tile_desc(sv + kk * 32), kk);
    wgmma_commit();
    fence_acc(sacc);
    fence_acc(dpacc);

    wgmma_wait<1>();
    fence_acc(sacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // P, in base 2
      float x = fmaf(sacc[i], scale2, -lse_r[(i >> 1) & 1]);
      if (kBias) x += bv[i];
      sacc[i] = fast_exp2(x);
    }
    wgmma_wait<0>();
    fence_acc(dpacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] *= dpacc[i] - del_r[(i >> 1) & 1];  // dS
    uint32_t dsf[4][4];
    acc_to_a(dsf, sacc);
    fence_frag(dsf);
    fence_acc(dqacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dQ += bf16(dS) K over the keys
      wgmma_rs<1>(dqacc, dsf[kk], tile_desc(sk + kk * 2048), 1);
    wgmma_commit();
    fence_frag(dsf);
    fence_acc(dqacc);
    wgmma_wait<0>();
    fence_acc(dqacc);
    fence_frag(dsf);
  }
  cp_async_wait<0>();

  bf16* dqp = dq + b * st.ob + h * st.oh + 2 * t4;
#pragma unroll
  for (int i = 0; i < kD / 2; i += 2) {  // columns 8 (i >> 2) + 2 t4 (+ 1) < kD
    const int qr = q0 + row_lo + 8 * ((i >> 1) & 1);
    if (qr < n && 8 * (i >> 2) + 2 * t4 < st.hd)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<int64_t>(qr) * st.ol + 8 * (i >> 2)) =
          __floats2bfloat162_rn(dqacc[i] * scale, dqacc[i + 1] * scale);
  }
}

// ----------------------- head dims 72-128 (kD = 128) ----------------------- //

// Each q, k, v and g row block is two 64-wide tiles side by side (the
// forward's layout, load_head_async): columns 0-63, then 64 to hd. The
// main kernel's dynamic shared memory holds k, v and the ring's q and g
// tiles, its lse and delta rows and the list of q tiles; the dq kernel's
// q, g, the ring's k and v and its list, in less. +1024 to align.
constexpr int kWideBytes = 2 * kTileBytes;
constexpr int kSmemWide = (2 + 2 * kStages) * kWideBytes + kStages * 2 * kTile * 4 + 1024;

// K-steps of a product over a head of 64 + kN2 columns: ceil(hd / 16)
__host__ __device__ constexpr int wide_ksteps(int kN2) { return (kHd + kN2 + 15) / 16; }

// d = X Y^T over the head dim, X and Y 64-row blocks at sx and sy, both read
// from shared memory K-major (issued, not committed)
template <int kN2>
__device__ __forceinline__ void wide_scores(float (&d)[32], uint32_t sx, uint32_t sy) {
#pragma unroll
  for (int kk = 0; kk < wide_ksteps(kN2); ++kk) {
    const uint32_t off = (kk >> 2) * kTileBytes + (kk & 3) * 32;
    wgmma_ss(d, tile_desc(sx + off), tile_desc(sy + off), kk);
  }
}

// (d0 | d1) += A B, A the bf16 fragments of a 64 x 64 accumulator, B the 64
// rows at sb read MN-major: its first half's 64 columns into d0, the
// second half's kN2 into d1 (issued, not committed)
template <int kN2>
__device__ __forceinline__ void wide_grad(float (&d0)[32], float (&d1)[kN2 / 2],
                                          const uint32_t (&a)[4][4], uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<1>(d0, a[kk], tile_desc(sb + kk * 2048), 1);
    wgmma_rs_mn<kN2>(d1, a[kk], tile_desc(sb + kTileBytes + kk * 2048));
  }
}

// this thread's rows row0 (+ 8) of (d0 | d1) times mul, cast once into dst
// (row stride ld; 2 t4 already added), rows < n and columns < hd only
template <int kN2>
__device__ __forceinline__ void wide_store(bf16* dst, int64_t ld, const float (&d0)[32],
                                           const float (&d1)[kN2 / 2], float mul, int row0,
                                           int n, int hd, int t4) {
  // element j of (d0 | d1): row row0 + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 t4 (+ 1)
  auto put = [&](int j, float x, float y) {
    const int r = row0 + 8 * ((j >> 1) & 1);
    if (r < n && 8 * (j >> 2) + 2 * t4 < hd)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(r) * ld + 8 * (j >> 2)) =
          __floats2bfloat162_rn(x * mul, y * mul);
  };
#pragma unroll
  for (int i = 0; i < 32; i += 2) put(i, d0[i], d0[i + 1]);
#pragma unroll
  for (int i = 0; i < kN2 / 2; i += 2) put(32 + i, d1[i], d1[i + 1]);
}

// main at head dims 72-128: one warpgroup per (b, h, 64 keys), dk and dv
// over 64 + kN2 columns. K and V stay in shared memory and are read there
// by wgmma, as are the ring's Q and G: S^T = K Q^T and dP^T = V G^T run
// wide_ksteps(kN2) K-steps, both waited for; then P^T, dS^T and their bf16
// fragments, and dV += bf16(P^T) G, dK += bf16(dS^T) Q over 64 + kN2
// columns. See the header comment.
template <int kId, int kN2, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ bias, const uint8_t* __restrict__ blank,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int lpad,
                         int heads, float scale, BwdStrides st) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sk = raw + pad, sv = sk + kWideBytes;
  const uint32_t sq0 = sv + kWideBytes, sg0 = sq0 + kStages * kWideBytes;
  // [stage][lse2, delta][64]
  float* sstat = reinterpret_cast<float*>(base + (2 + 2 * kStages) * kWideBytes);
  int* qlist = reinterpret_cast<int*>(sstat + kStages * 2 * kTile);
  __shared__ int qcount;

  const int ntq = lpad / kTile;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;

  if (threadIdx.x == 0) qcount = tile_list<kBias>(qlist, blank, ntq, kt, true);
  __syncthreads();
  const int cnt = qcount;

  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* gp = g + b * st.gb + h * st.gh;
  auto load_stage = [&](int s, int qt) {
    load_head_async<kThreads, 2 * kHd>(sq0 + s * kWideBytes, qp, qt * kTile, n, st.ql,
                                       threadIdx.x, st.hd);
    load_head_async<kThreads, 2 * kHd>(sg0 + s * kWideBytes, gp, qt * kTile, n, st.gl,
                                       threadIdx.x, st.hd);
    if (threadIdx.x < 32) {  // lse2 and delta: 16 chunks each, padded rows
      const float* src = (threadIdx.x < 16 ? lse2 : delta) + bh * lpad + qt * kTile +
                         (threadIdx.x & 15) * 4;
      cp_async16(smem_addr(sstat + s * 2 * kTile) + threadIdx.x * 16, src, true);
    }
  };
  load_head_async<kThreads, 2 * kHd>(sk, k + b * st.kb + h * st.kh, k0, n, st.kl, threadIdx.x,
                                     st.hd);
  load_head_async<kThreads, 2 * kHd>(sv, v + b * st.vb + h * st.vh, k0, n, st.vl, threadIdx.x,
                                     st.hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) load_stage(s, qlist[s] & (kZeroTile - 1));
    cp_async_commit();
  }

  float dk0[32], dk1[kN2 / 2], dv0[32], dv1[kN2 / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN2 / 2; ++i) dk1[i] = dv1[i] = 0.f;
  const int row_lo = warp * 16 + gr;  // this thread's accumulator rows: keys k0 + row_lo (+ 8)
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage `it` has landed; every thread is done with stage it - 1
    {
      const int nx = it + kStages - 1;
      if (nx < cnt) load_stage(nx % kStages, qlist[nx] & (kZeroTile - 1));
      cp_async_commit();
    }
    const int s = it % kStages;
    const int q0 = (qlist[it] & (kZeroTile - 1)) * kTile;
    const bool tile_bias = kBias && !(qlist[it] & kZeroTile);
    const uint32_t sq = sq0 + s * kWideBytes, sg = sg0 + s * kWideBytes;
    const float* slse = sstat + s * 2 * kTile;
    const float* sdel = slse + kTile;

    float sacc[32], dpacc[32];
    fence_acc(sacc);
    fence_acc(dpacc);
    wgmma_fence();
    wide_scores<kN2>(sacc, sk, sq);   // S^T = K Q^T
    wide_scores<kN2>(dpacc, sv, sg);  // dP^T = V G^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sacc);
    fence_acc(dpacc);
    // P^T = exp(S^T * scale + bias^T - lse) in base 2, and dS^T = P^T (dP^T -
    // delta) in dpacc. No wgmma owns a register here, so the bias is read
    // under a branch, only on the tiles whose bias is not all 0.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = fmaf(sacc[i], scale2, -slse[c]);
      if (tile_bias) {
        const int kr = k0 + row_lo + 8 * ((i >> 1) & 1), qc = q0 + c;
        if (kr < n && qc < n) x += bias[static_cast<int64_t>(qc) * st.bq + kr] * kLog2e;
      }
      sacc[i] = fast_exp2(x);
      dpacc[i] = sacc[i] * (dpacc[i] - sdel[c]);
    }
    uint32_t pf[4][4], dsf[4][4];
    acc_to_a(pf, sacc);
    acc_to_a(dsf, dpacc);
    fence_frag(pf);
    fence_frag(dsf);
    fence_acc(dv0);
    fence_acc(dv1);
    fence_acc(dk0);
    fence_acc(dk1);
    wgmma_fence();
    wide_grad<kN2>(dv0, dv1, pf, sg);   // dV += bf16(P^T) G over the q rows
    wide_grad<kN2>(dk0, dk1, dsf, sq);  // dK += bf16(dS^T) Q
    wgmma_commit();
    fence_frag(pf);
    fence_frag(dsf);
    wgmma_wait<0>();
    fence_acc(dv0);
    fence_acc(dv1);
    fence_acc(dk0);
    fence_acc(dk1);
    fence_frag(pf);
    fence_frag(dsf);
  }
  cp_async_wait<0>();

  // dk and dv rows of this block, cast once
  const int64_t out = b * st.ob + h * st.oh + 2 * t4;
  wide_store<kN2>(dk + out, st.ol, dk0, dk1, scale, k0 + row_lo, n, st.hd, t4);
  wide_store<kN2>(dv + out, st.ol, dv0, dv1, 1.f, k0 + row_lo, n, st.hd, t4);
}

// dq at head dims 72-128: one warpgroup per (b, h, 64 q rows); q and g stay
// in shared memory, the key tiles that the map leaves stream through the
// ring with their k and v. Per tile: S = Q K^T and dP = G V^T (shared
// memory, K-major), P and dS as in the main kernel, dQ += bf16(dS) K over
// 64 + kN2 columns (K read MN-major).
template <int kId, int kN2, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ g,
                            const float* __restrict__ bias, const uint8_t* __restrict__ blank,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int n, int lpad, int heads, float scale,
                            BwdStrides st) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t sq = raw + pad, sg = sq + kWideBytes;
  const uint32_t sk0 = sg + kWideBytes, sv0 = sk0 + kStages * kWideBytes;
  int* klist = reinterpret_cast<int*>(smem_raw + pad + (2 + 2 * kStages) * kWideBytes);
  __shared__ int kcount;

  const int ntk = lpad / kTile;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;

  if (threadIdx.x == 0) kcount = tile_list<kBias>(klist, blank, ntk, qt, false);
  __syncthreads();
  const int cnt = kcount;

  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  auto load_stage = [&](int s, int kt) {
    load_head_async<kThreads, 2 * kHd>(sk0 + s * kWideBytes, kp, kt * kTile, n, st.kl,
                                       threadIdx.x, st.hd);
    load_head_async<kThreads, 2 * kHd>(sv0 + s * kWideBytes, vp, kt * kTile, n, st.vl,
                                       threadIdx.x, st.hd);
  };
  load_head_async<kThreads, 2 * kHd>(sq, q + b * st.qb + h * st.qh, q0, n, st.ql, threadIdx.x,
                                     st.hd);
  load_head_async<kThreads, 2 * kHd>(sg, g + b * st.gb + h * st.gh, q0, n, st.gl, threadIdx.x,
                                     st.hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) load_stage(s, klist[s] & (kZeroTile - 1));
    cp_async_commit();
  }

  const int row_lo = warp * 16 + gr;  // this thread's accumulator rows: q0 + row_lo (+ 8)
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse2[bh * lpad + q0 + row_lo + 8 * r];
    del_r[r] = delta[bh * lpad + q0 + row_lo + 8 * r];
  }
  float dq0[32], dq1[kN2 / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN2 / 2; ++i) dq1[i] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage `it` (and q, g) landed; every thread is done with stage it - 1
    {
      const int nx = it + kStages - 1;
      if (nx < cnt) load_stage(nx % kStages, klist[nx] & (kZeroTile - 1));
      cp_async_commit();
    }
    const int s = it % kStages;
    const int k0 = (klist[it] & (kZeroTile - 1)) * kTile;
    const bool tile_bias = kBias && !(klist[it] & kZeroTile);
    const uint32_t sk = sk0 + s * kWideBytes, sv = sv0 + s * kWideBytes;

    float sacc[32], dpacc[32];
    fence_acc(sacc);
    fence_acc(dpacc);
    wgmma_fence();
    wide_scores<kN2>(sacc, sq, sk);   // S = Q K^T
    wide_scores<kN2>(dpacc, sg, sv);  // dP = G V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sacc);
    fence_acc(dpacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // P in base 2, then dS = P (dP - delta) in dpacc
      float x = fmaf(sacc[i], scale2, -lse_r[(i >> 1) & 1]);
      if (tile_bias) {
        const int qr = q0 + row_lo + 8 * ((i >> 1) & 1);
        const int kc = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (qr < n && kc < n) x += bias[static_cast<int64_t>(qr) * st.bq + kc] * kLog2e;
      }
      dpacc[i] = fast_exp2(x) * (dpacc[i] - del_r[(i >> 1) & 1]);
    }
    uint32_t dsf[4][4];
    acc_to_a(dsf, dpacc);
    fence_frag(dsf);
    fence_acc(dq0);
    fence_acc(dq1);
    wgmma_fence();
    wide_grad<kN2>(dq0, dq1, dsf, sk);  // dQ += bf16(dS) K over the keys
    wgmma_commit();
    fence_frag(dsf);
    wgmma_wait<0>();
    fence_acc(dq0);
    fence_acc(dq1);
    fence_frag(dsf);
  }
  cp_async_wait<0>();

  wide_store<kN2>(dq + b * st.ob + h * st.oh + 2 * t4, st.ol, dq0, dq1, scale, q0 + row_lo, n,
                  st.hd, t4);
}

// ------------------------------- launches ------------------------------- //

// What the main and dq kernels read and write, for their launches.
struct PairArgs {
  const bf16 *q, *k, *v, *g;
  const float* bias;
  const uint8_t* blank;
  const float *lse2, *delta;
  bf16 *dq, *dk, *dv;
  int n, lpad, batch, heads;
  float scale;
  BwdStrides st;
};
using MainKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const float*,
                            const uint8_t*, const float*, const float*, bf16*, bf16*, int, int,
                            int, float, BwdStrides);
using DqKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const float*,
                          const uint8_t*, const float*, const float*, bf16*, int, int, int,
                          float, BwdStrides);

// a main kernel, then its dq kernel, with smem_fixed bytes of dynamic shared
// memory and one int per tile for the list
inline void launch_main_dq(MainKernel mk, DqKernel dqk, int smem_fixed, const PairArgs& a,
                           cudaStream_t stm) {
  const int nt = a.lpad / kTile;
  const int smem = smem_fixed + nt * static_cast<int>(sizeof(int));
  const dim3 grid(nt, a.heads, a.batch);
  cudaFuncSetAttribute(mk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mk<<<grid, kThreads, smem, stm>>>(a.q, a.k, a.v, a.g, a.bias, a.blank, a.lse2, a.delta,
                                    a.dk, a.dv, a.n, a.lpad, a.heads, a.scale, a.st);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dqk<<<grid, kThreads, smem, stm>>>(a.q, a.k, a.v, a.g, a.bias, a.blank, a.lse2, a.delta,
                                     a.dq, a.n, a.lpad, a.heads, a.scale, a.st);
}

// the kD <= 64 pair, or the kD = 128 pair at the second half's width kN2
template <int kId, int kD, bool kBias>
void launch_pair(const PairArgs& a, cudaStream_t stm) {
  launch_main_dq(attn_bwd_sm90_kernel<kId, kD, kBias>, attn_bwd_dq_kernel<kId, kD, kBias>,
                 kSmemFixed, a, stm);
}
template <int kId, int kN2>
void launch_wide_pair(const PairArgs& a, cudaStream_t stm) {
  if (a.bias)
    launch_main_dq(attn_bwd_wide_kernel<kId, kN2, true>, attn_bwd_dq_wide_kernel<kId, kN2, true>,
                   kSmemWide, a, stm);
  else
    launch_main_dq(attn_bwd_wide_kernel<kId, kN2, false>,
                   attn_bwd_dq_wide_kernel<kId, kN2, false>, kSmemWide, a, stm);
}

// The fp32 workspace the wrapper allocates for one call: lse * log2(e) and
// delta, (B, H, lpad) each.
inline int64_t work_floats(int batch, int n, int heads) {
  const int64_t lpad = (n + kTile - 1) / kTile * kTile;
  return static_cast<int64_t>(batch) * heads * lpad * 2;
}

// prep, main and dq on `stm` for bf16 q, k, v, g (B, n, H, hd at the
// strides st.q*, st.k*, ...; hd = st.hd, a multiple of 8 up to kD = 48, 64
// or 128), the forward's o (strides os) and lse (fp32 (B, H, n)); bias null
// or an fp32 (n, n), row stride st.bq; dq, dk, dv at the output strides
// st.o*; work fp32 of work_floats(); blank two bytes per tile pair
// (2 * ceil(n/64)^2: the blank map, then the map of all-zero tiles) when a
// bias is given. Every base pointer and stride of q, k, v, g and o must be
// on a 16-byte boundary. Returns cudaGetLastError() as an int.
template <int kId, int kD = kHd>
int launch_attention_bwd_sm90(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                              const bf16* o, const OStrides& os, const float* lse,
                              const float* bias, bf16* dq, bf16* dk, bf16* dv, float* work,
                              uint8_t* blank, int batch, int n, int heads, const BwdStrides& st,
                              float scale, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (bias && !blank) || !o || !lse || !work ||
      st.hd % 8 || st.hd > kD || (kD > kHd && st.hd <= kHd))
    return cudaErrorInvalidValue;
  const int64_t al[15] = {st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl,
                          st.vh, st.gb, st.gl, st.gh, os.b,  os.l,  os.h};
  const void* ptrs[5] = {q, k, v, g, o};
  bool ok = true;
  for (int i = 0; i < 15; ++i) ok = ok && al[i] % 8 == 0;
  for (int i = 0; i < 5; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  if (!ok) return cudaErrorMisalignedAddress;
  const int nt = (n + kTile - 1) / kTile;
  const int lpad = nt * kTile;
  float* lse2 = work;
  float* delta = lse2 + static_cast<int64_t>(batch) * heads * lpad;

  const int64_t rows = static_cast<int64_t>(batch) * heads * lpad;
  const int row_blocks = static_cast<int>((rows + 31) / 32);
  attn_bwd_prep_kernel<kId, kD><<<row_blocks + (bias ? nt * nt : 0), 256, 0, stm>>>(
      o, g, lse, bias, lse2, delta, blank, batch, n, lpad, heads, row_blocks, st, os);
  if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());

  const PairArgs a{q, k, v, g, bias, blank, lse2, delta, dq, dk, dv,
                  n, lpad, batch, heads, scale, st};
  if constexpr (kD > kHd) {
    switch (st.hd - kHd) {  // the second half's width
      case 8: launch_wide_pair<kId, 8>(a, stm); break;
      case 16: launch_wide_pair<kId, 16>(a, stm); break;
      case 24: launch_wide_pair<kId, 24>(a, stm); break;
      case 32: launch_wide_pair<kId, 32>(a, stm); break;
      case 40: launch_wide_pair<kId, 40>(a, stm); break;
      case 48: launch_wide_pair<kId, 48>(a, stm); break;
      case 56: launch_wide_pair<kId, 56>(a, stm); break;
      default: launch_wide_pair<kId, 64>(a, stm); break;
    }
  } else if (bias) {
    launch_pair<kId, kD, true>(a, stm);
  } else {
    launch_pair<kId, kD, false>(a, stm);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blank-tile map alone (the prep kernel with no rows), for the checks:
// blank gets 2 * ceil(n/64)^2 bytes for the fp32 (n, n) bias of row stride
// bq, the blank map first.
template <int kId>
int launch_blank_tile_map(const float* bias, uint8_t* blank, int n, int64_t bq,
                          cudaStream_t stm) {
  if (n <= 0 || !bias || !blank) return cudaErrorInvalidValue;
  const int ntq = (n + kTile - 1) / kTile;
  BwdStrides st{};
  st.bq = bq;
  attn_bwd_prep_kernel<kId, kHd><<<ntq * ntq, 256, 0, stm>>>(
      nullptr, nullptr, nullptr, bias, nullptr, nullptr, blank, 1, n, ntq * kTile, 1,
      0, st, OStrides{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// The BNHD backwards' launch (#5, #6) after their C entries' checks, with
// their arguments: kernels A and B of attention_bwd_tile.cuh when `tile`
// (fp32, dbias asked for, #6 at L = 1; o, lse and blank unused, work their
// 3 * B * H * L scratch), else prep, main and dq above.
template <int kId, int kD>
int launch_bnhd_bwd(bool tile, const void* q, const void* k, const void* v, const void* g,
                    const void* o, const int64_t* os, const void* lse, const void* bias,
                    void* dq, void* dk, void* dv, void* dbias, void* work, void* blank,
                    int batch, int n, int heads, const BwdStrides& st, float scale,
                    int is_bf16, cudaStream_t stm) {
  if (tile)
    return launch_attention_bwd<kId, kD>(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n,
                                         heads, st, scale, is_bf16, stm);
  return sm90::launch_attention_bwd_sm90<kId, kD>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), sm90::OStrides{os[0], os[1], os[2]},
      static_cast<const float*>(lse), static_cast<const float*>(bias), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(work),
      static_cast<uint8_t*>(blank), batch, n, heads, st, scale, stm);
}

}  // namespace
