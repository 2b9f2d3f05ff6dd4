// Attention forwards for Hopper (sm_90a) in bf16 on wgmma: the BNHD forward
// of kernel #3 (attention_bnhd.cu), which replaces the TPU kernel
// imagefolder_tpu/ops/pallas/attention.py: fused_attention (kernel bodies
// _kernel and _kernel_bias), and the one-pass forward of the packed-qkv
// kernel #1 (attention_qkv.cu; _attention_qkv_fwd_impl, body
// _qkv_kernel_impl), the q-blocked kernel #4 (attention_qblk.cu;
// _fused_attention_qblk_fwd, body _kernel_qblk) and #7's attention step
// (attn_sublayer.cu).
//
// Per (batch, head), q (Lq rows) against k and v (Lk rows), keys >= Lk
// masked, s = q k^T * scale + bias (fp32), m = rowmax(s), l =
// rowsum(exp(s - m)); then
//   #3:           o = sum over keys of bf16(exp(s - m) / l) v, cast once;
//   #1, #4, #7:   o = (sum over keys of bf16(exp(s - m)) v) / l, cast once.
// #3 divides p by its row sum BEFORE the bf16 rounding for p v, as its
// Pallas kernel does; the others divide o after p v: the wrapper's
// _SINGLE_MAX_ELEMS makes that rounding point part of which numerics a call
// gets.
//
// #3: a streaming kernel knows l only once it has seen every key, so each
// block makes two passes over the key tiles:
//   pass 1: S = Q K^T per tile; a running max m and row sum l (online);
//   pass 2: S again; P = bf16(exp2(S scale log2(e) - lse2)) with lse2 =
//           m log2(e) + log2(l), which is exp(s - m) / l in fp32 with the
//           division folded into the exponent, as a register A operand;
//           O += P V.
// One pass (#1, #4, #7): per key tile, S = Q K^T; the running max m moves to
// m_new, and o and l are scaled by alpha = exp2(m - m_new); P =
// bf16(exp2(S scale log2(e) - m_new)) as a register A operand; l += rowsum
// of the fp32 P; O += P V. At the end o / l, cast once. Each k/v tile is read
// once, so k and v always stream together through the ring below.
// With kLse either kernel also stores lse = m + log(l) per row (fp32, B x H
// x Lq) for the backward (attention_bwd_sm90.cuh: #6 from #3; #2 and #5
// from the one-pass forward); a row whose every score is -inf gets -inf. The
// output does not depend on kLse.
//
// What bounds them: by its shapes, VAR's KV-cached decode at 256 px (q (128,
// pn^2 <= 121, 16, 64) against k, v (128, <= 286, 16, 64)) and its teacher
// forcing (64, 286, 16, 64) are bound by memory (the last sampling stage
// moves 213 MB for 18 GFLOP); the 512 px decode's last stage, q (128, 1024,
// 16, 64) against k, v (128, 2240, 16, 64), by operations (1.20 TFLOP at
// 4 hd per (q, k) pair; two passes run 1.5x that on the tensor cores, and
// two exponentials per pair on the special-function units), as are the
// one-pass shapes: #4 at VAR's 512 px teacher forcing (16, 2240, 16, 64)
// (214 GFLOP over the pairs the block-causal mask allows, 314 MB) and at
// the tokenizer's 512 px packed views (N = 2050 and 3073, 12 heads, B = 64:
// 206 and 464 GFLOP), #1 at (64, 514, 12 x 64) (52 GFLOP, 202 MB). At head
// dim 64 a 64 x 64 tile's two products take the tensor cores about as long
// as its 4096 exponentials take the special-function units (16 a clock on
// an SM), so the products and the softmax must overlap for either to near
// its peak. On the card they do not overlap within a warpgroup:
// timing-only variants of #3 (PERF.md) show them adding up, each product
// waited for before the step that reads it. So the design spends as few
// instructions in that chain as it can: one FFMA and one exponential per
// score on full tiles without a bias (the row max taken on the raw
// scores); the scale, bias and mask only on tiles that need them.
//
// Design: a block of two warpgroups (256 threads) per (b, h, 128 q rows);
// each warpgroup owns 64 q rows and both read the block's k and v tiles,
// which halves the shared memory and the copies per q row against one
// warpgroup per block and puts four warpgroups on an SM (two blocks of
// 97 KB or less, at most 128 registers a thread). Q is loaded once and held
// as the register A operand; both products run on wgmma m64n64k16 (bf16 in,
// fp32 accumulate; K read K-major for S, V read MN-major for P V), each
// waited for before its result is read; no score reaches device memory.
// Keys come in 64-row tiles through shared memory in wgmma's 128-byte
// swizzle, copied by cp.async (all 256 threads) ahead of their use:
//   - #3 resident (Lk <= 320: every 256 px call): every copy of k and v is
//     issued up front, k tile by tile so that pass 1 starts on the first
//     tile while the rest land; pass 2 reads k and v from shared memory, so
//     k comes from device memory once;
//   - #3 streamed (longer Lk: the 512 px decode, up to 2240): a ring of four
//     k/v slots walks the 2 nt items of both passes (pass 1 loads k, pass 2
//     k and v), three items in flight ahead of the one being computed;
//   - one pass: the same ring, one item (k and v) per key tile the block
//     needs.
// Blank tiles (one pass, with a bias and its blank-tile map): the map
// (attention_bwd_sm90.cuh's prep kernel, one byte per (64 q rows, 64 keys)
// tile: 1 when every bias entry is -inf, and a second plane, 1 when every
// one is 0) gives each block the list of key tiles it copies: those where
// either warpgroup's tile is not blank (a warpgroup past Lq counts as
// blank). A warpgroup skips both products and the softmax of a tile that is
// blank for it, which adds exactly 0 to l and o and leaves m (alpha = 1):
// the output is bit-equal to computing the tile. On a tile whose bias is
// all 0 it reads no bias. Without a map (null, or no bias) every tile is
// computed: 34% of VAR's 512 px tiles are blank.
// Ragged edges: q rows >= Lq load as zeros and are computed, never stored
// (Lq = 1 included; a warpgroup whose 64 rows all lie past Lq computes
// nothing and only copies and syncs with the other); keys >= Lk load as
// zeros and score -inf. A row whose tiles so far are all -inf (the
// block-causal mask's early rows) keeps m at -inf and exponentiates against
// 0, so that -inf - -inf never makes a NaN. A bias (1|B, 1|H, Lq, Lk),
// stride 0 on a broadcast axis, is read in place at its strides, after
// each score product's wait (a branch while a wgmma owns registers corrupts
// them: see attention_bwd_sm90.cuh). Every offset is 64-bit (the 512 px
// encoder's packed q view spans 453 M elements over 64 images). #3 computes
// the blank tiles of its bias (5 of 25 at VAR's L = 286; the decode has
// none).
// Head dim: kD = 64 (VAR, every ViT), 48 or 128 (#3 and #4 only: RAR-B,
// MaskGIT-B at 768 / 16; RAR-XL's 80 and RAR-XXL's 88), and at run time
// st.hd, any multiple of 8 up to kD (#3 and #4 run hd <= 48 under kD = 48,
// 56 under 64 and 72-128 under 128). A narrower head keeps the 64-wide
// tiles (wgmma_tile.cuh): its rows are copied into hd / 8 chunks and the
// rest zero-filled, S = Q K^T runs kD / 16 K-steps (3 instead of 4 at
// kD = 48), P V computes the zero columns of V past hd, and only hd columns
// are stored. At kD = 128 each q, k and v tile is two such 64-wide tiles
// side by side in shared memory (columns 0-63, then 64-127 from the next
// 8 KB), each a 128-byte swizzle atom a row: S = Q K^T runs 8 K-steps, four
// over each half, and O is two 64 x 64 accumulators, each P V against one
// half of V. That doubles the shared memory (one block an SM: 161 KB
// streamed, 193 KB resident) and O's registers, so the kD = 128
// instantiations run one block of two warpgroups per SM. Widths 72-120 run
// the 128 code over zero-filled columns; no branch guards a wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {
namespace sm90 {

// Element strides of q, k and v (batch, row, head; the head-dim stride is
// 1) and of the bias (batch, head, row; column stride 1; 0 on a broadcast
// axis), and the head dim hd (a multiple of 8, at most the kernel's kD;
// the output is (B, Lq, H, hd)).
struct FwdStrides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, bb, bh, bq;
  int hd = kHd;
};

constexpr int kFwdWG = 2;          // warpgroups per block, 64 q rows each, one k/v ring
constexpr int kFwdThreads = kFwdWG * kThreads;
constexpr int kFwdSlots = 4;       // streamed: k/v slots of the ring
constexpr int kResidentTiles = 5;  // resident: up to five key tiles (Lk <= 320)
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory for the q tiles and `slots` k/v pairs at head dim
// kD; +1024 to align
constexpr int fwd_smem_bytes(int slots, int kD = kHd) {
  return (kFwdWG + 2 * slots) * head_tiles(kD) * kTileBytes + 1024;
}

// the A fragments of a q tile of head dim kD (one set per 64-wide half)
template <int kD>
__device__ __forceinline__ void head_to_a(uint32_t (&qf)[head_tiles(kD)][4][4], uint32_t sq) {
#pragma unroll
  for (int hh = 0; hh < head_tiles(kD); ++hh) tile_to_a(qf[hh], sq + hh * kTileBytes);
}

// O (+)= P V for one 64-key tile: P the A fragments, V the head_tiles(kD)
// MN-major tiles at sv, one 64 x 64 accumulator per half; issued and
// waited for
template <int kD>
__device__ __forceinline__ void pv_tile(float (&o)[head_tiles(kD)][32], uint32_t (&pf)[4][4],
                                        uint32_t sv) {
  fence_frag(pf);
#pragma unroll
  for (int hh = 0; hh < head_tiles(kD); ++hh) fence_acc(o[hh]);
  wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < head_tiles(kD); ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // O += P V over the keys
      wgmma_rs<1>(o[hh], pf[kk], tile_desc(sv + hh * kTileBytes + kk * 2048), 1);
  wgmma_commit();
  fence_frag(pf);
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < head_tiles(kD); ++hh) fence_acc(o[hh]);
  fence_frag(pf);
}

// cp.async.wait_group with a count known at run time (at most kResidentTiles)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// S = Q K^T over one 64-key tile into x (qf the A fragments, sk the
// swizzled k tile or tiles), over a head dim of kD (kD / 16 K-steps, four
// per 64-wide half), issued and waited for. Element i of a thread's
// accumulator sits at row q0 + row_lo + 8 ((i >> 1) & 1) and column k0 +
// 8 (i >> 2) + 2 t4 + (i & 1).
template <int kD>
__device__ __forceinline__ void score_tile(float (&x)[32],
                                           const uint32_t (&qf)[head_tiles(kD)][4][4],
                                           uint32_t sk) {
  fence_acc(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_rs<0>(x, qf[kk >> 2][kk & 3],
                tile_desc(sk + (kk >> 2) * kTileBytes + (kk & 3) * 32), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(x);
}

// x = S * scale + bias in base 2 (times log2 e); on the ragged last tile,
// -inf past lk. The bias is read after the product's wait, while no wgmma
// owns registers.
template <bool kBias>
__device__ __forceinline__ void scale_tile(float (&x)[32], const float* bp, int64_t bq, int q0,
                                           int k0, int row_lo, int t4, int lq, int lk,
                                           float scale2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] *= scale2;
  if (kBias) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = q0 + row_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (row < lq && col < lk) x[i] = fmaf(bp[row * bq + col], kLog2e, x[i]);
    }
  }
  if (k0 + kTile > lk) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= lk) x[i] = -INFINITY;
  }
}

// the max of row r's 16 elements of x (r = 0: row_lo, 1: row_lo + 8), as a tree
__device__ __forceinline__ float row_max(const float (&x)[32], int r) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = fmaxf(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
  return t[0];
}

// kFwdWG warpgroups per (b, h, 64 kFwdWG q rows), each owning 64 q rows and
// sharing the block's k/v tiles, at head dim kD; see the header comment.
template <int kId, int kD, bool kBias, bool kLse, bool kResident>
__global__ void __launch_bounds__(kFwdThreads, head_tiles(kD) > 1 ? 1 : 2)
    attn_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ out, float* __restrict__ lse, int lq, int lk,
                         int heads, float scale, FwdStrides st) {
  constexpr int kH = head_tiles(kD);
  constexpr int kOpBytes = kH * kTileBytes;  // one q, k or v row block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const int wg = threadIdx.x / kThreads;  // this thread's warpgroup
  const uint32_t sq = ((raw + 1023) & ~1023u) + wg * kOpBytes;  // its q tile
  const uint32_t skv = ((raw + 1023) & ~1023u) + kFwdWG * kOpBytes;  // slot s: k, then v

  const int nt = (lk + kTile - 1) / kTile;
  const int q0 = (blockIdx.x * kFwdWG + wg) * kTile, h = blockIdx.y, b = blockIdx.z;
  const bool active = q0 < lq;  // a warpgroup past Lq only copies and syncs
  const int lane = threadIdx.x & 31;
  const int row_lo = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows q0 + row_lo (+ 8)
  const int t4 = lane & 3;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh : nullptr;
  const float scale2 = scale * kLog2e;

  // item it < nt is pass 1 over key tile it, item nt + j pass 2 over tile j
  auto slot = [&](int it) -> uint32_t {
    const int s = kResident ? (it < nt ? it : it - nt) : it % kFwdSlots;
    return skv + 2 * s * kOpBytes;
  };
  auto load_k = [&](uint32_t dst, int j) {
    load_head_async<kFwdThreads, kD>(dst, kp, j * kTile, lk, st.kl, threadIdx.x, st.hd);
  };
  auto load_v = [&](uint32_t dst, int j) {
    load_head_async<kFwdThreads, kD>(dst + kOpBytes, vp, j * kTile, lk, st.vl, threadIdx.x,
                                     st.hd);
  };
  auto load_item = [&](int it) {  // streamed: k (pass 1), or k and v (pass 2)
    load_k(slot(it), it < nt ? it : it - nt);
    if (it >= nt) load_v(slot(it), it - nt);
  };
  load_head_async<kThreads, kD>(sq, q + b * st.qb + h * st.qh, q0, lq, st.ql,
                                threadIdx.x % kThreads, st.hd);
  if (kResident) {
    for (int j = 0; j < nt; ++j) {  // group j: k tile j (group 0 also q)
      load_k(slot(j), j);
      cp_async_commit();
    }
    for (int j = 0; j < nt; ++j) load_v(slot(j), j);  // group nt: every v tile
    cp_async_commit();
  } else {
#pragma unroll
    for (int i = 0; i < kFwdSlots - 1; ++i) {
      if (i < 2 * nt) load_item(i);
      cp_async_commit();
    }
  }
  // wait for item it's tiles; streamed, then start item it + kFwdSlots - 1
  // into the slot that item it - 1 has left (every thread is past it)
  auto begin_item = [&](int it) {
    if (kResident) {
      if (it > nt) return;  // pass 2 past its first tile: all resident
      if (it < nt)
        cp_async_wait_n(nt - it);
      else
        cp_async_wait<0>();
    } else {
      cp_async_wait<kFwdSlots - 2>();
    }
    fence_proxy_async();
    __syncthreads();
    if (!kResident) {
      const int nx = it + kFwdSlots - 1;
      if (nx < 2 * nt) load_item(nx);
      cp_async_commit();
    }
  };

  // pass 1: m and this thread's share of l, online, in base 2
  uint32_t qf[kH][4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < nt; ++it) {
    begin_item(it);
    if (!active) continue;
    // a 128-wide head reads q's fragments from shared memory for each tile,
    // as the one-pass kernel does (see there); 48 and 64 load them once
    if (kH > 1 || it == 0) head_to_a<kD>(qf, sq);
    float x[32];
    score_tile<kD>(x, qf, slot(it));
    // a full tile without a bias at a positive scale keeps the raw scores:
    // max(s) * scale is the max of s * scale, and one FFMA per score gives
    // the exponent; otherwise x is the scaled, biased, masked score
    const bool raw = !kBias && scale2 > 0.f && (it + 1) * kTile <= lk;
    if (!raw) scale_tile<kBias>(x, bp, st.bq, q0, it * kTile, row_lo, t4, lq, lk, scale2);
    const float sx = raw ? scale2 : 1.f;  // x * sx is the score in base 2
    float mu[2], lt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max(x, r) * sx;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      l[r] *= fast_exp2(m[r] - mu[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      lt[(i >> 1) & 1][(i >> 2) & 1] += fast_exp2(fmaf(x[i], sx, -mu[(i >> 1) & 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += lt[r][0] + lt[r][1];
  }
  // lse2 = m + log2(l) per row, in base 2: p = exp2(x - lse2) is exp(s - m) / l
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lse2[r] = (m[r] == -INFINITY ? 0.f : m[r]) + log2f(l[r]);
  }
  if (kLse && active && t4 == 0) {  // lse = m + log(l), natural base
    float* row_lse = lse + (static_cast<int64_t>(b) * heads + h) * lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_lo + 8 * r;
      if (row < lq) row_lse[row] = lse2[r] * kLn2;
    }
  }

  // pass 2: O += bf16(exp(S - m) / l) V, p normalised before its rounding
  float o[kH][32];
#pragma unroll
  for (int hh = 0; hh < kH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  for (int it = nt; it < 2 * nt; ++it) {
    begin_item(it);
    if (!active) continue;
    const uint32_t sk = slot(it);
    const int k0 = (it - nt) * kTile;
    if (kH > 1) head_to_a<kD>(qf, sq);
    float x[32];
    score_tile<kD>(x, qf, sk);
    if (!kBias && k0 + kTile <= lk) {  // a full tile without a bias: one FFMA per score
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = fast_exp2(fmaf(x[i], scale2, -lse2[(i >> 1) & 1]));
    } else {
      scale_tile<kBias>(x, bp, st.bq, q0, k0, row_lo, t4, lq, lk, scale2);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = fast_exp2(x[i] - lse2[(i >> 1) & 1]);
    }
    uint32_t pf[4][4];
    acc_to_a(pf, x);
    pv_tile<kD>(o, pf, sk + kOpBytes);
  }
  cp_async_wait<0>();
  if (!active) return;

  const int64_t ldo = static_cast<int64_t>(heads) * st.hd;
  bf16* dst = out + (static_cast<int64_t>(b) * lq * heads + h) * st.hd + 2 * t4;
#pragma unroll
  for (int hh = 0; hh < kH; ++hh)
#pragma unroll
    for (int i = 0; i < (kD < kHd ? kD : kHd) / 2; i += 2) {
      // columns 64 hh + 8 (i >> 2) + 2 t4 (+ 1) < kD
      const int row = q0 + row_lo + 8 * ((i >> 1) & 1);
      const int col = hh * kHd + 8 * (i >> 2);
      if (row < lq && col + 2 * t4 < st.hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + row * ldo + col) =
            __floats2bfloat162_rn(o[hh][i], o[hh][i + 1]);
    }
}

// Every base pointer of q, k and v, and every stride of an axis longer
// than 1, on a 16-byte boundary: the cp.async copies' rule.
inline bool fwd_aligned(const bf16* q, const bf16* k, const bf16* v, int batch, int lq, int lk,
                        int heads, const FwdStrides& st) {
  const int64_t al[9] = {batch > 1 ? st.qb : 0, lq > 1 ? st.ql : 0, heads > 1 ? st.qh : 0,
                         batch > 1 ? st.kb : 0, lk > 1 ? st.kl : 0, heads > 1 ? st.kh : 0,
                         batch > 1 ? st.vb : 0, lk > 1 ? st.vl : 0, heads > 1 ? st.vh : 0};
  bool ok = reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) ok = ok && al[i] % 8 == 0;
  return ok;
}

template <int kId, int kD, bool kBias, bool kLse, bool kResident>
void launch_fwd_sm90(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
                     float* lse, int batch, int lq, int lk, int heads, const FwdStrides& st,
                     float scale, cudaStream_t stm) {
  const int nt = (lk + kTile - 1) / kTile;
  const int smem = fwd_smem_bytes(kResident ? nt : kFwdSlots, kD);
  cudaFuncSetAttribute(attn_fwd_sm90_kernel<kId, kD, kBias, kLse, kResident>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((lq + kFwdWG * kTile - 1) / (kFwdWG * kTile), heads, batch);
  attn_fwd_sm90_kernel<kId, kD, kBias, kLse, kResident><<<grid, kFwdThreads, smem, stm>>>(
      q, k, v, bias, out, lse, lq, lk, heads, scale, st);
}

// The forward on `stm` for bf16 q (B, Lq, H, kD) and k, v (B, Lk, H, kD) at
// the strides st.q*, st.k*, st.v*; bias null or fp32 at the strides st.bb,
// st.bh, st.bq (column stride 1); out contiguous (B, Lq, H, kD) bf16; lse
// null, or an fp32 (B, H, Lq) that receives each row's m + log(l). Every base
// pointer of q, k and v, and every stride of an axis longer than 1, must be
// on a 16-byte boundary (the stride of an axis of size 1 is never read). Returns
// cudaGetLastError() as an int (0 = launched). kId is the kernel's number:
// it only names the instantiations, so that a profile tells entries apart.
template <int kId, int kD = kHd>
int launch_attention_fwd_sm90(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                              bf16* out, float* lse, int batch, int lq, int lk, int heads,
                              const FwdStrides& st, float scale, cudaStream_t stm) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  if (!fwd_aligned(q, k, v, batch, lq, lk, heads, st)) return cudaErrorMisalignedAddress;
  const bool resident = (lk + kTile - 1) / kTile <= kResidentTiles;
#define FWD_SM90(kBias, kLse)                                                                  \
  (resident ? launch_fwd_sm90<kId, kD, kBias, kLse, true>(q, k, v, bias, out, lse, batch, lq, \
                                                           lk, heads, st, scale, stm)          \
            : launch_fwd_sm90<kId, kD, kBias, kLse, false>(q, k, v, bias, out, lse, batch, lq, \
                                                            lk, heads, st, scale, stm))
  if (bias && lse) FWD_SM90(true, true);
  else if (bias) FWD_SM90(true, false);
  else if (lse) FWD_SM90(false, true);
  else FWD_SM90(false, false);
#undef FWD_SM90
  return static_cast<int>(cudaGetLastError());
}


// ------------------------- one pass: #1, #4, #7 ------------------------- //

constexpr int kListShift = 24;  // a tile list entry: key tile | flags << kListShift

// kFwdWG warpgroups per (b, h, 64 kFwdWG q rows), one pass over the key
// tiles at head dim kD: o / l after p v (see the header comment). blank
// null: every key tile; else the (nt, nt) blank-tile map, then the map of
// all-zero bias tiles (lq == lk).
template <int kId, int kD, bool kBias, bool kLse>
__global__ void __launch_bounds__(kFwdThreads, head_tiles(kD) > 1 ? 1 : 2)
    attn_fwd_onepass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const uint8_t* __restrict__ blank, bf16* __restrict__ out,
                            float* __restrict__ lse, int lq, int lk, int heads, float scale,
                            FwdStrides st) {
  constexpr int kH = head_tiles(kD);
  constexpr int kOpBytes = kH * kTileBytes;  // one q, k or v row block
  extern __shared__ uint8_t smem_raw[];
  __shared__ int warp_count[kFwdThreads / 32];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;
  const int wg = threadIdx.x / kThreads;  // this thread's warpgroup
  const uint32_t sq = tiles + wg * kOpBytes;  // its q tile
  const uint32_t skv = tiles + kFwdWG * kOpBytes;  // slot s: k, then v
  // the block's list of key tiles, after the ring
  int* list = reinterpret_cast<int*>(smem_raw + (tiles - raw) +
                                     (kFwdWG + 2 * kFwdSlots) * kOpBytes);

  const int nt = (lk + kTile - 1) / kTile;
  const int q0 = (blockIdx.x * kFwdWG + wg) * kTile, h = blockIdx.y, b = blockIdx.z;
  const bool active = q0 < lq;  // a warpgroup past Lq only copies and syncs
  const int lane = threadIdx.x & 31;
  const int row_lo = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows q0 + row_lo (+ 8)
  const int t4 = lane & 3;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  const float* bp = kBias ? bias + b * st.bb + h * st.bh : nullptr;
  const float scale2 = scale * kLog2e;

  // With a map: list the key tiles that either warpgroup needs, in order,
  // each with its flags (bit w: blank for warpgroup w; bit kFwdWG + w: all
  // 0), compacted by ballots, kFwdThreads tiles at a time.
  int items = nt;
  if (blank) {
    const int qt0 = blockIdx.x * kFwdWG;  // the block's first q tile; the map is nt x nt
    items = 0;
    for (int c0 = 0; c0 < nt; c0 += kFwdThreads) {
      const int kt = c0 + threadIdx.x;
      int entry = 0;
      bool need = false;
      if (kt < nt) {
        int flags = 0;
#pragma unroll
        for (int w = 0; w < kFwdWG; ++w) {
          const int64_t at = static_cast<int64_t>(qt0 + w) * nt + kt;
          const bool in = qt0 + w < nt;
          flags |= (!in || blank[at] ? 1 : 0) << w;
          flags |= (in && blank[static_cast<int64_t>(nt) * nt + at] ? 1 : 0) << (kFwdWG + w);
        }
        need = (flags & ((1 << kFwdWG) - 1)) != (1 << kFwdWG) - 1;
        entry = kt | (flags << kListShift);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, need);
      if (lane == 0) warp_count[threadIdx.x >> 5] = __popc(ballot);
      __syncthreads();
      int before = items;
#pragma unroll
      for (int w = 0; w < kFwdThreads / 32; ++w) {
        if (w < static_cast<int>(threadIdx.x >> 5)) before += warp_count[w];
        items += warp_count[w];
      }
      if (need) list[before + __popc(ballot & ((1u << lane) - 1))] = entry;
      __syncthreads();  // the list is complete, warp_count free again
    }
  }
  auto tile_of = [&](int it) { return blank ? list[it] & ((1 << kListShift) - 1) : it; };
  auto slot = [&](int it) -> uint32_t { return skv + 2 * (it % kFwdSlots) * kOpBytes; };
  auto load_item = [&](int it) {  // k and v of the item's key tile
    const int j = tile_of(it);
    load_head_async<kFwdThreads, kD>(slot(it), kp, j * kTile, lk, st.kl, threadIdx.x, st.hd);
    load_head_async<kFwdThreads, kD>(slot(it) + kOpBytes, vp, j * kTile, lk, st.vl,
                                     threadIdx.x, st.hd);
  };
  load_head_async<kThreads, kD>(sq, q + b * st.qb + h * st.qh, q0, lq, st.ql,
                                threadIdx.x % kThreads, st.hd);
#pragma unroll
  for (int i = 0; i < kFwdSlots - 1; ++i) {  // group i: item i (group 0 also q)
    if (i < items) load_item(i);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share
  float o[kH][32];
#pragma unroll
  for (int hh = 0; hh < kH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  for (int it = 0; it < items; ++it) {
    // wait for item it; start item it + kFwdSlots - 1 into the slot that
    // item it - 1 has left (every thread is past it)
    cp_async_wait<kFwdSlots - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + kFwdSlots - 1 < items) load_item(it + kFwdSlots - 1);
    cp_async_commit();
    if (!active) continue;
    const int flags = blank ? list[it] >> kListShift : 0;
    if ((flags >> wg) & 1) continue;  // blank for this warpgroup: adds exactly 0
    const uint32_t sk = slot(it);
    const int k0 = tile_of(it) * kTile;
    // q's A fragments, read from shared memory for each tile: carried round
    // this loop in registers (loaded at its first item, or before it, even
    // with fences on them around each product) they came out wrong from the
    // second key tile on, with no diagnostic from ptxas. Four ldmatrix a
    // tile cost nothing measurable (nor did Q read by the product from
    // shared memory instead: PERF.md)
    uint32_t qf[kH][4][4];
    head_to_a<kD>(qf, sq);
    float x[32];
    score_tile<kD>(x, qf, sk);
    // a full tile without a bias at a positive scale keeps the raw scores:
    // max(s) * scale is the max of s * scale, and one FFMA per score gives
    // the exponent; otherwise x is the scaled, biased, masked score. An
    // all-0 bias tile is not read but keeps the scaled path, whose rounding
    // adding 0 does not change: the map changes no bit of the output
    const bool raw = !kBias && scale2 > 0.f && k0 + kTile <= lk;
    if (kBias && !((flags >> (kFwdWG + wg)) & 1))
      scale_tile<true>(x, bp, st.bq, q0, k0, row_lo, t4, lq, lk, scale2);
    else if (!raw)
      scale_tile<false>(x, bp, st.bq, q0, k0, row_lo, t4, lq, lk, scale2);
    const float sx = raw ? scale2 : 1.f;  // x * sx is the score in base 2
    float mu[2], alpha[2], lt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max(x, r) * sx;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = fast_exp2(m[r] - mu[r]);  // 0 while the row is all -inf
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int hh = 0; hh < kH; ++hh) o[hh][i] *= alpha[(i >> 1) & 1];
      x[i] = fast_exp2(fmaf(x[i], sx, -mu[(i >> 1) & 1]));
      lt[(i >> 1) & 1][(i >> 2) & 1] += x[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], lt[r][0] + lt[r][1]);
    uint32_t pf[4][4];
    acc_to_a(pf, x);
    pv_tile<kD>(o, pf, sk + kOpBytes);
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (kLse && t4 == 0) {  // lse = m + log(l), natural base
    float* row_lse = lse + (static_cast<int64_t>(b) * heads + h) * lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row_lo + 8 * r;
      if (row < lq) row_lse[row] = ((m[r] == -INFINITY ? 0.f : m[r]) + log2f(l[r])) * kLn2;
    }
  }
  const int64_t ldo = static_cast<int64_t>(heads) * st.hd;
  bf16* dst = out + (static_cast<int64_t>(b) * lq * heads + h) * st.hd + 2 * t4;
#pragma unroll
  for (int hh = 0; hh < kH; ++hh)
#pragma unroll
    for (int i = 0; i < (kD < kHd ? kD : kHd) / 2; i += 2) {
      // columns 64 hh + 8 (i >> 2) + 2 t4 (+ 1) < kD
      const int r = (i >> 1) & 1;
      const int row = q0 + row_lo + 8 * r;
      const int col = hh * kHd + 8 * (i >> 2);
      if (row < lq && col + 2 * t4 < st.hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + row * ldo + col) =
            __floats2bfloat162_rn(o[hh][i] / l[r], o[hh][i + 1] / l[r]);
    }
}

template <int kId, int kD, bool kBias, bool kLse>
void launch_fwd_onepass(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                        const uint8_t* blank, bf16* out, float* lse, int batch, int lq, int lk,
                        int heads, const FwdStrides& st, float scale, cudaStream_t stm) {
  const int nt = (lk + kTile - 1) / kTile;
  const int smem =
      fwd_smem_bytes(kFwdSlots, kD) + (blank ? nt : 0) * static_cast<int>(sizeof(int));
  cudaFuncSetAttribute(attn_fwd_onepass_kernel<kId, kD, kBias, kLse>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((lq + kFwdWG * kTile - 1) / (kFwdWG * kTile), heads, batch);
  attn_fwd_onepass_kernel<kId, kD, kBias, kLse><<<grid, kFwdThreads, smem, stm>>>(
      q, k, v, bias, blank, out, lse, lq, lk, heads, scale, st);
}

// The one-pass forward on `stm`: arguments as launch_attention_fwd_sm90's,
// and blank null or the blank-tile map of the bias and its map of all-zero
// tiles (2 ceil(lq/64)^2 bytes, as the prep kernel of attention_bwd_sm90.cuh
// writes them), which needs a bias and lq == lk.
template <int kId, int kD = kHd>
int launch_attention_fwd_onepass(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                 const uint8_t* blank, bf16* out, float* lse, int batch, int lq,
                                 int lk, int heads, const FwdStrides& st, float scale,
                                 cudaStream_t stm) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || (blank && (!bias || lq != lk)))
    return cudaErrorInvalidValue;
  if (!fwd_aligned(q, k, v, batch, lq, lk, heads, st)) return cudaErrorMisalignedAddress;
#define FWD_ONEPASS(kBias, kLse)                                                          \
  launch_fwd_onepass<kId, kD, kBias, kLse>(q, k, v, bias, blank, out, lse, batch, lq, lk, heads, \
                                           st, scale, stm)
  if (bias && lse) FWD_ONEPASS(true, true);
  else if (bias) FWD_ONEPASS(true, false);
  else if (lse) FWD_ONEPASS(false, true);
  else FWD_ONEPASS(false, false);
#undef FWD_ONEPASS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
