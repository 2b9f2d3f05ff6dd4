// Self-attention backward for Hopper (sm_90a) in bf16, FlashAttention-2's
// algorithm on wgmma: the device code of the packed-qkv backward
// (attention_qkv_bwd.cu, kernel #2) and the q-blocked backward
// (attention_qblk_bwd.cu, kernel #5). Both compute the TPU kernels' per-head
// math (_bwd_head_math, _qblk_bwd_kernel_impl) and differ only in where q, k,
// v, g, o and the three gradients live, which the strides carry. Each entry
// instantiates the kernels with its own number (kId), so that a profile
// attributes their time to the right one. fp32 inputs keep the exact FMA
// kernels of attention_bwd_tile.cuh.
//
// Per (batch, head), with lse = m + log(l) saved by the forward
// (attention_fwd_tile.cuh with kLse) and o the forward's bf16 output:
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
//     loaded once and held as register A operands; the q tiles that the map
//     leaves, with their g, lse and delta, stream through a two-stage
//     cp.async ring. Four wgmma products (m64n64k16) per tile: S^T = K Q^T
//     and dP^T = V G^T (Q and G read K-major), dV += bf16(P^T) G and dK +=
//     bf16(dS^T) Q (P^T and dS^T as register A operands, G and Q read
//     MN-major). dk and dv are written once, at the end.
//   dq, one warpgroup per (b, h, 64 q rows): the mirror image, q and g held
//     as A operands and the key tiles that the map leaves streaming past:
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
// runtime only), and the ragged tail is the forward's zero fill. Rows past L need no masks: their k and v are zero,
// and lse is +inf for q rows past L, so p is 0 there.
//
// Numerics against the TPU kernel: the same rounding points (bf16(p) for
// dv, bf16(ds) for dq and dk, fp32 sums, one cast of each output). p comes
// from lse, not from exp(s - max) / sum (fp32 rounding), and delta from the
// bf16 o, not from rowsum(p dp).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"

namespace {
namespace sm90 {

using mma_tile::bf16;
using mma_tile::pack_bf16;
using mma_tile::smem_addr;

constexpr int kHd = 64;                    // head dim
constexpr int kTile = 64;                  // q rows and keys per tile
constexpr int kThreads = 128;              // one warpgroup
constexpr int kStages = 2;                 // q/g ring depth
constexpr int kTileBytes = kTile * kHd * 2;  // one bf16 tile, 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kZeroTile = 1 << 30;  // flag on a q tile's list entry: its bias is all 0
// dynamic shared memory of the main kernel: k, v, the ring's q and g tiles,
// its lse and delta rows, then the list of q tiles (one int each); +1024 to
// align. The dq kernel takes less: q, g, the ring's k and v, its list.
constexpr int kSmemFixed = (2 + 2 * kStages) * kTileBytes + kStages * 2 * kTile * 4 + 1024;

// ------------------------------ primitives ------------------------------ //

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving, reusing or reading registers that an
// asynchronous wgmma still owns: accumulators are fenced before the
// products start, right after, and after the wait; register A operands
// right after the products start and after the wait, which keeps them live
// (and their registers unreused) until the wgmma has read them.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile whose
// rows are 128 bytes (64 values) and whose 8-row groups are 1024 bytes
// apart. Both byte offsets are 1024: the stride-dimension offset is the
// 8-row group stride in either major-ness, and the leading-dimension
// offset is never used at these shapes (a K-major row, or an MN-major run
// of 64 values, fits one swizzle atom).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define SM90_ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SM90_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, fp32) (+)= a (64 x 16, bf16 A fragments in registers) b (16 x
// 64, shared memory; kTB 0 = K-major, 1 = MN-major); accumulate = 0
// overwrites d
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
}

// This warp's A fragments (rows 16w..16w+15, one set of four per 16-wide
// step) of a 64 x 64 swizzled tile, by ldmatrix.
__device__ __forceinline__ void tile_to_a(uint32_t (&a)[4][4], uint32_t tile) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t addr = tile + r * 128 + (((kk * 2 + (lane >> 4)) ^ (r & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

// The A fragments of a 64 x 64 accumulator (its columns the product's inner
// dimension), rounded to bf16: one set of four per 16-wide step. A wgmma
// accumulator holds, per warp, the same 16-row layout as mma.sync's, which
// is the register A operand's layout.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// rows [row0, row0 + 64) x 64 values of one head's slice (row stride ld)
// into a swizzled tile at `dst`; rows >= n are zero. Every thread of the
// warpgroup starts four 16-byte copies.
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, int row0, int n,
                                                int64_t ld) {
#pragma unroll
  for (int j = 0; j < kTile * 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool in = row0 + r < n;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + static_cast<int64_t>(in ? row0 + r : 0) * ld + c * 8, in);
  }
}

// ------------------------------- kernels -------------------------------- //

// Element strides of o (the forward's output), as batch, row and head.
struct OStrides {
  int64_t b, l, h;
};

// prep: blocks [0, row_blocks) take 32 rows each (8 threads per (b, h, row)
// of the padded length lpad, 16-byte loads and stores); the next ntq * ntk
// blocks take one tile of the maps each (none when bias is null).
template <int kId>
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
    const int part = threadIdx.x & 7;  // this thread's 8 of the row's 64 values
    const int r = static_cast<int>(idx % lpad);
    const int64_t bh = idx / lpad;
    const int h = static_cast<int>(bh % heads), b = static_cast<int>(bh / heads);
    float d = 0.f;
    if (valid && r < n) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          o + b * os.b + static_cast<int64_t>(r) * os.l + h * os.h + part * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(
          g + b * st.gb + static_cast<int64_t>(r) * st.gl + h * st.gh + part * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(o2[j]), gf = __bfloat1622float2(g2[j]);
        d = fmaf(of.x, gf.x, fmaf(of.y, gf.y, d));
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

// main: one warpgroup per (b, h, 64 keys), dk and dv; see the header comment.
template <int kId, bool kBias>
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

  if (threadIdx.x == 0) {  // the q tiles that the map leaves, in order; + kZeroTile
    int c = 0;  // where the tile's bias is all 0
    for (int qt = 0; qt < ntq; ++qt)
      if (!kBias || !blank[qt * ntq + kt])
        qlist[c++] = qt | (kBias && blank[(ntq + qt) * ntq + kt] ? kZeroTile : 0);
    qcount = c;
  }
  __syncthreads();
  const int cnt = qcount;

  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* gp = g + b * st.gb + h * st.gh;
  auto load_stage = [&](int s, int qt) {
    load_tile_async(sq0 + s * kTileBytes, qp, qt * kTile, n, st.ql);
    load_tile_async(sg0 + s * kTileBytes, gp, qt * kTile, n, st.gl);
    if (threadIdx.x < 32) {  // lse2 and delta: 16 chunks each, padded rows
      const float* src = (threadIdx.x < 16 ? lse2 : delta) + bh * lpad + qt * kTile +
                         (threadIdx.x & 15) * 4;
      cp_async16(smem_addr(sstat + s * 2 * kTile) + threadIdx.x * 16, src, true);
    }
  };
  load_tile_async(sk, k + b * st.kb + h * st.kh, k0, n, st.kl);
  load_tile_async(sv, v + b * st.vb + h * st.vh, k0, n, st.vl);
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
    for (int kk = 0; kk < 4; ++kk)  // S^T = K Q^T over the head dim
      wgmma_rs<0>(sacc, kf[kk], tile_desc(sq + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dP^T = V G^T
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
  for (int i = 0; i < 32; i += 2) {
    const int kr = k0 + row_lo + 8 * ((i >> 1) & 1);
    if (kr >= n) continue;
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
template <int kId, bool kBias>
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

  if (threadIdx.x == 0) {  // the key tiles that the map leaves, in order; + kZeroTile
    int c = 0;  // where the tile's bias is all 0
    for (int kt = 0; kt < ntk; ++kt)
      if (!kBias || !blank[qt * ntk + kt])
        klist[c++] = kt | (kBias && blank[(ntk + qt) * ntk + kt] ? kZeroTile : 0);
    kcount = c;
  }
  __syncthreads();
  const int cnt = kcount;

  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  auto load_stage = [&](int s, int kt) {
    load_tile_async(sk0 + s * kTileBytes, kp, kt * kTile, n, st.kl);
    load_tile_async(sv0 + s * kTileBytes, vp, kt * kTile, n, st.vl);
  };
  load_tile_async(sq, q + b * st.qb + h * st.qh, q0, n, st.ql);
  load_tile_async(sg, g + b * st.gb + h * st.gh, q0, n, st.gl);
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
    for (int kk = 0; kk < 4; ++kk)  // S = Q K^T over the head dim
      wgmma_rs<0>(sacc, qf[kk], tile_desc(sk + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dP = G V^T
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
  for (int i = 0; i < 32; i += 2) {
    const int qr = q0 + row_lo + 8 * ((i >> 1) & 1);
    if (qr < n)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<int64_t>(qr) * st.ol + 8 * (i >> 2)) =
          __floats2bfloat162_rn(dqacc[i] * scale, dqacc[i + 1] * scale);
  }
}

// the main kernel, then the dq kernel, with the dynamic shared memory they take
template <int kId, bool kBias>
void launch_main_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                    const float* bias, const uint8_t* blank, const float* lse2,
                    const float* delta, bf16* dq, bf16* dk, bf16* dv, int n, int lpad,
                    int batch, int heads, float scale, const BwdStrides& st, cudaStream_t stm) {
  const int nt = lpad / kTile;
  const int smem = kSmemFixed + nt * static_cast<int>(sizeof(int));
  const dim3 grid(nt, heads, batch);
  cudaFuncSetAttribute(attn_bwd_sm90_kernel<kId, kBias>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attn_bwd_sm90_kernel<kId, kBias><<<grid, kThreads, smem, stm>>>(
      q, k, v, g, bias, blank, lse2, delta, dk, dv, n, lpad, heads, scale, st);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  cudaFuncSetAttribute(attn_bwd_dq_kernel<kId, kBias>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attn_bwd_dq_kernel<kId, kBias><<<grid, kThreads, smem, stm>>>(
      q, k, v, g, bias, blank, lse2, delta, dq, n, lpad, heads, scale, st);
}

// The fp32 workspace the wrapper allocates for one call: lse * log2(e) and
// delta, (B, H, lpad) each.
inline int64_t work_floats(int batch, int n, int heads) {
  const int64_t lpad = (n + kTile - 1) / kTile * kTile;
  return static_cast<int64_t>(batch) * heads * lpad * 2;
}

// prep, main and dq on `stm` for bf16 q, k, v, g (B, n, H, 64 at the
// strides st.q*, st.k*, ...), the forward's o (strides os) and lse (fp32
// (B, H, n)); bias null or an fp32 (n, n), row stride st.bq; dq, dk, dv at
// the output strides st.o*; work fp32 of work_floats(); blank two bytes per
// tile pair (2 * ceil(n/64)^2: the blank map, then the map of all-zero
// tiles) when a bias is given. Every base pointer and stride of q, k, v, g
// and o must be on a 16-byte boundary. Returns cudaGetLastError() as an int.
template <int kId>
int launch_attention_bwd_sm90(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                              const bf16* o, const OStrides& os, const float* lse,
                              const float* bias, bf16* dq, bf16* dk, bf16* dv, float* work,
                              uint8_t* blank, int batch, int n, int heads, const BwdStrides& st,
                              float scale, cudaStream_t stm) {
  if (batch <= 0 || n <= 0 || heads <= 0 || (bias && !blank) || !o || !lse || !work)
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
  attn_bwd_prep_kernel<kId><<<row_blocks + (bias ? nt * nt : 0), 256, 0, stm>>>(
      o, g, lse, bias, lse2, delta, blank, batch, n, lpad, heads, row_blocks, st, os);
  if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());

  if (bias)
    launch_main_dq<kId, true>(q, k, v, g, bias, blank, lse2, delta, dq, dk, dv, n, lpad, batch,
                              heads, scale, st, stm);
  else
    launch_main_dq<kId, false>(q, k, v, g, bias, blank, lse2, delta, dq, dk, dv, n, lpad, batch,
                               heads, scale, st, stm);
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
  attn_bwd_prep_kernel<kId><<<ntq * ntq, 256, 0, stm>>>(
      nullptr, nullptr, nullptr, bias, nullptr, nullptr, blank, 1, n, ntq * kTile, 1,
      0, st, OStrides{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
