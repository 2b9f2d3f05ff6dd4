// One GEMM with fused epilogues, y = x W^T, shared by the fused ViT
// sublayers (attn_sublayer.cu, kernel #7; mlp_sublayer.cu, kernels #8 and
// #10). x is row-major (M, K); W is in PyTorch's (out, in) layout, (N, K):
// both operands are K-major. M is ragged (rows masked); N and K must be
// multiples of 64 (the callers check).
//
// The epilogue is a template parameter, applied to the fp32 accumulators in
// registers before the only store; "round" is a rounding to the activation
// type (bf16, or nothing in fp32), b the bias and res the residual stream:
//   kDense      y = round(round(acc) + round(b))           flax Dense: #7's qkv
//   kDenseGelu  h = round(gelu(y)), erf in fp32              #8's fc1
//   kDenseLsRes out = fp32(res) + ls * fp32(y), stored fp32  #7's proj, #8's fc2
//   kBias32Gelu h = round(gelu(acc + b)), b fp32             #10's first product
//   kBias32     o = round(acc + b), b fp32                   #10's second
// In kDenseLsRes the multiply and the add are two roundings (__fmul_rn,
// __fadd_rn), as PyTorch computes res.float() + ls * y.
//
// bf16 (gemm_sm90_kernel) is warp-specialised and persistent, on Hopper's
// TMA and wgmma. A block of three warpgroups: warpgroup 0 is the producer
// (setmaxnreg.dec to 40 registers; one thread issues every copy), 1 and 2
// the consumers (setmaxnreg.inc to 232), each owning 64 rows of a 128 x BN
// output tile; BN = 256 where N % 256 == 0 (768, 1536, 2304, 3072), else
// 128 (ViT-S's 384 and 1152). Shared memory holds a ring of stages, each
// the x tile (128 rows) and the W tile (BN rows) of one 64-wide k-tile, one
// 128-byte swizzled row per operand row, with a full and an empty
// mbarrier: 4 stages of 48 KB at BN = 256 (6 of 32 KB at 128) for
// kDenseLsRes, 3 (4) beside the TMA stores' staging for the others. The
// producer waits on a stage's empty barrier, arms its full barrier with the
// stage's byte count and starts two TMA copies (tensor maps with the 128-byte
// swizzle, built on the host per call; rows past M or N arrive as zeros).
// A consumer waits on full, issues the k-tile's four m64nBNk16 products with
// both operands in shared memory, and releases the previous stage (every
// consumer thread arrives on its empty barrier) once wgmma.wait_group has
// left only this k-tile's products in flight. The grid is min(tiles, SMs);
// block b walks tiles b, b + grid, ... (m-tile t / nN, n-tile t % nN), so
// the blocks in flight share x's row blocks and W stays in L2, and the
// producer runs into the next tile's stages while the consumers run this
// tile's epilogue. Stage s of a role's i-th k-tile is i % stages; its full
// barrier completes once per round and is waited for with parity (i /
// stages) & 1, the empty one with the opposite parity, so that the
// producer's first round passes at once.
//
// The epilogue works on pairs of neighbouring accumulators (one packed
// conversion rounds both), reads the tile's biases and LayerScales from
// shared memory (loaded once per tile), and has no per-element branch: a
// branch per pair had kept ptxas from interleaving the pairs. A bf16
// output is written into a staging buffer in shared memory and leaves by
// TMA stores that the consumer does not wait for, so that the next tile's
// products overlap its write (all blocks finish their tiles together, and
// stores from registers came in one burst a tile); the rows and columns
// past M and N are dropped by the store. kDenseLsRes's fp32 output (64 KB
// a consumer) is stored from registers, the residuals of 16 column pairs
// loaded together first, and only a ragged tile tests its elements: staged
// through the same 32 KB in two passes, with the residuals held for a pass,
// it spilled and ran slower (PERF.md).
//
// fp32 (gemm_f32_kernel): exact FFMA tiles (64 x 64 per block of 256
// threads, 4 x 4 outputs a thread, a k-step of 16), never TF32, so that
// fp32 runs on the card stay within summation order of the CPU's.
//
// Each entry instantiates the kernels with its own number (kId, the first
// template argument), so that a profile attributes their time to the right
// one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time

#include "wgmma_tile.cuh"

namespace {

using mma_tile::bf16;
using mma_tile::smem_addr;

enum Epilogue : int { kDense = 0, kDenseGelu = 1, kDenseLsRes = 2, kBias32Gelu = 3, kBias32 = 4 };

// What the epilogue reads and writes beside the accumulators.
struct EpiArgs {
  const void* bias;  // (N,): the activation type for kDense*, fp32 for kBias32*
  const void* res;   // (M, N) residual stream for kDenseLsRes, bf16 (res_bf16) or fp32
  const float* ls;   // (N,) LayerScale for kDenseLsRes
  void* out;         // (M, N): fp32 for kDenseLsRes, else the activation type
  int res_bf16;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <bool kBf16>
__device__ __forceinline__ float round_act(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// What the epilogue reads beside an accumulator, loaded by the caller: the
// column's bias and LayerScale (a tile's columns are read once and serve
// every row) and, for kDenseLsRes, the residual of two neighbouring elements.
template <int kEpi, bool kBf16>
__device__ __forceinline__ float epi_bias(const EpiArgs& ea, int col) {
  return kEpi == kBias32Gelu || kEpi == kBias32 || !kBf16
             ? static_cast<const float*>(ea.bias)[col]
             : __bfloat162float(static_cast<const bf16*>(ea.bias)[col]);
}
template <int kEpi>
__device__ __forceinline__ float epi_ls(const EpiArgs& ea, int col) {
  return kEpi == kDenseLsRes ? ea.ls[col] : 0.f;
}
__device__ __forceinline__ float2 epi_res_pair(const EpiArgs& ea, int64_t row, int col,
                                               int n) {
  const int64_t i = row * n + col;
  if (ea.res_bf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(ea.res) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(ea.res) + i);
}

// Two values rounded to the activation type (bf16: one packed conversion
// for both, each rounded to nearest even), with their packed form.
struct Pair {
  float2 f;
  __nv_bfloat162 h;  // bf16 only
};
template <bool kBf16>
__device__ __forceinline__ Pair round_pair(float x, float y) {
  if (!kBf16) return {make_float2(x, y), __nv_bfloat162()};
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return {__bfloat1622float2(h), h};
}

// The epilogue of two neighbouring elements (col even) of one row from
// their accumulators a, biases b, LayerScales s and residuals r: their
// final values, rounded to the type they are stored in.
template <int kEpi, bool kBf16>
__device__ __forceinline__ Pair epi_pair(float2 a, float2 b, float2 s, float2 r) {
  if (kEpi == kBias32Gelu || kEpi == kBias32) {
    const float t0 = a.x + b.x, t1 = a.y + b.y;
    return kEpi == kBias32Gelu ? round_pair<kBf16>(gelu_erf(t0), gelu_erf(t1))
                               : round_pair<kBf16>(t0, t1);
  }
  const float2 ra = round_pair<kBf16>(a.x, a.y).f;
  const Pair y = round_pair<kBf16>(ra.x + b.x, ra.y + b.y);
  if (kEpi == kDense) return y;
  if (kEpi == kDenseGelu) return round_pair<kBf16>(gelu_erf(y.f.x), gelu_erf(y.f.y));
  return {make_float2(__fadd_rn(r.x, __fmul_rn(s.x, y.f.x)),
                      __fadd_rn(r.y, __fmul_rn(s.y, y.f.y))),
          __nv_bfloat162()};
}

// Stores a pair at element i of the output: fp32 for kDenseLsRes and in
// fp32, else packed bf16.
template <int kEpi, bool kBf16>
__device__ __forceinline__ void epi_store(const EpiArgs& ea, int64_t i, const Pair& v) {
  if (kEpi == kDenseLsRes || !kBf16)
    *reinterpret_cast<float2*>(static_cast<float*>(ea.out) + i) = v.f;
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ea.out) + i) = v.h;
}

// ------------------------------- bf16 ---------------------------------- //
// A warp-specialised, persistent GEMM on TMA and wgmma (see the header).

namespace gemm90 {

constexpr int kBM = 128;          // rows of a block's output tile: 64 per consumer warpgroup
constexpr int kBK = 64;           // k-tile: one 128-byte swizzled row per operand row
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);  // and one producer warpgroup
// bf16 outputs leave through shared memory and TMA stores (kStoreTma); the
// fp32 output of kDenseLsRes is stored from registers
template <int kEpi>
__host__ __device__ constexpr bool store_tma() { return kEpi != kDenseLsRes; }
// the ring's stages: 4 at BN = 256 and 6 at BN = 128, or 3 and 4 beside
// the staging of TMA stores
template <int kEpi>
__host__ __device__ constexpr int ring_bytes() { return store_tma<kEpi>() ? 147456 : 196608; }
constexpr int kStagingBytes = 32768;  // per consumer: its 64 x 256 bf16 outputs
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr long long kWatchdogCycles = 1ll << 34;  // ~9 s: a wait that never ends traps

template <int kBN>
__host__ __device__ constexpr int stage_bytes() { return (kBM + kBN) * kBK * 2; }
template <int kEpi, int kBN>
__host__ __device__ constexpr int stages() { return ring_bytes<kEpi>() / stage_bytes<kBN>(); }
constexpr int kBarBytes = 256;  // a full and an empty mbarrier per stage
// the ring (+1024 to align it to the 128-byte swizzle's 1024-byte period),
// the TMA stores' staging, the barriers, then each consumer's copy of its
// tile's bias and LayerScale
template <int kEpi, int kBN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<kEpi>() + (store_tma<kEpi>() ? kConsumers * kStagingBytes : 0) + 1024 +
         kBarBytes + kConsumers * 2 * kBN * 4;
}
constexpr int kResChunk = 16;  // column pairs whose residuals are loaded together

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the producer's arrival, which also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the phase of parity `parity` of the barrier has completed. A
// wrong parity or arrival count would hang: past kWatchdogCycles the wait
// traps instead, so that the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// box (64 values of k, rows) at (k0, row0) of a 2-d tensor map into
// shared memory at dst, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// a 64 x 64 box of shared memory at src to (k0, row0) of a 2-d tensor map
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int k0, int row0) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(k0), "r"(row0)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed TMA stores have read their shared memory (kRead) or are done
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

#define GEMM90_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define GEMM90_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x BN, fp32) (+)= a (64 x 16) b (BN x 16)^T, both operands bf16 in
// shared memory, K-major, 128-byte swizzled; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" GEMM90_D128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" GEMM90_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One k-tile's four k16 steps into d: this warpgroup's 64 rows of x at a,
// the tile's BN rows of W at b. A k16 step is 32 bytes along a swizzled row.
template <int kAcc>
__device__ __forceinline__ void ktile_mma(float (&d)[kAcc], uint32_t a, uint32_t b,
                                          int accumulate) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss(d, sm90::tile_desc(a + kk * 32), sm90::tile_desc(b + kk * 32),
             accumulate | kk);
}

}  // namespace gemm90

// One consumer's 64 x kBN accumulators through a bf16 epilogue into its
// staging at stg, as kBN / 64 boxes of 64 x 64 in the 128-byte swizzle
// (16-byte chunk q of row r at q ^ (r % 8)) that the TMA store reads; row r
// = r_lo is this thread's, with r_lo + 8; no element is tested: the store
// drops what lies past m and n.
template <int kEpi, int kBN>
__device__ __forceinline__ void stage_tile(const float (&d)[kBN / 2], const float (*cb)[kBN],
                                           uint32_t stg, int r_lo, int t4) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int lc = 8 * j + 2 * t4;
    const float2 b = *reinterpret_cast<const float2*>(&cb[0][lc]);
    const float2 s = *reinterpret_cast<const float2*>(&cb[1][lc]);
    const float2 none = make_float2(0.f, 0.f);
    const Pair v0 = epi_pair<kEpi, true>(make_float2(d[4 * j], d[4 * j + 1]), b, s, none);
    const Pair v1 = epi_pair<kEpi, true>(make_float2(d[4 * j + 2], d[4 * j + 3]), b, s, none);
    const uint32_t at = stg + (j / 8) * 8192 + r_lo * 128 + (((j % 8) ^ (r_lo & 7)) << 4) + 4 * t4;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                 "r"(*reinterpret_cast<const uint32_t*>(&v0.h))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                 "r"(*reinterpret_cast<const uint32_t*>(&v1.h))
                 : "memory");
  }
}

// One consumer's 64 x kBN accumulators through the epilogue into the
// output: element 4j + e of d sits at row r_lo + 8 (e >> 1), column n0 + 8j
// + 2 t4 + (e & 1); cb holds the tile's biases (cb[0]) and LayerScales
// (cb[1]). kMask tests each row and column against m and n (a ragged
// tile); a full tile has no branch, so that the pairs interleave.
// kDenseLsRes loads the residuals of kResChunk column pairs (both rows)
// before storing any of them, so that their reads are in flight together.
template <int kEpi, int kBN, bool kMask>
__device__ __forceinline__ void store_tile(const float (&d)[kBN / 2], const float (*cb)[kBN],
                                           const EpiArgs& ea, int r_lo, int n0, int m, int n,
                                           int t4) {
  constexpr int kChunk = kBN / 8 < gemm90::kResChunk ? kBN / 8 : gemm90::kResChunk;
  const int64_t i_lo = static_cast<int64_t>(r_lo) * n + n0 + 2 * t4, i_hi = i_lo + 8ll * n;
  const bool lo_in = !kMask || r_lo < m, hi_in = !kMask || r_lo + 8 < m;
#pragma unroll
  for (int j0 = 0; j0 < kBN / 8; j0 += kChunk) {
    float2 res[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      const bool in = kEpi == kDenseLsRes && (!kMask || n0 + 8 * j + 2 * t4 < n);
      res[jj][0] = in && lo_in ? epi_res_pair(ea, r_lo, n0 + 8 * j + 2 * t4, n)
                               : make_float2(0.f, 0.f);
      res[jj][1] = in && hi_in ? epi_res_pair(ea, r_lo + 8, n0 + 8 * j + 2 * t4, n)
                               : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj, lc = 8 * j + 2 * t4;
      if (kMask && n0 + lc >= n) continue;
      const float2 b = *reinterpret_cast<const float2*>(&cb[0][lc]);
      const float2 s = *reinterpret_cast<const float2*>(&cb[1][lc]);
      const Pair v0 = epi_pair<kEpi, true>(make_float2(d[4 * j], d[4 * j + 1]), b, s, res[jj][0]);
      const Pair v1 =
          epi_pair<kEpi, true>(make_float2(d[4 * j + 2], d[4 * j + 3]), b, s, res[jj][1]);
      if (lo_in) epi_store<kEpi, true>(ea, i_lo + 8 * j, v0);
      if (hi_in) epi_store<kEpi, true>(ea, i_hi + 8 * j, v1);
    }
  }
}

// y = x W^T with epilogue kEpi, bf16 operands: see the header. Block tiles
// of 128 x kBN walked persistently (the block's i-th tile t = blockIdx.x +
// i gridDim.x; m-tile t / nN, n-tile t % nN); warpgroup 0 produces, 1 and 2
// consume, 64 rows of each tile apiece.
template <int kId, int kEpi, int kBN>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_y, int m, int n, int k,
                     EpiArgs ea) {
  using namespace gemm90;
  constexpr bool kStoreTma = store_tma<kEpi>();
  constexpr int kStages = stages<kEpi, kBN>();
  constexpr int kStage = stage_bytes<kBN>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t staging = ring + ring_bytes<kEpi>();
  const uint32_t full = staging + (kStoreTma ? kConsumers * kStagingBytes : 0);
  const uint32_t empty = full + 8 * kStages;

  const int nn = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * nn;
  const int nk = k / kBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int it = 0;  // k-tiles issued by this block so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / nn * kBM, n0 = t % nn * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t round = it / kStages;
          mbar_wait(empty + 8 * s, (round & 1) ^ 1);  // both consumers released it
          mbar_expect_tx(full + 8 * s, kStage);
          const uint32_t a = ring + s * kStage;
          tma_load(a, &map_x, full + 8 * s, kt * kBK, m0);
          tma_load(a + kBM * kBK * 2, &map_w, full + 8 * s, kt * kBK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    // the k-tile at ring position `it` into the accumulators: this
    // consumer's 64 rows of x, the tile's kBN rows of W
    auto issue = [&](int it, int accumulate) {
      const uint32_t a = ring + it % kStages * kStage;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
      ktile_mma(acc, a + c * 64 * 128, a + kBM * 128, accumulate);
      sm90::wgmma_commit();
    };
    // this consumer's copy of its tile's bias (cb[0]) and LayerScale (cb[1])
    float(*cb)[kBN] = reinterpret_cast<float(*)[kBN]>(
        smem + (full - smem_addr(smem)) + kBarBytes + c * 2 * kBN * 4);
    for (int i = 0; blockIdx.x + i * gridDim.x < tiles; ++i) {
      const int t = blockIdx.x + i * gridDim.x;
      const int m0 = t / nn * kBM, n0 = t % nn * kBN;
      // this thread's share of the tile's columns, read before the products
      // and written to shared memory after them
      float col_b[kBN / 128], col_s[kBN / 128];
#pragma unroll
      for (int q = 0; q < kBN / 128; ++q) {
        const int col = n0 + tid + 128 * q;
        col_b[q] = col < n ? epi_bias<kEpi, true>(ea, col) : 0.f;
        col_s[q] = col < n ? epi_ls<kEpi>(ea, col) : 0.f;
      }
      // k-tile 0 overwrites the accumulators; each later k-tile is issued
      // before the previous one is waited for, and the previous stage is
      // released once its products have read it (one group in flight)
      int it = i * nk;  // ring position of the tile's first k-tile
      mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
      issue(it, 0);
      for (int kt = 1; kt < nk; ++kt) {
        ++it;
        mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
        issue(it, 1);
        sm90::wgmma_wait<1>();
        sm90::fence_acc(acc);
        mbar_arrive(empty + 8 * ((it - 1) % kStages));
      }
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
      mbar_arrive(empty + 8 * (it % kStages));

      // the columns into shared memory, once every warp of this consumer is
      // done with the last tile's (and its TMA stores have read the staging)
      if (kStoreTma && tid == 0) bulk_wait_all<true>();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
      for (int q = 0; q < kBN / 128; ++q) {
        cb[0][tid + 128 * q] = col_b[q];
        cb[1][tid + 128 * q] = col_s[q];
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

      // epilogue: bf16 outputs through the staging and TMA stores that this
      // consumer does not wait for; fp32 (kDenseLsRes) from registers, a
      // full tile with no per-element test
      const int row0 = m0 + c * 64;
      if (kStoreTma) {
        const uint32_t stg = staging + c * kStagingBytes;
        stage_tile<kEpi, kBN>(acc, cb, stg, warp * 16 + g, t4);
        sm90::fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < kBN / 64; ++b) tma_store(&map_y, stg + b * 8192, n0 + 64 * b, row0);
          bulk_commit();
        }
      } else if (m0 + kBM <= m && n0 + kBN <= n) {
        store_tile<kEpi, kBN, false>(acc, cb, ea, row0 + warp * 16 + g, n0, m, n, t4);
      } else {
        store_tile<kEpi, kBN, true>(acc, cb, ea, row0 + warp * 16 + g, n0, m, n, t4);
      }
    }
    if (kStoreTma && tid == 0) bulk_wait_all<false>();  // the last stores are done
  }
}

// ------------------------------- fp32 ---------------------------------- //

constexpr int kFT = 64, kFK = 16;  // 64 x 64 block tiles, k-step 16
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <int kId, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, int m, int n,
                    int k, EpiArgs ea) {
  __shared__ float sa[kFK][kFT + 4];  // transposed: [k][row]
  __shared__ float sb[kFK][kFT + 4];  // [k][col]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kFT * kFK; e += kGemmThreads) {
      const int r = e / kFK, kk = e % kFK;
      sa[kk][r] = m0 + r < m ? x[static_cast<int64_t>(m0 + r) * k + k0 + kk] : 0.f;
      sb[kk][r] = n0 + r < n ? w[static_cast<int64_t>(n0 + r) * k + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        b[i] = sb[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int col = n0 + tx * 4 + j;
      if (col >= n) continue;
      const float2 b = make_float2(epi_bias<kEpi, false>(ea, col),
                                   epi_bias<kEpi, false>(ea, col + 1));
      const float2 ls = make_float2(epi_ls<kEpi>(ea, col), epi_ls<kEpi>(ea, col + 1));
      const float2 r = kEpi == kDenseLsRes ? epi_res_pair(ea, row, col, n) : make_float2(0, 0);
      epi_store<kEpi, false>(ea, static_cast<int64_t>(row) * n + col,
                             epi_pair<kEpi, false>(make_float2(acc[i][j], acc[i][j + 1]), b,
                                                   ls, r));
    }
  }
}

// cuTensorMapEncodeTiled, from the CUDA driver API through the runtime (no -lcuda):
// its signature as cuda.h declares it since CUDA 12.0
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a K-major bf16 (rows, k) operand, read in boxes of 64
// values of k by box_rows rows with the 128-byte swizzle; rows past the end
// read as zeros. Built per call: the map holds the raw pointer. Returns 0 or
// the error.
inline int operand_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(bf16)};
  const cuuint32_t box[2] = {gemm90::kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(r);
}

template <int kId, int kEpi, int kBN>
int launch_gemm_sm90(const void* x, const void* w, int m, int n, int k, const EpiArgs& ea,
                     cudaStream_t stm) {
  CUtensorMap map_x, map_w, map_y{};
  int err = operand_map(&map_x, x, m, k, gemm90::kBM);
  if (!err) err = operand_map(&map_w, w, n, k, kBN);
  if (!err && gemm90::store_tma<kEpi>()) err = operand_map(&map_y, ea.out, m, n, 64);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) || (err = cudaDeviceGetAttribute(
                                          &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  constexpr int kSmem = gemm90::smem_bytes<kEpi, kBN>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      gemm_sm90_kernel<kId, kEpi, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (m + gemm90::kBM - 1) / gemm90::kBM * ((n + kBN - 1) / kBN);
  gemm_sm90_kernel<kId, kEpi, kBN><<<tiles < sms ? tiles : sms, gemm90::kThreads, kSmem, stm>>>(
      map_x, map_w, map_y, m, n, k, ea);
  return static_cast<int>(cudaGetLastError());
}

// Launches y = x W^T with epilogue kEpi on `stream`: x (M, K) and w (N, K)
// contiguous, both bf16 (is_bf16; 16-byte aligned) or both fp32. Returns 0
// once launched, else the error as an int (cudaGetLastError(), or the
// CUDA driver API's error if a tensor map cannot be encoded).
template <int kId, int kEpi>
int launch_gemm(const void* x, const void* w, int m, int n, int k, const EpiArgs& ea,
                int is_bf16, cudaStream_t stm) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 64 || k % 64) return cudaErrorInvalidValue;
  if (is_bf16)
    return n % 256 ? launch_gemm_sm90<kId, kEpi, 128>(x, w, m, n, k, ea, stm)
                   : launch_gemm_sm90<kId, kEpi, 256>(x, w, m, n, k, ea, stm);
  const dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT);
  gemm_f32_kernel<kId, kEpi><<<grid, kGemmThreads, 0, stm>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), m, n, k, ea);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
