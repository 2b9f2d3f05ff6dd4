// Q-blocked BNHD attention backward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _fused_attention_qblk_bwd (kernel body _qblk_bwd_kernel_impl, custom VJP
// _fused_attention_qblk_diff): the gradient of the q-blocked forward
// (attention_qblk.cu) for self-attention past the single-block budget, q, k,
// v and the output gradient g all (B, L, H, hd) strided views (batch, row
// and head strides; hd stride 1), with no bias or one fp32 (L, L) bias
// shared by every batch and head, which may hold -inf. dq, dk and dv are
// written contiguous (B, L, H, hd) in the inputs' type; dbias, when asked
// for, is the fp32 sum of ds over batches, heads and q tiles.
//
// The TPU kernel walked the q blocks of one (b, h) in grid order, added
// each block's dk and dv into fp32 outputs that stayed resident across the
// sequential q-block axis, and cast them at the end (attention.py:615-617,
// 649-650); dbias accumulated over the whole grid. A CUDA grid has no order,
// so that sequential axis becomes a loop inside a block. In bf16 the device
// code is attention_bwd_sm90.cuh, shared with kernel #2: FlashAttention-2's
// backward on wgmma, one warpgroup per 64 keys of one (b, h) that walks the
// q tiles the mask leaves and keeps dk and dv in fp32 registers until its
// one cast and store, which is #5's contract, and one per 64 q rows that
// walks the key tiles the mask leaves for dq; p comes from the forward's
// saved lse and delta = rowsum(o g) from its saved o. fp32, and a call that asks for
// dbias, keep the two-kernel design of attention_bwd_tile.cuh, shared with
// #6 (see attention_bwd_sm90.cuh for why dbias stays there); dbias goes by
// fp32 atomics. The instantiations carry #5's number (kId), so that its device
// time is counted apart from #2's and #6's. No score, probability or ds
// reaches device memory at any length, so the JAX package's caps (L <= 2304
// with a bias, 2816 without) do not apply; every offset is 64-bit.
//
// What bounds it on this card: VAR-d16's 512 px training step calls it 16
// times at (16, 2240, 16, 64) bf16 under the block-causal bias, with no
// dbias (the bias is a constant). A call needs five products of 2*hd
// operations per (b, h) and per (q, k) pair the mask allows, 536 GFLOP over
// 65% of the L^2 pairs (0.542 ms at 989 TFLOP/s), on 534 MB of compulsory
// traffic (q, k, v, g in; dq, dk, dv out; the bias: 0.159 ms at 3.35 TB/s):
// bound by operations. The design runs the products on the tensor cores
// (wgmma), over the 64 x 64 tiles the blank-tile map leaves (66% of them at
// this shape): seven per pair, S and dP twice (once for dk and dv, once for
// dq), which costs less than adding each key block's dq into a shared fp32
// buffer did (attention_bwd_sm90.cuh).

#include "attention_bwd_sm90.cuh"

// hd 72-128: the kD = 128 instantiations, compiled apart (attention_qblk_bwd_hd128.cu)
int attention_qblk_bwd_hd128(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias, void* stats,
                             int batch, int n, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, const int64_t* gs, int64_t bias_row_stride,
                             float scale, int is_bf16, int hd, cudaStream_t stm);
// hd 136-256: the kD = 256 kernels of attention_wide.cuh (attention_qblk_bwd_hd256.cu)
int attention_qblk_bwd_hd256(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias, void* stats,
                             int batch, int n, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, const int64_t* gs, int64_t bias_row_stride,
                             float scale, int is_bf16, int hd, cudaStream_t stm);

namespace {

template <int kD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* o,
               const int64_t* os, const void* lse, const void* bias, void* dq, void* dk,
               void* dv, void* dbias, void* work, void* blank, int batch, int n, int heads,
               const BwdStrides& st, float scale, int is_bf16, cudaStream_t stm) {
  if (!is_bf16 || dbias)
    return launch_attention_bwd<5, kD>(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n,
                                       heads, st, scale, is_bf16, stm);
  return sm90::launch_attention_bwd_sm90<5, kD>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), sm90::OStrides{os[0], os[1], os[2]},
      static_cast<const float*>(lse), static_cast<const float*>(bias), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(work),
      static_cast<uint8_t*>(blank), batch, n, heads, st, scale, stm);
}

}  // namespace

// q, k, v and g (B, L, H, hd), hd a multiple of 8 up to 256 (run under the
// kD = 48 kernels up to 48, 64 at 56 and 64, 128 at 72-128 and 256 past
// 128: past 64 every call, bf16 too, takes a two-kernel design, that of
// attention_bwd_tile.cuh up to 128 and that of attention_wide.cuh past it,
// and o, lse and blank go unused, work being its 3 * B * H * L scratch), each
// with its own batch, row and
// head strides in elements (qs, ks, vs, gs = {batch, row, head}; the head-dim
// stride is 1), all fp32 or all bf16 (is_bf16); bias null or an fp32 (L, L)
// shared by every batch and head, row stride bias_row_stride (column stride
// 1); dq, dk and dv contiguous (B, L, H, hd) of the inputs' type; dbias null
// (not wanted) or a zeroed fp32 (L, L) that receives the sum of ds. bf16
// without dbias: o the forward's output at strides os, lse its fp32 (B, H, L)
// log-sum-exp, work an fp32 scratch of sm90::work_floats(B, L, H), blank a
// scratch of two bytes per tile pair (2 * ceil(L/64)^2) when a bias is given;
// prep, main and dq kernels. fp32, or dbias wanted: o, lse and blank unused,
// work an fp32 scratch of 3 * B * H * L; kernels A and B of
// attention_bwd_tile.cuh. Launches on `stream` and returns cudaGetLastError()
// as an int (0 = all launched; cudaErrorInvalidValue for another head dim).
extern "C" int attention_qblk_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* o, const void* lse,
                                  const void* bias, void* dq, void* dk, void* dv, void* dbias,
                                  void* work, void* blank, int batch, int n, int heads,
                                  const int64_t* qs, const int64_t* ks, const int64_t* vs,
                                  const int64_t* gs, const int64_t* os,
                                  int64_t bias_row_stride, float scale, int is_bf16, int hd,
                                  void* stream) {
  if (hd < 8 || hd > 256 || hd % 8) return cudaErrorInvalidValue;
  if (hd > 128)
    return attention_qblk_bwd_hd256(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n, heads,
                                    qs, ks, vs, gs, bias_row_stride, scale, is_bf16, hd,
                                    static_cast<cudaStream_t>(stream));
  if (hd > 64)
    return attention_qblk_bwd_hd128(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n, heads,
                                    qs, ks, vs, gs, bias_row_stride, scale, is_bf16, hd,
                                    static_cast<cudaStream_t>(stream));
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  return hd <= 48 ? launch_bwd<48>(q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work, blank,
                                   batch, n, heads, st, scale, is_bf16, stm)
                  : launch_bwd<64>(q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work, blank,
                                   batch, n, heads, st, scale, is_bf16, stm);
}

// The blank-tile map of an fp32 (n, n) bias of row stride bias_row_stride
// (column stride 1) into the first ceil(n/64)^2 of blank's 2 * ceil(n/64)^2
// bytes (the map of all-zero tiles follows it): the backward's pre-pass
// alone (as #5's), for the checks. Returns cudaGetLastError() as an int.
extern "C" int attention_blank_tile_map(const void* bias, void* blank, int n,
                                        int64_t bias_row_stride, void* stream) {
  return sm90::launch_blank_tile_map<5>(static_cast<const float*>(bias),
                                        static_cast<uint8_t*>(blank), n, bias_row_stride,
                                        static_cast<cudaStream_t>(stream));
}
