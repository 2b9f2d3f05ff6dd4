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
// so that sequential axis becomes a loop inside a block: the per-head math
// (_bwd_head_math, with its casts) and the two-kernel design are those of
// attention_bwd_tile.cuh, shared with kernels #2 and #6. Kernel A, per 64 q
// rows, gets m, l, delta = rowsum(p dp) and dq; kernel B, per 64 k rows,
// loops over every q tile of the sequence and keeps dk and dv in fp32
// registers until its one cast and store, which is #5's contract. dbias
// goes by fp32 atomics from kernel A. The entry takes #6's arguments but
// instantiates the shared kernels as #5 (kId), so that its launches and its
// device time are counted apart from #6's. No score, probability or ds reaches
// device memory at any length, so the JAX package's caps (L <= 2304 with a
// bias, 2816 without) do not apply; every offset is 64-bit.
//
// What bounds it on this card: VAR-d16's 512 px training step calls it 16
// times at (16, 2240, 16, 64) bf16 under the block-causal bias, with no
// dbias (the bias is a constant). A call needs five products of 2*hd
// operations per (b, h) and per (q, k) pair the mask allows, 536 GFLOP over
// 65% of the L^2 pairs (0.542 ms at 989 TFLOP/s), on 534 MB of compulsory
// traffic (q, k, v, g in; dq, dk, dv out; the bias: 0.159 ms at 3.35 TB/s):
// bound by operations. The products run on mma.sync from registers and
// shared memory; kernel A recomputes the scores three times, and the
// mask's blank tiles are not skipped. Both are later work, with wgmma.

#include "attention_bwd_tile.cuh"

// q, k, v and g (B, L, H, 64), each with its own batch, row and head strides
// in elements (qs, ks, vs, gs = {batch, row, head}; the head-dim stride is
// 1), all fp32 or all bf16 (is_bf16); bias null or an fp32 (L, L) shared by
// every batch and head, row stride bias_row_stride (column stride 1); dq, dk
// and dv contiguous (B, L, H, 64) of the inputs' type; dbias null (not
// wanted) or a zeroed fp32 (L, L) that receives the sum of ds; stats an fp32
// scratch of 3 * B * H * L. Launches kernel A then kernel B on `stream` and
// returns cudaGetLastError() as an int (0 = both launched).
extern "C" int attention_qblk_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* bias, void* dq, void* dk,
                                  void* dv, void* dbias, void* stats, int batch, int n,
                                  int heads, const int64_t* qs, const int64_t* ks,
                                  const int64_t* vs, const int64_t* gs,
                                  int64_t bias_row_stride, float scale, int is_bf16,
                                  void* stream) {
  const int64_t ol = static_cast<int64_t>(heads) * kHd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, kHd, bias ? bias_row_stride : 0};
  return launch_attention_bwd<5>(q, k, v, g, bias, dq, dk, dv, dbias, stats, batch, n, heads,
                              st, scale, is_bf16, static_cast<cudaStream_t>(stream));
}
