// BNHD attention backward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _fused_attention_bwd_impl (kernel bodies _bnhd_bwd_kernel and
// _bnhd_bias_bwd_kernel, math _bwd_head_math): the gradient of
// fused_attention for self-attention, q, k, v and the output gradient g all
// (B, L, H, hd), with no bias or one fp32 (L, L) bias shared by every batch
// and head, which may hold -inf. q, k, v and g are strided views (batch, row
// and head strides; hd stride 1); dq, dk and dv are written contiguous
// (B, L, H, hd) in the inputs' type. The per-head math and the two-kernel
// design are in attention_bwd_tile.cuh, shared with the packed-qkv backward
// (attention_qkv_bwd.cu).
//
// What bounds it on this card: VAR-d16's training step calls it 16 times at
// (64, 286, 16, 64) bf16 under the block-causal bias. Each call must read
// q, k, v, g and write dq, dk, dv: 262 MB, 78 us at 3.35 TB/s, against 34
// GFLOP of products over the 51,445 allowed (q, k) pairs per (b, h), 34 us at
// 989 TFLOP/s. So it is bound by memory, as the forward is. VAR's bias is a
// constant, so its training step never asks for dbias.

#include "attention_bwd_tile.cuh"

// q, k, v and g (B, L, H, 64), each with its own batch, row and head strides in
// elements (qs, ks, vs, gs = {batch, row, head}; the head-dim stride is 1),
// all fp32 or all bf16 (is_bf16); bias null or an fp32 (L, L) shared by every
// batch and head, row stride bias_row_stride (column stride 1); dq, dk and dv
// contiguous (B, L, H, 64) of the inputs' type; dbias null (not wanted) or a
// zeroed fp32 (L, L) that receives the sum of ds; stats an fp32 scratch of
// 3 * B * H * L. Launches kernel A then kernel B on `stream` and returns
// cudaGetLastError() as an int (0 = both launched).
extern "C" int attention_bnhd_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* bias, void* dq, void* dk,
                                  void* dv, void* dbias, void* stats, int batch, int n,
                                  int heads, const int64_t* qs, const int64_t* ks,
                                  const int64_t* vs, const int64_t* gs,
                                  int64_t bias_row_stride, float scale, int is_bf16,
                                  void* stream) {
  const int64_t ol = static_cast<int64_t>(heads) * kHd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, kHd, bias ? bias_row_stride : 0};
  return launch_attention_bwd<6>(q, k, v, g, bias, dq, dk, dv, dbias, stats, batch, n, heads,
                              st, scale, is_bf16, static_cast<cudaStream_t>(stream));
}
