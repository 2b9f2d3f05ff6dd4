// Packed-qkv attention backward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _attention_qkv_bwd_impl (kernel bodies _qkv_bwd_kernel and
// _qkv_bias_bwd_kernel, math _bwd_head_math): the gradient of attention_qkv
// (attention_qkv.cu) for the ViT blocks of tokenizer training. The input is
// the (B, N, 3C) output of the fused qkv projection, read as its
// (B, N, 3, H, 64) view: head h's q, k and v at columns h*64, C + h*64 and
// 2C + h*64 of each row, read in place (row stride 3C, batch stride N*3C);
// the output gradient g is (B, N, C), head h at columns h*64. The result is
// dqkv in the same packed (B, N, 3C) layout, each of dq, dk and dv written
// straight to its columns (no concatenation afterwards, no contiguous q/k/v
// copies before), in qkv's type; with a shared fp32 (N, N) bias, dbias is
// the sum of ds over batches and heads, added by fp32 atomics into a zeroed
// buffer, only when asked for.
//
// What bounds it on this card: the flagship GAN step calls it at
// (64, 499, 2304) (encoder), (64, 379, 2304) (decoder) and (64, 197, 1152)
// (DinoDisc trunk) bf16 with no bias. At the encoder's shape each call must
// read qkv and g and write dqkv: 343 MB, 0.102 ms at 3.35 TB/s, against five
// products of 2*N*N*64 per (b, h) over 768 heads, 122 GFLOP, 0.124 ms at
// 989 TFLOP/s: it is bound by operations. The per-head math and the
// two-kernel design (no score ever in device memory) are the BNHD
// backward's, shared through attention_bwd_tile.cuh: only the strides differ.

#include "attention_bwd_tile.cuh"

// qkv (B, N, 3C) and g (B, N, C), contiguous, both fp32 or both bf16
// (is_bf16), C = heads * 64; bias null or an fp32 (N, N) shared by every
// batch and head, row stride bias_row_stride (column stride 1); dqkv a
// (B, N, 3C) of qkv's type; dbias null (not wanted) or a zeroed fp32 (N, N)
// that receives the sum of ds; stats an fp32 scratch of 3 * B * heads * N.
// Launches kernel A then kernel B on `stream` and returns cudaGetLastError()
// as an int (0 = both launched).
extern "C" int attention_qkv_bwd(const void* qkv, const void* g, const void* bias, void* dqkv,
                                 void* dbias, void* stats, int batch, int n, int c, int heads,
                                 int64_t bias_row_stride, float scale, int is_bf16,
                                 void* stream) {
  if (c != heads * kHd) return cudaErrorInvalidValue;
  const int64_t row = 3 * static_cast<int64_t>(c);  // qkv's and dqkv's row stride
  const int64_t bat = n * row;
  const int64_t gb = static_cast<int64_t>(n) * c;
  const BwdStrides st{bat, row, kHd, bat, row, kHd, bat, row, kHd, gb, c, kHd,
                      bat, row, kHd, bias ? bias_row_stride : 0};
  const size_t esz = is_bf16 ? sizeof(bf16) : sizeof(float);
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  return launch_attention_bwd<2>(in, in + c * esz, in + 2 * c * esz, g, bias, out,
                              out + c * esz, out + 2 * c * esz, dbias, stats, batch, n, heads,
                              st, scale, is_bf16, static_cast<cudaStream_t>(stream));
}
