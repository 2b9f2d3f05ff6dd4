// Packed-qkv attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _attention_qkv_fwd_impl (kernel body _qkv_kernel_impl): per (batch, head),
// softmax(q k^T * scale + bias) v, with q, k and v read straight from the
// (B, N, 3C) output of the fused qkv projection (head h at columns h*hd,
// C + h*hd and 2C + h*hd) and the result written as (B, N, C), head h at
// columns h*hd. The optional bias is fp32 (N, N), shared by batches and heads,
// and may hold -inf.
//
// What bounds it on this card: at the tokenizer's N = 513/514 and hd = 64 a
// (b, h) pair does 4*N*N*hd = 67.6 MFLOP on 263 KB of compulsory bf16
// traffic (q, k, v in, o out), about 257 FLOP per byte: near the H100's
// bf16 ridge (989 TFLOP/s over 3.35 TB/s, ~295); the k/v tiles are read
// again by every block of q rows (from L2), so it is bound by operations:
// the two products q k^T, p v and, at head dim 64, the softmax's
// exponentials beside them.
//
// What the design does about it: the TPU kernel kept one whole (Np, Np) fp32
// score tile per head in VMEM; a Hopper block has no room for that. In bf16
// the one-pass wgmma kernel of attention_fwd_sm90.cuh (shared with the
// q-blocked forward attention_qblk.cu and #7) streams 64-row k/v tiles
// through a cp.async ring past 128 q rows held in registers by two
// warpgroups, with an online softmax; this file gives it the packed
// layout's strides: row stride 3C, batch stride N*3C, q, k and v at column
// offsets 0, C and 2C. A mask is computed tile by tile (no blank-tile map:
// the encoder's mask blanks few tiles, and no main path gives #1 a mask).
//
// bf16 numerics follow the TPU kernel: fp32 scores and softmax, p rounded to
// bf16 before p v, the row sum taken on the fp32 p, o / l at the end.
// fp32 inputs (the ModelArgs default dtype) take a plain FMA kernel with the
// same online softmax (attention_fwd_tile.cuh), exact to fp32 rounding.

#include "attention_fwd_tile.cuh"

// qkv (B, N, 3C) and out (B, N, C), contiguous, fp32 or bf16 (is_bf16);
// bias null or fp32 (N, N) contiguous; lse null, or an fp32 (B, heads, N)
// that receives each row's log-sum-exp for the backward (#2). C must be
// heads * 64; bf16 needs qkv on a 16-byte boundary. Launches on `stream`
// and returns cudaGetLastError() as an int (0 = launched).
extern "C" int attention_qkv_fwd(const void* qkv, const void* bias, void* out, void* lse,
                                 int batch, int n, int c, int heads,
                                 float scale, int is_bf16, void* stream) {
  if (c != heads * kHd) return cudaErrorInvalidValue;
  const int64_t row = 3 * static_cast<int64_t>(c);
  const int64_t bat = n * row;
  const FwdStrides st{bat, row, kHd, bat, row, kHd, bat, row, kHd, 0, 0, bias ? n : 0};
  const size_t esz = is_bf16 ? sizeof(bf16) : sizeof(float);
  const char* in = static_cast<const char*>(qkv);
  return launch_attention_fwd<1>(in, in + c * esz, in + 2 * c * esz, bias, nullptr, out, batch,
                                 n, n, heads, st, scale, is_bf16,
                                 static_cast<cudaStream_t>(stream), static_cast<float*>(lse));
}
