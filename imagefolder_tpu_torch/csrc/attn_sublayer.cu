// Fused ViT attention sublayer for Hopper (sm_90a), bound through ctypes:
// kernel #7.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/block.py:
// _attn_sublayer_fused (kernel body _attn_sub_kernel): for a LayerScale
// block with no mask,
//   qkv = round(xn Wq) + round(bq)                       (B, N, 3C), act type
//   o   = per head softmax(q k^T * scale) v / rowsum     (B, N, C), act type
//   out = fp32(res) + ls * (round(o Wp) + round(bp))     (B, N, C), fp32
// with "round" a rounding to the activation type (bf16; nothing in fp32),
// p rounded before p v and o divided by the fp32 row sum after it, as in the
// packed-qkv kernel #1.
//
// What bounds it on this card: at the VQ-4096 decoder's (64, 514, 768) with
// 12 heads, the two projections are 2 * 32896 * 768 * (2304 + 768) = 155
// GFLOP and the attention 4 * 64 * 12 * 514^2 * 64 = 52 GFLOP: 207 GFLOP,
// 0.21 ms at the 989 TFLOP/s bf16 peak, against about 150 MB of compulsory
// traffic (xn, res and the weights in, fp32 out; 0.05 ms at 3.35 TB/s). It
// is bound by operations.
//
// What the design does about it: the TPU kernel kept one image's whole
// (N, 3C) qkv slab in VMEM, 2.4 MB at the decoder's shape, about ten times
// what a Hopper block can hold, so the single launch is not ported. What is
// ported is what the composed path spends outside its products: the bias
// adds, casts, LayerScale multiply and fp32 residual add, each an
// elementwise pass over device memory, here folded into the GEMMs'
// epilogues (gemm_epilogue.cuh). The split is three launches on one
// stream: the qkv GEMM (kDense) writes the packed qkv; #1's forward
// (attention_fwd_tile.cuh: in bf16 the one-pass wgmma kernel of
// attention_fwd_sm90.cuh, instantiated as kernel 7) reads it in place; the
// proj GEMM (kDenseLsRes) writes the fp32 output. qkv and o go through
// device memory once each (at the decoder's shape 152 MB and 51 MB in bf16),
// the price of the split.
//
// The GEMMs (bf16) are gemm_epilogue.cuh's warp-specialised, persistent
// kernel: a TMA producer warpgroup feeds a ring of 128-byte-swizzled
// stages to two consumer warpgroups that run m64n256k16 wgmma products
// with both operands in shared memory, 128 x 256 output tiles (128 x 128
// at ViT-S's widths). The qkv product (116 GFLOP at the decoder's shape)
// is bound by operations, and its bf16 output leaves by TMA stores that
// overlap the next tile's products; the proj product (39 GFLOP) reads the
// fp32 residual and writes the fp32 output (about 250 MB, 0.075 ms at 3.35
// TB/s against 0.039 ms of products) and is bound by bytes, which its
// epilogue moves between the block's tiles. Keeping o on chip is later
// work.

#include "attention_fwd_tile.cuh"
#include "gemm_epilogue.cuh"

// xn (B*N, C) in the act type (bf16 if is_bf16, else fp32); res (B*N, C) bf16
// (res_bf16) or fp32; wq (3Ci, C) and wp (C, Ci) in the act type, PyTorch's
// (out, in) layout; bq (3Ci,) and bp (C,) in the act type; ls (C,) fp32; qkv
// (B*N, 3Ci) and attn (B*N, Ci) act-type scratch; out (B*N, C) fp32. All
// contiguous and 16-byte aligned. Ci, the width of the heads this call
// computes, must be heads * 64; C and Ci multiples of 64. Ci is C but under
// tensor parallelism, where a call computes one rank's heads (the q, k and v
// rows of those heads in wq, their columns of wp) and its partial products
// are summed over the ranks after it (rank 0 alone passing res and bp).
// Launches three kernels on `stream` and returns the first nonzero
// cudaGetLastError() as an int (0 = launched).
extern "C" int attn_sublayer_fwd(const void* xn, const void* res, const void* wq,
                                 const void* bq, const void* wp, const void* bp, const void* ls,
                                 void* qkv, void* attn, void* out, int batch, int n, int c,
                                 int ci, int heads, float scale, int is_bf16, int res_bf16,
                                 void* stream) {
  if (ci != heads * kHd || batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const int m = batch * n;
  const EpiArgs e_qkv{bq, nullptr, nullptr, qkv, 0};
  int err = launch_gemm<7, kDense>(xn, wq, m, 3 * ci, c, e_qkv, is_bf16, stm);
  if (err) return err;
  const int64_t row = 3 * static_cast<int64_t>(ci);
  const int64_t bat = n * row;
  const FwdStrides st{bat, row, kHd, bat, row, kHd, bat, row, kHd, 0, 0, 0};
  const size_t esz = is_bf16 ? sizeof(bf16) : sizeof(float);
  const char* in = static_cast<const char*>(qkv);
  err = launch_attention_fwd<7>(in, in + ci * esz, in + 2 * ci * esz, nullptr, nullptr, attn,
                                batch, n, n, heads, st, scale, is_bf16, stm);
  if (err) return err;
  const EpiArgs e_proj{bp, res, static_cast<const float*>(ls), out, res_bf16};
  return launch_gemm<7, kDenseLsRes>(attn, wp, m, c, ci, e_proj, is_bf16, stm);
}
