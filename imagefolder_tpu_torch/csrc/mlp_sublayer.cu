// Fused ViT MLP sublayer (kernel #8) and the fused MLP probe (kernel #10)
// for Hopper (sm_90a), bound through ctypes.
//
// #8 replaces the TPU kernel imagefolder_tpu/ops/pallas/block.py:
// _mlp_sublayer_fused (kernel body _mlp_sub_kernel): for a LayerScale block,
//   h   = round(gelu(round(xn W1) + round(b1)))           erf in fp32
//   out = fp32(res) + ls * (round(h W2) + round(b2))      fp32
// #10 replaces scripts/perf.py: fused_mlp (kernel body _mlp_kernel, the MLP
// ablation probe), where the biases are added to the fp32 accumulators and
// GELU runs before the cast, with no residual and no LayerScale:
//   h = round(gelu(x W1 + b1))     o = round(h W2 + b2)
// "round" is a rounding to the activation type (bf16; nothing in fp32).
//
// What bounds them on this card: at the VQ-4096 decoder's (64, 514, 768)
// with hidden 3072 (#8), and at the probe's (32832, 768) with hidden 3072
// (#10), the two products are 4 * M * 768 * 3072, about 310 GFLOP: 0.31 ms at
// the 989 TFLOP/s bf16 peak, against under 0.1 ms of compulsory traffic at
// 3.35 TB/s. Both are bound by operations.
//
// What the design does about it: the TPU kernels kept a whole 512- or
// 1024-row block of h = (rows, 3072) in VMEM; a 64-row bf16 h tile alone is
// 384 KB, more than a Hopper block's 227 KB of shared memory, so the single
// launch is not ported. What is ported is what the composed path spends
// outside its products: the bias adds, casts, GELU, LayerScale multiply and
// fp32 residual add (about seven elementwise passes over device memory),
// here folded into the epilogues of two GEMMs (gemm_epilogue.cuh): fc1 with
// kDenseGelu (#10: kBias32Gelu) writes h in the act type, fc2 with
// kDenseLsRes (#10: kBias32) reads it. h goes through device memory once
// (202 MB at the decoder's shape, written and read), the price of the
// split; streaming the hidden dimension through shared memory so that h
// stays on chip is a later redesign.
//
// The GEMMs (bf16) are gemm_epilogue.cuh's warp-specialised, persistent
// kernel: a TMA producer warpgroup feeds a ring of 128-byte-swizzled
// stages to two consumer warpgroups that run m64n256k16 wgmma products
// with both operands in shared memory, 128 x 256 output tiles (128 x 128
// at ViT-S's widths). Both products are bound by operations (155 GFLOP
// each at the decoder's shape); h leaves fc1 by TMA stores that overlap
// the next tile's products, but fc1's 101 M erf-GELUs and fc2's fp32
// residual read and output write run between a block's tiles, while its
// tensor cores wait.

#include "gemm_epilogue.cuh"

// #8. xn (M, C) in the act type (bf16 if is_bf16, else fp32); res (M, C) bf16
// (res_bf16) or fp32; w1 (H, C) and w2 (C, H) in the act type, PyTorch's
// (out, in) layout; b1 (H,) and b2 (C,) in the act type; ls (C,) fp32; h
// (M, H) act-type scratch; out (M, C) fp32. All contiguous and 16-byte
// aligned; C and H multiples of 64. Launches two kernels on `stream` and
// returns the first nonzero cudaGetLastError() as an int (0 = launched).
extern "C" int mlp_sublayer_fwd(const void* xn, const void* res, const void* w1,
                                const void* b1, const void* w2, const void* b2, const void* ls,
                                void* h, void* out, int m, int c, int hidden, int is_bf16,
                                int res_bf16, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const EpiArgs e1{b1, nullptr, nullptr, h, 0};
  const int err = launch_gemm<8, kDenseGelu>(xn, w1, m, hidden, c, e1, is_bf16, stm);
  if (err) return err;
  const EpiArgs e2{b2, res, static_cast<const float*>(ls), out, res_bf16};
  return launch_gemm<8, kDenseLsRes>(h, w2, m, c, hidden, e2, is_bf16, stm);
}

// #10. x (M, D) and w1 (H, D), w2 (D, H) in the act type; b1 (H,) and b2 (D,)
// fp32; h (M, H) act-type scratch; out (M, D) in the act type. All contiguous
// and 16-byte aligned; D and H multiples of 64. Launches two kernels on
// `stream` and returns the first nonzero cudaGetLastError() as an int.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* h, void* out, int m, int d, int hidden,
                             int is_bf16, void* stream) {
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const EpiArgs e1{b1, nullptr, nullptr, h, 0};
  const int err = launch_gemm<10, kBias32Gelu>(x, w1, m, hidden, d, e1, is_bf16, stm);
  if (err) return err;
  const EpiArgs e2{b2, nullptr, nullptr, out, 0};
  return launch_gemm<10, kBias32>(h, w2, m, d, hidden, e2, is_bf16, stm);
}
