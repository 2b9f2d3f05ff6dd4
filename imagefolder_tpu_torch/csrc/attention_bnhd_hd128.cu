// #3's forward (attention_bnhd.cu) at head dims 72-128, on the kD = 128
// instantiations, in a source of their own so that they compile beside the
// kD = 48 and 64 ones. RAR-XL (1280 / 16 = 80) and RAR-XXL (1408 / 16 = 88)
// reach these widths through the generator CLIs' --hidden and --heads.
//
// A first version, right before fast: in bf16 the two-pass wgmma kernel of
// attention_fwd_sm90.cuh holds a 128-wide head as two 64-wide swizzled
// tiles side by side (S = Q K^T over 8 K-steps, O as two 64 x 64
// accumulators), one block of two warpgroups an SM; widths 72-120 run the
// 128 code over zero-filled columns. fp32 takes the FMA kernel of
// attention_bnhd_fwd.cuh at kD = 128. What bounds it: at RAR-XL's training
// forward, (64, 258, 16, 80) bf16 under the causal mask, 4 hd operations per
// allowed (q, k) pair make 11 GFLOP (0.011 ms at 989 TFLOP/s) against 169
// MB of q, k, v and o (0.050 ms at 3.35 TB/s): memory, as at 48 and 64. The
// padded columns and the second pass over the keys add tensor-core work
// that the bound does not count.

#include "attention_bnhd_fwd.cuh"

// attention_bnhd_fwd's launch for 72 <= hd <= 128, after its checks, with
// the entry's own arguments.
int attention_bnhd_fwd_hd128(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* bs, float scale, int is_bf16, int hd,
                             cudaStream_t stm) {
  const Strides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                   bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0, hd};
  return launch_bnhd_fwd<128>(q, k, v, static_cast<const float*>(bias), out, lse, batch, lq, lk,
                              heads, st, scale, is_bf16, stm);
}
