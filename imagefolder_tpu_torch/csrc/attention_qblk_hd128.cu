// #4's forward (attention_qblk.cu) at head dims 72-128, on the kD = 128
// instantiations, in a source of their own so that they compile beside the
// kD = 48 and 64 ones. A first version, right before fast: in bf16 the
// one-pass wgmma kernel of attention_fwd_sm90.cuh holds a 128-wide head as
// two 64-wide swizzled tiles side by side (8 K-steps for S, O as two
// 64 x 64 accumulators), one block of two warpgroups an SM, and skips the
// tiles of the blank-tile map as at 64; widths 72-120 run the 128 code over
// zero-filled columns. fp32 takes the FMA kernel of attention_fwd_tile.cuh
// at kD = 128, whose q and o registers ptxas partly spills.

#include "attention_fwd_tile.cuh"

// attention_qblk_fwd's launch for 72 <= hd <= 128, after its checks and the
// blank map's pre-pass, with the entry's own arguments (map the pre-pass's
// map or null).
int attention_qblk_fwd_hd128(const void* q, const void* k, const void* v, const void* bias,
                             const uint8_t* map, void* out, float* lse, int batch, int lq,
                             int lk, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, int64_t bias_row_stride, float scale,
                             int is_bf16, int hd, cudaStream_t stm) {
  const FwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      0, 0, bias ? bias_row_stride : 0, hd};
  return launch_attention_fwd<4, 128>(q, k, v, bias, map, out, batch, lq, lk, heads, st, scale,
                                      is_bf16, stm, lse);
}
