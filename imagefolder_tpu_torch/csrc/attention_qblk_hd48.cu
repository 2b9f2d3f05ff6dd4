// #4's forward (attention_qblk.cu) at head dims up to 48, on the kD = 48
// instantiations, in a source of its own so that they compile beside the
// kD = 64 ones: each width's one-pass wgmma and fp32 instantiations take
// nvcc about a minute, and with both widths attention_qblk.cu was the
// build's longest source.

#include "attention_fwd_tile.cuh"

// attention_qblk_fwd's launch for hd <= 48, after its checks and the blank
// map's pre-pass, with the entry's own arguments (map the pre-pass's map or
// null).
int attention_qblk_fwd_hd48(const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* map, void* out, float* lse, int batch, int lq,
                            int lk, int heads, const int64_t* qs, const int64_t* ks,
                            const int64_t* vs, int64_t bias_row_stride, float scale,
                            int is_bf16, int hd, cudaStream_t stm) {
  const FwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      0, 0, bias ? bias_row_stride : 0, hd};
  return launch_attention_fwd<4, 48>(q, k, v, bias, map, out, batch, lq, lk, heads, st, scale,
                                     is_bf16, stm, lse);
}
