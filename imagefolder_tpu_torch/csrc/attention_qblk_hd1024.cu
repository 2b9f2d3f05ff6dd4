// #4's forward (attention_qblk.cu) at head dims 520-1024 on the kD = 1024
// FMA kernel of attention_wide.cuh, and past 1024 on its segmented kernel,
// in a source of its own. o is divided by
// the row sum after p v, as the q-blocked TPU kernel does; the blank-tile
// map goes unused (every tile is computed, as a first version).

#include "attention_wide.cuh"

// attention_qblk_fwd's launch for 520 <= hd (past 1024 segmented), after its checks, with
// the entry's own arguments.
int attention_qblk_fwd_hd1024(const void* q, const void* k, const void* v, const void* bias,
                             void* out, float* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             int64_t bias_row_stride, float scale, int is_bf16, int hd,
                             cudaStream_t stm) {
  const sm90::FwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                            0, 0, bias ? bias_row_stride : 0, hd};
  return (hd > 1024 ? wide::launch_fwd_seg<4> : wide::launch_fwd<4, 1024>)(q, k, v, bias, out, lse, batch, lq, lk, heads, st, scale, is_bf16,
                             stm);
}
