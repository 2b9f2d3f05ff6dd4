// #3's forward (attention_bnhd.cu) at head dims 136-256, on the kD = 256
// FMA kernel of attention_wide.cuh (its design, and why not wgmma, are
// described there), in a source of its own so that it compiles beside the
// kD = 48, 64 and 128 ones. p is divided by its row sum before its
// rounding to the inputs' type, as the Pallas kernel does.

#include "attention_wide.cuh"

// attention_bnhd_fwd's launch for 136 <= hd <= 256, after its checks, with
// the entry's own arguments.
int attention_bnhd_fwd_hd256(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* bs, float scale, int is_bf16, int hd,
                             cudaStream_t stm) {
  const sm90::FwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                            bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0, hd};
  return wide::launch_fwd<3>(q, k, v, bias, out, static_cast<float*>(lse), batch, lq, lk, heads,
                             st, scale, is_bf16, stm);
}
