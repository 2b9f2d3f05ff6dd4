// The q-blocked backward #5 (attention_qblk_bwd.cu) at head dims 72-128, on
// the kD = 128 instantiations, in a source of its own: the design and its
// reasons are #6's (attention_bnhd_bwd_hd128.cu). bf16 without dbias runs
// the wgmma backward of attention_bwd_sm90.cuh at kD = 128; fp32 and a call
// that asks for dbias keep the two-kernel design of attention_bwd_tile.cuh.
// Neither needs a cap on L past the single-block budget (L * L > 2^22).

#include "attention_bwd_sm90.cuh"

// attention_qblk_bwd's launch for 72 <= hd <= 128, after its checks, with
// the entry's own arguments (tile: the two-kernel design).
int attention_qblk_bwd_hd128(bool tile, const void* q, const void* k, const void* v,
                             const void* g, const void* o, const int64_t* os, const void* lse,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias,
                             void* work, void* blank, int batch, int n, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* gs, int64_t bias_row_stride, float scale,
                             int is_bf16, int hd, cudaStream_t stm) {
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  return launch_bnhd_bwd<5, 128>(tile, q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work,
                                 blank, batch, n, heads, st, scale, is_bf16, stm);
}
