// The backward #5 (attention_qblk_bwd.cu) at head dims 520-1024 on the
// kD = 1024 FMA kernels A and B of attention_wide.cuh, and past 1024 on its
// segmented kernels, in a source of its own. Every call at
// these widths, bf16 without dbias included, takes them: they recompute
// the row statistics and need neither the forward's o nor its lse.

#include "attention_wide.cuh"

// attention_qblk_bwd's launch for 520 <= hd (past 1024 segmented), after its checks, with
// the entry's own arguments (stats: its work scratch, 3 * B * H * L fp32).
int attention_qblk_bwd_hd1024(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias,
                             void* stats, int batch, int n, int heads, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, const int64_t* gs,
                             int64_t bias_row_stride, float scale, int is_bf16, int hd,
                             cudaStream_t stm) {
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  return (hd > 1024 ? wide::launch_bwd_seg<5> : wide::launch_bwd<5, 1024>)(q, k, v, g, bias, dq, dk, dv, dbias, stats, batch, n, heads, st,
                             scale, is_bf16, stm);
}
