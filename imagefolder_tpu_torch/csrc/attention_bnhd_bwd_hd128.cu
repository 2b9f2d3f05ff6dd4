// The BNHD backward #6 (attention_bnhd_bwd.cu) at head dims 72-128, on the
// kD = 128 instantiations, in a source of its own so that they compile
// beside the kD = 48 and 64 ones (and beside #5's, attention_qblk_bwd_hd128.cu).
//
// bf16 without dbias, L > 1: the wgmma backward of attention_bwd_sm90.cuh
// at kD = 128 (attn_bwd_wide_kernel and attn_bwd_dq_wide_kernel), on the
// forward's saved o and lse, skipping the tiles that the causal mask
// blanks. Its kD = 64 kernels hold k and v as register A operands; at 64
// keys by a 128-wide head that and the dK, dV, S^T and dP^T accumulators
// come to about 256 registers a thread, past the 255 a thread may have. So
// at kD = 128 every operand of the score products stays in shared memory
// (wgmma reads both there), and the gradient products' second 64-wide half
// runs at the head's width past 64 (n16 at 80, n24 at 88): one
// instantiation per such width, 8 to 64. fp32, a call that asks for dbias,
// and L = 1 keep the two-kernel design on mma.sync with 128-wide shared
// tiles (attention_bwd_tile.cuh), which recomputes the row statistics; its
// kernel B spills (chip_smoke.py's build phase prints ptxas's report).
// What bounds it: at RAR-XL's training backward, (64, 258, 16, 80) bf16
// under the causal mask, five products of 2 hd operations per allowed
// (q, k) pair make 27 GFLOP (0.028 ms at 989 TFLOP/s) against 296 MB of q,
// k, v, g, dq, dk and dv (0.088 ms at 3.35 TB/s): memory.

#include "attention_bwd_sm90.cuh"

// attention_bnhd_bwd's launch for 72 <= hd <= 128, after its checks, with
// the entry's own arguments (tile: the two-kernel design).
int attention_bnhd_bwd_hd128(bool tile, const void* q, const void* k, const void* v,
                             const void* g, const void* o, const int64_t* os, const void* lse,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias,
                             void* work, void* blank, int batch, int n, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* gs, int64_t bias_row_stride, float scale,
                             int is_bf16, int hd, cudaStream_t stm) {
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  return launch_bnhd_bwd<6, 128>(tile, q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work,
                                 blank, batch, n, heads, st, scale, is_bf16, stm);
}
