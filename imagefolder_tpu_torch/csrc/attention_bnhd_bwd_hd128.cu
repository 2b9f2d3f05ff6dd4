// The BNHD backward #6 (attention_bnhd_bwd.cu) at head dims 72-128, on the
// kD = 128 instantiations of attention_bwd_tile.cuh, in a source of its own
// so that they compile beside the kD = 48 and 64 ones (and beside #5's,
// attention_qblk_bwd_hd128.cu: the spilling kernels take ptxas long).
//
// A first version, right before fast. The wgmma backward of
// attention_bwd_sm90.cuh holds, per thread, k and v as register A operands
// and the dK, dV, S^T and dP^T accumulators: at 64 keys by a 128-wide head
// that is about 256 registers, past the 255 a thread may have. So every
// call at these widths, bf16 without dbias included, takes the two-kernel
// design on mma.sync with 128-wide shared tiles (kernel A: dq and the row
// statistics; kernel B: dk and dv), which recomputes the row statistics
// and needs neither the forward's o nor its lse; its ptxas report (kernel
// B's registers and spills) is printed by chip_smoke.py's build phase.
// What bounds it: at RAR-XL's training backward, (64, 258, 16, 80) bf16
// under the causal mask, five products of 2 hd operations per allowed
// (q, k) pair make 27 GFLOP (0.028 ms at 989 TFLOP/s) against 296 MB of q,
// k, v, g, dq, dk and dv (0.088 ms at 3.35 TB/s): memory.

#include "attention_bwd_tile.cuh"

// attention_bnhd_bwd's launch for 72 <= hd <= 128, after its checks, with
// the entry's own arguments (stats: its work scratch, 3 * B * H * L fp32).
int attention_bnhd_bwd_hd128(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias,
                             void* stats, int batch, int n, int heads, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, const int64_t* gs,
                             int64_t bias_row_stride, float scale, int is_bf16, int hd,
                             cudaStream_t stm) {
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  return launch_attention_bwd<6, 128>(q, k, v, g, bias, dq, dk, dv, dbias, stats, batch, n,
                                      heads, st, scale, is_bf16, stm);
}
