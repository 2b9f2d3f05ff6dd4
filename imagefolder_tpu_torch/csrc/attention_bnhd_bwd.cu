// BNHD attention backward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _fused_attention_bwd_impl (kernel bodies _bnhd_bwd_kernel and
// _bnhd_bias_bwd_kernel, math _bwd_head_math): the gradient of
// fused_attention for self-attention, q, k, v and the output gradient g all
// (B, L, H, hd), with no bias or one fp32 (L, L) bias shared by every batch
// and head, which may hold -inf. q, k, v and g are strided views (batch, row
// and head strides; hd stride 1); dq, dk and dv are written contiguous
// (B, L, H, hd) in the inputs' type.
//
// In bf16 without dbias the device code is attention_bwd_sm90.cuh, shared
// with #2 and #5: FlashAttention-2's backward on wgmma, with p from the
// forward's saved lse (the BNHD forward #3 stores it, attention_fwd_sm90.cuh)
// and delta = rowsum(o g) from its saved output o; one warpgroup per 64 keys
// of one (b, h) walks the q tiles the blank-tile map leaves for dk and dv,
// one per 64 q rows walks the key tiles for dq. Its numerics are #5's: the
// plain version of #5 is #6's. fp32, a call that asks for dbias, and L = 1
// keep the two-kernel design of attention_bwd_tile.cuh: a row with one key
// has p = 1 and ds = 0 exactly there, where p from lse leaves ~1e-7 of |dp|
// (see attention_bwd_sm90.cuh), and at L = 1 every row is such a row, so dq
// and dk are exactly 0. The instantiations carry #6's number (kId), so that
// a profile counts its device time apart from #2's and #5's.
//
// What bounds it on this card: VAR-d16's training step calls it 16 times at
// (64, 286, 16, 64) bf16 under the block-causal bias, with no dbias (the
// bias is a constant). Each call must read q, k, v, g and write dq, dk, dv:
// 262 MB, 78 us at 3.35 TB/s, against 34 GFLOP of products over the 51,445
// allowed (q, k) pairs per (b, h) (five products of 2 hd operations per
// pair), 34 us at 989 TFLOP/s. So it is bound by memory, as the forward is;
// at tile grain the design runs seven products over 20 of the 25 tiles.

#include "attention_bwd_sm90.cuh"

// hd 72-128: the kD = 128 instantiations, compiled apart (attention_bnhd_bwd_hd128.cu)
int attention_bnhd_bwd_hd128(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias, void* stats,
                             int batch, int n, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, const int64_t* gs, int64_t bias_row_stride,
                             float scale, int is_bf16, int hd, cudaStream_t stm);
// hd 136-256: the kD = 256 kernels of attention_wide.cuh (attention_bnhd_bwd_hd256.cu)
int attention_bnhd_bwd_hd256(const void* q, const void* k, const void* v, const void* g,
                             const void* bias, void* dq, void* dk, void* dv, void* dbias, void* stats,
                             int batch, int n, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, const int64_t* gs, int64_t bias_row_stride,
                             float scale, int is_bf16, int hd, cudaStream_t stm);

namespace {

template <int kD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* o,
               const int64_t* os, const void* lse, const void* bias, void* dq, void* dk,
               void* dv, void* dbias, void* work, void* blank, int batch, int n, int heads,
               const BwdStrides& st, float scale, int is_bf16, cudaStream_t stm) {
  if (!is_bf16 || dbias || n == 1)
    return launch_attention_bwd<6, kD>(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n,
                                       heads, st, scale, is_bf16, stm);
  return sm90::launch_attention_bwd_sm90<6, kD>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), sm90::OStrides{os[0], os[1], os[2]},
      static_cast<const float*>(lse), static_cast<const float*>(bias), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(work),
      static_cast<uint8_t*>(blank), batch, n, heads, st, scale, stm);
}

}  // namespace

// q, k, v and g (B, L, H, hd), hd a multiple of 8 up to 256 (run under the
// kD = 48 kernels up to 48, 64 at 56 and 64, 128 at 72-128 and 256 past
// 128: past 64 every call, bf16 too, takes a two-kernel design, that of
// attention_bwd_tile.cuh up to 128 and that of attention_wide.cuh past it,
// and o, lse and blank go unused, work being its 3 * B * H * L scratch), each
// with its own batch, row and
// head strides in elements (qs, ks, vs, gs = {batch, row, head}; the head-dim
// stride is 1), all fp32 or all bf16 (is_bf16); bias null or an fp32 (L, L)
// shared by every batch and head, row stride bias_row_stride (column stride
// 1); dq, dk and dv contiguous (B, L, H, hd) of the inputs' type; dbias null
// (not wanted) or a zeroed fp32 (L, L) that receives the sum of ds. bf16
// without dbias: o the forward's output at strides os, lse its fp32 (B, H, L)
// log-sum-exp, work an fp32 scratch of sm90::work_floats(B, L, H), blank a
// scratch of two bytes per tile pair (2 * ceil(L/64)^2) when a bias is given;
// prep, main and dq kernels. fp32, dbias wanted, or L = 1: o, lse and blank
// unused, work an fp32 scratch of 3 * B * H * L; kernels A and B of
// attention_bwd_tile.cuh. Launches on `stream` and returns cudaGetLastError()
// as an int (0 = all launched; cudaErrorInvalidValue for another head dim).
extern "C" int attention_bnhd_bwd(const void* q, const void* k, const void* v,
                                  const void* g, const void* o, const void* lse,
                                  const void* bias, void* dq, void* dk, void* dv, void* dbias,
                                  void* work, void* blank, int batch, int n, int heads,
                                  const int64_t* qs, const int64_t* ks, const int64_t* vs,
                                  const int64_t* gs, const int64_t* os,
                                  int64_t bias_row_stride, float scale, int is_bf16, int hd,
                                  void* stream) {
  if (hd < 8 || hd > 256 || hd % 8) return cudaErrorInvalidValue;
  if (hd > 128)
    return attention_bnhd_bwd_hd256(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n, heads,
                                    qs, ks, vs, gs, bias_row_stride, scale, is_bf16, hd,
                                    static_cast<cudaStream_t>(stream));
  if (hd > 64)
    return attention_bnhd_bwd_hd128(q, k, v, g, bias, dq, dk, dv, dbias, work, batch, n, heads,
                                    qs, ks, vs, gs, bias_row_stride, scale, is_bf16, hd,
                                    static_cast<cudaStream_t>(stream));
  const int64_t ol = static_cast<int64_t>(heads) * hd;
  const BwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      gs[0], gs[1], gs[2], n * ol, ol, hd, bias ? bias_row_stride : 0, hd};
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  return hd <= 48 ? launch_bwd<48>(q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work, blank,
                                   batch, n, heads, st, scale, is_bf16, stm)
                  : launch_bwd<64>(q, k, v, g, o, os, lse, bias, dq, dk, dv, dbias, work, blank,
                                   batch, n, heads, st, scale, is_bf16, stm);
}
