// BNHD attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// fused_attention (kernel bodies _kernel and _kernel_bias): per (batch,
// head), o = softmax(q k^T * scale + bias) v for q (B, Lq, H, hd) and k, v
// (B, Lk, H, hd), Lq <= Lk allowed, with an optional fp32 bias of shape
// (1|B, 1|H, Lq, Lk) that may hold -inf. q, k and v are strided views: the
// kernel takes each one's batch, row and head strides, so q can come straight
// from the (B, L, 3, H, hd) view of a fused qkv projection and k, v from a
// preallocated KV cache, with no transpose copies (the Pallas wrapper moved
// everything to (B*H, L, hd) first). A bias that is shared over batches or
// heads has stride 0 there and is read from its one copy. The output is
// contiguous (B, Lq, H, hd).
//
// Numerics follow the Pallas kernel, which differs from #1 and #4: fp32
// scores and softmax, and p divided by its row sum BEFORE it is rounded to
// the input type for p v. A streaming kernel does not know the row sum
// until it has seen every key, so each block makes two passes over the k
// tiles: the first keeps a running max m and row sum l (online softmax); the
// second recomputes the scores and accumulates (exp(s - m) / l) v, whose
// bf16 rounding is that of the Pallas kernel. The output then needs no
// rescale.
//
// bf16 runs on wgmma (attention_fwd_sm90.cuh, instantiated as kernel 3):
// two warpgroups per (b, h, 128 q rows), each with 64 q rows, sharing k and
// v, resident in shared memory when Lk <= 320 and streamed through a
// four-slot cp.async ring past that,
// and, when asked, each row's lse = m + log(l) for the backward (#6). What
// bounds it and why the design is so are in that header. fp32 inputs (VAR's
// default dtype, the full-width model checks) take an FMA kernel with one
// thread per q row and the same two passes; it has no lse store.
//
// Head dims 64 (VAR) and 48 (RAR-B's training forward, 768 / 16), each
// instantiated from the same code (kD): the wgmma kernel zero-pads a 48-wide
// head to its 64-wide tiles (attention_fwd_sm90.cuh). Any other multiple of
// 8 up to 64 runs under those two at run time (st.hd): up to 48 under kD =
// 48, 56 under 64, its columns past hd zero in every tile and never stored.
// Heads of 72-128 (RAR-XL's 80, RAR-XXL's 88) run the kD = 128
// instantiations, compiled apart (attention_bnhd_hd128.cu), and heads of
// 136-256 the kD = 256 FMA kernel of attention_wide.cuh, in fp32 and bf16
// (attention_bnhd_hd256.cu).

#include "attention_bnhd_fwd.cuh"

// hd 72-128: the kD = 128 instantiations, with the entry's own arguments
int attention_bnhd_fwd_hd128(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* bs, float scale, int is_bf16, int hd,
                             cudaStream_t stm);
// hd 136-256: the kD = 256 kernel of attention_wide.cuh (attention_bnhd_hd256.cu)
int attention_bnhd_fwd_hd256(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             const int64_t* bs, float scale, int is_bf16, int hd,
                             cudaStream_t stm);

// q (B, Lq, H, hd), k and v (B, Lk, H, hd), hd a multiple of 8 up to 256,
// each with its own batch, row and head strides in elements (qs, ks, vs =
// {batch, row, head}; the head-dim stride is 1), all fp32 or all bf16
// (is_bf16); bias null or fp32 with strides bs = {batch, head, row} (column
// stride 1, 0 on a broadcast axis); out contiguous (B, Lq, H, hd) of q's type; lse null, or (bf16 only) an
// fp32 (B, H, Lq) that receives each row's log-sum-exp for the backward
// (#6). bf16 needs every base pointer and q/k/v stride on a 16-byte
// boundary. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched; cudaErrorInvalidValue for another head dim).
extern "C" int attention_bnhd_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, void* lse, int batch, int lq,
                                  int lk, int heads, const int64_t* qs,
                                  const int64_t* ks, const int64_t* vs,
                                  const int64_t* bs, float scale, int is_bf16, int hd,
                                  void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || (lse && !is_bf16) || hd < 8 ||
      hd > 256 || hd % 8)
    return cudaErrorInvalidValue;
  if (hd > 128)
    return attention_bnhd_fwd_hd256(q, k, v, bias, out, lse, batch, lq, lk, heads, qs, ks, vs,
                                    bs, scale, is_bf16, hd, static_cast<cudaStream_t>(stream));
  if (hd > 64)
    return attention_bnhd_fwd_hd128(q, k, v, bias, out, lse, batch, lq, lk, heads, qs, ks, vs,
                                    bs, scale, is_bf16, hd, static_cast<cudaStream_t>(stream));
  Strides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             bias ? bs[0] : 0, bias ? bs[1] : 0, bias ? bs[2] : 0, hd};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  return hd <= 48 ? launch_bnhd_fwd<48>(q, k, v, bp, out, lse, batch, lq, lk, heads, st, scale,
                                        is_bf16, stm)
                  : launch_bnhd_fwd<64>(q, k, v, bp, out, lse, batch, lq, lk, heads, st, scale,
                                        is_bf16, stm);
}
