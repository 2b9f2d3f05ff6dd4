// Q-blocked BNHD attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/attention.py:
// _fused_attention_qblk_fwd (kernel body _kernel_qblk): per (batch, head),
// o = softmax(q k^T * scale + bias) v for q (B, Lq, H, hd) and k, v
// (B, Lk, H, hd) past the single-block budget (Lq * Lk > 2^22), with o
// divided by the row sum AFTER p v, as the packed kernel does, and unlike
// the BNHD kernel #3 (attention_bnhd.cu), which divides p before it. q, k
// and v are strided views (batch, row and head strides; hd stride 1), so
// the (B, N, 3, H, hd) views of a packed qkv are read in place with no
// copy. The bias is none or one fp32 (Lq, Lk) shared by every batch and
// head, with a row stride, and may hold -inf. The output is contiguous
// (B, Lq, H, hd).
//
// The TPU kernel split the q axis into blocks so that one (qblk, Lk) fp32
// score tile fit its VMEM budget, and the JAX package capped L at 2304
// with a bias and 2816 without one (attention.py:666-667). A Hopper block
// streams k/v tiles with an online softmax (in bf16 the one-pass wgmma
// kernel of attention_fwd_sm90.cuh, shared with the packed forward
// attention_qkv.cu), so it holds no score tile and takes any length;
// offsets are 64-bit (the 512 px encoder's q view has a batch stride of
// 3073 * 2304 elements, 453 M over 64 images).
//
// What bounds it on this card: at VAR's 512 px teacher forcing, (16, 2240,
// 16, 64) bf16 under the block-causal bias, a call needs 4*B*H*hd operations
// per (q, k) pair the mask allows, 214 GFLOP over 65% of the L^2 pairs
// (0.217 ms at 989 TFLOP/s), on 314 MB of compulsory traffic (0.094 ms at
// 3.35 TB/s); at the tokenizer's N = 2050 and 3073, with no mask, the ratio
// is higher still. It is bound by operations: the design keeps the two
// products on the tensor cores and every score in registers, and with a
// square bias it skips the 64 x 64 tiles the bias blanks (34% of VAR's):
// a pre-pass (the prep kernel of attention_bwd_sm90.cuh, instantiated as
// kernel 4) writes the bias's blank-tile map, which the forward reads.

#include "attention_bwd_sm90.cuh"
#include "attention_fwd_tile.cuh"
#include "attention_widths.cuh"

// hd <= 48 and 72-128: the kD = 48 and 128 instantiations, compiled apart
// (attention_qblk_hd48.cu, attention_qblk_hd128.cu)
int attention_qblk_fwd_hd128(const void* q, const void* k, const void* v, const void* bias,
                             const uint8_t* map, void* out, float* lse, int batch, int lq,
                             int lk, int heads, const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, int64_t bias_row_stride, float scale,
                             int is_bf16, int hd, cudaStream_t stm);
int attention_qblk_fwd_hd48(const void* q, const void* k, const void* v, const void* bias,
                            const uint8_t* map, void* out, float* lse, int batch, int lq,
                            int lk, int heads, const int64_t* qs, const int64_t* ks,
                            const int64_t* vs, int64_t bias_row_stride, float scale,
                            int is_bf16, int hd, cudaStream_t stm);
// hd 136-256: the kD = 256 kernel of attention_wide.cuh (attention_qblk_hd256.cu)
int attention_qblk_fwd_hd256(const void* q, const void* k, const void* v, const void* bias,
                             void* out, float* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             int64_t bias_row_stride, float scale, int is_bf16, int hd,
                             cudaStream_t stm);
// hd 264-512: the kD = 512 kernel of attention_wide.cuh (attention_qblk_hd512.cu)
int attention_qblk_fwd_hd512(const void* q, const void* k, const void* v, const void* bias,
                             void* out, float* lse, int batch, int lq, int lk, int heads,
                             const int64_t* qs, const int64_t* ks, const int64_t* vs,
                             int64_t bias_row_stride, float scale, int is_bf16, int hd,
                             cudaStream_t stm);
// hd 520-1024: the kD = 1024 kernel of attention_wide.cuh (attention_qblk_hd1024.cu)
int attention_qblk_fwd_hd1024(const void* q, const void* k, const void* v, const void* bias,
                              void* out, float* lse, int batch, int lq, int lk, int heads,
                              const int64_t* qs, const int64_t* ks, const int64_t* vs,
                              int64_t bias_row_stride, float scale, int is_bf16, int hd,
                              cudaStream_t stm);

// q (B, Lq, H, hd), k and v (B, Lk, H, hd), hd a multiple of 8 (run under
// the kD = 48 kernels up to 48, 64 at 56 and 64, 128 at 72-128, and past 128
// the kD = 256, 512 and 1024 kernels of attention_wide.cuh and past 1024 its
// segmented kernel, which take no map), each with its own
// batch, row and head strides in elements (qs, ks, vs = {batch, row, head};
// the head-dim stride is 1), all fp32 or all bf16 (is_bf16); bias null or an fp32
// (Lq, Lk) shared by every batch and head, row stride bias_row_stride
// (column stride 1); blank null, or (bf16, with a bias and Lq == Lk) a
// scratch of 2 * ceil(Lq/64)^2 bytes: the pre-pass writes the bias's
// blank-tile map there and the forward skips the tiles it blanks (null:
// every tile computed); out contiguous (B, Lq, H, hd) of q's type; lse
// null, or an fp32 (B, H, Lq) that receives each row's log-sum-exp for the
// backward (#5). bf16 needs every base pointer and stride of q, k and v on
// a 16-byte boundary. Launches on `stream` and returns cudaGetLastError()
// as an int (0 = launched; cudaErrorInvalidValue for another head dim).
// kd: the instantiation the wrapper chose for hd, checked by bnhd_width_ok
// (attention_widths.cuh).
extern "C" int attention_qblk_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* blank, void* out, void* lse, int batch,
                                  int lq, int lk, int heads, const int64_t* qs,
                                  const int64_t* ks, const int64_t* vs, int64_t bias_row_stride,
                                  float scale, int is_bf16, int hd, int kd, void* stream) {
  if (!bnhd_width_ok(hd, kd)) return cudaErrorInvalidValue;
  const FwdStrides st{qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                      0, 0, bias ? bias_row_stride : 0, hd};
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  uint8_t* map = static_cast<uint8_t*>(blank);
  if (map && (!bias || lq != lk || !is_bf16)) return cudaErrorInvalidValue;
  if (kd > 128)
    return (kd >= 1024  ? attention_qblk_fwd_hd1024
            : kd == 512 ? attention_qblk_fwd_hd512
                        : attention_qblk_fwd_hd256)(
        q, k, v, bias, out, static_cast<float*>(lse), batch, lq, lk,
                                    heads, qs, ks, vs, bias_row_stride, scale, is_bf16, hd, stm);
  if (map) {
    if (!bias || lq != lk || !is_bf16) return cudaErrorInvalidValue;
    const int err = sm90::launch_blank_tile_map<4>(static_cast<const float*>(bias), map, lq,
                                                   st.bq, stm);
    if (err) return err;
  }
  float* lp = static_cast<float*>(lse);
  if (kd == 128)
    return attention_qblk_fwd_hd128(q, k, v, bias, map, out, lp, batch, lq, lk, heads, qs, ks,
                                    vs, bias_row_stride, scale, is_bf16, hd, stm);
  if (kd == 48)
    return attention_qblk_fwd_hd48(q, k, v, bias, map, out, lp, batch, lq, lk, heads, qs, ks, vs,
                                   bias_row_stride, scale, is_bf16, hd, stm);
  return launch_attention_fwd<4, 64>(q, k, v, bias, map, out, batch, lq, lk, heads, st, scale,
                                     is_bf16, stm, lp);
}
