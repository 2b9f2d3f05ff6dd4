// Nearest-code search for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel imagefolder_tpu/ops/pallas/codebook.py:
// codebook_argmin (kernel body _kernel): for each of N rows x (C floats),
// the index of argmin_v (|e_v|^2 - 2 x.e_v) over a V-entry codebook, or,
// with `maximize` (callers pass L2-normalised rows), argmax_v x.e_v, written
// as argmin_v (-2 x.e_v). Ties go to the lowest index, as torch.argmin and
// the Pallas kernel (first occurrence within a tile, strict < across tiles).
//
// What bounds it on this card: the multi-scale quantizer calls it with
// C = 32 and V = 4096 at N = B * pn^2 rows. At N = 7744 that is 2.03 GFLOP
// of fp32 multiply-adds against 1.5 MB of compulsory traffic, so it is bound
// by operations: 30 us at the 67 TFLOP/s fp32 FMA peak. The products must be
// exact fp32: TF32 or bf16 tensor cores flip near-tied codes, and a flipped
// code at one scale changes every later residual of the multi-scale encode.
//
// What the design does about it: the TPU kernel kept an (N-tile, V-tile)
// score block in VMEM and a running (min, argmin) in scratch across the
// sequential grid. Here a block of 128 threads owns 32 whole rows, so no
// reduction crosses blocks: it streams the codebook through shared memory in
// tiles of 128 codes (the 16 threads that read 16 different codes hit 16
// banks). Each thread holds 4 rows x 8 codes of dot products in registers,
// accumulated with fmaf over c in order, and keeps a running (best, index) per row with a strict <, over codes that it
// visits in increasing order. At the end, the 16 threads that share a row
// merge their pairs by (value, index) with warp shuffles. Padded codes
// (v >= V) are never compared; rows >= N are never stored. The x tile stays
// in shared memory and is read by broadcast. The scores never reach device
// memory: the output is N int64 indices. Both shared tiles pad their rows by
// one float, which also keeps the two row groups of a warp on other banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCodeThreads = 16;                       // threads across codes
constexpr int kRowThreads = kThreads / kCodeThreads;   // 8 threads across rows
constexpr int kRowsPerThread = 4;
constexpr int kCodesPerThread = 8;
constexpr int kRows = kRowThreads * kRowsPerThread;    // 32 rows per block
constexpr int kCodes = kCodeThreads * kCodesPerThread; // 128 codes per tile

template <int C, bool kNorms>
__global__ void __launch_bounds__(kThreads)
    codebook_argmin_kernel(const float* __restrict__ x,
                           const float* __restrict__ cb,
                           const float* __restrict__ e2,
                           int64_t* __restrict__ out, int n, int v) {
  __shared__ float sx[kRows][C + 1];
  __shared__ float se[kCodes][C + 1];

  const int tc = threadIdx.x % kCodeThreads;
  const int tr = threadIdx.x / kCodeThreads;
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    sx[r][c] = row0 + r < n ? x[static_cast<int64_t>(row0 + r) * C + c] : 0.f;
  }

  float best[kRowsPerThread];
  int arg[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    best[r] = INFINITY;
    arg[r] = 0;
  }

  for (int v0 = 0; v0 < v; v0 += kCodes) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kCodes * C; i += kThreads) {
      const int j = i / C, c = i % C;
      se[j][c] = v0 + j < v ? cb[static_cast<int64_t>(v0 + j) * C + c] : 0.f;
    }
    __syncthreads();

    float acc[kRowsPerThread][kCodesPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) acc[r][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      float xr[kRowsPerThread], ej[kCodesPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) xr[r] = sx[tr * kRowsPerThread + r][c];
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) ej[j] = se[tc + j * kCodeThreads][c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) acc[r][j] = fmaf(xr[r], ej[j], acc[r][j]);
    }

    // this thread's codes v0 + tc + 16 j rise with j: a strict < keeps the
    // first of equal scores
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j) {
      const int code = v0 + tc + j * kCodeThreads;
      if (code < v) {
        const float base = kNorms ? e2[code] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float d = base - 2.f * acc[r][j];
          if (d < best[r]) {
            best[r] = d;
            arg[r] = code;
          }
        }
      }
    }
  }

  // merge the 16 code threads of each row (lanes 0-15 or 16-31 of a warp):
  // the smaller score wins, and of equal scores the smaller index
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int off = kCodeThreads / 2; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[r], off);
      if (ob < best[r] || (ob == best[r] && oa < arg[r])) {
        best[r] = ob;
        arg[r] = oa;
      }
    }
    const int row = row0 + tr * kRowsPerThread + r;
    if (tc == 0 && row < n) out[row] = arg[r];
  }
}

template <int C>
void launch(const float* x, const float* cb, const float* e2, int64_t* out,
            int n, int v, cudaStream_t st) {
  const dim3 grid((n + kRows - 1) / kRows);
  if (e2)
    codebook_argmin_kernel<C, true><<<grid, kThreads, 0, st>>>(x, cb, e2, out, n, v);
  else
    codebook_argmin_kernel<C, false><<<grid, kThreads, 0, st>>>(x, cb, e2, out, n, v);
}

}  // namespace

// x (N, C) and codebook (V, C) fp32 contiguous; e2 (V,) fp32 with |e_v|^2,
// or null for `maximize` (scores -2 x.e); out (N,) int64. C in {8, 16, 32,
// 64}. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int codebook_argmin(const void* x, const void* codebook,
                               const void* e2, void* out, int n, int v, int c,
                               void* stream) {
  if (n <= 0 || v <= 0) return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(codebook);
  const float* ep = static_cast<const float*>(e2);
  int64_t* op = static_cast<int64_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8: launch<8>(xp, cp, ep, op, n, v, st); break;
    case 16: launch<16>(xp, cp, ep, op, n, v, st); break;
    case 32: launch<32>(xp, cp, ep, op, n, v, st); break;
    case 64: launch<64>(xp, cp, ep, op, n, v, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
