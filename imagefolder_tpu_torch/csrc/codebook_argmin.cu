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
// C = 32 and V = 4096 at N = B * pn^2 rows, 20 times per encode (two PQ
// branches, ten scales). At N = 7744 that is 2.03 GFLOP of fp32
// multiply-adds against 1.5 MB of compulsory traffic, so it is bound by
// operations: 30 us at the 67 TFLOP/s fp32 FMA peak. The products must be
// exact fp32: TF32 or bf16 tensor cores flip near-tied codes, and a flipped
// code at one scale changes every later residual of the multi-scale encode.
// Most of an encode's launches are small (N = 64 to 2304 at 256 px): there
// a design that gives each block whole rows of the codebook launches a few
// blocks that each walk all 4096 codes, and leaves the card nearly empty.
//
// What the design does about it:
//   - Fill the card at small N: the codebook is split into S code ranges
//     (S in {1, 2, 4, 8}), one per block of a thread-block cluster; S is the
//     one that gives the fewest code tiles a block scans times the waves of
//     clusters that ceil(N / 128) row tiles take, at the number of clusters
//     of S blocks that fit the card at once (cudaOccupancyMaxActiveClusters:
//     a cluster's blocks share a GPC, so fewer fit than SMs / S). Each block
//     scans its range in increasing code order with a strict <; after
//     cluster.sync() the block of rank 0 merges the
//     ranks' (best, index) pairs per row from their shared memory
//     (distributed shared memory), in rank order, by value and then index,
//     so that the first occurrence holds across ranges. One launch, no
//     workspace.
//   - An FFMA main loop toward the fp32 peak: 256 threads own a 128-row x
//     256-code tile, each thread an 8 x 16 register tile (rows ty + 16 i,
//     codes tx + 16 j). x and each code tile sit in shared memory row-major,
//     as in device memory, with rows padded to C + 4 floats: one 16-byte
//     load gives four c of a row or a code, and the codes a quarter-warp
//     reads land in distinct banks. On this card an SM does 128 FFMA a
//     clock but reads 128 bytes of shared memory a clock into registers, so
//     a thread's tile sets the ceiling: 8 x 8 reads 16 floats per 64 FFMA,
//     as fast as the products run; 8 x 16 reads 24 per 128. Tiles arrive by
//     coalesced 16-byte cp.async copies, code tiles double-buffered so that
//     the next lands while this one's products run; the 512 KB book stays
//     in L2. Tiles kept c-major would need 4-byte copies that transpose on
//     the way, 32 cache lines a warp instruction: timed so, the loads took
//     as long as the products (PERF.md).
//   - Exact fp32: every score is accumulated with fmaf over c in increasing
//     order from 0 and scored as base - 2 acc. The argmin epilogue runs in
//     registers per code column; the 16 threads that share a row then merge
//     by (value, index) with warp shuffles.
// Padded codes (v >= V, or past a rank's range) are never compared; rows
// >= N are never stored. The scores never reach device memory: the output is
// N int64 indices. One block an SM (128 accumulators a thread; 94 KB of
// shared memory at C = 32). Compiled at CK = 8, 16, 32, 64 and 128; a call
// at a true width c <= CK (the wrapper passes both) reads rows c floats
// apart and zero-fills the tiles' columns c..CK-1 as it loads them (zero
// columns change neither |e|^2 nor x.e), with 16-byte copies when c is a
// multiple of 4 and 4-byte copies otherwise; the products stop at c rounded
// up to 4. At CK = 128 one code tile is in flight at a time (199 KB of
// shared memory), not two.
// Past 128 (kChunked, on the CK = 128 tiles): for each code tile the
// block walks C in chunks of 128 columns, loading x's and the tile's
// columns of the chunk and adding their products into the same 8 x 16
// register tile, so that each score is still one fmaf chain over c in
// increasing order from 0; the argmin epilogue runs once per code tile.
// x is reloaded from L2 for every chunk of every code tile: a simple first
// version (no shipped config passes 64).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRows = 128;      // rows per block (row tile)
constexpr int kCodes = 256;     // codes per tile of the scan
constexpr int kMaxSplit = 8;    // code ranges per row tile: the portable cluster size
static_assert(kCodes == kThreads, "one |e|^2 copy a thread per code tile");

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a tile's rows are padded by kPad floats: a pitch of C + 4 keeps 16-byte
// rows and puts the rows of eight consecutive codes on distinct 16-byte
// bank groups
constexpr int kPad = 4;

// code tiles in flight: two (double-buffered) up to CK = 64; at CK = 128
// two would take 332 KB, past the 227 KB an SM has, so one, loaded after the
// last one's products
template <int CK>
__host__ __device__ constexpr int stages() {
  return CK <= 64 ? 2 : 1;
}

// dynamic shared memory: x [kRows][CK + kPad], stages() code tiles
// [kCodes][CK + kPad] and their rows of |e|^2
template <int CK>
constexpr int smem_bytes() {
  return (kRows * (CK + kPad) + stages<CK>() * kCodes * (CK + kPad) + stages<CK>() * kCodes) *
         4;
}

// Rows [row0, row0 + rows) of the (count, c) matrix src (rows c floats
// apart) into a [rows][P] shared tile, columns c..CK-1 and rows at or past
// `count` zero-filled: 16-byte copies when c is a multiple of 4 (then every
// row starts on a 16-byte boundary), 4-byte copies otherwise; consecutive
// threads copy consecutive chunks of a row.
// A chunk (kChunked) passes src at its first column, ld = C and c its
// width.
template <int CK, int P>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int count, int c, int tid, int ld) {
  if (c % 4 == 0 && ld % 4 == 0) {
    for (int i = tid; i < rows * CK / 4; i += kThreads) {
      const int r = i / (CK / 4), q = i % (CK / 4);
      const bool in = row0 + r < count && 4 * q < c;
      cp_async16(dst + r * P + 4 * q,
                 src + (in ? static_cast<int64_t>(row0 + r) * ld + 4 * q : 0), in);
    }
  } else {
    for (int i = tid; i < rows * CK; i += kThreads) {
      const int r = i / CK, k = i % CK;
      const bool in = row0 + r < count && k < c;
      cp_async4(dst + r * P + k, src + (in ? static_cast<int64_t>(row0 + r) * ld + k : 0), in);
    }
  }
}
template <int CK, int P>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int count, int c, int tid) {
  load_rows<CK, P>(dst, src, row0, rows, count, c, tid, c);
}

// acc[i][j] += the products of x's rows ty + 16 i (at xs) and the tile's
// codes tx + 16 j (at es) over the first c4 columns (a multiple of 4), four
// c at a time, each accumulator's sum still taken over c in order
template <int P>
__device__ __forceinline__ void accumulate(float (&acc)[8][16], const float* xs,
                                           const float* es, int c4) {
#pragma unroll 1
  for (int k = 0; k < c4; k += 4) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = *reinterpret_cast<const float4*>(xs + 16 * i * P + k);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 ev = *reinterpret_cast<const float4*>(es + 16 * j * P + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(xv[i].x, ev.x, acc[i][j]);
        acc[i][j] = fmaf(xv[i].y, ev.y, acc[i][j]);
        acc[i][j] = fmaf(xv[i].z, ev.z, acc[i][j]);
        acc[i][j] = fmaf(xv[i].w, ev.w, acc[i][j]);
      }
    }
  }
}

// One block: row tile blockIdx.y against code range `rank` (its cluster
// rank, blockIdx.x) of v_per codes, at true code width c <= CK, or (kChunked,
// CK = 128) any c walked in chunks of CK; see the header comment.
template <int CK, bool kNorms, bool kChunked = false>
__global__ void __launch_bounds__(kThreads, 1)
    codebook_argmin_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                           const float* __restrict__ e2, int64_t* __restrict__ out, int n,
                           int v, int c, int v_per) {
  constexpr int P = CK + kPad;  // row pitch of the tiles, in floats
  constexpr int S = stages<CK>();
  static_assert(!kChunked || S == 1, "a chunked search holds one code tile");
  const int c4 = (c + 3) / 4 * 4;  // the products' columns: past c they are zeros
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [kRows][P]
  float* se = sx + kRows * P;                   // [S][kCodes][P]
  float* sb = se + S * kCodes * P;              // [S][kCodes]
  __shared__ float rbest[kRows];                // this block's per-row result
  __shared__ int rarg[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * kRows;
  const int vbeg = rank * v_per;
  const int vend = min(v, vbeg + v_per);
  const int ntiles = vend > vbeg ? (vend - vbeg + kCodes - 1) / kCodes : 0;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 16 i, codes tx + 16 j

  // x and code tile t, row-major
  if (!kChunked) load_rows<CK, P>(sx, x, row0, kRows, n, c, tid);
  auto load_tile = [&](int t) {
    const int v0 = vbeg + t * kCodes;
    load_rows<CK, P>(se + (t % S) * kCodes * P, cb, v0, kCodes, vend, c, tid);
    if (kNorms) {
      const bool in = v0 + tid < vend;  // kCodes == kThreads: one each
      cp_async4(sb + (t % S) * kCodes + tid, e2 + (in ? v0 + tid : 0), in);
    }
  };
  if (!kChunked && ntiles > 0) load_tile(0);
  cp_async_commit();  // group 0: x and tile 0

  float best[8];  // rows ty + 16 i
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }

  for (int t = 0; t < ntiles; ++t) {
    const float* xs = sx + ty * P;
    const float* es = se + (t % S) * kCodes * P + tx * P;
    float acc[8][16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    if (kChunked) {
      // chunk c0 of x and of code tile t into the one buffer of each, then
      // its products; the next chunk's copies wait for every thread
      const int v0 = vbeg + t * kCodes;
      for (int c0 = 0; c0 < c; c0 += CK) {
        const int cw = c - c0 < CK ? c - c0 : CK;
        load_rows<CK, P>(sx, x + c0, row0, kRows, n, cw, tid, c);
        load_rows<CK, P>(se, cb + c0, v0, kCodes, vend, cw, tid, c);
        if (kNorms && c0 == 0) {
          const bool in = v0 + tid < vend;
          cp_async4(sb + tid, e2 + (in ? v0 + tid : 0), in);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        accumulate<P>(acc, xs, es, (cw + 3) / 4 * 4);
        __syncthreads();
      }
    } else {
      if (S == 2) {
        if (t + 1 < ntiles) load_tile(t + 1);  // into the buffer tile t - 1 has left
        cp_async_commit();
        cp_async_wait1();  // tile t (and x) landed
      } else {
        if (t > 0) load_tile(t);  // into the one buffer, which tile t - 1 has left
        cp_async_commit();
        cp_async_wait_all();
      }
      __syncthreads();
      accumulate<P>(acc, xs, es, c4);
    }

    // this thread's codes rise with j: a strict < keeps the first of equal
    // scores
    const int v0 = vbeg + t * kCodes;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int jj = tx + 16 * j;
      if (v0 + jj < vend) {
        const float base = kNorms ? sb[(t % S) * kCodes + jj] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = base - 2.f * acc[i][j];
          if (d < best[i]) {
            best[i] = d;
            arg[i] = v0 + jj;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with buffer t % S
  }
  cp_async_wait_all();  // a rank with no codes still copied x

  // merge the 16 code threads of each row (lanes 0-15 or 16-31 of a warp):
  // the smaller score wins, and of equal scores the smaller index
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (ob < best[i] || (ob == best[i] && oa < arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
    const int r = ty + 16 * i;
    if (tx == 0) {
      if (split == 1) {
        if (row0 + r < n) out[row0 + r] = arg[i];
      } else {
        rbest[r] = best[i];
        rarg[r] = arg[i];
      }
    }
  }
  if (split == 1) return;

  // across the cluster: rank 0 reads every rank that holds codes, in rank
  // order, from its shared memory; the second sync keeps each rank's shared
  // memory alive until then
  cluster.sync();
  if (rank == 0 && tid < kRows && row0 + tid < n) {
    float b = rbest[tid];
    int a = rarg[tid];
    for (int s = 1; s < split && s * v_per < v; ++s) {
      const float ob = cluster.map_shared_rank(rbest, s)[tid];
      const int oa = cluster.map_shared_rank(rarg, s)[tid];
      if (ob < b || (ob == b && oa < a)) {
        b = ob;
        a = oa;
      }
    }
    out[row0 + tid] = a;
  }
  cluster.sync();
}

// The launch of one call: row tile y, cluster rank x, as many clusters of
// `split` blocks as row tiles
template <int CK, bool kNorms, bool kChunked>
cudaLaunchConfig_t launch_config(int split, int row_tiles, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<CK>();
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of s = 1, 2, 4, 8 blocks that fit the card at once, read once
// per instantiation
template <int CK, bool kNorms, bool kChunked>
int max_clusters(int s) {
  static int known[4] = {0, 0, 0, 0};
  const int k = s == 1 ? 0 : s == 2 ? 1 : s == 4 ? 2 : 3;
  if (!known[k]) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<CK, kNorms, kChunked>(s, 1, nullptr, &attr);
    int n = 0;
    cudaOccupancyMaxActiveClusters(&n, codebook_argmin_kernel<CK, kNorms, kChunked>, &cfg);
    known[k] = n > 0 ? n : 1;
  }
  return known[k];
}

// The split S in {1, 2, 4, 8} for n rows of a v-code book that gives the
// least time by a count of code tiles: each block scans ceil(v / (kCodes
// S)) tiles, and the row tiles' clusters run in ceil(row tiles /
// max_clusters(S)) waves. Ties go to the smaller S (less merging, fewer
// copies of x).
template <int CK, bool kNorms, bool kChunked>
int split_for(int n, int v) {
  const int64_t tiles = (n + kRows - 1) / kRows;
  int best = 1;
  int64_t best_cost = INT64_MAX;
  for (int s = 1; s <= kMaxSplit && (s == 1 || (s / 2) * kCodes < v); s *= 2) {
    const int64_t per_block = (v + static_cast<int64_t>(s) * kCodes - 1) / (s * kCodes);
    const int64_t fit = max_clusters<CK, kNorms, kChunked>(s);
    const int64_t cost = per_block * ((tiles + fit - 1) / fit);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// split_for with the kernel's shared-memory attribute set, which the
// occupancy query and the launch need
template <int CK, bool kNorms, bool kChunked = false>
int split_of(int n, int v) {
  cudaFuncSetAttribute(codebook_argmin_kernel<CK, kNorms, kChunked>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<CK>());
  return split_for<CK, kNorms, kChunked>(n, v);
}

template <int CK, bool kNorms, bool kChunked>
int launch(const float* x, const float* cb, const float* e2, int64_t* out, int n, int v, int c,
           cudaStream_t st) {
  const int split = split_of<CK, kNorms, kChunked>(n, v);
  const int v_per = ((v + split - 1) / split + kCodes - 1) / kCodes * kCodes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<CK, kNorms, kChunked>(split, (n + kRows - 1) / kRows, st, &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, codebook_argmin_kernel<CK, kNorms, kChunked>,
                                             x, cb, e2, out, n, v, c, v_per));
}

template <int CK, bool kChunked = false>
int launch_c(const float* x, const float* cb, const float* e2, int64_t* out, int n, int v,
             int c, cudaStream_t st) {
  return e2 ? launch<CK, true, kChunked>(x, cb, e2, out, n, v, c, st)
            : launch<CK, false, kChunked>(x, cb, e2, out, n, v, c, st);
}

}  // namespace

// x (N, c) and codebook (V, c) fp32 contiguous on 16-byte boundaries; e2
// (V,) fp32 with |e_v|^2, or null for `maximize` (scores -2 x.e); out (N,)
// int64. ck: the instantiation the wrapper chose (ops/cuda/codebook.py,
// kernel_width), the smallest of 8, 16, 32, 64 and 128 that holds c, or 128
// for any c past 128 (walked in chunks of 128), which is checked here; N up
// to 65535 row tiles of 128. Launches on `stream` and returns the launch's
// error, then cudaGetLastError(), as an int (0 = launched;
// cudaErrorInvalidValue for another ck or c).
extern "C" int codebook_argmin(const void* x, const void* codebook,
                               const void* e2, void* out, int n, int v, int c, int ck,
                               void* stream) {
  if (n <= 0 || v <= 0 || (n + kRows - 1) / kRows > 65535 || c < 1 ||
      (c > ck && ck != 128) || (ck > 8 && 2 * c <= ck))
    return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(codebook);
  const float* ep = static_cast<const float*>(e2);
  int64_t* op = static_cast<int64_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (ck) {
    case 8: err = launch_c<8>(xp, cp, ep, op, n, v, c, st); break;
    case 16: err = launch_c<16>(xp, cp, ep, op, n, v, c, st); break;
    case 32: err = launch_c<32>(xp, cp, ep, op, n, v, c, st); break;
    case 64: err = launch_c<64>(xp, cp, ep, op, n, v, c, st); break;
    case 128:
      err = c > 128 ? launch_c<128, true>(xp, cp, ep, op, n, v, c, st)
                    : launch_c<128>(xp, cp, ep, op, n, v, c, st);
      break;
    default: return cudaErrorInvalidValue;
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The split S that a call of codebook_argmin for n rows of a v-code book of
// width c at instantiation ck (norms: with |e|^2, i.e. not maximize) takes on
// the current device, for the checks; 0 for a width the kernel is not built
// for.
extern "C" int codebook_argmin_split(int n, int v, int c, int ck, int norms) {
  if (n <= 0 || v <= 0) return 0;
  if (ck == 128 && c > 128)
    return norms ? split_of<128, true, true>(n, v) : split_of<128, false, true>(n, v);
  switch (ck) {
    case 8: return norms ? split_of<8, true>(n, v) : split_of<8, false>(n, v);
    case 16: return norms ? split_of<16, true>(n, v) : split_of<16, false>(n, v);
    case 32: return norms ? split_of<32, true>(n, v) : split_of<32, false>(n, v);
    case 64: return norms ? split_of<64, true>(n, v) : split_of<64, false>(n, v);
    case 128: return norms ? split_of<128, true>(n, v) : split_of<128, false>(n, v);
    default: return 0;
  }
}
