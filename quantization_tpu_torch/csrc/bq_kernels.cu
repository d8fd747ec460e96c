// Binary-quantization scoring and fused search kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of quantization_tpu/ops/pallas/bq_kernel.py:
//   K6  qtt_bq_scores        <- bq_scores_mxu / _mxu_kernel (bq_kernel.py:671)
//                               and bq_scores_pallas / _make_kernel (:716),
//                               which compute the same [Q, n_valid] function
//   K5c qtt_bq_search_exact  <- bq_search_mxu(mode="exact") /
//                               _make_mxu_packed_kernel (bq_kernel.py:605)
//   K5a qtt_bq_search_approx <- bq_search_mxu(mode="approx") /
//                               _make_mxu_topk_kernel (bq_kernel.py:509)
//   K10 qtt_bq_search_approx with a tile selection <- bq_search_indexed /
//                               _make_mxu_topk_kernel_indexed (bq_kernel.py:328),
//                               for packed sign queries
// and, for residual IVF-BQ (an int8 VALUE query against the sign bits,
// query_affine, plus the bucket term corr):
//   K5b qtt_bq_search_exact_res  <- bq_search_mxu(mode="exact", query_affine=) /
//                               _make_mxu_class_ids_kernel (bq_kernel.py:576)
//   K5a qtt_bq_search_approx_res <- bq_search_mxu(mode="approx", query_affine=) /
//                               _make_mxu_topk_kernel with_corr (bq_kernel.py:509)
//   K10 qtt_bq_search_approx_res with a tile selection <- bq_search_indexed(
//                               query_affine=) (bq_kernel.py:328)
//
// The residual forms score mult[q] * (qs[q] . bits[n]) + qb[q] (+ rowadd[n])
// (+ corr), qs int8 [Q, W8*32] with 0 on the pad dims: the SQ scan bodies of
// dot_scan.cuh (K1 / K2 / K9a, on the tensor cores) over 0/1 bytes that a
// PlaneRows loader expands from the planes into the swizzled wgmma tile, with
// the multiply-add rounded once (F24). They keep the BQ approx geometry
// (spans of SPAN * mxu_tile_n dense, SPAN * tile_n indexed), so their
// candidates are the BQ plain versions'. Bound on the H100: 2 * Q * rows *
// dims int8 operations at 1,979 TOPS (0.05 ms for 256 queries over 262,144
// rows of 768 dims, 0.25 ms over the serving plan's 1,255,424); K5a / K10
// run about 10 times that, K5b's radix select several times more (PERF.md).
//
// Layout, as in the JAX package: corpus sign bits as bit planes, u32
// [W8, npad] (word w of row n at planes[w * npad + n], LSB-first bit order),
// so neighbouring threads — neighbouring rows — read neighbouring words and
// every load of a warp is one 128-byte line. Queries are u32 [Q, W8].
//
// The sign-query kernels (K6, K5c, K5a, K10) compute, for query q and corpus
// row n, the XOR count over the
// true words wt = ceil(dim / 32) (bits past dim are zero on both sides)
//     x = sum_w popc(qwords[q][w] ^ planes[w][n])
// and the Hamming->metric map of ops/bq.py metric_from_xor:
//     score = sign * (dim - 2x),  sign = +1 for DOT or inverted L1/L2, else -1.
// Every value is an integer below 2^24, so the score is exact in f32 and
// equals the plain PyTorch version, and the JAX kernels' mult*(qs.bits) + qb,
// to the bit.
//
// What bounds the sign-query kernels on the H100: the main path's corpus is
// 1,000,000 x 1536
// bits, 192 MB of planes (57 us at 3.35 TB/s), and K6 writes a 1.0 GB score
// matrix (0.3 ms). The work is 256 x 1M x 48 = 1.2e10 popcounts per
// 256-query batch; the SM issues 16 popc per clock (the CUDA throughput
// table for compute capability 9.0), some 4.2e12/s over 132 SMs, so about
// 3 ms: these kernels are bound by popcount issue, not by memory. What the
// design does about it:
//   * a 32-query tile per block keeps the query words in shared memory,
//     read as 16-byte broadcasts (8 loads per 32 popc), and every corpus
//     word a thread loads serves 32 queries;
//   * the loop runs over the true word count, never the W8 padding;
//   * the searches never write the [Q, N] score matrix: K5c selects the
//     exact top-k of each 512-row split in shared memory (ktile.cuh), K5a
//     keeps one running maximum per stride class in registers.
// The +-1 x bits int8 tensor-core route of the TPU design (~0.4 ms of dense
// int8 peak at this shape) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_scan.cuh"

namespace {

constexpr int kBThreads = 256;  // 8 warps
constexpr int kBTQ = 32;        // queries per block

// qs[w * 32 + j] = word w of query q0 + j (0 for queries >= Q).
__device__ __forceinline__ void load_query_words(const uint32_t* __restrict__ qwords,
                                                 uint32_t* qs, int q0, int Q, int W8,
                                                 int wt) {
  for (int i = threadIdx.x; i < wt * kBTQ; i += blockDim.x) {
    const int w = i / kBTQ, j = i % kBTQ, q = q0 + j;
    qs[i] = q < Q ? qwords[(long long)q * W8 + w] : 0u;
  }
}

// acc[j] = XOR count of corpus row `row` against queries j0 .. j0+NQ-1 of
// the tile, over the wt true words.
template <int NQ>
__device__ __forceinline__ void xor_counts(const uint32_t* __restrict__ planes,
                                           const uint32_t* qs, long long npad,
                                           long long row, int wt, int j0,
                                           int acc[NQ]) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0;
  for (int w = 0; w < wt; ++w) {
    const uint32_t v = __ldg(planes + (long long)w * npad + row);
    const uint4* qv = reinterpret_cast<const uint4*>(qs + w * kBTQ + j0);
#pragma unroll
    for (int j4 = 0; j4 < NQ / 4; ++j4) {
      const uint4 a = qv[j4];
      acc[4 * j4 + 0] += __popc(a.x ^ v);
      acc[4 * j4 + 1] += __popc(a.y ^ v);
      acc[4 * j4 + 2] += __popc(a.z ^ v);
      acc[4 * j4 + 3] += __popc(a.w ^ v);
    }
  }
}

__device__ __forceinline__ float metric(int x, int dim, int sign) {
  return __int2float_rn(sign * (dim - 2 * x));
}

// ---------------------------------------------------------------- K6 scores
// grid (ceil(n_valid / 256), ceil(Q / 32)); one thread per corpus row.
// out f32 [Q, n_valid].
__global__ void __launch_bounds__(kBThreads) bq_scores_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ out, int Q, int W8, int wt, long long npad, int n_valid,
    int dim, int sign) {
  extern __shared__ __align__(16) uint32_t qs[];  // [wt][32]
  const int q0 = blockIdx.y * kBTQ;
  load_query_words(qwords, qs, q0, Q, W8, wt);
  __syncthreads();
  const long long row = (long long)blockIdx.x * kBThreads + threadIdx.x;
  if (row >= n_valid) return;
  int acc[kBTQ];
  xor_counts<kBTQ>(planes, qs, npad, row, wt, 0, acc);
#pragma unroll
  for (int j = 0; j < kBTQ; ++j) {
    const int q = q0 + j;
    if (q < Q) out[(long long)q * n_valid + row] = metric(acc[j], dim, sign);
  }
}

// ----------------------------------------------------------- K5c exact search
// grid (npad / split, ceil(Q / 32)). Block (s, t) scores rows
// [s*split, s*split + split) of its 32 queries into shared memory as ordered
// keys; then warp w selects the exact top-kk of queries 4w .. 4w+3 among the
// split's rows < n_valid and writes them, unordered, to cand_v / cand_i
// [Q, nsplit*kk] at columns s*kk .. s*kk+kk-1 (NEG / -1 past the valid rows).
__global__ void __launch_bounds__(kBThreads) bq_search_exact_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int W8, int wt,
    long long npad, int n_valid, int dim, int sign, int split, int kk) {
  extern __shared__ __align__(16) uint32_t smem_b[];
  unsigned* keys = smem_b;                   // [32][split]
  unsigned* hist_all = keys + kBTQ * split;  // [8][256]
  uint32_t* qs = hist_all + 8 * 256;         // [wt][32]
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kBTQ;
  const long long start = (long long)blockIdx.x * split;
  load_query_words(qwords, qs, q0, Q, W8, wt);
  __syncthreads();

  const long long valid = (long long)n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < split ? valid : split));
  for (int e = threadIdx.x; e < cnt; e += kBThreads) {
    int acc[kBTQ];
    xor_counts<kBTQ>(planes, qs, npad, start + e, wt, 0, acc);
#pragma unroll
    for (int j = 0; j < kBTQ; ++j)
      keys[j * split + e] = float_to_key(metric(acc[j], dim, sign));
  }
  __syncthreads();  // every thread wrote keys of every query

  const long long width = (long long)gridDim.x * kk;
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blockIdx.x * kk;
    warp_select_topk(keys + (warp * 4 + j) * split, cnt, kk, start, cand_v + o,
                     cand_i + o, hist_all + warp * 256);
  }
}

// ---------------------------------------------------------- K5a approx search
// K10 is the same kernel over selected tiles (map.sel; bq_search_indexed,
// bq_kernel.py:328 of the JAX package): the IVF probe's plane columns are
// read in place, and the bound is the selected rows' popcounts.
// Pass 1, grid (ceil(ncomp / part), ceil(Q / 32)). Thread (l, h) owns stride
// class l = tid % 128 for queries 16h .. 16h+15 of the tile and keeps, over
// compact rows p*part + m*128 + l in order, the running maximum and its
// corpus row (strict ">": the first row wins ties, as the Pallas kernel's
// compares do). Compact rows >= n_valid score NEG (bq_kernel.py:149).
// part_v / part_i: [Q, nparts*128]. Pass 2 is ktile.cuh's in-order combine
// per span block.
__global__ void __launch_bounds__(kBThreads) bq_approx_parts_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int W8, int wt,
    long long npad, int n_valid, int dim, int sign, int part, long long ncomp,
    ScanMap map) {
  constexpr int kHalf = kBTQ / 2;
  extern __shared__ __align__(16) uint32_t qs_a[];  // [wt][32]
  const int l = threadIdx.x & (kSlot - 1), h = threadIdx.x / kSlot;
  const int q0 = blockIdx.y * kBTQ;
  const long long start = (long long)blockIdx.x * part;
  load_query_words(qwords, qs_a, q0, Q, W8, wt);
  __syncthreads();
  float best[kHalf];
  int arg[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    best[j] = -__int_as_float(0x7f800000);  // -inf: any score beats it
    arg[j] = -1;
  }
  for (int off = 0; off < part && start + off < ncomp; off += kSlot) {
    const long long c = start + off + l, row = map.row(c);
    if (c < n_valid) {
      int acc[kHalf];
      xor_counts<kHalf>(planes, qs_a, npad, row, wt, h * kHalf, acc);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float s = metric(acc[j], dim, sign);
        if (s > best[j]) {
          best[j] = s;
          arg[j] = (int)row;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (kNeg > best[j]) {
          best[j] = kNeg;
          arg[j] = (int)row;
        }
      }
    }
  }
  const long long width = (long long)gridDim.x * kSlot;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int q = q0 + h * kHalf + j;
    if (q < Q) {
      const long long c = (long long)q * width + (long long)blockIdx.x * kSlot + l;
      part_v[c] = best[j];
      part_i[c] = arg[j];
    }
  }
}

inline size_t qs_bytes(int wt) { return sizeof(uint32_t) * (size_t)wt * kBTQ; }

}  // namespace

// ------------------------------------------------------------- C interface
// Every function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Shapes are checked by the Python wrappers
// (ops/kernels/bq_kernel.py): contiguous u32 tensors, npad % 2048 == 0,
// 1 <= wt <= W8, wt <= 1024.

extern "C" {

int qtt_bq_scores(const void* qwords, const void* planes, void* out, int Q,
                  int W8, int wt, long long npad, int n_valid, int dim, int sign,
                  void* stream) {
  const size_t smem = qs_bytes(wt);
  cudaError_t err = cudaFuncSetAttribute(
      bq_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_valid + kBThreads - 1) / kBThreads, (Q + kBTQ - 1) / kBTQ);
  bq_scores_kernel<<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(out), Q, W8, wt, npad, n_valid, dim, sign);
  return static_cast<int>(cudaGetLastError());
}

int qtt_bq_search_exact(const void* qwords, const void* planes, void* cand_v,
                        void* cand_i, int Q, int W8, int wt, long long npad,
                        int n_valid, int dim, int sign, int split, int kk,
                        void* stream) {
  const size_t smem =
      sizeof(unsigned) * ((size_t)kBTQ * split + 8 * 256) + qs_bytes(wt);
  cudaError_t err = cudaFuncSetAttribute(
      bq_search_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((npad + split - 1) / split), (Q + kBTQ - 1) / kBTQ);
  bq_search_exact_kernel<<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, W8, wt, npad,
      n_valid, dim, sign, split, kk);
  return static_cast<int>(cudaGetLastError());
}

// qtt_bq_search_approx scans ncomp compact rows: sel null for a dense scan
// (ncomp = npad), else T selected tiles of tile_n rows, a multiple of 512
// (K10; ncomp = T * tile_n).
int qtt_bq_search_approx(const void* qwords, const void* planes, void* part_v,
                         void* part_i, void* out_v, void* out_i, int Q, int W8,
                         int wt, long long npad, int n_valid, int dim, int sign,
                         int part, int span_rows, const void* sel, int tile_n,
                         long long ncomp, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = qs_bytes(wt);
  cudaError_t err = cudaFuncSetAttribute(
      bq_approx_parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nparts = (int)((ncomp + part - 1) / part);
  const dim3 grid(nparts, (Q + kBTQ - 1) / kBTQ);
  bq_approx_parts_kernel<<<grid, kBThreads, smem, s>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, W8, wt, npad,
      n_valid, dim, sign, part, ncomp, scan_map(sel, tile_n, nullptr, 0, 0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_approx_combine(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, nparts,
      span_rows / part, s));
}

// The residual forms (K5b, and K5a / K10 with a value query): qs int8
// [Q, W8*32], qb f32 [Q], mult f32 [1] or [Q] (mstride 0 / 1), rowadd f32
// [npad] by corpus row (residual IVF-BQ's NEG on pad slots, 0 elsewhere; in
// the epilogue's voff place, never null); the scan map as the SQ searches
// take it (sel null: dense, ncomp = npad; corr null: no additive).
int qtt_bq_search_exact_res(const void* qs, const void* qb, const void* mult,
                            const void* planes, const void* rowadd, void* cand_v,
                            void* cand_i, int Q, int W8, long long npad, int ncomp,
                            int n_valid, int split, int kk, int mstride, const void* sel,
                            int tile_n, const void* corr, long long corr_qs,
                            long long corr_bs, void* stream) {
  return static_cast<int>(launch_search_exact<PlaneRows, true>(
      planes, npad, qs, qb, mult, rowadd, cand_v, cand_i, Q, ncomp, n_valid, W8 * 32, split,
      kk, mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs), static_cast<cudaStream_t>(stream)));
}

int qtt_bq_search_approx_res(const void* qs, const void* qb, const void* mult,
                             const void* planes, const void* rowadd, void* part_v,
                             void* part_i, void* out_v, void* out_i, int Q, int W8,
                             long long npad, int ncomp, int n_valid, int part,
                             int span_rows, int mstride, const void* sel, int tile_n,
                             const void* corr, long long corr_qs, long long corr_bs,
                             void* stream) {
  return static_cast<int>(launch_search_approx<PlaneRows, true>(
      planes, npad, qs, qb, mult, rowadd, part_v, part_i, out_v, out_i, Q, ncomp, n_valid,
      W8 * 32, part, span_rows, mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
