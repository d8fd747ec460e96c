// Product-quantization scoring and fused search kernels for Hopper (sm_90a):
// the templates, shared by pq_kernels.cu (8-bit codes, KC = 256, and the C
// interface) and pq4_kernels.cu (4-bit codes, KC = 16), two translation units
// that nvcc compiles in parallel.
//
// Replaces the Pallas kernels of quantization_tpu/ops/pallas/pq_kernel.py:
//   K8  qtt_pq_scores        <- pq_scores_pallas, int8 LUT (_make_scores_kernel_i8,
//                               pq_kernel.py:943) and bf16 LUT (_make_scores_kernel,
//                               :962), which compute one [Q, n_valid] function
//   K7b qtt_pq_search_exact  <- pq_search_pallas(mode="exact") /
//                               _make_pq_class_kernel (pq_kernel.py:866)
//   K7a qtt_pq_search_approx <- pq_search_pallas(mode="approx") /
//                               _make_pq_topk_kernel (pq_kernel.py:791)
//   K11 qtt_pq_search_approx with a tile selection <- pq_search_indexed /
//                               _make_pq_topk_kernel_indexed (pq_kernel.py:582)
// Which launches run here: every K7b and K11; K8 and K7a with the bf16 or
// bf16x2 LUT or 8-bit codes. K8 and the dense K7a with 4-bit codes and the
// int8 LUT run as one-hot products on the tensor-core scan body instead
// (pq4_mma_kernels.cu, dot_scan.cuh NibbleRows); the wrapper
// (ops/kernels/pq_kernel.py onehot_route) picks the route.
//
// All compute, for query q and corpus row n,
//     acc = sum over chunks c in order 0 .. mpad-1 of lut[q][c][codes_t[c][n] & (KC-1)]
// (for 4-bit codes in groups of 8 chunks, each group summed first, in pairs,
// and then added, as the JAX kernel adds one block-diagonal matmul of 8
// chunks)
// from a LUT the wrapper (ops/kernels/pq_kernel.py) has already put in its
// working type, as the JAX package does before its pallas_call:
//   * int8:   entries int8, acc an exact int32 sum (|acc| <= 127 * mpad), then
//             score = f32(f64(scale[q]) * acc + f64(bias[q])): one rounding, as
//             the JAX package's compiled epilogue rounds (a fused multiply-add);
//   * bf16:   entries bf16, acc an f32 sum starting at 0.0;
//   * bf16x2: (search only) entries hi + lo / 256, two f32 sums, the lo sum
//             folded into acc as acc + lo * (1/256) at the end of every block
//             of 16 chunks (_accumulate_block_x2, pq_kernel.py:248-267).
// Each step rounds on its own (the _rn intrinsics, and the library is built
// with -fmad=false), in the plain PyTorch version's order, so the kernels
// equal it to the bit. KC is 256 (8-bit codes) or 16 (4-bit codes).
//
// The TPU has no vector gather, so the Pallas kernels multiply the LUT by a
// one-hot matrix of the codes on the MXU (pq_kernel.py:1-37). A GPU gathers
// from shared memory, and that is what these kernels do:
//   * a block holds 32 queries, one per lane, and a tile of 512 corpus rows,
//     64 per warp; each thread keeps its query's 64 sums in registers;
//   * the LUT arrives pre-transposed, [query tile][chunk][code][32 queries],
//     and is staged into shared memory a few chunks at a time (64 KB), so the
//     32 lanes of a lookup read 32 neighbouring entries of one (chunk, code)
//     row: no bank conflicts, whatever the codes;
//   * the codes of the tile are staged chunk-major as bytes; a warp reads four
//     rows' codes of one chunk as one broadcast word.
// What bounds them on the H100, at the main path's 1M rows x 96 chunks and
// Q = 256: 2.46e10 lookups. Shared memory serves 128 bytes per clock per SM,
// so one 32-bit load of this layout could read one code's entries for 4
// int8 queries (2 bf16): the card's lookup bound is 0.73 ms for int8 entries
// and 1.47 ms for bf16, at 1.98 GHz on 132 SMs. This design makes one load
// per lookup, 32 lookups per clock per SM: its floor is 2.94 ms. The one-hot
// product on the int8 tensor cores would take 6.4 ms at 8 bits and 0.8 ms at
// 4 bits (192 chunks x 16 codes), where this design's floor is 5.9 ms. The
// codes (96 MB) stream in 0.03 ms; K8's 1 GB output takes 0.3 ms. The LUT
// is staged again for every 512-row
// tile: 786 KB (int8) to 3.1 MB (bf16x2) per tile and 32 queries, read from
// L2. A design that keeps the LUT resident for more rows is later work; the
// tensor-core route now takes 4-bit codes with the int8 LUT (K8 12.49 ->
// 2.23 ms, K7a 12.31 -> 3.27 ms at 1M x 192 chunks, Q = 256; NVIDIA H100
// 80GB HBM3, 700 W, scan_ab.py).
//
// The searches then add the residual-IVF terms, when given, in the JAX order
// (score + rowadd[n]) + corr[q, block of n], each add rounded once: rowadd
// carries the decoded |v^|^2 term and the pad mask, corr the bucket term
// (ktile.cuh ScanMap). K11 walks the IVF probe's selected tiles in place:
// only the probed buckets' codes are read, and its bound is the probed
// fraction of K7a's.
//
// Selection, as in the SQ and BQ kernels: K7b writes each 512-row split's
// scores as ordered keys in shared memory and selects their exact
// top-min(k, 512) (ktile.cuh); K7a keeps, per query and stride class, the
// first maximum over spans of 4096 rows (SPAN * TILE_N of the JAX kernel),
// rows >= n_valid scoring NEG.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ktile.cuh"

namespace {

constexpr int kPThreads = 256;                   // 8 warps
constexpr int kPTQ = 32;                         // queries per block, one per lane
constexpr int kPTR = 512;                        // corpus rows per tile
constexpr int kPRW = kPTR / (kPThreads / 32);    // 64 rows per warp
constexpr int kMBlk = 16;                        // M_BLK: Mpad alignment, bf16x2 fold
constexpr int kLutBytes = 65536;                 // one staged LUT block
constexpr int kStride = kPTR + 1;                // staging row stride in words
constexpr int kStageBytes = kPTQ * kStride * 4;  // [32][513] f32 scores or keys
constexpr int kRegionBytes = kStageBytes > kLutBytes ? kStageBytes : kLutBytes;
constexpr int kCodesBytes = kMBlk * kPTR;        // [<=16 chunks][512 rows] codes
constexpr int kApproxPart = 4096;                // dense K7a part: SPAN * TILE_N

enum { kInt8 = 0, kBf16 = 1, kBf16x2 = 2 };

template <int KIND>
using LutWord = typename std::conditional<
    KIND == kInt8, int8_t,
    typename std::conditional<KIND == kBf16, uint16_t, uint32_t>::type>::type;

// Chunks staged per LUT block: as many as fit 64 KB, at most 16 (then they
// divide every Mpad, a multiple of 16).
template <int KC, int KIND>
struct Staging {
  static constexpr int kFit = kLutBytes / (KC * kPTQ * (int)sizeof(LutWord<KIND>));
  static constexpr int kChunks = kFit < kMBlk ? kFit : kMBlk;
};

template <int KIND>
struct Accum {
  using A = typename std::conditional<KIND == kInt8, int, float>::type;
  A v[kPRW];
  float lo[KIND == kBf16x2 ? kPRW : 1];
};

__device__ __forceinline__ int add_rn(int a, int b) { return a + b; }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// Adds entry x, the cc-th chunk of a group of G, to the group's sum gs:
// with G = 8 (4-bit codes) the chunks go in pairs (pr) and the pairs in
// order, ((x0 + x1) + (x2 + x3)) + ..., the order of the JAX package's CPU
// dot over one block-diagonal group (ROADMAP Queue 3, F19).
template <int G, typename A>
__device__ __forceinline__ void group_add(int cc, A& gs, A& pr, A x) {
  if constexpr (G == 1) {
    gs = x;
  } else if (cc % 2 == 0) {
    pr = x;
  } else {
    pr = add_rn(pr, x);
    gs = cc == 1 ? pr : add_rn(gs, pr);
  }
}

// The tile's sums for the lane's query over compact rows row0 + 64 * warp ..
// + 63 (corpus rows through map: 16 consecutive compact rows lie in one
// selected tile). lut points at this block's query tile, [mpad][KC][32]
// words. Every thread of the block must call it (it synchronises).
template <int KC, int KIND>
__device__ __forceinline__ void score_tile(const LutWord<KIND>* __restrict__ lut,
                                           const uint8_t* __restrict__ codes_t,
                                           long long npad, int mpad, long long row0,
                                           const ScanMap& map, uint8_t* region,
                                           uint8_t* codes_s, Accum<KIND>& acc) {
  using T = LutWord<KIND>;
  constexpr int MB = Staging<KC, KIND>::kChunks;
  // Chunks summed on their own before they join acc: 8 for 4-bit codes, as
  // the JAX kernel adds one block-diagonal matmul of 8 chunks at a time.
  constexpr int G = KC == 16 ? 8 : 1;
  static_assert(MB % G == 0, "a staged LUT block holds whole groups");
  constexpr int kLutVec = MB * KC * kPTQ * (int)sizeof(T) / 16;
  constexpr int kRowVec = kPTR / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* lut_s = reinterpret_cast<const T*>(region);
#pragma unroll
  for (int r = 0; r < kPRW; ++r) {
    acc.v[r] = 0;
    if constexpr (KIND == kBf16x2) acc.lo[r] = 0.0f;
  }
  for (int c0 = 0; c0 < mpad; c0 += MB) {
    __syncthreads();  // the previous block's (or the caller's) readers are done
    const uint4* src = reinterpret_cast<const uint4*>(lut + (long long)c0 * KC * kPTQ);
    for (int i = tid; i < kLutVec; i += kPThreads)
      reinterpret_cast<uint4*>(region)[i] = __ldg(src + i);
    for (int i = tid; i < MB * kRowVec; i += kPThreads) {
      const int c = i / kRowVec, v = i % kRowVec;
      reinterpret_cast<uint4*>(codes_s)[i] = __ldg(reinterpret_cast<const uint4*>(
          codes_t + (long long)(c0 + c) * npad + map.row(row0 + 16 * v)));
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < MB; c += G) {
#pragma unroll
      for (int j = 0; j < kPRW / 4; ++j) {
        // The group's sums of 4 rows (gs; gl of the lo words): chunks in
        // pairs (pr, pl), then the pairs in order.
        typename Accum<KIND>::A gs[4], pr[4];
        [[maybe_unused]] float gl[4], pl[4];
#pragma unroll
        for (int cc = 0; cc < G; ++cc) {
          const T* lc = lut_s + (c + cc) * KC * kPTQ + lane;
          // codes of 4 rows of one chunk: one broadcast load
          const uint32_t w = reinterpret_cast<const uint32_t*>(
              codes_s + (c + cc) * kPTR + warp * kPRW)[j];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const T e = lc[((w >> (8 * b)) & (KC - 1)) * kPTQ];
            if constexpr (KIND == kInt8) {
              group_add<G>(cc, gs[b], pr[b], (int)e);
            } else if constexpr (KIND == kBf16) {
              group_add<G>(cc, gs[b], pr[b], __uint_as_float((uint32_t)e << 16));
            } else {  // word = hi bf16 in the high half, lo bf16 in the low half
              group_add<G>(cc, gs[b], pr[b], __uint_as_float(e & 0xffff0000u));
              group_add<G>(cc, gl[b], pl[b], __uint_as_float(e << 16));
            }
          }
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = 4 * j + b;
          if constexpr (KIND == kInt8) {
            acc.v[r] += gs[b];
          } else {
            acc.v[r] = __fadd_rn(acc.v[r], gs[b]);
            if constexpr (KIND == kBf16x2) acc.lo[r] = __fadd_rn(acc.lo[r], gl[b]);
          }
        }
      }
      if constexpr (KIND == kBf16x2) {
        if ((c0 + c + G) % kMBlk == 0) {
#pragma unroll
          for (int r = 0; r < kPRW; ++r) {
            acc.v[r] = __fadd_rn(acc.v[r], __fmul_rn(acc.lo[r], 1.0f / 256.0f));
            acc.lo[r] = 0.0f;
          }
        }
      }
    }
  }
}

// The score of sum r: the int8 affine in f64 rounded once, else the sum.
template <int KIND>
__device__ __forceinline__ float finish(const Accum<KIND>& acc, int r, float scale,
                                        float bias) {
  if constexpr (KIND == kInt8) {
    return __double2float_rn(
        __dadd_rn(__dmul_rn((double)scale, (double)acc.v[r]), (double)bias));
  } else {
    return acc.v[r];
  }
}

struct TileArgs {
  const void* lut;      // [ceil(Q/32)][mpad][KC][32] words
  const float* scale;   // int8: [Q]
  const float* bias;    // int8: [Q]
  const uint8_t* codes_t;  // [mpad][npad]
  int Q;
  int mpad;
  long long npad;
  int n_valid;          // compact rows >= n_valid are masked (approx) or skipped
  long long ncomp;      // compact rows scanned: npad, or T * tile_n padded to 512
  int part;             // approx: compact rows per block, SPAN * tile_n
  const float* rowadd;  // per corpus row additive [npad], or null
  ScanMap map;          // selected tiles and corr (ktile.cuh)
};

// Every PQ launch's arguments: sel null for a dense scan over npad rows,
// rowadd and corr null for no additive.
inline TileArgs tile_args(const void* lut, const void* scale, const void* bias,
                          const void* codes_t, int Q, int mpad, long long npad, int n_valid,
                          const void* rowadd, const void* corr, long long corr_qs,
                          long long corr_bs, const void* sel, int tile_n, long long ncomp,
                          int part) {
  return TileArgs{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid, ncomp, part,
                  static_cast<const float*>(rowadd),
                  scan_map(sel, tile_n, corr, corr_qs, corr_bs)};
}

template <int KC, int KIND>
__device__ __forceinline__ const LutWord<KIND>* tile_lut(const TileArgs& a) {
  return static_cast<const LutWord<KIND>*>(a.lut) +
         (long long)blockIdx.y * a.mpad * KC * kPTQ;
}

// Writes the lane's 64 scores of the tile to stage[lane][64 * warp + r];
// with mask, compact rows >= n_valid score NEG instead.
template <int KIND>
__device__ __forceinline__ void stage_scores(const TileArgs& a, const Accum<KIND>& acc,
                                             float* stage, long long row0, bool mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.y * kPTQ + lane;
  float scale = 0.0f, bias = 0.0f;
  if constexpr (KIND == kInt8) {
    if (q < a.Q) {
      scale = a.scale[q];
      bias = a.bias[q];
    }
  }
#pragma unroll
  for (int r = 0; r < kPRW; ++r) {
    const int e = warp * kPRW + r;
    float s = finish<KIND>(acc, r, scale, bias);
    if (mask && row0 + e >= a.n_valid) s = kNeg;
    stage[lane * kStride + e] = s;
  }
}

// The residual terms of a staged tile, when the launch has them: stage[j][e]
// (query q0 + j, compact row row0 + e) becomes (s + rowadd[corpus row]) +
// corr, each add rounded once, in the JAX order (pq_kernel.py:397); rows
// masked NEG stay NEG. A pass of its own, outside the unrolled staging loop,
// so a launch without the additives runs the dense kernel's code. Called by
// every thread between barriers; returns whether it changed the stage.
__device__ __forceinline__ bool add_residual(const TileArgs& a, float* stage,
                                             long long row0, bool mask) {
  if (!a.rowadd) return false;  // the additives come as a pair
  for (int i = threadIdx.x; i < kPTQ * kPTR; i += kPThreads) {
    const int j = i / kPTR, e = i % kPTR;
    const long long c = row0 + e;
    if (mask && c >= a.n_valid) continue;
    const int q = min((int)blockIdx.y * kPTQ + j, a.Q - 1);  // lanes past Q are never kept
    const float s = __fadd_rn(stage[j * kStride + e], a.rowadd[a.map.row(c)]);
    stage[j * kStride + e] = a.map.add_corr(s, q, c);
  }
  return true;
}

// ---------------------------------------------------------------- K8 scores
// grid (ceil(n_valid / 512), ceil(Q / 32)); out f32 [Q, n_valid].
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads) pq_scores_kernel(TileArgs a, float* out) {
  extern __shared__ __align__(16) uint8_t smem_p[];
  uint8_t* region = smem_p;
  const long long row0 = (long long)blockIdx.x * kPTR;
  const int q0 = blockIdx.y * kPTQ;
  Accum<KIND> acc;
  score_tile<KC, KIND>(tile_lut<KC, KIND>(a), a.codes_t, a.npad, a.mpad, row0, a.map,
                       region, smem_p + kRegionBytes, acc);
  __syncthreads();  // every warp is done with the staged LUT
  float* stage = reinterpret_cast<float*>(region);
  stage_scores<KIND>(a, acc, stage, row0, false);
  __syncthreads();
  for (int i = threadIdx.x; i < kPTQ * kPTR; i += kPThreads) {
    const int j = i / kPTR, e = i % kPTR;
    const long long row = row0 + e;
    if (q0 + j < a.Q && row < a.n_valid)
      out[(long long)(q0 + j) * a.n_valid + row] = stage[j * kStride + e];
  }
}

// ----------------------------------------------------------- K7b exact search
// grid (npad / 512, ceil(Q / 32)). Block (s, t) scores split s of its 32
// queries into shared memory as ordered keys; warp w then selects the exact
// top-kk of queries 4w .. 4w+3 among the split's rows < n_valid and writes
// them, unordered, to cand_v / cand_i [Q, nsplit*kk] at columns s*kk ..
// s*kk+kk-1 (NEG / -1 past the valid rows).
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads) pq_search_exact_kernel(TileArgs a,
                                                                     float* cand_v,
                                                                     int* cand_i, int kk) {
  extern __shared__ __align__(16) uint8_t smem_p[];
  uint8_t* region = smem_p;
  unsigned* hist_all = reinterpret_cast<unsigned*>(smem_p + kRegionBytes + kCodesBytes);
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * kPTR;
  const int q0 = blockIdx.y * kPTQ;
  const long long valid = (long long)a.n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < kPTR ? valid : kPTR));
  unsigned* keys = reinterpret_cast<unsigned*>(region);
  if (cnt > 0) {  // the same for every thread of the block
    Accum<KIND> acc;
    score_tile<KC, KIND>(tile_lut<KC, KIND>(a), a.codes_t, a.npad, a.mpad, start, a.map,
                         region, smem_p + kRegionBytes, acc);
    __syncthreads();
    stage_scores<KIND>(a, acc, reinterpret_cast<float*>(region), start, false);
    __syncthreads();
    if (add_residual(a, reinterpret_cast<float*>(region), start, false)) __syncthreads();
    for (int i = threadIdx.x; i < kPTQ * kPTR; i += kPThreads) {
      const int j = i / kPTR, e = i % kPTR;
      keys[j * kStride + e] = float_to_key(reinterpret_cast<float*>(region)[j * kStride + e]);
    }
    __syncthreads();
  }
  const long long width = (long long)gridDim.x * kk;
  for (int j = 0; j < 4; ++j) {
    const int ql = warp * 4 + j, q = q0 + ql;
    if (q >= a.Q) break;
    const long long o = (long long)q * width + (long long)blockIdx.x * kk;
    warp_select_topk(keys + ql * kStride, cnt, kk, start, cand_v + o, cand_i + o,
                     hist_all + warp * 256);
  }
}

// ---------------------------------------------------------- K7a approx search
// K11 is the same kernel over selected tiles (a.map.sel; pq_search_indexed,
// pq_kernel.py:582 of the JAX package), with part = SPAN * tile_n.
// grid (ceil(ncomp / part), ceil(Q / 32)). Block b walks the 512-row tiles of
// compact rows [part b, part b + part) in order; thread t keeps, for the 16
// (query, stride class) pairs t + 256 p, the running maximum over compact
// rows part b + 128 m + l and its corpus row (strict ">": the first row wins
// ties, as the Pallas kernel's compares do). A 128-row class segment lies in
// one selected tile. out_v / out_i: [Q, nblocks*128].
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads) pq_search_approx_kernel(TileArgs a,
                                                                      float* out_v,
                                                                      int* out_i) {
  constexpr int kPairs = kPTQ * kSlot / kPThreads;
  extern __shared__ __align__(16) uint8_t smem_p[];
  uint8_t* region = smem_p;
  const float* stage = reinterpret_cast<const float*>(region);
  const long long part0 = (long long)blockIdx.x * a.part;
  const int q0 = blockIdx.y * kPTQ;
  float best[kPairs];
  int arg[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    best[p] = -__int_as_float(0x7f800000);  // -inf: any score beats it
    arg[p] = -1;
  }
  for (long long row0 = part0; row0 < part0 + a.part && row0 < a.ncomp; row0 += kPTR) {
    Accum<KIND> acc;
    // score_tile begins with a barrier: the previous tile's stage is read.
    score_tile<KC, KIND>(tile_lut<KC, KIND>(a), a.codes_t, a.npad, a.mpad, row0, a.map,
                         region, smem_p + kRegionBytes, acc);
    __syncthreads();
    stage_scores<KIND>(a, acc, reinterpret_cast<float*>(region), row0, true);
    __syncthreads();
    if (add_residual(a, reinterpret_cast<float*>(region), row0, true)) __syncthreads();
    int seg[kPTR / kSlot];  // corpus row of each 128-row class segment
#pragma unroll
    for (int s = 0; s < kPTR / kSlot; ++s) seg[s] = (int)a.map.row(row0 + s * kSlot);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int idx = threadIdx.x + p * kPThreads, ql = idx / kSlot, l = idx % kSlot;
#pragma unroll
      for (int s = 0; s < kPTR / kSlot; ++s) {
        const float v = stage[ql * kStride + s * kSlot + l];
        if (v > best[p]) {
          best[p] = v;
          arg[p] = seg[s] + l;
        }
      }
    }
  }
  const long long width = (long long)gridDim.x * kSlot;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int idx = threadIdx.x + p * kPThreads, ql = idx / kSlot, l = idx % kSlot;
    const int q = q0 + ql;
    if (q < a.Q) {
      const long long c = (long long)q * width + (long long)blockIdx.x * kSlot + l;
      out_v[c] = best[p];
      out_i[c] = arg[p];
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline unsigned query_tiles(int Q) { return (unsigned)((Q + kPTQ - 1) / kPTQ); }

template <int KC, int KIND>
int launch_scores(const TileArgs& a, void* out, cudaStream_t s) {
  const size_t smem = kRegionBytes + kCodesBytes;
  cudaError_t err = prepare(pq_scores_kernel<KC, KIND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((a.n_valid + kPTR - 1) / kPTR), query_tiles(a.Q));
  pq_scores_kernel<KC, KIND><<<grid, kPThreads, smem, s>>>(a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int KC, int KIND>
int launch_exact(const TileArgs& a, void* cand_v, void* cand_i, int kk, cudaStream_t s) {
  const size_t smem = kRegionBytes + kCodesBytes + sizeof(unsigned) * 8 * 256;
  cudaError_t err = prepare(pq_search_exact_kernel<KC, KIND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(a.ncomp / kPTR), query_tiles(a.Q));
  pq_search_exact_kernel<KC, KIND><<<grid, kPThreads, smem, s>>>(
      a, static_cast<float*>(cand_v), static_cast<int*>(cand_i), kk);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, int KIND>
int launch_approx(const TileArgs& a, void* out_v, void* out_i, cudaStream_t s) {
  const size_t smem = kRegionBytes + kCodesBytes;
  cudaError_t err = prepare(pq_search_approx_kernel<KC, KIND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((a.ncomp + a.part - 1) / a.part), query_tiles(a.Q));
  pq_search_approx_kernel<KC, KIND><<<grid, kPThreads, smem, s>>>(
      a, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch of FN<KC, kind>, or cudaErrorInvalidValue for an unknown kind.
#define QTT_PQ_KIND_DISPATCH(FN, KC, ...)                     \
  switch (kind) {                                             \
    case kInt8: return FN<KC, kInt8>(__VA_ARGS__);            \
    case kBf16: return FN<KC, kBf16>(__VA_ARGS__);            \
    case kBf16x2: return FN<KC, kBf16x2>(__VA_ARGS__);        \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }
