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
// Which launches run here: those with the bf16 or bf16x2 LUT or 8-bit
// codes, but K8 with 4-bit codes. With 4-bit codes and the int8 LUT, K8,
// K7a, K7b and K11 run as one-hot products on the tensor-core scan body
// instead (pq4_mma_kernels.cu, dot_scan.cuh NibbleRows), and so does K8 with
// 4-bit codes and the bf16 LUT (pq4_mma_kernels.cu, one-hot bf16 products
// summed in this body's order); the wrapper (ops/kernels/pq_kernel.py
// onehot_route, bf16_onehot_route) picks the route.
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
//     and is staged into shared memory a few chunks at a time, so the 32
//     lanes of a lookup read 32 neighbouring entries of one (chunk, code)
//     row: no bank conflicts, whatever the codes;
//   * the codes of the tile are staged chunk-major as bytes; a warp reads four
//     rows' codes of one chunk as one broadcast word;
//   * the kernels (K8, K7b, K7a, K11) stage both through a ring of bulk
//     copies completing on mbarriers, each stage refilled by the last warp
//     done with it (see "the ring" below), but K7b with 8-bit codes and the
//     int8 LUT, which the ring leaves slower: it stages them synchronously
//     through registers (score_tile).
// What bounds them on the H100, at the main path's 1M rows x 96 chunks and
// Q = 256: 2.46e10 lookups. Shared memory serves 128 bytes per clock per SM,
// so one 32-bit load of this layout could read one code's entries for 4
// int8 queries (2 bf16): the card's lookup bound is 0.73 ms for int8 entries
// and 1.47 ms for bf16, at 1.98 GHz on 132 SMs. This design makes one load
// per lookup, 32 lookups per clock per SM: its floor is 2.94 ms. The one-hot
// product on the int8 tensor cores would take 6.4 ms at 8 bits and 0.8 ms at
// 4 bits (192 chunks x 16 codes), where this design's floor is 5.9 ms. The
// codes (96 MB) stream in 0.03 ms; K8's 1 GB output takes 0.3 ms. The LUT
// is staged again for every 512-row tile: 786 KB (int8) to 3.1 MB (bf16x2)
// per tile and 32 queries, read from L2 (~12.9 GB a K11 launch at bf16x2,
// 262,144 rows, m = 96, Q = 256). What binds is the lookup loop itself: one
// chunk's 64 lookups a thread take ~265 instructions for int8 entries, ~400
// for bf16 and ~692 for bf16x2 (its lo fold included; chip_smoke.py counts
// them in the SASS), and with one block of 8 warps per SM (their 64 sums a
// thread need the registers) the loads' latency shows. The synchronous
// staging this ring replaced (through registers, two barriers a LUT block,
// no overlap) ran K11 bf16x2 at 5.45 ms against the ring's 3.83 and the
// 8-bit bf16 / bf16x2 K7a a third slower. Multicasting each stage's LUT over a cluster of 2 blocks halved
// the L2 reads and ran slower on every launch (K11 bf16x2 5.06 ms, K7b
// 8-bit bf16x2 24.36 against 15.95): each stage then waits for the
// slower block. (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py; PERF.md.)
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
constexpr int kLutBytes = 65536;                 // one staged LUT block (score_tile)
constexpr int kStride = kPTR + 1;                // score stage row stride in words
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

// Chunks summed on their own before they join acc: 8 for 4-bit codes, as
// the JAX kernel adds one block-diagonal matmul of 8 chunks at a time.
template <int KC>
constexpr int kGroup = KC == 16 ? 8 : 1;

// Adds the group of chunks c .. c + G - 1 of a staged block to the lane's 64
// sums: lut_s [chunks][KC][32] words, codes_s [chunks][512] row codes (the
// warp's rows at 64 * warp ..). Every search and K8 sum through it, in this
// order, which is the plain version's.
template <int KC, int KIND>
__device__ __forceinline__ void add_group(const LutWord<KIND>* lut_s, const uint8_t* codes_s,
                                          int c, Accum<KIND>& acc) {
  using T = LutWord<KIND>;
  constexpr int G = kGroup<KC>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
      const uint32_t w =
          reinterpret_cast<const uint32_t*>(codes_s + (c + cc) * kPTR + warp * kPRW)[j];
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
}

template <int KIND>
__device__ __forceinline__ void zero_acc(Accum<KIND>& acc) {
#pragma unroll
  for (int r = 0; r < kPRW; ++r) {
    acc.v[r] = 0;
    if constexpr (KIND == kBf16x2) acc.lo[r] = 0.0f;
  }
}

// bf16x2: the lo sums folded into acc at the end of every block of 16
// chunks, once chunks .. c_end - 1 are summed.
template <int KIND>
__device__ __forceinline__ void fold_lo(Accum<KIND>& acc, int c_end) {
  if constexpr (KIND == kBf16x2) {
    if (c_end % kMBlk == 0) {
#pragma unroll
      for (int r = 0; r < kPRW; ++r) {
        acc.v[r] = __fadd_rn(acc.v[r], __fmul_rn(acc.lo[r], 1.0f / 256.0f));
        acc.lo[r] = 0.0f;
      }
    }
  }
}

// The tile's sums for the lane's query over compact rows row0 + 64 * warp ..
// + 63 (corpus rows through map: 16 consecutive compact rows lie in one
// selected tile). lut points at this block's query tile, [mpad][KC][32]
// words. Every thread of the block must call it (it synchronises).
// Only K7b with 8-bit codes and the int8 LUT stages through it,
// synchronously (registers, st.shared, two barriers a LUT block): the ring
// below ran that launch slower (see pq_search_exact_staged_kernel).
template <int KC, int KIND>
__device__ __forceinline__ void score_tile(const LutWord<KIND>* __restrict__ lut,
                                           const uint8_t* __restrict__ codes_t,
                                           long long npad, int mpad, long long row0,
                                           const ScanMap& map, uint8_t* region,
                                           uint8_t* codes_s, Accum<KIND>& acc) {
  using T = LutWord<KIND>;
  constexpr int MB = Staging<KC, KIND>::kChunks;
  constexpr int G = kGroup<KC>;
  static_assert(MB % G == 0, "a staged LUT block holds whole groups");
  constexpr int kLutVec = MB * KC * kPTQ * (int)sizeof(T) / 16;
  constexpr int kRowVec = kPTR / 16;
  const int tid = threadIdx.x;
  const T* lut_s = reinterpret_cast<const T*>(region);
  zero_acc<KIND>(acc);
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
      add_group<KC, KIND>(lut_s, codes_s, c, acc);
      fold_lo<KIND>(acc, c0 + c + G);
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

// ---------------------------------------------------------------- the ring
// K8, K7b and K7a / K11 stream the LUT through a ring of stages (Ring) in
// shared memory, fed by bulk copies (cp.async.bulk, TMA without a tensor
// map) that complete on an mbarrier. A stage holds Ring::kChunks chunks: their LUT
// block of the query tile, [chunks][KC][32] words, contiguous in the
// kernels' layout and so one copy, and the tile's codes of those chunks,
// [chunks][512] bytes, one copy per run of consecutive corpus rows (512
// dense; with a selection the largest of 512 / 256 / 128 dividing tile_n,
// since a 128-row aligned run of compact rows lies in one selected tile).
// A block walks its tiles' stages in order (stage j: tile j / per_tile,
// chunks (j % per_tile) * kChunks ..), across tiles too. Warp 0 issues the
// first kStages stages; after that, the warp that releases a stage last
// (a per-stage count of releasing warps in shared memory) refills it with
// stage j + kStages, so no warp waits for another to free a stage and
// the block needs no producer warp (a ninth warp capped ptxas at 168
// registers, and the bf16x2 and 4-bit searches spilled). Every warp waits on
// a stage's full barrier, which completes once its bytes have landed. The
// approx searches' scores go through a stage of their own, so the next
// tile's LUT arrives while a tile's epilogue runs; K8's and K7b's reuse the
// ring (Ring, kExact). Each thread sums its rows in the plain version's
// order (add_group, fold_lo), so the sums equal its to the bit.
constexpr int kRingMaxStages = 4;
constexpr int kRingBarBytes = 128;            // full barriers and release counts
constexpr int kHistBytes = sizeof(unsigned) * (kPThreads / 32) * 256;

// A ring's geometry, chosen by timing the candidates in turns (NVIDIA H100
// 80GB HBM3, 700 W, scan_ab.py; PERF.md): every stage costs each warp a wait
// and a release, so 8-bit codes take few, large stages, as many chunks as
// fit 36 KB (K8, K7b: 3 stages) or 72 KB (K7a / K11: 2 stages; 4 stages of up to
// 36 KB ran K11 bf16x2 4.75 against 3.82 ms, K7a 8-bit int8 7.38 against
// 6.80), and 4-bit codes 4 stages of one group of 8 chunks (16-chunk stages
// ran K7b 4-bit bf16 19.27 against 15.70 ms).
// kExact: K8's and K7b's, whose score stage reuses the ring once its one
// tile is summed: a block's shared memory (74-110 KB) lets two blocks share an SM
// where the registers allow (every word but bf16x2), and the second
// block's lookups overlap the first's radix select (one block per SM, with
// a score stage of its own, took K7b 8-bit int8 from 7.06 to 10.26 ms).
// Else K7a / K11's, beside a score stage of its own (one block per SM:
// their registers allow no more), so that the next tile's stages arrive
// during a tile's epilogue.
template <int KC, int KIND, bool kExact>
struct Ring {
  static constexpr int kChunkLut = KC * kPTQ * (int)sizeof(LutWord<KIND>);
  static constexpr int kFit = (kExact ? 36 * 1024 : 72 * 1024) / (kChunkLut + kPTR);
  // Chunks per stage: a power of two, so it divides every Mpad (a multiple
  // of 16); one group of 8 with 4-bit codes.
  static constexpr int kChunks = KC == 16 ? kGroup<KC>
                                 : kFit >= 16 ? 16 : kFit >= 8 ? 8 : kFit >= 4 ? 4
                                 : kFit >= 2 ? 2 : 1;
  static constexpr int kStages = KC == 16 ? 4 : kExact ? 3 : 2;
  static constexpr int kLut = kChunks * kChunkLut;       // LUT bytes of a stage
  static constexpr int kStage = kLut + kChunks * kPTR;   // + the codes of its chunks
  static constexpr int kBytes = kStages * kStage;
  // Shared memory: barriers, the ring, the score stage (in the ring for
  // K7b) and K7b's select histograms.
  static constexpr int kSmem = kRingBarBytes +
                               (kExact ? (kBytes > kStageBytes ? kBytes : kStageBytes) + kHistBytes
                                       : kBytes + kStageBytes);
  static_assert(kChunks % kGroup<KC> == 0, "a stage holds whole groups");
  static_assert(kStages <= kRingMaxStages, "the barriers' room holds the stages'");
  static_assert(kSmem <= 232448, "the ring and the score stage fit the SM's shared memory");
  static_assert(!kExact || KIND == kBf16x2 || 2 * (kSmem + 1024) <= 233472,
                "two K7b blocks share an SM");
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The issuing warp's arrival, with the bytes the stage's copies will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global memory
// to shared memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A block's ring: the full barrier and the release count of each stage at
// the start of its shared memory, the stages after them, and the block's
// walk: tiles of 512 compact rows from row0, per_tile stages each, total
// stages in all.
template <int KC, int KIND, class R>
struct RingWalk {
  uint32_t bars;        // full[s] at bars + 8 s
  unsigned* released;   // [kStages] warps that released each stage, ever
  uint8_t* stages;
  long long row0;
  int per_tile, total;

  // Sets up the barriers and counts; every thread of the block calls it,
  // then warp 0 issues the first stages.
  __device__ __forceinline__ RingWalk(uint8_t* smem, const TileArgs& a, long long first_row,
                                      int tiles)
      : bars(shared_addr(smem)),
        released(reinterpret_cast<unsigned*>(smem + 8 * kRingMaxStages)),
        stages(smem + kRingBarBytes), row0(first_row), per_tile(a.mpad / R::kChunks),
        total(tiles * (a.mpad / R::kChunks)) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < R::kStages; ++s) {
        mbar_init(bars + 8 * s, 1);
        released[s] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32)
      for (int j = 0; j < R::kStages && j < total; ++j) issue(a, j);
  }

  // One warp: the copies of stage j into its slot.
  __device__ __forceinline__ void issue(const TileArgs& a, int j) const {
    const int lane = threadIdx.x & 31, slot = j % R::kStages;
    const uint32_t full = bars + 8 * slot, dst = shared_addr(stages + slot * R::kStage);
    const long long r0 = row0 + (long long)(j / per_tile) * kPTR;
    const int c0 = (j % per_tile) * R::kChunks;
    const int run = !a.map.sel || a.map.tile_n % 512 == 0 ? 512
                    : a.map.tile_n % 256 == 0            ? 256
                                                         : 128;
    const int nruns = kPTR / run;
    if (lane == 0) mbar_expect_tx(full, R::kStage);
    __syncwarp();
    for (int t = lane; t < 1 + R::kChunks * nruns; t += 32) {
      if (t == 0) {
        bulk_load(dst,
                  static_cast<const uint8_t*>(a.lut) +
                      ((long long)blockIdx.y * a.mpad + c0) * R::kChunkLut,
                  R::kLut, full);
      } else {
        const int c = (t - 1) / nruns, r = (t - 1) % nruns;
        bulk_load(dst + R::kLut + c * kPTR + r * run,
                  a.codes_t + (long long)(c0 + c) * a.npad + a.map.row(r0 + r * run), run,
                  full);
      }
    }
  }

  // The warp is done reading stage j: count it, and the last of the 8 warps
  // refills the slot with stage j + kStages.
  __device__ __forceinline__ void release(const TileArgs& a, int j) const {
    __syncwarp();
    unsigned last = 0;
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();  // this warp's reads of the slot come first
      last = atomicAdd(&released[j % R::kStages], 1u) % (kPThreads / 32) ==
             kPThreads / 32 - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && j + R::kStages < total) {
      __threadfence_block();
      // Every warp's reads of the slot (generic proxy) before the copies
      // into it (async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(a, j + R::kStages);
    }
  }
};

// The tile's sums for the lane's query over compact rows 64 * warp .. + 63
// of the walk's next tile, from stages j .. j + per_tile - 1. Every warp of
// the block calls it.
template <int KC, int KIND, class R>
__device__ __forceinline__ void ring_tile(const TileArgs& a, const RingWalk<KC, KIND, R>& ring,
                                          int& j, Accum<KIND>& acc) {
  using T = LutWord<KIND>;
  constexpr int G = kGroup<KC>;
  zero_acc<KIND>(acc);
  for (int c0 = 0; c0 < a.mpad; c0 += R::kChunks, ++j) {
    mbar_wait(ring.bars + 8 * (j % R::kStages), (j / R::kStages) & 1);
    const uint8_t* st = ring.stages + (j % R::kStages) * R::kStage;
#pragma unroll 1
    for (int c = 0; c < R::kChunks; c += G) {
      add_group<KC, KIND>(reinterpret_cast<const T*>(st), st + R::kLut, c, acc);
      fold_lo<KIND>(acc, c0 + c + G);
    }
    ring.release(a, j);
  }
}

// ---------------------------------------------------------------- K8 scores
// grid (ncomp / 512, ceil(Q / 32)), ncomp = n_valid rounded up to a tile.
// Block (t, y) sums tile t of its 32 queries through the ring, on K7b's
// geometry (Ring kExact: 3 stages, the score stage in the ring's memory,
// two blocks per SM, so one block's stores overlap the other's lookups),
// and writes the scores out through the score stage, so that a warp stores
// whole runs of an output row; out f32 [Q, n_valid]. K7a's geometry (2
// stages of up to 72 KB, a score stage of its own, one block per SM walking
// 8 tiles) ran K8 slower: int8 7.09 against 5.86 ms, bf16 7.37 against
// 6.48 at 1M x 96 chunks, Q = 256 (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py
// in turns; PERF.md).
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads, 2) pq_scores_kernel(TileArgs a, float* out) {
  using R = Ring<KC, KIND, true>;
  extern __shared__ __align__(128) uint8_t smem_p[];
  float* stage = reinterpret_cast<float*>(smem_p + kRingBarBytes);  // the ring's memory
  const long long row0 = (long long)blockIdx.x * kPTR;
  const int q0 = blockIdx.y * kPTQ;
  const RingWalk<KC, KIND, R> ring(smem_p, a, row0, 1);
  int j = 0;
  Accum<KIND> acc;
  ring_tile(a, ring, j, acc);
  __syncthreads();  // every warp is done with the ring, whose bytes have all landed
  stage_scores<KIND>(a, acc, stage, row0, false);
  __syncthreads();
  for (int i = threadIdx.x; i < kPTQ * kPTR; i += kPThreads) {
    const int jq = i / kPTR, e = i % kPTR;
    const long long row = row0 + e;
    if (q0 + jq < a.Q && row < a.n_valid)
      out[(long long)(q0 + jq) * a.n_valid + row] = stage[jq * kStride + e];
  }
}

// ----------------------------------------------------------- K7b exact search
// The tile's scores (the lane's 64 sums in acc) as ordered keys in the
// score stage, with the residual terms when the launch has them. Every
// thread of the block calls it, once the stage's memory is free.
template <int KIND>
__device__ __forceinline__ void exact_keys(const TileArgs& a, const Accum<KIND>& acc,
                                           float* stage, long long start) {
  stage_scores<KIND>(a, acc, stage, start, false);
  __syncthreads();
  if (add_residual(a, stage, start, false)) __syncthreads();
  unsigned* keys = reinterpret_cast<unsigned*>(stage);
  for (int i = threadIdx.x; i < kPTQ * kPTR; i += kPThreads) {
    const int q = i / kPTR, e = i % kPTR;
    keys[q * kStride + e] = float_to_key(stage[q * kStride + e]);
  }
  __syncthreads();
}

// Warp w selects the exact top-kk of queries 4w .. 4w+3 among the split's
// cnt valid rows (keys as exact_keys left them) and writes them, unordered,
// to cand_v / cand_i [Q, nsplit*kk] at columns s*kk .. s*kk+kk-1 (NEG / -1
// past the valid rows).
__device__ __forceinline__ void exact_select(const TileArgs& a, const unsigned* keys,
                                             unsigned* hist_all, long long start, int cnt,
                                             int kk, float* cand_v, int* cand_i) {
  const int warp = threadIdx.x >> 5;
  const long long width = (long long)gridDim.x * kk;
  for (int i = 0; i < 4; ++i) {
    const int ql = warp * 4 + i, q = blockIdx.y * kPTQ + ql;
    if (q >= a.Q) break;
    const long long o = (long long)q * width + (long long)blockIdx.x * kk;
    warp_select_topk(keys + ql * kStride, cnt, kk, start, cand_v + o, cand_i + o,
                     hist_all + warp * 256);
  }
}

// The rows of split blockIdx.x that the select reads: those < n_valid.
__device__ __forceinline__ int split_rows(const TileArgs& a) {
  const long long valid = (long long)a.n_valid - (long long)blockIdx.x * kPTR;
  return (int)(valid < 0 ? 0 : (valid < kPTR ? valid : kPTR));
}

// grid (npad / 512, ceil(Q / 32)). Block (s, t) scores split s of its 32
// queries through the ring into its score stage, as ordered keys, and
// selects each query's exact top-kk (exact_select).
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads, KIND == kBf16x2 ? 1 : 2)
    pq_search_exact_kernel(TileArgs a, float* cand_v, int* cand_i, int kk) {
  using R = Ring<KC, KIND, true>;
  extern __shared__ __align__(128) uint8_t smem_p[];
  float* stage = reinterpret_cast<float*>(smem_p + kRingBarBytes);  // the ring's memory
  const long long start = (long long)blockIdx.x * kPTR;
  const int cnt = split_rows(a);
  if (cnt > 0) {  // the same for every thread of the block
    const RingWalk<KC, KIND, R> ring(smem_p, a, start, 1);
    int j = 0;
    Accum<KIND> acc;
    ring_tile(a, ring, j, acc);
    __syncthreads();  // every warp is done with the ring, whose bytes have all landed
    exact_keys<KIND>(a, acc, stage, start);
  }
  exact_select(a, reinterpret_cast<const unsigned*>(stage),
               reinterpret_cast<unsigned*>(smem_p + R::kSmem - kHistBytes), start, cnt, kk,
               cand_v, cand_i);
}

// K7b with 8-bit codes and the int8 LUT: the same, its LUT staged
// synchronously by score_tile. The one launch the ring leaves slower, at
// every geometry timed: 7.08 against 7.21 ms at 1M x 96 chunks, Q = 256,
// and again 6.97 against 7.31 (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py in
// turns; PERF.md), as its int8 lookups are the cheapest
// (4.14 instructions each, against 10.8 for bf16x2) and two blocks per SM
// already overlap one's staging with the other's work.
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads) pq_search_exact_staged_kernel(TileArgs a,
                                                                            float* cand_v,
                                                                            int* cand_i,
                                                                            int kk) {
  extern __shared__ __align__(128) uint8_t smem_p[];
  float* stage = reinterpret_cast<float*>(smem_p);
  const long long start = (long long)blockIdx.x * kPTR;
  const int cnt = split_rows(a);
  if (cnt > 0) {  // the same for every thread of the block
    Accum<KIND> acc;
    score_tile<KC, KIND>(tile_lut<KC, KIND>(a), a.codes_t, a.npad, a.mpad, start, a.map,
                         smem_p, smem_p + kRegionBytes, acc);
    __syncthreads();  // every warp is done with the staged LUT
    exact_keys<KIND>(a, acc, stage, start);
  }
  exact_select(a, reinterpret_cast<const unsigned*>(stage),
               reinterpret_cast<unsigned*>(smem_p + kRegionBytes + kCodesBytes), start, cnt,
               kk, cand_v, cand_i);
}

// ---------------------------------------------------------- K7a approx search
// K11 is the same kernel over selected tiles (a.map.sel; pq_search_indexed,
// pq_kernel.py:582 of the JAX package), with part = SPAN * tile_n.
// grid (ceil(ncomp / part), ceil(Q / 32)). Block b walks the 512-row tiles
// of compact rows [part b, part b + part) in order, through the ring; thread
// t keeps, for the 16 (query, stride class) pairs t + 256 p, the running
// maximum over compact rows part b + 128 m + l and its corpus row (strict
// ">": the first row wins ties, as the Pallas kernel's compares do). A
// 128-row class segment lies in one selected tile. out_v / out_i: [Q,
// nblocks*128].
template <int KC, int KIND>
__global__ void __launch_bounds__(kPThreads, 1)
    pq_search_approx_kernel(TileArgs a, float* out_v, int* out_i) {
  using R = Ring<KC, KIND, false>;
  constexpr int kPairs = kPTQ * kSlot / kPThreads;
  extern __shared__ __align__(128) uint8_t smem_p[];
  float* stage = reinterpret_cast<float*>(smem_p + kRingBarBytes + R::kBytes);
  const long long part0 = (long long)blockIdx.x * a.part;
  const long long part_end = min(part0 + a.part, a.ncomp);
  const int q0 = blockIdx.y * kPTQ;
  const RingWalk<KC, KIND, R> ring(smem_p, a, part0, (int)((part_end - part0) / kPTR));
  int j = 0;
  float best[kPairs];
  int arg[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    best[p] = -__int_as_float(0x7f800000);  // -inf: any score beats it
    arg[p] = -1;
  }
  for (long long row0 = part0; row0 < part_end; row0 += kPTR) {
    Accum<KIND> acc;
    ring_tile(a, ring, j, acc);
    __syncthreads();  // every warp is done reading the previous tile's stage
    stage_scores<KIND>(a, acc, stage, row0, true);
    __syncthreads();
    if (add_residual(a, stage, row0, true)) __syncthreads();
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
  const size_t smem = Ring<KC, KIND, true>::kSmem - kHistBytes;  // K8 selects nothing
  cudaError_t err = prepare(pq_scores_kernel<KC, KIND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(a.ncomp / kPTR), query_tiles(a.Q));
  pq_scores_kernel<KC, KIND><<<grid, kPThreads, smem, s>>>(a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_exact_kernel(K kernel, size_t smem, const TileArgs& a, void* cand_v, void* cand_i,
                        int kk, cudaStream_t s) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(a.ncomp / kPTR), query_tiles(a.Q));
  kernel<<<grid, kPThreads, smem, s>>>(a, static_cast<float*>(cand_v),
                                        static_cast<int*>(cand_i), kk);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, int KIND>
int launch_exact(const TileArgs& a, void* cand_v, void* cand_i, int kk, cudaStream_t s) {
  if constexpr (KC == 256 && KIND == kInt8) {
    return launch_exact_kernel(pq_search_exact_staged_kernel<KC, KIND>,
                               kRegionBytes + kCodesBytes + kHistBytes, a, cand_v, cand_i, kk,
                               s);
  } else {
    return launch_exact_kernel(pq_search_exact_kernel<KC, KIND>, Ring<KC, KIND, true>::kSmem, a,
                               cand_v, cand_i, kk, s);
  }
}

template <int KC, int KIND>
int launch_approx(const TileArgs& a, void* out_v, void* out_i, cudaStream_t s) {
  if (a.part % kPTR) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Ring<KC, KIND, false>::kSmem;
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
