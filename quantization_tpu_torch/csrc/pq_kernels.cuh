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
//   * a block holds 32 queries and a tile of 512 corpus rows, 64 per warp;
//   * the LUT arrives as [query tile][chunk][code][32 queries' entries],
//     packed so that one 32-bit word holds one (chunk, code)'s entries for 4
//     neighbouring queries (int8, each biased by 128 as x ^ 0x80) or 2
//     (bf16); bf16x2 holds a pair's hi halves in one word and its lo halves
//     in the next. It is staged into shared memory a few chunks at a time;
//   * the lookup loop (Lanes): each lane loads 8 bytes of a (chunk, code)
//     row, the entries of 8 int8 / 4 bf16 / 2 bf16x2 neighbouring queries,
//     and the warp's lanes split into query groups x row groups (4 x 8, 8 x
//     4, 16 x 2): a lane sums its queries over 8 / 16 / 32 of the warp's 64
//     rows (rows rg, rg + 8 / 4 / 2, ... for row group rg), so the code byte
//     and the row address are computed once for 8 / 4 / 2 lookups;
//   * int8 sums are packed: a word's even and odd bytes, split by one mask
//     and one byte permute, each add into a register of two 16-bit sums
//     (4 registers a row for 8 queries), exact while 255 x chunks < 65,536;
//     every 256 chunks (only where mpad > 256) they are flushed into int32
//     sums in local memory, and 128 x mpad comes off at the end, so the sum
//     is the plain int32 sum to the bit;
//   * bf16 / bf16x2 entries are unpacked by a shift or a mask and summed in
//     f32 in the plain version's order (chunk order, 4-bit pairs, the lo
//     fold every 16 chunks), so the sums equal its to the bit;
//   * the codes of the tile are staged chunk-major as bytes; a lane reads its
//     row's code as one byte (the row groups of a warp read neighbouring
//     bytes);
//   * the kernels (K8, K7b, K7a, K11) stage both through a ring of bulk
//     copies completing on mbarriers, each stage refilled by the last warp
//     done with it (see "the ring" below). K7b with 8-bit codes and the int8
//     LUT, which the old loop ran faster on a synchronous staging through
//     registers, runs on the ring too since this loop: 4.66 against 5.23 ms
//     at 1M x 96 chunks, Q = 256 (scan_ab.py in turns, PERF.md).
// Bank conflicts: a half-warp's 8-byte loads read one (chunk, code) row of
// 128 bytes for bf16x2 (none), two rows of 64 bytes for bf16 (two-way when
// the codes' parity agrees) and four rows of 32 bytes for int8 (as many ways
// as the codes share a residue mod 4; ~2.1 on random codes). The map that
// puts lanes across queries (128 int8 queries a warp, one 32-bit load a
// lane) has none, but it idles lanes below 128 queries, stages 4x the LUT
// bytes a row tile, and ran slower: csrc/probe/lut_gather_rate.cu counts
// 48.4-48.8 int8 lookups a clock per SM for this map, 32.4-32.6 for that
// one and 25.4-25.6 for the old loop (16.7 against 15.1 for bf16x2).
// What bounds them on the H100, at the main path's 1M rows x 96 chunks and
// Q = 256: 2.46e10 lookups. Shared memory serves 128 bytes per clock per SM:
// the card's lookup bound is 0.73 ms for int8 entries and 1.47 ms for bf16,
// at 1.98 GHz on 132 SMs. The one-hot product on the int8 tensor cores would
// take 6.4 ms at 8 bits and 0.8 ms at 4 bits (192 chunks x 16 codes). The
// codes (96 MB) stream in 0.03 ms; K8's 1 GB output takes 0.3 ms. The LUT
// is staged again for every 512-row tile: 786 KB (int8) to 3.1 MB (bf16x2)
// per tile and 32 queries, read from L2 (0.5 B a lookup for int8, 2 B for
// bf16x2), which the probe copies at ~32 B a clock per SM: bf16x2 cannot
// pass ~16 lookups a clock per SM this way. The loop takes 1.59 SASS
// instructions a lookup for int8 entries, 3.1 for bf16 and 6.1 for bf16x2
// (chip_smoke.py counts them), against 4.14, ~6.25 and 10.86 for the loop it
// replaced (one 1-4 byte load a lookup, 32 lookups per clock per SM, a
// 2.94 ms floor, run at ~44 % of it): K7b 8-bit int8 7.03 -> 4.68 ms, K8
// 5.85 -> 3.10, K11 bf16x2 3.88 -> 3.34. The synchronous staging the ring
// replaced ran K11 bf16x2 at 5.45 ms against the ring's 3.83; multicasting
// each stage's LUT over a cluster of 2 blocks ran slower on every launch
// (K11 bf16x2 5.06 ms): each stage then waits for the slower block.
// (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py; PERF.md.)
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
constexpr int kStride = kPTR + 1;                // score stage row stride in words
constexpr int kStageBytes = kPTQ * kStride * 4;  // [32][513] f32 scores or keys
constexpr int kApproxPart = 4096;                // dense K7a part: SPAN * TILE_N

enum { kInt8 = 0, kBf16 = 1, kBf16x2 = 2 };

template <int KIND>
using LutWord = typename std::conditional<
    KIND == kInt8, uint8_t,
    typename std::conditional<KIND == kBf16, uint16_t, uint32_t>::type>::type;

// The lookup loop's lane map: a lane reads 8 bytes of a (chunk, code) row,
// the entries of kQL neighbouring queries, and sums them over kRL of its
// warp's 64 rows. Lane = rg * kG + g: query group g (queries kQL g ..), row
// group rg (the warp's rows rg, rg + kRG, ..). A half-warp's loads then read
// 16 / kG rows of kPTQ entries, and a store of the lanes' r-th sums of one
// query index to the score stage hits 32 banks.
template <int KIND>
struct Lanes {
  static constexpr int kQL = 8 / (int)sizeof(LutWord<KIND>);  // queries a lane: 8 / 4 / 2
  static constexpr int kG = kPTQ / kQL;                       // query groups a warp
  static constexpr int kRG = 32 / kG;                         // row groups a warp
  static constexpr int kRL = kPRW / kRG;                      // rows a lane: 8 / 16 / 32
  static constexpr int kRowBytes = kPTQ * (int)sizeof(LutWord<KIND>);  // a (chunk, code)
  static __device__ __forceinline__ int g() { return (threadIdx.x & 31) % kG; }
  static __device__ __forceinline__ int rg() { return (threadIdx.x & 31) / kG; }
  // The tile row of the lane's r-th sum, and the tile query of its i-th.
  static __device__ __forceinline__ int row(int r) {
    return (threadIdx.x >> 5) * kPRW + r * kRG + rg();
  }
  static __device__ __forceinline__ int query(int i) { return g() * kQL + i; }
};

// int8 sums are packed: two 16-bit sums a register, flushed into int32 every
// kFlush chunks (only where mpad > kFlush), exact while 255 x kFlush < 2^16.
constexpr int kFlush = 256;

template <int KIND>
struct Accum {
  using L = Lanes<KIND>;
  // int8: a row's 8 queries in 4 words of two 16-bit sums (word 2h + p holds
  // queries 4h + p and 4h + p + 2 in its low and high halves); else f32.
  using A = typename std::conditional<KIND == kInt8, uint32_t, float>::type;
  static constexpr int kV = KIND == kInt8 ? 4 : L::kQL;
  static constexpr int kWide = KIND == kInt8 ? L::kRL * L::kQL : 1;
  A v[L::kRL][kV];
  float lo[KIND == kBf16x2 ? L::kRL : 1][KIND == kBf16x2 ? L::kQL : 1];
  // int8 past kFlush chunks: the flushed sums, kWide ints of the kernel's
  // local memory (indexed at run time, so that they take no registers).
  int* wide;
};

// Adds entry x, the cc-th chunk of a group of G, to the group's sum gs:
// with G = 8 (4-bit codes) the chunks go in pairs (pr) and the pairs in
// order, ((x0 + x1) + (x2 + x3)) + ..., the order of the JAX package's CPU
// dot over one block-diagonal group (ROADMAP Queue 3, F19).
template <int G>
__device__ __forceinline__ void group_add(int cc, float& gs, float& pr, float x) {
  if constexpr (G == 1) {
    gs = x;
  } else if (cc % 2 == 0) {
    pr = x;
  } else {
    pr = __fadd_rn(pr, x);
    gs = cc == 1 ? pr : __fadd_rn(gs, pr);
  }
}

// Chunks summed on their own before they join acc: 8 for 4-bit codes, as
// the JAX kernel adds one block-diagonal matmul of 8 chunks at a time.
template <int KC>
constexpr int kGroup = KC == 16 ? 8 : 1;

// The f32 values of a loaded 8 bytes: bf16 4 queries (low half first);
// bf16x2 2 queries' hi (x) and lo (y) halves.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Adds the group of chunks c .. c + G - 1 of a staged block to the lane's
// sums: lut_s [chunks][KC][32 queries' entries], codes_s [chunks][512] row
// codes (the warp's rows at 64 * warp ..). Every search and K8 sum through
// it; the float sums in the plain version's order.
template <int KC, int KIND>
__device__ __forceinline__ void add_group(const LutWord<KIND>* lut_s, const uint8_t* codes_s,
                                          int c, Accum<KIND>& acc) {
  using L = Lanes<KIND>;
  constexpr int G = kGroup<KC>;
  // the lane's 8 bytes of chunk c + cc, code 0; the row's code at cs[cc][r]
  const uint8_t* lut_b = reinterpret_cast<const uint8_t*>(lut_s) + 8 * L::g();
  const uint8_t* cs = codes_s + (threadIdx.x >> 5) * kPRW + L::rg();
#pragma unroll
  for (int r = 0; r < L::kRL; ++r) {
    [[maybe_unused]] float gs[L::kQL], pr[L::kQL], gl[L::kQL], pl[L::kQL];
#pragma unroll
    for (int cc = 0; cc < G; ++cc) {
      const uint8_t* lc = lut_b + (c + cc) * (KC * L::kRowBytes);
      const int code = cs[(c + cc) * kPTR + r * L::kRG] & (KC - 1);
      const uint2 e = *reinterpret_cast<const uint2*>(lc + code * L::kRowBytes);
      if constexpr (KIND == kInt8) {
        // biased entries: the even bytes by a mask, the odd by a permute
        acc.v[r][0] += e.x & 0x00ff00ffu;
        acc.v[r][1] += __byte_perm(e.x, 0u, 0x4341);
        acc.v[r][2] += e.y & 0x00ff00ffu;
        acc.v[r][3] += __byte_perm(e.y, 0u, 0x4341);
      } else if constexpr (KIND == kBf16) {
        // the row's group sums (gs): chunks in pairs (pr), then the pairs
        group_add<G>(cc, gs[0], pr[0], bf16_lo(e.x));
        group_add<G>(cc, gs[1], pr[1], bf16_hi(e.x));
        group_add<G>(cc, gs[2], pr[2], bf16_lo(e.y));
        group_add<G>(cc, gs[3], pr[3], bf16_hi(e.y));
      } else {  // x: the pair's hi halves, y: its lo halves (gl, pl)
        group_add<G>(cc, gs[0], pr[0], bf16_lo(e.x));
        group_add<G>(cc, gs[1], pr[1], bf16_hi(e.x));
        group_add<G>(cc, gl[0], pl[0], bf16_lo(e.y));
        group_add<G>(cc, gl[1], pl[1], bf16_hi(e.y));
      }
    }
    if constexpr (KIND != kInt8) {
#pragma unroll
      for (int i = 0; i < L::kQL; ++i) {
        acc.v[r][i] = __fadd_rn(acc.v[r][i], gs[i]);
        if constexpr (KIND == kBf16x2) acc.lo[r][i] = __fadd_rn(acc.lo[r][i], gl[i]);
      }
    }
  }
}

// The packed 16-bit sum of the lane's i-th query in a row's int8 words.
__device__ __forceinline__ int packed_sum(const uint32_t (&w)[4], int i) {
  const uint32_t x = w[2 * (i >> 2) + (i & 1)];
  return (int)((i & 2) ? x >> 16 : x & 0xffffu);
}

// A run-time zero: wide's indices hold it, so that wide stays in local memory.
__device__ __forceinline__ int wide_base(int mpad) { return mpad >> 31; }

template <int KIND>
__device__ __forceinline__ void zero_acc(Accum<KIND>& acc, int mpad) {
  using L = Lanes<KIND>;
#pragma unroll
  for (int r = 0; r < L::kRL; ++r) {
#pragma unroll
    for (int i = 0; i < Accum<KIND>::kV; ++i) acc.v[r][i] = 0;
    if constexpr (KIND == kBf16x2) {
#pragma unroll
      for (int i = 0; i < L::kQL; ++i) acc.lo[r][i] = 0.0f;
    }
  }
  if constexpr (KIND == kInt8) {
    if (mpad > kFlush) {
      const int z = wide_base(mpad);
#pragma unroll 1
      for (int i = 0; i < Accum<KIND>::kWide; ++i) acc.wide[z + i] = 0;
    }
  }
}

// Once chunks .. c_end - 1 are summed (at the end of a staged block, whose
// chunks divide 16): bf16x2 folds the lo sums into acc as acc + lo * (1/256)
// at the end of every block of 16 chunks; int8 flushes its packed sums every
// kFlush chunks while chunks remain.
template <int KIND>
__device__ __forceinline__ void end_stage(Accum<KIND>& acc, int c_end, int mpad) {
  using L = Lanes<KIND>;
  if constexpr (KIND == kBf16x2) {
    if (c_end % kMBlk == 0) {
#pragma unroll
      for (int r = 0; r < L::kRL; ++r) {
#pragma unroll
        for (int i = 0; i < L::kQL; ++i) {
          acc.v[r][i] = __fadd_rn(acc.v[r][i], __fmul_rn(acc.lo[r][i], 1.0f / 256.0f));
          acc.lo[r][i] = 0.0f;
        }
      }
    }
  } else if constexpr (KIND == kInt8) {
    if (c_end % kFlush == 0 && c_end < mpad) {
      const int z = wide_base(mpad);
#pragma unroll
      for (int r = 0; r < L::kRL; ++r) {
#pragma unroll
        for (int i = 0; i < L::kQL; ++i) acc.wide[z + r * L::kQL + i] += packed_sum(acc.v[r], i);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.v[r][i] = 0;
      }
    }
  }
}

// The score of the lane's r-th row and i-th query: the int8 sum unbiased
// (less 128 a chunk, plus the flushed sums) and its affine in f64 rounded
// once, else the sum.
template <int KIND>
__device__ __forceinline__ float finish(const Accum<KIND>& acc, int r, int i, float scale,
                                        float bias, int mpad) {
  if constexpr (KIND == kInt8) {
    int s = packed_sum(acc.v[r], i) - 128 * mpad;
    if (mpad > kFlush) s += acc.wide[wide_base(mpad) + r * Lanes<KIND>::kQL + i];
    return __double2float_rn(__dadd_rn(__dmul_rn((double)scale, (double)s), (double)bias));
  } else {
    return acc.v[r][i];
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

// Writes the lane's scores of the tile to stage[query][row]; with mask,
// compact rows >= n_valid score NEG instead.
template <int KIND>
__device__ __forceinline__ void stage_scores(const TileArgs& a, const Accum<KIND>& acc,
                                             float* stage, long long row0, bool mask) {
  using L = Lanes<KIND>;
  float scale[L::kQL], bias[L::kQL];
#pragma unroll
  for (int i = 0; i < L::kQL; ++i) {
    const int q = blockIdx.y * kPTQ + L::query(i);
    scale[i] = bias[i] = 0.0f;
    if constexpr (KIND == kInt8) {
      if (q < a.Q) {
        scale[i] = a.scale[q];
        bias[i] = a.bias[q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < L::kRL; ++r) {
    const int e = L::row(r);
    const bool masked = mask && row0 + e >= a.n_valid;
#pragma unroll
    for (int i = 0; i < L::kQL; ++i) {
      const float s = finish<KIND>(acc, r, i, scale[i], bias[i], a.mpad);
      stage[L::query(i) * kStride + e] = masked ? kNeg : s;
    }
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
// order (add_group, end_stage), so the sums equal its to the bit.
constexpr int kRingMaxStages = 4;
constexpr int kRingBarBytes = 128;            // full barriers and release counts
constexpr int kHistBytes = sizeof(unsigned) * (kPThreads / 32) * 256;

// A ring's geometry, chosen by timing the candidates in turns (NVIDIA H100
// 80GB HBM3, 700 W, scan_ab.py; PERF.md): every stage costs each warp a wait
// and a release, so 8-bit codes take few, large stages, as many chunks as
// fit 36 KB (K8, K7b: 3 stages; K7b bf16x2, one block a SM, 72 KB) or 72 KB
// (K7a / K11: 2 stages; 4 stages of up to
// 36 KB ran K11 bf16x2 4.75 against 3.82 ms, K7a 8-bit int8 7.38 against
// 6.80), and 4-bit codes 4 stages of one group of 8 chunks (16-chunk stages
// ran K7b 4-bit bf16 19.27 against 15.70 ms).
// kExact: K8's and K7b's, whose score stage reuses the ring once its one
// tile is summed: a block's shared memory (74-110 KB) lets two blocks share an SM
// where the registers allow (every word but bf16x2, whose one block a SM
// takes 72 KB stages of 2 chunks: 11.42 against 14.08 ms for 36 KB stages
// of one), and the second
// block's lookups overlap the first's radix select (one block per SM, with
// a score stage of its own, took K7b 8-bit int8 from 7.06 to 10.26 ms).
// Else K7a / K11's, beside a score stage of its own (one block per SM:
// their registers allow no more), so that the next tile's stages arrive
// during a tile's epilogue.
template <int KC, int KIND, bool kExact>
struct Ring {
  static constexpr int kChunkLut = KC * kPTQ * (int)sizeof(LutWord<KIND>);
  static constexpr int kFit =
      (kExact && KIND != kBf16x2 ? 36 * 1024 : 72 * 1024) / (kChunkLut + kPTR);
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
  static_assert(kChunks % kGroup<KC> == 0 && kMBlk % kChunks == 0,
                "a stage holds whole groups and divides 16 chunks");
  static_assert(kStages <= kRingMaxStages, "the barriers' room holds the stages'");
  static_assert(kSmem <= 232448, "the ring and the score stage fit the SM's shared memory");
  static_assert(!kExact || KIND == kBf16x2 || 2 * (kSmem + 1024) <= 233472,
                "two K7b blocks share an SM");
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The tile's sums for the lane's queries over its rows of the walk's next
// tile, from stages j .. j + per_tile - 1. Every warp of the block calls it.
template <int KC, int KIND, class R>
__device__ __forceinline__ void ring_tile(const TileArgs& a, const RingWalk<KC, KIND, R>& ring,
                                          int& j, Accum<KIND>& acc) {
  using T = LutWord<KIND>;
  constexpr int G = kGroup<KC>;
  zero_acc<KIND>(acc, a.mpad);
  for (int c0 = 0; c0 < a.mpad; c0 += R::kChunks, ++j) {
    mbar_wait(ring.bars + 8 * (j % R::kStages), (j / R::kStages) & 1);
    const uint8_t* st = ring.stages + (j % R::kStages) * R::kStage;
#pragma unroll 1
    for (int c = 0; c < R::kChunks; c += G)
      add_group<KC, KIND>(reinterpret_cast<const T*>(st), st + R::kLut, c, acc);
    ring.release(a, j);
    end_stage<KIND>(acc, c0 + R::kChunks, a.mpad);
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
  int flushed[Accum<KIND>::kWide];
  acc.wide = flushed;
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
    int flushed[Accum<KIND>::kWide];
    acc.wide = flushed;
    ring_tile(a, ring, j, acc);
    __syncthreads();  // every warp is done with the ring, whose bytes have all landed
    exact_keys<KIND>(a, acc, stage, start);
  }
  exact_select(a, reinterpret_cast<const unsigned*>(stage),
               reinterpret_cast<unsigned*>(smem_p + R::kSmem - kHistBytes), start, cnt, kk,
               cand_v, cand_i);
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
    int flushed[Accum<KIND>::kWide];
    acc.wide = flushed;
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

template <int KC, int KIND>
int launch_exact(const TileArgs& a, void* cand_v, void* cand_i, int kk, cudaStream_t s) {
  const size_t smem = Ring<KC, KIND, true>::kSmem;
  cudaError_t err = prepare(pq_search_exact_kernel<KC, KIND>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(a.ncomp / kPTR), query_tiles(a.Q));
  pq_search_exact_kernel<KC, KIND><<<grid, kPThreads, smem, s>>>(
      a, static_cast<float*>(cand_v), static_cast<int*>(cand_i), kk);
  return static_cast<int>(cudaGetLastError());
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
