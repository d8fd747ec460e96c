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
// Layout, as in the JAX package: corpus sign bits as bit planes, u32
// [W8, npad] (word w of row n at planes[w * npad + n], LSB-first bit order),
// so neighbouring threads — neighbouring rows — read neighbouring words and
// every load of a warp is one 128-byte line. Queries are u32 [Q, W8]. W8 is
// a multiple of 8 words (256 bits), and bits past dim are zero on both sides.
//
// Sign queries score, for query q and corpus row n, with the Hamming
// distance x over the W8 words and the map of ops/bq.py metric_from_xor:
//     score = sign * (dim - 2x),  sign = +1 for DOT or inverted L1/L2, else -1.
// Every value is an integer below 2^24, so the score is exact in f32 and
// equals the plain PyTorch version, and the JAX kernels' mult*(qs.bits) + qb,
// to the bit.
//
// The sign-query kernels (K6, K5c, K5a, K10) run on the tensor cores: the int8
// scan body of dot_scan.cuh (mma_segment, the ring, the swizzle and the
// accumulator fragment) with the single-bit product wgmma m64nNk256
// b1.b1.and.popc and the BitRows loader, which stores plane words as they
// are (a 256-bit step is 32 bytes deep, as the s8 k32 step is). The product
// gives the AND count a = popc(q & c), and
//     x = pq + pc - 2a,
// pq the query's popcount (taken when the block starts), pc the row's (taken
// by the loader, one __popc a word). The epilogue computes sign * (dim - 2x)
// in integers (hamming_score), so a zero score is +0.0, as plain's is (an
// f32 epilogue could give -0.0). K5a / K10 run bq_sign_approx_ws_kernel
// (below: warp-specialized, persistent, 128 queries resident, A from
// registers, span items in place) at the depths it is built for, where its
// layout fits; past that bq_sign_approx_kernel keeps the approx body's
// geometry (approx_parts_kernel: 64 queries a block, two blocks a SM,
// running maxima per stride class over APPROX_PART-row parts and the
// combine). Both keep the JAX approx geometry, so their candidates are the
// plain approx's to the bit, the maxima on the row's integer term, the
// query's added once at the end. K5c selects
// by kk (ktile.cuh): up to 64 on the queue select, 64 queries a block
// (K5a's query tile, SignQueueTile) over ranges of several 512-row splits,
// two blocks a SM; above it on the radix select in the geometry of the
// popcount kernel it replaced (32 queries a block, 4 a warp, two blocks a
// SM; SignExactTile), each 512-row split's keys in shared memory. K6 is
// persistent, two blocks a SM, each holding a 128-query tile and its
// popcounts and walking 128-row segments; a segment's [128 x 128] f32
// scores leave in two halves by cp.async.bulk stores (bq_sign_scores_kernel,
// below).
//
// What bounds them on the H100 at the main path's 1,000,000 x 1536 bits, Q =
// 256: 192 MB of planes, 57 us at 3.35 TB/s; 3.9e11 bit products, which the
// b1 wgmma issues at the s8 instruction rate (5.5e7 m64n64k256 products a
// second per SM, NVIDIA H100 80GB HBM3 at 700 W, scan_ab.py --only rate),
// 51 us; so bytes, where the +-1 int8 route of the TPU design counts 0.40 ms
// of int8 operations. The two-block approx body ran far above that floor:
// a 128-row segment's depth is 1.5 chunks, so its ring barely fills and
// each segment pays its barriers, its query copies and its epilogue (K5a
// pass 1 0.53 ms, its scan alone 0.39, the combine 0.07). The
// warp-specialized body takes K5a's pass 1 to 0.21 ms (scan alone 0.11) and
// K10's over 262,144 x 768 from 0.12 + 0.02 to 0.05
// (csrc/probe/approx_split.cu, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md); the merge's torch.topk is then the larger share of K5a's
// search. On the way (same probe): the rows moved into a swizzled ring by
// the producer, from words landed by 4-byte cp.async, 0.40 ms; by 256-byte
// bulk copies from one thread, 0.59; by one 2D box, 0.31; with whole chunks
// of three steps (no product issued under a condition), 0.27; the item-end
// rows in 32-bit arithmetic (no spills), 0.24; A from registers, 0.21.
// Deeper raw prefetch (two to six segments), two accumulator sets and turns
// between the consumers measured no faster. The select takes half of K5c's
// time (its scan alone 0.4887 ms, the kernel 1.1491 on random planes,
// csrc/probe/select_split.cu). Same card (scan_ab.py in turns; PERF.md): K5c
// 3.37 on the radix select and 1.25 on the queue, where the popcount body
// these replaced (one __popc(q ^ c) per word, query and row on the CUDA
// cores, ~3 ms of popc issue) ran 3.79 (K5a), 6.12 and 0.62 (K10), and the
// +-1 int8 route on PlaneRows runs 1.75 and 5.98. Also measured: K5c in the
// exact body's geometry (64 queries, 8 a warp, one block a SM) 4.77; the
// two-block K5a with a float running maximum 0.91 (the integer one 0.79),
// with every prologue chunk's loads issued before the first store 0.83 (96
// bytes of spills), with no plane loads at all (wrong sums, a timing probe)
// 0.65. Over 262,144 rows of 768 dims K5c is select-bound, 0.84 ms against
// the popcount kernel's 0.80.
//
// K6 writes a 1.024 GB score matrix at that shape, 0.306 ms of its 0.363 ms
// bound (bytes). The popcount body it replaced (32 queries a block, one row
// a thread, one __popc(q ^ c) a word) was bound by __popc issue at 3.42 ms.
// On the b1 products (same card, scan_ab.py in turns; PERF.md): in
// scores_kernel's shape (a 128-row segment against 128 queries a block, the
// int tile through the ring, 16-byte thread stores) 0.74 ms, 0.90 with 256
// queries a block (one block a SM, the planes read once); persistent with
// the bulk stores as below 0.64; the same with two half tiles in turn at one
// block a SM 0.87-0.95 (a ring of two or three chunks), 0.75 with 256
// queries. A block of the first shape takes its query popcounts and two
// chunk loads for every 128 x 128 tile it writes; the persistent one takes
// the popcounts once and leaves the stores to the copy engine.
//
// The residual forms score mult[q] * (qs[q] . bits[n]) + qb[q] (+ rowadd[n])
// (+ corr), qs int8 [Q, W8*32] with 0 on the pad dims: the SQ scan bodies of
// dot_scan.cuh (K1 / K2 / K9a) over 0/1 bytes that a PlaneRows loader
// expands from the planes into the swizzled wgmma tile, with the
// multiply-add rounded once (F24). They keep the BQ approx geometry (spans
// of SPAN * mxu_tile_n dense, SPAN * tile_n indexed), so their candidates are
// the BQ plain versions'. Bound: 2 * Q * rows * dims int8 operations at
// 1,979 TOPS (0.05 ms for 256 queries over 262,144 rows of 768 dims, 0.25 ms
// over the serving plan's 1,255,424); K5a / K10 run about 10 times that, K5b
// more (its select; PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "dot_scan.cuh"


namespace {

// ------------------------------------------------ K5c / K5a / K10: b1 products

// qo[j] = sign * (dim - 2 * pq) for query q0 + j of the block's TQ (clamped
// to Q - 1), pq its popcount over W words: kThreads / TQ threads a query.
template <int TQ>
__device__ __forceinline__ void load_hamming_q(int* qo, const uint32_t* __restrict__ qwords,
                                               int q0, int Q, int W, int dim, int sign) {
  constexpr int kPer = kThreads / TQ;
  const int j = threadIdx.x / kPer, part = threadIdx.x % kPer;
  const uint32_t* qw = qwords + (long long)min(q0 + j, Q - 1) * W;
  int pq = 0;
  for (int w = part; w < W; w += kPer) pq += __popc(__ldg(qw + w));
#pragma unroll
  for (int o = 1; o < kPer; o <<= 1) pq += __shfl_xor_sync(0xffffffffu, pq, o);
  if (part == 0) qo[j] = sign * (dim - 2 * pq);
}

// sign * (dim - 2 * (pq + pc - 2 * acc)) = qo + sign * (4 * acc - 2 * pc): the
// row's term, then the score in integers (below 2^24, exact in f32, and +0.0
// for 0 as plain's is).
__device__ __forceinline__ int hamming_term(int pc, int acc, int sign) {
  return sign * (4 * acc - 2 * pc);
}
__device__ __forceinline__ float hamming_score(int qo, int pc, int acc, int sign) {
  return __int2float_rn(qo + hamming_term(pc, acc, sign));
}

// The shared memory after the ring: qo [TQ], the loader's pc [2][kSeg].
template <class T>
constexpr size_t hamming_bytes() {
  return sizeof(int) * (T::TQ + 2 * kSeg);
}

// K5c's tile on the radix select (kk > 64): 32 queries a block (n32
// products), a ring of two chunks, two blocks a SM, so 16 warps a SM
// select, 4 queries each, while the other block scans; the popcount kernel
// it replaced selected in this geometry. The exact body's (64 queries, 8 a
// warp, one block a SM) radix-selected slower: 4.77 against 3.39 ms at 1M x
// 1536, 1.21 against 0.80 ms over 262,144 x 768 (NVIDIA H100 80GB HBM3,
// 700 W, scan_ab.py; PERF.md).
using SignExactTile = Tile<32, 2, 2>;

// K5c on the radix select. grid nsplit * ceil(Q / 32), the query tiles of a
// split neighbours in launch order. Block (s, t) scores rows [s*split,
// s*split + split) of its 32 queries into shared memory as ordered keys,
// then each warp selects the exact top-kk of its 4 queries among the
// split's rows < n_valid and writes them, unordered, to cand_v / cand_i
// [Q, nsplit*kk] at columns s*kk .. s*kk+kk-1 (NEG / -1 past the valid
// rows). The warps' histograms take the ring's memory once the scan is
// done.
__global__ void __launch_bounds__(kThreads, SignExactTile::kBlocks) bq_sign_exact_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int W, long long npad,
    int n_valid, int dim, int sign, int split, int kk) {
  using T = SignExactTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  int* qo = reinterpret_cast<int*>(smem + T::kBytes);
  int* pc = qo + TQ;
  const int ks = split + kKeyPad;                                  // key row stride
  unsigned* keys = reinterpret_cast<unsigned*>(pc + 2 * kSeg);     // [TQ][ks]
  const int warp = threadIdx.x >> 5;
  const int nqt = (Q + TQ - 1) / TQ, nsplit = (int)((npad + split - 1) / split);
  const int split_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)split_id * split;
  load_hamming_q<TQ>(qo, qwords, q0, Q, W, dim, sign);
  const BitRows rows{planes, npad, W, pc};
  const int8_t* qbytes = reinterpret_cast<const int8_t*>(qwords);

  for (int off = 0; off < split && start + off < n_valid; off += kSeg) {
    int acc[1][T::kAcc];
    mma_segment<T>(rows, qbytes, q0, Q, start + off, 4 * W, smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < T::kAcc; ++e) {
      const int j = frag_col(e), r = frag_row(e);
      keys[j * ks + off + r] =
          float_to_key(hamming_score(qo[j], pc[r] + pc[kSeg + r], acc[0][e], sign));
    }
  }
  __syncthreads();  // the keys of a query come from every warp; the ring is free

  const long long valid = (long long)n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < split ? valid : split));
  const long long width = (long long)nsplit * kk;
  unsigned* hist = reinterpret_cast<unsigned*>(smem) + warp * 256;
  for (int j = warp; j < TQ; j += kThreads / 32) {
    const int q = q0 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)split_id * kk;
    warp_select_topk(keys + j * ks, cnt, kk, start, cand_v + o, cand_i + o, hist);
  }
}

// K5c on the queue route (kk <= kQueueK; ktile.cuh QueueSelect): 64
// queries a block (n64 products, K5a's query tile) and a ring of two chunks,
// two blocks a SM; grid nblk * ceil(Q / 64) over ranges of `split` rows (a
// multiple of 128; the wrapper's one wave of two blocks a SM, ktile.py
// exact_geometry), each block walking its range a segment at a time with
// one queue a query, the owner warps 8 queries each. The queues leave
// sorted, NEG / -1 past the valid rows, at columns s*kk .. s*kk+kk-1 of
// cand_v / cand_i [Q, nblk*kk]. The 32-query tile, which the radix select
// needed, ran 1.4381-1.4573 ms against this one's 1.2692 at 1M x 1536, k =
// 40, and 0.3711-0.3813 against 0.4054 over 262,144 x 768, k = 20 (NVIDIA
// H100 80GB HBM3, 700 W, scan_ab.py; PERF.md).
using SignQueueTile = Tile<64, 2, 2>;

__global__ void __launch_bounds__(kThreads, SignQueueTile::kBlocks) bq_sign_queue_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int W, long long npad,
    int n_valid, int dim, int sign, int split, int kk) {
  using T = SignQueueTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  int* qo = reinterpret_cast<int*>(smem + T::kBytes);
  int* pc = qo + TQ;
  static_assert(T::kBytes >= TQ * kKeyStride * sizeof(unsigned), "the keys in the ring");
  QueueSelect<TQ> qs;
  qs.init(reinterpret_cast<uint8_t*>(pc + 2 * kSeg), smem, kk);
  const int nqt = (Q + TQ - 1) / TQ, nblk = (int)((npad + split - 1) / split);
  const int blk = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)blk * split;
  const long long end = min((long long)n_valid, start + split);
  load_hamming_q<TQ>(qo, qwords, q0, Q, W, dim, sign);
  const BitRows rows{planes, npad, W, pc};
  const int8_t* qbytes = reinterpret_cast<const int8_t*>(qwords);

  for (long long off = start; off < end; off += kSeg) {
    int acc[1][T::kAcc];
    mma_segment<T>(rows, qbytes, q0, Q, off, 4 * W, smem_addr(smem), acc);
    unsigned key[T::kAcc];
#pragma unroll
    for (int e = 0; e < T::kAcc; ++e) {
      const int r = frag_row(e);
      key[e] = off + r < end ? float_to_key(hamming_score(qo[frag_col(e)], pc[r] + pc[kSeg + r],
                                                          acc[0][e], sign))
                             : 0u;
    }
    queue_segment<TQ, T::kAcc>(qs, key, off, min(TQ, Q - q0));
  }
  __syncthreads();  // the queues, also where the block had no valid row

  const long long width = (long long)nblk * kk;
  const ScanMap dense{nullptr, 0, nullptr, 0, 0};
  for (int j = threadIdx.x >> 5; j < TQ; j += kThreads / 32) {
    const int q = q0 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blk * kk;
    qs.write(j, cand_v + o, cand_i + o, dense);
  }
}

// K5a, and K10 over selected tiles (map.sel; bq_search_indexed, bq_kernel.py:328
// of the JAX package), where bq_sign_approx_ws_kernel (below) does not run
// (sign_ws_tq): pass 1, grid ceil(ncomp / part) * ceil(Q / 64), the
// query tiles of a part neighbours in launch order: approx_parts_kernel's
// geometry. Block p keeps, for each of its queries and each stride class l
// (compact rows p*part + m*128 + l), the running maximum and its corpus row
// (strict ">" in compact order: the first row wins ties, as the Pallas
// kernel's compares do). Compact rows >= n_valid score NEG (bq_kernel.py:149).
// part_v / part_i: [Q, nparts*128]. Pass 2 is ktile.cuh's in-order combine
// per span block.
__global__ void __launch_bounds__(kThreads, ApproxTile::kBlocks) bq_sign_approx_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int W, long long npad,
    long long ncomp, int n_valid, int dim, int sign, int part, ScanMap map) {
  using T = ApproxTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  int* qo = reinterpret_cast<int*>(smem + T::kBytes);
  int* pc = qo + TQ;
  const int nqt = (Q + TQ - 1) / TQ, nparts = (int)((ncomp + part - 1) / part);
  const int part_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)part_id * part;
  load_hamming_q<TQ>(qo, qwords, q0, Q, W, dim, sign);
  const BitRows rows{planes, npad, W, pc};
  const int8_t* qbytes = reinterpret_cast<const int8_t*>(qwords);
  // The running maxima as hamming_term, qo[j] being the same for every row
  // of a (query, class) pair: kNone before the first row, kPad for rows >=
  // n_valid (NEG), below every real term; the score is formed once at the end.
  constexpr int kNone = INT_MIN, kPad = INT_MIN + 1;
  int best[32];
  unsigned seg[8];  // byte e % 4 of seg[e / 4]: the segment of best[e]; 0xff: none
#pragma unroll
  for (int e = 0; e < 32; ++e) best[e] = kNone;
#pragma unroll
  for (int i = 0; i < 8; ++i) seg[i] = 0xffffffffu;
  int m = 0;
  for (int off = 0; off < part && start + off < ncomp; off += kSeg, ++m) {
    int acc[1][32];
    mma_segment<T>(rows, qbytes, q0, Q, map.row(start + off), 4 * W, smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = frag_row(e);
      const int v = start + off + r < n_valid
                        ? hamming_term(pc[r] + pc[kSeg + r], acc[0][e], sign)
                        : kPad;
      if (v > best[e]) {
        best[e] = v;
        const int sh = 8 * (e & 3);
        seg[e >> 2] = (seg[e >> 2] & ~(0xffu << sh)) | ((unsigned)m << sh);
      }
    }
  }
  const long long width = (long long)nparts * kSlot;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int j = frag_col(e), q = q0 + j, l = frag_row(e);
    if (q >= Q) continue;
    const unsigned sm = (seg[e >> 2] >> (8 * (e & 3))) & 0xffu;
    const long long c = (long long)q * width + (long long)part_id * kSlot + l;
    part_v[c] = best[e] == kNone  ? -__int_as_float(0x7f800000)
                : best[e] == kPad ? kNeg
                                  : __int2float_rn(qo[j] + best[e]);
    part_i[c] = sm == 0xffu ? -1 : (int)map.row(start + (long long)sm * kSeg + l);
  }
}

// ------------------------------------- K5a / K10: the warp-specialized body
// bq_sign_approx_ws_kernel: pass 1 of K5a / K10 with sign queries, warp-
// specialized and persistent on dot_scan.cuh's walk (WsWalk over the items
// of ktile.py approx_geometry, span blocks in place; WsBars; ws_grid;
// ws_fetch_queries), bq_sign_approx_kernel's output to the bit, wherever
// its layout fits (sign_ws_tq). A block of 384 threads, one a SM:
//   * 128 queries resident (64 where Q <= 64): their words land once as the
//     B operand, in chunks of 128 bytes, zero past 4 W; each query's qo
//     once. The products are m64n128k256 b1: a row loaded once serves 128
//     queries.
//   * the producer warpgroup only lands plane words: one thread a consumer
//     warpgroup copies each segment's box of the planes (64 rows and 8
//     more, every word: one 2D TMA copy, tma_load_2d) into a slot of its
//     own, R slots deep, on the slot's barrier.
//   * the consumers take the A operand from registers: b1 wgmma takes
//     K-major operands only and the planes hold a row's words npad apart, so
//     no copy lands a row's words together; each thread loads its fragment
//     (two rows, two words a k256 step) from the box with 32-bit loads (72
//     rows a word: the warp's loads fall on 32 banks) and counts the rows'
//     set bits on the way (pc, summed over the row's four lanes). The next
//     segment's fragment loads while this segment's maxima are taken.
//   * per (query, stride class) one integer key: 256 t + (255 - m), t =
//     sign * (2 acc - pc) (half of hamming_term) and m the segment in the
//     item, so the larger key is the larger term and, among equal terms, the
//     earlier segment: the strict ">" in compact order, first row of a tie.
//     One multiply-add and one max an element, with the row's multiplier and
//     addend (0 and kWsPadT for rows >= n_valid, which score NEG); the
//     segment needs no byte of its own. The score qo + 2t is formed once,
//     when an item ends.
// kScan (csrc/probe/approx_split.cu): the scan alone, each accumulator
// folded into a register in place of the epilogue (wrong results).
constexpr int kWsNone = INT_MIN;     // no row yet: -inf, id -1
constexpr int kWsPadT = -(1 << 22);  // a row >= n_valid; real |t| <= dim < 2^22
constexpr int kBoxRows = 72;         // a box: 64 rows and 8 more, for the banks
constexpr int kSignRaw = 6;          // slots a consumer warpgroup, at most

// The depths the body is built for: 256-bit steps a row (W / 8).
__host__ __device__ inline bool sign_ws_depth(int n) {
  return n == 1 || n == 2 || n == 3 || n == 4 || n == 6 || n == 8;
}

// The body's shared memory from the 1024-aligned base: the resident query
// tile (ceil(n / 4) chunks of [TQ][128 B]), then R slots a warpgroup of one
// box ([W][kBoxRows] u32), qo[TQ], the barriers. R = 0 where fewer than two
// fit.
struct SignLayout {
  int R, raw, raw_seg, qo, bars, bytes;
  __host__ __device__ SignLayout(int TQ, int W) {
    raw = (W / 8 + 3) / 4 * TQ * kDK;
    raw_seg = W * kBoxRows * 4;
    R = (kWsSmem - kAlign - raw - TQ * 4 - kWsBarBytes) / (2 * raw_seg);
    R = R > kSignRaw ? kSignRaw : R < 2 ? 0 : R;
    qo = raw + 2 * R * raw_seg;
    bars = qo + TQ * 4;
    bytes = bars + kWsBarBytes;
  }
};
static_assert(kSignRaw <= kWsMaxStages && kSignRaw <= kWsMaxRaw, "a slot's two barriers");

// The route's query tile: bq_sign_approx_ws_kernel's (128, or 64 where Q <=
// 64) at the depths it is built for, where its layout fits, else 0
// (bq_sign_approx_kernel).
inline int sign_ws_tq(int Q, int W) {
  return sign_ws_depth(W / 8) && SignLayout(ws_tq(Q), W).R ? ws_tq(Q) : 0;
}

// d[64 x N] += popc(A[64 x 256 bits] & B[N x 256 bits]^T), A from registers,
// B K-major in shared memory: a[0 .. 3] the thread's fragment of its warp's
// 16 rows, as mma.m16n8k256 holds it (lane l: a[0] row l/4, word l%4 of the
// step; a[1] row l/4 + 8; a[2], a[3] the same rows, word l%4 + 4).
__device__ __forceinline__ void wgmma_m64n128k256_b1_rs(int (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n64k256_b1_rs(int (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <int TQ>
__device__ __forceinline__ void wgmma_b1_rs(int (&d)[TQ / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (TQ == 128) {
    wgmma_m64n128k256_b1_rs(d, a, b);
  } else {
    wgmma_m64n64k256_b1_rs(d, a, b);
  }
}

// Keeps the compiler from reusing a fragment's registers before the
// products that read them are done.
template <int kN>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int k = 0; k < kN; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

template <bool kScan, int TQ, int kN>
__global__ void __launch_bounds__(kWsThreads, 1) bq_sign_approx_ws_kernel(
    const __grid_constant__ CUtensorMap planes_map, const uint32_t* __restrict__ qwords,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int W, int ncomp, int n_valid,
    int dim, int sign, int part, ScanMap map) {
  constexpr int kAcc = TQ / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const SignLayout L(TQ, W);
  const uint32_t s0 = smem_addr(smem);
  const WsBars bars{s0 + L.bars};  // raw(g, r): slot r landed; empty(g, r): slot r read
  int* qo = reinterpret_cast<int*>(smem + L.qo);
  const int q0 = (int)(blockIdx.x % ((Q + TQ - 1) / TQ)) * TQ;
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g) {
      for (int r = 0; r < L.R; ++r) {
        mbar_init(bars.raw(g, r), 1);      // the copying thread
        mbar_init(bars.empty(g, r), 128);  // the warpgroup's threads
      }
    }
    mbar_init(bars.qready(), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    if constexpr (TQ == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - 256, g = pt >> 6;
    ws_fetch_queries<TQ>(s0, reinterpret_cast<const int8_t*>(qwords), q0, Q, 4 * W,
                         bars.qready(), pt);
    cp_async_commit();
    if ((pt & 63) == 0) {
      int u = 0;
      for (WsWalk w(TQ, Q, ncomp, part); !w.done(); w.next(), ++u) {
        const int slot = u % L.R;
        mbar_wait(bars.empty(g, slot), ((u / L.R) & 1) ^ 1u);  // its last box was read
        mbar_expect_tx(bars.raw(g, slot), L.raw_seg);
        // The box: kBoxRows rows from the warpgroup's first of every word, as
        // [W8][kBoxRows] (word w of row r at 4 (kBoxRows w + r)).
        tma_load_2d(s0 + L.raw + (g * L.R + slot) * L.raw_seg, &planes_map,
                    (int)map.row(w.comp()) + 64 * g, 0, bars.raw(g, slot));
      }
    }
    cp_async_wait<0>();
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (TQ == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = threadIdx.x >> 7, lane = threadIdx.x & 31;
  load_hamming_q<TQ>(qo, qwords, q0, Q, W, dim, sign);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers' qo
  mbar_wait(bars.qready(), 0);
  fence_proxy_async();
  const uint64_t dq = wgmma_desc(s0);
  const long long width = (long long)((ncomp + part - 1) / part) * kSlot;
  const int r0 = frag_row(0);  // this thread's rows: r0 (e & 2 == 0) and r0 + 8
  // Its fragment's words in a box: row r0 - 64 g, word l%4 of each step.
  const int fo = (lane & 3) * kBoxRows + r0 - 64 * g;
  int best[kAcc];
  unsigned fold = 0;
#pragma unroll
  for (int e = 0; e < kAcc; ++e) best[e] = kWsNone;

  // Segment u's fragment from its box into a (its rows' set bits into p0,
  // p1), then the slot is free.
  int p0 = 0, p1 = 0;
  auto load = [&](uint32_t (&a)[kN][4], int u) {
    const int slot = u % L.R;
    mbar_wait(bars.raw(g, slot), (u / L.R) & 1);
    const uint32_t* box =
        reinterpret_cast<const uint32_t*>(smem + L.raw + (g * L.R + slot) * L.raw_seg) + fo;
    p0 = p1 = 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const uint32_t* x = box + 8 * k * kBoxRows;
      a[k][0] = x[0];
      a[k][1] = x[8];
      a[k][2] = x[4 * kBoxRows];
      a[k][3] = x[4 * kBoxRows + 8];
      p0 += __popc(a[k][0]) + __popc(a[k][2]);
      p1 += __popc(a[k][1]) + __popc(a[k][3]);
    }
    ws_bar_arrive(bars.empty(g, slot));
  };
  // The segment's products from a, one commit group.
  auto issue = [&](int (&acc)[kAcc], uint32_t (&a)[kN][4]) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kN; ++k)
      wgmma_b1_rs<TQ>(acc, a[k], dq + (uint64_t)(((k / 4) * TQ * kDK) >> 4) + 2 * (k % 4));
    wgmma_commit();
  };
  // Segment u's maxima (and, where its item ends, the item's slots), once
  // its products are done; pc of its rows from this segment's p0 / p1.
  auto retire = [&](int (&acc)[kAcc], const WsWalk& w, int pc0, int pc1) {
    if constexpr (kScan) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) fold ^= (unsigned)acc[e];
    } else {
      const long long cs = w.comp();
      const int tail = 255 - w.m;
      // Row r's key a * mul + add: 256 sign (2a - pc) + tail, or kWsPadT's.
      const bool in0 = cs + r0 < n_valid, in1 = cs + r0 + 8 < n_valid;
      const int mul0 = in0 ? 512 * sign : 0, mul1 = in1 ? 512 * sign : 0;
      const int add0 = (in0 ? -sign * pc0 : kWsPadT) * 256 + tail;
      const int add1 = (in1 ? -sign * pc1 : kWsPadT) * 256 + tail;
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        best[e] = max(best[e], acc[e] * (e & 2 ? mul1 : mul0) + (e & 2 ? add1 : add0));
    }
    if (w.last()) {
      // The item's slots, and its rows in 32-bit arithmetic (npad and ncomp
      // fit an int): segment cs = seg0 + m of the compact rows, through the
      // selection's tiles of tseg segments where there is one.
      const long long item = (long long)(w.start / part) * kSlot;
      const int seg0 = (int)(w.start / kSeg), tseg = map.sel ? map.tile_n / kSeg : 0;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int j = frag_col(e), q = q0 + j, l = frag_row(e);
        if (q >= Q) continue;
        const long long o = (long long)q * width + item + l;
        if constexpr (kScan) {
          part_v[o] = __uint_as_float(fold);
        } else {
          const int key = best[e], t = key >> 8, cs = seg0 + 255 - (key & 255);
          part_v[o] = key == kWsNone ? -__int_as_float(0x7f800000)
                      : t == kWsPadT ? kNeg
                                     : __int2float_rn(qo[j] + 2 * t);
          part_i[o] = key == kWsNone ? -1
                      : tseg         ? map.sel[cs / tseg] * map.tile_n + cs % tseg * kSeg + l
                                     : cs * kSeg + l;
        }
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) best[e] = kWsNone;
    }
  };
  // Each segment: its products, then (once they are done) the next
  // segment's fragment loaded into the same registers, under this one's
  // maxima.
  int acc[kAcc];
  uint32_t a[kN][4];
  int u = 0;
  load(a, 0);
  for (WsWalk w(TQ, Q, ncomp, part); !w.done(); w.next(), ++u) {
    issue(acc, a);
    int c0 = p0, c1 = p1;
    wgmma_wait<0>();
    fence_frag(a);
    fence_acc(acc);
    WsWalk ahead = w;
    ahead.next();
    if (!ahead.done()) load(a, u + 1);
    // pc of this segment's rows: the four lanes of a row hold a quarter each.
    c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
    c0 += __shfl_xor_sync(0xffffffffu, c0, 2);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 2);
    retire(acc, w, c0, c1);
  }
}

// ---------------------------------------------------------------- K6 scores

// K6, the [Q, n_valid] score matrix, persistent: grid bpt * ceil(Q / 128),
// block b holding query tile b % nqt (its qo taken once) and walking
// segments b / nqt, + bpt, ..., two blocks a SM. Each 128-row segment's b1
// products run on a ring of two chunks (mma_segment with BitRows); its
// scores, sign * (dim - 2x) formed in integers (+0.0 for a zero, as
// plain's), leave as f32 in two halves of 64 queries through a [64][kTS]
// tile after the ring: where n_valid % 4 == 0, thread i < 64 stores query
// row i of a half with one cp.async.bulk (512 bytes, fewer for the last
// segment), which drains while the block goes on, and the tile is rewritten
// once those stores have read it; else the warps store the half by
// store_tile. out f32 [Q, n_valid], 16-byte aligned.
using SignScoresTile = Tile<128, 2, 2>;
constexpr int kHalfQ = 64;

__global__ void __launch_bounds__(kThreads, SignScoresTile::kBlocks) bq_sign_scores_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    float* __restrict__ out, int Q, int W, long long npad, int n_valid, int dim, int sign,
    int bpt) {
  using T = SignScoresTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  int* half = reinterpret_cast<int*>(smem + T::kBytes);  // [kHalfQ][kTS], f32 bits
  int* qo = half + kHalfQ * kTS;
  int* pc = qo + TQ;
  const int tid = threadIdx.x;
  const int nqt = (Q + TQ - 1) / TQ, nseg = (n_valid + kSeg - 1) / kSeg;
  const int q0 = (blockIdx.x % nqt) * TQ;
  const bool bulk = (n_valid & 3) == 0;
  load_hamming_q<TQ>(qo, qwords, q0, Q, W, dim, sign);
  const BitRows rows{planes, npad, W, pc};
  for (int seg = blockIdx.x / nqt; seg < nseg; seg += bpt) {
    const long long row0 = (long long)seg * kSeg;
    const int cnt = (int)min((long long)kSeg, n_valid - row0);  // the segment's valid rows
    int acc[T::kH][T::kAcc];
    mma_segment<T>(rows, reinterpret_cast<const int8_t*>(qwords), q0, Q, row0, 4 * W,
                   smem_addr(smem), acc);
#pragma unroll
    for (int h = 0; h < T::kH; ++h) {
      if (bulk && tid < kHalfQ) bulk_wait_read();
      __syncthreads();  // the tile is free: its stores have read it
#pragma unroll
      for (int e = 0; e < T::kAcc; ++e) {
        const int j = frag_col(e), r = frag_row(e);
        half[j * kTS + r] = __float_as_int(
            __int2float_rn(qo[64 * h + j] + hamming_term(pc[r] + pc[kSeg + r], acc[h][e], sign)));
      }
      if (bulk) fence_proxy_async();  // the tile's writes, seen by the bulk stores
      __syncthreads();
      const int hq0 = q0 + 64 * h;
      if (!bulk) {
        store_tile<kHalfQ>(
            half, [](int) { return [](int a, long long) { return __int_as_float(a); }; }, out,
            hq0, Q, row0, n_valid);
      } else if (tid < kHalfQ && hq0 + tid < Q) {
        bulk_store(out + (long long)(hq0 + tid) * n_valid + row0, smem_addr(half + tid * kTS),
                   4 * cnt);
        bulk_commit();
      }
    }
  }
  if (bulk && tid < kHalfQ) bulk_wait();
}

// ------------------------------------------------------------- launches

// bq_sign_approx_kernel's launch (pass 1 only).
cudaError_t launch_sign_approx_parts(const void* qwords, const void* planes, void* part_v,
                                     void* part_i, int Q, int W8, long long npad,
                                     long long ncomp, int n_valid, int dim, int sign, int part,
                                     ScanMap map, cudaStream_t s) {
  const size_t smem = kAlign + ApproxTile::kBytes + hamming_bytes<ApproxTile>();
  cudaError_t err = cudaFuncSetAttribute(
      bq_sign_approx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nparts = (int)((ncomp + part - 1) / part);
  const unsigned grid = (unsigned)nparts * ((Q + ApproxTile::TQ - 1) / ApproxTile::TQ);
  bq_sign_approx_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, W8, npad, ncomp, n_valid,
      dim, sign, part, map);
  return cudaGetLastError();
}

// The planes' tensor map for bq_sign_approx_ws_kernel: u32 [W8][npad],
// boxes of kBoxRows rows x W8 words, rows past npad zero.
cudaError_t planes_box_map(CUtensorMap* m, const void* planes, int W8, long long npad) {
  return tensor_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT32, planes, (unsigned long long)npad,
                       (unsigned long long)W8, (unsigned long long)npad * 4, kBoxRows,
                       (unsigned)W8, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool kScan, int TQ, int kN>
cudaError_t launch_sign_ws_n(const CUtensorMap& planes_map, const void* qwords, void* part_v,
                             void* part_i, int Q, int W8, long long ncomp, int n_valid, int dim,
                             int sign, int part, ScanMap map, cudaStream_t s) {
  auto* kernel = bq_sign_approx_ws_kernel<kScan, TQ, kN>;
  const size_t smem = kAlign + SignLayout(TQ, W8).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  unsigned grid = 0;
  if (err == cudaSuccess) err = ws_grid(Q, TQ, ncomp, part, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, smem, s>>>(
      planes_map, static_cast<const uint32_t*>(qwords), static_cast<float*>(part_v),
      static_cast<int*>(part_i), Q, W8, (int)ncomp, n_valid, dim, sign, part, map);
  return cudaGetLastError();
}

// bq_sign_approx_ws_kernel's launch (ws_grid), the instantiation of its
// depth; the caller checks the route (sign_ws_tq).
template <bool kScan, int TQ>
cudaError_t launch_sign_approx_ws(const void* qwords, const void* planes, void* part_v,
                                  void* part_i, int Q, int W8, long long npad, long long ncomp,
                                  int n_valid, int dim, int sign, int part, ScanMap map,
                                  cudaStream_t s) {
  if (!sign_ws_depth(W8 / 8) || !SignLayout(TQ, W8).R || npad > INT_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap m;
  const cudaError_t err = planes_box_map(&m, planes, W8, npad);
  if (err != cudaSuccess) return err;
  auto run = [&](auto n) {
    return launch_sign_ws_n<kScan, TQ, decltype(n)::value>(m, qwords, part_v, part_i, Q, W8,
                                                           ncomp, n_valid, dim, sign, part, map,
                                                           s);
  };
  switch (W8 / 8) {
    case 1: return run(std::integral_constant<int, 1>{});
    case 2: return run(std::integral_constant<int, 2>{});
    case 3: return run(std::integral_constant<int, 3>{});
    case 4: return run(std::integral_constant<int, 4>{});
    case 6: return run(std::integral_constant<int, 6>{});
    default: return run(std::integral_constant<int, 8>{});
  }
}

}  // namespace

// ------------------------------------------------------------- C interface
// Every function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Shapes are checked by the Python wrappers
// (ops/kernels/bq_kernel.py): contiguous u32 tensors, npad % 2048 == 0,
// W8 % 8 == 0, the query words 16-byte aligned.

extern "C" {

int qtt_bq_scores(const void* qwords, const void* planes, void* out, int Q, int W8,
                  long long npad, int n_valid, int dim, int sign, void* stream) {
  using T = SignScoresTile;
  if (reinterpret_cast<uintptr_t>(out) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = kAlign + T::kBytes + sizeof(int) * kHalfQ * kTS + hamming_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(bq_sign_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqt = (Q + T::TQ - 1) / T::TQ, nseg = (n_valid + kSeg - 1) / kSeg;
  const int per = T::kBlocks * sms / nqt;  // blocks a query tile: the card full, or nseg
  const int bpt = per < 1 ? 1 : (per < nseg ? per : nseg);
  bq_sign_scores_kernel<<<(unsigned)(bpt * nqt), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(out), Q, W8, npad, n_valid, dim, sign, bpt);
  return static_cast<int>(cudaGetLastError());
}

int qtt_bq_search_exact(const void* qwords, const void* planes, void* cand_v,
                        void* cand_i, int Q, int W8, long long npad, int n_valid, int dim,
                        int sign, int split, int kk, void* stream) {
  using T = SignExactTile;
  static_assert(T::kBytes >= sizeof(unsigned) * 256 * (kThreads / 32), "hist in the ring");
  if (split % kSeg || kk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = (npad + split - 1) / split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk <= kQueueK) {
    using U = SignQueueTile;
    const unsigned grid = (unsigned)(nblk * ((Q + U::TQ - 1) / U::TQ));
    const size_t smem = kAlign + U::kBytes + hamming_bytes<U>() + QueueSelect<U::TQ>::bytes(kk);
    const cudaError_t err = queue_smem(bq_sign_queue_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bq_sign_queue_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
        static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, W8, npad, n_valid, dim,
        sign, split, kk);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned grid = (unsigned)(nblk * ((Q + T::TQ - 1) / T::TQ));
  const size_t smem = kAlign + T::kBytes + hamming_bytes<T>() +
                      sizeof(unsigned) * (size_t)T::TQ * (split + kKeyPad);
  cudaError_t err = cudaFuncSetAttribute(
      bq_sign_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bq_sign_exact_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, W8, npad, n_valid, dim,
      sign, split, kk);
  return static_cast<int>(cudaGetLastError());
}

// qtt_bq_search_approx scans ncomp compact rows: sel null for a dense scan
// (ncomp = npad), else T selected tiles of tile_n rows, a multiple of 512
// (K10; ncomp = T * tile_n).
// Pass 1 on the body the caller chose by qtt_bq_sign_approx_ws_tq:
// bq_sign_approx_ws_kernel with a tile of tq = 128 or 64 queries (its layout
// must fit), or bq_sign_approx_kernel for tq = 0; then, unless out_v / out_i
// are the parts' (each part a whole span block, the maxima the result), the
// combine.
int qtt_bq_search_approx(const void* qwords, const void* planes, void* part_v,
                         void* part_i, void* out_v, void* out_i, int Q, int W8,
                         long long npad, int n_valid, int dim, int sign, int part,
                         int span_rows, const void* sel, int tile_n, long long ncomp, int tq,
                         void* stream) {
  const bool in_place = out_v == part_v;
  if (part % kSeg || part / kSeg > 255 || span_rows % part || (in_place && span_rows != part) ||
      ncomp > INT_MAX || (tq && ((tq != 64 && tq != 128) || !sign_ws_depth(W8 / 8) ||
                                 !SignLayout(tq, W8).R)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nparts = (int)((ncomp + part - 1) / part);
  const ScanMap map = scan_map(sel, tile_n, nullptr, 0, 0);
  cudaError_t err =
      tq == 128 ? launch_sign_approx_ws<false, 128>(qwords, planes, part_v, part_i, Q, W8, npad,
                                                    ncomp, n_valid, dim, sign, part, map, s)
      : tq == 64 ? launch_sign_approx_ws<false, 64>(qwords, planes, part_v, part_i, Q, W8, npad,
                                                    ncomp, n_valid, dim, sign, part, map, s)
                 : launch_sign_approx_parts(qwords, planes, part_v, part_i, Q, W8, npad, ncomp,
                                            n_valid, dim, sign, part, map, s);
  if (err != cudaSuccess || in_place) return static_cast<int>(err);
  return static_cast<int>(launch_approx_combine(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, nparts,
      span_rows / part, s));
}

// The sign-query approx route for Q queries of W8 words, a function of the
// layout's fit alone: the query tile of bq_sign_approx_ws_kernel (128, or 64
// where Q <= 64; the wrapper then takes ktile.py approx_geometry's part), or
// 0 past it (bq_sign_approx_kernel: 2048-row parts and the combine).
int qtt_bq_sign_approx_ws_tq(int Q, int W8) { return sign_ws_tq(Q, W8); }

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
