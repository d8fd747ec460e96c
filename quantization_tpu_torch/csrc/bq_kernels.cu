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
// f32 epilogue could give -0.0). K5a / K10 keep the approx body's geometry
// (approx_parts_kernel: 64 queries a block, two blocks a SM, running maxima
// per stride class over APPROX_PART-row parts, the JAX approx geometry, so
// their candidates are the plain approx's to the bit), the maxima kept on
// the row's integer term, the query's added once at the end. K5c selects
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
// of int8 operations. The kernels run far above that floor: a 128-row
// segment's depth is 1.5 chunks, so the ring barely fills and each segment
// pays its barriers, its query copies and its epilogue; the select takes
// half of K5c's time (its scan alone 0.4887 ms, the kernel 1.1491 on random
// planes, csrc/probe/select_split.cu). Same card (scan_ab.py in turns;
// PERF.md): K5a 0.80, K5c 3.37 on the radix select and 1.25 on the queue,
// K10 over 262,144 rows of 768 dims 0.25 ms, where the
// popcount body these replaced (one __popc(q ^ c) per word, query and row on
// the CUDA cores, ~3 ms of popc issue) ran 3.79, 6.12 and 0.62, and the +-1
// int8 route on PlaneRows runs 1.75 and 5.98. Also measured: K5c in the exact
// body's geometry (64 queries, 8 a warp, one block a SM) 4.77; K5a with a
// float running maximum 0.91 (the integer one below 0.79); K5a with every
// prologue chunk's loads issued before the first store 0.83 (96 bytes of
// spills); K5a with no plane loads at all (wrong sums, a timing probe) 0.65.
// Over 262,144 rows of 768 dims K5c is select-bound, 0.84 ms against the
// popcount kernel's 0.80.
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
// of the JAX package): pass 1, grid ceil(ncomp / part) * ceil(Q / 64), the
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

// ---------------------------------------------------------------- K6 scores

// Bulk stores of shared memory to device memory (the async proxy): one
// group a thread, committed and waited on by the thread that issued it.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Returns once this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Returns once this thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

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
int qtt_bq_search_approx(const void* qwords, const void* planes, void* part_v,
                         void* part_i, void* out_v, void* out_i, int Q, int W8,
                         long long npad, int n_valid, int dim, int sign, int part,
                         int span_rows, const void* sel, int tile_n, long long ncomp,
                         void* stream) {
  if (part % kSeg || part / kSeg > 255) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = kAlign + ApproxTile::kBytes + hamming_bytes<ApproxTile>();
  cudaError_t err = cudaFuncSetAttribute(
      bq_sign_approx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nparts = (int)((ncomp + part - 1) / part);
  const unsigned grid = (unsigned)nparts * ((Q + ApproxTile::TQ - 1) / ApproxTile::TQ);
  bq_sign_approx_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(qwords), static_cast<const uint32_t*>(planes),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, W8, npad, ncomp, n_valid,
      dim, sign, part, scan_map(sel, tile_n, nullptr, 0, 0));
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
