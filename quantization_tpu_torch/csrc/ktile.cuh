// Top-k selection shared by the fused search kernels (sq_kernels.cu,
// bq_kernels.cu, pq_kernels.cuh): the device twin of ops/kernels/ktile.py.
// Both exact selects replace the Pallas kernels' per-class top-r with a
// spill bound (quantization_tpu/ops/pallas/ktile.py): each block returns the
// exact top-min(kk, rows) of the rows it covers, the lower row first among
// equal scores, so the union of the blocks holds the exact top-k. Which one
// runs is a function of kk alone (kQueueK, ktile.py QUEUE_K_MAX):
//
//   * QueueSelect, kk <= 64 (the int8 body's exact searches, K1 / K9b / K5b /
//     4-bit K7b, and K5c): a queue of the kk best 64-bit keys a query and
//     its threshold, the queue's kk-th f32 key. A block walks a range of
//     several 512-row splits (one wave of two blocks a SM); after each
//     128-row segment's products the keys go through the ring into a
//     [query][row] tile, and the warp that owns a query keeps the rows
//     above its threshold, a few put in one by one, more sorted and merged
//     (warp-wide bitonic networks on shuffles, as FAISS's WarpSelect), so
//     after the first segments almost no row costs more than a compare.
//     With no split-wide key buffer the block holds two blocks a SM.
//     Measured (NVIDIA H100 80GB HBM3, 700 W; csrc/probe/select_split.cu,
//     PERF.md): K1's scan alone 0.0722 ms, the kernel 0.1975 on random
//     scores and 0.1216 on scores that fall with the row (no survivor past
//     a block's first segment): a block's owner warps keep its scan waiting
//     (the next segment's barrier), so the select shows end to end. Tried
//     and dropped on the way (same card, same probe): offers from the
//     epilogue by shared atomics into a buffer (the block's 8 warps hit the
//     same 4 counters a step: K1 0.2394-0.3125), a buffer merged when full,
//     the shifts through shared memory in place of shuffles (0.2016), and
//     half the blocks started half a segment late (no change).
//   * warp_select_topk, kk > 64 (and the LUT-gather K7b at every kk): one
//     warp's exact top-k of a 512-row split's scores held as ordered keys in
//     shared memory (radix select, then compaction in row order).
//   * approx_combine_kernel: pass 2 of the approx searches — the in-order
//     max-merge of per-part stride-class maxima over each span block
//     (ktile.combine_slots of the JAX package).
//   * ScanMap: the scan's row map and its per-block additive. A search runs
//     over "compact" rows c = 0 .. ncomp-1; a dense scan reads corpus row c,
//     an indexed scan (the IVF probe, K9a / K9b / K10 / K11) reads row
//     sel[c / tile_n] * tile_n + c % tile_n, so the j-th selected tile
//     streams in place with no gather copy. corr, when given, adds one f32
//     per (query, 512-row block of compact rows): the residual-IVF bucket
//     term (sq_kernel.py:48-55 of the JAX package), after the epilogue and
//     before selection. Null pointers mean a dense scan and no additive, so
//     no kernel is instantiated twice for them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3.4e38f;  // ktile.NEG
constexpr int kSlot = 128;        // stride classes per approx block
constexpr int kCorrShift = 9;     // log2 of CORR_BLK = 512 rows per corr value

struct ScanMap {
  const int* sel;        // [T] selected tile ids, or null: a dense scan
  int tile_n;            // rows per selected tile (a multiple of 16)
  const float* corr;     // additive, or null
  long long corr_qs;     // corr of query q, block b: corr[q * corr_qs + b * corr_bs]
  long long corr_bs;     //   ([Q, N/512]: qs = N/512, bs = 1; [T*tile_n/512, Q]: qs = 1, bs = Q)

  // The corpus row of compact row c.
  __device__ __forceinline__ long long row(long long c) const {
    return sel ? (long long)sel[c / tile_n] * tile_n + c % tile_n : c;
  }

  // s + corr of query q at compact row c, rounded once (plain torch's add).
  __device__ __forceinline__ float add_corr(float s, int q, long long c) const {
    return corr ? __fadd_rn(s, corr[q * corr_qs + (c >> kCorrShift) * corr_bs]) : s;
  }
};

inline ScanMap scan_map(const void* sel, int tile_n, const void* corr, long long corr_qs,
                        long long corr_bs) {
  return ScanMap{static_cast<const int*>(sel), tile_n, static_cast<const float*>(corr),
                 corr_qs, corr_bs};
}

// mbarriers in shared memory (the LUT ring, pq_kernels.cuh; the
// warp-specialized approx bodies, dot_scan.cuh and bq_kernels.cu).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

// The issuing thread's arrival, with the bytes its bulk copies will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Order-preserving map f32 -> u32: a > b as floats iff key(a) > key(b).
__device__ __forceinline__ unsigned float_to_key(float f) {
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned k) {
  unsigned u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(u);
}

// Called by all 32 lanes of one warp. kq[0..cnt) are the ordered keys of a
// split whose first row is `start`; hist is this warp's 256-word scratch in
// shared memory. Writes the exact top-min(kk, cnt) keys, unordered, as
// (value, row) to ov / oi[0 ..), every key above the threshold first and
// then the equal ones in row order, and NEG / -1 to the slots after them.
__device__ __forceinline__ void warp_select_topk(
    const unsigned* kq, int cnt, int kk, long long start, float* ov, int* oi,
    unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu, lt = (1u << lane) - 1u;
  const int take = min(kk, cnt);
  for (int s = take + lane; s < kk; s += 32) {
    ov[s] = kNeg;
    oi[s] = -1;
  }
  if (take == 0) return;

  // Radix select, most significant byte first: thr = the take-th largest
  // key; remaining = how many elements equal to thr belong to the top-take.
  unsigned prefix = 0, mask = 0;
  int remaining = take;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int e = lane; e < cnt; e += 32) {
      const unsigned key = kq[e];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncwarp();
    // Lane l owns bins 255-8l .. 248-8l, scanned from the top down.
    int local[8], sum = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      local[t] = (int)hist[255 - 8 * lane - t];
      sum += local[t];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = incl - sum;
    const bool mine = excl < remaining && remaining <= incl;
    const int src = __ffs(__ballot_sync(full, mine)) - 1;
    int digit = 0, rem = 0;
    if (mine) {
      int cum = excl;
      bool found = false;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (!found && cum + local[t] >= remaining) {
          digit = 255 - 8 * lane - t;
          rem = remaining - cum;
          found = true;
        }
        cum += local[t];
      }
    }
    digit = __shfl_sync(full, digit, src);
    rem = __shfl_sync(full, rem, src);
    prefix |= (unsigned)digit << shift;
    mask |= 255u << shift;
    remaining = rem;
    __syncwarp();
  }
  const unsigned thr = prefix;
  const int n_gt = take - remaining;

  // Compaction in row order: every key > thr, then the first `remaining`
  // keys == thr.
  int gt_pos = 0, eq_pos = 0;
  for (int base = 0; base < cnt; base += 32) {
    const int e = base + lane;
    const unsigned key = e < cnt ? kq[e] : 0u;
    const bool gt = e < cnt && key > thr, eq = e < cnt && key == thr;
    const unsigned bg = __ballot_sync(full, gt), be = __ballot_sync(full, eq);
    int slot = -1;
    if (gt) slot = gt_pos + __popc(bg & lt);
    if (eq) {
      const int r = eq_pos + __popc(be & lt);
      if (r < remaining) slot = n_gt + r;
    }
    if (slot >= 0) {
      ov[slot] = key_to_float(key);
      oi[slot] = (int)(start + e);
    }
    gt_pos += __popc(bg);
    eq_pos += __popc(be);
  }
}

// ------------------------------------------------------------ queue select

constexpr int kQueueK = 64;    // the queue route's largest kk (ktile.py QUEUE_K_MAX)

using u64 = unsigned long long;

// A candidate as one 64-bit key: the f32 order key above, the one's
// complement of its compact row (< 2^31) below, so one compare orders by
// score and then puts the lower row first, the order the radix select's
// compaction gives. 0 is no candidate: every real key is above it.
__device__ __forceinline__ u64 cand_of(unsigned key, long long c) {
  return ((u64)key << 32) | (unsigned)~(unsigned)c;
}
__device__ __forceinline__ long long cand_row(u64 v) {
  return (long long)(unsigned)~(unsigned)v;
}

// One warp's 64 keys, element i = 32r + lane in v[r], sorted descending:
// a bitonic sort, the pairs across lanes exchanged by shuffles.
__device__ __forceinline__ void sort64_desc(u64 (&v)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: the partner is the lane's other element
        const u64 a = v[0], b = v[1];
        v[0] = a > b ? a : b;
        v[1] = a > b ? b : a;
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const u64 o = __shfl_xor_sync(0xffffffffu, v[r], j);
          const bool desc = ((32 * r + lane) & k) == 0, lo = (lane & j) == 0;
          v[r] = (lo == desc) == (v[r] > o) ? v[r] : o;
        }
      }
    }
  }
}

// q = the 64 largest of q and b (both sorted descending), sorted descending:
// max(q[i], b[63 - i]) is a bitonic sequence holding them, and the half
// cleaners sort it.
__device__ __forceinline__ void merge64_desc(u64 (&q)[2], const u64 (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const u64 b1 = __shfl_xor_sync(0xffffffffu, b[1], 31);
  const u64 b0 = __shfl_xor_sync(0xffffffffu, b[0], 31);
  q[0] = q[0] > b1 ? q[0] : b1;
  q[1] = q[1] > b0 ? q[1] : b0;
  const u64 a = q[0], c = q[1];
  q[0] = a > c ? a : c;
  q[1] = a > c ? c : a;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const u64 o = __shfl_xor_sync(0xffffffffu, q[r], j);
      q[r] = ((lane & j) == 0) == (q[r] > o) ? q[r] : o;
    }
  }
}

// q (descending, element i = 32r + lane in q[r], 0 at and past kk) with x
// put in its place, the kk-th entry dropped: the entries above x count its
// place, and the ones at or past it move down by one.
__device__ __forceinline__ void insert64_desc(u64 (&q)[2], u64 x, int kk) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int pos = __popc(__ballot_sync(full, q[0] > x)) + __popc(__ballot_sync(full, q[1] > x));
  if (pos >= kk) return;  // warp-uniform
  const u64 up0 = __shfl_up_sync(full, q[0], 1), up1 = __shfl_up_sync(full, q[1], 1);
  const u64 last0 = __shfl_sync(full, q[0], 31);
  const int i0 = lane, i1 = 32 + lane;
  q[0] = i0 < pos ? q[0] : i0 == pos ? x : up0;
  q[1] = i1 < pos ? q[1] : i1 == pos ? x : (lane == 0 ? last0 : up1);
  if (i0 >= kk) q[0] = 0ull;
  if (i1 >= kk) q[1] = 0ull;
}

// The queue select of a block of TQ queries: per query, a queue of its kk
// best candidates so far, descending (0 = none), and thr, the f32 key of
// the queue's kk-th entry (0 while it holds fewer), in shared memory
// (carved from `p`; bytes(kk) long, 8-byte aligned), and for one segment at
// a time the segment's keys [TQ][kKeyStride] in the scan's ring, free
// between a segment's products and the next segment's loads.
// A segment's protocol: every thread writes its accumulators' order keys
// into that tile (0 for a row that is not a candidate: no real key is 0);
// then the warp that owns a query (TQ / 8 a warp) reads the query's 128
// keys, four a lane, and keeps those above thr: a block meets its rows in
// increasing order and thr comes from earlier segments, so a key equal to
// thr belongs to a later row than the queue's kk-th and cannot enter. The
// survivors go into the queue (take): a few one by one (insert64_desc,
// each against the queue as it then stands, so most of a segment's later
// survivors drop out), more in a sort and merge of 64 (sort64_desc,
// merge64_desc), and thr rises. Every query's state is its owner warp's
// alone: no atomics, no buffer, and no barrier beyond the tile's two.
constexpr int kKeyRows = 128;             // a segment's rows
constexpr int kKeyStride = kKeyRows + 4;  // spreads the fragment's writes over the banks
constexpr int kInsertMax = 16;            // survivors taken one by one; more are sorted

// All 32 lanes of the warp that owns a query: the segment's rows row0 +
// 4 lane + i whose keys k[i] pass (bit i of `pass`; the keys also at
// keys[4 lane + i], the query's row of the segment's key tile) into its
// queue of kk. Few survivors go in one by one, in row order, each against
// the queue as it then stands; more (a block's first segments) as two sets
// of 64 (k[0], k[1] and k[2], k[3] of every lane), each sorted and merged.
// Returns the f32 key of the queue's kk-th entry (0 while it holds fewer).
__device__ __forceinline__ unsigned queue_take(u64* queue, const unsigned* keys,
                                               const unsigned (&k)[4], unsigned pass,
                                               long long row0, int kk) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  u64 q[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) q[r] = 32 * r + lane < kk ? queue[32 * r + lane] : 0ull;
  unsigned m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = __ballot_sync(full, (pass >> i) & 1u);
  if (__popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]) <= kInsertMax) {
    // Row order: lane-major, element-minor.
    for (unsigned lanes = m[0] | m[1] | m[2] | m[3]; lanes; lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((m[i] >> src) & 1u)
          insert64_desc(q, cand_of(keys[4 * src + i], row0 + 4 * src + i), kk);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u64 b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 2 * h + r;
        b[r] = (pass >> i) & 1u ? cand_of(k[i], row0 + 4 * lane + i) : 0ull;
      }
      sort64_desc(b);
      merge64_desc(q, b);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (32 * r + lane >= kk) q[r] = 0ull;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (32 * r + lane < kk) queue[32 * r + lane] = q[r];
  const u64 kth = __shfl_sync(full, kk > 32 ? q[1] : q[0], (kk - 1) & 31);
  __syncwarp();
  return (unsigned)(kth >> 32);
}

template <int TQ>
struct QueueSelect {
  u64* queue;
  unsigned* thr;
  unsigned* keys;
  int kk;

  static constexpr size_t bytes(int kk) { return (size_t)TQ * (8 * (size_t)kk + 4); }

  // Every thread of the block, before the block's first barrier; ring is
  // the scan's ring (at least TQ * kKeyStride * 4 bytes).
  __device__ __forceinline__ void init(uint8_t* p, uint8_t* ring, int kk_) {
    kk = kk_;
    queue = reinterpret_cast<u64*>(p);
    thr = reinterpret_cast<unsigned*>(queue + TQ * kk);
    keys = reinterpret_cast<unsigned*>(ring);
    for (int i = threadIdx.x; i < TQ * kk; i += blockDim.x) queue[i] = 0ull;
    for (int i = threadIdx.x; i < TQ; i += blockDim.x) thr[i] = 0u;
  }

  // The warp that owns query j, at the block's end: the queue's kk slots,
  // as (value, corpus row), NEG / -1 where it holds no candidate.
  __device__ __forceinline__ void write(int j, float* ov, int* oi, const ScanMap& map) const {
    const int lane = threadIdx.x & 31;
    for (int s = lane; s < kk; s += 32) {
      const u64 v = queue[j * kk + s];
      ov[s] = v ? key_to_float((unsigned)(v >> 32)) : kNeg;
      oi[s] = v ? (int)map.row(cand_row(v)) : -1;
    }
  }
};

// A queue kernel's launch attributes: its dynamic shared memory, and the
// carveout that gives shared memory all of the SM's 228 KB, so that two
// blocks fit beside each other.
template <class Kernel>
inline cudaError_t queue_smem(Kernel* kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// Pass 2 of an approx search, one thread per output slot: slot (q, b, l) =
// first maximum over the parts of span block b (parts b*ppb .. b*ppb+ppb-1,
// in row order). part_v / part_i: [Q, nparts*128]; out_v / out_i:
// [Q, nblocks*128].
__global__ void approx_combine_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    float* __restrict__ out_v, int* __restrict__ out_i, int Q, int nparts,
    int ppb, int nblocks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_q = (long long)nblocks * kSlot;
  if (t >= (long long)Q * per_q) return;
  const int q = (int)(t / per_q), c = (int)(t % per_q);
  const int b = c / kSlot, l = c % kSlot;
  const int p_end = min((b + 1) * ppb, nparts);
  const long long row = (long long)q * nparts * kSlot;
  float best = part_v[row + (long long)b * ppb * kSlot + l];
  int arg = part_i[row + (long long)b * ppb * kSlot + l];
  for (int p = b * ppb + 1; p < p_end; ++p) {
    const float v = part_v[row + (long long)p * kSlot + l];
    if (v > best) {
      best = v;
      arg = part_i[row + (long long)p * kSlot + l];
    }
  }
  out_v[t] = best;
  out_i[t] = arg;
}

// Launches approx_combine_kernel for span blocks of `ppb` parts.
inline cudaError_t launch_approx_combine(const float* part_v, const int* part_i,
                                         float* out_v, int* out_i, int Q,
                                         int nparts, int ppb,
                                         cudaStream_t stream) {
  const int nblocks = (nparts + ppb - 1) / ppb;
  const long long total = (long long)Q * nblocks * kSlot;
  approx_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_v, part_i, out_v, out_i, Q, nparts, ppb, nblocks);
  return cudaGetLastError();
}

}  // namespace
