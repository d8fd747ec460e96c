// Top-k selection shared by the fused search kernels (sq_kernels.cu,
// bq_kernels.cu): the device twin of ops/kernels/ktile.py.
//
//   * warp_select_topk: one warp's exact top-k of a split's scores held as
//     ordered keys in shared memory (radix select, then compaction in row
//     order). It replaces the Pallas kernels' per-class top-r with a spill
//     bound (quantization_tpu/ops/pallas/ktile.py): each split returns its
//     exact top-min(k, rows), so the union of splits holds the exact top-k.
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
