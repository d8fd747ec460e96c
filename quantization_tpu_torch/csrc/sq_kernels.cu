// SQ-u8 scoring and fused search kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of quantization_tpu/ops/pallas/sq_kernel.py:
//   K3 qtt_sq_scores        <- sq_scores_pallas / _dot_kernel (sq_kernel.py:748, :100)
//   K1 qtt_sq_search_exact  <- sq_search_pallas(mode="exact") /
//                              _make_dot_class_kernel (sq_kernel.py:433, :232)
//   K2 qtt_sq_search_approx <- sq_search_pallas(mode="approx") /
//                              _make_dot_topk_kernel (sq_kernel.py:353, :139)
//   K9b qtt_sq_search_exact with a tile selection <- sq_search_indexed(mode=
//                              "exact") / _make_dot_class_kernel_indexed (:664, :200)
//   K9a qtt_sq_search_approx with a tile selection <- sq_search_indexed(mode=
//                              "approx") / _make_dot_topk_kernel_indexed (:628, :169)
//
// All compute, for query q and corpus row n,
//     score = (mult[q * mstride] * dot(qcodes[q], codes[n]) + qoff[q]) + voff[n]
// (mstride 0: one multiplier for every query; 1: one each), and the searches
// then add the optional residual-IVF term corr of n's 512-row block, rounded
// once more, before they select. K9a / K9b are the K2 / K1 bodies walking
// the IVF probe's selected tiles in place (ktile.cuh ScanMap): the probed
// buckets' rows stream from HBM with no gather copy, and the bound is the
// selected rows' bytes and int8 work, the probed fraction of a full scan.
// with an exact int32 dot of int8 codes in [0, 127] (127*127*D < 2^31 for any
// D below 133,000). The epilogue rounds each step on its own (__fmul_rn /
// __fadd_rn, and the library is built with -fmad=false), so kernel scores
// equal the plain PyTorch version's to the bit.
//
// What bounds them on the H100: the main path's corpus is 100,000 x 1024
// int8 codes, 100 MB, and every search streams it from HBM at most 3.35 TB/s,
// so about 30 us per pass is the floor. The int8 work is 256 x 100,000 x 1024
// multiply-adds (26 G) per 256-query batch; on CUDA cores with __dp4a (4 MACs
// per instruction) that is some 0.5 ms at the card's integer issue rate, well
// above the HBM floor, so these first kernels are bound by instruction issue,
// not by memory. Their design does three things about it:
//   * a 32-query tile per block reuses every 128-byte corpus chunk it loads
//     32 times from shared memory, so the corpus is read from device memory
//     ceil(Q/32) times (8 passes at Q=256, most of it from L2);
//   * each thread holds a 4-query x 4-row register tile and reads operands as
//     16-byte vectors from shared memory, padded to 144-byte rows so the
//     vector reads of a warp are free of bank conflicts: 16 __dp4a per 2
//     shared-memory loads;
//   * the fused searches never write the [Q, N] score matrix: K1 selects the
//     exact top-k of each 512-row split inside the block (radix select in
//     shared memory, ktile.cuh), K2 keeps one running maximum per stride
//     class in registers, and only candidates reach device memory.
// The tensor cores (wgmma int8, ~2 POPS) and TMA pipelining are later work.
//
// The C functions below are the K1-K3 entry points. qtt_error_string, shared
// by every kernel source of the library, is defined here too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ktile.cuh"

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kTQ = 32;                   // queries per block: 4 per warp
constexpr int kSeg = 128;                 // corpus rows per segment: 4 per lane
constexpr int kDK = 128;                  // bytes of D per staged chunk
constexpr int kDKP = kDK + 16;            // padded shared-memory row stride
constexpr int kStageBytes = (kSeg + kTQ) * kDKP;

__device__ __forceinline__ float epilogue(float m, int acc, float qo, float vo) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m, __int2float_rn(acc)), qo), vo);
}

__device__ __forceinline__ int dot4(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

// acc[j][i] = dot(qcodes[q0 + 4*warp + j], codes[row0 + lane + 32*i]) for
// one 128-row segment. Rows row0 .. row0+127 must exist; queries >= Q read
// as zeros. Every thread of the block must call it (it synchronises).
__device__ __forceinline__ void segment_dot(
    const int8_t* __restrict__ qcodes, const int8_t* __restrict__ codes,
    int q0, int Q, long long row0, int D, int8_t* cs, int8_t* qs,
    int acc[4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  for (int d0 = 0; d0 < D; d0 += kDK) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int t = 0; t < kSeg * (kDK / 16) / kThreads; ++t) {
      const int idx = tid + t * kThreads, r = idx >> 3, c = idx & 7;
      const int4 v = *reinterpret_cast<const int4*>(
          codes + (row0 + r) * (long long)D + d0 + c * 16);
      *reinterpret_cast<int4*>(cs + r * kDKP + c * 16) = v;
    }
    {
      const int r = tid >> 3, c = tid & 7, q = q0 + r;  // 32 rows x 8 vectors
      int4 v = make_int4(0, 0, 0, 0);
      if (q < Q)
        v = *reinterpret_cast<const int4*>(qcodes + (long long)q * D + d0 + c * 16);
      *reinterpret_cast<int4*>(qs + r * kDKP + c * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k16 = 0; k16 < kDK / 16; ++k16) {
      int4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = *reinterpret_cast<const int4*>(qs + (warp * 4 + j) * kDKP + k16 * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = *reinterpret_cast<const int4*>(cs + (lane + 32 * i) * kDKP + k16 * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = dot4(a[j], b[i], acc[j][i]);
    }
  }
}

// ---------------------------------------------------------------- K3 scores
// grid (ceil(n_valid / 128), ceil(Q / 32)); out f32 [Q, n_valid].
__global__ void __launch_bounds__(kThreads) sq_scores_kernel(
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const int8_t* __restrict__ codes,
    const float* __restrict__ voff, float* __restrict__ out, int Q,
    int n_valid, int D, int mstride) {
  __shared__ __align__(16) int8_t stage[kStageBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long row0 = (long long)blockIdx.x * kSeg;
  int acc[4][4];
  segment_dot(qcodes, codes, q0, Q, row0, D, stage, stage + kSeg * kDKP, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) continue;
    const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + lane + 32 * i;
      if (row < n_valid)
        out[(long long)q * n_valid + row] = epilogue(m, acc[j][i], qo, voff[row]);
    }
  }
}

// ----------------------------------------------------------- K1 exact search
// K9b is the same kernel over selected tiles (map.sel; sq_search_indexed,
// sq_kernel.py:664 of the JAX package).
// grid (nsplit = ceil(ncomp / split), ceil(Q / 32)). Block (s, t) scores
// compact rows [s*split, s*split + split) of its 32 queries into shared
// memory as ordered keys, then each warp selects the exact top-kk of its 4
// queries among the split's valid rows (compact rows < n_valid) by a 4-pass
// radix select, and writes them, unordered, with their corpus rows, to
// cand_v / cand_i [Q, nsplit*kk] at columns s*kk .. s*kk+kk-1. Slots beyond
// the split's valid rows hold NEG / -1. A split lies in one selected tile
// (split divides tile_n), so its corpus rows are consecutive.
__global__ void __launch_bounds__(kThreads) sq_search_exact_kernel(
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const int8_t* __restrict__ codes,
    const float* __restrict__ voff, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int Q, int ncomp, int n_valid, int D, int split,
    int kk, int mstride, ScanMap map) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* cs = smem;
  int8_t* qs = smem + kSeg * kDKP;
  unsigned* keys = reinterpret_cast<unsigned*>(smem + kStageBytes);  // [32][split]
  unsigned* hist_all = keys + kTQ * split;                           // [8][256]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long start = (long long)blockIdx.x * split;
  const long long row0 = map.row(start);

  for (int off = 0; off < split && start + off < ncomp; off += kSeg) {
    int acc[4][4];
    segment_dot(qcodes, codes, q0, Q, row0 + off, D, cs, qs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(q0 + warp * 4 + j, Q - 1);  // rows >= Q are never read
      const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = off + lane + 32 * i;
        keys[(warp * 4 + j) * split + e] = float_to_key(
            map.add_corr(epilogue(m, acc[j][i], qo, voff[row0 + e]), q, start + e));
      }
    }
  }
  // Each warp wrote every key of its own 4 queries: no block barrier needed.
  __syncwarp();

  const long long valid = (long long)n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < split ? valid : split));
  const long long width = (long long)gridDim.x * kk;
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blockIdx.x * kk;
    warp_select_topk(keys + (warp * 4 + j) * split, cnt, kk, row0, cand_v + o,
                     cand_i + o, hist_all + warp * 256);
  }
}

// ---------------------------------------------------------- K2 approx search
// K9a is the same kernel over selected tiles (map.sel; sq_search_indexed,
// sq_kernel.py:628 of the JAX package).
// Pass 1, grid (ceil(ncomp / part), ceil(Q / 32)): block p keeps, for each
// of its queries and each stride class l (compact rows p*part + m*128 + l),
// the running maximum and its corpus row — strict ">" in compact order, so
// the first row wins ties, as the Pallas kernel's compares do. Compact rows
// >= n_valid score NEG. A 128-row segment lies in one selected tile.
// part_v / part_i: [Q, nparts*128].
__global__ void __launch_bounds__(kThreads) sq_approx_parts_kernel(
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const int8_t* __restrict__ codes,
    const float* __restrict__ voff, float* __restrict__ part_v,
    int* __restrict__ part_i, int Q, int ncomp, int n_valid, int D, int part,
    int mstride, ScanMap map) {
  __shared__ __align__(16) int8_t stage[kStageBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long start = (long long)blockIdx.x * part;
  float best[4][4];
  int arg[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[j][i] = -__int_as_float(0x7f800000);  // -inf: any score beats it
      arg[j][i] = -1;
    }
  for (int off = 0; off < part && start + off < ncomp; off += kSeg) {
    int acc[4][4];
    const long long seg0 = map.row(start + off);
    segment_dot(qcodes, codes, q0, Q, seg0, D, stage, stage + kSeg * kDKP, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(q0 + warp * 4 + j, Q - 1);
      const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long c = start + off + lane + 32 * i, row = seg0 + lane + 32 * i;
        const float s =
            c < n_valid ? map.add_corr(epilogue(m, acc[j][i], qo, voff[row]), q, c) : kNeg;
        if (s > best[j][i]) {
          best[j][i] = s;
          arg[j][i] = (int)row;
        }
      }
    }
  }
  const long long width = (long long)gridDim.x * kSlot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long c = (long long)q * width + (long long)blockIdx.x * kSlot + lane + 32 * i;
      part_v[c] = best[j][i];
      part_i[c] = arg[j][i];
    }
  }
}

}  // namespace

// ------------------------------------------------------------- C interface
// Every function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Shapes are checked by the Python wrappers
// (ops/kernels/sq_kernel.py): D % 128 == 0, npad % 512 == 0, 16-byte-aligned
// code pointers, contiguous tensors. The searches scan ncomp compact rows
// through the map (sel, tile_n, corr, corr_qs, corr_bs) of ktile.cuh: sel
// null for a dense scan (ncomp = npad), else T selected tiles of tile_n rows
// (a multiple of 512; ncomp = T * tile_n); corr null for no additive.

extern "C" {

const char* qtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qtt_sq_scores(const void* qcodes, const void* qoff, const void* mult,
                  const void* codes, const void* voff, void* out, int Q,
                  int n_valid, int D, int mstride, void* stream) {
  const dim3 grid((n_valid + kSeg - 1) / kSeg, (Q + kTQ - 1) / kTQ);
  sq_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const int8_t*>(codes),
      static_cast<const float*>(voff), static_cast<float*>(out), Q, n_valid, D,
      mstride);
  return static_cast<int>(cudaGetLastError());
}

int qtt_sq_search_exact(const void* qcodes, const void* qoff, const void* mult,
                        const void* codes, const void* voff, void* cand_v,
                        void* cand_i, int Q, int ncomp, int n_valid, int D,
                        int split, int kk, int mstride, const void* sel, int tile_n,
                        const void* corr, long long corr_qs, long long corr_bs,
                        void* stream) {
  const size_t smem = kStageBytes + sizeof(unsigned) * ((size_t)kTQ * split + 8 * 256);
  cudaError_t err = cudaFuncSetAttribute(
      sq_search_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ncomp + split - 1) / split, (Q + kTQ - 1) / kTQ);
  sq_search_exact_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const int8_t*>(codes),
      static_cast<const float*>(voff), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), Q, ncomp, n_valid, D, split, kk, mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs));
  return static_cast<int>(cudaGetLastError());
}

int qtt_sq_search_approx(const void* qcodes, const void* qoff, const void* mult,
                         const void* codes, const void* voff, void* part_v,
                         void* part_i, void* out_v, void* out_i, int Q, int ncomp,
                         int n_valid, int D, int part, int span_rows, int mstride,
                         const void* sel, int tile_n, const void* corr, long long corr_qs,
                         long long corr_bs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nparts = (ncomp + part - 1) / part;
  const dim3 grid(nparts, (Q + kTQ - 1) / kTQ);
  sq_approx_parts_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const int8_t*>(codes),
      static_cast<const float*>(voff), static_cast<float*>(part_v),
      static_cast<int*>(part_i), Q, ncomp, n_valid, D, part, mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_approx_combine(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, nparts,
      span_rows / part, s));
}

}  // extern "C"
