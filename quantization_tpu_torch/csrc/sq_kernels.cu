// SQ-u8 scoring and fused search kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of quantization_tpu/ops/pallas/sq_kernel.py:
//   K3  qtt_sq_scores        <- sq_scores_pallas / _dot_kernel (sq_kernel.py:748, :100)
//   K12 qtt_sq_scores_l1     <- sq_scores_pallas / _l1_kernel (sq_kernel.py:748, :112)
//   K1  qtt_sq_search_exact  <- sq_search_pallas(mode="exact") /
//                               _make_dot_class_kernel (sq_kernel.py:433, :232)
//   K2  qtt_sq_search_approx <- sq_search_pallas(mode="approx") /
//                               _make_dot_topk_kernel (sq_kernel.py:353, :139)
//   K9b qtt_sq_search_exact with a tile selection <- sq_search_indexed(mode=
//                               "exact") / _make_dot_class_kernel_indexed (:664, :200)
//   K9a qtt_sq_search_approx with a tile selection <- sq_search_indexed(mode=
//                               "approx") / _make_dot_topk_kernel_indexed (:628, :169)
//
// All compute, for query q and corpus row n,
//     score = (mult[q * mstride] * dot(qcodes[q], codes[n]) + qoff[q]) + voff[n]
// (mstride 0: one multiplier for every query; 1: one each), and the searches
// then add the optional residual-IVF term corr of n's 512-row block, rounded
// once more, before they select; K12 the same with the L1 sum of absolute
// differences in place of the dot. K9a / K9b are the K2 / K1 bodies walking
// the IVF probe's selected tiles in place (ktile.cuh ScanMap): the probed
// buckets' rows stream from HBM with no gather copy, and the bound is the
// selected rows' bytes and int8 work, the probed fraction of a full scan.
// The bodies live in dot_scan.cuh, shared with the residual-BQ kernels.
// The int32 dot of int8 codes in [0, 127] is exact (127*127*D < 2^31 for any
// D below 133,000). K1-K3 round each epilogue step on its own (__fmul_rn /
// __fadd_rn, and the library is built with -fmad=false), so their scores
// equal the plain PyTorch version's to the bit; K12 rounds mult * acc +
// qoff once (in f64), as the JAX package's compiled L1 does (ROADMAP F24),
// and its plain version does the same.
//
// What bounds them on the H100: the main path's corpus is 100,000 x 1024
// int8 codes, 100 MB, and every search streams it from HBM at most 3.35 TB/s,
// so about 30 us per pass is the floor; the int8 work, 256 x 100,000 x 1024
// multiply-adds per 256-query batch, takes 26 us at the tensor cores' 1,979
// TOPS, and K3 writes a 102 MB score matrix (31 us). So K1-K3 and K9 are
// bound by bytes. K1-K3 and K9 run on the tensor-core body of dot_scan.cuh
// (wgmma m64n64k32, 128 corpus rows x 64 or 128 queries a block; its header
// gives the tiles, the registers and the measured times):
//   * K3 takes 128 queries a block, so the corpus is read twice at Q = 256,
//     the two tiles of a segment together; the int32 tile is staged through
//     shared memory and each output row leaves as coalesced stores, with the
//     epilogue applied on the way out;
//   * the fused searches never write the [Q, N] score matrix: K1 selects the
//     exact top-k of each block's rows inside the block (ktile.cuh: a
//     threshold-filtered queue over several 512-row splits for k <= 64, a
//     radix select of one split above), K2 keeps one running maximum per
//     stride class in registers, and only candidates reach device memory.
// K12 keeps a __dp4a body of its own (below): the tensor cores have no
// absolute-difference product. Its operations bind it, not its bytes (the
// same as K3's, 0.06 ms at 100k x 1024): 6.6e9 __vabsdiffu4 + __dp4a pairs
// a 256-query batch, which issue at 1.21e11 pairs a second per SM (61 a
// clock, csrc/probe/absdiff_rate.cu), 0.41 ms. The one tensor-core form of
// L1, thermometer codes through the b1 product (sum |q - c| = sum q + sum c
// - 2 sum_t [q > t][c > t] over the 127 levels of a code), would need 127
// bit products a byte pair, 0.44 ms at the b1 rate. K12 runs 0.60-0.61 ms,
// 65-67 % of the pairs' floor (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The C functions below are the SQ entry points. qtt_error_string, shared
// by every kernel source of the library, is defined here too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_scan.cuh"

namespace {

// ------------------------------------------------------------ K12 (L1)
// The __dp4a body: a block scores one 128-row segment against 32 queries,
// both staged 128 bytes of depth at a time into rows padded to 144 bytes
// (a warp's 16-byte reads free of bank conflicts); each thread holds a
// 4-query x 4-row register tile. Each four-byte step is __vabsdiffu4 then a
// __dp4a against 0x01010101 (exact as unsigned for bytes in [0, 127]). A
// __vsadu4 step was timed beside it and dropped: on an NVIDIA H100 80GB HBM3
// at 700 W it ran 0.71 ms against this step's 0.60-0.62 ms at 100k x 1024,
// Q = 256 (chip_smoke.py; PERF.md). grid (ceil(n_valid / 128), ceil(Q / 32)).
constexpr int kL1TQ = 32;
constexpr int kL1DKP = kDK + 16;
constexpr int kL1StageBytes = (kSeg + kL1TQ) * kL1DKP;

__device__ __forceinline__ int absdiff_dot(int a, int b, int c) {
  return (int)__dp4a(__vabsdiffu4((unsigned)a, (unsigned)b), 0x01010101u, (unsigned)c);
}

__global__ void __launch_bounds__(kThreads) l1_scores_kernel(
    const int8_t* __restrict__ codes, const int8_t* __restrict__ qcodes,
    const float* __restrict__ qoff, const float* __restrict__ mult,
    const float* __restrict__ voff, float* __restrict__ out, int Q, int n_valid, int D,
    int mstride) {
  __shared__ __align__(16) int8_t stage[kL1StageBytes];
  int8_t* cs = stage;
  int8_t* qs = stage + kSeg * kL1DKP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kL1TQ;
  const long long row0 = (long long)blockIdx.x * kSeg;
  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  for (int d0 = 0; d0 < D; d0 += kDK) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int t = 0; t < kSeg * (kDK / 16) / kThreads; ++t) {
      const int idx = tid + t * kThreads, r = idx >> 3, c = idx & 7;
      *reinterpret_cast<int4*>(cs + r * kL1DKP + c * 16) =
          __ldg(reinterpret_cast<const int4*>(codes + (row0 + r) * D + d0 + c * 16));
    }
    {
      const int r = tid >> 3, c = tid & 7, q = q0 + r;  // 32 rows x 8 vectors
      int4 v = make_int4(0, 0, 0, 0);
      if (q < Q)
        v = *reinterpret_cast<const int4*>(qcodes + (long long)q * D + d0 + c * 16);
      *reinterpret_cast<int4*>(qs + r * kL1DKP + c * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k16 = 0; k16 < kDK / 16; ++k16) {
      int4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = *reinterpret_cast<const int4*>(qs + (warp * 4 + j) * kL1DKP + k16 * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = *reinterpret_cast<const int4*>(cs + (lane + 32 * i) * kL1DKP + k16 * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int c = acc[j][i];
          c = absdiff_dot(a[j].x, b[i].x, c);
          c = absdiff_dot(a[j].y, b[i].y, c);
          c = absdiff_dot(a[j].z, b[i].z, c);
          acc[j][i] = absdiff_dot(a[j].w, b[i].w, c);
        }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) continue;
    const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + lane + 32 * i;
      if (row < n_valid)
        out[(long long)q * n_valid + row] = epilogue<true>(m, acc[j][i], qo, voff, row);
    }
  }
}

inline cudaError_t launch_l1_scores(const void* qcodes, const void* qoff, const void* mult,
                                    const void* codes, const void* voff, void* out, int Q,
                                    int n_valid, int D, int mstride, cudaStream_t s) {
  const dim3 grid((n_valid + kSeg - 1) / kSeg, (Q + kL1TQ - 1) / kL1TQ);
  l1_scores_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qcodes),
      static_cast<const float*>(qoff), static_cast<const float*>(mult),
      static_cast<const float*>(voff), static_cast<float*>(out), Q, n_valid, D, mstride);
  return cudaGetLastError();
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
  return static_cast<int>(launch_mma_scores<CodeRows, false>(
      codes, D, qcodes, qoff, mult, voff, out, Q, n_valid, D, mstride,
      static_cast<cudaStream_t>(stream)));
}

int qtt_sq_scores_l1(const void* qcodes, const void* qoff, const void* mult,
                     const void* codes, const void* voff, void* out, int Q,
                     int n_valid, int D, int mstride, void* stream) {
  return static_cast<int>(launch_l1_scores(qcodes, qoff, mult, codes, voff, out, Q, n_valid,
                                           D, mstride, static_cast<cudaStream_t>(stream)));
}

int qtt_sq_search_exact(const void* qcodes, const void* qoff, const void* mult,
                        const void* codes, const void* voff, void* cand_v,
                        void* cand_i, int Q, int ncomp, int n_valid, int D,
                        int split, int kk, int mstride, const void* sel, int tile_n,
                        const void* corr, long long corr_qs, long long corr_bs,
                        void* stream) {
  return static_cast<int>(launch_search_exact<CodeRows, false>(
      codes, D, qcodes, qoff, mult, voff, cand_v, cand_i, Q, ncomp, n_valid, D, split, kk,
      mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs), static_cast<cudaStream_t>(stream)));
}

int qtt_sq_search_approx(const void* qcodes, const void* qoff, const void* mult,
                         const void* codes, const void* voff, void* part_v,
                         void* part_i, void* out_v, void* out_i, int Q, int ncomp,
                         int n_valid, int D, int part, int span_rows, int mstride,
                         const void* sel, int tile_n, const void* corr, long long corr_qs,
                         long long corr_bs, void* stream) {
  return static_cast<int>(launch_search_approx<CodeRows, false>(
      codes, D, qcodes, qoff, mult, voff, part_v, part_i, out_v, out_i, Q, ncomp, n_valid, D,
      part, span_rows, mstride,
      scan_map(sel, tile_n, corr, corr_qs, corr_bs), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
