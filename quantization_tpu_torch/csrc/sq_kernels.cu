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
// K12 is K3's structure with a byte-SIMD absolute difference per four-byte
// step (dot_scan.cuh AbsDiffDotOp, __vabsdiffu4 + __dp4a): the same bytes,
// so the same 0.06 ms HBM bound at 100k x 1024; it measured within 5 % of
// K3's time on the H100, where a __vsadu4 step ran about 20 % above it.
// The tensor cores (wgmma int8, ~2 POPS) and TMA pipelining are later work.
//
// The C functions below are the SQ entry points. qtt_error_string, shared
// by every kernel source of the library, is defined here too.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dot_scan.cuh"

namespace {

template <class Op>
cudaError_t launch_scores(const void* qcodes, const void* qoff, const void* mult,
                          const void* codes, const void* voff, void* out, int Q,
                          int n_valid, int D, int mstride, cudaStream_t s) {
  const dim3 grid((n_valid + kSeg - 1) / kSeg, (Q + kTQ - 1) / kTQ);
  constexpr bool kOnce = !std::is_same<Op, DotOp>::value;  // L1 rounds once (F24)
  scores_kernel<CodeRows, Op, kOnce><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(codes), D, static_cast<const int8_t*>(qcodes),
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
  return static_cast<int>(launch_scores<DotOp>(qcodes, qoff, mult, codes, voff, out, Q,
                                               n_valid, D, mstride,
                                               static_cast<cudaStream_t>(stream)));
}

int qtt_sq_scores_l1(const void* qcodes, const void* qoff, const void* mult,
                     const void* codes, const void* voff, void* out, int Q,
                     int n_valid, int D, int mstride, void* stream) {
  return static_cast<int>(launch_scores<AbsDiffDotOp>(qcodes, qoff, mult, codes, voff, out,
                                                      Q, n_valid, D, mstride,
                                                      static_cast<cudaStream_t>(stream)));
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
