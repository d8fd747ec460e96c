// 4-bit PQ with the int8 LUT on the tensor cores (sm_90a): K8, K7a, K7b and
// K11 as one-hot products on the int8 scan body of dot_scan.cuh.
//
// Replaces, for 4-bit codes (KC = 16) and the int8 LUT, the Pallas kernels of
// quantization_tpu/ops/pallas/pq_kernel.py:
//   K8  qtt_pq4_mma_scores         <- pq_scores_pallas, int8 LUT
//                                     (_make_scores_kernel_i8, pq_kernel.py:943)
//   K7a qtt_pq4_mma_search_approx  <- pq_search_pallas(mode="approx") /
//                                     _make_pq_topk_kernel (pq_kernel.py:791)
//   K11 qtt_pq4_mma_search_approx with a tile selection <- pq_search_indexed /
//                                     _make_pq_topk_kernel_indexed (pq_kernel.py:582)
//   K7b qtt_pq4_mma_search_exact   <- pq_search_pallas(mode="exact") /
//                                     _make_pq_class_kernel (pq_kernel.py:866)
// Every other PQ launch (the bf16 / bf16x2 LUTs, 8-bit codes) runs the
// LUT-gather body of pq_kernels.cuh; the wrapper (ops/kernels/pq_kernel.py
// onehot_route) picks the route.
//
// The JAX kernel computes score[q, n] = sum_c lut[q, c, :] . onehot(code[n,
// c]) on the MXU (pq_kernel.py:1-37), and so does this one, on wgmma:
//   * A (corpus rows, the M side): NibbleRows expands the transposed codes
//     u8 [mpad, npad] to 16 one-hot bytes per chunk, one swizzle piece each;
//   * B (queries, the N side): the int8 LUT flattened to [Q, mpad * 16], zero
//     past m (quantize_lut's entries, no transposition: the JAX package's
//     lut_flat, pq_kernel.py:932-933). The depth D = mpad * 16 is a multiple
//     of 256.
// The sum is exact: LUT entries lie in [-127, 127] and the one-hot bytes in
// {0, 1}, so the s32 accumulator equals the gather body's int32 sum to the
// bit. The epilogue is f32(f64(scale) * acc + f64(bias)), rounded once, as
// the gather body and the plain version round it (ROADMAP F14); K8 adds no
// row additive, and the searches add voff and corr in the JAX order (score +
// rowadd) + corr before they select. Without a rowadd the wrapper passes a
// row of -0.0 as voff: x + (-0.0) == x for every x under round-to-nearest,
// where a +0.0 row would turn a -0.0 score into +0.0, a different key of
// the exact select (ktile.cuh float_to_key).
//
// What bounds them on the H100, at 1M rows, m = 192 and Q = 256: the
// one-hot product is 2 * 256 * 1M * 3,072 = 1.57e12 int8 operations, 0.79 ms
// at 1,979 TOPS; K8 also writes a 1 GB score matrix (0.30 ms at 3.35 TB/s).
// The body's tiles and its measured rate are in dot_scan.cuh's header. K8
// runs the K3 tile (128 queries a block, the int32 tile staged through
// shared memory for coalesced row stores); K7a and K11 the approx tile over
// parts of SPAN * tile_n rows (SPAN * TILE_N = 4096 dense: 32 segments), so
// that each part is one span block of the JAX geometry and no combine pass
// follows; K7b the exact tile, each 512-row split radix-selecting its
// top-min(k, 512) (ktile.cuh), which binds it as it binds K1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_scan.cuh"

namespace {
constexpr int kExactSplit = 512;  // rows per exact split, as every exact search (F10)
}  // namespace

// ------------------------------------------------------------- C interface
// Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Shapes are checked by the Python
// wrapper: lutq int8 [Q, mpad * 16], scale / bias f32 [Q], codes_t u8
// [mpad, npad] (mpad % 16 == 0, npad % 1024 == 0), 16-byte-aligned
// contiguous tensors. The searches take voff f32 [npad] (rowadd, or a row
// of -0.0) and corr (null for none; corr_qs, corr_bs: ktile.cuh ScanMap).
// The approx search also takes a tile selection sel [ncomp / tile_n] (null:
// dense, ncomp = npad) and writes out_v / out_i [Q, ceil(ncomp / part) *
// 128]; the exact search writes cand_v / cand_i [Q, npad / 512 * kk].

extern "C" {

int qtt_pq4_mma_scores(const void* lutq, const void* scale, const void* bias,
                       const void* codes_t, void* out, int Q, int mpad, long long npad,
                       int n_valid, void* stream) {
  return static_cast<int>(launch_mma_scores<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, nullptr, out, Q, n_valid, mpad * 16, 1,
      static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_approx(const void* lutq, const void* scale, const void* bias,
                              const void* codes_t, const void* voff, void* out_v,
                              void* out_i, int Q, int mpad, long long npad, int n_valid,
                              int part, const void* sel, int tile_n, long long ncomp,
                              const void* corr, long long corr_qs, long long corr_bs,
                              void* stream) {
  return static_cast<int>(launch_search_approx<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, out_v, out_i, out_v, out_i, Q, (int)ncomp,
      n_valid, mpad * 16, part, part, 1, scan_map(sel, tile_n, corr, corr_qs, corr_bs),
      static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_exact(const void* lutq, const void* scale, const void* bias,
                             const void* codes_t, const void* voff, void* cand_v,
                             void* cand_i, int Q, int mpad, long long npad, int n_valid,
                             int kk, const void* corr, long long corr_qs, long long corr_bs,
                             void* stream) {
  return static_cast<int>(launch_search_exact<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, cand_v, cand_i, Q, (int)npad, n_valid,
      mpad * 16, kExactSplit, kk, 1, scan_map(nullptr, 0, corr, corr_qs, corr_bs),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
