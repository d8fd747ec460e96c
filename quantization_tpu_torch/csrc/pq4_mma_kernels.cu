// 4-bit PQ with the int8 LUT on the tensor cores (sm_90a): K8 and the dense
// K7a as one-hot products on the int8 scan body of dot_scan.cuh.
//
// Replaces, for 4-bit codes (KC = 16) and the int8 LUT, the Pallas kernels of
// quantization_tpu/ops/pallas/pq_kernel.py:
//   K8  qtt_pq4_mma_scores         <- pq_scores_pallas, int8 LUT
//                                     (_make_scores_kernel_i8, pq_kernel.py:943)
//   K7a qtt_pq4_mma_search_approx  <- pq_search_pallas(mode="approx") /
//                                     _make_pq_topk_kernel (pq_kernel.py:791)
// Every other PQ launch (K7b, K11, the bf16 / bf16x2 LUTs, 8-bit codes)
// stays on the LUT-gather body of pq_kernels.cuh; the wrapper
// (ops/kernels/pq_kernel.py onehot_route) picks the route.
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
// row additive, and K7a adds voff (rowadd, or a zero row) and corr in the
// JAX order (score + rowadd) + corr before it selects.
//
// What bounds them on the H100, at 1M rows, m = 192 and Q = 256: the
// one-hot product is 2 * 256 * 1M * 3,072 = 1.57e12 int8 operations, 0.79 ms
// at 1,979 TOPS; K8 also writes a 1 GB score matrix (0.30 ms at 3.35 TB/s).
// The body's tiles and its measured rate are in dot_scan.cuh's header. K8
// runs the K3 tile (128 queries a block, the int32 tile staged through
// shared memory for coalesced row stores); K7a the approx tile over parts of
// SPAN * TILE_N = 4096 rows (32 segments), so that each part is one span
// block of the JAX geometry and no combine pass follows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_scan.cuh"

// ------------------------------------------------------------- C interface
// Both launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success). Shapes are checked by the Python
// wrapper: lutq int8 [Q, mpad * 16], scale / bias f32 [Q], codes_t u8
// [mpad, npad] (mpad % 16 == 0, npad % 1024 == 0), 16-byte-aligned
// contiguous tensors. The
// search takes voff f32 [npad] (rowadd, or zeros) and corr (null for none;
// corr_qs, corr_bs: ktile.cuh ScanMap), and writes out_v / out_i [Q,
// ceil(npad / part) * 128].

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
                              int part, const void* corr, long long corr_qs,
                              long long corr_bs, void* stream) {
  return static_cast<int>(launch_search_approx<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, out_v, out_i, out_v, out_i, Q, (int)npad,
      n_valid, mpad * 16, part, part, 1, scan_map(nullptr, 0, corr, corr_qs, corr_bs),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
