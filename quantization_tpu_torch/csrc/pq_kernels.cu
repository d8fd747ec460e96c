// PQ kernels for 8-bit codes (KC = 256) and the C interface of the
// LUT-gather body; the kernels themselves are in pq_kernels.cuh, and
// pq4_kernels.cu holds the 4-bit instantiations of the searches, to which
// the entry points below forward kc = 16. K8 with 4-bit codes, and the
// searches with 4-bit codes and the int8 LUT, have entry points of their
// own, in pq4_mma_kernels.cu.

#include "pq_kernels.cuh"

// ------------------------------------------------------------- C interface
// Every function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a (kc,
// kind) pair it does not build. kc: 256 or 16 (searches only); kind: 0
// int8, 1 bf16, 2 bf16x2 (searches only). Shapes are checked by the Python wrappers
// (ops/kernels/pq_kernel.py): contiguous, 16-byte-aligned tensors,
// mpad % 16 == 0, npad % 1024 == 0. The searches take the residual
// additives rowadd [npad] and corr (corr_qs, corr_bs: ktile.cuh ScanMap),
// null for none; the approx search also a tile selection sel [ncomp /
// tile_n] (null: dense, ncomp = npad) and its span of compact rows, part.

extern "C" {

int qtt_pq4_search_exact(const void*, const void*, const void*, const void*, void*, void*,
                         int, int, long long, int, int, int, const void*, const void*,
                         long long, long long, void*);
int qtt_pq4_search_approx(const void*, const void*, const void*, const void*, void*, void*,
                          int, int, long long, int, int, const void*, const void*,
                          long long, long long, const void*, int, long long, int, void*);

int qtt_pq_scores(const void* lut, const void* scale, const void* bias,
                  const void* codes_t, void* out, int Q, int mpad, long long npad,
                  int n_valid, int kc, int kind, void* stream) {
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  // The tiles holding rows < n_valid, one a block.
  const long long ncomp = ((long long)n_valid + kPTR - 1) / kPTR * kPTR;
  const TileArgs a = tile_args(lut, scale, bias, codes_t, Q, mpad, npad, n_valid, nullptr,
                               nullptr, 0, 0, nullptr, 0, ncomp, kPTR);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {  // no bf16x2 K8: the wrapper rounds that LUT to bf16
    case kInt8: return launch_scores<256, kInt8>(a, out, s);
    case kBf16: return launch_scores<256, kBf16>(a, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int qtt_pq_search_exact(const void* lut, const void* scale, const void* bias,
                        const void* codes_t, void* cand_v, void* cand_i, int Q, int mpad,
                        long long npad, int n_valid, int kc, int kind, int kk,
                        const void* rowadd, const void* corr, long long corr_qs,
                        long long corr_bs, void* stream) {
  if (kc == 16)
    return qtt_pq4_search_exact(lut, scale, bias, codes_t, cand_v, cand_i, Q, mpad, npad,
                                n_valid, kind, kk, rowadd, corr, corr_qs, corr_bs, stream);
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a = tile_args(lut, scale, bias, codes_t, Q, mpad, npad, n_valid, rowadd,
                               corr, corr_qs, corr_bs, nullptr, 0, npad, kApproxPart);
  QTT_PQ_KIND_DISPATCH(launch_exact, 256, a, cand_v, cand_i, kk,
                       static_cast<cudaStream_t>(stream))
}

int qtt_pq_search_approx(const void* lut, const void* scale, const void* bias,
                         const void* codes_t, void* out_v, void* out_i, int Q, int mpad,
                         long long npad, int n_valid, int kc, int kind, const void* rowadd,
                         const void* corr, long long corr_qs, long long corr_bs,
                         const void* sel, int tile_n, long long ncomp, int part,
                         void* stream) {
  if (kc == 16)
    return qtt_pq4_search_approx(lut, scale, bias, codes_t, out_v, out_i, Q, mpad, npad,
                                 n_valid, kind, rowadd, corr, corr_qs, corr_bs, sel, tile_n,
                                 ncomp, part, stream);
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a = tile_args(lut, scale, bias, codes_t, Q, mpad, npad, n_valid, rowadd,
                               corr, corr_qs, corr_bs, sel, tile_n, ncomp, part);
  QTT_PQ_KIND_DISPATCH(launch_approx, 256, a, out_v, out_i,
                       static_cast<cudaStream_t>(stream))
}

}  // extern "C"
