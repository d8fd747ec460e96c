// PQ searches for 4-bit codes (KC = 16), compiled apart from the 8-bit
// kernels so that nvcc builds the two in parallel. Entered only through the
// C interface of pq_kernels.cu, which forwards kc = 16 here with the same
// arguments (less kc). K8 with 4-bit codes runs on the tensor cores
// (pq4_mma_kernels.cu) for both of its LUT words.

#include "pq_kernels.cuh"

extern "C" {

int qtt_pq4_search_exact(const void* lut, const void* scale, const void* bias,
                         const void* codes_t, void* cand_v, void* cand_i, int Q, int mpad,
                         long long npad, int n_valid, int kind, int kk, const void* rowadd,
                         const void* corr, long long corr_qs, long long corr_bs,
                         void* stream) {
  const TileArgs a = tile_args(lut, scale, bias, codes_t, Q, mpad, npad, n_valid, rowadd,
                               corr, corr_qs, corr_bs, nullptr, 0, npad, kApproxPart);
  QTT_PQ_KIND_DISPATCH(launch_exact, 16, a, cand_v, cand_i, kk,
                       static_cast<cudaStream_t>(stream))
}

int qtt_pq4_search_approx(const void* lut, const void* scale, const void* bias,
                          const void* codes_t, void* out_v, void* out_i, int Q, int mpad,
                          long long npad, int n_valid, int kind, const void* rowadd,
                          const void* corr, long long corr_qs, long long corr_bs,
                          const void* sel, int tile_n, long long ncomp, int part,
                          void* stream) {
  const TileArgs a = tile_args(lut, scale, bias, codes_t, Q, mpad, npad, n_valid, rowadd,
                               corr, corr_qs, corr_bs, sel, tile_n, ncomp, part);
  QTT_PQ_KIND_DISPATCH(launch_approx, 16, a, out_v, out_i, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
