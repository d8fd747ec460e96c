// PQ kernels for 4-bit codes (KC = 16), compiled apart from the 8-bit ones
// so that nvcc builds the two in parallel. Entered only through the C
// interface of pq_kernels.cu, which forwards kc = 16 here with the same
// arguments (less kc).

#include "pq_kernels.cuh"

extern "C" {

int qtt_pq4_scores(const void* lut, const void* scale, const void* bias,
                   const void* codes_t, void* out, int Q, int mpad, long long npad,
                   int n_valid, int kind, void* stream) {
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_scores, 16, a, out, static_cast<cudaStream_t>(stream))
}

int qtt_pq4_search_exact(const void* lut, const void* scale, const void* bias,
                         const void* codes_t, void* cand_v, void* cand_i, int Q, int mpad,
                         long long npad, int n_valid, int kind, int kk, void* stream) {
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_exact, 16, a, cand_v, cand_i, kk,
                       static_cast<cudaStream_t>(stream))
}

int qtt_pq4_search_approx(const void* lut, const void* scale, const void* bias,
                          const void* codes_t, void* out_v, void* out_i, int Q, int mpad,
                          long long npad, int n_valid, int kind, void* stream) {
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_approx, 16, a, out_v, out_i, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
