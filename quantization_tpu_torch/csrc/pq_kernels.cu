// PQ kernels for 8-bit codes (KC = 256) and the C interface of every PQ
// kernel; the kernels themselves are in pq_kernels.cuh, and pq4_kernels.cu
// holds their 4-bit instantiations, to which the entry points below forward
// kc = 16.

#include "pq_kernels.cuh"

// ------------------------------------------------------------- C interface
// Every function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a (kc,
// kind) pair it does not build. kc: 256 or 16; kind: 0 int8, 1 bf16, 2
// bf16x2 (searches only). Shapes are checked by the Python wrappers
// (ops/kernels/pq_kernel.py): contiguous, 16-byte-aligned tensors,
// mpad % 16 == 0, npad % 1024 == 0.

extern "C" {

int qtt_pq4_scores(const void*, const void*, const void*, const void*, void*, int, int,
                   long long, int, int, void*);
int qtt_pq4_search_exact(const void*, const void*, const void*, const void*, void*, void*,
                         int, int, long long, int, int, int, void*);
int qtt_pq4_search_approx(const void*, const void*, const void*, const void*, void*, void*,
                          int, int, long long, int, int, void*);

int qtt_pq_scores(const void* lut, const void* scale, const void* bias,
                  const void* codes_t, void* out, int Q, int mpad, long long npad,
                  int n_valid, int kc, int kind, void* stream) {
  if (kc == 16)
    return qtt_pq4_scores(lut, scale, bias, codes_t, out, Q, mpad, npad, n_valid, kind,
                          stream);
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_scores, 256, a, out, static_cast<cudaStream_t>(stream))
}

int qtt_pq_search_exact(const void* lut, const void* scale, const void* bias,
                        const void* codes_t, void* cand_v, void* cand_i, int Q, int mpad,
                        long long npad, int n_valid, int kc, int kind, int kk,
                        void* stream) {
  if (kc == 16)
    return qtt_pq4_search_exact(lut, scale, bias, codes_t, cand_v, cand_i, Q, mpad, npad,
                                n_valid, kind, kk, stream);
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_exact, 256, a, cand_v, cand_i, kk,
                       static_cast<cudaStream_t>(stream))
}

int qtt_pq_search_approx(const void* lut, const void* scale, const void* bias,
                         const void* codes_t, void* out_v, void* out_i, int Q, int mpad,
                         long long npad, int n_valid, int kc, int kind, void* stream) {
  if (kc == 16)
    return qtt_pq4_search_approx(lut, scale, bias, codes_t, out_v, out_i, Q, mpad, npad,
                                 n_valid, kind, stream);
  if (kc != 256) return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a{lut, static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<const uint8_t*>(codes_t), Q, mpad, npad, n_valid};
  QTT_PQ_KIND_DISPATCH(launch_approx, 256, a, out_v, out_i,
                       static_cast<cudaStream_t>(stream))
}

}  // extern "C"
