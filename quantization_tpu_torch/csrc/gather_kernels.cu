// SQ candidate rescoring for Hopper (sm_90a): the fine stage of two-stage
// retrieval.
//
// Replaces the Pallas kernel of quantization_tpu/ops/pallas/gather.py:
//   K4 qtt_sq_rescore <- gather_rows_pallas / _gather_kernel (gather.py:135)
// together with the scoring that follows it in the JAX package
// (models/sq.py:453-467, _score_gathered): for query q and candidate slot r
// with id = cand[q][r],
//     out[q][r] = (mult[q * mstride] * k(qcodes[q], codes[id]) + qoff[q]) + voff[id]
// where k is the int8 dot (DOT, L2) or the sum of absolute differences (L1),
// and mstride is 0 for one multiplier of every query, 1 for one each.
// The gathered [Q, R, D] rows are never written: the TPU needed them as a
// dense tile for its matrix unit, a GPU warp reads the row and scores it.
//
// One warp per candidate. Its lanes read the row as 16-byte vectors, all in
// one pass (1536 bytes at the main path's width: 3 loads a lane), and sum
// with __dp4a, or __vsadu4 for L1 (codes lie in [0, 127], so unsigned and
// signed bytes agree); a shuffle reduction and the epilogue follow. The
// epilogue rounds each step (__fmul_rn / __fadd_rn, the library is built
// with -fmad=false), so the scores equal the plain PyTorch version to the
// bit.
//
// An id outside [0, n_valid) (a coarse stage's padding -1, a padding row, a
// row past the matrix) scores -inf and reads nothing, as in the plain
// version. The JAX gather reads some row for -1 instead (ROADMAP F4/F5).
//
// What bounds it on the H100: it reads Q*R rows of D bytes, 15.7 MB at
// Q=256, R=40, D=1536 (4.7 us at 3.35 TB/s), scattered over the 1.5 GB code
// matrix: each row is 12 lines of 128 bytes at a random address, so the
// reads are latency-bound; one warp per row keeps 10,240 rows in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGThreads = 256;  // 8 candidates per block

__global__ void __launch_bounds__(kGThreads) sq_rescore_kernel(
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const int8_t* __restrict__ codes,
    const float* __restrict__ voff, const int* __restrict__ cand,
    float* __restrict__ out, int Q, int R, int n_valid, int D, int l1, int mstride) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * (kGThreads / 32) + (threadIdx.x >> 5);
  if (t >= (long long)Q * R) return;
  const int q = (int)(t / R);
  const int id = cand[t];
  if (id < 0 || id >= n_valid) {
    if (lane == 0) out[t] = -__int_as_float(0x7f800000);
    return;
  }
  const int4* a = reinterpret_cast<const int4*>(qcodes + (long long)q * D);
  const int4* b = reinterpret_cast<const int4*>(codes + (long long)id * D);
  int acc = 0;
  for (int c = lane; c < D / 16; c += 32) {
    const int4 x = a[c], y = __ldg(b + c);
    if (l1) {
      acc += (int)(__vsadu4(x.x, y.x) + __vsadu4(x.y, y.y) + __vsadu4(x.z, y.z) +
                   __vsadu4(x.w, y.w));
    } else {
      acc = __dp4a(x.x, y.x, acc);
      acc = __dp4a(x.y, y.y, acc);
      acc = __dp4a(x.z, y.z, acc);
      acc = __dp4a(x.w, y.w, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0)
    out[t] = __fadd_rn(__fadd_rn(__fmul_rn(mult[q * mstride], __int2float_rn(acc)), qoff[q]),
                       voff[id]);
}

}  // namespace

// ------------------------------------------------------------- C interface
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success). Shapes are checked by the Python wrapper
// (ops/kernels/gather.py): D % 16 == 0, 16-byte-aligned contiguous codes.

extern "C" {

int qtt_sq_rescore(const void* qcodes, const void* qoff, const void* mult,
                   const void* codes, const void* voff, const void* cand,
                   void* out, int Q, int R, int n_valid, int D, int l1,
                   int mstride, void* stream) {
  const long long warps = (long long)Q * R;
  const long long blocks = (warps + kGThreads / 32 - 1) / (kGThreads / 32);
  sq_rescore_kernel<<<(unsigned)blocks, kGThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const int8_t*>(codes),
      static_cast<const float*>(voff), static_cast<const int*>(cand),
      static_cast<float*>(out), Q, R, n_valid, D, l1, mstride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
