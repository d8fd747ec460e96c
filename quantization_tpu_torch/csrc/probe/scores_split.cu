// The 4-bit int8 score matrix K8 on one card: pq4_mma_kernels.cu's
// pq4_scores_ws_kernel against the kernel it replaced,
// scores_kernel<NibbleRows, true> of dot_scan.cuh, split into their parts
// (split_scores), the scores equal to the bit. A standalone program (not
// part of the kernel library), a probe of its own so that it builds beside
// approx_split.cu:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//          -o scores_split scores_split.cu
//     ./scores_split               # one JSON line a measurement
//     ./scores_split parent        # the replaced kernel alone
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <type_traits>

#include "../pq4_mma_kernels.cu"  // pq4_scores_ws_kernel, and dot_scan.cuh
#include "probe_common.cuh"

namespace {

// The replaced K8 with 4-bit codes and the int8 LUT, scores_kernel
// <NibbleRows, true> (the K3 tile of dot_scan.cuh: one block a 128-row
// segment and 128 queries, the one-hot rows expanded in shared memory), split
// into its scan (mma_segment's walk: the expansion and the products), the
// products alone (NibbleProducts), the expansion alone (onehot_expand_kernel
// on its tile) and its stores alone (scores_store_kernel).
template <class Rows>
__global__ void __launch_bounds__(kThreads, ScoresTile::kBlocks) scores_scan_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, unsigned* __restrict__ out, int Q, int D) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  using T = ScoresTile;
  const int nqt = (Q + T::TQ - 1) / T::TQ;
  int acc[T::kH][32];
  mma_segment<T>(Rows{base, stride}, qcodes, (blockIdx.x % nqt) * T::TQ, Q,
                 (long long)(blockIdx.x / nqt) * kSeg, D, smem_addr(smem), acc);
  unsigned fold = 0;
#pragma unroll
  for (int h = 0; h < T::kH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) fold ^= (unsigned)acc[h][e];
  out[(long long)blockIdx.x * kThreads + threadIdx.x] = fold;
}

// scores_kernel's epilogue and stores alone: its int tile through the ring's
// memory and store_tile, with each accumulator a function of its place in
// place of the products.
__global__ void __launch_bounds__(kThreads, ScoresTile::kBlocks) scores_store_kernel(
    const float* __restrict__ qoff, const float* __restrict__ mult, float* __restrict__ out,
    int Q, int n_valid) {
  using T = ScoresTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int nqt = (Q + T::TQ - 1) / T::TQ;
  const int q0 = (blockIdx.x % nqt) * T::TQ;
  const long long row0 = (long long)(blockIdx.x / nqt) * kSeg;
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int h = 0; h < T::kH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e)
      tile[(64 * h + frag_col(e)) * kTS + frag_row(e)] = (int)(threadIdx.x * 64 + 32 * h + e);
  __syncthreads();
  store_tile<T::TQ>(
      tile,
      [&](int q) {
        const double m = mult[q], qo = qoff[q];
        return [=](int a, long long) { return affine_once(m, a, qo); };
      },
      out, q0, Q, row0, n_valid);
}

// The words of a and b that differ, over n (bits; 0 where equal).
__global__ void count_diff(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                           long long n, unsigned long long* __restrict__ diff) {
  unsigned long long d = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    d += a[i] != b[i];
  if (d) atomicAdd(diff, d);
}

// 4-bit int8 K8 at chip_smoke.py path 3's shape: 1,000,000 rows of m = 192
// chunks (npad 1,000,448), Q = 256, 100 and 32 (the first queries of one
// LUT). The reference is scores_kernel<NibbleRows, true>, the kernel that
// pq4_scores_ws_kernel replaced: at each Q its time and, at Q = 256, its
// scan, the products alone, the expansion alone and the epilogue and stores
// alone. Then pq4_scores_ws_kernel in the wrapper's geometry (at Q = 32 also
// in the other): the kernel, its products alone (kOsScan) and its products
// and epilogue without the stores (kOsTile), its scores equal to the
// reference's to the bit; without ws_too the reference alone.
bool split_scores(bool ws_too) {
  const int QM = 256, m = 192, D = m * 16;
  const long long n = 1000000, npad = 1000448, nseg = (n + kSeg - 1) / kSeg;
  uint8_t* codes;
  int8_t* lut;
  float *scale, *bias, *ref, *got;
  unsigned* fold;
  unsigned long long* diff;
  cudaMalloc(&codes, (size_t)m * npad);
  cudaMalloc(&lut, (size_t)QM * D);
  cudaMalloc(&scale, QM * 4);
  cudaMalloc(&bias, QM * 4);
  cudaMalloc(&ref, (size_t)QM * n * 4);
  cudaMalloc(&got, (size_t)QM * n * 4);
  cudaMalloc(&fold, (size_t)nseg * 2 * kThreads * 4);
  cudaMalloc(&diff, 8);
  fill_kernel<<<1024, 256>>>(codes, (long long)m * npad, 0x0f, 41);
  for (int c = 0; c < m; ++c) cudaMemset(codes + c * npad + n, 0, npad - n);
  fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(lut), (long long)QM * D, 0xff, 42);
  fill_f32<<<64, 256>>>(scale, QM, 1e-3f, 1e-2f, 43);
  fill_f32<<<64, 256>>>(bias, QM, -1.f, 2.f, 44);
  const size_t ssmem = kAlign + ScoresTile::kBytes;
  cudaFuncSetAttribute(scores_scan_kernel<NibbleRows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  cudaFuncSetAttribute(scores_scan_kernel<NibbleProducts>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  cudaFuncSetAttribute(onehot_expand_kernel<ScoresTile>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  cudaFuncSetAttribute(scores_store_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ssmem);
  bool good = ok("K8 operands");
  for (const int q : {256, 100, 32}) {
    const unsigned grid = (unsigned)(nseg * ((q + ScoresTile::TQ - 1) / ScoresTile::TQ));
    const float pms = time_ms([&] {
      launch_mma_scores<NibbleRows, true>(codes, npad, lut, bias, scale, nullptr, ref, q, (int)n,
                                          D, 1, 0);
    });
    good &= ok("K8 reference");
    if (q == QM) {
      const float sc = time_ms([&] {
        scores_scan_kernel<NibbleRows><<<grid, kThreads, ssmem>>>(codes, npad, lut, fold, q, D);
      });
      const float pr = time_ms([&] {
        scores_scan_kernel<NibbleProducts><<<grid, kThreads, ssmem>>>(codes, npad, lut, fold, q,
                                                                      D);
      });
      const float ex = time_ms([&] {
        onehot_expand_kernel<ScoresTile><<<grid, kThreads, ssmem>>>(codes, npad, fold, q,
                                                                    (int)npad, D, kSeg);
      });
      const float sto = time_ms([&] {
        scores_store_kernel<<<grid, kThreads, ssmem>>>(bias, scale, got, q, (int)n);
      });
      good &= ok("K8 reference splits");
      printf("{\"probe\": \"scores_split\", \"kernel\": \"pq_scores_4bit\", "
             "\"design\": \"scores_parent\", \"q\": %d, \"ms\": %.4f, \"scan_ms\": %.4f, "
             "\"products_ms\": %.4f, \"expand_ms\": %.4f, \"stores_ms\": %.4f, \"smem\": %zu, "
             "\"blocks_per_sm\": %d}\n",
             q, pms, sc, pr, ex, sto, ssmem, ScoresTile::kBlocks);
    } else {
      printf("{\"probe\": \"scores_split\", \"kernel\": \"pq_scores_4bit\", "
             "\"design\": \"scores_parent\", \"q\": %d, \"ms\": %.4f, \"smem\": %zu, "
             "\"blocks_per_sm\": %d}\n",
             q, pms, ssmem, ScoresTile::kBlocks);
    }
    if (!ws_too) continue;
    // pq4_scores_ws_kernel in the geometry TQ queries x NB blocks.
    auto ws = [&](auto tq, auto nb, const char* design) {
      constexpr int TQ = decltype(tq)::value, NB = decltype(nb)::value;
      auto run = [&](auto form) {
        launch_onehot_scores_g<decltype(form)::value, TQ, NB>(codes, npad, lut, bias, scale, got,
                                                              q, (int)n, D, 0);
      };
      const float t = time_ms([&] { run(std::integral_constant<int, kOsFull>{}); });
      const float ts = time_ms([&] { run(std::integral_constant<int, kOsScan>{}); });
      const float tt = time_ms([&] { run(std::integral_constant<int, kOsTile>{}); });
      run(std::integral_constant<int, kOsFull>{});
      cudaMemset(diff, 0, 8);
      count_diff<<<1024, 256>>>(reinterpret_cast<const unsigned*>(ref),
                                reinterpret_cast<const unsigned*>(got), (long long)q * n, diff);
      unsigned long long nd = 1;
      const bool e = ok("K8 ws") && cudaMemcpy(&nd, diff, 8, cudaMemcpyDeviceToHost) ==
                                        cudaSuccess && nd == 0;
      good &= e;
      printf("{\"probe\": \"scores_split\", \"kernel\": \"pq_scores_4bit\", \"design\": \"%s\", "
             "\"q\": %d, \"ms\": %.4f, \"scan_ms\": %.4f, \"tile_ms\": %.4f, \"smem\": %d, "
             "\"stages\": %d, \"tq\": %d, \"nb\": %d, \"blocks_per_sm\": 1, \"equal\": %s}\n",
             design, q, t, ts, tt, OsGeom<TQ, NB>::kSmem, OsGeom<TQ, NB>::S, TQ, NB,
             e ? "true" : "false");
    };
    if (q > 64) {
      ws(std::integral_constant<int, 128>{}, std::integral_constant<int, 2>{}, "scores_ws");
    } else {
      ws(std::integral_constant<int, 64>{}, std::integral_constant<int, 4>{}, "scores_ws");
      ws(std::integral_constant<int, 128>{}, std::integral_constant<int, 2>{}, "scores_ws128");
    }
  }
  for (void* p : {(void*)codes, (void*)lut, (void*)scale, (void*)bias, (void*)ref, (void*)got,
                  (void*)fold, (void*)diff})
    cudaFree(p);
  return good;
}

}  // namespace

int main(int argc, char** argv) {
  setvbuf(stdout, nullptr, _IOLBF, 0);  // each line out as it is measured
  const bool good = split_scores(argc < 2 || strcmp(argv[1], "parent"));
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "scores_split: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return good ? 0 : 1;
}
