// The issue rate of K12's step on one card: __vabsdiffu4 then __dp4a against
// 0x01010101 (the sum of four absolute byte differences, l1_scores_kernel in
// sq_kernels.cu; SASS VABSDIFF4.U8 then IDP.4A.U8.U8), in pairs a second per
// SM. The tensor cores have no absolute-difference product, so this pair is
// the unit of K12's own design, and its bound (chip_smoke.py
// ABSDIFF_PAIRS_PER_S_PER_SM) is this measurement beside the b1 product's
// (wgmma_rate.cu). Each thread keeps 16 independent accumulators, a 4 x 4
// tile as K12's is, and each pair takes the absolute difference against its
// own accumulator's bytes, so no difference can be reused or hoisted (with
// loop-invariant operands ptxas computes each difference once and issues the
// dp4a alone); 16 chains a thread at 1024 threads a SM (four blocks of 256)
// hide the chains' latency. A standalone program (not part of the kernel
// library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o absdiff absdiff_rate.cu
//     ./absdiff    # one JSON line a run
//
// scan_ab.py --only rate builds and runs it, and counts its SASS pairs.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) pair_kernel(int iters, int* out) {
  unsigned a[4], b[4];
  unsigned c[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = (threadIdx.x * 2654435761u + k * 40503u) & 0x7f7f7f7fu;
    b[k] = (blockIdx.x * 2246822519u + k * 3266489917u) & 0x7f7f7f7fu;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = b[i & 3];
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[4 * j + i] = __dp4a(__vabsdiffu4(a[j], c[4 * j + i]), 0x01010101u, c[4 * j + i]);
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += c[i];
  if (s == 0x7fffffffu) out[0] = (int)s;
  if (threadIdx.x == 0 && blockIdx.x == 0) out[1] = (int)c[0];
}

int main() {
  int dev = 0, sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  const int blocks = 4 * sms, threads = 256, iters = 20000;
  int* out;
  cudaMalloc(&out, 16);
  pair_kernel<<<blocks, threads>>>(100, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int run = 0; run < 3; ++run) {
    cudaEventRecord(e0);
    pair_kernel<<<blocks, threads>>>(iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      fprintf(stderr, "absdiff_rate: %s\n", cudaGetErrorString(err));
      return 1;
    }
    const double pairs = (double)blocks * threads * iters * 16;
    const double per_sm = pairs / (ms * 1e-3) / sms;
    printf("{\"form\": \"vabsdiffu4 + dp4a\", \"run\": %d, \"ms\": %.4f, "
           "\"pairs_per_s_per_sm\": %.4e, \"pairs_per_clock_per_sm_at_max_clock\": %.2f}\n",
           run, ms, per_sm, per_sm / (khz * 1e3));
  }
  cudaFree(out);
  return 0;
}
