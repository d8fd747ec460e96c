// What the two probes of the int8 bodies share (approx_split.cu,
// scores_split.cu): random operands made on the card, CUDA-event timing,
// the launch check, and the pieces of the one-hot splits (NibbleRows with
// its expansion taken out, the expansion alone). Included after
// dot_scan.cuh.
#pragma once

#include <algorithm>
#include <cstdio>
#include <vector>

namespace {

// Fills n bytes with a hash of their index, masked.
__global__ void fill_kernel(uint8_t* p, long long n, unsigned mask, unsigned seed) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)i * 2654435761u ^ seed;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    p[i] = (uint8_t)(h & mask);
  }
}

// f32 values in [lo, lo + span) from a hash of their index.
__global__ void fill_f32(float* p, long long n, float lo, float span, unsigned seed) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)i * 2654435761u ^ seed;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    p[i] = lo + span * (float)(h >> 8) * (1.0f / 16777216.0f);
  }
}

// The one-hot split of approx_parts_kernel<NibbleRows> and scores_kernel
// <NibbleRows, true> (4-bit int8 K7a's and K8's bodies before their
// warp-specialized ones; approx_split.cu, scores_split.cu): NibbleRows with
// its loads and one-hot stores taken out, so the products read the A tiles
// as they stand (the products alone; wrong results).
struct NibbleProducts {
  static constexpr bool kBits = false;
  using Elem = uint8_t;
  struct Pending {};
  const uint8_t* codes_t;
  long long npad;
  __device__ __forceinline__ void prefetch(Pending&, long long, int) const {}
  __device__ __forceinline__ void issue(uint32_t, long long, int) const {}
  __device__ __forceinline__ void put(uint32_t, const Pending&) const {}
};

// The one-hot expansion alone on tile T: mma_segment's walk over segment
// rows with the codes' loads and one-hot stores (NibbleRows) and its
// barriers, no LUT copies and no products; `part` rows a block.
template <class T>
__global__ void __launch_bounds__(kThreads, T::kBlocks) onehot_expand_kernel(
    const uint8_t* __restrict__ codes_t, long long npad, unsigned* __restrict__ out, int Q,
    int ncomp, int D, int part) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(smem);
  const NibbleRows rows{codes_t, npad};
  const int nqt = (Q + T::TQ - 1) / T::TQ, nk = D / kDK;
  const long long start = (long long)(blockIdx.x / nqt) * part;
  for (int off = 0; off < part && start + off < ncomp; off += kSeg) {
    const long long row0 = start + off;
    __syncthreads();
    NibbleRows::Pending p;
#pragma unroll
    for (int s = 0; s < T::S - 1; ++s) {
      if (s < nk) {
        rows.prefetch(p, row0, s * kDK);
        rows.put(ring + s * T::kStage, p);
      }
    }
    if (T::S - 1 < nk) rows.prefetch(p, row0, (T::S - 1) * kDK);
    for (int c = 0; c < nk; ++c) {
      fence_proxy_async();
      __syncthreads();
      const int nc = c + T::S - 1;
      if (nc < nk) rows.put(ring + (nc % T::S) * T::kStage, p);
      if (nc + 1 < nk) rows.prefetch(p, row0, (nc + 1) * kDK);
    }
  }
  __syncthreads();
  out[(long long)blockIdx.x * kThreads + threadIdx.x] =
      reinterpret_cast<const unsigned*>(smem)[threadIdx.x];
}

template <class Launch>
float time_ms(Launch launch) {
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> runs;
  for (int run = 0; run < 7; ++run) {
    cudaEventRecord(e0);
    for (int i = 0; i < 10; ++i) launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    runs.push_back(ms / 10);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(runs.begin(), runs.end());
  return runs[runs.size() / 2];
}

bool ok(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "probe: %s: %s\n", what, cudaGetErrorString(err));
    return false;
  }
  return true;
}

}  // namespace
