// The PQ LUT-gather lookup loop's rates on one card, for choosing its lane
// map: lookups a clock per SM of
//   * "old": the loop before the packed words (a block's 32 queries one a
//     lane, 64 rows a warp, one 1- or 4-byte load a lookup, int32 / f32
//     sums), int8 and bf16x2 entries;
//   * "query_x_row": the library's loop (pq_kernels.cuh add_group: a lane's
//     8-byte load serves 8 int8 / 2 bf16x2 queries, lanes split into query
//     groups x row groups, int8 sums packed two to a register), int8 and
//     bf16x2;
//   * "queries": lanes across queries, 128 int8 queries a warp, one 32-bit
//     load serving a lane's 4 queries, 16 rows a lane (the same 64 sums a
//     lane), no bank conflicts;
// each over a LUT and codes resident in shared memory (random codes from a
// hash), at the kernels' blocks of 8 warps a SM (int8 two, bf16x2 one, whose
// 128 sums a thread take the registers), so that the rate is the loop's own;
// and "l2_restage": the rate at which the blocks copy a LUT slice from L2
// (a 4 MB buffer, read once before timing) into shared memory by 16-byte
// loads and st.shared, two barriers a 64 KB slice, in bytes a clock per
// SM: the ceiling that re-staging the LUT for every 512-row tile sets (0.5 B
// a lookup int8, 2 B bf16x2). A standalone program (not part of the kernel
// library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//         -o lut_gather_rate lut_gather_rate.cu
//     ./lut_gather_rate    # one JSON line a measurement
#include <cstdint>
#include <cstdio>

#include "../pq_kernels.cuh"

namespace {

constexpr int kIters = 64;         // passes over the staged chunks a block
constexpr int kSliceBytes = 65536;  // a LUT slice re-staged from L2

__device__ __forceinline__ unsigned hash32(unsigned i, unsigned seed) {
  unsigned h = i * 2654435761u ^ seed;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= h >> 13;
  return h;
}

// Fills the block's shared memory: lut_bytes of LUT, then the codes.
__device__ void fill(uint8_t* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x)
    reinterpret_cast<unsigned*>(smem)[i] = hash32(i, blockIdx.x);
  __syncthreads();
}

// The library's loop: Accum, add_group and end_stage of pq_kernels.cuh, over
// kCh staged chunks of 8-bit codes.
template <int KIND, int kCh>
__global__ void __launch_bounds__(kPThreads, KIND == kBf16x2 ? 1 : 2)
    query_x_row_kernel(unsigned* out) {
  extern __shared__ __align__(128) uint8_t smem_p[];
  constexpr int kLut = kCh * 256 * kPTQ * (int)sizeof(LutWord<KIND>);
  fill(smem_p, kLut + kCh * kPTR);
  const LutWord<KIND>* lut_s = reinterpret_cast<const LutWord<KIND>*>(smem_p);
  Accum<KIND> acc;
  int flushed[Accum<KIND>::kWide];
  acc.wide = flushed;
  zero_acc<KIND>(acc, kCh);
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
#pragma unroll 1
    for (int c = 0; c < kCh; ++c) add_group<256, KIND>(lut_s, smem_p + kLut, c, acc);
    end_stage<KIND>(acc, (it + 1) * kCh, kCh);  // a bf16x2 fold every 16 chunks
  }
  unsigned fold = 0;
#pragma unroll
  for (int r = 0; r < Lanes<KIND>::kRL; ++r)
#pragma unroll
    for (int i = 0; i < Accum<KIND>::kV; ++i) fold ^= __float_as_uint((float)acc.v[r][i]);
  out[blockIdx.x * kPThreads + threadIdx.x] = fold;
}

// The old loop: lane = query, a warp's 64 rows, 4 rows' codes a broadcast
// word, one load of one entry a lookup.
template <int KIND, int kCh>
__global__ void __launch_bounds__(kPThreads, KIND == kBf16x2 ? 1 : 2) old_kernel(unsigned* out) {
  using T = typename std::conditional<KIND == kInt8, int8_t, uint32_t>::type;
  extern __shared__ __align__(128) uint8_t smem_p[];
  constexpr int kLut = kCh * 256 * kPTQ * (int)sizeof(T);
  fill(smem_p, kLut + kCh * kPTR);
  const T* lut_s = reinterpret_cast<const T*>(smem_p);
  const uint8_t* codes_s = smem_p + kLut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  using A = typename std::conditional<KIND == kInt8, int, float>::type;
  A v[kPRW];
  float lo[KIND == kBf16x2 ? kPRW : 1];
#pragma unroll
  for (int r = 0; r < kPRW; ++r) {
    v[r] = 0;
    if constexpr (KIND == kBf16x2) lo[r] = 0.0f;
  }
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
#pragma unroll 1
    for (int c = 0; c < kCh; ++c) {
      const T* lc = lut_s + c * 256 * kPTQ + lane;
#pragma unroll
      for (int j = 0; j < kPRW / 4; ++j) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(codes_s + c * kPTR + warp * kPRW)[j];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const T e = lc[((w >> (8 * b)) & 255) * kPTQ];
          if constexpr (KIND == kInt8) {
            v[4 * j + b] += (int)e;
          } else {
            v[4 * j + b] = __fadd_rn(v[4 * j + b], __uint_as_float(e & 0xffff0000u));
            lo[4 * j + b] = __fadd_rn(lo[4 * j + b], __uint_as_float(e << 16));
          }
        }
      }
      if constexpr (KIND == kBf16x2) {
        if ((c + 1) % kMBlk == 0) {
#pragma unroll
          for (int r = 0; r < kPRW; ++r) {
            v[r] = __fadd_rn(v[r], __fmul_rn(lo[r], 1.0f / 256.0f));
            lo[r] = 0.0f;
          }
        }
      }
    }
  }
  unsigned fold = 0;
#pragma unroll
  for (int r = 0; r < kPRW; ++r) fold ^= __float_as_uint((float)v[r]);
  out[blockIdx.x * kPThreads + threadIdx.x] = fold;
}

// Lanes across queries: a warp's 128 int8 queries, 4 a lane (one 32-bit
// word of a 128-byte (chunk, code) row), 16 rows a lane, every lane of the
// warp on the same row: a broadcast code byte and one conflict-free load.
template <int kCh>
__global__ void __launch_bounds__(kPThreads, 2) queries_kernel(unsigned* out) {
  constexpr int kRows = 16;
  extern __shared__ __align__(128) uint8_t smem_p[];
  constexpr int kLut = kCh * 256 * 128;
  fill(smem_p, kLut + kCh * kPThreads / 32 * kRows);
  const uint32_t* lut_s = reinterpret_cast<const uint32_t*>(smem_p) + (threadIdx.x & 31);
  const uint8_t* codes_s = smem_p + kLut + (threadIdx.x >> 5) * kRows;
  uint32_t v[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r][0] = v[r][1] = 0;
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
#pragma unroll 1
    for (int c = 0; c < kCh; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t e = lut_s[(c * 256 + codes_s[c * kPThreads / 32 * kRows + r]) * 32];
        v[r][0] += e & 0x00ff00ffu;
        v[r][1] += __byte_perm(e, 0u, 0x4341);
      }
    }
  }
  unsigned fold = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) fold ^= v[r][0] ^ v[r][1];
  out[blockIdx.x * kPThreads + threadIdx.x] = fold;
}

// Copies 64 KB slices of src (L2-resident) into shared memory, kIters times
// a block.
__global__ void __launch_bounds__(kPThreads, 2) restage_kernel(const uint4* __restrict__ src,
                                                               int slices, unsigned* out) {
  extern __shared__ __align__(128) uint8_t smem_p[];
  constexpr int kVec = kSliceBytes / 16;
  unsigned fold = 0;
#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
    __syncthreads();
    const uint4* s = src + (long long)((blockIdx.x + it) % slices) * kVec;
    for (int i = threadIdx.x; i < kVec; i += kPThreads)
      reinterpret_cast<uint4*>(smem_p)[i] = __ldg(s + i);
    __syncthreads();
    fold ^= reinterpret_cast<const unsigned*>(smem_p)[(threadIdx.x * 37 + it) % (kVec * 4)];
  }
  out[blockIdx.x * kPThreads + threadIdx.x] = fold;
}

struct Card {
  int sms;
  double clock_hz;
};

template <typename K>
double time_ms(K kernel, int blocks, int smem, unsigned* out, int reps = 5) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kernel<<<blocks, kPThreads, smem>>>(out);  // warm-up
  float best = 1e30f;
  for (int i = 0; i < reps; ++i) {
    cudaEventRecord(a);
    kernel<<<blocks, kPThreads, smem>>>(out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  return best;
}

template <typename K>
void loop_rate(const char* loop, const char* word, K kernel, int lut_bytes, int code_bytes,
               double lookups_per_pass, const Card& card, unsigned* out) {
  const int blocks = card.sms * 2 * 16;
  const double ms = time_ms(kernel, blocks, lut_bytes + code_bytes, out);
  const double lookups = (double)blocks * kIters * lookups_per_pass;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "lut_gather_rate: %s %s: %s\n", loop, word, cudaGetErrorString(err));
    return;
  }
  printf("{\"probe\": \"lut_gather\", \"loop\": \"%s\", \"word\": \"%s\", \"ms\": %.4f, "
         "\"lookups_per_clock_per_sm\": %.2f}\n",
         loop, word, ms, lookups / (ms * 1e-3 * card.clock_hz * card.sms));
}

}  // namespace

int main() {
  Card card{};
  int khz = 0;
  cudaDeviceGetAttribute(&card.sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  card.clock_hz = khz * 1e3;
  unsigned* out = nullptr;
  cudaMalloc(&out, (size_t)card.sms * 2 * 16 * kPThreads * sizeof(unsigned));
  printf("{\"probe\": \"card\", \"sms\": %d, \"clock_mhz\": %.0f}\n", card.sms,
         card.clock_hz / 1e6);
  // a block's lookups a pass over its chunks: queries x rows x chunks
  constexpr int kCh8 = 8, kCh2 = 2;
  loop_rate("old", "int8", old_kernel<kInt8, kCh8>, kCh8 * 8192, kCh8 * kPTR,
            32.0 * kPTR * kCh8, card, out);
  loop_rate("query_x_row", "int8", query_x_row_kernel<kInt8, kCh8>, kCh8 * 8192, kCh8 * kPTR,
            32.0 * kPTR * kCh8, card, out);
  loop_rate("queries", "int8", queries_kernel<kCh2>, kCh2 * 32768, kCh2 * 128,
            128.0 * 128 * kCh2, card, out);
  loop_rate("old", "bf16x2", old_kernel<kBf16x2, kCh2>, kCh2 * 32768, kCh2 * kPTR,
            32.0 * kPTR * kCh2, card, out);
  loop_rate("query_x_row", "bf16x2", query_x_row_kernel<kBf16x2, kCh2>, kCh2 * 32768,
            kCh2 * kPTR, 32.0 * kPTR * kCh2, card, out);

  // L2 re-staging: 64 slices of 64 KB (4 MB), read once before timing.
  const int slices = 64;
  uint4* src = nullptr;
  cudaMalloc(&src, (size_t)slices * kSliceBytes);
  cudaMemset(src, 1, (size_t)slices * kSliceBytes);
  const int blocks = card.sms * 2 * 16;
  auto restage = [&](unsigned* o) {
    restage_kernel<<<blocks, kPThreads, kSliceBytes>>>(src, slices, o);
  };
  cudaFuncSetAttribute(restage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceBytes);
  restage(out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f;
  for (int i = 0; i < 5; ++i) {
    cudaEventRecord(a);
    restage(out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "lut_gather_rate: restage: %s\n", cudaGetErrorString(err));
    return 1;
  }
  const double bytes = (double)blocks * kIters * kSliceBytes;
  printf("{\"probe\": \"l2_restage\", \"ms\": %.4f, \"gb_per_s\": %.1f, "
         "\"bytes_per_clock_per_sm\": %.2f}\n",
         best, bytes / (best * 1e-3) / 1e9, bytes / (best * 1e-3 * card.clock_hz * card.sms));
  cudaFree(src);
  cudaFree(out);
  return 0;
}
