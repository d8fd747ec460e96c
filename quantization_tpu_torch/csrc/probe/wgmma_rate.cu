// The issue rate of the single-bit product wgmma m64n64k256 b1.b1.and.popc
// against the int8 one, m64n64k32 s8.s8, on one card: NVIDIA publishes no
// b1 rate for Hopper, and the BQ sign-query kernels' bound
// (chip_smoke.py B1_PRODUCTS_PER_S_PER_SM) is this measurement. Both
// operands K-major in shared memory with the 128-byte swizzle descriptors
// of dot_scan.cuh, two warpgroups a block, one or two blocks a SM, each
// warpgroup issuing groups of 32 products into one accumulator with one
// group left in flight. A standalone program (not part of the kernel
// library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o rate wgmma_rate.cu
//     ./rate    # one JSON line a run, then the b1 / s8 ratio a geometry
//
// scan_ab.py --only rate builds and runs it.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define ACC_OUT                                                                           \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),   \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),          \
      "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),       \
      "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),       \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
#define ACC_LIST                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "             \
  "%8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, "      \
  "%24, %25, %26, %27, %28, %29, %30, %31}, "

template <bool B1>
__device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (B1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc " ACC_LIST
                 "%32, %33, p;\n}\n"
                 : ACC_OUT
                 : "l"(a), "l"(b), "r"(1)
                 : "memory");
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " ACC_LIST
                 "%32, %33, p;\n}\n"
                 : ACC_OUT
                 : "l"(a), "l"(b), "r"(1)
                 : "memory");
  }
}

template <bool B1>
__global__ void __launch_bounds__(256) rate_kernel(int iters, int* out) {
  extern __shared__ __align__(1024) uint8_t raw[];
  uint8_t* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  uint32_t* w = reinterpret_cast<uint32_t*>(sm);
  for (int i = threadIdx.x; i < (2 * 64 * 128 + 64 * 128) / 4; i += 256)
    w[i] = (uint32_t)(i * 2654435761u) ^ (uint32_t)(blockIdx.x * 40503u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  int d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0;
  const uint32_t base = smem_addr(sm);
  const uint64_t da = desc(base + (threadIdx.x >> 7) * 64 * 128), db = desc(base + 2 * 64 * 128);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) mma<B1>(d, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
  for (int i = 0; i < 32; ++i) s += d[i];
  if (s == 0x7fffffff) out[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) out[1] = d[0];
}

template <bool B1>
double run(int nb, int iters) {
  int dev = 0, sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = 1024 + 3 * 64 * 128;
  cudaFuncSetAttribute(rate_kernel<B1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int* out;
  cudaMalloc(&out, 16);
  rate_kernel<B1><<<sms * nb, 256, smem>>>(10, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  rate_kernel<B1><<<sms * nb, 256, smem>>>(iters, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  cudaError_t e = cudaGetLastError();
  cudaFree(out);
  if (e != cudaSuccess) {
    fprintf(stderr, "wgmma_rate: %s\n", cudaGetErrorString(e));
    return -1.0;
  }
  const double products = (double)sms * nb * 2 * iters * 32;  // m64n64 products, all warpgroups
  const double per_sm = products / (ms * 1e-3) / sms;
  printf("{\"form\": \"%s\", \"blocks_per_sm\": %d, \"ms\": %.4f, "
         "\"products_per_s_per_sm\": %.4e, \"macs_per_s_per_sm\": %.4e}\n",
         B1 ? "b1 m64n64k256" : "s8 m64n64k32", nb, ms, per_sm,
         per_sm * 64 * 64 * (B1 ? 256 : 32));
  return per_sm;
}

int main() {
  for (int nb : {1, 2}) {  // in turns: s8, b1, s8, b1
    const double r[4] = {run<false>(nb, 20000), run<true>(nb, 20000), run<false>(nb, 20000),
                         run<true>(nb, 20000)};
    if (r[0] < 0 || r[1] < 0 || r[2] < 0 || r[3] < 0) return 1;
    printf("{\"blocks_per_sm\": %d, \"b1_over_s8_instr_rate\": %.4f}\n", nb,
           (r[1] + r[3]) / (r[0] + r[2]));
  }
  return 0;
}
