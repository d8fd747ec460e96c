// The exact searches' time split into scan and select, on one card: the
// scan of K1 (int8 codes, 100,000 x 1024 padded to 100,352 rows, Q = 256),
// of K5c (sign bits, 1,000,000 x 1536 padded to 1,001,472 rows, Q = 256)
// and of 4-bit int8 K7b (pq4_queue_kernel with kScan, 1,000,000 rows of 192
// chunks, Q = 256, k = 10, in its own geometry only) with their epilogue
// and its order keys, and no select: each key is folded into a register
// that one store a thread leaves behind, so the epilogue stays. K1's and
// K5c's scans run in two geometries, the launch and the shared memory (so
// the blocks a SM) of the exact kernel whose time it is taken from:
//   * "radix": 512-row splits, the split-wide key buffer's shared memory
//     (K1 one block a SM, K5c two);
//   * "queue": the queue select's ranges (ktile.py exact_geometry: one wave
//     of 264 blocks) and its tile and shared memory at k = 10 (K1) / 40
//     (K5c: 64 queries a block), two blocks a SM.
// It also times the queue kernels themselves (K1 on these scores and on
// scores that fall with the row, K5c on these planes and on planes that all
// tie: past a block's first segment no row passes a threshold there, so
// those runs are the scan and the select's fixed cost) and prints the exact
// kernels' blocks a SM.
// The select's share of an exact kernel is its time less the scan's in the
// same geometry (chip_smoke.py and scan_ab.py print both). A standalone
// program (not part of the kernel library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o select_split select_split.cu
//     ./select_split    # one JSON line a measurement
#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <vector>

#include "../bq_kernels.cu"
#include "../pq4_mma_kernels.cu"

namespace {

constexpr int kRangeWave = 264;  // ktile.py QUEUE_WAVE

// voff[n] = -n * 1e4: scores that fall with the row, so after a block's
// first segment no row passes its queue's threshold.
__global__ void falling_kernel(float* voff, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) voff[i] = -1.0e4f * (float)i;
}

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

// K1's scan over ranges of `split` rows (search_queue_kernel's loop and
// epilogue, kOnce false), tile T.
template <class T>
__global__ void __launch_bounds__(kThreads, T::kBlocks) sq_scan_kernel(
    const int8_t* __restrict__ codes, const int8_t* __restrict__ qcodes,
    const float* __restrict__ qoff, const float* __restrict__ mult,
    const float* __restrict__ voff, unsigned* __restrict__ out, int Q, int ncomp, int D,
    int split) {
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  float* qm = reinterpret_cast<float*>(smem + T::kBytes);
  float* qo = qm + TQ;
  const int nqt = (Q + TQ - 1) / TQ;
  const int blk = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)blk * split;
  const long long end = min((long long)ncomp, start + split);
  load_qparams<TQ>(qm, qo, mult, qoff, q0, Q, 0);
  unsigned fold = 0;
  for (long long off = start; off < end; off += kSeg) {
    int acc[1][32];
    mma_segment<T>(CodeRows{codes, D}, qcodes, q0, Q, off, D, smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = frag_col(e);
      fold ^= float_to_key(epilogue<false>(qm[j], acc[0][e], qo[j], voff, off + frag_row(e)));
    }
  }
  out[(long long)blockIdx.x * kThreads + threadIdx.x] = fold;
}

// K5c's scan (bq_sign_queue_kernel's loop and epilogue: the row's popcount
// from the loader, the score sign * (dim - 2x) in integers).
template <class T>
__global__ void __launch_bounds__(kThreads, T::kBlocks) bq_scan_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    unsigned* __restrict__ out, int Q, int W, long long npad, int dim, int split) {
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  int* qo = reinterpret_cast<int*>(smem + T::kBytes);
  int* pc = qo + TQ;
  const int nqt = (Q + TQ - 1) / TQ;
  const int blk = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)blk * split;
  const long long end = min(npad, start + split);
  for (int j = threadIdx.x; j < TQ; j += kThreads) qo[j] = dim - 2 * (q0 + j);
  const BitRows rows{planes, npad, W, pc};
  unsigned fold = 0;
  for (long long off = start; off < end; off += kSeg) {
    int acc[1][T::kAcc];
    mma_segment<T>(rows, reinterpret_cast<const int8_t*>(qwords), q0, Q, off, 4 * W,
                   smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < T::kAcc; ++e) {
      const int r = frag_row(e);
      fold ^= float_to_key(
          __int2float_rn(qo[frag_col(e)] + (4 * acc[0][e] - 2 * (pc[r] + pc[kSeg + r]))));
    }
  }
  out[(long long)blockIdx.x * kThreads + threadIdx.x] = fold;
}

// The queue route's rows a block: whole 512-row splits, one wave of blocks.
int queue_split(long long ncomp, int Q, int TQ) {
  const long long nsplit = (ncomp + 511) / 512;
  const int nqt = (Q + TQ - 1) / TQ;
  const int per = kRangeWave / nqt > 1 ? kRangeWave / nqt : 1;
  return (int)(512 * ((nsplit + per - 1) / per));
}

template <class Kernel, class Launch>
float time_ms(Kernel* kernel, size_t smem, Launch launch) {
  queue_smem(kernel, smem);
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int run = 0; run < 5; ++run) {
    cudaEventRecord(e0);
    for (int i = 0; i < 10; ++i) launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    best = ms / 10 < best ? ms / 10 : best;
  }
  return best;
}

// Blocks a SM of a kernel at `smem` bytes of dynamic shared memory.
template <class Kernel>
int blocks_per_sm(Kernel* kernel, size_t smem) {
  int n = 0;
  queue_smem(kernel, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return n;
}

void report_cost(const char* kernel, const char* corpus, int kk, float ms) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "select_split: %s %s: %s\n", kernel, corpus, cudaGetErrorString(err));
    return;
  }
  printf("{\"probe\": \"select_cost\", \"kernel\": \"%s\", \"corpus\": \"%s\", "
         "\"kk\": %d, \"ms\": %.4f}\n", kernel, corpus, kk, ms);
}

void report(const char* kernel, const char* route, int split, size_t smem, float ms) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "select_split: %s %s: %s\n", kernel, route, cudaGetErrorString(err));
    return;
  }
  printf("{\"probe\": \"select_split\", \"kernel\": \"%s\", \"route\": \"%s\", "
         "\"split\": %d, \"smem\": %zu, \"scan_ms\": %.4f}\n",
         kernel, route, split, smem, ms);
}

}  // namespace

int main() {
  const int Q = 256;
  // The exact kernels' residency as their launchers size them: the queue
  // route must hold two blocks a SM at every kk it takes.
  for (int kk : {1, 10, 40, 64}) {
    const size_t smem =
        kAlign + ExactQueueTile::kBytes + 4 * 2 * 64 + QueueSelect<64>::bytes(kk);
    printf("{\"probe\": \"occupancy\", \"kernel\": \"search_queue_kernel\", \"kk\": %d, "
           "\"smem\": %zu, \"blocks_per_sm\": %d}\n",
           kk, smem, blocks_per_sm(search_queue_kernel<CodeRows, false>, smem));
  }
  {
    const size_t smem = kAlign + ExactTile::kBytes + 4 * 2 * 64 +
                        4 * ((size_t)64 * (512 + kKeyPad) + 8 * 256);
    printf("{\"probe\": \"occupancy\", \"kernel\": \"search_exact_kernel\", \"kk\": 512, "
           "\"smem\": %zu, \"blocks_per_sm\": %d}\n",
           smem, blocks_per_sm(search_exact_kernel<CodeRows, false>, smem));
  }
  unsigned* out;
  cudaMalloc(&out, (size_t)1 << 24);

  // K1: 100,352 x 1024 int8 codes in [0, 127].
  const int N = 100352, D = 1024;
  int8_t *codes, *qcodes;
  float *qoff, *mult, *voff;
  cudaMalloc(&codes, (size_t)N * D);
  cudaMalloc(&qcodes, (size_t)Q * D);
  cudaMalloc(&qoff, Q * 4);
  cudaMalloc(&mult, 4);
  cudaMalloc(&voff, (size_t)N * 4);
  fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(codes), (long long)N * D, 0x7f, 1);
  fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(qcodes), (long long)Q * D, 0x7f, 2);
  cudaMemset(qoff, 0, Q * 4);
  cudaMemset(voff, 0, (size_t)N * 4);
  const float one = 1.0f;
  cudaMemcpy(mult, &one, 4, cudaMemcpyHostToDevice);
  {
    using T = Tile<64, 3, 1>;  // the radix route: split-wide keys, one block a SM
    const size_t smem =
        kAlign + T::kBytes + 4 * 2 * 64 + 4 * ((size_t)64 * (512 + kKeyPad) + 8 * 256);
    const unsigned grid = (N + 511) / 512 * (Q / 64);
    const float ms = time_ms(sq_scan_kernel<T>, smem, [&] {
      sq_scan_kernel<T><<<grid, kThreads, smem>>>(codes, qcodes, qoff, mult, voff, out, Q, N,
                                                  D, 512);
    });
    report("sq_search_exact", "radix", 512, smem, ms);
  }
  {
    using T = Tile<64, 3, 2>;  // the queue route at k = 10
    const size_t smem = kAlign + T::kBytes + 4 * 2 * 64 + QueueSelect<64>::bytes(10);
    const int split = queue_split(N, Q, 64);
    const unsigned grid = (N + split - 1) / split * (Q / 64);
    const float ms = time_ms(sq_scan_kernel<T>, smem, [&] {
      sq_scan_kernel<T><<<grid, kThreads, smem>>>(codes, qcodes, qoff, mult, voff, out, Q, N,
                                                  D, split);
    });
    report("sq_search_exact", "queue", split, smem, ms);
  }
  // The queue kernel itself (K1, k = 10) on these scores and on falling
  // ones, where no row passes a threshold after a block's first segment:
  // the second is the scan plus the select's fixed cost a segment.
  {
    const int kk = 10, split = queue_split(N, Q, 64);
    float *cv, *ci;
    cudaMalloc(&cv, (size_t)Q * ((N + split - 1) / split) * kk * 4);
    cudaMalloc(&ci, (size_t)Q * ((N + split - 1) / split) * kk * 4);
    const ScanMap dense{nullptr, 0, nullptr, 0, 0};
    auto launch = [&] {
      launch_search_exact<CodeRows, false>(codes, D, qcodes, qoff, mult, voff, cv, ci, Q, N, N,
                                           D, split, kk, 0, dense, 0);
    };
    report_cost("sq_search_exact", "random", kk,
                time_ms(search_queue_kernel<CodeRows, false>, 0, launch));
    falling_kernel<<<(N + 255) / 256, 256>>>(voff, N);
    report_cost("sq_search_exact", "falling", kk,
                time_ms(search_queue_kernel<CodeRows, false>, 0, launch));
    cudaFree(cv);
    cudaFree(ci);
  }
  cudaFree(codes);

  // K5c: 1,001,472 rows of 1536 sign bits (48 words), Q = 256.
  const long long npad = 1001472;
  const int W = 48, dim = 1536;
  uint32_t *planes, *qwords;
  cudaMalloc(&planes, (size_t)W * npad * 4);
  cudaMalloc(&qwords, (size_t)Q * W * 4);
  fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(planes), (long long)W * npad * 4, 0xff, 3);
  fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(qwords), (long long)Q * W * 4, 0xff, 4);
  {
    using T = Tile<32, 2, 2>;  // SignExactTile
    const size_t hb = sizeof(int) * (T::TQ + 2 * kSeg);
    const size_t smem_radix = kAlign + T::kBytes + hb + 4 * (size_t)32 * (512 + kKeyPad);
    const unsigned grid_radix = (unsigned)((npad + 511) / 512) * (Q / 32);
    float ms = time_ms(bq_scan_kernel<T>, smem_radix, [&] {
      bq_scan_kernel<T><<<grid_radix, kThreads, smem_radix>>>(qwords, planes, out, Q, W, npad,
                                                              dim, 512);
    });
    report("bq_search_exact", "radix", 512, smem_radix, ms);
    using U = SignQueueTile;
    const size_t smem = kAlign + U::kBytes + sizeof(int) * (U::TQ + 2 * kSeg) +
                        QueueSelect<64>::bytes(40);
    const int split = queue_split(npad, Q, 64);
    const unsigned grid = (unsigned)((npad + split - 1) / split) * (Q / 64);
    ms = time_ms(bq_scan_kernel<U>, smem, [&] {
      bq_scan_kernel<U><<<grid, kThreads, smem>>>(qwords, planes, out, Q, W, npad, dim, split);
    });
    report("bq_search_exact", "queue", split, smem, ms);
    // K5c itself (k = 40) on these rows and on rows that all tie, where no
    // row passes a threshold after a block's first segment.
    float *cv, *ci;
    const int kk = 40;
    cudaMalloc(&cv, (size_t)Q * ((npad + split - 1) / split) * kk * 4);
    cudaMalloc(&ci, (size_t)Q * ((npad + split - 1) / split) * kk * 4);
    auto launch = [&] {
      qtt_bq_search_exact(qwords, planes, cv, ci, Q, W, npad, (int)npad, dim, 1, split, kk,
                          nullptr);
    };
    report_cost("bq_search_exact", "random", kk, time_ms(bq_sign_queue_kernel, 0, launch));
    cudaMemset(planes, 0, (size_t)W * npad * 4);
    report_cost("bq_search_exact", "ties", kk, time_ms(bq_sign_queue_kernel, 0, launch));
    cudaFree(cv);
    cudaFree(ci);
  }
  cudaFree(planes);
  cudaFree(qwords);

  // K7b with 4-bit codes and the int8 LUT (pq4_mma_kernels.cu
  // pq4_queue_kernel) at chip_smoke.py path 3's shape: 1,000,000 rows (npad
  // 1,000,448) of m = 192 chunks, Q = 256, k = 10: its scan and the kernel.
  {
    const int m = 192, D4 = m * 16, kk = 10;
    const long long n4 = 1000000, np4 = 1000448;
    uint8_t* codes4;
    int8_t* lut;
    float *scale, *bias, *voff4;
    cudaMalloc(&codes4, (size_t)m * np4);
    cudaMalloc(&lut, (size_t)Q * D4);
    cudaMalloc(&scale, Q * 4);
    cudaMalloc(&bias, Q * 4);
    cudaMalloc(&voff4, np4 * 4);
    fill_kernel<<<1024, 256>>>(codes4, (long long)m * np4, 0x0f, 5);
    for (int c = 0; c < m; ++c) cudaMemset(codes4 + c * np4 + n4, 0, np4 - n4);
    fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(lut), (long long)Q * D4, 0xff, 6);
    std::vector<float> hs(Q, 1e-3f), hb(Q, 0.5f);
    cudaMemcpy(scale, hs.data(), Q * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(bias, hb.data(), Q * 4, cudaMemcpyHostToDevice);
    cudaMemset(voff4, 0, np4 * 4);
    // The scan: pq4_queue_kernel's products and keys, each key folded into a
    // register in place of the select (kScan), in the kernel's geometry.
    const int split = queue_split(np4, Q, 64);
    const size_t smem = kAlign + kOxRing + 8 * 2 * 64 + QueueSelect<64>::bytes(kk);
    float *cv, *ci;
    cudaMalloc(&cv, (size_t)Q * ((np4 + split - 1) / split) * kk * 4);
    cudaMalloc(&ci, (size_t)Q * ((np4 + split - 1) / split) * kk * 4);
    const ScanMap dense{nullptr, 0, nullptr, 0, 0};
    const float ms = time_ms(pq4_queue_kernel<true>, smem, [&] {
      launch_onehot_queue<true>(codes4, np4, lut, bias, scale, voff4, cv, ci, Q, (int)np4, (int)n4,
                                D4, split, kk, dense, 0);
    });
    report("pq_search_exact_4bit", "queue", split, smem, ms);
    auto launch = [&] {
      qtt_pq4_mma_search_exact(lut, scale, bias, codes4, voff4, cv, ci, Q, m, np4, (int)n4, split,
                               kk, nullptr, 0, 0, nullptr);
    };
    report_cost("pq_search_exact_4bit", "random", kk,
                time_ms(pq4_queue_kernel<false>, smem, launch));
    printf("{\"probe\": \"occupancy\", \"kernel\": \"pq4_queue_kernel\", \"kk\": %d, "
           "\"smem\": %zu, \"blocks_per_sm\": %d}\n",
           kk, smem, blocks_per_sm(pq4_queue_kernel<false>, smem));
    for (void* p : {(void*)codes4, (void*)lut, (void*)scale, (void*)bias, (void*)voff4,
                    (void*)cv, (void*)ci})
      cudaFree(p);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "select_split: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
