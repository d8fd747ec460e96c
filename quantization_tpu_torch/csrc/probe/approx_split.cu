// The int8 approx searches' time split into pass 1, its scan alone and the
// combine, on one card, for both bodies of dot_scan.cuh: approx_ws_kernel
// (the warp-specialized body) as the wrappers launch it (span-block items in
// place, or 2048-row items with the combine; its 128-query tile, or 64 where
// Q <= 64) and at its other query tile, and approx_parts_kernel (the body
// where that tile does not fit, queries in the ring) at 2048-row items with
// the combine, the reference. Four searches:
//   * K9a: 256 of 1,152 tiles of 1024 rows of 768-byte SQ codes, Q = 256
//     (CodeRows, the step-by-step epilogue; scan_ab.py's shape);
//   * K2: a dense scan of 100,352 rows of 1024-byte SQ codes, Q = 256 and 32
//     (span blocks of 8,192 rows);
//   * K10-value at the serving width: all 1,226 tiles of 1024 rows of 768
//     bits, Q = 256 (PlaneRows, the kOnce epilogue, a query mult a query,
//     corr).
// "scan" is pass 1 with its epilogue and maxima taken out (each accumulator
// folded into a register): a timing probe whose results are wrong. The
// merge's torch.topk is timed by scan_ab.py (--only approx), beside the
// public wrappers. Every warp-specialized candidate set must equal the
// reference to the bit. A standalone program (not part of the kernel
// library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//          -o approx_split approx_split.cu
//     ./approx_split    # one JSON line a measurement
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <type_traits>
#include <vector>

#include "../dot_scan.cuh"

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

// approx_parts_kernel's scan alone: its loop over its part's segments
// (mma_segment), each accumulator folded into a register.
template <class Rows>
__global__ void __launch_bounds__(kThreads, ApproxTile::kBlocks) parts_scan_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, unsigned* __restrict__ out, int Q, int ncomp, int D,
    int part, ScanMap map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr int TQ = ApproxTile::TQ;
  const int nqt = (Q + TQ - 1) / TQ;
  const int part_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)part_id * part;
  unsigned fold = 0;
  for (int off = 0; off < part && start + off < ncomp; off += kSeg) {
    int acc[1][32];
    mma_segment<ApproxTile>(Rows{base, stride}, qcodes, q0, Q, map.row(start + off), D,
                            smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) fold ^= (unsigned)acc[0][e];
  }
  out[(long long)blockIdx.x * kThreads + threadIdx.x] = fold;
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
    fprintf(stderr, "approx_split: %s: %s\n", what, cudaGetErrorString(err));
    return false;
  }
  return true;
}

// Pass 1 of one search on approx_parts_kernel at part rows an item, its
// scan alone and, where part is not the span block, the combine.
template <class Rows, bool kOnce>
bool split_one(const char* name, const void* base, long long stride, const int8_t* qcodes,
               const float* qoff, const float* mult, const float* voff, int Q, int ncomp, int D,
               int mstride, int span, int part, ScanMap map, float* pv, int* pi, float* ov,
               int* oi, unsigned* fold) {
  const size_t smem = kAlign + ApproxTile::kBytes + kApproxSide +
                      2 * ApproxTile::TQ * sizeof(typename QParam<kOnce>::T);
  auto* kernel = approx_parts_kernel<Rows, kOnce>;
  const int nparts = (ncomp + part - 1) / part, nqt = (Q + 63) / 64;
  const float p1 = time_ms([&] {
    launch_approx_parts<Rows, kOnce>(base, stride, qcodes, qoff, mult, voff, pv, pi, Q, ncomp,
                                     ncomp, D, part, mstride, map, 0);
  });
  bool good = ok("pass 1");
  const size_t ssmem = kAlign + ApproxTile::kBytes;
  cudaFuncSetAttribute(parts_scan_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ssmem);
  const float sc = time_ms([&] {
    parts_scan_kernel<Rows><<<nparts * nqt, kThreads, ssmem>>>(
        static_cast<const typename Rows::Elem*>(base), stride, qcodes, fold, Q, ncomp, D, part,
        map);
  });
  good &= ok("scan");
  const float cb = part == span ? 0.0f : time_ms([&] {
    launch_approx_combine(pv, pi, ov, oi, Q, nparts, span / part, 0);
  });
  good &= ok("combine");
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  printf("{\"probe\": \"approx_split\", \"kernel\": \"%s\", \"design\": \"parts\", "
         "\"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, \"combine_ms\": %.4f, "
         "\"smem\": %zu, \"blocks_per_sm\": %d}\n",
         name, part, p1, sc, cb, smem, per_sm);
  return good;
}

// Equal to the bit: n values and ids at (av, ai) and (bv, bi) on the card.
bool same(const float* av, const int* ai, const float* bv, const int* bi, size_t n) {
  std::vector<float> a(n), b(n);
  std::vector<int> x(n), y(n);
  cudaMemcpy(a.data(), av, n * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(b.data(), bv, n * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(x.data(), ai, n * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(y.data(), bi, n * 4, cudaMemcpyDeviceToHost);
  return !memcmp(a.data(), b.data(), n * 4) && x == y;
}

// Pass 1 of one search on the warp-specialized body (approx_ws_kernel with
// TQ queries a block, the other warpgroup starting kGo chunks before a
// chain's end) at part rows an item, its scan alone and, where part is not
// the span block, the combine; its candidates (into ov / oi) against the
// reference (rv / ri).
template <class Rows, bool kOnce, int TQ>
bool split_ws(const char* name, const void* base, long long stride, const int8_t* qcodes,
              const float* qoff, const float* mult, const float* voff, int Q, int ncomp, int D,
              int mstride, int span, int part, ScanMap map, float* pv, int* pi, float* ov,
              int* oi, const float* rv, const int* ri) {
  auto pass1 = [&] {
    launch_approx_ws<Rows, kOnce, false, TQ>(base, stride, qcodes, qoff, mult, voff, pv, pi, Q,
                                             ncomp, ncomp, D, part, mstride, map, 0);
  };
  const float p1 = time_ms(pass1);
  bool good = ok("ws pass 1");
  const float sc = time_ms([&] {
    launch_approx_ws<Rows, kOnce, true, TQ>(base, stride, qcodes, qoff, mult, voff, ov, oi, Q,
                                            ncomp, ncomp, D, part, mstride, map, 0);
  });
  good &= ok("ws scan");
  const int nparts = (ncomp + part - 1) / part;
  auto combine = [&] { launch_approx_combine(pv, pi, ov, oi, Q, nparts, span / part, 0); };
  const float cb = part == span ? 0.0f : time_ms(combine);
  good &= ok("ws combine");
  pass1();
  if (part != span) combine();
  good &= cudaDeviceSynchronize() == cudaSuccess;
  const bool eq = good && same(rv, ri, part == span ? pv : ov, part == span ? pi : oi,
                               (size_t)Q * ((ncomp + span - 1) / span) * kSlot);
  const WsLayout L(TQ, D, std::is_same<Rows, PlaneRows>::value,
                   (int)sizeof(typename QParam<kOnce>::T));
  printf("{\"probe\": \"approx_split\", \"kernel\": \"%s\", \"design\": \"ws%d\", "
         "\"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, \"combine_ms\": %.4f, "
         "\"smem\": %d, \"stages\": %d, \"blocks_per_sm\": 1, \"equal\": %s}\n",
         name, TQ, part, p1, sc, cb, kAlign + L.bytes, L.S, eq ? "true" : "false");
  return good && eq;
}

// One search on both bodies: approx_parts_kernel at 2048-row items and the
// combine, the reference;
// approx_ws_kernel as the wrappers launch it at span items in place and at
// 2048-row items with the combine, and its variants at span items. Every
// warp-specialized candidate set must equal the reference to the bit.
template <class Rows, bool kOnce>
bool split(const char* name, const void* base, long long stride, const int8_t* qcodes,
           const float* qoff, const float* mult, const float* voff, int Q, int ncomp, int D,
           int mstride, int span, ScanMap map) {
  const int pmax = ncomp / 512 + 1;
  float *pv, *ov, *wv, *xv;
  int *pi, *oi, *wi, *xi;
  unsigned* fold;
  const size_t slots = (size_t)Q * pmax * kSlot;
  for (float** p : {&pv, &ov, &wv, &xv}) cudaMalloc(p, slots * 4);
  for (int** p : {&pi, &oi, &wi, &xi}) cudaMalloc(p, slots * 4);
  cudaMalloc(&fold, (size_t)pmax * 4 * kThreads * 4);
  bool good = split_one<Rows, kOnce>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp, D,
                                     mstride, span, 2048, map, pv, pi, ov, oi, fold);
  launch_approx_combine(pv, pi, ov, oi, Q, (ncomp + 2047) / 2048, span / 2048, 0);
  good &= ok("the reference") && cudaDeviceSynchronize() == cudaSuccess;
  // The query tile the wrappers' launch takes (ws_tq), then the other.
  if (Q > 64) {
    good &= split_ws<Rows, kOnce, kWsTQ>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp,
                                         D, mstride, span, 2048, map, xv, xi, wv, wi, ov, oi);
    good &= split_ws<Rows, kOnce, kWsTQ>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp,
                                         D, mstride, span, span, map, wv, wi, xv, xi, ov, oi);
    good &= split_ws<Rows, kOnce, 64>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp, D,
                                      mstride, span, span, map, wv, wi, xv, xi, ov, oi);
  } else {
    good &= split_ws<Rows, kOnce, 64>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp, D,
                                      mstride, span, 2048, map, xv, xi, wv, wi, ov, oi);
    good &= split_ws<Rows, kOnce, 64>(name, base, stride, qcodes, qoff, mult, voff, Q, ncomp, D,
                                      mstride, span, span, map, wv, wi, xv, xi, ov, oi);
  }
  for (void* p : {(void*)pv, (void*)pi, (void*)ov, (void*)oi, (void*)wv, (void*)wi, (void*)xv,
                  (void*)xi, (void*)fold})
    cudaFree(p);
  return good;
}

}  // namespace

int main() {
  setvbuf(stdout, nullptr, _IOLBF, 0);  // each line out as it is measured
  const int Q = 256, D = 768, TILE = 1024;
  bool good = true;

  // K9a: SQ codes of 1,152 tiles, 256 of them selected.
  {
    const int tiles = 1152, ntile = 256;
    const long long npad = (long long)tiles * TILE;
    int8_t *codes, *qcodes;
    float *qoff, *mult, *voff;
    int* sel;
    cudaMalloc(&codes, npad * D);
    cudaMalloc(&qcodes, (size_t)Q * D);
    cudaMalloc(&qoff, Q * 4);
    cudaMalloc(&mult, 4);
    cudaMalloc(&voff, npad * 4);
    cudaMalloc(&sel, ntile * 4);
    fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(codes), npad * D, 0x7f, 1);
    fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(qcodes), (long long)Q * D, 0x7f, 2);
    fill_f32<<<64, 256>>>(qoff, Q, 0.f, 1.f, 3);
    fill_f32<<<1, 32>>>(mult, 1, 1e-3f, 0.f, 4);
    fill_f32<<<1024, 256>>>(voff, npad, 0.f, 1.f, 5);
    std::vector<int> hs(ntile);
    for (int i = 0; i < ntile; ++i) hs[i] = (i * 7) % tiles;
    cudaMemcpy(sel, hs.data(), ntile * 4, cudaMemcpyHostToDevice);
    good &= split<CodeRows, false>("sq_search_indexed_approx", codes, D, qcodes, qoff, mult,
                                   voff, Q, ntile * TILE, D, 0, 4 * TILE,
                                   ScanMap{sel, TILE, nullptr, 0, 0});
    for (void* p : {(void*)codes, (void*)qcodes, (void*)qoff, (void*)mult, (void*)voff,
                    (void*)sel})
      cudaFree(p);
  }

  // K2: a dense scan of 100,352 rows of 1024-byte SQ codes (span blocks of
  // 8,192 rows), Q = 256 and 32.
  for (const int q : {256, 32}) {
    const int D2 = 1024, n = 100352;
    int8_t *codes, *qcodes;
    float *qoff, *mult, *voff;
    cudaMalloc(&codes, (size_t)n * D2);
    cudaMalloc(&qcodes, (size_t)q * D2);
    cudaMalloc(&qoff, q * 4);
    cudaMalloc(&mult, 4);
    cudaMalloc(&voff, (size_t)n * 4);
    fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(codes), (long long)n * D2, 0x7f, 11);
    fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(qcodes), (long long)q * D2, 0x7f, 12);
    fill_f32<<<64, 256>>>(qoff, q, 0.f, 1.f, 13);
    fill_f32<<<1, 32>>>(mult, 1, 1e-3f, 0.f, 14);
    fill_f32<<<1024, 256>>>(voff, n, 0.f, 1.f, 15);
    good &= split<CodeRows, false>(q == 256 ? "sq_search_approx" : "sq_search_approx_q32", codes,
                                   D2, qcodes, qoff, mult, voff, q, n, D2, 0, 8192,
                                   ScanMap{nullptr, 0, nullptr, 0, 0});
    for (void* p : {(void*)codes, (void*)qcodes, (void*)qoff, (void*)mult, (void*)voff})
      cudaFree(p);
  }

  // K10-value at the serving width: every tile of 1,226, value queries.
  {
    const int tiles = 1226, W = D / 32;
    const long long npad = (long long)tiles * TILE;
    uint32_t* planes;
    int8_t* qs;
    float *qb, *mult, *rowadd, *corr;
    int* sel;
    cudaMalloc(&planes, (size_t)W * npad * 4);
    cudaMalloc(&qs, (size_t)Q * D);
    cudaMalloc(&qb, Q * 4);
    cudaMalloc(&mult, Q * 4);
    cudaMalloc(&rowadd, npad * 4);
    cudaMalloc(&corr, npad / 512 * Q * 4);
    cudaMalloc(&sel, tiles * 4);
    fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(planes), (long long)W * npad * 4, 0xff,
                               6);
    fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(qs), (long long)Q * D, 0xff, 7);
    fill_f32<<<64, 256>>>(qb, Q, -1.f, 2.f, 8);
    fill_f32<<<64, 256>>>(mult, Q, 1e-3f, 2e-2f, 9);
    cudaMemset(rowadd, 0, npad * 4);
    fill_f32<<<1024, 256>>>(corr, npad / 512 * Q, -1.f, 2.f, 10);
    std::vector<int> hs(tiles);
    for (int i = 0; i < tiles; ++i) hs[i] = (i * 7) % tiles;
    cudaMemcpy(sel, hs.data(), tiles * 4, cudaMemcpyHostToDevice);
    good &= split<PlaneRows, true>("bq_search_indexed_res_serve", planes, npad, qs, qb, mult,
                                   rowadd, Q, (int)npad, D, 1, 4 * TILE,
                                   ScanMap{sel, TILE, corr, 1, Q});
    for (void* p : {(void*)planes, (void*)qs, (void*)qb, (void*)mult, (void*)rowadd,
                    (void*)corr, (void*)sel})
      cudaFree(p);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "approx_split: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return good ? 0 : 1;
}
