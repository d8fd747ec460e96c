// The approx searches' time split into pass 1, its scan alone and the
// combine, on one card, for both int8 bodies of dot_scan.cuh:
// approx_ws_kernel (the warp-specialized body) as the wrappers launch it
// (span-block items in place, or 2048-row items with the combine; its
// 128-query tile, or 64 where Q <= 64) and at its other query tile, and
// approx_parts_kernel (the body where that tile does not fit, queries in the
// ring) at 2048-row items with the combine, the reference; and for both
// sign-query bodies of bq_kernels.cu: bq_sign_approx_ws_kernel the same
// way, against bq_sign_approx_kernel (2048-row parts and the combine, the
// reference); and for 4-bit int8 K7a, pq4_mma_kernels.cu's
// pq4_approx_ws_kernel against approx_parts_kernel<NibbleRows>, whose scan
// it also splits into the one-hot expansion and the products (the 4-bit
// int8 score matrix K8 has a probe of its own, scores_split.cu). Seven
// searches:
//   * K9a: 256 of 1,152 tiles of 1024 rows of 768-byte SQ codes, Q = 256
//     (CodeRows, the step-by-step epilogue; scan_ab.py's shape);
//   * K2: a dense scan of 100,352 rows of 1024-byte SQ codes, Q = 256 and 32
//     (span blocks of 8,192 rows);
//   * K10-value at the serving width: all 1,226 tiles of 1024 rows of 768
//     bits, Q = 256 (PlaneRows, the kOnce epilogue, a query mult a query,
//     corr);
//   * sign-query K5a: a dense scan of 1,000,000 rows of 1536 bits (npad
//     1,001,472), Q = 256 (chip_smoke.py path 2's shape);
//   * sign-query K10: 256 of 1,152 tiles of 1024 rows of 768 bits, Q = 256;
//   * 4-bit int8 K7a: 1,000,000 rows of 192 chunks, Q = 256 (chip_smoke.py
//     path 3's shape).
// "scan" is pass 1 with its epilogue and maxima taken out (each accumulator
// folded into a register): a timing probe whose results are wrong. The
// merge's torch.topk is timed by scan_ab.py (--only approx), beside the
// public wrappers. Every warp-specialized candidate set must equal the
// reference to the bit. A standalone program (not part of the kernel
// library):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//          -o approx_split approx_split.cu
//     ./approx_split               # one JSON line a measurement
//     ./approx_split sign          # the sign-query K5a / K10 alone
//     ./approx_split sign-parent   # their two-block body alone
//     ./approx_split onehot        # the 4-bit int8 K7a alone
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <type_traits>
#include <vector>

#include "../bq_kernels.cu"       // the sign-query kernels, and dot_scan.cuh
#include "../pq4_mma_kernels.cu"  // the 4-bit int8 one-hot PQ searches
#include "probe_common.cuh"       // operands, timing, the one-hot split's pieces

namespace {

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

// bq_sign_approx_kernel's scan alone: its loop over its part's segments
// (mma_segment with BitRows), each accumulator folded into a register.
__global__ void __launch_bounds__(kThreads, ApproxTile::kBlocks) sign_parts_scan_kernel(
    const uint32_t* __restrict__ qwords, const uint32_t* __restrict__ planes,
    unsigned* __restrict__ out, int Q, int W, long long npad, long long ncomp, int part,
    ScanMap map) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  constexpr int TQ = ApproxTile::TQ;
  int* pc = reinterpret_cast<int*>(smem + ApproxTile::kBytes) + TQ;
  const int nqt = (Q + TQ - 1) / TQ;
  const int part_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)part_id * part;
  const BitRows rows{planes, npad, W, pc};
  unsigned fold = 0;
  for (int off = 0; off < part && start + off < ncomp; off += kSeg) {
    int acc[1][32];
    mma_segment<ApproxTile>(rows, reinterpret_cast<const int8_t*>(qwords), q0, Q,
                            map.row(start + off), 4 * W, smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) fold ^= (unsigned)acc[0][e];
  }
  out[(long long)blockIdx.x * kThreads + threadIdx.x] = fold;
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

// Pass 1 of one sign-query search on bq_sign_approx_ws_kernel (TQ queries a
// block) at part rows an item, its scan alone and, where part is not the
// span block, the combine; its candidates (into ov / oi) against the
// reference (rv / ri).
template <int TQ>
bool split_sign_ws(const char* name, const uint32_t* qwords, const uint32_t* planes, int Q,
                   int W, long long npad, long long ncomp, int n_valid, int dim, int span,
                   int part, ScanMap map, float* pv, int* pi, float* ov, int* oi, const float* rv,
                   const int* ri) {
  auto pass1 = [&] {
    launch_sign_approx_ws<false, TQ>(qwords, planes, pv, pi, Q, W, npad, ncomp, n_valid, dim, 1,
                                     part, map, 0);
  };
  const float p1 = time_ms(pass1);
  bool good = ok("sign ws pass 1");
  const float sc = time_ms([&] {
    launch_sign_approx_ws<true, TQ>(qwords, planes, ov, oi, Q, W, npad, ncomp, n_valid, dim, 1,
                                    part, map, 0);
  });
  good &= ok("sign ws scan");
  const int nparts = (int)((ncomp + part - 1) / part);
  auto combine = [&] { launch_approx_combine(pv, pi, ov, oi, Q, nparts, span / part, 0); };
  const float cb = part == span ? 0.0f : time_ms(combine);
  good &= ok("sign ws combine");
  pass1();
  if (part != span) combine();
  good &= cudaDeviceSynchronize() == cudaSuccess;
  const bool eq = good && same(rv, ri, part == span ? pv : ov, part == span ? pi : oi,
                               (size_t)Q * ((ncomp + span - 1) / span) * kSlot);
  const SignLayout L(TQ, W);
  printf("{\"probe\": \"approx_split\", \"kernel\": \"%s\", \"design\": \"sign_ws%d\", "
         "\"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, \"combine_ms\": %.4f, "
         "\"smem\": %d, \"slots\": %d, \"blocks_per_sm\": 1, \"equal\": %s}\n",
         name, TQ, part, p1, sc, cb, kAlign + L.bytes, L.R, eq ? "true" : "false");
  return good && eq;
}

// One sign-query search (K5a dense, K10 over selected tiles; bq_kernels.cu):
// the two-block body (bq_sign_approx_kernel, its 64-query tile, two blocks a
// SM) at 2048-row items, its scan alone and the combine, the reference; then
// bq_sign_approx_ws_kernel as the wrapper launches it (128 queries, span
// items in place), at 2048-row items with the combine, and at 64 queries.
// Every warp-specialized candidate set must equal the reference to the bit.
bool split_sign(const char* name, const uint32_t* qwords, const uint32_t* planes, int Q, int W,
                long long npad, long long ncomp, int n_valid, int dim, int span, ScanMap map,
                bool ws) {
  const int part = 2048, nparts = (int)((ncomp + part - 1) / part), nqt = (Q + 63) / 64;
  const size_t slots = (size_t)Q * (ncomp / 512 + 1) * kSlot;
  float *pv, *rv, *wv, *xv;
  int *pi, *ri, *wi, *xi;
  unsigned* fold;
  for (float** p : {&pv, &rv, &wv, &xv}) cudaMalloc(p, slots * 4);
  for (int** p : {&pi, &ri, &wi, &xi}) cudaMalloc(p, slots * 4);
  cudaMalloc(&fold, (size_t)nparts * nqt * kThreads * 4);
  const float p1 = time_ms([&] {
    launch_sign_approx_parts(qwords, planes, pv, pi, Q, W, npad, ncomp, n_valid, dim, 1, part,
                             map, 0);
  });
  bool good = ok("sign pass 1");
  const size_t smem = kAlign + ApproxTile::kBytes + hamming_bytes<ApproxTile>();
  cudaFuncSetAttribute(sign_parts_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const float sc = time_ms([&] {
    sign_parts_scan_kernel<<<nparts * nqt, kThreads, smem>>>(qwords, planes, fold, Q, W, npad,
                                                             ncomp, part, map);
  });
  good &= ok("sign scan");
  const float cb = time_ms([&] { launch_approx_combine(pv, pi, rv, ri, Q, nparts, span / part, 0); });
  launch_sign_approx_parts(qwords, planes, pv, pi, Q, W, npad, ncomp, n_valid, dim, 1, part, map,
                           0);
  launch_approx_combine(pv, pi, rv, ri, Q, nparts, span / part, 0);
  good &= ok("sign combine") && cudaDeviceSynchronize() == cudaSuccess;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bq_sign_approx_kernel, kThreads, smem);
  printf("{\"probe\": \"approx_split\", \"kernel\": \"%s\", \"design\": \"sign_parts\", "
         "\"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, \"combine_ms\": %.4f, "
         "\"smem\": %zu, \"blocks_per_sm\": %d}\n",
         name, part, p1, sc, cb, smem, per_sm);
  if (ws && good && sign_ws_tq(Q, W) == 128) {
    good &= split_sign_ws<128>(name, qwords, planes, Q, W, npad, ncomp, n_valid, dim, span, span,
                               map, wv, wi, xv, xi, rv, ri);
    good &= split_sign_ws<128>(name, qwords, planes, Q, W, npad, ncomp, n_valid, dim, span, 2048,
                               map, xv, xi, wv, wi, rv, ri);
    good &= split_sign_ws<64>(name, qwords, planes, Q, W, npad, ncomp, n_valid, dim, span, span,
                              map, wv, wi, xv, xi, rv, ri);
  }
  for (void* p : {(void*)pv, (void*)pi, (void*)rv, (void*)ri, (void*)wv, (void*)wi, (void*)xv,
                  (void*)xi, (void*)fold})
    cudaFree(p);
  return good;
}

// Random sign planes [W, npad] (zero past n) and query words [Q, W].
void sign_operands(uint32_t** planes, uint32_t** qwords, int Q, int W, long long npad,
                   long long n, unsigned seed) {
  cudaMalloc(planes, (size_t)W * npad * 4);
  cudaMalloc(qwords, (size_t)Q * W * 4);
  fill_kernel<<<1024, 256>>>(reinterpret_cast<uint8_t*>(*planes), (long long)W * npad * 4, 0xff,
                             seed);
  fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(*qwords), (long long)Q * W * 4, 0xff,
                           seed + 1);
  for (int w = 0; w < W && n < npad; ++w) cudaMemset(*planes + w * npad + n, 0, (npad - n) * 4);
}

// 4-bit int8 K7a at chip_smoke.py path 3's shape: 1,000,000 rows of m = 192
// chunks (3,072 one-hot bytes a row, npad 1,000,448), Q = 256, a random
// rowadd, 4096-row parts in place (one span block each, no combine). The
// reference is approx_parts_kernel<NibbleRows, true>, K7a's body before
// pq4_approx_ws_kernel (A built in registers): its pass 1, its scan alone
// (the expansion and the products), the expansion alone and the products
// alone; then pq4_approx_ws_kernel's pass 1 and scan alone in the wrapper's
// geometry at Q = 256 (128 queries a block, two m64 blocks a warpgroup) and
// at Q = 32 (64 and four), and at Q = 32 also in the other (the choice's
// measure), its candidates equal to the reference's to the bit.
bool split_onehot() {
  const int Q = 256, m = 192, D = m * 16, part = 4096;
  const long long n = 1000000, npad = 1000448;
  uint8_t* codes;
  int8_t* lut;
  float *scale, *bias, *voff;
  cudaMalloc(&codes, (size_t)m * npad);
  cudaMalloc(&lut, (size_t)Q * D);
  cudaMalloc(&scale, Q * 4);
  cudaMalloc(&bias, Q * 4);
  cudaMalloc(&voff, npad * 4);
  fill_kernel<<<1024, 256>>>(codes, (long long)m * npad, 0x0f, 31);
  for (int c = 0; c < m; ++c) cudaMemset(codes + c * npad + n, 0, npad - n);
  fill_kernel<<<64, 256>>>(reinterpret_cast<uint8_t*>(lut), (long long)Q * D, 0xff, 32);
  fill_f32<<<64, 256>>>(scale, Q, 1e-3f, 1e-2f, 33);
  fill_f32<<<64, 256>>>(bias, Q, -1.f, 2.f, 34);
  fill_f32<<<1024, 256>>>(voff, npad, -1.f, 2.f, 35);
  const ScanMap dense{nullptr, 0, nullptr, 0, 0};
  const int nparts = (int)((npad + part - 1) / part), nqt = Q / ApproxTile::TQ;
  const size_t slots = (size_t)Q * nparts * kSlot;
  float* rv;
  int* ri;
  unsigned* fold;
  cudaMalloc(&rv, slots * 4);
  cudaMalloc(&ri, slots * 4);
  cudaMalloc(&fold, (size_t)nparts * nqt * kThreads * 4);
  const float p1 = time_ms([&] {
    launch_approx_parts<NibbleRows, true>(codes, npad, lut, bias, scale, voff, rv, ri, Q, (int)npad,
                                          (int)n, D, part, 1, dense, 0);
  });
  bool good = ok("one-hot pass 1");
  const size_t ssmem = kAlign + ApproxTile::kBytes;
  cudaFuncSetAttribute(parts_scan_kernel<NibbleRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ssmem);
  cudaFuncSetAttribute(parts_scan_kernel<NibbleProducts>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  cudaFuncSetAttribute(onehot_expand_kernel<ApproxTile>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  const unsigned grid = (unsigned)(nparts * nqt);
  const float sc = time_ms([&] {
    parts_scan_kernel<NibbleRows><<<grid, kThreads, ssmem>>>(codes, npad, lut, fold, Q, (int)npad,
                                                             D, part, dense);
  });
  const float pr = time_ms([&] {
    parts_scan_kernel<NibbleProducts><<<grid, kThreads, ssmem>>>(codes, npad, lut, fold, Q,
                                                                 (int)npad, D, part, dense);
  });
  const float ex = time_ms([&] {
    onehot_expand_kernel<ApproxTile><<<grid, kThreads, ssmem>>>(codes, npad, fold, Q, (int)npad,
                                                                D, part);
  });
  good &= ok("one-hot scan splits") && cudaDeviceSynchronize() == cudaSuccess;
  printf("{\"probe\": \"approx_split\", \"kernel\": \"pq_search_approx_4bit\", "
         "\"design\": \"onehot_parts\", \"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, "
         "\"expand_ms\": %.4f, \"products_ms\": %.4f, \"combine_ms\": 0.0, \"smem\": %zu, "
         "\"blocks_per_sm\": %d}\n",
         part, p1, sc, ex, pr, ssmem, ApproxTile::kBlocks);
  // pq4_approx_ws_kernel in the geometry TQ queries x NB blocks, at Q = q
  // (the first q queries): pass 1, its scan alone, its candidates against
  // the reference's first q rows.
  float* wv;
  int* wi;
  cudaMalloc(&wv, slots * 4);
  cudaMalloc(&wi, slots * 4);
  bool eq = true;
  auto ws = [&](auto tq, auto nb, int q, const char* design) {
    constexpr int TQ = decltype(tq)::value, NB = decltype(nb)::value;
    auto run = [&](auto scan) {
      launch_onehot_approx_g<decltype(scan)::value, TQ, NB>(codes, npad, lut, bias, scale, voff,
                                                             wv, wi, q, (int)npad, (int)n, D, part,
                                                             dense, 0);
    };
    const float t1 = time_ms([&] { run(std::false_type{}); });
    const float ts = time_ms([&] { run(std::true_type{}); });
    run(std::false_type{});
    const bool e = ok("one-hot ws") && cudaDeviceSynchronize() == cudaSuccess &&
                   same(rv, ri, wv, wi, (size_t)q * nparts * kSlot);
    eq &= e;
    printf("{\"probe\": \"approx_split\", \"kernel\": \"pq_search_approx_4bit%s\", "
           "\"design\": \"%s\", \"part\": %d, \"pass1_ms\": %.4f, \"scan_ms\": %.4f, "
           "\"combine_ms\": 0.0, \"smem\": %d, \"stages\": %d, \"tq\": %d, \"nb\": %d, "
           "\"blocks_per_sm\": 1, \"equal\": %s}\n",
           q == Q ? "" : "_q32", design, part, t1, ts, OhGeom<TQ, NB>::kSmem, OhGeom<TQ, NB>::S,
           TQ, NB, e ? "true" : "false");
  };
  // The wrapper's geometry at Q = 256 and at Q = 32, and the other at 32.
  ws(std::integral_constant<int, 128>{}, std::integral_constant<int, 2>{}, Q, "onehot_ws");
  ws(std::integral_constant<int, 64>{}, std::integral_constant<int, 4>{}, 32, "onehot_ws");
  ws(std::integral_constant<int, 128>{}, std::integral_constant<int, 2>{}, 32, "onehot_ws128");
  for (void* p : {(void*)codes, (void*)lut, (void*)scale, (void*)bias, (void*)voff, (void*)rv,
                  (void*)ri, (void*)fold, (void*)wv, (void*)wi})
    cudaFree(p);
  return good && eq;
}

}  // namespace

int main(int argc, char** argv) {
  setvbuf(stdout, nullptr, _IOLBF, 0);  // each line out as it is measured
  const int Q = 256, D = 768, TILE = 1024;
  // No argument: every search; "sign": the sign-query K5a / K10 alone;
  // "sign-parent": only their two-block body (bq_sign_approx_kernel);
  // "onehot": the 4-bit int8 K7a alone.
  const bool all = argc < 2, ws = all || !strcmp(argv[1], "sign"),
             sign = ws || !strcmp(argv[1], "sign-parent"),
             onehot = all || !strcmp(argv[1], "onehot");
  bool good = true;
  if (onehot) good &= split_onehot();

  // K9a: SQ codes of 1,152 tiles, 256 of them selected.
  if (all) {
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
    if (!all) break;
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
  if (all) {
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
  // Sign-query K5a at path 2's 1,000,000 x 1536 (span blocks of 4,096
  // rows), and K10 over 256 of 1,152 tiles of 1024 rows of 768 dims.
  if (sign) {
    const long long n = 1000000, npad = 1001472;
    uint32_t *planes, *qwords;
    sign_operands(&planes, &qwords, Q, 48, npad, n, 21);
    good &= split_sign("bq_search_approx", qwords, planes, Q, 48, npad, npad, (int)n, 1536, 4096,
                       ScanMap{nullptr, 0, nullptr, 0, 0}, ws);
    cudaFree(planes);
    cudaFree(qwords);
    const int tiles = 1152, ntile = 256;
    sign_operands(&planes, &qwords, Q, D / 32, (long long)tiles * TILE, (long long)tiles * TILE,
                  23);
    int* sel;
    cudaMalloc(&sel, ntile * 4);
    std::vector<int> hs(ntile);
    for (int i = 0; i < ntile; ++i) hs[i] = (i * 7) % tiles;
    cudaMemcpy(sel, hs.data(), ntile * 4, cudaMemcpyHostToDevice);
    good &= split_sign("bq_search_indexed", qwords, planes, Q, D / 32, (long long)tiles * TILE,
                       ntile * TILE, ntile * TILE, D, 4 * TILE, ScanMap{sel, TILE, nullptr, 0, 0},
                       ws);
    for (void* p : {(void*)planes, (void*)qwords, (void*)sel}) cudaFree(p);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "approx_split: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return good ? 0 : 1;
}
