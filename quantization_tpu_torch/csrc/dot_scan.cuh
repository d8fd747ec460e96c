// The int8 scan bodies shared by sq_kernels.cu (K1-K3, K9a / K9b, K12) and
// bq_kernels.cu (K5b and the value-query forms of K5a / K10).
//
// A block scores one 128-row corpus segment against a 32-query tile: both
// sides are staged into shared memory 128 bytes of depth at a time, and each
// thread holds a 4-query x 4-row register tile that reads its operands as
// 16-byte vectors (rows padded to 144 bytes, so a warp's vector reads are
// free of bank conflicts): 16 four-byte steps per 2 shared-memory loads.
//
// The searches ask for two blocks per SM (__launch_bounds__(kThreads, 2)):
// left to itself, ptxas gave the approx body 158 registers (one block per
// SM) and the exact body 64 with spills, and K9a / K1 ran up to a third
// slower on the H100 than before the bodies were shared (PERF.md).
//
// Where the rows come from ("Rows"; each kernel takes the row source as a
// __restrict__ pointer and a stride and builds its Rows inside: passed as a
// struct kernel parameter, the scan ran K2 measurably slower on the H100):
//   * CodeRows: SQ-u8 codes int8 [N, D] row-major, copied 16 bytes a thread.
//   * PlaneRows: BQ bit planes u32 [W8, npad] (word w of row n at
//     planes[w * npad + n], bit j of word w = dim 32w + j, LSB first, as
//     ops/bq.py packs them). A thread loads one word of one row — a warp
//     reads 32 neighbouring rows, one 128-byte line — and expands it to 32
//     0/1 bytes, one nibble at a time: (nibble * 0x00204081) & 0x01010101
//     moves bit i of the nibble to byte i. The residual-BQ score is then
//     the SQ dot of an int8 value query against 0/1 "codes", so K5b and the
//     value forms of K5a / K10 are the K1 / K2 / K9a bodies with this row
//     loader. The alternative, 8 AND + __popc planes of the int8 query per
//     word, issues as many instructions at a quarter of __dp4a's rate.
//
// What each four-byte step does ("Op"): DotOp, the int8 dot (__dp4a);
// AbsDiffDotOp, the L1 sum of absolute differences of bytes in [0, 127]
// (exact as unsigned), as __vabsdiffu4 then a __dp4a against 0x01010101.
// A __vsadu4 step was timed beside it and dropped: on an NVIDIA H100 80GB
// HBM3 at 700 W it ran 0.71 ms against this step's 0.60-0.62 ms at
// 100k x 1024, Q = 256 (chip_smoke.py; PERF.md).
//
// The epilogue ("kOnce"): false — (mult * acc + qoff) + voff, each step
// rounded on its own (__fmul_rn / __fadd_rn; the library is built with
// -fmad=false), as plain torch rounds it (K1-K3, K9); true — mult * acc +
// qoff in f64, rounded once to f32, then + voff: the value of the JAX
// package's compiled code, which fuses that multiply-add (ROADMAP F24; K12,
// and residual BQ, whose qoff is the query's qb and whose voff is the
// per-row rowadd that poisons pad slots). voff is never null: a null check
// in the epilogue slowed K2 too. Every search then adds the optional
// residual-IVF corr of the row's 512-row block (ktile.cuh ScanMap), rounded
// once more, before it selects.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ktile.cuh"

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kTQ = 32;                   // queries per block: 4 per warp
constexpr int kSeg = 128;                 // corpus rows per segment: 4 per lane
constexpr int kDK = 128;                  // bytes of depth per staged chunk
constexpr int kDKP = kDK + 16;            // padded shared-memory row stride
constexpr int kStageBytes = (kSeg + kTQ) * kDKP;

struct CodeRows {
  using Elem = int8_t;
  const int8_t* codes;
  long long D;
  // cs[r][0 .. 128) = codes[row0 + r][d0 .. d0 + 128) for r < 128.
  __device__ __forceinline__ void stage(int8_t* cs, long long row0, int d0) const {
#pragma unroll
    for (int t = 0; t < kSeg * (kDK / 16) / kThreads; ++t) {
      const int idx = threadIdx.x + t * kThreads, r = idx >> 3, c = idx & 7;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          codes + (row0 + r) * D + d0 + c * 16));
      *reinterpret_cast<int4*>(cs + r * kDKP + c * 16) = v;
    }
  }
};

struct PlaneRows {
  using Elem = uint32_t;
  const uint32_t* planes;
  long long npad;
  // cs[r][32w + j] = bit j of word d0/32 + w of row row0 + r, w < 4.
  __device__ __forceinline__ void stage(int8_t* cs, long long row0, int d0) const {
    const int w0 = d0 >> 5;
#pragma unroll
    for (int t = 0; t < kSeg * (kDK / 32) / kThreads; ++t) {
      const int idx = threadIdx.x + t * kThreads, r = idx & (kSeg - 1), w = idx >> 7;
      const uint32_t v = __ldg(planes + (long long)(w0 + w) * npad + row0 + r);
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = (((v >> (4 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;
      int4* dst = reinterpret_cast<int4*>(cs + r * kDKP + w * 32);
      dst[0] = make_int4((int)b[0], (int)b[1], (int)b[2], (int)b[3]);
      dst[1] = make_int4((int)b[4], (int)b[5], (int)b[6], (int)b[7]);
    }
  }
};

struct DotOp {
  __device__ static __forceinline__ int step(int a, int b, int c) { return __dp4a(a, b, c); }
};

struct AbsDiffDotOp {
  __device__ static __forceinline__ int step(int a, int b, int c) {
    return (int)__dp4a(__vabsdiffu4((unsigned)a, (unsigned)b), 0x01010101u, (unsigned)c);
  }
};

template <bool kOnce>
__device__ __forceinline__ float epilogue(float m, int acc, float qo,
                                          const float* __restrict__ voff, long long row) {
  float s;
  if (kOnce) {
    s = __double2float_rn(__dadd_rn(__dmul_rn((double)m, (double)acc), (double)qo));
  } else {
    s = __fadd_rn(__fmul_rn(m, __int2float_rn(acc)), qo);
  }
  return __fadd_rn(s, voff[row]);
}

template <class Op>
__device__ __forceinline__ int step4(const int4& a, const int4& b, int c) {
  c = Op::step(a.x, b.x, c);
  c = Op::step(a.y, b.y, c);
  c = Op::step(a.z, b.z, c);
  return Op::step(a.w, b.w, c);
}

// acc[j][i] = Op over the depth of query q0 + 4*warp + j against segment row
// row0 + lane + 32*i. Rows row0 .. row0+127 must exist; queries >= Q read as
// zeros. qcodes is int8 [Q, D], D a multiple of 128. Every thread of the
// block must call it (it synchronises).
template <class Rows, class Op>
__device__ __forceinline__ void segment_scan(const Rows& rows,
                                             const int8_t* __restrict__ qcodes, int q0,
                                             int Q, long long row0, int D, int8_t* cs,
                                             int8_t* qs, int acc[4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  for (int d0 = 0; d0 < D; d0 += kDK) {
    __syncthreads();  // the previous chunk's readers are done
    rows.stage(cs, row0, d0);
    {
      const int r = tid >> 3, c = tid & 7, q = q0 + r;  // 32 rows x 8 vectors
      int4 v = make_int4(0, 0, 0, 0);
      if (q < Q)
        v = *reinterpret_cast<const int4*>(qcodes + (long long)q * D + d0 + c * 16);
      *reinterpret_cast<int4*>(qs + r * kDKP + c * 16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k16 = 0; k16 < kDK / 16; ++k16) {
      int4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = *reinterpret_cast<const int4*>(qs + (warp * 4 + j) * kDKP + k16 * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[i] = *reinterpret_cast<const int4*>(cs + (lane + 32 * i) * kDKP + k16 * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = step4<Op>(a[j], b[i], acc[j][i]);
    }
  }
}

// ------------------------------------------------------------ score matrix
// grid (ceil(n_valid / 128), ceil(Q / 32)); out f32 [Q, n_valid].
template <class Rows, class Op, bool kOnce>
__global__ void __launch_bounds__(kThreads) scores_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff, float* __restrict__ out,
    int Q, int n_valid, int D, int mstride) {
  __shared__ __align__(16) int8_t stage[kStageBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long row0 = (long long)blockIdx.x * kSeg;
  int acc[4][4];
  segment_scan<Rows, Op>(Rows{base, stride}, qcodes, q0, Q, row0, D, stage,
                         stage + kSeg * kDKP, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) continue;
    const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + lane + 32 * i;
      if (row < n_valid)
        out[(long long)q * n_valid + row] = epilogue<kOnce>(m, acc[j][i], qo, voff, row);
    }
  }
}

// ----------------------------------------------------------- exact search
// grid (nsplit = ceil(ncomp / split), ceil(Q / 32)). Block (s, t) scores
// compact rows [s*split, s*split + split) of its 32 queries into shared
// memory as ordered keys, then each warp selects the exact top-kk of its 4
// queries among the split's valid rows (compact rows < n_valid) by a 4-pass
// radix select, and writes them, unordered, with their corpus rows, to
// cand_v / cand_i [Q, nsplit*kk] at columns s*kk .. s*kk+kk-1. Slots beyond
// the split's valid rows hold NEG / -1. A split lies in one selected tile
// (split divides tile_n), so its corpus rows are consecutive.
template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, 2) search_exact_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int ncomp, int n_valid,
    int D, int split, int kk, int mstride, ScanMap map) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* cs = smem;
  int8_t* qs = smem + kSeg * kDKP;
  unsigned* keys = reinterpret_cast<unsigned*>(smem + kStageBytes);  // [32][split]
  unsigned* hist_all = keys + kTQ * split;                           // [8][256]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long start = (long long)blockIdx.x * split;
  const long long row0 = map.row(start);

  for (int off = 0; off < split && start + off < ncomp; off += kSeg) {
    int acc[4][4];
    segment_scan<Rows, DotOp>(Rows{base, stride}, qcodes, q0, Q, row0 + off, D, cs, qs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(q0 + warp * 4 + j, Q - 1);  // rows >= Q are never read
      const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = off + lane + 32 * i;
        keys[(warp * 4 + j) * split + e] = float_to_key(
            map.add_corr(epilogue<kOnce>(m, acc[j][i], qo, voff, row0 + e), q, start + e));
      }
    }
  }
  // Each warp wrote every key of its own 4 queries: no block barrier needed.
  __syncwarp();

  const long long valid = (long long)n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < split ? valid : split));
  const long long width = (long long)gridDim.x * kk;
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blockIdx.x * kk;
    warp_select_topk(keys + (warp * 4 + j) * split, cnt, kk, row0, cand_v + o,
                     cand_i + o, hist_all + warp * 256);
  }
}

// ---------------------------------------------------------- approx search
// Pass 1, grid (ceil(ncomp / part), ceil(Q / 32)): block p keeps, for each
// of its queries and each stride class l (compact rows p*part + m*128 + l),
// the running maximum and its corpus row — strict ">" in compact order, so
// the first row wins ties, as the Pallas kernels' compares do. Compact rows
// >= n_valid score NEG. A 128-row segment lies in one selected tile.
// part_v / part_i: [Q, nparts*128]. Pass 2 is ktile.cuh's in-order combine
// per span block.
template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, 2) approx_parts_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int ncomp, int n_valid,
    int D, int part, int mstride, ScanMap map) {
  __shared__ __align__(16) int8_t stage[kStageBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kTQ;
  const long long start = (long long)blockIdx.x * part;
  float best[4][4];
  int arg[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[j][i] = -__int_as_float(0x7f800000);  // -inf: any score beats it
      arg[j][i] = -1;
    }
  for (int off = 0; off < part && start + off < ncomp; off += kSeg) {
    int acc[4][4];
    const long long seg0 = map.row(start + off);
    segment_scan<Rows, DotOp>(Rows{base, stride}, qcodes, q0, Q, seg0, D, stage,
                              stage + kSeg * kDKP, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(q0 + warp * 4 + j, Q - 1);
      const float m = mult[q * mstride], qo = qoff[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long c = start + off + lane + 32 * i, row = seg0 + lane + 32 * i;
        const float s =
            c < n_valid ? map.add_corr(epilogue<kOnce>(m, acc[j][i], qo, voff, row), q, c)
                        : kNeg;
        if (s > best[j][i]) {
          best[j][i] = s;
          arg[j][i] = (int)row;
        }
      }
    }
  }
  const long long width = (long long)gridDim.x * kSlot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + warp * 4 + j;
    if (q >= Q) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long c = (long long)q * width + (long long)blockIdx.x * kSlot + lane + 32 * i;
      part_v[c] = best[j][i];
      part_i[c] = arg[j][i];
    }
  }
}

// --------------------------------------------------------- host launches
// Both launch on `s` without synchronising and return cudaGetLastError().

template <class Rows, bool kOnce>
cudaError_t launch_search_exact(const void* base, long long stride, const void* qcodes,
                                const void* qoff,
                                const void* mult, const void* voff, void* cand_v,
                                void* cand_i, int Q, int ncomp, int n_valid, int D,
                                int split, int kk, int mstride, ScanMap map,
                                cudaStream_t s) {
  const size_t smem = kStageBytes + sizeof(unsigned) * ((size_t)kTQ * split + 8 * 256);
  cudaError_t err = cudaFuncSetAttribute(search_exact_kernel<Rows, kOnce>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ncomp + split - 1) / split, (Q + kTQ - 1) / kTQ);
  search_exact_kernel<Rows, kOnce><<<grid, kThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, ncomp, n_valid, D, split,
      kk, mstride, map);
  return cudaGetLastError();
}

template <class Rows, bool kOnce>
cudaError_t launch_search_approx(const void* base, long long stride, const void* qcodes,
                                 const void* qoff,
                                 const void* mult, const void* voff, void* part_v,
                                 void* part_i, void* out_v, void* out_i, int Q, int ncomp,
                                 int n_valid, int D, int part, int span_rows, int mstride,
                                 ScanMap map, cudaStream_t s) {
  const int nparts = (ncomp + part - 1) / part;
  const dim3 grid(nparts, (Q + kTQ - 1) / kTQ);
  approx_parts_kernel<Rows, kOnce><<<grid, kThreads, 0, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, ncomp, n_valid, D, part,
      mstride, map);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_approx_combine(static_cast<const float*>(part_v),
                               static_cast<const int*>(part_i), static_cast<float*>(out_v),
                               static_cast<int*>(out_i), Q, nparts, span_rows / part, s);
}

}  // namespace
