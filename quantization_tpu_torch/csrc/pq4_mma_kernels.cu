// 4-bit PQ on the tensor cores (sm_90a): with the int8 LUT, K8, K7a, K7b
// and K11 as one-hot products, K7b past kk = 64 on the int8 scan body of
// dot_scan.cuh, K8, K7a / K11 and K7b up to kk = 64 on kernels of this file
// that build the one-hot A operand in registers (pq4_scores_ws_kernel,
// pq4_approx_ws_kernel, pq4_queue_kernel); with the bf16 LUT, K8 as one-hot
// bf16 products summed on the CUDA cores in the plain version's order
// (qtt_pq4_mma_scores_bf16).
//
// Replaces, for 4-bit codes (KC = 16) and the int8 LUT, the Pallas kernels of
// quantization_tpu/ops/pallas/pq_kernel.py:
//   K8  qtt_pq4_mma_scores         <- pq_scores_pallas, int8 LUT
//                                     (_make_scores_kernel_i8, pq_kernel.py:943)
//   K7a qtt_pq4_mma_search_approx  <- pq_search_pallas(mode="approx") /
//                                     _make_pq_topk_kernel (pq_kernel.py:791)
//   K11 qtt_pq4_mma_search_approx with a tile selection <- pq_search_indexed /
//                                     _make_pq_topk_kernel_indexed (pq_kernel.py:582)
//   K7b qtt_pq4_mma_search_exact   <- pq_search_pallas(mode="exact") /
//                                     _make_pq_class_kernel (pq_kernel.py:866)
//   K8  qtt_pq4_mma_scores_bf16    <- pq_scores_pallas, bf16 LUT
//                                     (_make_scores_kernel, pq_kernel.py:962)
// Every other PQ launch (the 4-bit searches with the bf16 / bf16x2 LUTs,
// 8-bit codes) runs the LUT-gather body of pq_kernels.cuh; the wrapper
// (ops/kernels/pq_kernel.py onehot_route, bf16_onehot_route) picks the
// route.
//
// The JAX kernel computes score[q, n] = sum_c lut[q, c, :] . onehot(code[n,
// c]) on the MXU (pq_kernel.py:1-37), and so does this one, on wgmma:
//   * A (corpus rows, the M side): the one-hot bytes of the transposed codes
//     u8 [mpad, npad], 16 per chunk, expanded into shared memory by
//     NibbleRows (the radix K7b) or built in registers by OneHotI8Frag;
//   * B (queries, the N side): the int8 LUT flattened to [Q, mpad * 16], zero
//     past m (quantize_lut's entries, no transposition: the JAX package's
//     lut_flat, pq_kernel.py:932-933). The depth D = mpad * 16 is a multiple
//     of 256.
// The sum is exact: LUT entries lie in [-127, 127] and the one-hot bytes in
// {0, 1}, so the s32 accumulator equals the gather body's int32 sum to the
// bit. The epilogue is f32(f64(scale) * acc + f64(bias)), rounded once, as
// the gather body and the plain version round it (ROADMAP F14); K8 adds no
// row additive, and the searches add voff and corr in the JAX order (score +
// rowadd) + corr before they select. Without a rowadd the wrapper passes a
// row of -0.0 as voff: x + (-0.0) == x for every x under round-to-nearest,
// where a +0.0 row would turn a -0.0 score into +0.0, a different key of
// the exact select (ktile.cuh float_to_key).
//
// What bounds them on the H100, at 1M rows, m = 192 and Q = 256: the
// one-hot product is 2 * 256 * 1M * 3,072 = 1.57e12 int8 operations, 0.79 ms
// at 1,979 TOPS; K8 also writes a 1 GB score matrix (0.31 ms at 3.35 TB/s).
// K8 runs pq4_scores_ws_kernel (persistent, its stores drained under the
// products); K7a and K11
// pq4_approx_ws_kernel over parts of SPAN * tile_n rows (SPAN * TILE_N =
// 4096 dense: 32 segments), so that each part is one span block of the JAX
// geometry and no combine pass follows; K7b the exact selects by kk
// (ktile.cuh): pq4_queue_kernel up to 64, over ranges of several 512-row
// splits, two blocks a SM; above it dot_scan.cuh's radix body, each
// 512-row split selecting its top-min(k, 512). Their designs and measured
// times are at their definitions below.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "dot_scan.cuh"

namespace {

// ------------------------------------------------- K8 with the bf16 LUT
// The JAX kernel's bf16 K8 multiplies the LUT, bf16 [Q, Mpad * 16], by the
// one-hot matrix of the codes on the MXU and sums each group of 8 chunks in
// that matmul (pq_kernel.py:956-961). The port's plain version sums the
// entries of a group in pairs, the pairs in order, then adds the group to
// an f32 sum that starts at +0.0 (ROADMAP Queue 3, F19), and the LUT-gather
// body equals it to the bit. A bf16 wgmma that accumulates over chunks adds
// inside the tensor core in an order and rounding of its own, so this
// kernel gives each wgmma exactly one chunk: a k16 step is 16 bf16 deep,
// one 4-bit chunk's codes, and each product starts from a zero accumulator
// (scale-d 0). An output element then holds one product, entry x 1.0, and
// fifteen zeros: the entry itself, exactly (a product of two bf16 values is
// exact in f32, subnormals included, and adding zeros changes no nonzero
// value). The adds run on the CUDA cores with __fadd_rn, in add_group's
// order (pq_kernels.cuh): pr = v0 + v1, gs = pr; pr = v2 + v3, gs = gs + pr;
// ...; acc = acc + gs every 8 chunks.
//
// Signed zeros: a zero entry may come back as +0.0 or -0.0 (0 x a negative
// entry is -0.0, and the fifteen zero products carry the signs of their
// entries), and a chunk past m (a zero B row) or an odd m's unpaired chunk
// adds such a zero where the plain version adds nothing. Neither shows:
// x + (+-0.0) == x for every x != 0, a zero pair or group sum differs at
// most in its sign, and acc starts at +0.0 and under round-to-nearest never
// becomes -0.0 (x + y is -0.0 only when both are), so acc + (+0.0) and acc +
// (-0.0) are the same. LUT entries must be finite: an infinite bf16 entry
// (an f32 entry beyond bf16's range) times 0.0 is NaN in every row of its
// chunk, as in the JAX package's one-hot matmul.
//
// A block of 256 threads scores 128 corpus rows (M: warpgroup g rows 64g ..
// 64g+63) against 64 queries (N). The one-hot A operand never touches
// shared memory: each thread builds its fragment of a chunk's 64 x 16 A
// tile in registers from the codes of its two rows (OneHotBf16Frag), and
// the wgmma reads A from registers. Expanding the rows into shared memory
// instead, as NibbleRows does for the int8 LUT, wrote and then read back
// 24 GB at 1M rows, 64 queries a block and bf16 width: that kernel ran
// 7.16 ms, and 3.93 ms with the expansion left out (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md). Shared memory holds a ring of 4 stages, each 256
// bytes of depth (8 chunks, one group; 128-byte stages ran slower): the LUT
// block (B: the LUT rows, two 128-byte-swizzled tiles of [64][128 B],
// cp.async with zero fill for queries >= Q, as fetch_queries reads them)
// and the codes of the block's rows, filled 2 stages ahead (the wgmma of a
// stage's last chunk is still running when the next stage begins, so the
// slot it reads is refilled one stage later than dot_scan.cuh's ring
// refills).
// Three accumulator sets (96 registers) rotate so that the product of
// chunk c + 1 runs while the CUDA cores sum chunk c, with one product group
// left pending (wgmma.wait_group 1); acc, gs and the sets make 160
// registers a thread. (Four sets and wait_group 2 ran no faster: 7.22
// against 7.24 ms, with the expansion in shared memory.) A block walks
// kBfSegs segments of one query tile as one stream of stages, so the next
// segment's stages land while a segment's epilogue writes its [64
// query][128 row] f32 tile out through shared memory, whole output rows at
// a time.
//
// What bounds it on the H100, at 1M rows, m = 192, Q = 256: the one-hot
// product is 2 * 256 * 1M * 3,072 = 1.57e12 bf16 operations, 1.59 ms at
// 989.4 TFLOP/s; beside it the F19 adds, one f32 add per entry (4 pair sums,
// 3 group adds and 1 acc add per group of 8), 4.92e10 adds at 128 per clock
// per SM (1.47 ms at 1.98 GHz), on other units. The fragments' build (about
// 10 instructions a chunk and thread, against 32 adds) and the LUT's reads
// (12.6 GB from L2: every 128-row block reads its 64 queries' 393 KB) come
// on top. It runs 5.3 ms there against 16.1 on the LUT-gather body
// (NVIDIA H100 80GB HBM3, 700 W, in turns; PERF.md): the CUDA cores'
// issue binds, ~950 instructions a thread per 16 chunks of which 512 adds
// (chip_smoke.py counts them in the SASS), with one block of 8 warps per SM
// (255 registers).

constexpr int kBfTQ = 64;                        // queries per block: one n64 product
constexpr int kBfSlots = 4;                      // ring stages, a power of two
constexpr int kBfAhead = 2;                      // stages filled ahead of the products
constexpr int kBfChunks = 8;                     // PQ chunks per stage: a group, 256 bytes
constexpr int kBfStage = kBfTQ * kBfChunks * 32; // B: two [64][128 B] tiles, 1024-aligned
constexpr int kBfCodes = kBfChunks * kSeg;       // a stage's codes: [8 chunks][128 rows]
constexpr int kBfSegs = 8;                       // 128-row segments a block walks
constexpr int kBfTS = kSeg + 4;                  // the epilogue tile's row stride (f32)
constexpr int kBfSmem = kAlign + kBfSlots * (kBfStage + kBfCodes) + kBfTQ * kBfTS * 4;
static_assert(kBfSmem <= 232448, "the ring and the epilogue tile fit the SM's shared memory");

// The A fragment of one chunk, one-hot bf16: element (row r, column i) of
// the 64 x 16 A tile is 1.0 (0x3F80) where code(chunk, row r) == i, else 0.
// A thread holds rows R and R + 8 of its warp's 16 (R = lane / 4; lane % 4
// names its columns 2 (lane % 4) .. + 1 and + 8, wgmma_m64n64k16_bf16_rs),
// and the A tile's rows are the segment's rows in another order: tile rows
// R and R + 8 of warp w of warpgroup g are segment rows 64g + 16w + 2R and +
// 1, so one 16-bit load of a chunk's codes gives a thread both its rows.
// pair_row (dot_scan.cuh) names the segment row of an accumulator element.
struct OneHotBf16Frag {
  uint32_t src;  // offset of the thread's two codes in a stage's [8][128] codes
  uint32_t col;  // 32 (lane % 4): the thread's column pair, as a shift

  __device__ __forceinline__ OneHotBf16Frag()
      : src(((threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
             2 * ((threadIdx.x & 31) >> 2))),
        col(32 * (threadIdx.x & 3)) {}
  // The thread's codes of stage chunks k and k + 1 (k even): bytes 0, 1 its
  // first and second row's codes of chunk k, bytes 2, 3 those of chunk k +
  // 1.
  __device__ __forceinline__ uint32_t load(const uint8_t* codes, int k) const {
    return *reinterpret_cast<const uint16_t*>(codes + k * kSeg + src) |
           (uint32_t)*reinterpret_cast<const uint16_t*>(codes + (k + 1) * kSeg + src) << 16;
  }
  // The fragment of stage chunk k from load's word of its pair: a code x
  // puts 0x3F80 << 16 (x & 1) in the register of its column pair x / 2, if
  // the thread holds it: 0x3F80 << 16 (x - 2 (lane % 4)) with the shift
  // clamped (shl.b32: 0 from 32 on, a negative amount being huge unsigned).
  __device__ __forceinline__ void build(uint32_t cw, int k, uint32_t (&a)[4]) const {
    const uint32_t w = cw >> (16 * (k & 1));
    const uint32_t x16 = (w << 4) & 0xF0u, y16 = (w >> 4) & 0xF0u;  // 16 x, 16 y
    a[0] = shl_clamp(0x3F80u, x16 - col);
    a[1] = shl_clamp(0x3F80u, y16 - col);
    a[2] = shl_clamp(0x3F80u, x16 - col - 128);
    a[3] = shl_clamp(0x3F80u, y16 - col - 128);
  }

 private:
  static __device__ __forceinline__ uint32_t shl_clamp(uint32_t v, uint32_t n) {
    uint32_t r;
    asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(n));
    return r;
  }
};

// The accumulator set of chunk c of a group: 0 1 2 0 1 0 2 1. A set is
// rewritten only once its chunk is summed: chunk c's while chunks c - 1
// (pending) and c - 2 (even c: waiting for its pair) hold the other two.
// The A fragments rotate with them: a chunk's stays untouched until its
// product has landed.
__host__ __device__ constexpr int bf_set(int c) {
  return c == 0 || c == 3 || c == 5 ? 0 : c == 2 || c == 6 ? 2 : 1;
}

// gs = (x + y), or gs + (x + y): one pair of a group, each add rounded once.
template <bool kFirst>
__device__ __forceinline__ void pair_add(float (&gs)[32], const float (&x)[32],
                                         const float (&y)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float pr = __fadd_rn(x[e], y[e]);
    gs[e] = kFirst ? pr : __fadd_rn(gs[e], pr);
  }
}

__device__ __forceinline__ void group_done(float (&acc)[32], const float (&gs)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], gs[e]);
}

// Segment rows row0 .. row0+127 of queries q0 .. q0+63 (acc) to out [Q,
// n_valid] through the tile: warp w stores query rows w, w + 8, ..., lane l
// the rows 4l .. 4l+3. Every thread calls it; the tile is free again after
// the next barrier.
__device__ __forceinline__ void bf_epilogue(const float (&acc)[32], float* tile,
                                            float* __restrict__ out, int q0, int Q,
                                            long long row0, int n_valid) {
#pragma unroll
  for (int e = 0; e < 32; ++e) tile[frag_col(e) * kBfTS + pair_row(e)] = acc[e];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = row0 + 4 * lane;
  const bool vec = (n_valid & 3) == 0 && r + 3 < n_valid;
  for (int i = warp; i < kBfTQ; i += kThreads / 32) {
    const int q = q0 + i;
    if (q >= Q) break;
    const float4 v = *reinterpret_cast<const float4*>(tile + i * kBfTS + 4 * lane);
    float* o = out + (long long)q * n_valid + r;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r + j < n_valid) o[j] = x[j];
    }
  }
}

// grid ceil(ceil(n_valid / 128) / kBfSegs) * ceil(Q / 64), a segment run's
// query tiles neighbours in launch order. lut: bf16 [Q, mpad * 16] as bytes;
// out f32 [Q, n_valid].
__global__ void __launch_bounds__(kThreads, 1)
    pq4_bf16_scores_kernel(const uint8_t* __restrict__ codes_t, long long npad,
                           const int8_t* __restrict__ lut, float* __restrict__ out, int Q,
                           int n_valid, int mpad) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(smem);
  uint8_t* codes_s = smem + kBfSlots * kBfStage;  // [slot][4 chunks][128 rows]
  float* tile = reinterpret_cast<float*>(codes_s + kBfSlots * kBfCodes);
  const int tid = threadIdx.x;
  const int nqt = (Q + kBfTQ - 1) / kBfTQ, nseg = (n_valid + kSeg - 1) / kSeg;
  const int q0 = (blockIdx.x % nqt) * kBfTQ, seg0 = (blockIdx.x / nqt) * kBfSegs;
  const int nk = mpad / kBfChunks;  // stages a segment, a multiple of 2
  const int nsegs = min(kBfSegs, nseg - seg0);
  const int total = nsegs * nk;
  const OneHotBf16Frag frag;

  // A stage's LUT block: the thread's four 16-byte pieces of the two tiles
  // (64 queries x 128 bytes each), query rows tid / 8 and tid / 8 + 32,
  // zero for queries >= Q; a stage adds its depth offset, 256 bytes a
  // stage, the same for every segment.
  const long long D = (long long)mpad * 32;  // bytes of a query's LUT row
  const int8_t* lsrc[2];
  uint32_t ldst[2];
  int lbytes[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = (tid >> 3) + 32 * t, c = tid & 7, q = q0 + r;
    lsrc[t] = lut + (long long)min(q, Q - 1) * D + c * 16;
    ldst[t] = swz(r, c);
    lbytes[t] = q < Q ? 16 : 0;
  }
  long long ld = 0;
  // A stage's codes, 1024 bytes: warps 0 and 1, lane l of warp w copying 16
  // rows of the stage's chunk 4w + l / 8, from the next stage's chunk
  // block's address.
  const uint8_t* csrc = codes_t + (long long)((tid >> 3) & 7) * npad + 16 * (tid & 7);
  long long crow = (long long)seg0 * kSeg;
  int cd = 0;
  // Stage j's LUT block and codes into its slot, as one cp.async group.
  auto fetch = [&](int j) {
    const int slot = j & (kBfSlots - 1);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        cp_async16(ring + slot * kBfStage + u * kBfTQ * kDK + ldst[t], lsrc[t] + ld + u * kDK,
                   lbytes[t]);
    ld = ld + 2 * kDK == D ? 0 : ld + 2 * kDK;
    if (tid < 64)
      cp_async16(smem_addr(codes_s + slot * kBfCodes + 16 * tid),
                 csrc + (long long)kBfChunks * cd * npad + crow, 16);
    if (++cd == nk) {
      cd = 0;
      crow += kSeg;
    }
  };
#pragma unroll
  for (int j = 0; j < kBfAhead; ++j) {  // total >= 2 stages
    fetch(j);
    cp_async_commit();
  }

  float acc[32], gs[32], sv[3][32];
  uint32_t af[3][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    acc[e] = 0.0f;
    gs[e] = 0.0f;
    sv[0][e] = sv[1][e] = sv[2][e] = 0.0f;
  }
  int j = 0;  // the stage the products read
  for (int s = 0; s < nsegs; ++s) {
    // Two groups of 8 chunks (2 stages) an iteration. Chunk c's product goes
    // to set bf_set(c % 8); once it is issued, chunk c - 1's has landed, and
    // the pair (c - 2, c - 1) is summed when c - 1 is odd, a group added to
    // acc after its chunk 7. No product is pending across iterations: the
    // last pair is summed after wgmma.wait_group 0, as ptxas otherwise
    // serializes every product (C7514).
    for (int g = 0; g < nk; g += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h, ++j) {
        // Stage j's bytes have landed; the slot of stage j - 2, whose
        // products every warpgroup has finished (stage j - 1's first wait)
        // and whose codes every thread has read, takes stage j + 2.
        cp_async_wait<kBfAhead - 1>();
        fence_proxy_async();
        __syncthreads();
        if (j + kBfAhead < total) fetch(j + kBfAhead);
        cp_async_commit();
        const uint32_t st = ring + (j & (kBfSlots - 1)) * kBfStage;
        const uint8_t* codes = codes_s + (j & (kBfSlots - 1)) * kBfCodes;
        const uint64_t db = wgmma_desc(st);
        uint32_t cw = 0;
#pragma unroll
        for (int k = 0; k < kBfChunks; ++k) {
          const int c = kBfChunks * h + k;
          if (k % 2 == 0) cw = frag.load(codes, k);
          frag.build(cw, k, af[bf_set(c % 8)]);
          wgmma_fence();  // the fragment's and the CUDA cores' register accesses come first
          wgmma_m64n64k16_bf16_rs(sv[bf_set(c % 8)], af[bf_set(c % 8)],
                                  db + (uint64_t)((k >> 2) * kBfTQ * kDK >> 4) + 2 * (k & 3), 0);
          wgmma_commit();
          if (c == 0) continue;
          wgmma_wait<1>();
          const int p = (c - 1) % 8;  // the chunk that landed, in its group
          fence_acc(sv[bf_set(p)]);
          if (p % 2 == 1) {
            if (p == 1) {
              pair_add<true>(gs, sv[bf_set(0)], sv[bf_set(1)]);
            } else {
              pair_add<false>(gs, sv[bf_set(p - 1)], sv[bf_set(p)]);
            }
          }
          if (p == 7) group_done(acc, gs);
        }
      }
      wgmma_wait<0>();
      fence_acc(sv[bf_set(7)]);
      pair_add<false>(gs, sv[bf_set(6)], sv[bf_set(7)]);
      group_done(acc, gs);
    }
    bf_epilogue(acc, tile, out, q0, Q, (long long)(seg0 + s) * kSeg, n_valid);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  }
}

cudaError_t launch_bf16_scores(const void* lut, const void* codes_t, void* out, int Q, int mpad,
                               long long npad, int n_valid, cudaStream_t s) {
  if (mpad % 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pq4_bf16_scores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBfSmem);
  if (err != cudaSuccess) return err;
  const long long nseg = ((long long)n_valid + kSeg - 1) / kSeg;
  const unsigned grid =
      (unsigned)((nseg + kBfSegs - 1) / kBfSegs) * (unsigned)((Q + kBfTQ - 1) / kBfTQ);
  pq4_bf16_scores_kernel<<<grid, kThreads, kBfSmem, s>>>(
      static_cast<const uint8_t*>(codes_t), npad, static_cast<const int8_t*>(lut),
      static_cast<float*>(out), Q, n_valid, mpad);
  return cudaGetLastError();
}

// ------------------------------------- K7a / K11 and K7b with the int8 LUT
// The one-hot searches with A built in registers. The JAX kernels multiply
// the LUT by the one-hot matrix of the codes on the MXU; the int8 body of
// dot_scan.cuh did the same with the one-hot rows expanded into shared
// memory (NibbleRows), 16 bytes a code, written and read back once per
// 64-query tile: at 1M rows x 192 chunks, Q = 256, the expansion alone took
// 1.20 ms and the products alone 1.43 of approx_parts_kernel's 2.74 ms
// pass 1, every 128-row segment re-reading its queries' LUT block from L2
// (NVIDIA H100 80GB HBM3, 700 W; csrc/probe/approx_split.cu, PERF.md). Here
// each thread builds its A fragment of a k32 step (two chunks) from the
// codes of its rows (OneHotI8Frag), shared memory holds only the LUT stream
// and the raw codes, and more rows share each LUT stage: 512 in the approx
// kernel, 256 in the exact one. The sums stay exact (LUT entries in
// [-127, 127] against 0/1 bytes: any order gives the same s32), and the
// epilogue stays f32(f64(scale) * acc + f64(bias)) rounded once, + voff,
// then + corr (ROADMAP F14), so both equal their plain versions as the
// NibbleRows bodies did.
//
// Geometry: the LUT block a stage is the block's 64 queries x 256 bytes of
// depth (16 chunks, 8 k32 steps): two [64][128 B] tiles in the 128-byte
// swizzle the wgmma descriptors name, zero for queries >= Q; beside it the
// raw codes of the stage's rows, 16 chunks of each, as codes_t holds them
// ([chunk][row]). 64 queries a block,
// because a consumer thread holds (rows / 128) x 32 accumulators and (as
// each m64 block shares its classes across segments) 32 maxima: four m64
// blocks at 64 queries are 128 accumulators, at 128 queries they would be
// 256. The A fragment's build is the same per k32 step whatever the query
// width, and the LUT's L2 reads fall with the rows a stage: N Q 3,072 / 512
// = 1.6 GB a 1M-row search at 512 rows a stage against 6.3 GB at 128.

// The one-hot A fragment of one k32 step (chunks c and c + 1) of a warp's 16
// rows, int8: byte (tile row R, column i) is 1 where code(chunk c + i / 16,
// row) == i % 16, else 0. A thread's four registers are (row R, chunk c),
// (row R + 8, chunk c), (row R, chunk c + 1) and (row R + 8, chunk c + 1),
// columns 4 (lane % 4) .. + 3 of each chunk (wgmma_m64n64k32_rs): the
// register of code x is 1 << (8 x - 32 (lane % 4)), zero where that is not
// in [0, 24] (shl.b32 gives 0 from 32 on, and a negative amount, taken mod
// 256 below, is at least 160). Tile rows R and R + 8 are rows 2R and 2R + 1
// of the warp's 16 (pair_row), so one 16-bit load gives a chunk's two codes.
struct OneHotI8Frag {
  uint32_t src;   // the thread's first row within its warpgroup's 64: 16 w + 2 (lane / 4)
  uint32_t bias;  // each byte 128 - 32 (lane % 4)
  __device__ __forceinline__ OneHotI8Frag()
      : src(((threadIdx.x >> 5) & 3) * 16 + 2 * ((threadIdx.x & 31) >> 2)),
        bias((0x80u - 32u * (threadIdx.x & 3)) * 0x01010101u) {}
  // The thread's codes of chunks c and c + 1, rows R and R + 8 (bytes 0 ..
  // 3 in register order), from rows of a warpgroup's 64 codes each chunk,
  // cstride bytes apart.
  __device__ __forceinline__ uint32_t load(const uint8_t* codes, int c, int cstride) const {
    return *reinterpret_cast<const uint16_t*>(codes + c * cstride + src) |
           (uint32_t)*reinterpret_cast<const uint16_t*>(codes + (c + 1) * cstride + src) << 16;
  }
  // The four registers from load's word: each byte of v is (8 x - 32 (lane %
  // 4)) mod 256, formed for all four codes at once (8 x + 128 - 32 (lane %
  // 4) lies in [32, 248], so no byte carries), then one shift a register.
  __device__ __forceinline__ void build(uint32_t cw, uint32_t (&a)[4]) const {
    const uint32_t v = ((cw & 0x0F0F0F0Fu) * 8u + bias) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t n = __byte_perm(v, 0u, 0x4440u | i);  // byte i, zero-extended
      asm("shl.b32 %0, %1, %2;" : "=r"(a[i]) : "r"(1u), "r"(n));
    }
  }
};

constexpr int kOhTQ = 64;                // the exact kernel's queries a block
constexpr int kOhKS = 256;               // depth a stage: 16 chunks, 8 k32 steps
constexpr int kOhSteps = kOhKS / 32;
constexpr int kOhLut = kOhTQ * kOhKS;    // the exact kernel's LUT block: two [64][128 B] tiles
constexpr int kOhBox = kOhKS / 16 * 64;  // a code box: [16 chunks][64 rows]
constexpr int kOhLag = 2;                // stages warpgroup 1 runs behind warpgroup 0, at most

// pq4_approx_ws_kernel's geometry: TQ queries a block (one m64nTQk32
// product a row block), NB m64 blocks a consumer warpgroup (a unit: NB
// segments, so 2 NB 64-row blocks share a LUT stage), and the shared
// memory from the 1024-aligned base: S ring stages (the LUT block, two
// tiles of [TQ][128 B], then 2 NB code boxes), the maxima f32 [TQ / 2][256
// threads], their segments [TQ / 8][256][4 B], qm / qo f64 [TQ], each
// consumer warpgroup's corr of its unit f32 [2][TQ], the barriers; S as
// many as fit, at most kWsMaxStages.
template <int TQ_, int NB_>
struct OhGeom {
  static constexpr int TQ = TQ_, NB = NB_, kAcc = TQ / 2;
  static constexpr int kLut = TQ * kOhKS;
  static constexpr int kStage = kLut + 2 * NB * kOhBox;
  static constexpr int kFixed = kAcc * kThreads * 5 + 2 * TQ * 8 + 2 * TQ * 4 + kWsBarBytes;
  static constexpr int kRoom = (kWsSmem - kAlign - kFixed) / kStage;
  static constexpr int S = kRoom < kWsMaxStages ? kRoom : kWsMaxStages;
  static constexpr int kBestOff = S * kStage;
  static constexpr int kSegOff = kBestOff + kAcc * kThreads * 4;
  static constexpr int kQpOff = kSegOff + kAcc * kThreads;
  static constexpr int kCorrOff = kQpOff + 2 * TQ * 8;
  static constexpr int kBarOff = kCorrOff + 2 * TQ * 4;
  static constexpr int kSmem = kAlign + kBarOff + kWsBarBytes;
  static_assert(S >= 3 && kSmem <= kWsSmem, "three stages beside the maxima");
};

// A block's walk over its units: NB segments of its items b, b + G, ... (G
// the grid; item i = part i / nqt, query tile i % nqt, as WsWalk), in
// order; an item's last unit may hold fewer segments.
template <int TQ, int NB>
struct OhWalk {
  int nqt, nitems, part, ncomp, item, u, nu, ns;
  long long start;  // the item's first compact row
  __device__ __forceinline__ OhWalk(int Q, int ncomp_, int part_) {
    nqt = (Q + TQ - 1) / TQ;
    part = part_;
    ncomp = ncomp_;
    nitems = (ncomp + part - 1) / part * nqt;
    item = blockIdx.x;
    u = 0;
    if (item < nitems) set_item();
  }
  __device__ __forceinline__ void set_item() {
    start = (long long)(item / nqt) * part;
    const long long left = ncomp - start;
    ns = (int)(((left < part ? left : part) + kSeg - 1) / kSeg);
    nu = (ns + NB - 1) / NB;
  }
  __device__ __forceinline__ bool done() const { return item >= nitems; }
  __device__ __forceinline__ bool last() const { return u == nu - 1; }
  // The unit's first compact row; the item's number of the unit's segment h
  // (a segment of the item where below ns).
  __device__ __forceinline__ long long comp() const { return start + (long long)u * NB * kSeg; }
  __device__ __forceinline__ int seg(int h) const { return u * NB + h; }
  __device__ __forceinline__ void next() {
    if (++u == nu) {
      u = 0;
      item += gridDim.x;
      if (item < nitems) set_item();
    }
  }
};

template <int TQ>
__device__ __forceinline__ void wgmma_rs(int (&d)[TQ / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (TQ == 128) {
    wgmma_m64n128k32_rs(d, a, b, scale_d);
  } else {
    wgmma_m64n64k32_rs(d, a, b, scale_d);
  }
}

// The one-hot ring's barriers: stage s full on the producer's arrival with
// the stage's bytes, empty on each consumer warpgroup's first thread.
template <class G>
__device__ __forceinline__ void onehot_init(const WsBars& bars) {
  for (int s = 0; s < G::S; ++s) {
    mbar_init(bars.full(0, s), 1);
    mbar_init(bars.empty(0, s), 2);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// n stages a consumer warpgroup reads without products (warpgroup 1's first
// lag, warpgroup 0's last lag), so that both release every stage.
template <class G>
__device__ __forceinline__ void onehot_idle(const WsBars& bars, bool lead, int n, int& s,
                                            uint32_t& ph) {
  for (int i = 0; i < n; ++i) {
    mbar_wait(bars.full(0, s), ph);
    ws_bar_arrive_if(bars.empty(0, s), lead);
    if (++s == G::S) s = 0, ph ^= 1u;
  }
}

// The one-hot kernels' producer thread: fills the ring of G::S stages
// (full / empty mbarriers of WsBars' ring 0) with the LUT block of depth
// slice j (two boxes of [TQ queries][128 B] in the 128-byte swizzle, zero
// past Q; the slices cycle 0 .. nk - 1) and, for each consumer warpgroup, a
// box of codes [16 chunks][64 rows] at slice j of each segment of its unit
// (rows through map); warpgroup 1 walks the same units lag stages behind.
template <class G, class Walk>
__device__ __forceinline__ void onehot_produce(const WsBars& bars, uint32_t s0,
                                               const CUtensorMap* lmap, const CUtensorMap* cmap,
                                               Walk w0, int nk, int lag, int q0,
                                               const ScanMap& map) {
  constexpr int TQ = G::TQ, NB = G::NB;
  Walk w1 = w0;  // warpgroup 1's units
  int s = 0, j = 0;
  uint32_t ph = 0;
  for (int p = 0;; ++p) {
    const bool a0 = !w0.done(), a1 = p >= lag && !w1.done();
    if (!a0 && !a1) break;
    mbar_wait(bars.empty(0, s), ph ^ 1u);
    int boxes = 0;
#pragma unroll
    for (int h = 0; h < NB; ++h) boxes += (a0 && w0.seg(h) < w0.ns) + (a1 && w1.seg(h) < w1.ns);
    const uint32_t st = s0 + s * G::kStage, full = bars.full(0, s);
    mbar_expect_tx(full, G::kLut + boxes * kOhBox);
    tma_load_2d(st, lmap, j * kOhKS, q0, full);
    tma_load_2d(st + TQ * kDK, lmap, j * kOhKS + kDK, q0, full);
    // Warpgroup g's code boxes: segment h's rows 64g .. 64g + 63, chunks
    // 16 j .. 16 j + 15, at st + kLut + (NB g + h) kOhBox.
    auto codes = [&](Walk& w, int g, int js) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
        if (w.seg(h) < w.ns)
          tma_load_2d(st + G::kLut + (NB * g + h) * kOhBox, cmap,
                      (int)map.row(w.comp() + kSeg * h) + 64 * g, 16 * j, full);
      if (js == nk - 1) w.next();
    };
    if (a0) codes(w0, 0, j);
    if (a1) codes(w1, 1, j >= lag ? j - lag : j - lag + nk);
    if (++s == G::S) s = 0, ph ^= 1u;
    if (++j == nk) j = 0;
  }
}

// A consumer warpgroup's products of one unit: nk ring stages from (s, ph)
// on, against each stage's LUT block NB m64 blocks (the warpgroup's 64 rows
// of each of the unit's segments) with A built in registers. Each block's
// product is a commit group of its own, so a block's fragment is rebuilt
// for the next step while the other blocks' products run (one fragment
// set); every stage's products are waited for before the stage is
// released and the next one waited on (ptxas serializes every product,
// C7513, where products stay in flight across the barrier's wait loop).
template <class G>
__device__ __forceinline__ void onehot_unit(int (&acc)[G::NB][G::TQ / 2],
                                            uint32_t (&af)[G::NB][4], const OneHotI8Frag& frag,
                                            const WsBars& bars, uint32_t s0,
                                            const uint8_t* smem, int g, bool lead, int nk,
                                            int& s, uint32_t& ph) {
  constexpr int TQ = G::TQ, NB = G::NB;
  for (int js = 0; js < nk; ++js) {
    mbar_wait(bars.full(0, s), ph);
    const uint64_t db = wgmma_desc(s0 + s * G::kStage);
    const uint8_t* codes = smem + s * G::kStage + G::kLut + NB * g * kOhBox;
#pragma unroll
    for (int k = 0; k < kOhSteps; ++k) {
      const uint64_t b = db + (uint64_t)((k >> 2) * (TQ * kDK) >> 4) + 2 * (k & 3);
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        // Block h's product of the step before is done (NB - 1 later
        // groups may be pending): its fragment is free.
        wgmma_wait<NB - 1>();
        frag.build(frag.load(codes + h * kOhBox, 2 * k, 64), af[h]);
        wgmma_fence();  // the fragment's register writes come first
        wgmma_rs<TQ>(acc[h], af[h], b, js + k);  // scale-d 0: the unit's first step
        wgmma_commit();
      }
    }
    wgmma_wait<0>();  // the stage's products are done: it is free
    ws_bar_arrive_if(bars.empty(0, s), lead);
    if (++s == G::S) s = 0, ph ^= 1u;
  }
#pragma unroll
  for (int h = 0; h < NB; ++h) fence_acc(acc[h]);
}

// pq4_approx_ws_kernel: pass 1 of K7a (dense) and K11 (a tile selection)
// with 4-bit codes and the int8 LUT, approx_parts_kernel<NibbleRows>'s output
// to the bit: per (query, stride class) of each item of part rows (a whole
// span block: the candidates, in place), the maximum, the first row of a tie
// (strict ">" in segment order), rows >= n_valid scoring NEG. 384 threads,
// one block a SM, persistent over the items of its query tile (ws_grid):
//   * a producer thread (warpgroup 2) fills the ring of G::S stages (full /
//     empty mbarriers) by TMA: a stage is the LUT block of depth slice j
//     (two boxes of [TQ queries][128 B] in the 128-byte swizzle, zero past
//     Q; the slices cycle 0 .. nk - 1) and, for each consumer warpgroup, a
//     box of codes [16 chunks][64 rows] at slice j of each segment of its
//     unit.
//   * warpgroups 0 and 1 consume: warpgroup g takes rows 64g .. 64g + 63 of
//     each of a unit's NB segments, NB m64 blocks against the stage's LUT
//     block, so one LUT stage serves 128 NB rows. Its maxima keep the
//     classes of its rows across segments, so neither warpgroup waits for
//     the other. Warpgroup 1 walks the same units lag stages behind
//     warpgroup 0 (at most kOhLag and S - 2: a stage is refilled once both
//     have read it, so the ring must still run ahead of warpgroup 0),
//     starting each unit at slice lag: both read every stage, and the
//     epilogue of one runs under the other's products. Each block's product
//     is a commit group of its own, so a block's fragment is rebuilt for the
//     next step while the other blocks' products run (one fragment set).
//   * the producer warpgroup gives its registers to the consumers
//     (setmaxnreg: 40 and 232 a thread), whose NB TQ / 2 accumulators and 4
//     NB fragment registers would not fit the launch's 168; the maxima and
//     their segments wait in shared memory (thread-major words), read and
//     written once a unit.
//   * the epilogue reads its rows' voff from device memory, and its
//     queries' corr once a unit into shared memory, under the other
//     warpgroup's products; it walks the blocks in segment order, so each
//     block's accumulators die with it.
//   * every stage's products are waited for before the next stage's
//     barrier: ptxas serializes every product (C7513) where products stay
//     in flight across the barrier's wait loop, also where that loop runs
//     only for a stage still filling (pass 1 2.36 against 2.24 ms at 128
//     queries, NVIDIA H100 80GB HBM3, 700 W; csrc/probe/approx_split.cu).
// kScan (csrc/probe/approx_split.cu): the scan alone, each accumulator
// folded into a register in place of the epilogue (wrong results).
template <bool kScan, int TQ, int NB>
__global__ void __launch_bounds__(kWsThreads, 1) pq4_approx_ws_kernel(
    const __grid_constant__ CUtensorMap lut_map, const __grid_constant__ CUtensorMap codes_map,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ voff, float* __restrict__ part_v, int* __restrict__ part_i, int Q,
    int ncomp, int n_valid, int D, int part, ScanMap map) {
  using G = OhGeom<TQ, NB>;
  using Walk = OhWalk<TQ, NB>;
  constexpr int kAcc = G::kAcc;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(smem);
  const WsBars bars{s0 + G::kBarOff};  // full(0, s) and empty(0, s): the ring's stage s
  double* qm = reinterpret_cast<double*>(smem + G::kQpOff);
  double* qo = qm + TQ;
  const int nk = D / kOhKS;  // stages a unit
  const int lag = min(min(nk / 2, G::S - 2), kOhLag);
  const int q0 = (int)(blockIdx.x % ((Q + TQ - 1) / TQ)) * TQ;
  if (threadIdx.x == 0) onehot_init<G>(bars);
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kThreads) return;
    onehot_produce<G>(bars, s0, &lut_map, &codes_map, Walk(Q, ncomp, part), nk, lag, q0, map);
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = threadIdx.x >> 7;
  const bool lead = (threadIdx.x & 127) == 0;
  for (int i = threadIdx.x; i < TQ; i += kThreads) {
    const int q = min(q0 + i, Q - 1);
    qm[i] = scale[q];
    qo[i] = bias[q];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers' qm / qo
  const OneHotI8Frag frag;
  const int r0 = (int)frag.src;  // its rows of the warpgroup's 64: r0 (e & 2 == 0), r0 + 1
  const long long width = (long long)((ncomp + part - 1) / part) * kSlot;
  // The running maximum of element e, best[e * kThreads], and its segment
  // (0xff: none), byte e % 4 of this thread's word e / 4 (words [kAcc / 4][256
  // threads]).
  float* best = reinterpret_cast<float*>(smem + G::kBestOff) + threadIdx.x;
  uint8_t* segb = smem + G::kSegOff + 4 * threadIdx.x;
  unsigned fold = 0;
  auto reset = [&]() {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) best[e * kThreads] = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) *reinterpret_cast<unsigned*>(segb + i * 1024) = ~0u;
  };
  reset();
  int s = 0;
  uint32_t ph = 0;
  if (g == 1) onehot_idle<G>(bars, lead, lag, s, ph);  // warpgroup 1 starts lag behind
  int acc[NB][kAcc];
  uint32_t af[NB][4];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[h][e] = 0;
  }
  for (Walk w(Q, ncomp, part); !w.done(); w.next()) {
    onehot_unit<G>(acc, af, frag, bars, s0, smem, g, lead, nk, s, ph);
    if constexpr (kScan) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) fold ^= (unsigned)acc[h][e];
    } else {
      // The unit's corr of the block's queries into the warpgroup's slot
      // (its last readers, the unit before's epilogue, are done).
      float* cs = reinterpret_cast<float*>(smem + G::kCorrOff) + g * TQ;
      if (map.corr) {
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
        const float* corr = map.corr + (w.comp() >> kCorrShift) * map.corr_bs;
        for (int j = threadIdx.x & 127; j < TQ; j += 128)
          cs[j] = __ldg(corr + min(q0 + j, Q - 1) * map.corr_qs);
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
      }
      // Segment h's rows r0 and r0 + 1 of the warpgroup's 64, the segments
      // in order, so each (query, class) keeps its first maximum: elements
      // 4i .. 4i + 3 are queries j = 8i + 2 (lane % 4) and j + 1 (e & 1) at
      // rows r0 and r0 + 1 (e & 2). Each block's accumulators die with it.
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const int m = w.seg(h);
        if (m >= w.ns) break;
        const long long row = map.row(w.comp() + kSeg * h) + 64 * g + r0;
        const float v0 = __ldg(voff + row), v1 = __ldg(voff + row + 1);
        const long long c = w.comp() + kSeg * h + 64 * g + r0;
        const bool in0 = c < n_valid, in1 = c + 1 < n_valid;
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i) {
          const int j = frag_col(4 * i);
          const double m0 = qm[j], m1 = qm[j + 1], o0 = qo[j], o1 = qo[j + 1];
          const float k0 = map.corr ? cs[j] : 0.f, k1 = map.corr ? cs[j + 1] : 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = 4 * i + x;
            float sc = kNeg;
            if (x & 2 ? in1 : in0) {
              sc = __fadd_rn(affine_once(x & 1 ? m1 : m0, acc[h][e], x & 1 ? o1 : o0),
                             x & 2 ? v1 : v0);
              if (map.corr) sc = __fadd_rn(sc, x & 1 ? k1 : k0);
            }
            if (sc > best[e * kThreads]) {
              best[e * kThreads] = sc;
              segb[i * 1024 + x] = (uint8_t)m;
            }
          }
        }
      }
    }
    if (w.last()) {
      const long long item = (long long)(w.start / part) * kSlot;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int q = q0 + frag_col(e), l = 64 * g + r0 + ((e >> 1) & 1);
        if (q >= Q) continue;
        const long long o = (long long)q * width + item + l;
        if constexpr (kScan) {
          part_v[o] = __uint_as_float(fold);
        } else {
          const unsigned sm = segb[(e >> 2) * 1024 + (e & 3)];
          part_v[o] = best[e * kThreads];
          part_i[o] = sm == 0xffu ? -1 : (int)map.row(w.start + (long long)sm * kSeg + l);
        }
      }
      reset();
    }
  }
  if (g == 0) onehot_idle<G>(bars, lead, lag, s, ph);  // warpgroup 0 ends lag ahead
}

// The tensor maps of the warp-specialized one-hot kernels, made per launch:
// the int8 LUT [Q, D] in boxes of [TQ queries][128 B] in the 128-byte
// swizzle (zero past Q), the codes u8 [D / 16, npad] in boxes of [16
// chunks][64 rows].
cudaError_t onehot_maps(CUtensorMap* lut_map, CUtensorMap* codes_map, const void* lutq,
                        const void* codes_t, long long npad, int Q, int D, int TQ) {
  if (D % kOhKS || npad > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = tensor_map_2d(lut_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, lutq,
                                        (unsigned long long)D, (unsigned long long)Q,
                                        (unsigned long long)D, kDK, TQ, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  return tensor_map_2d(codes_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes_t, (unsigned long long)npad,
                       (unsigned long long)(D / 16), (unsigned long long)npad, 64, kOhKS / 16,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

// pq4_approx_ws_kernel's launch (ws_grid): part rows an item, a whole span
// block (its maxima are the candidates), whole units whose segment numbers
// fit a byte.
template <bool kScan, int TQ, int NB>
cudaError_t launch_onehot_approx_g(const void* codes_t, long long npad, const void* lutq,
                                   const void* bias, const void* scale, const void* voff,
                                   void* part_v, void* part_i, int Q, int ncomp, int n_valid,
                                   int D, int part, ScanMap map, cudaStream_t s) {
  using G = OhGeom<TQ, NB>;
  if (part % (NB * kSeg) || part / kSeg > 255) return cudaErrorInvalidValue;
  CUtensorMap lut_map, codes_map;
  cudaError_t err = onehot_maps(&lut_map, &codes_map, lutq, codes_t, npad, Q, D, TQ);
  auto* kernel = pq4_approx_ws_kernel<kScan, TQ, NB>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  unsigned grid = 0;
  if (err == cudaSuccess) err = ws_grid(Q, TQ, ncomp, part, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, G::kSmem, s>>>(
      lut_map, codes_map, static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(voff), static_cast<float*>(part_v), static_cast<int*>(part_i), Q,
      ncomp, n_valid, D, part, map);
  return cudaGetLastError();
}

// The route's geometry: 128 queries and two m64 blocks a warpgroup (256
// rows a LUT stage), or where Q <= 64 (half a 128-query tile would be zero)
// 64 queries and four blocks (512 rows a stage). At 1M rows x 192 chunks,
// Q = 256, pass 1 ran 1.62 ms at 128 queries, 2.18 at 64 with four blocks
// and 2.21 with two: a fragment built once serves twice the queries at
// n128 (NVIDIA H100 80GB HBM3, 700 W; csrc/probe/approx_split.cu).
template <bool kScan>
cudaError_t launch_onehot_approx(const void* codes_t, long long npad, const void* lutq,
                                 const void* bias, const void* scale, const void* voff,
                                 void* part_v, void* part_i, int Q, int ncomp, int n_valid, int D,
                                 int part, ScanMap map, cudaStream_t s) {
  return Q > 64 ? launch_onehot_approx_g<kScan, 128, 2>(codes_t, npad, lutq, bias, scale, voff,
                                                        part_v, part_i, Q, ncomp, n_valid, D,
                                                        part, map, s)
                : launch_onehot_approx_g<kScan, 64, 4>(codes_t, npad, lutq, bias, scale, voff,
                                                       part_v, part_i, Q, ncomp, n_valid, D, part,
                                                       map, s);
}

// ------------------------------------------------ K8 with the int8 LUT
// pq4_scores_ws_kernel: the [Q, n_valid] score matrix of 4-bit codes with
// the int8 LUT, score[q, n] = f32(f64(scale[q]) * sum_c lutq[q, c, code(n,
// c)] + f64(bias[q])) rounded once (ROADMAP F14), no row additive: the
// plain version's (pq_kernel.py pq_scores_plain) to the bit, as the sum is
// exact. It replaced scores_kernel<NibbleRows> (the K3 tile of dot_scan.cuh:
// a block a 128-row segment and 128 queries, the one-hot rows expanded into
// shared memory once a query tile, every block reading its queries' whole
// LUT from L2, its int tile stored only after the products), which ran
// 2.03-2.05 ms at 1M rows x 192 chunks, Q = 256 (its products alone 1.09,
// the expansion alone 0.71, its epilogue and stores alone 0.95), against
// the one-hot product's bound of 0.79 ms (NVIDIA H100 80GB HBM3, 700 W;
// csrc/probe/scores_split.cu, PERF.md).
//
// The walk, the ring and the products are pq4_approx_ws_kernel's: 384
// threads, one block a SM, persistent over units of NB segments of its
// query tile (OhWalk with part = NB segments: an item is one unit); a
// producer thread fills the ring of G::S stages by TMA (the LUT block of a
// depth slice, TQ queries x 256 bytes in the 128-byte swizzle, and each
// consumer warpgroup's NB code boxes); consumer warpgroup g takes rows 64g
// .. 64g + 63 of each of the unit's segments, NB m64 blocks with A built
// in registers (OneHotI8Frag: no one-hot byte is written to shared memory),
// so 128 NB rows share each LUT stage; warpgroup 1 runs up to kOhLag stages
// behind warpgroup 0, so one's epilogue runs under the other's products;
// every stage's products are waited for before the next stage's barrier
// (C7513: products in flight across the wait loop are serialized).
//
// The epilogue: with no maxima a consumer holds only its accumulators and
// fragments. Each block's scores go, 64 queries at a time, into one of the
// warpgroup's two staging tiles, which are the boxes of a tensor map over
// out ([64 queries][32 rows] f32, two a tile, in the 128-byte swizzle: a
// thread's float2 of its two rows, and a half-warp's 16 of them, fall on
// distinct banks). One thread of the warpgroup stores a tile with two TMA
// tensor stores (cp.async.bulk.tensor, which write no element past Q or
// n_valid) and, before the tile is rewritten two tiles later, waits for
// them to have read it. The stores drain while the warpgroup writes its
// other tile and while both warpgroups run the next unit's products. A tile
// covers one warpgroup's 64 rows, not a whole segment: the warpgroups run
// apart, and a shared tile would make each wait for the other. Where
// n_valid % 4 != 0 (the rows of out are not 16-byte strided, as a tensor
// map needs) the warpgroup's warps store the tile, a query row a warp at a
// time, up to n_valid. Measured against the other stores, at Q = 256 (the
// same card and call): one 256-byte bulk store a query row and thread,
// 1.4509 ms (1.4407 without waiting for the reads); each thread's float2
// stores from its registers, 1.3107; the tensor stores 1.2806.
//
// What bounds it on the H100, at 1M rows, m = 192, Q = 256: the one-hot
// product, 2 * 256 * 1M * 3,072 = 1.57e12 int8 operations, 0.79 ms at
// 1,979 TOPS; the 1 GB score matrix, 0.31 ms at 3.35 TB/s, drains under the
// products. The LUT's L2 reads fall with the rows a stage: N Q 3,072 / (128
// NB) = 3.1 GB at 256 rows a stage (TQ = 128), against 6.3 GB for the
// replaced kernel.
//
// Forms (kForm): the kernel (kOsFull); the products alone, each accumulator
// folded into a register (kOsScan); the products and the epilogue into the
// staging tiles with no store (kOsTile). The last two are timing probes
// (csrc/probe/scores_split.cu) whose results are wrong.
constexpr int kOsFull = 0, kOsScan = 1, kOsTile = 2;
constexpr int kOsBox = 64 * 128;        // a box: [64 queries][32 rows] f32, 128-byte swizzled
constexpr int kOsTileBytes = 2 * kOsBox;  // a staging tile: 64 queries x 64 rows

// A tensor store of the box at src (tensor_map_2d's layout) to element (x,
// y) of the map, in this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}
// Returns once at most one of this thread's bulk groups has not read its
// shared memory.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Byte offset of (query i, row r) in a staging tile: box r / 32, 16-byte
// piece (r % 32) / 4 of row i at piece ^ (i % 8).
__device__ __forceinline__ int os_at(int i, int r) {
  return (r >> 5) * kOsBox + i * 128 + ((((r & 31) >> 2) ^ (i & 7)) << 4) + (r & 3) * 4;
}

// pq4_scores_ws_kernel's geometry: TQ queries a block, NB m64 blocks a
// consumer warpgroup, and the shared memory from the 1024-aligned base: S
// ring stages (OhGeom's stage), the four staging tiles (warpgroup g's tile b at
// (2g + b) kOsTileBytes, 1024-aligned as the swizzle needs), qm / qo f64
// [TQ], the barriers; S as many as fit, at most kWsMaxStages.
template <int TQ_, int NB_>
struct OsGeom {
  static constexpr int TQ = TQ_, NB = NB_, kAcc = TQ / 2;
  static constexpr int kLut = OhGeom<TQ, NB>::kLut, kStage = OhGeom<TQ, NB>::kStage;
  static constexpr int kFixed = 4 * kOsTileBytes + 2 * TQ * 8 + kWsBarBytes;
  static constexpr int kRoom = (kWsSmem - kAlign - kFixed) / kStage;
  static constexpr int S = kRoom < kWsMaxStages ? kRoom : kWsMaxStages;
  static constexpr int kTileOff = S * kStage;
  static constexpr int kQpOff = kTileOff + 4 * kOsTileBytes;
  static constexpr int kBarOff = kQpOff + 2 * TQ * 8;
  static constexpr int kSmem = kAlign + kBarOff + kWsBarBytes;
  static_assert(S >= 3 && kSmem <= kWsSmem && kTileOff % 1024 == 0,
                "three stages beside the staging tiles");
};

// grid: ws_grid over units of NB segments; out f32 [Q, n_valid], 16-byte
// aligned, and out_map its tensor map where n_valid % 4 == 0 (kOsScan: out
// [grid][256] words).
template <int kForm, int TQ, int NB>
__global__ void __launch_bounds__(kWsThreads, 1) pq4_scores_ws_kernel(
    const __grid_constant__ CUtensorMap lut_map, const __grid_constant__ CUtensorMap codes_map,
    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ out, int Q, int n_valid, int D) {
  using G = OsGeom<TQ, NB>;
  using Walk = OhWalk<TQ, NB>;
  constexpr int kAcc = G::kAcc, kPart = NB * kSeg;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(smem);
  const WsBars bars{s0 + G::kBarOff};  // full(0, s) and empty(0, s): the ring's stage s
  double* qm = reinterpret_cast<double*>(smem + G::kQpOff);
  double* qo = qm + TQ;
  const int nk = D / kOhKS;  // stages a unit
  const int lag = min(min(nk / 2, G::S - 2), kOhLag);
  const int q0 = (int)(blockIdx.x % ((Q + TQ - 1) / TQ)) * TQ;
  if (threadIdx.x == 0) onehot_init<G>(bars);
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kThreads) return;
    onehot_produce<G>(bars, s0, &lut_map, &codes_map, Walk(Q, n_valid, kPart), nk, lag, q0,
                      ScanMap{});
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const bool lead = wt == 0;  // arrives on the ring's barriers, issues the tensor stores
  for (int i = threadIdx.x; i < TQ; i += kThreads) {
    const int q = min(q0 + i, Q - 1);
    qm[i] = scale[q];
    qo[i] = bias[q];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers' qm / qo
  const OneHotI8Frag frag;
  const int r0 = (int)frag.src;  // its rows of the warpgroup's 64: r0 (e & 2 == 0), r0 + 1
  uint8_t* tiles = smem + G::kTileOff + 2 * g * kOsTileBytes;
  const bool tma = (n_valid & 3) == 0;
  int tb = 0;  // the tile the next 64 queries go to
  unsigned fold = 0;
  int s = 0;
  uint32_t ph = 0;
  if (g == 1) onehot_idle<G>(bars, lead, lag, s, ph);  // warpgroup 1 starts lag behind
  int acc[NB][kAcc];
  uint32_t af[NB][4];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[h][e] = 0;
  }
  for (Walk w(Q, n_valid, kPart); !w.done(); w.next()) {
    onehot_unit<G>(acc, af, frag, bars, s0, smem, g, lead, nk, s, ph);
    if constexpr (kForm == kOsScan) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) fold ^= (unsigned)acc[h][e];
    } else {
      // Block h's rows r0 and r0 + 1 (e & 2) of the warpgroup's 64, 64
      // queries at a time: elements 32x .. 32x + 31 are queries 64x + j, j =
      // 8i + 2 (lane % 4) + (e & 1), i < 8.
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const long long row = w.comp() + kSeg * h + 64 * g;  // the block's first row
        if (w.seg(h) >= w.ns || row >= n_valid) break;
#pragma unroll
        for (int x = 0; x < TQ / 64; ++x) {
          const int hq0 = q0 + 64 * x;
          if (hq0 >= Q) break;
          uint8_t* tile = tiles + tb * kOsTileBytes;
          // The tile's stores of two tiles ago have read it.
          if (kForm == kOsFull && tma && lead) bulk_wait_read1();
          asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");  // the tile is free
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = 32 * x + 4 * i, j = frag_col(e), jj = j - 64 * x;
            const double m0 = qm[j], m1 = qm[j + 1], o0 = qo[j], o1 = qo[j + 1];
            *reinterpret_cast<float2*>(tile + os_at(jj, r0)) = make_float2(
                affine_once(m0, acc[h][e], o0), affine_once(m0, acc[h][e + 2], o0));
            *reinterpret_cast<float2*>(tile + os_at(jj + 1, r0)) = make_float2(
                affine_once(m1, acc[h][e + 1], o1), affine_once(m1, acc[h][e + 3], o1));
          }
          if (kForm == kOsFull && tma) fence_proxy_async();  // seen by the tensor stores
          asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
          if constexpr (kForm == kOsFull) {
            if (tma) {
              if (lead) {
                tma_store_2d(&out_map, smem_addr(tile), (int)row, hq0);
                if (row + 32 < n_valid)
                  tma_store_2d(&out_map, smem_addr(tile + kOsBox), (int)row + 32, hq0);
                bulk_commit();
              }
            } else {
              const int cnt = (int)min(64LL, (long long)n_valid - row);  // its valid rows
              const int lane = wt & 31;
              for (int i = wt >> 5; i < 64 && hq0 + i < Q; i += 4) {
                float* o = out + (long long)(hq0 + i) * n_valid + row;
                for (int c = lane; c < cnt; c += 32)
                  o[c] = *reinterpret_cast<const float*>(tile + os_at(i, c));
              }
            }
          }
          tb ^= 1;
        }
      }
    }
  }
  if (g == 0) onehot_idle<G>(bars, lead, lag, s, ph);  // warpgroup 0 ends lag ahead
  if constexpr (kForm == kOsFull) {
    if (tma && lead) bulk_wait();  // the stores are done before the block's memory goes
  } else if constexpr (kForm == kOsScan) {
    out[(long long)blockIdx.x * kThreads + threadIdx.x] = __uint_as_float(fold);
  }
}

// pq4_scores_ws_kernel's launch (ws_grid over units of NB segments); out's
// tensor map (boxes of [64 queries][32 rows]) where n_valid % 4 == 0.
template <int kForm, int TQ, int NB>
cudaError_t launch_onehot_scores_g(const void* codes_t, long long npad, const void* lutq,
                                   const void* bias, const void* scale, void* out, int Q,
                                   int n_valid, int D, cudaStream_t s) {
  using G = OsGeom<TQ, NB>;
  CUtensorMap lut_map, codes_map, out_map{};
  cudaError_t err = onehot_maps(&lut_map, &codes_map, lutq, codes_t, npad, Q, D, TQ);
  if (err == cudaSuccess && kForm == kOsFull && n_valid % 4 == 0)
    err = tensor_map_2d(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out,
                        (unsigned long long)n_valid, (unsigned long long)Q,
                        (unsigned long long)n_valid * 4, 32, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  auto* kernel = pq4_scores_ws_kernel<kForm, TQ, NB>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  unsigned grid = 0;
  if (err == cudaSuccess) err = ws_grid(Q, TQ, n_valid, NB * kSeg, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, G::kSmem, s>>>(lut_map, codes_map, out_map,
                                            static_cast<const float*>(bias),
                                            static_cast<const float*>(scale),
                                            static_cast<float*>(out), Q, n_valid, D);
  return cudaGetLastError();
}

// The geometry by Q, as launch_onehot_approx picks it: 128 queries and two
// m64 blocks a warpgroup (256 rows a LUT stage), or where Q <= 64 64 queries
// and four blocks (512 rows a stage). At 1M rows x 192 chunks, Q = 32, the
// kernel ran 0.4671 ms at 64 x 4 against 0.5779 at 128 x 2 (NVIDIA H100
// 80GB HBM3, 700 W; csrc/probe/scores_split.cu).
template <int kForm>
cudaError_t launch_onehot_scores(const void* codes_t, long long npad, const void* lutq,
                                 const void* bias, const void* scale, void* out, int Q,
                                 int n_valid, int D, cudaStream_t s) {
  return Q > 64 ? launch_onehot_scores_g<kForm, 128, 2>(codes_t, npad, lutq, bias, scale, out, Q,
                                                        n_valid, D, s)
                : launch_onehot_scores_g<kForm, 64, 4>(codes_t, npad, lutq, bias, scale, out, Q,
                                                       n_valid, D, s);
}

// pq4_queue_kernel: K7b with 4-bit codes and the int8 LUT on the queue
// select (kk <= 64), search_queue_kernel<NibbleRows>'s output (ktile.cuh
// QueueSelect; candidates [Q, nblk * kk]): grid nblk * ceil(Q / 64), block
// (b, t) walking its range of whole 512-row splits (ktile.py
// exact_geometry; two blocks a SM) two segments at a time. A pass's
// products: a ring of three stages (cp.async groups, one stage ahead), each
// the LUT block of a depth slice and the two segments' codes, so 256 rows
// share a LUT stage; warpgroup g takes rows 64g .. 64g + 63 of both
// segments (two m64 blocks, A from registers as in pq4_approx_ws_kernel,
// each block's product a commit group of its own).
// Then each segment's keys, in row order, pass through the ring's memory
// into the queues (queue_segment, pair_row's rows). kScan
// (csrc/probe/select_split.cu): the scan alone, each key folded into a
// register in place of the select (wrong results).
constexpr int kOxSegs = 2;                             // segments a pass
constexpr int kOxCodes = kOhKS / 16 * kOxSegs * kSeg;  // a stage's codes: [16][2][128]
constexpr int kOxStage = kOhLut + kOxCodes;            // 20 KB
constexpr int kOxS = 3;                                // ring stages
constexpr int kOxRing = kOxS * kOxStage;
static_assert(kOxRing >= kOhTQ * kKeyStride * 4, "the select's key tile in the ring");

template <bool kScan>
__global__ void __launch_bounds__(kThreads, 2) pq4_queue_kernel(
    const uint8_t* __restrict__ codes_t, long long npad, const int8_t* __restrict__ lut,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ voff, float* __restrict__ cand_v, int* __restrict__ cand_i, int Q,
    int ncomp, int n_valid, int D, int split, int kk, ScanMap map) {
  constexpr int TQ = kOhTQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(smem);
  double* qm = reinterpret_cast<double*>(smem + kOxRing);
  double* qo = qm + TQ;
  QueueSelect<TQ> qs;
  qs.init(reinterpret_cast<uint8_t*>(qo + TQ), smem, kk);
  const int tid = threadIdx.x, g = tid >> 7;
  const int nqt = (Q + TQ - 1) / TQ, nblk = (ncomp + split - 1) / split;
  const int blk = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)blk * split;
  const long long end = min(min((long long)ncomp, (long long)n_valid), start + split);
  load_qparams<TQ>(qm, qo, scale, bias, q0, Q, 1);
  const int nk = D / kOhKS;
  const OneHotI8Frag frag;
  // Stage j of the pass at compact rows p0 into ring slot `slot`: the LUT
  // block of slice j (four pieces a thread) and the two segments' codes of
  // chunks 16 j .. 16 j + 15 (one piece a thread).
  auto fetch = [&](int slot, long long p0, int j) {
    const uint32_t st = ring + slot * kOxStage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i, r = idx >> 4, t = (idx >> 3) & 1, pc = idx & 7;
      const int q = q0 + r;
      cp_async16(st + t * (TQ * kDK) + swz(r, pc),
                 lut + (long long)min(q, Q - 1) * D + j * kOhKS + t * kDK + pc * 16,
                 q < Q ? 16 : 0);
    }
    const int chunk = tid >> 4, h = (tid >> 3) & 1, pc = tid & 7;
    cp_async16(st + kOhLut + chunk * (kOxSegs * kSeg) + h * kSeg + 16 * pc,
               codes_t + (long long)(j * 16 + chunk) * npad + map.row(p0 + kSeg * h) + 16 * pc,
               16);
  };
  int acc[kOxSegs][32];
  uint32_t af[kOxSegs][4];
#pragma unroll
  for (int h = 0; h < kOxSegs; ++h) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0;
  }
  unsigned fold = 0;
  // A pass's rows lie below npad: p0 is a multiple of 256 below end <= npad,
  // a multiple of 1024.
  for (long long p0 = start; p0 < end; p0 += kOxSegs * kSeg) {
    __syncthreads();  // the ring's last readers (the select's key tile) are done
    fetch(0, p0, 0);
    cp_async_commit();
    for (int js = 0; js < nk; ++js) {
      cp_async_wait<0>();  // this thread's copies of stage js landed
      fence_proxy_async();
      __syncthreads();  // everyone's, and the products of stage js - 2 are done
      if (js + 1 < nk) fetch((js + 1) % kOxS, p0, js + 1);
      cp_async_commit();
      const int slot = js % kOxS;
      const uint64_t db = wgmma_desc(ring + slot * kOxStage);
      const uint8_t* codes = smem + slot * kOxStage + kOhLut + 64 * g;
#pragma unroll
      for (int k = 0; k < kOhSteps; ++k) {
        const uint64_t b = db + (uint64_t)((k >> 2) * (TQ * kDK) >> 4) + 2 * (k & 3);
#pragma unroll
        for (int h = 0; h < kOxSegs; ++h) {
          wgmma_wait<kOxSegs - 1>();  // block h's product a step before: its fragment is free
          frag.build(frag.load(codes + kSeg * h, 2 * k, kOxSegs * kSeg), af[h]);
          wgmma_fence();
          wgmma_m64n64k32_rs(acc[h], af[h], b, js + k);
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kOxSegs; ++h) fence_acc(acc[h]);
#pragma unroll
    for (int h = 0; h < kOxSegs; ++h) {
      const long long off = p0 + kSeg * h;
      if (off >= end) break;
      unsigned key[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = frag_col(e), r = pair_row(e);
        key[e] = off + r < end ? float_to_key(map.add_corr(
                                     epilogue_q<true>(qm[j], acc[h][e], qo[j], voff, off + r),
                                     min(q0 + j, Q - 1), off + r))
                               : 0u;
      }
      if constexpr (kScan) {
#pragma unroll
        for (int e = 0; e < 32; ++e) fold ^= key[e];
      } else {
        queue_segment<TQ, 32, true>(qs, key, off, min(TQ, Q - q0));
      }
    }
  }
  __syncthreads();  // the queues, also where the block had no valid row
  if constexpr (kScan) {
    reinterpret_cast<unsigned*>(cand_v)[(long long)blockIdx.x * kThreads + tid] = fold;
    return;
  }
  const long long width = (long long)nblk * kk;
  for (int j = tid >> 5; j < TQ; j += kThreads / 32) {
    const int q = q0 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blk * kk;
    qs.write(j, cand_v + o, cand_i + o, map);
  }
}

// pq4_queue_kernel's launch: split a multiple of 512 (ktile.py
// exact_geometry's queue ranges), kk <= 64.
template <bool kScan>
cudaError_t launch_onehot_queue(const void* codes_t, long long npad, const void* lutq,
                                const void* bias, const void* scale, const void* voff,
                                void* cand_v, void* cand_i, int Q, int ncomp, int n_valid, int D,
                                int split, int kk, ScanMap map, cudaStream_t s) {
  if (split % (kOxSegs * kSeg) || kk < 1 || kk > kQueueK || D % kOhKS)
    return cudaErrorInvalidValue;
  const size_t smem =
      kAlign + kOxRing + 2 * kOhTQ * sizeof(double) + QueueSelect<kOhTQ>::bytes(kk);
  const cudaError_t err = queue_smem(pq4_queue_kernel<kScan>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      (unsigned)((ncomp + split - 1) / split) * (unsigned)((Q + kOhTQ - 1) / kOhTQ);
  pq4_queue_kernel<kScan><<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(codes_t), npad, static_cast<const int8_t*>(lutq),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(voff), static_cast<float*>(cand_v), static_cast<int*>(cand_i),
      Q, ncomp, n_valid, D, split, kk, map);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C interface
// Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Shapes are checked by the Python
// wrapper: lutq int8 [Q, mpad * 16], scale / bias f32 [Q], codes_t u8
// [mpad, npad] (mpad % 16 == 0, npad % 1024 == 0), 16-byte-aligned
// contiguous tensors. The searches take voff f32 [npad] (rowadd, or a row
// of -0.0) and corr (null for none; corr_qs, corr_bs: ktile.cuh ScanMap).
// The approx search also takes a tile selection sel [ncomp / tile_n] (null:
// dense, ncomp = npad) and writes out_v / out_i [Q, ceil(ncomp / part) *
// 128]; the exact search writes cand_v / cand_i [Q, ceil(npad / split) *
// kk], split the rows of a block (ktile.py exact_geometry). The
// bf16 K8 takes the bf16 LUT [Q, mpad * 16] (zero past m) and no scale,
// bias or voff.

extern "C" {

int qtt_pq4_mma_scores(const void* lutq, const void* scale, const void* bias,
                       const void* codes_t, void* out, int Q, int mpad, long long npad,
                       int n_valid, void* stream) {
  return static_cast<int>(launch_onehot_scores<kOsFull>(codes_t, npad, lutq, bias, scale, out, Q,
                                                        n_valid, mpad * 16,
                                                        static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_approx(const void* lutq, const void* scale, const void* bias,
                              const void* codes_t, const void* voff, void* out_v,
                              void* out_i, int Q, int mpad, long long npad, int n_valid,
                              int part, const void* sel, int tile_n, long long ncomp,
                              const void* corr, long long corr_qs, long long corr_bs,
                              void* stream) {
  return static_cast<int>(launch_onehot_approx<false>(
      codes_t, npad, lutq, bias, scale, voff, out_v, out_i, Q, (int)ncomp, n_valid, mpad * 16,
      part, scan_map(sel, tile_n, corr, corr_qs, corr_bs), static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_exact(const void* lutq, const void* scale, const void* bias,
                             const void* codes_t, const void* voff, void* cand_v,
                             void* cand_i, int Q, int mpad, long long npad, int n_valid,
                             int split, int kk, const void* corr, long long corr_qs,
                             long long corr_bs, void* stream) {
  const ScanMap map = scan_map(nullptr, 0, corr, corr_qs, corr_bs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk <= kQueueK)
    return static_cast<int>(launch_onehot_queue<false>(codes_t, npad, lutq, bias, scale, voff,
                                                       cand_v, cand_i, Q, (int)npad, n_valid,
                                                       mpad * 16, split, kk, map, s));
  return static_cast<int>(launch_search_radix<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, cand_v, cand_i, Q, (int)npad, n_valid, mpad * 16,
      split, kk, 1, map, s));
}

int qtt_pq4_mma_scores_bf16(const void* lut, const void* codes_t, void* out, int Q, int mpad,
                            long long npad, int n_valid, void* stream) {
  return static_cast<int>(launch_bf16_scores(lut, codes_t, out, Q, mpad, npad, n_valid,
                                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
