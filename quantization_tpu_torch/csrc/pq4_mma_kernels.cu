// 4-bit PQ on the tensor cores (sm_90a): with the int8 LUT, K8, K7a, K7b
// and K11 as one-hot products on the int8 scan body of dot_scan.cuh; with
// the bf16 LUT, K8 as one-hot bf16 products summed on the CUDA cores in the
// plain version's order (qtt_pq4_mma_scores_bf16, at the end of this file).
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
//   * A (corpus rows, the M side): NibbleRows expands the transposed codes
//     u8 [mpad, npad] to 16 one-hot bytes per chunk, one swizzle piece each;
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
// at 1,979 TOPS; K8 also writes a 1 GB score matrix (0.30 ms at 3.35 TB/s).
// The body's tiles and its measured rate are in dot_scan.cuh's header. K8
// runs the K3 tile (128 queries a block, the int32 tile staged through
// shared memory for coalesced row stores); K7a and K11 the approx tile over
// parts of SPAN * tile_n rows (SPAN * TILE_N = 4096 dense: 32 segments), so
// that each part is one span block of the JAX geometry and no combine pass
// follows; K7b the exact tile with its two selects by kk (ktile.cuh): the
// queue up to 64, over ranges of several 512-row splits, two blocks a SM;
// above it each 512-row split radix-selecting its top-min(k, 512).

#include <cuda_runtime.h>
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
// bf_row names the segment row of an accumulator element.
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

// The segment row of accumulator element e (frag_row's tile row, in the
// A tile's order of OneHotBf16Frag).
__device__ __forceinline__ int bf_row(int e) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + 2 * ((t & 31) >> 2) + ((e >> 1) & 1);
}

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
  for (int e = 0; e < 32; ++e) tile[frag_col(e) * kBfTS + bf_row(e)] = acc[e];
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
  return static_cast<int>(launch_mma_scores<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, nullptr, out, Q, n_valid, mpad * 16, 1,
      static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_approx(const void* lutq, const void* scale, const void* bias,
                              const void* codes_t, const void* voff, void* out_v,
                              void* out_i, int Q, int mpad, long long npad, int n_valid,
                              int part, const void* sel, int tile_n, long long ncomp,
                              const void* corr, long long corr_qs, long long corr_bs,
                              void* stream) {
  return static_cast<int>(launch_search_approx<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, out_v, out_i, out_v, out_i, Q, (int)ncomp,
      n_valid, mpad * 16, part, part, 1, scan_map(sel, tile_n, corr, corr_qs, corr_bs),
      static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_search_exact(const void* lutq, const void* scale, const void* bias,
                             const void* codes_t, const void* voff, void* cand_v,
                             void* cand_i, int Q, int mpad, long long npad, int n_valid,
                             int split, int kk, const void* corr, long long corr_qs,
                             long long corr_bs, void* stream) {
  return static_cast<int>(launch_search_exact<NibbleRows, true>(
      codes_t, npad, lutq, bias, scale, voff, cand_v, cand_i, Q, (int)npad, n_valid,
      mpad * 16, split, kk, 1, scan_map(nullptr, 0, corr, corr_qs, corr_bs),
      static_cast<cudaStream_t>(stream)));
}

int qtt_pq4_mma_scores_bf16(const void* lut, const void* codes_t, void* out, int Q, int mpad,
                            long long npad, int n_valid, void* stream) {
  return static_cast<int>(launch_bf16_scores(lut, codes_t, out, Q, mpad, npad, n_valid,
                                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
