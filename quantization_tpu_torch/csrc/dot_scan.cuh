// The int8 scan body shared by sq_kernels.cu (K1-K3, K9a / K9b),
// bq_kernels.cu (K5b and the value-query forms of K5a / K10) and
// pq4_mma_kernels.cu (K7b above the queue select, with 4-bit codes and the
// int8 LUT, as one-hot products; K8, K7a / K11 and the queue K7b run that
// file's kernels with the one-hot A operand built in registers, on this
// file's walk, barriers, tensor maps and bulk stores), on the tensor cores:
// wgmma.mma_async m64n64k32 s32.s8.s8, both operands K-major in shared
// memory (mma_segment). The BQ
// sign-query kernels of bq_kernels.cu (K6, K5c, and K5a / K10 past their
// warp-specialized body's fit) run the same body with the single-bit
// product m64nNk256 b1.b1.and.popc (N = 64, or 32 for K5c's 32-query tile)
// on plane words stored as they are (BitRows); K5a / K10 with sign queries
// run bq_kernels.cu's bq_sign_approx_ws_kernel, on this file's walk
// (WsWalk, WsBars, ws_fetch_queries, ws_grid) with A from registers. K12 (L1)
// keeps a __dp4a body of its own in sq_kernels.cu: the tensor cores have no
// absolute-difference product, and L1's one tensor-core form, thermometer
// codes through the b1 product, needs more time than the __vabsdiffu4 +
// __dp4a pairs (sq_kernels.cu gives both floors). Every other PQ launch (the
// bf16 / bf16x2 LUTs, 8-bit codes) runs the LUT-gather body of pq_kernels.cuh, but
// K8 with 4-bit codes and the bf16 LUT, a kernel of its own in
// pq4_mma_kernels.cu that uses this file's swizzle, cp.async and descriptor
// helpers and its bf16 wgmma wrapper (A from registers).
//
// A block of 256 threads (two warpgroups) scores one 128-row corpus segment
// against a tile of TQ queries: corpus rows are the M side (warpgroup g owns
// segment rows 64g .. 64g+63), queries the N side, one n64 product per 64
// queries of the tile. The depth streams through a ring of S = 3 chunks of
// 128 bytes, each [rows][128 B] in the 128-byte swizzle the wgmma
// descriptors name (16-byte piece c of row r at piece c ^ (r % 8); 8-row
// groups 1024 bytes apart), filled two chunks ahead of the products:
//   * CodeRows: SQ-u8 codes int8 [N, D] row-major, 16-byte cp.async.cg.
//   * PlaneRows: BQ bit planes u32 [W8, npad] (word w of row n at
//     planes[w * npad + n], bit j of word w = dim 32w + j, LSB first, as
//     ops/bq.py packs them). A thread loads one word of one row a chunk
//     early (a warp reads 32 neighbouring rows, one 128-byte line) and,
//     while the products run, expands it to 32 0/1 bytes, one nibble at a
//     time ((nibble * 0x00204081) & 0x01010101 moves bit i of the nibble to
//     byte i), straight into the swizzled tile. The residual-BQ score is
//     then the SQ dot of an int8 value query against 0/1 "codes", so K5b
//     and the value forms of K5a / K10 are the K1 / K2 / K9a bodies with
//     this row loader, expanding once per 64 queries.
//   * NibbleRows: 4-bit PQ codes u8 [mpad, npad], transposed, expanded to
//     16 one-hot bytes per chunk (one swizzle piece), a chunk ahead as
//     PlaneRows does; the "queries" are then the int8 LUT [Q, mpad * 16],
//     and the dot is the LUT sum of each row's codes.
//   * BitRows: the bit planes unexpanded, for the b1 product: a 128-byte
//     chunk is 32 plane words (1024 dims) of each row, and a row's depth
//     ends on a 256-bit step, not a chunk, so no product runs past it.
//   * Queries: int8 [Q, D] rows, cp.async with zero fill for rows >= Q
//     (with BitRows the query words [Q, D / 4]).
// The rows of a segment come from ScanMap::row (ktile.cuh), so the IVF tile
// lists (K9a, K9b, K10) stream in place with no tensor map. The sums are
// exact: SQ codes and queries lie in [0, 127], plane and one-hot bytes are
// 0/1 against signed int8 value queries or LUT entries in [-127, 127], so
// the s32 accumulators equal the __dp4a sums of the body this one replaced,
// and the int32 LUT sums of the gather body, to the bit. A block's query
// tiles are neighbours in launch order (a 1-D grid, the tile index
// fastest), so the tiles of one segment read its rows from device memory
// together.
//
// The accumulator fragment fixes which thread holds which (row, query):
// thread t of warpgroup g holds segment rows 64g + 16(t/32 % 4) + t%32/4
// (+ 8) against queries 8j + 2(t % 4) (+ 1), j < 8, of each 64-query half
// (frag_row / frag_col). A row of the segment is a stride class l of the
// approx geometry (compact row mod 128 within a part), so one thread holds
// each (query, class) pair for every segment of a part, and its running
// maximum with a strict ">" in segment order keeps the first row of a tie,
// as the Pallas kernels' compares do.
//
// Tiles (Tile<TQ, S, blocks per SM>; H100: 227 KB of shared memory and 64K
// registers a SM), with ptxas's counts (-Xptxas -v, printed by
// chip_smoke.py):
//   * scores_kernel, K3 (CodeRows; K8 4-bit int8 ran it on NibbleRows
//     until pq4_mma_kernels.cu's pq4_scores_ws_kernel): TQ = 128, a 96 KB
//     ring, two blocks per SM; 108 registers, no spills.
//     The [128 query][128 row] int32 tile goes through the ring's memory
//     after the scan, so whole output rows leave as coalesced (16-byte
//     where n_valid % 4 == 0) stores (store_tile), with the epilogue
//     applied there.
//   * K6, the BQ sign-query score matrix (BitRows, bq_kernels.cu): TQ =
//     128, a 64 KB ring of two chunks and a [64][132] f32 half tile after
//     it, two blocks per SM, persistent (a block walks segments with its
//     query tile); each half tile leaves by cp.async.bulk stores, one query
//     row a thread, that drain under the next half's and segment's work
//     (store_tile where n_valid % 4 != 0).
//   * approx, two bodies. approx_ws_kernel (K2, K9a, K10 / K5a value, where
//     its query tile fits: CodeRows to 1,024 bytes and PlaneRows to 768
//     bits, at Q <= 64 to 2,304 and 1,536): warp-specialized and
//     persistent, one block a SM, a
//     producer warpgroup filling each consumer warpgroup's ring on
//     mbarriers, 128 queries resident (64 where Q <= 64), work items of
//     ktile.py approx_geometry (span blocks in place; K2 at 100k x 1024
//     2048-row parts and the combine); the consumers take 224 registers
//     (setmaxnreg) and spill 236-256 bytes of loop invariants at 128
//     queries, none at 64. approx_parts_kernel (the depths past that): TQ =
//     64, a 72 KB ring, two blocks per SM,
//     121-124 registers, no spills. Both stage each segment's voff and corr
//     beside its first chunk, and keep, a thread, its running maxima and
//     their segment numbers as bytes, turned into corpus rows once an item
//     ends.
//   * exact (K1, K9b, K5b; K7b 4-bit int8 past kk = 64), two selects by kk
//     (ktile.cuh):
//     - the queue select, kk <= 64 (search_queue_kernel): TQ = 64, the 72 KB
//       ring (each segment's [64][132] u32 key tile passes through it) and
//       the queues, 64 x (8 kk + 4) bytes: two blocks per SM, each walking
//       a range of several 512-row splits; 128 registers, 36 / 40-44 / 56-76
//       bytes of spill stores / loads (CodeRows / PlaneRows / NibbleRows).
//       The owner warps' select still keeps the scan waiting: K1's scan
//       alone in this geometry takes 0.0722 ms, the kernel 0.1975
//       (csrc/probe/select_split.cu; NVIDIA H100 80GB HBM3, 700 W).
//     - the radix select, kk > 64 (search_exact_kernel): TQ = 64, the ring
//       plus the split's keys [64][split + 4] u32 (132 KB at split 512; the
//       4-word pad spreads the fragment's writes over every bank) and 8 KB
//       of histograms: one block per SM; 112 / 102 / 100 (NibbleRows)
//       registers, no spills; each warp radix-selects 8 queries.
//   * the BQ sign searches (BitRows, bq_kernels.cu): K5a / K10 past their
//     warp-specialized body's fit the approx tile, 128 registers, no spills;
//     K5c on the queue select 64 queries and a ring of two chunks, two
//     blocks a SM, 100 registers, no spills; on the radix select 32 queries
//     (n32 products) beside the [32][516] keys, two blocks a SM, 104
//     registers, no spills.
// Also measured and dropped (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py): a
// fourth ring stage with one product group left in flight across the next
// chunk's barrier, for the approx body and for K3 (no gain, PlaneRows and
// K3 slower); one chunk stream across a block's segments with the epilogue
// between chunks (approx slower); 1024-row approx parts (slower); a 32-query
// exact tile with 256-row splits at two blocks per SM (no gain); for the
// warp-specialized approx body, strict turns between its consumer
// warpgroups, a 64-query tile at any Q (K10's plane expansion then holds
// the scan: 1.0 ms against 0.61), the epilogue's loads kept in program
// order, and a 232 / 40 register split (ROADMAP "Measured and dropped").
//
// What bounds them on the H100: int8 tensor work at 1,979 TOPS against the
// corpus bytes at 3.35 TB/s; at Q = 256 the SQ scans are bound by bytes, the
// residual-BQ scans by operations. The design reads the corpus ceil(Q / TQ)
// times (2 / 4 passes at Q = 256, the later ones from L2 where the tiles run
// together). A segment's products take about 40 % of the tensor-core rate
// per chunk; the per-segment epilogue, the searches' selection (the exact
// body's queue or radix select, the approx merge's torch.topk) and K3's
// output write take the rest. The approx searches split (the probe
// csrc/probe/approx_split.cu and scan_ab.py --only approx, NVIDIA H100 80GB
// HBM3, 700 W): K9a pass 1 0.157-0.163 ms (its scan alone 0.100-0.102) and
// the merge 0.10-0.13; K10 at the serving width pass 1 0.931-0.932 ms
// (scan 0.611-0.613, the kOnce epilogue most of the rest) and the merge
// 0.28. The replaced body, a __dp4a 4 x 4 register tile over 32 queries,
// was bound by instruction issue at 3-5 % of the int8 tensor-core
// bound: K3 0.51, K2 0.64, K1 0.75 ms at 100k x 1024, Q = 256, and the
// value-query K10 1.22 ms over 262,144 x 768 rows and 5.49 ms over the
// serving plan's 1,255,424 rows, against about 0.12, 0.18, 0.52, 0.50 and
// 2.05 ms for this one (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py; PERF.md).
// 4-bit PQ with the int8 LUT, 1M rows x 192 chunks, Q = 256 (a depth of
// 3,072 one-hot bytes, bound by operations, 0.79 ms): K8 2.23 and K7a
// 3.27 ms on this body against 12.49 and 12.31 on the LUT-gather body (the
// same card, scan_ab.py).
//
// The epilogue ("kOnce"): false — (mult * acc + qoff) + voff, each step
// rounded on its own (__fmul_rn / __fadd_rn; the library is built with
// -fmad=false), as plain torch rounds it (K1-K3, K9); true — mult * acc +
// qoff in f64, rounded once to f32, then + voff: the value of the JAX
// package's compiled code, which fuses that multiply-add (ROADMAP F24; K12,
// and residual BQ, whose qoff is the query's qb and whose voff is the
// per-row rowadd that poisons pad slots; K7a 4-bit, whose voff is the
// residual rowadd or a zero row). voff is never null in the searches; the
// scores kernel's kOnce form (K8) reads none. Every search
// then adds the optional residual-IVF corr of the row's 512-row block
// (ktile.cuh ScanMap), rounded once more, before it selects.
#pragma once

#include <cuda.h>  // CUtensorMap (libcuda is not linked: tensor_map_2d)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ktile.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kSeg = 128;       // corpus rows per segment: 64 per warpgroup
constexpr int kDK = 128;        // bytes of depth per staged chunk: one swizzle row
constexpr int kKeyPad = 4;      // words after each query's keys in the exact body
constexpr int kAlign = 1024;    // the swizzle atom: ring stages start on it

// A body's tile: TQ queries (TQ / 64 products of 64, or one of TQ = 32,
// the single-bit route only), a ring of S chunks filled S - 1 chunks ahead
// of the products, and the blocks per SM its registers are held to. kN is
// a product's query width and kAcc a thread's accumulators for it.
template <int TQ_, int S_, int kBlocks_>
struct Tile {
  static constexpr int TQ = TQ_, S = S_, kBlocks = kBlocks_;
  static constexpr int kN = TQ < 64 ? TQ : 64, kH = TQ / kN, kAcc = kN / 2;
  static constexpr int kStage = (kSeg + TQ) * kDK;  // A: kSeg rows, B: TQ rows
  static constexpr int kBytes = S * kStage;
};
using ScoresTile = Tile<128, 3, 2>;
using ExactTile = Tile<64, 3, 1>;
using ApproxTile = Tile<64, 3, 2>;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kDK + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Writes of the generic proxy (st.shared, cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 bytes by cp.async (.ca: the 16-byte .cg form takes no smaller copy).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b),
               "r"(c), "r"(d)
               : "memory");
}

// K-major operand, 128-byte swizzle: the leading offset is unused (16 B),
// 8-row groups are 1024 bytes apart; each 32-byte k step adds 2 to the
// start address field.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Returns once at most N of this warpgroup's committed product groups are
// pending (groups complete in commit order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The box of a 2D tensor map (tensor_map_2d) at element (x, y) into shared
// memory at dst, completing on bar (its bytes expected there first).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Bulk stores of shared memory to device memory (the async proxy): one
// group a thread, committed and waited on by the thread that issued it
// (bq_kernels.cu's K6, pq4_mma_kernels.cu's K8 with the int8 LUT).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Returns once this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Returns once this thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 32] . B[64 x 32]^T, s8 x s8 -> s32, from shared memory.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, from shared
// memory: the m64n64k32 product over 128 queries (the accumulator fragment
// continues frag_col past 64).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d[64 x 64] += popc(A[64 x 256 bits] & B[64 x 256 bits]^T), b1 x b1 -> s32,
// from shared memory: the single-bit product (its only bit operation is
// .and). A 256-bit step is 32 bytes deep, as a k32 step of int8 is, so the
// descriptors, the swizzle and the accumulator fragment are the s8 ones.
__device__ __forceinline__ void wgmma_m64n64k256_b1(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// The same product against 32 queries (B[32 x 256 bits]): the first 16
// accumulators of the n64 fragment.
__device__ __forceinline__ void wgmma_m64n32k256_b1(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// d[64 x 64] = A[64 x 16] . B[64 x 16]^T, plus d where scale_d is not 0,
// bf16 x bf16 -> f32, A from registers, B K-major in shared memory (trans-b
// 0, scale-a and scale-b 1). A k16 step of bf16 is 32 bytes deep, as a k32
// step of int8 is, so wgmma_desc and the swizzle serve B. a[0 .. 3] is the
// thread's fragment of the 64 x 16 A tile, as mma.m16n8k16 holds it for the
// warp's 16 rows (warp w of the warpgroup rows 16w ..; lane l: a[0] row
// l/4, columns 2 (l%4) and + 1, a[1] row l/4 + 8, a[2] and a[3] the same
// rows at columns + 8), two bf16 a register, the lower column in the low
// half. The f32 fragment of d is the s32 one (frag_row, frag_col).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// d[64 x 64] = A[64 x 32] . B[64 x 32]^T, plus d where scale_d is not 0,
// s8 x s8 -> s32, A from registers, B K-major in shared memory (the
// m64n64k32 product's descriptors). a[0 .. 3] is the thread's fragment of
// the 64 x 32 A tile, as mma.m16n8k32 holds it for the warp's 16 rows (warp
// w of the warpgroup rows 16w ..; lane l: a[0] row l/4, columns 4 (l%4) ..
// + 3, a[1] row l/4 + 8, a[2] and a[3] the same rows at columns + 16), four
// bytes a register, the lower column in the low byte.
__device__ __forceinline__ void wgmma_m64n64k32_rs(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// The same product against 128 queries (B[128 x 32]): the accumulator
// fragment continues frag_col past 64, as wgmma_m64n128k32's does.
__device__ __forceinline__ void wgmma_m64n128k32_rs(int (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// Element e of a thread's 64 x 64 fragment: its segment row and its query
// within the 64-query half.
__device__ __forceinline__ int frag_row(int e) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) + ((e >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int e) {
  return (e >> 2) * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}
// The segment row of element e where the A tile's rows come in pairs (the
// one-hot fragments of pq4_mma_kernels.cu, A built in registers): tile rows
// R and R + 8 of warp w of warpgroup g are segment rows 64g + 16w + 2R and
// + 1, so one 16-bit load of a chunk's codes gives a thread both its rows.
__device__ __forceinline__ int pair_row(int e) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + 2 * ((t & 31) >> 2) + ((e >> 1) & 1);
}

// One segment of the queue select (ktile.cuh QueueSelect's protocol),
// called by every thread of the block once the segment's products are
// done: key[e] is the order key of the thread's accumulator e (0: not a
// candidate), at segment row frag_row(e) (pair_row(e) with kPairRows) and
// query frag_col(e); the segment's first compact row is row0 (rows in
// increasing order); nq the block's queries below Q.
template <int TQ, int kAcc, bool kPairRows = false>
__device__ __forceinline__ void queue_segment(QueueSelect<TQ>& qs, const unsigned (&key)[kAcc],
                                              long long row0, int nq) {
  __syncthreads();  // every warpgroup's products are done: the ring is free
#pragma unroll
  for (int e = 0; e < kAcc; ++e)
    qs.keys[frag_col(e) * kKeyStride + (kPairRows ? pair_row(e) : frag_row(e))] = key[e];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < nq; j += kThreads / 32) {
    const uint4 k4 = *reinterpret_cast<const uint4*>(qs.keys + j * kKeyStride + 4 * lane);
    const unsigned k[4] = {k4.x, k4.y, k4.z, k4.w};
    const unsigned t = qs.thr[j];
    const unsigned pass = (unsigned)(k[0] > t) | (unsigned)(k[1] > t) << 1 |
                          (unsigned)(k[2] > t) << 2 | (unsigned)(k[3] > t) << 3;
    if (__any_sync(0xffffffffu, pass != 0)) {
      const unsigned nt =
          queue_take(qs.queue + j * qs.kk, qs.keys + j * kKeyStride, k, pass, row0, qs.kk);
      if (lane == 0) qs.thr[j] = nt;
    }
  }
}

// ------------------------------------------------------------ row sources

// A row source moves chunk d0 of segment rows row0 .. row0+127 into the A
// tile at a in three steps, each a no-op for one of them: prefetch (one
// chunk ahead: global loads into registers), issue (before the chunk's
// cp.async group is committed) and put (while the products run). kBits
// names the product: int8 bytes (s8 k32) or bits (b1 k256).
struct CodeRows {
  static constexpr bool kBits = false;
  using Elem = int8_t;
  struct Pending {};
  const int8_t* codes;
  long long D;
  __device__ __forceinline__ void prefetch(Pending&, long long, int) const {}
  // A tile rows r < 128 = codes[row0 + r][d0 .. d0 + 128), by cp.async.
  __device__ __forceinline__ void issue(uint32_t a, long long row0, int d0) const {
#pragma unroll
    for (int t = 0; t < kSeg * (kDK / 16) / kThreads; ++t) {
      const int idx = threadIdx.x + t * kThreads, r = idx >> 3, c = idx & 7;
      cp_async16(a + swz(r, c), codes + (row0 + r) * D + d0 + c * 16, 16);
    }
  }
  __device__ __forceinline__ void put(uint32_t, const Pending&) const {}
};

// 4-bit PQ codes, transposed u8 [mpad, npad] (code of chunk c, row n at
// codes_t[c * npad + n], read & 15 as the gather body masks with KC - 1),
// expanded to one-hot bytes: byte 16j + i of A tile row r, depth chunk d0,
// is 1 where code(chunk d0/16 + j, row r) == i. One 16-byte swizzle piece is
// one PQ chunk. Warp w moves PQ chunk d0/16 + w: lane l loads the codes of
// rows 4l .. 4l+3 as one word a chunk early (the warp reads one 128-byte
// line) and, while the products run, writes one piece per row, row 4l + b'
// at step b with b' = (b + l/2) % 4. The 8 lanes of a quarter-warp then hold
// 8 distinct r % 8, so their 16-byte stores fall on 8 distinct swizzle
// columns, free of bank conflicts; in row order (b' = b) every quarter-warp
// would sit on two columns. Timed against PlaneRows' map (lane i row i, its
// stores as free, but four byte loads a thread) and kept: at 1M x 192
// chunks, Q = 256, K8 2.18-2.22 ms against 2.54-2.55, K7a 3.22-3.27 against
// 3.95 (NVIDIA H100 80GB HBM3, 700 W, scan_ab.py, the two maps in turns).
struct NibbleRows {
  static constexpr bool kBits = false;
  using Elem = uint8_t;
  struct Pending {
    uint32_t v;
  };
  const uint8_t* codes_t;
  long long npad;
  __device__ __forceinline__ void prefetch(Pending& p, long long row0, int d0) const {
    const long long c = (d0 >> 4) + (threadIdx.x >> 5);
    p.v = __ldg(reinterpret_cast<const uint32_t*>(codes_t + c * npad + row0) +
                (threadIdx.x & 31));
  }
  __device__ __forceinline__ void issue(uint32_t, long long, int) const {}
  // Word w of a code's piece: 1 << 8 * (code & 3) where w == code >> 2.
  __device__ __forceinline__ void put(uint32_t a, const Pending& p) const {
    const int j = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int bb = (b + (l >> 1)) & 3;
      const uint32_t code = (p.v >> (8 * bb)) & 0xFu, one = 1u << (8 * (code & 3)),
                     w = code >> 2;
      st_shared_v4(a + swz(4 * l + bb, j), w == 0 ? one : 0u, w == 1 ? one : 0u,
                   w == 2 ? one : 0u, w == 3 ? one : 0u);
    }
  }
};

struct PlaneRows {
  static constexpr bool kBits = false;
  using Elem = uint32_t;
  static constexpr int kWords = kSeg * (kDK / 32) / kThreads;  // plane words a thread moves
  struct Pending {
    uint32_t v[kWords];
  };
  const uint32_t* planes;
  long long npad;
  // The words d0/32 .. d0/32 + 3 of rows row0 .. row0+127, one chunk ahead.
  __device__ __forceinline__ void prefetch(Pending& p, long long row0, int d0) const {
    const int w0 = d0 >> 5;
#pragma unroll
    for (int t = 0; t < kWords; ++t) {
      const int idx = threadIdx.x + t * kThreads, r = idx & (kSeg - 1), w = idx >> 7;
      p.v[t] = __ldg(planes + (long long)(w0 + w) * npad + row0 + r);
    }
  }
  __device__ __forceinline__ void issue(uint32_t, long long, int) const {}
  // A tile row r, byte 32w + j = bit j of word w of row r.
  __device__ __forceinline__ void put(uint32_t a, const Pending& p) const {
#pragma unroll
    for (int t = 0; t < kWords; ++t) {
      const int idx = threadIdx.x + t * kThreads, r = idx & (kSeg - 1), w = idx >> 7;
      const uint32_t v = p.v[t];
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = (((v >> (4 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;
      st_shared_v4(a + swz(r, 2 * w), b[0], b[1], b[2], b[3]);
      st_shared_v4(a + swz(r, 2 * w + 1), b[4], b[5], b[6], b[7]);
    }
  }
};

// BQ bit planes as they are, for the single-bit product: bytes 4w .. 4w+3 of
// A tile row r, depth chunk d0 (bytes), hold plane word d0/4 + w of row r; a
// chunk is 32 words, 1024 dims. Thread t moves the 16-byte pieces c = t/128
// + 2i, i < 4, of row r = t % 128: four loads a piece, each of a warp's 32
// neighbouring rows (one 128-byte line), and one 16-byte store, so a
// quarter-warp's stores fall on 8 distinct swizzle columns. Words >= W are
// neither read nor, since the body issues no product past the depth, used.
// put also counts the row's set bits: pc[h * 128 + r] (h = t / 128) is the
// popcount of row r's words in this thread's pieces, over the segment's
// chunks so far (set at chunk 0), read after mma_segment.
struct BitRows {
  static constexpr bool kBits = true;
  using Elem = uint32_t;
  static constexpr int kPieces = kSeg * (kDK / 16) / kThreads;  // 16-byte pieces a thread
  struct Pending {
    uint32_t v[4 * kPieces];
    int d0;
  };
  const uint32_t* planes;
  long long npad;
  int W;    // words a row (the planes' W8)
  int* pc;  // shared [2][kSeg]
  __device__ __forceinline__ void prefetch(Pending& p, long long row0, int d0) const {
    const int r = threadIdx.x & (kSeg - 1), h = threadIdx.x >> 7;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int w = (d0 >> 2) + 4 * (h + 2 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p.v[4 * i + j] = w < W ? __ldg(planes + (long long)(w + j) * npad + row0 + r) : 0u;
    }
    p.d0 = d0;
  }
  __device__ __forceinline__ void issue(uint32_t, long long, int) const {}
  __device__ __forceinline__ void put(uint32_t a, const Pending& p) const {
    const int r = threadIdx.x & (kSeg - 1), h = threadIdx.x >> 7;
    int s = p.d0 == 0 ? 0 : pc[h * kSeg + r];
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const uint32_t* v = p.v + 4 * i;
      st_shared_v4(a + swz(r, h + 2 * i), v[0], v[1], v[2], v[3]);
      s += __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
    }
    pc[h * kSeg + r] = s;
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

// The kOnce epilogue with m and qo already in f64 (exact widenings of the
// f32 values), and acc widened by adding it to 2^52 + 2^31 in the low word
// of a double: one f64 add in place of a 64-bit conversion, exact for any
// int32.
__device__ __forceinline__ float affine_once(double m, int acc, double qo) {
  const double a = __hiloint2double(0x43300000, (int)((unsigned)acc ^ 0x80000000u)) -
                   4503601774854144.0;
  // m * a is exact in f64 (24 + 31 bits), so one fused multiply-add rounds
  // as the multiply then the add do.
  return __double2float_rn(__fma_rn(m, a, qo));
}

__device__ __forceinline__ float epilogue(double m, int acc, double qo,
                                          const float* __restrict__ voff, long long row) {
  return __fadd_rn(affine_once(m, acc, qo), voff[row]);
}

// A body's per-query epilogue parameters in shared memory: f32, or f64
// where the epilogue rounds once; epilogue_q picks the form.
template <bool kOnce>
struct QParam {
  using T = float;
};
template <>
struct QParam<true> {
  using T = double;
};

template <bool kOnce>
__device__ __forceinline__ float epilogue_q(typename QParam<kOnce>::T m, int acc,
                                            typename QParam<kOnce>::T qo,
                                            const float* __restrict__ voff, long long row) {
  if constexpr (kOnce) {
    return epilogue(m, acc, qo, voff, row);
  } else {
    return epilogue<false>(m, acc, qo, voff, row);
  }
}

// mult * acc + qoff as epilogue_q computes it, without the row additive.
template <bool kOnce>
__device__ __forceinline__ float affine_q(typename QParam<kOnce>::T m, int acc,
                                          typename QParam<kOnce>::T qo) {
  if constexpr (kOnce) {
    return affine_once(m, acc, qo);
  } else {
    return __fadd_rn(__fmul_rn(m, __int2float_rn(acc)), qo);
  }
}

// The 1024-aligned start of a block's dynamic shared memory (the launchers
// ask for kAlign bytes more than the layout needs).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// No copies beside a segment's first chunk (mma_segment's side).
struct NoSide {
  __device__ __forceinline__ void operator()() const {}
};

// acc[h][e] = the int8 dot over the depth of segment row frag_row(e) (corpus
// row row0 + frag_row(e)) against query q0 + 64h + frag_col(e). Rows row0 ..
// row0+127 must exist; queries >= Q read as zeros. qcodes is int8 [Q, D], D
// a multiple of 128. With a bit row source (Rows::kBits) acc is the AND
// count, qcodes the query words [Q, D / 4] and D a multiple of 32 bytes (a
// 256-bit step): the last chunk may be partial, and no product reads past
// D. Every thread of the block must call it (it synchronises); ring is the
// shared address of T::kBytes, 1024-aligned. side() issues more cp.async
// copies with the first chunk's, landed when the products start.
template <class T, class Rows, class Side = NoSide>
__device__ __forceinline__ void mma_segment(const Rows& rows,
                                            const int8_t* __restrict__ qcodes, int q0,
                                            int Q, long long row0, int D, uint32_t ring,
                                            int (&acc)[T::kH][T::kAcc],
                                            const Side& side = Side{}) {
  constexpr int TQ = T::TQ, S = T::S, kStage = T::kStage, kH = T::kH;
  const int tid = threadIdx.x;
  const int nk = Rows::kBits ? (D + kDK - 1) / kDK : D / kDK;
  const uint32_t a_off = (uint32_t)(tid >> 7) * 64 * kDK;  // this warpgroup's rows
#pragma unroll
  for (int h = 0; h < kH; ++h) {
#pragma unroll
    for (int e = 0; e < T::kAcc; ++e) acc[h][e] = 0;
    fence_acc(acc[h]);
  }

  // The queries' chunk d0 into the B tile at b: TQ rows x 8 pieces.
  auto fetch_queries = [&](uint32_t b, int d0) {
#pragma unroll
    for (int t = 0; t < TQ * (kDK / 16) / kThreads; ++t) {
      const int idx = tid + t * kThreads, r = idx >> 3, c = idx & 7, q = q0 + r;
      if constexpr (Rows::kBits) {
        const bool in = q < Q && d0 + c * 16 < D;  // pieces past D: zero, no read
        const int8_t* src = qcodes + (long long)min(q, Q - 1) * D + (in ? d0 + c * 16 : 0);
        cp_async16(b + swz(r, c), src, in ? 16 : 0);
      } else {
        cp_async16(b + swz(r, c), qcodes + (long long)min(q, Q - 1) * D + d0 + c * 16,
                   q < Q ? 16 : 0);
      }
    }
  };

  __syncthreads();  // the ring's previous readers (scan or epilogue) are done
  typename Rows::Pending p;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      const uint32_t st = ring + s * kStage;
      rows.prefetch(p, row0, s * kDK);
      rows.issue(st, row0, s * kDK);
      fetch_queries(st + kSeg * kDK, s * kDK);
      if (s == 0) side();
      rows.put(st, p);
    }
    cp_async_commit();
  }
  if (S - 1 < nk) rows.prefetch(p, row0, (S - 1) * kDK);
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<S - 2>();  // this thread's copies of chunk c landed
    fence_proxy_async();
    __syncthreads();  // everyone's, and chunk c-1's products are done
    const int nc = c + S - 1;
    const uint32_t nst = ring + (nc % S) * kStage;
    if (nc < nk) {
      rows.issue(nst, row0, nc * kDK);
      fetch_queries(nst + kSeg * kDK, nc * kDK);
    }
    cp_async_commit();
    const uint32_t st = ring + (c % S) * kStage;
    const uint64_t da = wgmma_desc(st + a_off), db = wgmma_desc(st + kSeg * kDK);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kDK / 32; ++k) {
      if constexpr (Rows::kBits) {
        if (c * kDK + 32 * k < D) {
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const uint64_t bh = db + (uint64_t)(h * 64 * kDK >> 4) + 2 * k;
            if constexpr (T::kN == 32) {
              wgmma_m64n32k256_b1(acc[h], da + 2 * k, bh);
            } else {
              wgmma_m64n64k256_b1(acc[h], da + 2 * k, bh);
            }
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < kH; ++h)
          wgmma_m64n64k32(acc[h], da + 2 * k, db + (uint64_t)(h * 64 * kDK >> 4) + 2 * k);
      }
    }
    wgmma_commit();
    if (nc < nk) rows.put(nst, p);  // while the products run
    if (nc + 1 < nk) rows.prefetch(p, row0, (nc + 1) * kDK);
    wgmma_wait_all();
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) fence_acc(acc[h]);
}

// Loads mult and qoff of the block's queries (clamped to Q - 1) into shared
// memory; read after mma_segment's first barrier.
template <int TQ, class P>
__device__ __forceinline__ void load_qparams(P* qm, P* qo, const float* __restrict__ mult,
                                             const float* __restrict__ qoff, int q0, int Q,
                                             int mstride) {
  for (int i = threadIdx.x; i < TQ; i += kThreads) {
    const int q = min(q0 + i, Q - 1);
    qm[i] = mult[q * mstride];
    qo[i] = qoff[q];
  }
}

// ------------------------------------------------------------ score matrix

// Query rows 0 .. NQ-1 of an int [NQ][kTS] tile in shared memory to out (f32
// [Q, n_valid]), tile row i holding query q0 + i against corpus rows row0 ..
// row0+127 (scores_kernel; K6's thread stores in bq_kernels.cu): warp w
// writes tile rows w, w + 8, ...: lane l the corpus rows row0 + 4l .. + 3, as
// one coalesced 16-byte store where n_valid % 4 == 0, each value through
// score_of(q)(value, row). The row stride kTS puts the accumulator
// fragment's writes to the tile on distinct banks.
constexpr int kTS = kSeg + 4;
template <int NQ, class ScoreOf>
__device__ __forceinline__ void store_tile(const int* tile, ScoreOf score_of,
                                           float* __restrict__ out, int q0, int Q,
                                           long long row0, int n_valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = row0 + 4 * lane;
  const bool vec = (n_valid & 3) == 0 && r + 3 < n_valid;
  for (int i = warp; i < NQ; i += kThreads / 32) {
    const int q = q0 + i;
    if (q >= Q) break;
    const auto score = score_of(q);
    const int4 a = *reinterpret_cast<const int4*>(tile + i * kTS + 4 * lane);
    float* o = out + (long long)q * n_valid + r;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(score(a.x, r), score(a.y, r + 1), score(a.z, r + 2), score(a.w, r + 3));
    } else {
      const int v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r + j < n_valid) o[j] = score(v[j], r + j);
    }
  }
}

// K3 (CodeRows, kOnce false: (mult * acc + qoff) + voff, step by step);
// kOnce true (mult * acc + qoff in f64 rounded once, with no row additive:
// voff is not read and may be null, since x + 0.0 would turn a -0.0 into
// +0.0) is K8's form on NibbleRows, which the library no longer launches
// (pq4_mma_kernels.cu pq4_scores_ws_kernel) and the probe
// csrc/probe/approx_split.cu times as the replaced kernel. grid ceil(n_valid /
// 128) * ceil(Q / 128), the query tiles of a segment neighbours; out f32
// [Q, n_valid]. The [128 query][128 row] int tile goes through the ring's
// memory once the products are done, and leaves by store_tile.
template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, ScoresTile::kBlocks) scores_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff, float* __restrict__ out,
    int Q, int n_valid, int D, int mstride) {
  using T = ScoresTile;
  constexpr int TQ = T::TQ;
  static_assert(TQ * kTS * sizeof(int) <= T::kBytes, "the int tile in the ring");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int nqt = (Q + TQ - 1) / TQ;
  const int q0 = (blockIdx.x % nqt) * TQ;
  const long long row0 = (long long)(blockIdx.x / nqt) * kSeg;
  int acc[T::kH][32];
  mma_segment<T>(Rows{base, stride}, qcodes, q0, Q, row0, D, smem_addr(smem), acc);
  __syncthreads();  // every warpgroup's products are done: the ring is free
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int h = 0; h < T::kH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) tile[(64 * h + frag_col(e)) * kTS + frag_row(e)] = acc[h][e];
  __syncthreads();
  store_tile<TQ>(
      tile,
      [&](int q) {
        const typename QParam<kOnce>::T m = mult[q * mstride], qo = qoff[q];
        return [=](int a, long long row) {
          if constexpr (kOnce) {
            return affine_once(m, a, qo);
          } else {
            return epilogue<false>(m, a, qo, voff, row);
          }
        };
      },
      out, q0, Q, row0, n_valid);
}

// ----------------------------------------------------------- exact search
// Two selects, chosen by kk alone (ktile.cuh): the queue for kk <= kQueueK,
// the radix select above it. Both write cand_v / cand_i [Q, nblk*kk], block
// (b, t)'s exact top-min(kk, rows) of compact rows [b*split, b*split +
// split) below n_valid at columns b*kk .. b*kk+kk-1, NEG / -1 in the slots
// past its valid rows; grid nblk * ceil(Q / 64), nblk = ceil(ncomp / split),
// the query tiles of a range neighbours in launch order.
//
// The radix route (search_exact_kernel): split = 512. The block scores its
// split's 64 queries into shared memory as ordered keys, then each warp
// selects the top-kk of its 8 queries by a 4-pass radix select and writes
// them, unordered, with their corpus rows. A split lies in one selected
// tile (split divides tile_n), so its corpus rows are consecutive.
template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, ExactTile::kBlocks) search_exact_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int ncomp, int n_valid,
    int D, int split, int kk, int mstride, ScanMap map) {
  using T = ExactTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  using P = typename QParam<kOnce>::T;
  P* qm = reinterpret_cast<P*>(smem + T::kBytes);
  P* qo = qm + TQ;
  const int ks = split + kKeyPad;                               // key row stride
  unsigned* keys = reinterpret_cast<unsigned*>(qo + TQ);        // [TQ][ks]
  unsigned* hist_all = keys + TQ * ks;                          // [8][256]
  const int warp = threadIdx.x >> 5;
  const int nqt = (Q + TQ - 1) / TQ, nsplit = (ncomp + split - 1) / split;
  const int split_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)split_id * split;
  const long long row0 = map.row(start);
  load_qparams<TQ>(qm, qo, mult, qoff, q0, Q, mstride);

  for (int off = 0; off < split && start + off < ncomp; off += kSeg) {
    int acc[1][32];
    mma_segment<T>(Rows{base, stride}, qcodes, q0, Q, row0 + off, D, smem_addr(smem), acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = frag_col(e), r = off + frag_row(e);
      keys[j * ks + r] = float_to_key(map.add_corr(
          epilogue_q<kOnce>(qm[j], acc[0][e], qo[j], voff, row0 + r), min(q0 + j, Q - 1),
          start + r));
    }
  }
  __syncthreads();  // the keys of a query come from every warp

  const long long valid = (long long)n_valid - start;
  const int cnt = (int)(valid < 0 ? 0 : (valid < split ? valid : split));
  const long long width = (long long)nsplit * kk;
  for (int j = warp; j < TQ; j += kThreads / 32) {
    const int q = q0 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)split_id * kk;
    warp_select_topk(keys + j * ks, cnt, kk, row0, cand_v + o, cand_i + o,
                     hist_all + warp * 256);
  }
}

// The queue route (search_queue_kernel): split is any multiple of 128, the
// wrapper's range of whole 512-row splits that makes one wave of two blocks
// a SM (ktile.py exact_geometry). The block walks its range a 128-row
// segment at a time with one QueueSelect (ktile.cuh): the epilogue offers
// each valid score above its query's threshold, the owner warps (8 queries
// each) merge, and the queues leave sorted. Each segment lies in one
// selected tile (tile_n is a multiple of 128), its corpus rows from
// ScanMap::row; ties go to the lower compact row.
using ExactQueueTile = Tile<64, 3, 2>;

template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, ExactQueueTile::kBlocks) search_queue_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int Q, int ncomp, int n_valid,
    int D, int split, int kk, int mstride, ScanMap map) {
  using T = ExactQueueTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  using P = typename QParam<kOnce>::T;
  P* qm = reinterpret_cast<P*>(smem + T::kBytes);
  P* qo = qm + TQ;
  static_assert(T::kBytes >= TQ * kKeyStride * sizeof(unsigned), "the keys in the ring");
  QueueSelect<TQ> qs;
  qs.init(reinterpret_cast<uint8_t*>(qo + TQ), smem, kk);
  const int nqt = (Q + TQ - 1) / TQ, nblk = (ncomp + split - 1) / split;
  const int blk = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)blk * split;
  const long long end = min(min((long long)ncomp, (long long)n_valid), start + split);
  load_qparams<TQ>(qm, qo, mult, qoff, q0, Q, mstride);

  for (long long off = start; off < end; off += kSeg) {
    int acc[1][32];
    const long long seg0 = map.row(off);
    mma_segment<T>(Rows{base, stride}, qcodes, q0, Q, seg0, D, smem_addr(smem), acc);
    unsigned key[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = frag_col(e), r = frag_row(e);
      key[e] = off + r < end ? float_to_key(map.add_corr(
                                   epilogue_q<kOnce>(qm[j], acc[0][e], qo[j], voff, seg0 + r),
                                   min(q0 + j, Q - 1), off + r))
                             : 0u;
    }
    queue_segment<TQ, 32>(qs, key, off, min(TQ, Q - q0));
  }
  __syncthreads();  // the queues, also where the block had no valid row

  const long long width = (long long)nblk * kk;
  for (int j = threadIdx.x >> 5; j < TQ; j += kThreads / 32) {
    const int q = q0 + j;
    if (q >= Q) break;
    const long long o = (long long)q * width + (long long)blk * kk;
    qs.write(j, cand_v + o, cand_i + o, map);
  }
}

// ---------------------------------------------------------- approx search
// Pass 1, grid ceil(ncomp / part) * ceil(Q / 64), the query tiles of a part
// neighbours in launch order: block p keeps, for each of its queries and
// each stride class l (compact rows p*part + m*128 + l),
// the running maximum and its corpus row — strict ">" in compact order, so
// the first row wins ties, as the Pallas kernels' compares do. Compact rows
// >= n_valid score NEG. A 128-row segment lies in one selected tile; part
// is a multiple of 128 below 255 * 128, so a segment number m fits a byte.
// part_v / part_i: [Q, nparts*128]. Where part is the span block (the
// wrappers' geometry, ktile.py approx_geometry) they are the candidates;
// else pass 2 is ktile.cuh's in-order combine per span block. Every
// segment's voff (its 128 rows) and corr (its 512-row block, the block's
// queries) land in shared memory with its first chunk (side), so the
// epilogue reads no global memory. approx_ws_kernel (below) takes K2 / K9a
// and the value-query K5a / K10 wherever its query tile fits; this body
// keeps the depths past that.
constexpr int kApproxSide = (kSeg + ApproxTile::TQ) * 4;  // voff[128], corr[64]

template <class Rows, bool kOnce>
__global__ void __launch_bounds__(kThreads, ApproxTile::kBlocks) approx_parts_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int ncomp, int n_valid,
    int D, int part, int mstride, ScanMap map) {
  using T = ApproxTile;
  constexpr int TQ = T::TQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  using P = typename QParam<kOnce>::T;
  P* qm = reinterpret_cast<P*>(smem + T::kBytes + kApproxSide);
  P* qo = qm + TQ;
  const float* sv = reinterpret_cast<const float*>(smem + T::kBytes);
  const uint32_t ring = smem_addr(smem), side = ring + T::kBytes;
  const int nqt = (Q + TQ - 1) / TQ, nparts = (ncomp + part - 1) / part;
  const int part_id = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * TQ;
  const long long start = (long long)part_id * part;
  load_qparams<TQ>(qm, qo, mult, qoff, q0, Q, mstride);
  float best[32];
  unsigned seg[8];  // byte e % 4 of seg[e / 4]: the segment of best[e]; 0xff: none
#pragma unroll
  for (int e = 0; e < 32; ++e) best[e] = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
  for (int i = 0; i < 8; ++i) seg[i] = 0xffffffffu;
  int m = 0;
  for (int off = 0; off < part && start + off < ncomp; off += kSeg, ++m) {
    int acc[1][32];
    const long long seg0 = map.row(start + off);
    // The segment's voff (32 pieces of 16 bytes) and corr, beside its first
    // chunk.
    const auto copy_side = [&]() {
      const int t = threadIdx.x;
      if (t < kSeg / 4) {
        cp_async16(side + 16 * t, voff + seg0 + 4 * t, 16);
      } else if (map.corr && t < kSeg / 4 + TQ) {
        const int j = t - kSeg / 4;
        cp_async4(side + 4 * (kSeg + j), map.corr + min(q0 + j, Q - 1) * map.corr_qs +
                                             ((start + off) >> kCorrShift) * map.corr_bs);
      }
    };
    mma_segment<T>(Rows{base, stride}, qcodes, q0, Q, seg0, D, ring, acc, copy_side);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = frag_col(e), r = frag_row(e);
      const long long c = start + off + r;
      float sc = kNeg;
      if (c < n_valid) {
        sc = __fadd_rn(affine_q<kOnce>(qm[j], acc[0][e], qo[j]), sv[r]);
        if (map.corr) sc = __fadd_rn(sc, sv[kSeg + j]);
      }
      if (sc > best[e]) {
        best[e] = sc;
        const int sh = 8 * (e & 3);
        seg[e >> 2] = (seg[e >> 2] & ~(0xffu << sh)) | ((unsigned)m << sh);
      }
    }
  }
  const long long width = (long long)nparts * kSlot;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int q = q0 + frag_col(e), l = frag_row(e);
    if (q >= Q) continue;
    const unsigned sm = (seg[e >> 2] >> (8 * (e & 3))) & 0xffu;
    const long long c = (long long)q * width + (long long)part_id * kSlot + l;
    part_v[c] = best[e];
    part_i[c] = sm == 0xffu ? -1 : (int)map.row(start + (long long)sm * kSeg + l);
  }
}

// ------------------------------------- approx search, warp-specialized body
// approx_ws_kernel: pass 1 of K2 / K9a (CodeRows) and of the value-query K5a
// / K10 (PlaneRows), approx_parts_kernel's output to the bit, wherever the
// block's query tile stays resident beside kWsMinStages ring stages a
// warpgroup (WsLayout, ws_fits; past that approx_parts_kernel runs; the
// 4-bit int8 K7a / K11, whose 3,072-byte one-hot depth is no resident tile,
// run pq4_mma_kernels.cu's pq4_approx_ws_kernel on this walk). A block of 384 threads, one a SM, persistent:
//   * a tile of 128 queries (ws_tq: 64 where Q <= 64) is loaded once and
//     stays resident: the products are m64n128k32, so a chunk of rows staged
//     once serves twice the queries it serves in a 64-query tile.
//   * warpgroups 0 and 1 consume: warpgroup g takes rows 64g .. 64g + 63 of
//     every 128-row segment (frag_row), as mma_segment's warpgroups do, from
//     a ring of its own (8 KB stages: its 64 rows of a 128-byte chunk,
//     swizzled). Full / empty mbarriers pace the ring, no block-wide barrier
//     is left in the walk, and a warpgroup keeps a chunk's products in
//     flight while it releases the stage of the one before.
//   * warpgroup 2 produces: warps 2g and 2g + 1 keep warpgroup g's ring full
//     across segments and items. CodeRows: cp.async straight into the
//     swizzled stage, each thread's copies arriving on the stage's full
//     barrier as they land (cp.async.mbarrier.arrive.noinc). PlaneRows: a
//     segment's plane words land raw one segment ahead (cp.async), then a
//     thread expands its row's words into the stage. With a segment's first
//     chunk go its voff (the warpgroup's 64 rows) and corr (the block's
//     queries) into a side slot, so the epilogue reads no global memory. At
//     TQ = 128 the producer gives registers to the consumers (setmaxnreg:
//     56 and 224 a thread), whose accumulators and maxima take 128.
//   * the two consumer warpgroups run free of each other, each on its own
//     ring, so the epilogue and stride-class maxima of one run under the
//     other's products. Strict turns on the tensor cores (a warpgroup's chain
//     only once the other's was issued) measured no faster: K10-value at the
//     serving width 1.2953 against 1.2593 ms, K9a 0.1632 against 0.1629
//     (NVIDIA H100 80GB HBM3, 700 W, csrc/probe/approx_split.cu).
//   * block b walks the work items b, b + G, ... (G, the grid, a multiple of
//     the query tiles nqt; item i = part i / nqt, query tile i % nqt): its
//     query tile never changes, and the query tiles of a part run on
//     neighbouring blocks at once, reading its rows once from device memory.
// Where an item is a whole span block (part == span_rows, ktile.py
// approx_geometry), its maxima are the candidates and no combine runs.
// kScan (csrc/probe/approx_split.cu): the scan alone, each accumulator
// folded into a register in place of the epilogue (wrong results).
constexpr int kWsThreads = 3 * 128;
constexpr int kWsStage = 64 * kDK;                       // a warpgroup's 64 rows of a chunk
constexpr int kWsMinStages = 4, kWsMaxStages = 8;        // a warpgroup's ring
constexpr int kWsSide = 4;                               // side slots a warpgroup
constexpr int kWsMaxRaw = 8;  // box slots a warpgroup (bq_sign_approx_ws_kernel)
constexpr int kWsBarBytes = 512;
constexpr int kWsTQ = 128;  // queries a block (64 where Q <= 64: ws_tq)
constexpr int kWsSmem = 232448;  // H100: dynamic shared memory a block may take

// The block's shared memory, offsets from the 1024-aligned base: the two
// rings (stage s of warpgroup g at (g * S + s) * kWsStage), the resident
// queries (chunk c [TQ][128 B] swizzled at q + c * TQ * 128), PlaneRows'
// raw words (two segments a warpgroup), the side slots, qm / qo, the
// segment bytes of the running maxima, the barriers. S = 0 where fewer than
// kWsMinStages fit.
struct WsLayout {
  int S, q, raw, raw_seg, side, side_bytes, qp, segs, bars, bytes;
  __host__ __device__ WsLayout(int TQ, int D, bool planes, int psize) {
    const int nk = D / kDK, qbytes = nk * TQ * kDK;
    raw_seg = planes ? nk * 4 * 64 * 4 : 0;  // nk chunks x 4 words x 64 rows
    side_bytes = (64 + TQ) * 4;              // voff[64], corr[TQ]
    const int fixed = qbytes + 2 * 2 * raw_seg + 2 * kWsSide * side_bytes + 2 * TQ * psize +
                      256 * TQ / 2 + kWsBarBytes;
    const int room = (kWsSmem - kAlign - fixed) / (2 * kWsStage);
    S = room < kWsMinStages ? 0 : room < kWsMaxStages ? room : kWsMaxStages;
    q = 2 * S * kWsStage;
    raw = q + qbytes;
    side = raw + 2 * 2 * raw_seg;
    qp = side + 2 * kWsSide * side_bytes;
    segs = qp + 2 * TQ * psize;
    bars = segs + 256 * TQ / 2;
    bytes = bars + kWsBarBytes;
  }
};

// The body's mbarriers, 8 bytes each from b.
struct WsBars {
  uint32_t b;
  __device__ __forceinline__ uint32_t full(int g, int s) const {
    return b + 8 * (g * kWsMaxStages + s);
  }
  __device__ __forceinline__ uint32_t empty(int g, int s) const {
    return b + 8 * ((2 + g) * kWsMaxStages + s);
  }
  __device__ __forceinline__ uint32_t side_free(int g, int k) const {
    return b + 8 * (4 * kWsMaxStages + g * kWsSide + k);
  }
  __device__ __forceinline__ uint32_t qready() const {
    return b + 8 * (4 * kWsMaxStages + 2 * kWsSide);
  }
  // Box slot r of warpgroup g, landed by a bulk copy (the sign-query body).
  __device__ __forceinline__ uint32_t raw(int g, int r) const {
    return b + 8 * (4 * kWsMaxStages + 2 * kWsSide + 1 + g * kWsMaxRaw + r);
  }
};
static_assert(8 * (4 * kWsMaxStages + 2 * kWsSide + 1 + 2 * kWsMaxRaw) <= kWsBarBytes,
              "the barriers fit");

__device__ __forceinline__ void ws_bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival where p holds, with no branch (between a warpgroup's products).
__device__ __forceinline__ void ws_bar_arrive_if(uint32_t bar, bool p) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)p)
      : "memory");
}
// An arrival once every cp.async this thread issued so far has landed (the
// barrier's count includes it).
__device__ __forceinline__ void ws_bar_arrive_cp(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// The block's resident query tile, staged by the producer warpgroup (thread
// pt of 128): chunk c of query q0 + r at dst + c * TQ * kDK + swz(r, piece),
// from the D bytes of each row of qcodes [Q, D] (a multiple of 16: the last
// chunk may be partial), zero for queries >= Q and past D; each thread's
// copies then arrive on qready.
template <int TQ>
__device__ __forceinline__ void ws_fetch_queries(uint32_t dst, const int8_t* __restrict__ qcodes,
                                                 int q0, int Q, int D, uint32_t qready, int pt) {
  const int nk = (D + kDK - 1) / kDK;
  for (int idx = pt; idx < nk * TQ * 8; idx += 128) {
    const int c = idx / (TQ * 8), r = (idx >> 3) % TQ, pc = idx & 7, q = q0 + r;
    const bool in = q < Q && c * kDK + pc * 16 < D;
    cp_async16(dst + c * (TQ * kDK) + swz(r, pc),
               qcodes + (long long)min(q, Q - 1) * D + (in ? c * kDK + pc * 16 : 0), in ? 16 : 0);
  }
  ws_bar_arrive_cp(qready);
}

// The block's walk over its items' segments, in order.
struct WsWalk {
  int nqt, nitems, part, ncomp, item, m, ns;
  long long start;  // the item's first compact row
  __device__ __forceinline__ WsWalk(int TQ, int Q, int ncomp_, int part_) {
    nqt = (Q + TQ - 1) / TQ;
    part = part_;
    ncomp = ncomp_;
    nitems = (ncomp + part - 1) / part * nqt;
    item = blockIdx.x;
    m = 0;
    set_item();
  }
  __device__ __forceinline__ void set_item() {
    start = (long long)(item / nqt) * part;
    const long long left = ncomp - start;
    ns = (int)(((left < part ? left : part) + kSeg - 1) / kSeg);
  }
  __device__ __forceinline__ bool done() const { return item >= nitems; }
  __device__ __forceinline__ bool last() const { return m == ns - 1; }
  // The segment's first compact row.
  __device__ __forceinline__ long long comp() const { return start + (long long)m * kSeg; }
  __device__ __forceinline__ void next() {
    if (++m == ns) {
      m = 0;
      item += gridDim.x;
      if (item < nitems) set_item();
    }
  }
};

// The products of one k32 step against TQ queries.
template <int TQ>
__device__ __forceinline__ void wgmma_tq(int (&d)[TQ / 2], uint64_t a, uint64_t b) {
  if constexpr (TQ == 128) {
    wgmma_m64n128k32(d, a, b);
  } else {
    wgmma_m64n64k32(d, a, b);
  }
}

template <class Rows, bool kOnce, bool kScan, int TQ>
__global__ void __launch_bounds__(kWsThreads, 1) approx_ws_kernel(
    const typename Rows::Elem* __restrict__ base, long long stride,
    const int8_t* __restrict__ qcodes, const float* __restrict__ qoff,
    const float* __restrict__ mult, const float* __restrict__ voff,
    float* __restrict__ part_v, int* __restrict__ part_i, int Q, int ncomp, int n_valid,
    int D, int part, int mstride, ScanMap map) {
  constexpr bool kPlanes = std::is_same<Rows, PlaneRows>::value;
  static_assert(kPlanes || std::is_same<Rows, CodeRows>::value, "CodeRows or PlaneRows");
  constexpr int kAcc = TQ / 2;
  using P = typename QParam<kOnce>::T;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const WsLayout L(TQ, D, kPlanes, (int)sizeof(P));
  const uint32_t s0 = smem_addr(smem);
  const WsBars bars{s0 + L.bars};
  P* qm = reinterpret_cast<P*>(smem + L.qp);
  P* qo = qm + TQ;
  const int nk = D / kDK, S = L.S;
  const int q0 = (int)(blockIdx.x % ((Q + TQ - 1) / TQ)) * TQ;
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g) {
      for (int s = 0; s < S; ++s) {
        mbar_init(bars.full(g, s), 64);  // the ring's 64 producer threads
        mbar_init(bars.empty(g, s), 1);  // the warpgroup's first thread
      }
      for (int k = 0; k < kWsSide; ++k) mbar_init(bars.side_free(g, k), 128);
    }
    mbar_init(bars.qready(), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    // TQ = 128: the consumers' accumulators and maxima need more than the
    // launch's 168 registers a thread; the producer gives them its own.
    if constexpr (TQ == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x - 256, g = pt >> 6, lt = pt & 63;
    ws_fetch_queries<TQ>(s0 + L.q, qcodes, q0, Q, D, bars.qready(), pt);
    const uint32_t ring = s0 + g * S * kWsStage;
    const uint32_t side0 = s0 + L.side + g * kWsSide * L.side_bytes;
    const uint32_t raw0 = s0 + L.raw + g * 2 * L.raw_seg;
    // PlaneRows: the plane words of the segment at row0 into raw slot p,
    // word (4c + w) of this thread's row at (4c + w) * 256 + 4 lt.
    auto issue_raw = [&](int p, long long row0) {
      const uint32_t dst = raw0 + p * L.raw_seg + 4 * lt;
      const typename Rows::Elem* src = base + row0 + 64 * g + lt;
      for (int cw = 0; cw < 4 * nk; ++cw) cp_async4(dst + cw * 256, src + (long long)cw * stride);
    };
    WsWalk w(TQ, Q, ncomp, part), ahead(TQ, Q, ncomp, part);
    if constexpr (kPlanes) {
      issue_raw(0, map.row(w.comp()));
      cp_async_commit();
      ahead.next();
    }
    int s = 0, u = 0;
    uint32_t ph = 0;
    for (; !w.done(); w.next(), ++u) {
      const long long cs = w.comp(), row0 = map.row(cs);
      const int ks = u % kWsSide;
      mbar_wait(bars.side_free(g, ks), ((u / kWsSide) & 1) ^ 1u);
      const uint32_t side = side0 + ks * L.side_bytes;
      if (lt < 16) cp_async16(side + 16 * lt, voff + row0 + 64 * g + 4 * lt, 16);
      if (map.corr) {
        for (int j = lt; j < TQ; j += 64)
          cp_async4(side + 4 * (64 + j), map.corr + min(q0 + j, Q - 1) * map.corr_qs +
                                             (cs >> kCorrShift) * map.corr_bs);
      }
      if constexpr (kPlanes) {
        cp_async_commit();
        if (!ahead.done()) issue_raw((u + 1) & 1, map.row(ahead.comp()));
        cp_async_commit();
        ahead.next();
        cp_async_wait<1>();  // the side and this segment's raw words landed
      }
      for (int c = 0; c < nk; ++c) {
        mbar_wait(bars.empty(g, s), ph ^ 1u);
        const uint32_t st = ring + s * kWsStage;
        if constexpr (kPlanes) {
          // Row lt's words 4c .. 4c + 3: A row lt, byte 32w + j = bit j of
          // word w (PlaneRows::put's expansion).
          const uint32_t src = raw0 + (u & 1) * L.raw_seg + 4 * c * 256 + 4 * lt;
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            uint32_t v;
            asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(src + wd * 256));
            uint32_t b[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              b[i] = (((v >> (4 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;
            st_shared_v4(st + swz(lt, 2 * wd), b[0], b[1], b[2], b[3]);
            st_shared_v4(st + swz(lt, 2 * wd + 1), b[4], b[5], b[6], b[7]);
          }
          fence_proxy_async();  // the stores, for the products
          ws_bar_arrive(bars.full(g, s));
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int idx = lt + 64 * i, r = idx >> 3, pc = idx & 7;
            cp_async16(st + swz(r, pc), base + (row0 + 64 * g + r) * stride + c * kDK + pc * 16,
                       16);
          }
          ws_bar_arrive_cp(bars.full(g, s));
        }
        if (++s == S) s = 0, ph ^= 1u;
      }
    }
    cp_async_wait<0>();
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (TQ == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int g = threadIdx.x >> 7;
  const bool lead = (threadIdx.x & 127) == 0;
  for (int i = threadIdx.x; i < TQ; i += 256) {
    const int q = min(q0 + i, Q - 1);
    qm[i] = mult[q * mstride];
    qo[i] = qoff[q];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers' qm / qo
  mbar_wait(bars.qready(), 0);
  fence_proxy_async();
  const uint32_t ring = s0 + g * S * kWsStage;
  const uint64_t dq = wgmma_desc(s0 + L.q);
  const int nparts = (ncomp + part - 1) / part;
  const long long width = (long long)nparts * kSlot;
  float best[kAcc];
  // The segment of best[e] (0xff: none), a byte in shared memory: byte e % 4
  // of this thread's word e / 4 (words [kAcc / 4][256 threads]).
  uint8_t* seg = smem + L.segs + 4 * threadIdx.x;
  unsigned fold = 0;
  auto reset = [&]() {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) best[e] = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) *reinterpret_cast<unsigned*>(seg + i * 1024) = ~0u;
  };
  reset();
  int s = 0, u = 0;
  uint32_t ph = 0;
  for (WsWalk w(TQ, Q, ncomp, part); !w.done(); w.next(), ++u) {
    int acc[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0;
    fence_acc(acc);
    int sp = 0;
    for (int c = 0; c < nk; ++c) {
      mbar_wait(bars.full(g, s), ph);
      fence_proxy_async();  // the producer's cp.async copies, for the products
      const uint64_t da = wgmma_desc(ring + s * kWsStage),
                     db = dq + (uint64_t)((c * TQ * kDK) >> 4);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDK / 32; ++k) wgmma_tq<TQ>(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();  // chunk c - 1's products are done: its stage is free
        ws_bar_arrive_if(bars.empty(g, sp), lead);
      }
      sp = s;
      if (++s == S) s = 0, ph ^= 1u;
    }
    wgmma_wait<0>();
    ws_bar_arrive_if(bars.empty(g, sp), lead);
    fence_acc(acc);
    const int ks = u % kWsSide;
    const float* sv = reinterpret_cast<const float*>(smem + L.side +
                                                     (g * kWsSide + ks) * L.side_bytes);
    const long long cs = w.comp();
    if constexpr (kScan) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) fold ^= (unsigned)acc[e];
    } else {
      // Elements 4i .. 4i + 3: queries j = 8i + 2 (t % 4) and j + 1 (e & 1) at
      // rows r and r + 8 (e & 2).
      const int r0 = frag_row(0);
      const bool in0 = cs + r0 < n_valid, in1 = cs + r0 + 8 < n_valid;
      const float v0 = sv[r0 - 64 * g], v1 = sv[r0 + 8 - 64 * g];
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        const int j = frag_col(4 * i);
        const P m0 = qm[j], m1 = qm[j + 1], o0 = qo[j], o1 = qo[j + 1];
        const float c0 = map.corr ? sv[64 + j] : 0.f, c1 = map.corr ? sv[65 + j] : 0.f;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 4 * i + h;
          float sc = kNeg;
          if (h & 2 ? in1 : in0) {
            sc = __fadd_rn(affine_q<kOnce>(h & 1 ? m1 : m0, acc[e], h & 1 ? o1 : o0),
                           h & 2 ? v1 : v0);
            if (map.corr) sc = __fadd_rn(sc, h & 1 ? c1 : c0);
          }
          if (sc > best[e]) {
            best[e] = sc;
            seg[i * 1024 + h] = (uint8_t)w.m;
          }
        }
      }
    }
    ws_bar_arrive(bars.side_free(g, ks));
    if (w.last()) {
      const int pid = (int)(w.start / part);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int q = q0 + frag_col(e), l = frag_row(e);
        if (q >= Q) continue;
        const unsigned sm = seg[(e >> 2) * 1024 + (e & 3)];
        const long long o = (long long)q * width + (long long)pid * kSlot + l;
        if constexpr (kScan) {
          part_v[o] = __uint_as_float(fold);
        } else {
          part_v[o] = best[e];
          part_i[o] = sm == 0xffu ? -1 : (int)map.row(w.start + (long long)sm * kSeg + l);
        }
      }
      reset();
    }
  }
}

// --------------------------------------------------------- host launches
// Each launches on `s` without synchronising and returns cudaGetLastError().

template <class Rows, bool kOnce>
cudaError_t launch_mma_scores(const void* base, long long stride, const void* qcodes,
                              const void* qoff, const void* mult, const void* voff, void* out,
                              int Q, int n_valid, int D, int mstride, cudaStream_t s) {
  const size_t smem = kAlign + ScoresTile::kBytes;
  cudaError_t err = cudaFuncSetAttribute(scores_kernel<Rows, kOnce>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      (unsigned)((n_valid + kSeg - 1) / kSeg) * ((Q + ScoresTile::TQ - 1) / ScoresTile::TQ);
  scores_kernel<Rows, kOnce><<<grid, kThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(out), Q, n_valid, D, mstride);
  return cudaGetLastError();
}

// The radix route alone (search_exact_kernel), whatever kk.
template <class Rows, bool kOnce>
cudaError_t launch_search_radix(const void* base, long long stride, const void* qcodes,
                                const void* qoff, const void* mult, const void* voff,
                                void* cand_v, void* cand_i, int Q, int ncomp, int n_valid, int D,
                                int split, int kk, int mstride, ScanMap map, cudaStream_t s) {
  if (split % kSeg || kk < 1) return cudaErrorInvalidValue;
  using P = typename QParam<kOnce>::T;
  // The query tiles of one split are neighbours in launch order, so they
  // run together and read its rows once from device memory.
  const unsigned grid =
      (unsigned)((ncomp + split - 1) / split) * ((Q + ExactTile::TQ - 1) / ExactTile::TQ);
  const size_t smem = kAlign + ExactTile::kBytes + sizeof(P) * 2 * ExactTile::TQ +
                      sizeof(unsigned) * ((size_t)ExactTile::TQ * (split + kKeyPad) + 8 * 256);
  cudaError_t err = cudaFuncSetAttribute(search_exact_kernel<Rows, kOnce>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  search_exact_kernel<Rows, kOnce><<<grid, kThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, ncomp, n_valid, D, split,
      kk, mstride, map);
  return cudaGetLastError();
}

template <class Rows, bool kOnce>
cudaError_t launch_search_exact(const void* base, long long stride, const void* qcodes,
                                const void* qoff,
                                const void* mult, const void* voff, void* cand_v,
                                void* cand_i, int Q, int ncomp, int n_valid, int D,
                                int split, int kk, int mstride, ScanMap map,
                                cudaStream_t s) {
  static_assert(ExactTile::TQ == ExactQueueTile::TQ, "one grid for both routes");
  if (kk > kQueueK)
    return launch_search_radix<Rows, kOnce>(base, stride, qcodes, qoff, mult, voff, cand_v,
                                            cand_i, Q, ncomp, n_valid, D, split, kk, mstride,
                                            map, s);
  if (split % kSeg || kk < 1) return cudaErrorInvalidValue;
  using P = typename QParam<kOnce>::T;
  // The query tiles of one range are neighbours in launch order, so they
  // run together and read its rows once from device memory.
  const unsigned grid =
      (unsigned)((ncomp + split - 1) / split) * ((Q + ExactTile::TQ - 1) / ExactTile::TQ);
  const size_t smem = kAlign + ExactQueueTile::kBytes + sizeof(P) * 2 * ExactQueueTile::TQ +
                      QueueSelect<ExactQueueTile::TQ>::bytes(kk);
  const cudaError_t err = queue_smem(search_queue_kernel<Rows, kOnce>, smem);
  if (err != cudaSuccess) return err;
  search_queue_kernel<Rows, kOnce><<<grid, kThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), Q, ncomp, n_valid, D, split, kk,
      mstride, map);
  return cudaGetLastError();
}

// approx_parts_kernel's launch.
template <class Rows, bool kOnce>
cudaError_t launch_approx_parts(const void* base, long long stride, const void* qcodes,
                                const void* qoff, const void* mult, const void* voff,
                                void* part_v, void* part_i, int Q, int ncomp, int n_valid, int D,
                                int part, int mstride, ScanMap map, cudaStream_t s) {
  auto* kernel = approx_parts_kernel<Rows, kOnce>;
  const size_t smem = kAlign + ApproxTile::kBytes + kApproxSide +
                      2 * ApproxTile::TQ * sizeof(typename QParam<kOnce>::T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nparts = (ncomp + part - 1) / part;
  const unsigned grid = (unsigned)nparts * ((Q + ApproxTile::TQ - 1) / ApproxTile::TQ);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, ncomp, n_valid, D, part,
      mstride, map);
  return cudaGetLastError();
}

// A 2D tensor map over a row-major array of `rows` rows of `cols` elements
// of `type`, row_bytes apart, for boxes of box_cols x box_rows elements
// (tma_load_2d); elements past the array land as zeros. The TMA loads of
// the warp-specialized bodies: bq_kernels.cu's plane boxes, pq4_mma_kernels.cu's
// LUT and code boxes. cuTensorMapEncodeTiled lives in libcuda; the runtime
// hands its entry point over, so the library does not link libcuda.
inline cudaError_t tensor_map_2d(CUtensorMap* m, CUtensorMapDataType type, const void* base,
                                 unsigned long long cols, unsigned long long rows,
                                 unsigned long long row_bytes, unsigned box_cols, unsigned box_rows,
                                 CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  return encode(m, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A warp-specialized launch's grid: one block a SM (at least one a query
// tile), a multiple of the query tiles and at most the items.
inline cudaError_t ws_grid(int Q, int TQ, long long ncomp, int part, unsigned* grid) {
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nqt = (Q + TQ - 1) / TQ;
  const long long nitems = (ncomp + part - 1) / part * nqt;
  const long long g = (long long)(nsm / nqt > 1 ? nsm / nqt : 1) * nqt;
  *grid = (unsigned)(g < nitems ? g : nitems);
  return cudaSuccess;
}

// approx_ws_kernel's launch (ws_grid). The caller checks that the layout
// fits (ws_fits).
template <class Rows, bool kOnce, bool kScan = false, int TQ = kWsTQ>
cudaError_t launch_approx_ws(const void* base, long long stride, const void* qcodes,
                             const void* qoff, const void* mult, const void* voff, void* part_v,
                             void* part_i, int Q, int ncomp, int n_valid, int D, int part,
                             int mstride, ScanMap map, cudaStream_t s) {
  const WsLayout L(TQ, D, std::is_same<Rows, PlaneRows>::value,
                   (int)sizeof(typename QParam<kOnce>::T));
  if (L.S == 0) return cudaErrorInvalidValue;
  auto* kernel = approx_ws_kernel<Rows, kOnce, kScan, TQ>;
  const size_t smem = kAlign + L.bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  unsigned grid = 0;
  if (err == cudaSuccess) err = ws_grid(Q, TQ, ncomp, part, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, smem, s>>>(
      static_cast<const typename Rows::Elem*>(base), stride,
      static_cast<const int8_t*>(qcodes), static_cast<const float*>(qoff),
      static_cast<const float*>(mult), static_cast<const float*>(voff),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, ncomp, n_valid, D, part,
      mstride, map);
  return cudaGetLastError();
}

// The query tile: 128 queries, or 64 where there are no more.
inline int ws_tq(int Q) { return Q > 64 ? kWsTQ : 64; }

// Whether approx_ws_kernel runs the route: CodeRows or PlaneRows, its
// layout in the SM's shared memory.
template <class Rows, bool kOnce>
bool ws_fits(int Q, int D) {
  constexpr bool planes = std::is_same<Rows, PlaneRows>::value;
  if (!planes && !std::is_same<Rows, CodeRows>::value) return false;
  return WsLayout(ws_tq(Q), D, planes, (int)sizeof(typename QParam<kOnce>::T)).S > 0;
}

// Pass 1 (approx_ws_kernel where ws_fits, else approx_parts_kernel), then,
// unless each part is a whole span block, the combine into out_v / out_i
// [Q, ceil(ncomp / span_rows) * 128].
template <class Rows, bool kOnce>
cudaError_t launch_search_approx(const void* base, long long stride, const void* qcodes,
                                 const void* qoff,
                                 const void* mult, const void* voff, void* part_v,
                                 void* part_i, void* out_v, void* out_i, int Q, int ncomp,
                                 int n_valid, int D, int part, int span_rows, int mstride,
                                 ScanMap map, cudaStream_t s) {
  // With out_v / out_i in the parts' place, each part must be a whole span
  // block: pass 1's maxima are then the result, and no combine runs.
  const bool in_place = out_v == part_v;
  if (part % kSeg || part / kSeg > 255 || span_rows % part || (in_place && span_rows != part))
    return cudaErrorInvalidValue;
  static_assert(std::is_same<Rows, CodeRows>::value || std::is_same<Rows, PlaneRows>::value,
                "CodeRows or PlaneRows (the one-hot searches: pq4_mma_kernels.cu)");
  const int nparts = (ncomp + part - 1) / part;
  cudaError_t err;
  if (ws_fits<Rows, kOnce>(Q, D) && ws_tq(Q) == 64) {
    err = launch_approx_ws<Rows, kOnce, false, 64>(base, stride, qcodes, qoff, mult, voff, part_v,
                                                   part_i, Q, ncomp, n_valid, D, part, mstride,
                                                   map, s);
  } else if (ws_fits<Rows, kOnce>(Q, D)) {
    err = launch_approx_ws<Rows, kOnce>(base, stride, qcodes, qoff, mult, voff, part_v, part_i, Q,
                                        ncomp, n_valid, D, part, mstride, map, s);
  } else {
    err = launch_approx_parts<Rows, kOnce>(base, stride, qcodes, qoff, mult, voff, part_v, part_i,
                                           Q, ncomp, n_valid, D, part, mstride, map, s);
  }
  if (err != cudaSuccess || in_place) return err;
  return launch_approx_combine(static_cast<const float*>(part_v),
                               static_cast<const int*>(part_i), static_cast<float*>(out_v),
                               static_cast<int*>(out_i), Q, nparts, span_rows / part, s);
}

}  // namespace
