#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py             # the checks and times, about 17 minutes
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown per path
    python3 chip_smoke.py --rehearse [pq] [ivf] [rbq]  # paths 3-5's recall on the CPU, 30k rows
    python3 chip_smoke.py --rehearse ann  # path 6's recall on the CPU, 20k rows
    python3 chip_smoke.py --rehearse 10m  # path 9's recall on the CPU, 30k rows

Builds the hand-written kernels from ``quantization_tpu_torch/csrc`` with
nvcc (one process per source, all at once), checks with cuobjdump that
every entry function of the int8 scan body runs on wgmma (the BQ
sign-query kernels, K6 and the searches, on its single-bit product) and that the PQ searches'
LUT ring is fed by bulk copies on mbarriers, counts the PQ LUT-gather
lookup loop's SASS instructions a lookup (held to LOOP_SASS_MAX) and prints
each of its entries' ptxas registers and spills, builds and runs the probe
csrc/probe/select_split.cu (the scans of K1, K5c and 4-bit K7b without their select,
which splits their times into scan and select, and the exact kernels'
blocks a SM) and csrc/probe/approx_split.cu (K9a's, dense K2's,
K10-value's, the sign-query K5a's and K10's and 4-bit int8 K7a's pass 1,
its scan alone and
the combine on the warp-specialized bodies and the two-block ones, span
items and 2048-row items: the [approx] lines; every approx body's ptxas
registers and spills are printed from the build, the sign-query ones
required), and drives the
port's eleven main paths through the public API, each with the kernel launch
counts set to 0 just before it and read just after:

  1. SQ-u8: DOT over 100,000 x 1024 random vectors, a 256-query batch,
     top-10 exact (K1) and approx (K2), score_batch (K3), save/load; K1-K3
     are timed at Q = 256 and at Q = 32.
  2. BQ + two-stage retrieval at the shape of dbpedia-entities-openai-1M
     (1,000,000 x 1536, DOT on cosine-normalised rows; synthetic, clustered
     data made on the card from the seed), Q = 256, k = 10, oversampling 4:
     BQ coarse search approx (K5a) and exact (K5c), rescored by SQ-u8 (K4)
     or by the f32 vectors; BQ score_batch (K6); a BQ save/load round trip.

The two-stage indexes then run again on a second synthetic corpus of the
same shape whose sign bits rank neighbours (small neighbourhoods), where
recall@10 is held to a floor; the BQ searches and the batches are timed on
both corpora, since the clustered one ties far more.

  3. PQ at the repo's PQ target, DOT over 1,000,000 x 768 rows of such a
     neighbourhood corpus, Q = 256, k = 10: 8-bit (96 subquantizers x 256
     centroids) and 4-bit (192 x 16) trained and encoded on the card, exact
     (K7b) and approx (K7a) top-10 and score_batch (K8, with the int8 and
     the bf16 LUT), counted per bit width (with 4-bit codes and the int8
     LUT, K8, K7b and K7a take the one-hot route on the tensor-core scan
     body, counted apart and the searches also held against plain with the
     residual additives; with 4-bit codes and the bf16 LUT, K8 takes the
     bf16 one-hot route, counted apart too); codes
     against the CPU
     encoder, save/load; the LUT-gather kernels also held at Q = 4, 33 and
     100 and on int8 sums at their extremes, past the packed sums' flush
     (gather_holds); then OPQ and an OPQ ->
     f32 two-stage index (R = 40), whose recall@10 is held to the floor of
     the CPU rehearsal (``--rehearse``).

  4. IVF on path 3's corpus (1,000,000 x 768, Q = 256, k = 10): IVF-SQ,
     residual IVF-SQ, residual IVF-OPQ, IVF-BQ and 4-bit IVF-PQ at the
     automatic geometry (S = 1024), residual IVF-OPQ at the README geometry
     (nlist 2048, S = 512), searched exact and approx at nprobe 32 over 256
     and 512 buckets through the indexed scans (K9b, K9a, K10, K11; 4-bit
     K11 on the one-hot route) and the compact ones (K1 / K2 with corr, K5c,
     K7b / K7a with rowadd and corr, 4-bit K7b on the one-hot route), and
     IVF-SQ / IVF-OPQ -> f32 two-stage, whose recall@10 is held to the floor
     of the CPU rehearsal (``--rehearse ivf``); indexed == compact, the
     full probe == the full scan, chunked == unchunked, save/load.

  5. Residual IVF-BQ, SQ L1 and serving: residual and plain IVF-BQ at
     1,000,000 x 768 on the JAX package's residual-regime corpus (6 centres
     x 3, sigma 0.3, not normalized; built without a warning), every bucket
     scanned exactly (K5b), whose recall lift is held to half the CPU
     rehearsal's (``--rehearse rbq``), then nprobe 32 over 256 / 512
     buckets through the indexed (K10, value query + corr) and compact
     (K5a / K5b) scans; the full probe == a plain scan of every row,
     chunked == unchunked, save/load and the numpy round trip. SQ-u8 L1 at
     100,000 x 1024: score_batch, top_k and IVF-SQ L1 through K12. Then
     ``recommend(target 0.9)`` -> ``plan.serve`` -> ``search_stream`` over
     16 fresh 256-query batches (depth 8): each result equal to the
     blocking search, the held-out recall, the per-batch walls, the device
     idle share from the searches' CUDA-event spans in unprofiled windows,
     and the host syncs per search in a profiler window. The served
     searches' K10 (value query, every bucket) is held against its plain
     version and timed at the plan's width as its own kernels-line entry.

  6. The harness, the entry points a user runs: the ann-benchmarks CLI
     (bench/ann_benchmark.py) on deep-image-96-angular's synthetic corpus at
     its published 9,990,000 x 96, made once: u8 exact (with the f32
     baseline), u8 approx, u8-f32, bq, bq-u8 and pq through the CLI's own
     functions, each with recall@10/20/30, latency percentiles over 25
     batches of 4 queries, encode wall and q/s of all 100 queries at once;
     ivf-sq-f32 through main() on glove-100-angular at 1,183,514 x 100.
     Every kernel a method launched is held against its plain version on
     the inputs of its last launch there (the [100, 9,990,000] score
     matrices included). The same methods at 20,000 rows are held to the
     CPU rehearsal (``--rehearse ann``); the native host encoders at 1M x
     768 on 8 threads against the device encoders; micro; cpu_baseline; the
     five examples. Its wall is held to 180 s.

  7. The sharded engines (parallel/sharded.py) on a mesh of 4 shards of the
     one card: path 2's neighbourhood corpus (1,000,000 x 1536) encoded by
     the single-device and the sharded-native streaming encoders (codes
     byte-equal; the last shard ragged, 248,896 of its 250,368 SQ rows
     valid), path 3's PQ 8-bit / 4-bit quantizers wrapped; SQ / BQ / PQ
     exact, approx and past the fused caps (K3, K6, K8 per shard), K4
     rescoring, BQ -> SQ / f32 two-stage over sharded stages, counted per
     search (one launch a shard) and held against plain on the last shard's
     last launch; each exact search equal to the single-device one (values
     to the bit, ids where untied), approx overlap, two-stage recall,
     score_candidates (-inf for ids no shard owns), score_internal_batch;
     files both ways; the streaming PQ encode at 100,000 rows; 5,000 rows
     on 8 shards, some holding none; per-batch device time sharded against
     single-device. Its wall is held to 120 s.

  8. The sharded IVF engine (parallel/sharded_ivf.py) on path 7's mesh:
     path 4's IVF-SQ, residual IVF-SQ, IVF-BQ, 4-bit IVF-PQ and residual
     IVF-OPQ (README geometry) and path 5's residual IVF-BQ and IVF-SQ L1
     wrapped (round-robin buckets; 1,139 buckets are 285 a shard and one pad
     bucket); exact and approx at nprobe 32 over 256 / 512 buckets,
     indexed and compact, IVF-SQ at k = 600 (K3), counted per search (one
     launch a shard) and held against plain on the last shard's last launch;
     every bucket equal to the single-device search (plain to the bit,
     residual within rtol 1e-5 / atol 1e-4), indexed == compact, recall;
     ShardedIVF.encode of IVF-SQ and residual IVF-SQ from path 4's corpus
     and their files both ways; a PipelinedSearcher over the sharded IVF-SQ
     rescored to f32; 5,000 rows in 4 buckets on 8 shards; per-batch device
     time sharded against single-device. Its wall is held to 120 s.

  9. The 10M anchor harness (bench/bench_10m.py, the twin of the JAX
     package's tools/bench_10m.py) through its main() at 5,000,000 x 768
     (the anchor's 10M cut for the smoke's time) of the JAX harness's
     realistic corpus (--dist realistic --normalize --opq --ivf
     --ivf-residual; Q = 256, k = 10, S = 1024, nlist 1,627),
     its rows made on the card by id (the row kernel, held against plain
     threefry first): every leg present, none FAILED, recall figures in
     [0, 1], each rescored leg at least its coarse leg, the IVF-SQ ladder
     non-decreasing, each TPU kernel it launched held against plain on its
     last launch (the full scans in row blocks), a breakdown of its deepest
     IVF-SQ search, and the same flags at 30,000 rows held to the CPU
     rehearsal (``--rehearse 10m``). Its wall is held to 240 s.

 10. The capacity configuration: the same harness's main() at 100,000,000
     x 768 with the JAX package's capacity flags (--batch 250000 --dist
     realistic --normalize --only none --ivf --ivf-base bq; Q = 256, k =
     10), on one card: the automatic geometry (nlist 32,552, S = 1024),
     every row in exactly one slot, 96 B of planes a slot, the resident
     serving state and the serving peak (at most 16 GiB), each leg's
     recall@10 within 0.03 of the TPU run's (BASELINE.md:585-594, legs
     matched by the scanned fraction), rescored legs at least their coarse
     leg and not falling as R grows, and K10 held against plain on its
     last launch. The row kernel is held at the 100M corpus's last batch
     and its query ids in path 9. Its wall is held to 360 s. Path 10 keeps
     its build (pass 0, the ground truth, the IVF build) on the host.

 11. The quality-first capacity point: the same main() with path 10's
     flags and --ivf-base opq --ivf-residual (BASELINE.md:612-622), on the
     build path 10 kept: IVF-OPQ and residual IVF-OPQ (m = 96) over 4.75 /
     11.86 % of the buckets, rescored to f32 at R = 40-640. Exactly the JAX
     harness's legs in its order (plain OPQ's R = 160 leg twice), each
     index's codes [96, slots] u8 at 96 B a slot held as appended, each
     index's serving peak at most 16 GiB, each leg with a TPU figure
     (BASELINE.md:624-635) within 0.03 of it (plain IVF-OPQ's on a second
     run of that index with the TPU's f32 products, one bf16 pass, which
     its f32 legs must match or beat: ROADMAP F40), rescored legs at least
     their coarse leg and not falling as R grows, every K11 launch on the
     LUT-gather ring, and K11 held against plain on the last launch of each
     LUT word (int8 for plain OPQ, bf16x2 with the additives for OPQr) and
     timed there. Its wall is held to 240 s.

It holds every kernel against its plain PyTorch version on the card at the
shapes of its path (each exact search on both of its selects: the queue at
k <= 64, the radix select above, ktile.exact_geometry), checks the results
against an f32 oracle, and times the
kernels, their plain versions, the PyTorch library call that computes the
same function where there is one (for the searches torch._int_mm, the
epilogue and torch.topk), an f32 matmul + top-k baseline and the two-stage
batches with CUDA events. The kernels line names the select each exact
kernel's timed launches took.

Every phase prints one line; any failed check raises and the exit code is
not 0. The last lines are a JSON object of the kernels, the nvidia-smi name
and power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script fails
before it prints a result.
"""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 42
# Path 1 (SQ-u8): bench.py's configuration.
N, D, Q, K = 100_000, 1024, 256, 10
# Path 2 (BQ + two-stage): dbpedia-entities-openai-1M's shape.
BN, BD, OVERSAMPLING = 1_000_000, 1536, 4.0
R = int(K * OVERSAMPLING)

SRC = "quantization_tpu_torch/csrc/"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "sq_scores": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:748"),
    "sq_search_exact": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:433"),
    "sq_search_approx": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:353"),
    "sq_score_candidates": ("gather_kernels.cu",
                            "quantization_tpu/ops/pallas/gather.py:135"),
    "bq_search_approx": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:509"),
    "bq_search_exact": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:605"),
    "bq_scores": ("bq_kernels.cu",
                  "quantization_tpu/ops/pallas/bq_kernel.py:671 and :716"),
}
for _sfx in ("", "_4bit"):  # one kernel per name; the 4-bit rows time KC = 16
    KERNELS.update({
        "pq_scores" + _sfx: ("pq_kernels.cu",
                             "quantization_tpu/ops/pallas/pq_kernel.py:943 and :962"),
        "pq_search_exact" + _sfx: ("pq_kernels.cu",
                                   "quantization_tpu/ops/pallas/pq_kernel.py:866"),
        "pq_search_approx" + _sfx: ("pq_kernels.cu",
                                    "quantization_tpu/ops/pallas/pq_kernel.py:791"),
    })
# The 4-bit rows time the int8 LUT, which runs K8a, K7b and K7a on the
# one-hot route (K8a: pq4_scores_ws_kernel).
KERNELS["pq_scores_4bit"] = ("pq4_mma_kernels.cu",
                             "quantization_tpu/ops/pallas/pq_kernel.py:943")
KERNELS["pq_search_exact_4bit"] = ("pq4_mma_kernels.cu",
                                   "quantization_tpu/ops/pallas/pq_kernel.py:866")
KERNELS["pq_search_approx_4bit"] = ("pq4_mma_kernels.cu",
                                    "quantization_tpu/ops/pallas/pq_kernel.py:791")
# K8 with 4-bit codes and the bf16 LUT: one-hot bf16 products, the sums on
# the CUDA cores in the plain version's order.
KERNELS["pq_scores_4bit_bf16"] = ("pq4_mma_kernels.cu",
                                  "quantization_tpu/ops/pallas/pq_kernel.py:962")
# K7a again, as the coarse stage of OPQ -> f32 two-stage (k = R).
KERNELS["pq_search_approx_opq"] = KERNELS["pq_search_approx"]
# Path 4 (IVF): the indexed scans, and the dense kernels again as the
# compact scans of the probed buckets, with the residual additives.
KERNELS.update({
    "sq_search_indexed_exact": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:664"),
    "sq_search_indexed_approx": ("sq_kernels.cu",
                                 "quantization_tpu/ops/pallas/sq_kernel.py:628"),
    "bq_search_indexed": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:328"),
    "pq_search_indexed": ("pq_kernels.cu", "quantization_tpu/ops/pallas/pq_kernel.py:582"),
    # K11 of the 4-bit IVF-PQ index (int8 LUT): the one-hot route.
    "pq_search_indexed_4bit": ("pq4_mma_kernels.cu",
                               "quantization_tpu/ops/pallas/pq_kernel.py:582"),
})
for _name in ("sq_search_exact", "sq_search_approx", "bq_search_exact", "pq_search_exact",
              "pq_search_approx"):
    KERNELS[_name + "_ivf"] = KERNELS[_name]
# Path 5: residual IVF-BQ (value queries against the residual sign bits,
# with the bucket term corr) and SQ L1.
KERNELS.update({
    "bq_search_exact_res": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:576"),
    "bq_search_approx_res": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:509"),
    "bq_search_indexed_res": ("bq_kernels.cu",
                              "quantization_tpu/ops/pallas/bq_kernel.py:328"),
    "sq_scores_l1": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:748"),
})
# K10 with a value query again, at the serving plan's width (every bucket).
KERNELS["bq_search_indexed_res_serve"] = KERNELS["bq_search_indexed_res"]
# The small batch at which K1-K3 are timed beside Q.
Q_SMALL = 32

# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989.4e12
# The single-bit product wgmma m64n64k256 b1.b1.and.popc, the fastest unit
# the card has for a binary dot: NVIDIA publishes no rate, and it issued at
# the s8 m64n64k32 instruction rate, 5.5e7 products a second per SM (NVIDIA
# H100 80GB HBM3 at 700 W, `scan_ab.py --only rate`; PERF.md), each
# 64 x 64 x 256 AND-popcount bit products. The BQ sign-query bounds count
# the binary dot at this rate (K6, K5a, K5c and K10 run on it); the +-1
# int8 count at the int8 peak, the bound before, is printed beside it.
B1_PRODUCTS_PER_S_PER_SM = 5.5e7
B1_BITS_PER_PRODUCT = 64 * 64 * 256
# K12 (L1): the tensor cores have no absolute-difference product, so its
# operations run on one of two units, and its bound takes the faster: the
# __vabsdiffu4 + __dp4a pair of its own design (four byte pairs a pair of
# instructions), at the rate csrc/probe/absdiff_rate.cu measured
# (`scan_ab.py --only rate`; NVIDIA H100 80GB HBM3 at 700 W; PERF.md); or
# thermometer codes through the b1 product, sum |q - c| = sum q + sum c -
# 2 sum_d sum_t [q_d > t][c_d > t] over the 127 levels t of a [0, 127]
# code, Q * N * D * 127 bit products at the b1 rate. Its int8 count (2 Q N D
# at the int8 peak, a unit that cannot compute L1), the bound before, is
# printed beside.
ABSDIFF_PAIRS_PER_S_PER_SM = 1.21e11
L1_LEVELS = 127
# Recall@10 floor of the two-stage indexes on the neighbourhood corpus.
TWO_STAGE_RECALL_MIN = 0.8
# Path 3 (PQ): the repo's PQ target, 1M x 768 DOT, 96 subquantizers x 256
# centroids (BASELINE.md:31,37; README.md:116), and 4-bit PQ at equal bytes
# (192 x 16, BASELINE.md:67,115), on the neighbourhood corpus.
PN, PD, PQ_CHUNK, PQ4_CHUNK = 1_000_000, 768, 8, 4
PQ_CODE_CHECK_ROWS = 20_000
# OPQ -> f32 recall@10 of the CPU rehearsal at 30k rows (--rehearse), and the
# floor the card's run is held to: 0.05 below it, or 0.8 if that is lower.
OPQ_F32_RECALL_REHEARSAL = 0.9371
OPQ_F32_RECALL_MIN = min(OPQ_F32_RECALL_REHEARSAL - 0.05, 0.8)
# int8-LUT exact recall may lose at most this much against the bf16 LUT.
INT8_RECALL_SLACK = 0.02
# Shared-memory bytes an SM serves per clock (32 banks of 4 bytes): a LUT
# gather's peak is 128 / (entry bytes) lookups per clock per SM, since one
# 32-bit load of a [chunk][code][query] table reads the same code for
# 4 int8 (2 bf16) queries. The PQ kernels' own design makes one load per
# lookup, 32 per clock per SM: its floor, printed beside the bound.
SMEM_BYTES_PER_CLOCK_PER_SM = 128
# The LUT-gather lookup loop (csrc/pq_kernels.cuh Lanes): queries a lane's
# 8-byte LUT load serves, by LUT word, and the SASS instructions a lookup its
# loop may take (the loop before the packed words took 4.14 / ~6.25 /
# 10.86). Its issue floor is its instructions at 4 warp instructions a
# clock per SM, 32 lookups each. LOOP_SASS: each entry's count, from the
# build.
LOOKUPS_PER_LOAD = {"int8": 8, "bf16": 4, "bf16x2": 2}
LOOP_SASS_MAX = {"int8": 2.5, "bf16x2": 7.0}
ISSUE_PER_CLOCK_PER_SM = 4 * 32
LOOP_SASS = {}
# The query counts the LUT-gather kernels are also held at (gather_holds).
GATHER_HOLD_QS = (4, 33, 100)
# f32 adds per clock per SM (128 FP32 lanes; 67 TFLOP/s counts an FMA as
# two): the floor of the bf16 one-hot K8's own design, whose products land
# on the tensor cores and whose one add per LUT entry (pairs, groups, the
# running sum) runs on the CUDA cores, printed beside its bound.
FADD_PER_CLOCK_PER_SM = 128
LUT_ENTRY_BYTES = {"int8": 1, "bf16": 2, "bf16x2": 4}
# The one-hot product's rate on the tensor cores for the LUT's own type: an
# int8 LUT multiplies as int8, a bf16 LUT as bf16, and bf16x2 is two bf16
# products.
ONEHOT_OPS_PER_S = {"int8": INT8_OPS_PER_S, "bf16": BF16_FLOPS_PER_S,
                    "bf16x2": BF16_FLOPS_PER_S / 2}
# Path 4 (IVF) on path 3's corpus: per-query probes and the batch-union
# widths of the search ladder (in buckets), the README geometry's nlist and
# bucket size for residual OPQ (README.md:134-136), and the floor of the
# IVF-SQ -> f32 recall@10: the CPU rehearsal's value less 0.05 (--rehearse
# ivf, 30k rows, the same fraction of buckets scanned), or 0.8 if lower.
IVF_NPROBE, IVF_NSCANS = 32, (256, 512)
IVF_README_NLIST, IVF_README_BUCKET = 2048, 512
IVF_SQ_F32_RECALL_REHEARSAL = 0.3098
IVF_SQ_F32_RECALL_MIN = min(IVF_SQ_F32_RECALL_REHEARSAL - 0.05, 0.8)
# The chunked indexed scan is checked with chunks of this many tiles.
IVF_CHECK_CHUNK_TILES = 64
# Path 5: residual IVF-BQ at 1M x 768 on the JAX package's residual-regime
# corpus (tests/test_ivf.py:307-318: 6 centres x 3, sigma 0.3, not
# normalized), the repo's residual-IVF validation scale (BASELINE.md:372-390).
# The recall lift of residual over plain IVF-BQ (all buckets scanned, exact)
# in the CPU rehearsal (--rehearse rbq, 30k rows); the card's lift is held to
# half of it.
RBQ_LIFT_REHEARSAL = 0.1648  # plain 0.0457 -> residual 0.2105, 34 buckets
# Serving: the calibration target, the fresh 256-query batches of the
# pipelined loop and the pipeline depth; the held-out recall may sit this far
# below the calibrated one.
SERVE_TARGET, SERVE_BATCHES, SERVE_DEPTH, SERVE_RECALL_SLACK = 0.9, 16, 8, 0.05
SERVE_IDLE_WINDOWS = 3  # unprofiled pipelined loops the idle share is read from
# Path 6 (harness): the ann-benchmarks CLI on deep-image-96-angular at its
# published size (9,990,000 x 96, angular: DOT on normalised rows; the
# registry entry of bench/ann_data.py) on its seeded synthetic corpus, and
# ivf-sq-f32 on glove-100-angular at its published 1,183,514 x 100.
ANN_DATASET, ANN_COUNT = "deep-image-96-angular", 9_990_000
ANN_IVF_DATASET, ANN_IVF_COUNT = "glove-100-angular", 1_183_514
ANN_FLAGS = ["--test-acc", "--bench", "--query-batch", "256", "--json"]
# test_knn's batches: 25 of 4 of the 100 queries, so the latency percentiles
# come from 25 samples (p99 is the largest); --bench scores or searches all
# 100 queries at once (ivf-sq-f32, through main(), 4 at a time).
ANN_KNN_BATCH = 4
ANN_QUERIES = 100  # the synthetic corpus's queries (AnnBenchmarkData.load's default)
# The deep-image methods, label -> CLI flags, each through the CLI's own
# functions on one loaded corpus (u8 exact with --bench-f32), at 9.99M and
# at 20,000 rows.
ANN_METHODS = {
    "u8": ["--method", "u8"],
    "u8-approx": ["--method", "u8", "--topk-method", "approx"],
    "u8-f32": ["--method", "u8-f32"],
    "bq": ["--method", "bq"],
    "bq-u8": ["--method", "bq-u8"],
    "pq": ["--method", "pq", "--chunk-size", "2"],
}
# The wrappers each method must launch on the card (test_knn searches exact;
# --bench scores, or searches approx through PipelinedSearcher).
ANN_LAUNCHES = {
    "u8": ("sq_search_exact", "sq_scores"),
    "u8-approx": ("sq_search_approx", "sq_scores"),
    "u8-f32": ("sq_search_exact", "sq_search_approx"),
    "bq": ("bq_search_exact", "bq_scores"),
    "bq-u8": ("bq_search_exact", "bq_search_approx", "sq_score_candidates"),
    "pq": ("pq_search_exact", "pq_scores"),
    "ivf-sq-f32": ("sq_search_indexed_exact", "sq_search_indexed_approx"),
}
# The rehearsal: the same methods at 20,000 rows, recall@10 on the CPU
# (python3 chip_smoke.py --rehearse ann; rerun it and update these when the
# CLI, the codecs or the corpus change); the card's run at 20,000 rows is
# held to each within ANN_REHEARSAL_SLACK.
ANN_REHEARSAL_COUNT = 20_000
ANN_RECALL_REHEARSAL = {"u8": 0.7630, "u8-approx": 0.7620, "u8-f32": 0.9990, "bq": 0.1050,
                        "bq-u8": 0.6400, "pq": 0.4200, "ivf-sq-f32": 0.9990}
ANN_REHEARSAL_SLACK = 0.02
# Native host encode (b) at 1,000,000 x 768 on 8 threads.
NATIVE_N, NATIVE_D, NATIVE_THREADS = 1_000_000, 768, 8
# streaming_ingest runs at 1M rows (its default is 10M: cut, PERF.md §4).
STREAMING_N = 1_000_000
# The whole of path 6 keeps to this many seconds of card wall.
HARNESS_WALL_LIMIT_S = 180.0
# Path 7 (sharded engines): a mesh of SHARDS shards on the one card at path
# 2's and path 3's shapes; the streaming PQ encode on path 3's first
# SHARD_PQ_ENCODE_N rows; the score-matrix path at k = SHARD_K_SCORES (past
# the fused caps); the empty-shard phase, EMPTY_N rows on EMPTY_SHARDS
# shards (SQ and PQ: shards 5-7 hold no row, BQ: 3-7); the path's wall
# limit in seconds.
SHARDS = 4
SHARD_PQ_ENCODE_N = 100_000
SHARD_K_SCORES = 1100
EMPTY_SHARDS, EMPTY_N = 8, 5_000
# Path 7's exact-coarse two-stage equals the single-device one on the queries
# whose R coarse candidates agree; they may differ only by a tie across the
# R-th BQ score (ROADMAP F32). All 256 agreed on the H100 runs of this path,
# so at most this many may differ.
TWO_STAGE_DISAGREE_MAX = 8
SHARDED_WALL_LIMIT_S = 120.0
# Path 8 (the sharded IVF engine) on path 7's mesh: path 4's indexes it
# wraps (path 5's residual IVF-BQ and IVF-SQ L1 beside them), and the
# searches of each at nprobe 32 over 256 / 512 buckets, (method, scan, the
# kernel each shard launches); IVF-SQ exact at k = 600 passes the fused cap
# (kk2 = k * max_dup > 1,024), so each shard scores with K3.
SHARDED_IVF_WRAPPED = ("sq", "sq_res", "bq", "pq4", "opq_res_512")
_SQ_SCANS = [("exact", "indexed", "sq_search_indexed_exact"),
             ("approx", "indexed", "sq_search_indexed_approx"),
             ("exact", "compact", "sq_search_exact"), ("approx", "compact", "sq_search_approx")]
SHARDED_IVF_SEARCHES = {
    "sq": _SQ_SCANS,
    "sq_res": _SQ_SCANS,
    "bq": [("exact", "compact", "bq_search_exact"), ("approx", "indexed", "bq_search_indexed"),
           ("approx", "compact", "bq_search_approx")],
    "pq4": [("exact", "compact", "pq_search_exact"), ("approx", "compact", "pq_search_approx")],
    "opq_res_512": [("exact", "compact", "pq_search_exact"),
                    ("approx", "compact", "pq_search_approx")],
    "rbq": [("exact", "compact", "bq_search_exact_res"),
            ("approx", "indexed", "bq_search_indexed_res"),
            ("approx", "compact", "bq_search_approx_res")],
    "l1": [("exact", "compact", "sq_scores_l1")],
}
SHARDED_IVF_K_SCORES = 600
# The pipelined searcher over the sharded IVF-SQ -> f32: batches, depth.
SHARDED_IVF_SERVE_BATCHES, SHARDED_IVF_SERVE_DEPTH = 8, 8
# The searches timed sharded against single-device, (index, method).
SHARDED_IVF_TIMED = [("sq", "exact"), ("sq", "approx"), ("sq_res", "approx"), ("bq", "approx"),
                     ("pq4", "approx"), ("opq_res_512", "approx"), ("rbq", "approx")]
SHARDED_IVF_WALL_LIMIT_S = 120.0


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class Ms(float):
    """A time in ms, with the exact select (ktile.SELECT_LAUNCHES: "queue" or
    "radix") that the timed calls' exact launches took, None for none."""
    select = None


def timed_ms(fn, warmup=3, iters=10, reps=7):
    """Median over ``reps`` runs of the mean time per call of ``iters``
    back-to-back calls, between two CUDA events (an Ms)."""
    from quantization_tpu_torch.ops.kernels import ktile

    before = dict(ktile.SELECT_LAUNCHES)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    out = Ms(statistics.median(runs))
    out.select = "+".join(r for r, n in ktile.SELECT_LAUNCHES.items() if n != before[r]) or None
    return out


def library_time(label, fn, smi):
    """The time of a library yardstick (a composite of PyTorch calls that
    computes what a kernel computes; the port never calls it), or None where
    this torch refuses it (torch._int_mm wants shapes it may not take)."""
    try:
        t = timed_ms(fn)
    except RuntimeError as e:
        say("library", f"{label}: not timed ({e})")
        return None
    say("library", f"{label}: {t:.4f} ms per {Q}-query batch on {smi}")
    return t


def sq_composite(qcodes, qoff, codes, voff, mult, k, corr=None):
    """The library composite of an exact SQ search over ``codes``' rows: one
    cuBLAS int8 GEMM (torch._int_mm), the affine epilogue (and the
    residual-IVF corr, [Q, rows]) and torch.topk."""
    m = torch.as_tensor(mult, dtype=torch.float32, device=qcodes.device).reshape(-1, 1)

    def run():
        acc = torch._int_mm(qcodes, codes.t())
        s = m * acc.to(torch.float32) + qoff[:, None] + voff[None, :]
        return torch.topk(s if corr is None else s + corr, k, dim=1)

    return run


def value_composite(planes, aff, rowadd, corr, k, rows=None, n_valid=None):
    """The library composite of a value-query BQ search (K5a / K10 with a
    value query) over the planes' columns ``rows`` (all, or the first
    ``n_valid``): the 0/1 planes expanded once to int8 rows (outside the
    timed call, as K6's yardstick expands its signs), then torch._int_mm, the
    kOnce epilogue (mult * acc + qb in f64, rounded once), rowadd, corr
    ([Q, rows], expanded) and torch.topk."""
    from quantization_tpu_torch.ops import bq as bq_ops

    cols = planes if rows is None else planes[:, rows]
    ra = rowadd if rows is None else rowadd[rows]
    if n_valid is not None:
        cols, ra, corr = cols[:, :n_valid], ra[:n_valid], corr[:, :n_valid]
    bits = torch.cat([bq_ops.unpack_bits(cols[:, c:c + 65_536]).T
                      for c in range(0, cols.shape[1], 65_536)]).contiguous()
    qs, mult, qb = aff
    m = torch.as_tensor(mult, device=qs.device).reshape(-1, 1).double()
    b = qb.reshape(-1, 1).double()

    def run():
        acc = torch._int_mm(qs, bits.t())
        return torch.topk((m * acc.double() + b).float() + ra[None, :] + corr, k, dim=1)

    return run


def sign_composite(qpm, cpm, sign, k):
    """The library composite of an exact sign-query BQ search: torch._int_mm
    of the +-1 int8 signs (K6's yardstick: the rows expanded once, outside
    the timed call), times the sign, as f32, and torch.topk."""
    def run():
        acc = torch._int_mm(qpm, cpm.t())
        return torch.topk((acc if sign > 0 else acc.neg_()).float(), k, dim=1)

    return run


PROBE = "quantization_tpu_torch/csrc/probe/select_split.cu"
APPROX_PROBE = "quantization_tpu_torch/csrc/probe/approx_split.cu"
SCORES_PROBE = "quantization_tpu_torch/csrc/probe/scores_split.cu"
_probe = {}
_aprobe = {}
_sprobe = {}


def start_select_probe(nvcc):
    """Starts building the scan / select probe (csrc/probe/select_split.cu),
    the approx split probe (csrc/probe/approx_split.cu) and the K8 probe
    (csrc/probe/scores_split.cu; the last two with the library's
    -fmad=false), beside the library's build."""
    for state, src, flags in ((_probe, PROBE, []), (_aprobe, APPROX_PROBE, ["-fmad=false"]),
                              (_sprobe, SCORES_PROBE, ["-fmad=false"])):
        exe = os.path.join("quantization_tpu_torch", "_build",
                           os.path.splitext(os.path.basename(src))[0])
        os.makedirs(os.path.dirname(exe), exist_ok=True)
        state["exe"] = exe
        state["proc"] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *flags,
             "-o", exe, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def approx_split(smi):
    """Runs the approx probe once and prints its [approx] lines: for K9a,
    dense K2 at Q = 256 and 32 and K10-value at the serving width, pass 1,
    its scan alone and the combine of the warp-specialized body
    (approx_ws_kernel) at span-block items in place and at 2048-row items
    with the combine, at its other query tile, and of approx_parts_kernel
    (the body where the query tile does not fit) at 2048-row items, the
    reference; the same for the sign-query K5a at 1M x 1536 and K10 over 256
    tiles of 768 dims on bq_sign_approx_ws_kernel against
    bq_sign_approx_kernel; for 4-bit int8 K7a at 1M x 192 chunks,
    pq4_approx_ws_kernel (at Q = 256, and at Q = 32 in both its geometries)
    against approx_parts_kernel<NibbleRows>, whose scan it splits into the
    one-hot expansion and the products; requires every
    warp-specialized candidate set equal to its reference. Then the K8
    probe's [K8] lines: 4-bit int8 K8 at 1M x 192 chunks, Q = 256, 100 and
    32, the replaced scores_kernel<NibbleRows> (at Q = 256 split into its
    scan, the products alone, the expansion alone and its stores alone)
    against pq4_scores_ws_kernel (the kernel, its products alone and its
    products and epilogue without the stores), whose scores must equal the
    replaced kernel's to the bit. {(kernel, design, part): line} of the
    searches."""

    def run_probe(state, what):
        proc = state["proc"]
        out, _ = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"the {what} probe builds: {out[-2000:]}")
        run = subprocess.run([state["exe"]], capture_output=True, text=True, timeout=300)
        require(run.returncode == 0, f"the {what} probe runs: {run.stderr[-2000:]}")
        return [json.loads(ln) for ln in run.stdout.splitlines() if ln.startswith("{")]

    lines = run_probe(_aprobe, "approx")
    k8 = run_probe(_sprobe, "K8")
    for ln in k8:
        if ln["design"] == "scores_parent":
            parts = "".join(f", {x} {ln[x + '_ms']:.4f}" for x in
                            ("scan", "products", "expand", "stores") if x + "_ms" in ln)
            say("K8", f"4-bit int8 Q={ln['q']}: scores_kernel<NibbleRows> (replaced) "
                f"{ln['ms']:.4f} ms{parts} (csrc/probe/scores_split.cu) on {smi}")
        else:
            require(ln["equal"], f"K8 Q={ln['q']} {ln['design']}: pq4_scores_ws_kernel's "
                    "scores equal the replaced kernel's to the bit")
            say("K8", f"4-bit int8 Q={ln['q']}: pq4_scores_ws_kernel<{ln['tq']}, {ln['nb']}> "
                f"({ln['stages']} stages, {ln['smem']} bytes) {ln['ms']:.4f} ms, products "
                f"alone {ln['scan_ms']:.4f}, products and epilogue {ln['tile_ms']:.4f}, equal "
                f"(csrc/probe/scores_split.cu) on {smi}")
    require(len(k8) == 7, f"the K8 probe's 7 lines ({len(k8)})")
    split = {}
    for ln in lines:
        if "equal" in ln:
            require(ln["equal"], f"{ln['kernel']} {ln['design']} {ln['part']}: the "
                    "warp-specialized candidates equal the reference body's")
        split[ln["kernel"], ln["design"], ln["part"]] = ln
        design = ln["design"]
        body = ("approx_parts_kernel, queries in the ring" if design == "parts" else
                "bq_sign_approx_kernel, 64 queries a block in the ring" if design == "sign_parts"
                else f"bq_sign_approx_ws_kernel, {design[7:]} queries a block, "
                f"{ln['slots']} box slots" if design.startswith("sign_ws") else
                "approx_parts_kernel<NibbleRows>, the one-hot rows expanded in shared memory "
                f"(the expansion alone {ln.get('expand_ms', 0):.4f} ms, the products alone "
                f"{ln.get('products_ms', 0):.4f})" if design == "onehot_parts" else
                f"pq4_approx_ws_kernel, A in registers, {ln['tq']} queries and {ln['nb']} m64 "
                f"blocks a warpgroup, {ln['stages']} stages" if design.startswith("onehot_ws") else
                f"approx_ws_kernel, {design[2:]} queries a block, {ln['stages']} stages")
        say("approx", f"{ln['kernel']}, {body}, {ln['part']}-row items "
            f"({ln['blocks_per_sm']} blocks a SM, {ln['smem']} bytes): pass 1 "
            f"{ln['pass1_ms']:.4f} ms, scan alone {ln['scan_ms']:.4f}, combine "
            f"{ln['combine_ms']:.4f}, pass 1 + combine {ln['pass1_ms'] + ln['combine_ms']:.4f} "
            f"(csrc/probe/approx_split.cu) on {smi}")
    require(len(split) == 27, f"the approx probe's 27 splits ({sorted(split)})")
    return split


def select_probe():
    """The probe's lines, run once: the scans of K1 and K5c without their
    select, in each route's geometry ({(kernel, route): scan ms}), and the
    exact kernels' blocks a SM."""
    if "out" not in _probe:
        proc = _probe["proc"]
        out, _ = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"the select probe builds: {out[-2000:]}")
        run = subprocess.run([_probe["exe"]], capture_output=True, text=True, timeout=300)
        require(run.returncode == 0, f"the select probe runs: {run.stderr[-2000:]}")
        _probe["out"] = [json.loads(ln) for ln in run.stdout.splitlines() if ln.startswith("{")]
        for line in _probe["out"]:
            if line["probe"] == "occupancy":
                say("select", f"{line['kernel']} kk={line['kk']}: {line['smem']} bytes of "
                    f"shared memory, {line['blocks_per_sm']} blocks a SM")
                if line["kernel"] in ("search_queue_kernel", "pq4_queue_kernel"):
                    require(line["blocks_per_sm"] == 2, "the queue select holds two blocks a SM")
    return {(ln["kernel"], ln["route"]): ln["scan_ms"] for ln in _probe["out"]
            if ln["probe"] == "select_split"}


def say_select_split(kname, label, kernel_ms, smi):
    """A kernel's time split by the probe into its scan and its select."""
    split = select_probe()
    route = kernel_ms.select
    scan = split[(kname, route)]
    say("select", f"{label} ({route} select): kernel {kernel_ms:.4f} ms = scan {scan:.4f} ms "
        f"(csrc/probe/select_split.cu, the same geometry) + select {kernel_ms - scan:.4f} ms; "
        f"the other geometry's scan: " + ", ".join(
            f"{r} {t:.4f} ms" for (k, r), t in sorted(split.items()) if k == kname and r != route)
        + f"; on {smi}")


def graph_ms(fn, iters=20, reps=7):
    """Device time per call of ``fn``, for kernels shorter than their
    wrapper's host work: ``iters`` calls captured in one CUDA graph, whose
    replays are timed between CUDA events (median of ``reps``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return timed_ms(graph.replay, warmup=2, iters=1, reps=reps) / iters


def plain_ms(fn):
    """Few reps for the plain versions, which take up to a second a call."""
    return timed_ms(fn, warmup=1, iters=1, reps=3)


def wall_ms(fn, reps=7):
    """Median host wall per call, each ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their unit's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bq_bound(nbytes, q, rows, dim):
    """((bound_ms, bound_by), int8_ms) of a BQ sign-query kernel: the larger
    of its bytes and its q * rows * dim bit products at the measured b1
    wgmma rate; and the same dot as +-1 int8 multiply-adds at the int8 peak."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b1_per_s = B1_PRODUCTS_PER_S_PER_SM * sms * B1_BITS_PER_PRODUCT
    return (bound(nbytes, q * rows * dim, b1_per_s),
            2 * q * rows * dim / INT8_OPS_PER_S * 1e3)


def l1_bound(nbytes, q, rows, d):
    """((bound_ms, bound_by), int8_ms, pairs_ms, thermo_ms) of K12: the
    larger of its bytes and the cheaper of its two operation floors, the
    absolute-difference pairs (q * rows * d / 4) at the measured pair rate
    and the thermometer bit products (q * rows * d * 127) at the b1 rate;
    and the int8 count of the bound before."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs_ms = q * rows * d / 4 / (ABSDIFF_PAIRS_PER_S_PER_SM * sms) * 1e3
    thermo_ms = q * rows * d * L1_LEVELS / (
        B1_PRODUCTS_PER_S_PER_SM * sms * B1_BITS_PER_PRODUCT) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(pairs_ms, thermo_ms)
    bnd = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bnd, 2 * q * rows * d / INT8_OPS_PER_S * 1e3, pairs_ms, thermo_ms


def pm1_rows(words, dim, chunk=65_536):
    """int8 [N, W*32]: the sign bits of words int32 [N, W] (LSB first) as
    +1 / -1 on the first dim dims and 0 past them, so that a dot of two such
    rows is dim - 2 * Hamming; expanded in chunks of rows."""
    n, w = words.shape
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    out = torch.empty((n, w * 32), dtype=torch.int8, device=words.device)
    for r0 in range(0, n, chunk):
        bits = (words[r0:r0 + chunk, :, None] >> shifts) & 1
        out[r0:r0 + chunk] = (2 * bits - 1).reshape(-1, w * 32).to(torch.int8)
    out[:, dim:] = 0
    return out


def random_operands(n_valid, d, q, gen, dev):
    npad = n_valid + (-n_valid) % 512
    codes = torch.randint(0, 128, (npad, d), generator=gen, device=dev, dtype=torch.int8)
    codes[n_valid:] = 0
    voff = torch.rand(npad, generator=gen, device=dev) * 50.0
    voff[n_valid:] = 0.0
    qcodes = torch.randint(0, 128, (q, d), generator=gen, device=dev, dtype=torch.int8)
    qoff = torch.rand(q, generator=gen, device=dev) * 50.0
    mult = torch.tensor([(2.0 / 127.0) ** 2], device=dev)
    return qcodes, qoff, codes, voff, mult


def clustered(n, q, dim, gen, dev, chunk=100_000):
    """The JAX package's synthetic ANN corpus (bench/ann_data.py:95-131),
    made on the card: 64 gaussian centres with anisotropic spread, rows and
    queries cosine-normalised. Returns (data [n, dim], queries [q, dim])."""
    centers = torch.randn(64, dim, generator=gen, device=dev)
    scales = 0.3 + torch.rand(64, generator=gen, device=dev)

    def rows(count):
        out = torch.empty((count, dim), device=dev)
        for r0 in range(0, count, chunk):
            r1 = min(r0 + chunk, count)
            a = torch.randint(0, 64, (r1 - r0,), generator=gen, device=dev)
            x = torch.randn(r1 - r0, dim, generator=gen, device=dev)
            x.mul_(scales[a, None] * 0.5).add_(centers[a])
            out[r0:r1] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return out

    return rows(n), rows(q)


def neighbourhoods(n, q, dim, gen, dev, size=64, chunk=100_000):
    """A corpus whose sign bits rank neighbours, made on the card: n / size
    gaussian centres on the unit sphere; each row and query is a random
    centre plus isotropic noise of the same norm, normalised. A query's
    true top-10 lie among the ~64 rows of its centre (cosine ~0.5, against
    0 +- 0.03 for the rest), and ranking those takes more than their sign
    bits. Returns (data [n, dim], queries [q, dim])."""
    nc = n // size
    centers = torch.randn(nc, dim, generator=gen, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)

    def rows(count):
        out = torch.empty((count, dim), device=dev)
        for r0 in range(0, count, chunk):
            r1 = min(r0 + chunk, count)
            a = torch.randint(0, nc, (r1 - r0,), generator=gen, device=dev)
            x = torch.randn(r1 - r0, dim, generator=gen, device=dev)
            x.mul_(dim ** -0.5).add_(centers[a])
            out[r0:r1] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return out

    return rows(n), rows(q)


def ties_at(scores, r):
    """Mean over queries of the rows whose score equals the r-th best."""
    kth = torch.topk(scores, r, dim=1).values[:, -1:]
    return float((scores == kth).sum(1).float().mean())


def check_topk(vals, ids, want_vals, scores, n_valid, what):
    """Values equal the plain top-k exactly; every id is a distinct valid row
    whose plain score is the value claimed for its slot (so ids differ from
    the plain ones only among tied scores); an empty slot (id -1) holds
    -inf. Returns max |error| over the live slots."""
    require(torch.equal(vals, want_vals), f"{what}: values equal plain top-k")
    live = ids >= 0
    require(bool((ids[live] < n_valid).all()), f"{what}: ids < n_valid")
    require(bool(torch.isneginf(vals[~live]).all()), f"{what}: empty slots hold -inf")
    got = torch.gather(scores, 1, ids.clamp(min=0).long())
    require(torch.equal(got[live], vals[live]), f"{what}: score[id] == value")
    srt = torch.sort(ids, dim=1).values  # the -1 of empty slots come first
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    require(not bool(dup.any()), f"{what}: distinct ids")
    return float((got[live] - vals[live]).abs().max()) if bool(live.any()) else 0.0


def reset_all(*modules):
    for m in modules:
        m.reset_launches()


def require_sign_ws(what, launches, names):
    """Every launch of the sign-query K5a / K10 (``names`` that ``launches``
    shows moved, one at least) ran the warp-specialized body
    (csrc/bq_kernels.cu bq_sign_approx_ws_kernel, counted in
    bq_kernel.SIGN_WS_LAUNCHES): at these shapes its query tile fits."""
    from quantization_tpu_torch.ops.kernels import bq_kernel

    moved = [n for n in names if launches.get(n)]
    require(moved, f"{what}: launched {' or '.join(names)}")
    for n in moved:
        ws = bq_kernel.SIGN_WS_LAUNCHES[n]
        require(ws == launches[n], f"{what}: every {n} launch ({launches[n]}) ran "
                f"bq_sign_approx_ws_kernel ({ws})")
    say("sign-ws", f"{what}: " + ", ".join(f"{n} {launches[n]} launches" for n in moved)
        + ", every one on bq_sign_approx_ws_kernel")


def counts(*modules):
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def recall(ids, oracle, k):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, oracle)]))


def profile(label, fn, reps=5):
    """One call path, three ways: the host wall per call (each call ending in
    a sync), the device span per call of back-to-back calls between CUDA
    events (host gaps excluded), and torch.profiler's device time per kernel
    (the profiler's sum can fall short of the events' span: it is printed,
    not used for the idle share)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wall = wall_ms(fn)
    span = timed_ms(fn, warmup=1, iters=5, reps=3)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    say("profile", f"{label}: host wall {wall:.4f} ms per call, device span "
        f"{span:.4f} ms back to back (idle share of the wall "
        f"{100 * max(0.0, 1 - span / wall):.1f} %), profiler kernel sum {busy:.4f} ms")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        say("profile", f"  {e.key[:70]}: {e.self_device_time_total / 1e3 / reps:.4f} ms")


class ClockSampler:
    """nvidia-smi's SM clock and power draw every 100 ms while the block
    runs; the process is stopped when it ends."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((clock, power))
        return False

    def summary(self):
        if not self.samples:
            return "no nvidia-smi samples"
        clocks = sorted(c for c, _ in self.samples)
        return (f"SM clock min {clocks[0]:.0f} / median {statistics.median(clocks):.0f} "
                f"MHz, power draw max {max(p for _, p in self.samples):.0f} W "
                f"({len(self.samples)} samples)")


def sq_path(dev, smi, do_profile):
    """Path 1: the SQ-u8 kernels against plain, then the SQ main path."""
    from quantization_tpu_torch import (
        DistanceType, ScalarQuantizerU8, VectorParameters, pairwise,
    )
    from quantization_tpu_torch.ops.kernels import sq_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    dt = DistanceType.DOT
    qcodes, qoff, codes, voff, mult = random_operands(N, D, Q, gen, dev)
    kw = dict(distance_type=dt, n_valid=N)
    plain = sq_kernel.sq_scores_plain(qcodes, qoff, codes, voff, mult, **kw)
    got = sq_kernel.sq_scores(qcodes, qoff, codes, voff, mult, **kw)
    torch.cuda.synchronize()
    err = {"sq_scores": float((got - plain).abs().max())}
    if not torch.equal(got, plain):
        ulp = (got.view(torch.int32).long() - plain.view(torch.int32).long()).abs().max()
        say("K3", f"FAIL: differs from plain by up to {int(ulp)} ulp "
            "(the epilogue must round like plain torch: no FMA contraction)")
        require(False, "K3 equals plain to the bit")
    say("K3", f"sq_scores [{Q}, {N}] x D={D}: equal to plain to the bit")

    err["sq_search_exact"] = 0.0
    for k in (10, 100, 1024):
        want_v, _ = sq_kernel.merge_exact(
            plain, torch.arange(N, device=dev, dtype=torch.int32).expand(Q, N), k
        )
        v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=k, mode="exact", **kw)
        e = check_topk(v, i, want_v, plain, N, f"K1 k={k}")
        err["sq_search_exact"] = max(err["sq_search_exact"], e)
        say("K1", f"exact k={k}: values equal plain top-k, ids equal up to ties")

    # The adversarial class-collision case (tests/test_pallas_kernels.py:388):
    # the 10 best rows all in one stride class, ids 0, 128, ..., 1152.
    n_adv = 3000
    aq, aqo, ac, av, _ = random_operands(n_adv, 256, 2, gen, dev)
    ac.zero_()
    aq.zero_()
    av[:n_adv] = torch.rand(n_adv, generator=gen, device=dev)
    top = torch.arange(10, device=dev) * 128
    av[top] = 1000.0 + torch.arange(10, device=dev, dtype=torch.float32)
    one = torch.ones(1, device=dev)
    v, i = sq_kernel.sq_search(aq, aqo, ac, av, one, distance_type=dt,
                               n_valid=n_adv, k=10, mode="exact")
    want = top.flip(0).to(torch.int32).expand(2, 10)
    require(torch.equal(i, want), "K1 adversarial: ids of the 10 planted rows")
    say("K1", "adversarial class collision: the 10 planted rows, in order")

    # k > n_valid: every valid row, then -inf / -1 (ROADMAP F11, repaired).
    n_small, k_big = 600, 1000
    sq_, so_, sc_, sv_, sm_ = random_operands(n_small, 256, 2, gen, dev)
    splain = sq_kernel.sq_scores_plain(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                                       n_valid=n_small)
    want_v, _ = sq_kernel.merge_exact(
        splain, torch.arange(n_small, device=dev, dtype=torch.int32).expand(2, n_small),
        k_big,
    )
    v, i = sq_kernel.sq_search(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                               n_valid=n_small, k=k_big, mode="exact")
    check_topk(v, i, want_v, splain, n_small, "K1 k>n_valid")
    require(int((i >= 0).sum(1).min()) == n_small, "K1 k>n_valid: every row returned")
    say("K1", f"k={k_big} > n_valid={n_small}: all rows, then -inf / -1")

    pv, _ = sq_kernel.sq_search_plain(qcodes, qoff, codes, voff, mult, k=K,
                                       mode="approx", **kw)
    v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=K, mode="approx", **kw)
    e = check_topk(v, i, pv, plain, N, "K2")
    ex_v, ex_i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=K, mode="exact", **kw)
    overlap = torch.tensor([
        len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(i.cpu(), ex_i.cpu())
    ])
    require(float(overlap.min()) >= 0.8, f"K2 overlap with exact >= 0.8 per query "
            f"(min {float(overlap.min())})")
    err["sq_search_approx"] = e
    say("K2", f"approx k={K}: pairs equal plain scores, values equal plain approx, "
        f"overlap with exact min {float(overlap.min()):.2f} mean {float(overlap.mean()):.3f}")
    del plain, got

    # ---------------------------------------------- SQ main path, public API
    rng = np.random.default_rng(SEED)
    data = rng.random((N, D), dtype=np.float32) * 2.0 - 1.0
    queries = rng.random((Q, D), dtype=np.float32) * 2.0 - 1.0
    params = VectorParameters(D, N, DistanceType.DOT, False)
    sq_kernel.reset_launches()
    t0 = time.perf_counter()
    enc = ScalarQuantizerU8.encode(data, params)  # on the card by default
    eq = enc.encode_query(queries)
    s_ex, i_ex = enc.top_k(eq, K)
    s_ap, i_ap = enc.top_k(eq, K, method="approx")
    scores = enc.score_batch(eq)
    with tempfile.TemporaryDirectory() as tmp:
        enc.save(os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"))
        enc2 = ScalarQuantizerU8.load(
            os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"), params)
    s_re, i_re = enc2.top_k(enc2.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: sq_kernel.LAUNCHES[n]
                for n in ("sq_scores", "sq_search_exact", "sq_search_approx")}
    say("sq-main", f"encode + queries + exact/approx top-{K} + score_batch + save/load "
        f"+ search in {wall:.2f} s; launches {launches}")
    for kname, n in launches.items():
        require(n > 0, f"SQ main path launched {kname}")

    require(enc.device.type == "cuda", "encode places the codes on the card by default")
    require(s_ex.shape == (Q, K) and i_ex.shape == (Q, K), "top_k shapes")
    require(tuple(scores.shape) == (Q, N), "score_batch shape")
    require(bool(np.isfinite(s_ex).all() and np.isfinite(s_ap).all()), "finite scores")
    require(bool(torch.isfinite(scores).all()), "finite score_batch")
    require(np.array_equal(s_re, s_ex) and np.array_equal(i_re, i_ex),
            "search after save/load equals search before")
    ref_v, _ = torch.topk(scores, K, dim=1)
    require(np.array_equal(s_ex, ref_v.cpu().numpy()), "exact top-k == topk(score_batch)")
    cpu = ScalarQuantizerU8.encode(data, params, device="cpu")
    require(torch.equal(cpu.codes, enc.codes.cpu()), "card codes == CPU codes")
    require(torch.equal(cpu.voffsets, enc.voffsets.cpu()), "card offsets == CPU offsets")
    data_dev = torch.from_numpy(data).to(dev)
    queries_dev = torch.from_numpy(queries).to(dev)
    _, oracle = torch.topk(pairwise(queries_dev, data_dev, DistanceType.DOT), K, dim=1)
    oracle = oracle.cpu().numpy()
    r_ex, r_ap = recall(i_ex, oracle, K), recall(i_ap, oracle, K)
    say("sq-main", f"codes equal the CPU encoder's; recall@{K} vs f32 oracle: "
        f"exact {r_ex:.4f} approx {r_ap:.4f}")
    require(r_ex >= 0.8 and r_ap >= 0.8, "recall@10 >= 0.8")

    # ----------------------------------------------------------------- times
    args = (eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult)
    ms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores(*args, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search(*args, k=K, **kw)),
        "sq_search_approx": timed_ms(
            lambda: sq_kernel.sq_search(*args, k=K, mode="approx", **kw)),
    }
    pms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores_plain(*args, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search_plain(*args, k=K, **kw)),
        "sq_search_approx": timed_ms(
            lambda: sq_kernel.sq_search_plain(*args, k=K, mode="approx", **kw)),
    }
    # The same kernels at a small batch: the first Q_SMALL queries.
    args_s = (eq.codes[:Q_SMALL].contiguous(), eq.offsets[:Q_SMALL].contiguous(), enc.codes,
              enc.voffsets, enc._mult)
    small_ms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores(*args_s, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search(*args_s, k=K, **kw)),
        "sq_search_approx": timed_ms(
            lambda: sq_kernel.sq_search(*args_s, k=K, mode="approx", **kw)),
    }
    # The library yardstick of K3: cuBLAS int8 GEMM (torch._int_mm) and the
    # same affine epilogue, timed together. K1/K2 have none: no PyTorch call
    # fuses a score matrix with its top-k.
    npad = enc.codes.shape[0]

    def int_mm_scores():
        acc = torch._int_mm(eq.codes, enc.codes.t())
        return enc._mult * acc.to(torch.float32) + eq.offsets[:, None] + enc.voffsets[None, :]

    lib_ms = {"sq_scores": None, "sq_search_exact": None, "sq_search_approx": None}
    try:
        same = torch.equal(int_mm_scores(),
                           sq_kernel.sq_scores(*args, distance_type=dt, n_valid=npad))
        lib_ms["sq_scores"] = timed_ms(int_mm_scores)
        say("library", f"torch._int_mm + epilogue {'equals' if same else 'differs from'} "
            "K3's scores")
    except RuntimeError as e:  # a yardstick only: the port never calls it
        say("library", f"torch._int_mm not timed: {e}")
    # K1 / K2's: the same and torch.topk, over the valid rows (the exact
    # top-k; K2's approx has no library form).
    composite = sq_composite(eq.codes, eq.offsets, enc.codes[:N], enc.voffsets[:N], enc._mult,
                             K)
    lib_ms["sq_search_exact"] = lib_ms["sq_search_approx"] = library_time(
        f"torch._int_mm + epilogue + torch.topk (k={K}), K1 / K2's yardstick", composite, smi)
    if lib_ms["sq_search_exact"] is not None:
        same = torch.equal(composite()[0], sq_kernel.sq_search(*args, k=K, **kw)[0])
        say("library", f"its values {'equal' if same else 'differ from'} K1's")
    f32_ms = timed_ms(lambda: torch.topk(queries_dev @ data_dev.T, K, dim=1))
    for kname in ms:
        extra = f", library {lib_ms[kname]:.4f} ms" if lib_ms[kname] else ""
        say("time", f"{kname}: kernel {ms[kname]:.4f} ms, plain {pms[kname]:.4f} ms{extra} "
            f"per {Q}-query batch at N={N} D={D} on {smi}")
    say("time", f"f32 matmul + topk baseline: {f32_ms:.4f} ms per batch at N={N} D={D} "
        f"on {smi}")
    say("time", f"at Q={Q_SMALL}: " + ", ".join(f"{n_} {t:.4f} ms" for n_, t in small_ms.items())
        + f" per batch at N={N} D={D} on {smi}")
    say_select_split("sq_search_exact", f"K1 at N={N} D={D}, k={K}", ms["sq_search_exact"],
                     smi)
    if do_profile:
        profile("SQ top_k exact", lambda: enc.top_k(eq, K))
        profile("SQ top_k approx", lambda: enc.top_k(eq, K, method="approx"))

    # Bounds at the timed shapes: codes, offsets and queries read once, the
    # output written once; Q * N * D int8 multiply-adds (2 ops each).
    in_bytes = N * D + N * 4 + Q * D + Q * 4
    ops = 2 * Q * N * D
    bounds = {
        "sq_scores": bound(in_bytes + Q * N * 4, ops, INT8_OPS_PER_S),
        "sq_search_exact": bound(in_bytes + Q * K * 8, ops, INT8_OPS_PER_S),
        "sq_search_approx": bound(in_bytes + Q * K * 8, ops, INT8_OPS_PER_S),
    }
    recs = [dict(name=n, launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=pms[n], bound=bounds[n], library_ms=lib_ms[n]) for n in ms]
    return recs, {"f32_ms": f32_ms, "recall_exact": r_ex, "recall_approx": r_ap,
                  "small_batch_ms": small_ms}


def bq_path(dev, smi, do_profile):
    """Path 2: BQ + two-stage retrieval at 1M x 1536, then every new kernel
    against its plain version at the path's shapes."""
    from quantization_tpu_torch import (
        BinaryQuantizer, DistanceType, ExactRescorer, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, ktile, sq_kernel

    mods = (sq_kernel, gather, bq_kernel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    t0 = time.perf_counter()
    data_dev, queries_dev = clustered(BN, Q, BD, gen, dev)
    data = data_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    say("bq-data", f"{BN} x {BD} clustered, normalised rows made on the card and copied "
        f"to the host in {time.perf_counter() - t0:.1f} s")
    params = VectorParameters(BD, BN, DistanceType.DOT, False)

    # ------------------------------------------------ BQ main path, public API
    reset_all(*mods)
    t0 = time.perf_counter()
    bq = BinaryQuantizer.encode(data, params)  # on the card by default
    t_bq = time.perf_counter() - t0
    sq = ScalarQuantizerU8.encode(data, params)
    t_sq = time.perf_counter() - t0 - t_bq
    two = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING)  # coarse approx: K5a
    s_a, i_a = two.top_k(two.encode_query(queries), K)
    two_e = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING, coarse_method="exact")
    s_e, i_e = two_e.top_k(two_e.encode_query(queries), K)
    two_x = TwoStageIndex(bq, ExactRescorer(data_dev, DistanceType.DOT, False),
                          oversampling=OVERSAMPLING)
    s_x, i_x = two_x.top_k(two_x.encode_query(queries), K)
    beq = bq.encode_query(queries)
    s_b, i_b = bq.top_k(beq, K)  # exact coarse alone: K5c
    scores = bq.score_batch(beq)  # K6
    with tempfile.TemporaryDirectory() as tmp:
        bq.save(os.path.join(tmp, "bq.bin"), os.path.join(tmp, "bq.json"))
        bq2 = BinaryQuantizer.load(os.path.join(tmp, "bq.bin"),
                                   os.path.join(tmp, "bq.json"), params)
    s_re, i_re = TwoStageIndex(bq2, sq, oversampling=OVERSAMPLING).top_k(
        two.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(*mods)
    say("bq-main", f"BQ encode {t_bq:.2f} s + SQ encode {t_sq:.2f} s + two-stage "
        f"approx/exact/f32 + BQ top-{K} + score_batch + save/load + search in {wall:.2f} s; "
        f"launches {launches}")
    for kname in ("sq_score_candidates", "bq_search_approx", "bq_search_exact", "bq_scores"):
        require(launches[kname] > 0, f"two-stage main path launched {kname}")
    require_sign_ws("two-stage main path", launches, ("bq_search_approx",))

    require(bq.device.type == "cuda" and sq.device.type == "cuda",
            "encode places the codes on the card by default")
    require(tuple(bq.planes.shape) == (48, 1_001_472), "BQ planes [48, 1001472]")
    for name, s, i in (("BQ->SQ approx", s_a, i_a), ("BQ->SQ exact", s_e, i_e),
                       ("BQ->f32", s_x, i_x), ("BQ", s_b, i_b)):
        require(s.shape == (Q, K) and i.shape == (Q, K), f"{name}: shapes")
        require(bool(np.isfinite(s).all()) and bool(((i >= 0) & (i < BN)).all()),
                f"{name}: finite scores, valid ids")
    require(tuple(scores.shape) == (Q, BN) and bool(torch.isfinite(scores).all()),
            "BQ score_batch shape and values")
    require(np.array_equal(s_re, s_a) and np.array_equal(i_re, i_a),
            "two-stage search after BQ save/load equals search before")
    seq = sq.encode_query(queries)
    for name, s, i in (("approx", s_a, i_a), ("exact", s_e, i_e)):
        want = gather.sq_score_candidates_plain(
            seq.codes, seq.offsets, sq.codes, sq.voffsets, torch.from_numpy(i).to(dev),
            sq._mult, distance_type=DistanceType.DOT, n_valid=BN)
        require(np.array_equal(s, want.cpu().numpy()),
                f"BQ->SQ {name}: final scores == plain SQ score_candidates of the ids")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    rec = {"bq": recall(i_b, oracle, K), "bq_sq_approx": recall(i_a, oracle, K),
           "bq_sq_exact": recall(i_e, oracle, K), "bq_f32": recall(i_x, oracle, K)}
    say("bq-main", "recall@10 vs the f32 oracle (TF32 off): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    require(rec["bq_sq_approx"] >= rec["bq"] and rec["bq_sq_exact"] >= rec["bq"],
            "BQ->SQ recall >= BQ alone")

    # ------------------------------- the new kernels against plain, on the card
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=BD, n_valid=BN)
    qw, planes = beq.planes, bq.planes
    err = {}
    plain = bq_kernel.bq_scores_plain(qw, planes, **kw)
    got = bq_kernel.bq_scores(qw, planes, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, plain), "K6 equals plain to the bit")
    require(torch.equal(torch.signbit(got), torch.signbit(plain)),
            "K6: the sign of every score, zeros included, as plain's")
    err["bq_scores"] = float((got - plain).abs().max())
    zeros = int((plain == 0).sum())
    say("K6", f"bq_scores [{Q}, {BN}] x dim={BD}: equal to plain to the bit, sign bits "
        f"too ({zeros} zero scores, every one +0.0)")
    # The library yardstick of K6: torch._int_mm of the +-1 int8 query and row
    # signs (0 past dim), times the sign, as f32; the rows are expanded once,
    # outside the timed call. The port never calls it.
    sign = bq_kernel.metric_sign(DistanceType.DOT, False)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    cpm = pm1_rows(planes[:, :BN].t(), BD)
    qpm = pm1_rows(qw, BD)
    ev1.record()
    ev1.synchronize()
    expand_ms = ev0.elapsed_time(ev1)

    def int_mm_bq():
        acc = torch._int_mm(qpm, cpm.t())
        return (acc if sign > 0 else acc.neg_()).float()

    lib_bq = None
    try:
        lib_out = int_mm_bq()
        require(torch.equal(lib_out, got) and torch.equal(torch.signbit(lib_out),
                                                          torch.signbit(got)),
                "torch._int_mm of the +-1 signs equals K6's scores")
        del lib_out
        lib_bq = timed_ms(int_mm_bq)
        say("library", f"torch._int_mm of the +-1 signs, times the sign, as f32, equals "
            f"K6's scores: {lib_bq:.4f} ms per {Q}-query batch, beside the rows' expansion "
            f"to +-1 int8 [{BN}, {cpm.shape[1]}] once, {expand_ms:.4f} ms, on {smi}")
    except RuntimeError as e:  # a yardstick only: the port never calls it
        if "check failed" in str(e):
            raise
        say("library", f"torch._int_mm not timed: {e}")
    del got, cpm, qpm
    tied = ties_at(plain, R)
    err["bq_search_exact"] = 0.0
    ids_all = torch.arange(BN, device=dev, dtype=torch.int32).expand(Q, BN)
    for k in (10, 40, 1024):
        want_v, _ = ktile.merge_exact(plain, ids_all, k)
        v, i = bq_kernel.bq_search(qw, planes, k=k, **kw)
        e = check_topk(v, i, want_v, plain, BN, f"K5c k={k}")
        err["bq_search_exact"] = max(err["bq_search_exact"], e)
        say("K5c", f"exact k={k}: values equal plain top-k, ids equal up to ties")
    sw, sp = qw[:2], planes[:, : bq_kernel.TILE_N].clone()
    sp[:, 700:] = 0
    skw = dict(kw, n_valid=700)
    splain = bq_kernel.bq_scores_plain(sw, sp, **skw)
    want_v, _ = ktile.merge_exact(splain, ids_all[:2, :700], 1000)
    v, i = bq_kernel.bq_search(sw, sp, k=1000, **skw)
    check_topk(v, i, want_v, splain, 700, "K5c k>n_valid")
    require(int((i >= 0).sum(1).min()) == 700, "K5c k>n_valid: every row returned")
    say("K5c", "k=1000 > n_valid=700: all rows, then -inf / -1")
    pv, pi = bq_kernel.bq_search_plain(qw, planes, k=R, mode="approx", **kw)
    v, i = bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)
    err["bq_search_approx"] = check_topk(v, i, pv, plain, BN, f"K5a k={R}")
    require(torch.equal(i, pi), f"K5a k={R}: ids equal the plain approx's")
    say("K5a", f"approx k={R}: values and ids equal the plain approx, pairs are true scores")
    del plain
    _, cand = bq.top_k_device(beq, R, method="approx")
    cand = cand.clone()
    cand[::7, 3] = -1
    cand[::11, 5] = BN  # a padding row of the SQ codes
    cand[::13, 6] = 2**31 - 1  # past the matrix
    sargs = (seq.codes, seq.offsets, sq.codes, sq.voffsets, cand, sq._mult)
    dk = dict(distance_type=DistanceType.DOT, n_valid=BN)
    want = gather.sq_score_candidates_plain(*sargs, **dk)
    got = gather.sq_score_candidates(*sargs, **dk)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K4 equals plain to the bit")
    live = (cand >= 0) & (cand < BN)
    require(bool(torch.isneginf(got[~live]).all()), "K4: an id outside [0, n) scores -inf")
    err["sq_score_candidates"] = float((got[live] - want[live]).abs().max())
    say("K4", f"sq_score_candidates [{Q}, {R}] x D={sq.codes.shape[1]} of the coarse "
        "candidates: equal to plain to the bit, ids -1, n and 2^31-1 give -inf")

    # ----------------------------------------------------------------- times
    cand = cand.clamp(0, BN - 1)
    sargs = (seq.codes, seq.offsets, sq.codes, sq.voffsets, cand, sq._mult)
    k4_wrapper_ms = timed_ms(lambda: gather.sq_score_candidates(*sargs, **dk))
    with ClockSampler() as clocks:
        ms = {
            "sq_score_candidates": graph_ms(
                lambda: gather.sq_score_candidates(*sargs, **dk)),
            "bq_search_approx": timed_ms(
                lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)),
            "bq_search_exact": timed_ms(
                lambda: bq_kernel.bq_search(qw, planes, k=R, **kw)),
            "bq_scores": timed_ms(lambda: bq_kernel.bq_scores(qw, planes, **kw)),
        }
    say("clocks", f"during the K4/K5/K6 timings: {clocks.summary()}")
    pms = {
        "sq_score_candidates": timed_ms(
            lambda: gather.sq_score_candidates_plain(*sargs, **dk)),
        "bq_search_approx": plain_ms(
            lambda: bq_kernel.bq_search_plain(qw, planes, k=R, mode="approx", **kw)),
        "bq_search_exact": plain_ms(lambda: bq_kernel.bq_search_plain(qw, planes, k=R, **kw)),
        "bq_scores": plain_ms(lambda: bq_kernel.bq_scores_plain(qw, planes, **kw)),
    }
    f32_ms = timed_ms(lambda: torch.topk(queries_dev @ data_dev.T, K, dim=1), iters=3)
    batch_ms = batch_walls(two, two_e, two_x, queries)
    score_batch_ms = wall_ms(lambda: bq.score_batch(beq), reps=21)
    for kname in ms:
        say("time", f"{kname}: kernel {ms[kname]:.4f} ms, plain {pms[kname]:.4f} ms per "
            f"{Q}-query batch at N={BN} dim={BD} (k={R} for the searches) on {smi}")
    say("time", f"sq_score_candidates: {ms['sq_score_candidates']:.4f} ms is the device "
        f"time (CUDA graph); the wrapper called back to back takes {k4_wrapper_ms:.4f} ms")
    say("time", f"f32 matmul + topk baseline: {f32_ms:.4f} ms per batch at N={BN} "
        f"D={BD} on {smi}")
    say_batches("clustered", batch_ms, rec, smi)
    say("time", f"BQ score_batch (K6): {score_batch_ms:.4f} ms host wall per {Q}-query batch "
        f"(the [{Q}, {BN}] f32 matrix on the card, median of 21), on {smi}")
    say("ties", f"clustered: {tied:.1f} rows per query score the {R}-th best BQ score")
    if do_profile:
        eqs = two.encode_query(queries)
        profile("two-stage BQ->SQ approx top_k_device", lambda: two.top_k_device(eqs, K))
        eqe = two_e.encode_query(queries)
        profile("two-stage BQ->SQ exact top_k_device", lambda: two_e.top_k_device(eqe, K))
        eqx = two_x.encode_query(queries)
        profile("two-stage BQ->f32 top_k_device", lambda: two_x.top_k_device(eqx, K))
        profile(f"K5a bq_search approx k={R} alone",
                lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw))
        pool = torch.randn(Q, -(-BN // 4096) * 128, device=dev)
        profile(f"torch.topk of a [{Q}, {pool.shape[1]}] pool, k={R}",
                lambda: torch.topk(pool, R, dim=1))

    # Bounds at the timed shapes. BQ: the planes' true words read once,
    # the output written once; the binary dot as Q * N * dim bit products at
    # the b1 wgmma rate (bq_bound), the +-1 int8 count printed beside. K4:
    # the Q*R gathered rows (what this run's ids need), their offsets and
    # ids, the queries; Q*R*D int8 multiply-adds.
    wt = bq_kernel.true_words(BD)
    pl_bytes = wt * 4 * BN + Q * wt * 4
    dl = sq.codes.shape[1]
    bounds, int8_ms = {}, {}
    for kname, out_bytes in (("bq_search_approx", Q * R * 8), ("bq_search_exact", Q * R * 8),
                             ("bq_scores", Q * BN * 4)):
        bounds[kname], int8_ms[kname] = bq_bound(pl_bytes + out_bytes, Q, BN, BD)
    bounds["sq_score_candidates"] = bound(Q * R * (dl + 8) + Q * (dl + 4) + Q * R * 4,
                                          2 * Q * R * dl, INT8_OPS_PER_S)
    for kname in ("bq_search_approx", "bq_search_exact", "bq_scores"):
        say("bound", f"{kname}: {ms[kname]:.4f} ms against its bound {bounds[kname][0]:.4f} "
            f"ms ({bounds[kname][1]}; {Q * BN * BD:.3e} bit products at the b1 wgmma rate, "
            f"{B1_PRODUCTS_PER_S_PER_SM:.3e} products/s/SM; {pl_bytes / 1e6:.1f} MB of planes), "
            f"{100 * bounds[kname][0] / ms[kname]:.1f} % of it; as +-1 int8 multiply-adds "
            f"at 1,979 TOPS {int8_ms[kname]:.4f} ms")
    if lib_bq:
        say("time", f"bq_scores: kernel {ms['bq_scores']:.4f} ms against torch._int_mm "
            f"{lib_bq:.4f} ms ({lib_bq / ms['bq_scores']:.2f}x the kernel's time) on {smi}")
    say_select_split("bq_search_exact", f"K5c at N={BN} dim={BD}, k={R}", ms["bq_search_exact"],
                     smi)
    # K5c / K5a's yardstick: K6's and torch.topk (K5a's approx has no library form).
    lib = {"bq_scores": lib_bq}
    if lib_bq is not None:
        cpm, qpm = pm1_rows(planes[:, :BN].t(), BD), pm1_rows(qw, BD)
        lib["bq_search_exact"] = lib["bq_search_approx"] = library_time(
            f"torch._int_mm of the +-1 signs + torch.topk (k={R}), K5c / K5a's yardstick",
            sign_composite(qpm, cpm, sign, R), smi)
        del cpm, qpm
    recs = [dict(name=n, launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=pms[n], bound=bounds[n], library_ms=lib.get(n)) for n in ms]
    return recs, {"f32_ms": f32_ms, "recall": rec, "batch_ms": batch_ms,
                  "bq_scores_pm1_expand_ms": expand_ms, "score_batch_ms": score_batch_ms,
                  "ties_at_r": tied,
                  "k4_wrapper_ms": k4_wrapper_ms}


def batch_walls(two, two_e, two_x, queries):
    """Host wall per batch of the three two-stage indexes (encode_query +
    top_k + copy to the host), median of 21: the host's clock on a shared
    machine varies by tens of percent between runs of 7."""
    return {
        name: wall_ms(lambda idx=idx: idx.top_k(idx.encode_query(queries), K), reps=21)
        for name, idx in (("bq_sq_approx", two), ("bq_sq_exact", two_e), ("bq_f32", two_x))
    }


def say_batches(corpus, batch_ms, rec, smi):
    for name, t in batch_ms.items():
        say("time", f"two-stage {name} on the {corpus} corpus: {t:.4f} ms host wall per "
            f"{Q}-query batch (encode_query + top_k + copy to host) at recall@{K} "
            f"{rec[name]:.4f}, on {smi}")


def bq_neighbour_path(dev, smi):
    """The two-stage indexes again at 1M x 1536, on the neighbourhood
    corpus, where the sign bits rank neighbours: recall@10 is held to a
    floor, and the BQ searches and the batches are timed on a corpus that
    ties far less than the clustered one."""
    from quantization_tpu_torch import (
        BinaryQuantizer, DistanceType, ExactRescorer, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    t0 = time.perf_counter()
    data_dev, queries_dev = neighbourhoods(BN, Q, BD, gen, dev)
    data = data_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    params = VectorParameters(BD, BN, DistanceType.DOT, False)
    bq = BinaryQuantizer.encode(data, params)
    sq = ScalarQuantizerU8.encode(data, params)
    two = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING)
    two_e = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING, coarse_method="exact")
    two_x = TwoStageIndex(bq, ExactRescorer(data_dev, DistanceType.DOT, False),
                          oversampling=OVERSAMPLING)
    beq = bq.encode_query(queries)
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    rec = {"bq": recall(bq.top_k(beq, K)[1], oracle, K)}
    for name, idx in (("bq_sq_approx", two), ("bq_sq_exact", two_e), ("bq_f32", two_x)):
        s, i = idx.top_k(idx.encode_query(queries), K)
        require(bool(np.isfinite(s).all()) and bool(((i >= 0) & (i < BN)).all()),
                f"neighbourhoods {name}: finite scores, valid ids")
        rec[name] = recall(i, oracle, K)
    say("bq-neigh", f"{BN} x {BD} neighbourhood corpus made, encoded and searched in "
        f"{time.perf_counter() - t0:.1f} s; recall@{K} vs the f32 oracle (TF32 off): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    for name in ("bq_sq_approx", "bq_sq_exact", "bq_f32"):
        require(rec[name] >= TWO_STAGE_RECALL_MIN and rec[name] > rec["bq"],
                f"neighbourhoods {name}: recall@{K} >= {TWO_STAGE_RECALL_MIN} and above "
                "BQ alone")
    tied = ties_at(bq.score_batch(beq), R)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=BD, n_valid=BN)
    qw, planes = beq.planes, bq.planes
    ms = {
        "bq_search_approx": timed_ms(
            lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)),
        "bq_search_exact": timed_ms(lambda: bq_kernel.bq_search(qw, planes, k=R, **kw)),
        "bq_scores": timed_ms(lambda: bq_kernel.bq_scores(qw, planes, **kw)),
    }
    batch_ms = batch_walls(two, two_e, two_x, queries)
    for kname, t in ms.items():
        say("time", f"{kname} on the neighbourhood corpus: kernel {t:.4f} ms per "
            f"{Q}-query batch (k={R} for the searches) on {smi}")
    say_batches("neighbourhood", batch_ms, rec, smi)
    say("ties", f"neighbourhoods: {tied:.1f} rows per query score the {R}-th best BQ score")
    return {"recall_at_10": rec, "two_stage_batch_ms": batch_ms, "kernel_ms": ms,
            "ties_at_r": tied}


def codes_differ_only_at_near_ties(got, want, x_chunks, c_chunks, rel=1e-5):
    """got/want u8 [B, m] on the host: equal, or the two centroids' squared
    distances (f64) within ``rel`` of each other (the rule of
    tests/test_torch_pq_codec.py). Returns the number of differing codes."""
    bad = np.argwhere(got != want)
    x = x_chunks.double()
    c = c_chunks.double()
    for b, ci in bad:
        d1 = float(((x[ci, b] - c[ci, int(got[b, ci])]) ** 2).sum())
        d2 = float(((x[ci, b] - c[ci, int(want[b, ci])]) ** 2).sum())
        require(abs(d1 - d2) <= rel * max(d1, d2, 1e-30),
                f"a code differs from the CPU encoder's only at a near-tie ({d1}, {d2})")
    return len(bad)


def lookup_ms(q, n, m, per_clock, props, clock_hz):
    """Q*N*m LUT lookups at ``per_clock`` lookups per clock per SM."""
    return q * n * m / (per_clock * props.multi_processor_count * clock_hz) * 1e3


def pq_bound(kind, q, n, m, kc, k, precision, props, clock_hz):
    """(bound_ms, bound_by) of one PQ kernel: the larger of its bytes (the
    f32 LUT and the codes read once, the output written once) at the HBM rate
    and its operations done the cheaper of two ways: Q*N*m LUT lookups at the
    shared-memory rate for the entry type (128 B per clock per SM), or the
    one-hot product, 2*Q*N*m*kc operations on the tensor cores at the rate
    of the LUT's type."""
    out = q * n * 4 if kind == "scores" else q * k * 8
    t_bytes = (q * m * kc * 4 + m * n + out) / HBM_BYTES_PER_S * 1e3
    lookups = lookup_ms(q, n, m, SMEM_BYTES_PER_CLOCK_PER_SM // LUT_ENTRY_BYTES[precision],
                        props, clock_hz)
    onehot = 2 * q * n * m * kc / ONEHOT_OPS_PER_S[precision] * 1e3
    t_ops = min(lookups, onehot)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_lut(precision, fn):
    """fn() with QTPU_PQ_LUT set to ``precision`` (the model reads it at each
    call), restored after."""
    old = os.environ.get("QTPU_PQ_LUT")
    os.environ["QTPU_PQ_LUT"] = precision
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["QTPU_PQ_LUT"]
        else:
            os.environ["QTPU_PQ_LUT"] = old


def pq_recalls(dev, n, dim, seed):
    """Path 3's indexes, trained and searched through the public API on
    ``dev``, with their recall@10 against the f32 oracle on the neighbourhood
    corpus: PQ 8-bit (int8 and bf16 LUT exact, approx), PQ 4-bit, OPQ, and
    OPQ -> f32 two-stage (R = 40). Returns (recalls, state)."""
    from quantization_tpu_torch import (
        DistanceType, ExactRescorer, ProductQuantizer, TwoStageIndex, VectorParameters,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data_dev, queries_dev = neighbourhoods(n, Q, dim, gen, dev)
    data = data_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    st = {"data": data, "queries": queries, "data_dev": data_dev, "params": params,
          "queries_dev": queries_dev, "times": {}, "results": {}}
    rec = {}
    for label, chunk, bits in (("8bit", PQ_CHUNK, 8), ("4bit", PQ4_CHUNK, 4)):
        t0 = time.perf_counter()
        enc = ProductQuantizer.encode(data, params, chunk_size=chunk, bits=bits, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        st["times"][f"train_encode_{label}_s"] = time.perf_counter() - t0
        eq = enc.encode_query(queries)
        s_ex, i_ex = with_lut("int8", lambda: enc.top_k(eq, K))
        s_ap, i_ap = with_lut("int8", lambda: enc.top_k(eq, K, method="approx"))
        st[label] = enc
        st["results"][label] = (s_ex, i_ex, s_ap, i_ap)
        rec[f"pq_{label}_int8_exact"] = recall(i_ex, oracle, K)
        rec[f"pq_{label}_int8_approx"] = recall(i_ap, oracle, K)
        if label == "8bit":
            _, i_bf = with_lut("bf16", lambda: enc.top_k(eq, K))
            rec["pq_8bit_bf16_exact"] = recall(i_bf, oracle, K)
    t0 = time.perf_counter()
    opq = ProductQuantizer.encode(data, params, chunk_size=PQ_CHUNK, rotation="opq", device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    st["times"]["train_encode_opq_s"] = time.perf_counter() - t0
    st["opq"] = opq
    _, i_opq = with_lut("int8", lambda: opq.top_k(opq.encode_query(queries), K))
    rec["opq_int8_exact"] = recall(i_opq, oracle, K)
    two = TwoStageIndex(opq, ExactRescorer(data_dev, DistanceType.DOT, False, device=dev),
                        oversampling=OVERSAMPLING)
    st["two"] = two
    s_two, i_two = with_lut("int8", lambda: two.top_k(two.encode_query(queries), K))
    st["results"]["opq_f32"] = (s_two, i_two)
    rec["opq_f32"] = recall(i_two, oracle, K)
    return rec, st


def hold_k8_onehot(lut, ct, dev):
    """K8 with 4-bit codes and the int8 LUT (pq4_scores_ws_kernel) held to
    its plain version to the bit in both geometries and both store branches:
    path 3's LUT and codes (m = 192) at Q = 1, 33, 100 and 256 (the first
    queries), n_valid the corpus (a multiple of 4, not of 128: the tensor
    stores of a partial segment), odd (the warps' stores) and a multiple of
    4 but not of 128 over the first 100,100 rows; then m = 8 and 13 on
    random LUTs and codes with their high nibble set, 51,200 rows, the same
    Q and n_valid kinds."""
    from quantization_tpu_torch.ops.kernels import pq_kernel

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    cases = 0
    for m in (8, 13, 192):
        if m == 192:
            lm, cm, ns = lut, ct, (PN, 100_003, 100_100)
        else:
            npad = 51_200
            lm = (torch.randn(Q, m, 16, generator=g, device=dev) * 2
                  + torch.randn(Q, m, 1, generator=g, device=dev))
            cm = torch.zeros((m + (-m) % pq_kernel.M_BLK, npad), dtype=torch.uint8, device=dev)
            cm[:m] = torch.randint(0, 256, (m, npad), generator=g, device=dev, dtype=torch.uint8)
            ns = (npad, npad - 1197, npad - 1100)
        for q in (1, 33, 100, 256):
            ql = lm[:q].contiguous()
            for n in ns:
                got = pq_kernel.pq_scores(ql, cm, n_valid=n, precision="int8")
                want = pq_kernel.pq_scores_plain(ql, cm, n_valid=n, precision="int8")
                torch.cuda.synchronize()
                require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                        f"K8 4bit int8 m={m} Q={q} n_valid={n} equals plain to the bit")
                cases += 1
                del got, want
    say("K8", f"4bit int8 on pq4_scores_ws_kernel at Q = 1, 33, 100 and 256, m = 8, 13 and "
        f"192, n_valid whole, odd and a multiple of 4 not of 128: {cases} cases equal plain "
        "to the bit")


def pq_path(dev, smi, do_profile):
    """Path 3: PQ encode -> LUT -> fused search at 1M x 768 on the card,
    8-bit (m = 96) and 4-bit (m = 192), then OPQ -> f32 two-stage; every new
    kernel against its plain version at the path's shapes."""
    from quantization_tpu_torch import ProductQuantizer
    from quantization_tpu_torch.ops import pq as pq_ops
    from quantization_tpu_torch.ops.kernels import ktile, pq_kernel

    # ------------------------------------------------ PQ main path, public API
    t0 = time.perf_counter()
    launches = {}
    pq_kernel.reset_launches()
    rec, st = pq_recalls(dev, PN, PD, SEED + 3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # pq_recalls trains, encodes and searches each index once. Then each bit
    # width is its own counted main-path run on its trained index: the
    # queries, exact and approx top-k and score_batch, with the counts reset
    # just before it and read just after. The OPQ -> f32 two-stage search is
    # a third counted run, below.
    for label in ("8bit", "4bit"):
        enc = st[label]
        pq_kernel.reset_launches()
        eq = enc.encode_query(st["queries"])
        s_ex, i_ex = with_lut("int8", lambda: enc.top_k(eq, K))
        with_lut("int8", lambda: enc.top_k(eq, K, method="approx"))
        scores = with_lut("int8", lambda: enc.score_batch(eq))  # K8a
        with_lut("bf16", lambda: enc.score_batch(eq))  # K8b (4-bit: the bf16 one-hot route)
        torch.cuda.synchronize()
        sfx = "" if label == "8bit" else "_4bit"
        names = ("pq_scores", "pq_search_exact", "pq_search_approx")
        dense = {n: pq_kernel.LAUNCHES[n] for n in names}
        onehot = {n: pq_kernel.ONEHOT_LAUNCHES[n] for n in names}
        launches.update({name + sfx: n for name, n in dense.items()})
        say("pq-main", f"{label}: launches {dense}, of which on the one-hot route {onehot}")
        for name, n in dense.items():
            require(n > 0, f"PQ {label} main path launched {name}")
        if label == "4bit":
            # The kernels line's 4-bit K8 / K7b / K7a entries are the one-hot
            # route's: its own launches (the bf16 score_batch is K8b's).
            launches.update({name + sfx: n for name, n in onehot.items()})
            require(all(n > 0 for n in onehot.values()),
                    "PQ 4-bit int8 main path launched the one-hot K8, K7b and K7a")
            launches["pq_scores_4bit_bf16"] = pq_kernel.BF16_ONEHOT_LAUNCHES["pq_scores"]
            say("pq-main", f"{label}: bf16 K8 on the bf16 one-hot route: "
                f"{launches['pq_scores_4bit_bf16']}")
            require(launches["pq_scores_4bit_bf16"] > 0,
                    "PQ 4-bit bf16 score_batch launched the bf16 one-hot K8")
        else:
            require(not any(pq_kernel.ONEHOT_LAUNCHES.values())
                    and not any(pq_kernel.BF16_ONEHOT_LAUNCHES.values()),
                    "PQ 8-bit main path stays on the gather body")
        require(enc.codes_t.is_cuda and tuple(enc.codes_t.shape)
                == (enc.num_chunks + (-enc.num_chunks) % pq_kernel.M_BLK,
                    PN + (-PN) % pq_kernel.TILE_N),
                f"PQ {label}: codes_t [Mpad, Npad] on the card")
        require(tuple(scores.shape) == (Q, PN) and bool(torch.isfinite(scores).all()),
                f"PQ {label}: score_batch shape and values")
        require(s_ex.shape == (Q, K) and bool(np.isfinite(s_ex).all())
                and bool(((i_ex >= 0) & (i_ex < PN)).all()), f"PQ {label}: top_k")
        np.testing.assert_array_equal(
            s_ex, torch.topk(scores, K, dim=1).values.cpu().numpy(),
            err_msg=f"PQ {label}: exact top-k values == top-k of score_batch")
        del scores
    two = st["two"]
    pq_kernel.reset_launches()
    s_two, i_two = with_lut("int8", lambda: two.top_k(two.encode_query(st["queries"]), K))
    torch.cuda.synchronize()
    launches["pq_search_approx_opq"] = pq_kernel.LAUNCHES["pq_search_approx"]
    say("pq-main", f"OPQ -> f32 two-stage: launches {dict(pq_kernel.LAUNCHES)}")
    require(launches["pq_search_approx_opq"] > 0,
            "OPQ -> f32 two-stage launched pq_search_approx as its coarse stage")
    require(np.array_equal(s_two, st["results"]["opq_f32"][0])
            and np.array_equal(i_two, st["results"]["opq_f32"][1]),
            "OPQ -> f32 two-stage: the counted run equals the first")
    say("pq-main", f"{PN} x {PD} neighbourhood corpus: PQ 8-bit / 4-bit and OPQ trained, "
        f"encoded and searched in {wall:.1f} s (train + encode 8-bit "
        f"{st['times']['train_encode_8bit_s']:.2f} s, 4-bit "
        f"{st['times']['train_encode_4bit_s']:.2f} s, OPQ "
        f"{st['times']['train_encode_opq_s']:.2f} s); recall@{K} vs the f32 oracle: "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    require(rec["opq_f32"] >= OPQ_F32_RECALL_MIN,
            f"OPQ -> f32 recall@{K} >= {OPQ_F32_RECALL_MIN}")
    require(rec["pq_8bit_int8_exact"] >= rec["pq_8bit_bf16_exact"] - INT8_RECALL_SLACK,
            f"int8-LUT exact recall within {INT8_RECALL_SLACK} of the bf16 LUT's")
    require(rec["opq_f32"] >= rec["opq_int8_exact"], "OPQ -> f32 recall >= OPQ alone")

    # ------------------------------------------- codes: the card vs the CPU
    enc8 = st["8bit"]
    div = enc8.metadata.vector_division
    rows = st["data"][:PQ_CODE_CHECK_ROWS]
    x_chunks = torch.from_numpy(pq_ops.chunk_tensor(rows, div))
    cpu_codes = pq_ops.encode_batch(x_chunks, enc8._c_chunks.cpu()).numpy()
    card = enc8.codes[:PQ_CODE_CHECK_ROWS, : enc8.num_chunks].cpu().numpy()
    flips = codes_differ_only_at_near_ties(card, cpu_codes, x_chunks, enc8._c_chunks.cpu())
    say("pq-codes", f"{PQ_CODE_CHECK_ROWS} rows x {enc8.num_chunks} chunks encoded on the "
        f"card equal the CPU encoder's but for {flips} near-ties")

    # ------------------------------------------------------- save / load
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("8bit", "4bit"):
            enc = st[label]
            d, mpath = os.path.join(tmp, f"{label}.bin"), os.path.join(tmp, f"{label}.json")
            enc.save(d, mpath)
            back = ProductQuantizer.load(d, mpath, st["params"])
            require(torch.equal(back.codes, enc.codes), f"PQ {label}: codes after save/load")
            s2, i2 = with_lut("int8", lambda: back.top_k(back.encode_query(st["queries"]), K))
            s1, i1 = st["results"][label][:2]
            require(np.array_equal(s2, s1) and np.array_equal(i2, i1),
                    f"PQ {label}: search after save/load equals search before")
            say("pq-save", f"{label}: {os.path.getsize(d)} bytes of codes "
                f"({enc.get_quantized_vector_size()} B/row); load equals")

    # ----------------------------- the new kernels against plain, on the card
    err, ms, pms, lib_ms, bounds, design_floor = {}, {}, {}, {}, {}, {}
    props = torch.cuda.get_device_properties(0)
    clock = max_sm_clock_hz()
    for label in ("8bit", "4bit"):
        enc = st[label]
        sfx = "" if label == "8bit" else "_4bit"
        lut = enc.encode_query(st["queries"]).lut
        ct = enc.codes_t
        m, kc = enc.num_chunks, lut.shape[2]
        kw = dict(n_valid=PN)
        plain = {p: pq_kernel.lut_scores_plain(lut, ct, precision=p, **kw)
                 for p in ("int8", "bf16")}
        for p in ("int8", "bf16"):
            got = pq_kernel.pq_scores(lut, ct, precision=p, **kw)
            torch.cuda.synchronize()
            require(torch.equal(got, plain[p]), f"K8 {label} {p} equals plain to the bit")
            del got
        err["pq_scores" + sfx] = 0.0
        say("K8", f"{label} pq_scores [{Q}, {PN}] x m={m}, int8 and bf16 LUT: equal to "
            "plain to the bit")
        if label == "4bit":
            hold_k8_onehot(lut, ct, dev)
        ids_all = torch.arange(PN, device=dev, dtype=torch.int32).expand(Q, PN)
        err["pq_search_exact" + sfx] = 0.0
        for p in ("int8", "bf16", "bf16x2"):
            sc = plain[p] if p in plain else pq_kernel.lut_scores_plain(lut, ct, precision=p,
                                                                        **kw)
            for k in (K, 1024):
                want_v, _ = ktile.merge_exact(sc, ids_all, k)
                v, i = pq_kernel.pq_search(lut, ct, k=k, precision=p, **kw)
                e = check_topk(v, i, want_v, sc, PN, f"K7b {label} {p} k={k}")
                err["pq_search_exact" + sfx] = max(err["pq_search_exact" + sfx], e)
            del sc
        say("K7b", f"{label} exact k={K} and 1024, int8 / bf16 / bf16x2 LUT: values equal "
            "plain top-k, ids equal up to ties")
        err["pq_search_approx" + sfx] = 0.0
        for p in ("int8", "bf16"):
            pv, pi = pq_kernel.pq_search_plain(lut, ct, k=R, mode="approx", precision=p, **kw)
            v, i = pq_kernel.pq_search(lut, ct, k=R, mode="approx", precision=p, **kw)
            e = check_topk(v, i, pv, plain[p], PN, f"K7a {label} {p}")
            require(torch.equal(i, pi), f"K7a {label} {p}: ids equal plain approx")
            err["pq_search_approx" + sfx] = max(err["pq_search_approx" + sfx], e)
        say("K7a", f"{label} approx k={R}, int8 and bf16 LUT: values and ids equal the plain "
            "approx")
        if label == "4bit":  # the one-hot route with the residual pair
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 8)
            npad = ct.shape[1]
            rowadd = torch.randn(npad, generator=gen, device=dev) * 5
            rowadd[PN:] = ktile.NEG  # the pad mask rides rowadd
            corr = torch.randn(Q, npad // ktile.CORR_BLK, generator=gen, device=dev)
            rkw = dict(n_valid=PN, k=R, mode="approx", precision="int8")
            pv, pi = pq_kernel.pq_search_plain(lut, ct, rowadd, corr, **rkw)
            v, i = pq_kernel.pq_search(lut, ct, rowadd, corr, **rkw)
            require(torch.equal(v, pv) and torch.equal(i, pi),
                    "K7a 4bit int8 with rowadd and corr: values and ids equal the plain approx")
            rkw["mode"] = "exact"
            pv, _ = pq_kernel.pq_search_plain(lut, ct, rowadd, corr, **rkw)
            v, i = pq_kernel.pq_search(lut, ct, rowadd, corr, **rkw)
            sc = (plain["int8"] + rowadd[None, :PN]) + ktile.expand_corr(corr)[:, :PN]
            check_topk(v, i, pv, sc, PN, "K7b 4bit int8 with rowadd and corr")
            say("K7a/K7b", f"4bit approx and exact k={R}, int8 LUT with rowadd and corr (the "
                "one-hot route): values equal the plain version's, ids equal (approx) or "
                "equal up to ties (exact)")
            del pv, pi, rowadd, corr, sc
        del plain

        # ------------------------------------------------------------ times
        with ClockSampler() as clocks:
            tk = {
                "pq_scores": timed_ms(lambda: pq_kernel.pq_scores(lut, ct, precision="int8",
                                                                  **kw)),
                "pq_search_exact": timed_ms(lambda: pq_kernel.pq_search(
                    lut, ct, k=K, precision="int8", **kw)),
                "pq_search_approx": timed_ms(lambda: pq_kernel.pq_search(
                    lut, ct, k=K, mode="approx", precision="int8", **kw)),
            }
            other = {
                f"{name} {p}": timed_ms(lambda p=p, mode=mode: pq_kernel.pq_search(
                    lut, ct, k=K, mode=mode, precision=p, **kw))
                for name, mode in (("pq_search_exact", "exact"), ("pq_search_approx",
                                                                   "approx"))
                for p in ("bf16", "bf16x2")
            }
            other["pq_scores bf16"] = timed_ms(
                lambda: pq_kernel.pq_scores(lut, ct, precision="bf16", **kw))
        say("clocks", f"during the {label} PQ timings: {clocks.summary()}")
        plain_bf16 = plain_ms(lambda: pq_kernel.pq_scores_plain(lut, ct, precision="bf16",
                                                                 **kw))
        say("time", f"pq_scores {label} bf16 LUT: plain {plain_bf16:.4f} ms on {smi}")
        if label == "4bit":  # K8b on the bf16 one-hot route: its own kernels-line entry
            name = "pq_scores_4bit_bf16"
            ms[name], pms[name], err[name] = other["pq_scores bf16"], plain_bf16, 0.0
            bounds[name] = pq_bound("scores", Q, PN, m, kc, K, "bf16", props, clock)
            add_ms = Q * PN * ct.shape[0] / (
                FADD_PER_CLOCK_PER_SM * props.multi_processor_count * clock) * 1e3
            design_floor["pq_4bit_bf16_fadd"] = add_ms
            say("bound", f"{name}: bound {bounds[name][0]:.4f} ms ({bounds[name][1]}, the "
                f"one-hot product at the bf16 rate); the design's f32-add floor {add_ms:.4f} ms "
                f"(one add per entry, {FADD_PER_CLOCK_PER_SM} per clock per SM) on {smi}")
        tp = {
            "pq_scores": plain_ms(lambda: pq_kernel.pq_scores_plain(lut, ct, precision="int8",
                                                                    **kw)),
            "pq_search_exact": plain_ms(lambda: pq_kernel.pq_search_plain(
                lut, ct, k=K, precision="int8", **kw)),
            "pq_search_approx": plain_ms(lambda: pq_kernel.pq_search_plain(
                lut, ct, k=K, mode="approx", precision="int8", **kw)),
        }
        # The library yardstick of K8: embedding_bag sums the gathered rows
        # of a table, here the f32 LUT laid out [m * kc, Q], over each row's
        # m codes (the f32-LUT function, K8's within its quantization step).
        # K7a/K7b have none: no PyTorch call fuses the scores with a top-k.
        table = lut.permute(1, 2, 0).reshape(m * kc, Q).contiguous()
        bags = (ct[:m, :PN].T.long() & (kc - 1)) + torch.arange(m, device=dev) * kc

        def embedding_bag():
            return torch.nn.functional.embedding_bag(bags, table, mode="sum")

        f32_scores = pq_kernel.lut_scores_plain(lut, ct, precision="int8", **kw)
        gap = float((embedding_bag().T - f32_scores).abs().max())
        lib_ms["pq_scores" + sfx] = timed_ms(embedding_bag, iters=3)
        del bags, table, f32_scores
        say("library", f"{label}: embedding_bag (f32 LUT) {lib_ms['pq_scores' + sfx]:.4f} ms; "
            f"max |f32-LUT - int8-LUT score| {gap:.4f}")
        if label == "4bit":
            lib_ms["pq_scores_4bit_bf16"] = lib_ms["pq_scores" + sfx]
        lib_ms["pq_search_exact" + sfx] = lib_ms["pq_search_approx" + sfx] = None
        for name in tk:
            ms[name + sfx], pms[name + sfx] = tk[name], tp[name]
            bounds[name + sfx] = pq_bound("scores" if name == "pq_scores" else "search",
                                          Q, PN, m, kc, K, "int8", props, clock)
            say("time", f"{name} {label} int8 LUT: kernel {tk[name]:.4f} ms, plain "
                f"{tp[name]:.4f} ms per {Q}-query batch at N={PN} m={m} (k={K} for the "
                f"searches) on {smi}")
        if label == "4bit":
            say_select_split("pq_search_exact_4bit", f"K7b 4bit int8 at N={PN} m={m}, k={K}",
                             tk["pq_search_exact"], smi)
        for name, t in other.items():
            kname, p = name.split()
            b, by = pq_bound("scores" if kname == "pq_scores" else "search", Q, PN, m, kc, K,
                             p, props, clock)
            say("time", f"{kname} {label} {p} LUT: kernel {t:.4f} ms, bound {b:.4f} ms "
                f"({by}) on {smi}")
        # The gather loop's issue floor: its SASS instructions a lookup (the
        # K7a / K11 entry's, LOOP_SASS) at ISSUE_PER_CLOCK_PER_SM.
        floors = {p: lookup_ms(Q, PN, m, ISSUE_PER_CLOCK_PER_SM
                               / LOOP_SASS[f"pq_search_approx_kernel<{kc}, {p}>"], props, clock)
                  for p in (("int8", "bf16", "bf16x2") if label == "8bit" else
                            ("bf16", "bf16x2"))}
        design_floor["pq" + sfx] = floors
        say("bound", f"PQ {label}: the LUT-gather loop's issue floor (its SASS instructions a "
            f"lookup at {ISSUE_PER_CLOCK_PER_SM} a clock per SM) "
            + ", ".join(f"{p} {t:.4f} ms" for p, t in floors.items()) + f" on {smi}")
        if do_profile:
            eqp = enc.encode_query(st["queries"])
            profile(f"PQ {label} top_k exact", lambda: enc.top_k(eqp, K))
            profile(f"PQ {label} top_k approx", lambda: enc.top_k(eqp, K, method="approx"))

    gather_holds(dev, st, smi)

    # K7a as the OPQ coarse stage: k = R on the rotated LUT and OPQ codes.
    opq = st["opq"]
    name = "pq_search_approx_opq"
    lut, ct = opq.encode_query(st["queries"]).lut, opq.codes_t
    m, kc = opq.num_chunks, lut.shape[2]
    kw = dict(n_valid=PN, k=R, mode="approx", precision="int8")
    pv, pi = pq_kernel.pq_search_plain(lut, ct, **kw)
    v, i = pq_kernel.pq_search(lut, ct, **kw)
    err[name] = check_topk(v, i, pv, pq_kernel.lut_scores_plain(
        lut, ct, n_valid=PN, precision="int8"), PN, "K7a OPQ")
    require(torch.equal(i, pi), "K7a OPQ: ids equal plain approx")
    ms[name] = timed_ms(lambda: pq_kernel.pq_search(lut, ct, **kw))
    pms[name] = plain_ms(lambda: pq_kernel.pq_search_plain(lut, ct, **kw))
    bounds[name] = pq_bound("search", Q, PN, m, kc, R, "int8", props, clock)
    lib_ms[name] = None
    say("K7a", f"OPQ coarse stage, approx k={R}, int8 LUT: values and ids equal the plain "
        f"approx; kernel {ms[name]:.4f} ms, plain {pms[name]:.4f} ms on {smi}")
    two_ms = wall_ms(lambda: two.top_k(two.encode_query(st["queries"]), K), reps=21)
    if do_profile:
        eqt = two.encode_query(st["queries"])
        profile("two-stage OPQ -> f32 top_k_device", lambda: two.top_k_device(eqt, K))
    f32_ms = timed_ms(lambda: torch.topk(st["queries_dev"] @ st["data_dev"].T, K, dim=1),
                      iters=3)
    say("time", f"two-stage OPQ -> f32 (R={R}): {two_ms:.4f} ms host wall per {Q}-query "
        f"batch (encode_query + top_k + copy to host) at recall@{K} {rec['opq_f32']:.4f}; "
        f"f32 matmul + topk baseline {f32_ms:.4f} ms at N={PN} D={PD}, on {smi}")
    recs = [dict(name=n, launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=pms[n], bound=bounds[n], library_ms=lib_ms[n]) for n in ms]
    # Path 7 wraps the trained quantizers and encodes the corpus's first rows.
    keep = {"8bit": st["8bit"], "4bit": st["4bit"], "queries": st["queries"],
            "data": st["data"][:SHARD_PQ_ENCODE_N].copy()}
    return recs, {"recall_at_10": rec, "f32_ms": f32_ms, "opq_f32_batch_ms": two_ms,
                  "train_encode_s": st["times"], "lookup_floor_ms": design_floor}, keep


def gather_holds(dev, st, smi):
    """The LUT-gather kernels against plain at the lookup loop's edges: Q = 4,
    33 and 100 (a 32-query tile partly past Q) on path 3's LUTs and codes
    (8 bits: K8 int8 / bf16, K7b and K7a with every LUT word; 4 bits: the
    bf16 / bf16x2 K7b and K7a), then the int8 kernels (K8, K7b, K7a, K11) on
    LUTs whose packed 16-bit sums reach +-127 x m (every code +127, -127, or
    the two in turn) at m = 96 and at m = 272, past the packed sums' flush
    every 256 chunks, at 100,000 rows. K8 to the bit, K7b values (ids up to
    ties), K7a / K11 values and ids."""
    from quantization_tpu_torch.ops.kernels import ktile, pq_kernel

    t0 = time.perf_counter()
    n = 0
    for label, words in (("8bit", ("int8", "bf16", "bf16x2")), ("4bit", ("bf16", "bf16x2"))):
        enc = st[label]
        lut_all, ct = enc.encode_query(st["queries"]).lut, enc.codes_t
        for q in GATHER_HOLD_QS:
            lut = lut_all[:q].contiguous()
            for p in words:
                kw = dict(n_valid=PN, precision=p)
                sc = pq_kernel.lut_scores_plain(lut, ct, **kw)
                if label == "8bit" and p != "bf16x2":
                    require(torch.equal(pq_kernel.pq_scores(lut, ct, **kw), sc),
                            f"K8 {label} {p} Q={q} equals plain to the bit")
                ids_all = torch.arange(PN, device=dev, dtype=torch.int32).expand(q, PN)
                v, i = pq_kernel.pq_search(lut, ct, k=K, **kw)
                check_topk(v, i, ktile.merge_exact(sc, ids_all, K)[0], sc, PN,
                           f"K7b {label} {p} Q={q}")
                pv, pi = pq_kernel.pq_search_plain(lut, ct, k=R, mode="approx", **kw)
                v, i = pq_kernel.pq_search(lut, ct, k=R, mode="approx", **kw)
                require(torch.equal(v, pv) and torch.equal(i, pi),
                        f"K7a {label} {p} Q={q}: values and ids equal the plain approx")
                n += 1
                del sc, ids_all
    rows, q = 100_000, 33
    npad = rows + (-rows) % pq_kernel.TILE_N
    sel = torch.arange(0, npad // 1024, 2, device=dev, dtype=torch.int32)
    for m in (96, 272):
        lut = torch.zeros((q, m, pq_kernel.K), device=dev)
        lut[:, :, 0], lut[:, :, 1] = 1.0, -1.0  # int8 entries +127 and -127
        c = torch.arange(m, device=dev)[:, None] + torch.arange(rows, device=dev)[None]
        for kind, codes in (("+127", 0 * c), ("-127", 0 * c + 1), ("alternating", c % 2)):
            ct = torch.zeros((m + (-m) % pq_kernel.M_BLK, npad), dtype=torch.uint8, device=dev)
            ct[:m, :rows] = codes.to(torch.uint8)
            kw = dict(n_valid=rows, precision="int8")
            sc = pq_kernel.pq_scores_plain(lut, ct, **kw)
            what = f"int8 {kind} m={m}"
            require(torch.equal(pq_kernel.pq_scores(lut, ct, **kw), sc), f"K8 {what}")
            v, i = pq_kernel.pq_search(lut, ct, k=K, **kw)
            check_topk(v, i, pq_kernel.pq_search_plain(lut, ct, k=K, **kw)[0], sc, rows,
                       f"K7b {what}")
            for got, want in ((pq_kernel.pq_search(lut, ct, k=R, mode="approx", **kw),
                               pq_kernel.pq_search_plain(lut, ct, k=R, mode="approx", **kw)),
                              (pq_kernel.pq_search_indexed(lut, ct, sel, k=R, precision="int8"),
                               pq_kernel.pq_search_indexed_plain(lut, ct, sel, k=R,
                                                                 precision="int8"))):
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"K7a / K11 {what}: values and ids equal the plain approx")
            n += 1
            del sc, ct
    torch.cuda.synchronize()
    say("K7/K8", f"the LUT-gather kernels at Q = {GATHER_HOLD_QS} on path 3's LUTs and codes "
        "(8-bit every word, 4-bit bf16 / bf16x2), and the int8 K8 / K7b / K7a / K11 on "
        "+127 / -127 / alternating sums at m = 96 and 272 (past the packed sums' flush "
        f"every 256 chunks): {n} cases equal plain ({time.perf_counter() - t0:.1f} s)")


IVF_SPECS = {  # name -> IVFIndex.encode arguments beyond (data, params)
    "sq": dict(quantizer="sq"),
    "sq_res": dict(quantizer="sq", residual=True),
    "opq_res": dict(quantizer="pq", chunk_size=PQ_CHUNK, rotation="opq", residual=True),
    "bq": dict(quantizer="bq"),
    "opq_res_512": dict(quantizer="pq", chunk_size=PQ_CHUNK, rotation="opq", residual=True,
                        nlist=IVF_README_NLIST, bucket_size=IVF_README_BUCKET),
    # 4-bit PQ with the default int8 LUT: K11 and the compact K7b on the
    # one-hot route.
    "pq4": dict(quantizer="pq", chunk_size=PQ4_CHUNK, bits=4),
}


def serve_defaults(ivf):
    """The two-stage searches' probe and union widths, set as the index's
    defaults: 1/32 and 1/4 of its buckets (32 and ~256 at 1M rows), so the
    CPU rehearsal at 30k rows scans the same fraction."""
    nb = ivf.metadata.nbuckets
    ivf.metadata.nprobe = max(1, round(nb / 32))
    ivf.metadata.nscan = max(ivf.metadata.nprobe, round(nb / 4))


def ivf_sq_recalls(dev, n, dim, seed):
    """IVF-SQ coarse and IVF-SQ -> f32 two-stage (R = 40) recall@10 on the
    neighbourhood corpus, with ``serve_defaults``: the numbers the card's
    run is held to, rehearsed on the CPU."""
    from quantization_tpu_torch import (
        DistanceType, ExactRescorer, IVFIndex, TwoStageIndex, VectorParameters,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data_dev, queries_dev = neighbourhoods(n, Q, dim, gen, dev)
    data, queries = data_dev.cpu().numpy(), queries_dev.cpu().numpy()
    oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1).indices.cpu().numpy()
    ivf = IVFIndex.encode(data, VectorParameters(dim, n, DistanceType.DOT, False),
                          quantizer="sq", device=dev)
    serve_defaults(ivf)
    two = TwoStageIndex(ivf, ExactRescorer(data_dev, DistanceType.DOT, False, device=dev),
                        oversampling=OVERSAMPLING)
    _, i_c = ivf.top_k(ivf.encode_query(queries), K)
    _, i_t = two.top_k(two.encode_query(queries), K)
    return {"ivf_sq": recall(i_c, oracle, K), "ivf_sq_f32": recall(i_t, oracle, K),
            "nbuckets": ivf.metadata.nbuckets, "nprobe": ivf.metadata.nprobe,
            "nscan": ivf.metadata.nscan}


def ivf_union(ivf, q, nprobe, nscan):
    """The batch union of a search (bucket ids in priority order), as
    ``top_k_device`` computes it."""
    from quantization_tpu_torch.models import ivf as ivf_mod

    nb = ivf.metadata.nbuckets
    p = min(nprobe, nb)
    return ivf_mod._union(q, ivf._means_dev, ivf.params.distance_type, ivf.params.invert,
                          p, max(min(nscan, nb), p))


def ivf_corr(ivf, q, union):
    """The residual bucket term [U, Q] of a union, as the model builds it."""
    from quantization_tpu_torch.models import ivf as ivf_mod

    rc = ivf_mod._residual_coeffs(ivf.params.distance_type, ivf.params.invert)[1]
    return ivf_mod._bucket_term(q, ivf._means_dev, union, ivf._res_a,
                                rc if ivf.metadata.kind == "pq" else 0.0)


def tiles_of(union, s, itile):
    tpb = s // itile
    return (union[:, None] * tpb + torch.arange(tpb, device=union.device)).reshape(-1).to(
        torch.int32)


def check_exact_pairs(v, i, pv, scores, col, what):
    """Exact-search rule: values equal the plain version's; every live id is
    distinct and scores (plain, through ``col``: corpus row -> column of
    ``scores``) the value of its slot."""
    require(torch.equal(v, pv), f"{what}: values equal plain")
    live = i >= 0
    c = col[i.clamp(min=0).long()]
    require(bool((c[live] >= 0).all()), f"{what}: ids are rows of the scan")
    got = torch.gather(scores, 1, c.clamp(min=0))
    require(torch.equal(got[live], v[live]), f"{what}: score[id] == value")
    srt = torch.sort(i, dim=1).values
    require(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()),
            f"{what}: distinct ids")
    return 0.0


def column_map(rows, npad, dev):
    col = torch.full((npad,), -1, dtype=torch.long, device=dev)
    col[rows] = torch.arange(rows.shape[0], device=dev)
    return col


def ivf_path(dev, smi, do_profile, opq_f32_ms):
    """Path 4: IVF at 1M x 768 on path 3's neighbourhood corpus — IVF-SQ,
    residual IVF-SQ, residual IVF-OPQ and IVF-BQ at the automatic geometry,
    residual IVF-OPQ at the README geometry — searched through the public
    API, two-stage over IVF, then every kernel of the path against its plain
    version at the path's shapes, and the times."""
    from quantization_tpu_torch import (
        DistanceType, ExactRescorer, IVFIndex, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.models import ivf as ivf_mod
    from quantization_tpu_torch.ops.kernels import bq_kernel, ktile, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    data_dev, queries_dev = neighbourhoods(PN, Q, PD, gen, dev)
    data, queries = data_dev.cpu().numpy(), queries_dev.cpu().numpy()
    params = VectorParameters(PD, PN, DistanceType.DOT, False)
    oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1).indices.cpu().numpy()

    # ------------------------------------------------------------- builds
    idx, build_s = {}, {}
    for name, kw in IVF_SPECS.items():
        t0 = time.perf_counter()
        idx[name] = IVFIndex.encode(data, params, **kw)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        m = idx[name].metadata
        say("ivf-build", f"{name}: nlist {m.nlist}, bucket_size {m.bucket_size}, "
            f"{m.nbuckets} buckets ({m.nbuckets * m.bucket_size} inner rows), built in "
            f"{build_s[name]:.2f} s")
        require(idx[name].device.type == "cuda", f"{name}: on the card by default")
    for name in ("sq", "sq_res", "opq_res", "bq"):
        require(idx[name].metadata.bucket_size == 1024, f"{name}: auto geometry S = 1024")
    for ivf in idx.values():
        serve_defaults(ivf)

    # ----------------------------------------- the main path, counted
    fine = ExactRescorer(data_dev, DistanceType.DOT, False)
    twos = {"ivf_sq_f32": TwoStageIndex(idx["sq"], fine, oversampling=OVERSAMPLING),
            "ivf_opq_res_f32": TwoStageIndex(idx["opq_res"], fine, oversampling=OVERSAMPLING),
            "ivf_opq_res_f32_r160": TwoStageIndex(idx["opq_res"], fine, oversampling=16.0)}
    reset_all(*mods)
    t0 = time.perf_counter()
    res, nsearch = {}, 0
    for name, ivf in idx.items():
        eq = ivf.encode_query(queries)
        for nscan in IVF_NSCANS:
            for method in ("exact", "approx"):
                res[name, method, nscan] = ivf.top_k(eq, K, method=method, nprobe=IVF_NPROBE,
                                                     nscan=nscan)
                nsearch += 1
        if name == "sq_res":  # the compact scan too: K1 / K2 with corr
            for method in ("exact", "approx"):
                res[name, method, "compact"] = ivf.top_k(
                    eq, K, method=method, nprobe=IVF_NPROBE, nscan=IVF_NSCANS[0],
                    scan="compact")
                nsearch += 1
    for name, two in twos.items():
        res[name] = two.top_k(two.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(*mods)
    # The 4-bit index's K11 and compact K7b run on the one-hot route: rows of
    # their own, the ring kernels' rows count the rest.
    onehot = {n: pq_kernel.ONEHOT_LAUNCHES[n] for n in ("pq_search_indexed", "pq_search_exact")}
    launches["pq_search_indexed_4bit"] = onehot["pq_search_indexed"]
    say("ivf-main", f"{nsearch} IVF searches + 3 two-stage searches in {wall:.2f} s; "
        f"launches {launches}, of which on the one-hot route {onehot}")
    path_kernels = {  # kernel -> the name of its row
        "sq_search_indexed_exact": "sq_search_indexed_exact",
        "sq_search_indexed_approx": "sq_search_indexed_approx",
        "bq_search_indexed": "bq_search_indexed",
        "pq_search_indexed": "pq_search_indexed",
        "sq_search_exact": "sq_search_exact_ivf",
        "sq_search_approx": "sq_search_approx_ivf",
        "bq_search_exact": "bq_search_exact_ivf",
        "pq_search_exact": "pq_search_exact_ivf",
        "pq_search_approx": "pq_search_approx_ivf",
    }
    for kname in path_kernels:
        require(launches[kname] > 0, f"IVF main path launched {kname}")
    require_sign_ws("IVF main path", launches, ("bq_search_indexed", "bq_search_approx"))
    for kname, n in onehot.items():
        require(0 < n < launches[kname], f"IVF main path launched {kname} on the one-hot "
                "route (4-bit IVF-PQ) and on the ring")
    scans, searches = sum(launches[k] for k in path_kernels), nsearch + len(twos)
    for kname, n in onehot.items():
        launches[kname] -= n
    say("ivf-main", f"{scans} scan-kernel launches for {searches} searches: "
        f"{scans / searches:.2f} per search (probe, union, corr and dedupe are torch ops)")
    require(scans == searches, "one scan kernel per IVF search (no chunking at these shapes)")
    rec = {}
    for key, (s, i) in res.items():
        require(s.shape == (Q, K) and bool(np.isfinite(s).all())
                and bool(((i >= 0) & (i < PN)).all()), f"IVF {key}: finite scores, valid ids")
        rec["/".join(map(str, key)) if isinstance(key, tuple) else key] = recall(i, oracle, K)
    eq_sq = idx["sq"].encode_query(queries)
    _, i_c = idx["sq"].top_k(eq_sq, K)
    rec["ivf_sq_serve"] = recall(i_c, oracle, K)
    say("ivf-main", f"recall@{K} vs the f32 oracle (nprobe {IVF_NPROBE}, nscan "
        f"{'/'.join(map(str, IVF_NSCANS))}; two-stage and ivf_sq_serve at "
        f"nprobe {idx['sq'].metadata.nprobe} nscan {idx['sq'].metadata.nscan}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    require(rec["ivf_sq_f32"] >= IVF_SQ_F32_RECALL_MIN,
            f"IVF-SQ -> f32 recall@{K} >= {IVF_SQ_F32_RECALL_MIN:.4f}")
    # Rescoring cannot add what the probe missed; among the scanned rows it
    # ranks at least as well as SQ (on this corpus the two tie closely).
    require(rec["ivf_sq_f32"] >= rec["ivf_sq_serve"], "IVF-SQ -> f32 not below IVF-SQ alone")

    # ---------------------------------------------- the path's invariants
    for name in ("sq", "sq_res"):
        ivf, nb = idx[name], idx[name].metadata.nbuckets
        eq = ivf.encode_query(queries)
        for nscan in (IVF_NSCANS[0], nb):
            a = ivf.top_k(eq, K, method="exact", nprobe=IVF_NPROBE, nscan=nscan,
                          scan="indexed")
            b = ivf.top_k(eq, K, method="exact", nprobe=IVF_NPROBE, nscan=nscan,
                          scan="compact")
            require(np.array_equal(a[0], b[0]), f"{name} nscan {nscan}: indexed == compact "
                    "exact values")
    full_sq = ScalarQuantizerU8.encode(data, params)
    eq_full = full_sq.encode_query(queries)
    f_s, f_i = full_sq.top_k(eq_full, K)
    rec["full_sq"] = recall(f_i, oracle, K)
    p_s, _ = idx["sq"].top_k(eq_sq, K, nprobe=idx["sq"].metadata.nbuckets,
                             nscan=idx["sq"].metadata.nbuckets)
    require(np.array_equal(f_s, p_s), "IVF-SQ over every bucket == the full SQ scan")
    old_chunk = ivf_mod._INDEXED_CHUNK_TILES
    try:
        for name in ("sq", "sq_res"):
            ivf, nb = idx[name], idx[name].metadata.nbuckets
            eq = ivf.encode_query(queries)
            u = ivf.top_k(eq, K, method="exact", nprobe=IVF_NPROBE, nscan=nb)
            ivf_mod._INDEXED_CHUNK_TILES = IVF_CHECK_CHUNK_TILES
            c = ivf.top_k(eq, K, method="exact", nprobe=IVF_NPROBE, nscan=nb)
            ivf_mod._INDEXED_CHUNK_TILES = old_chunk
            require(np.array_equal(u[0], c[0]), f"{name}: chunked indexed scan == unchunked")
    finally:
        ivf_mod._INDEXED_CHUNK_TILES = old_chunk
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("sq_res", "opq_res_512", "bq"):
            ivf = idx[name]
            d, mpath = os.path.join(tmp, f"{name}.bin"), os.path.join(tmp, f"{name}.json")
            ivf.save(d, mpath)
            back = IVFIndex.load(d, mpath, params)
            for method in ("exact", "approx"):
                a = ivf.top_k(ivf.encode_query(queries), K, method=method)
                b = back.top_k(back.encode_query(queries), K, method=method)
                require(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
                        f"{name} {method}: search after save/load equals search before")
    say("ivf-check", "indexed == compact (exact, nscan 256 and every bucket), full probe "
        "== full scan, chunked == unchunked, save/load equals: all hold")

    # ------------------------- every kernel against plain, at the path's shapes
    props = torch.cuda.get_device_properties(0)
    clock = max_sm_clock_hz()
    q_dev = torch.from_numpy(queries).to(dev)
    recs = []
    kk2 = 2 * K

    def record(name, err, fn, plain_fn, bnd, lib=None):
        recs.append(dict(name=name, launches=launches[name.replace("_ivf", "")]
                         if name.endswith("_ivf") else launches[name],
                         max_abs_err=err, ms=timed_ms(fn), plain_ms=plain_ms(plain_fn),
                         bound=bnd, library_ms=lib))
        r = recs[-1]
        say("time", f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) per {Q}-query batch, k={kk2}, on {smi}")

    def sq_bound(rows, d, corr_rows=0, sel=0):
        b = rows * d + rows * 4 + Q * (d + 8) + corr_rows * Q * 4 + sel * 4 + Q * kk2 * 8
        return bound(b, 2 * Q * rows * d, INT8_OPS_PER_S)

    nscan = IVF_NSCANS[0]
    for name, with_corr in (("sq", False), ("sq_res", True)):
        ivf = idx[name]
        s = ivf.metadata.bucket_size
        union = ivf_union(ivf, q_dev, IVF_NPROBE, nscan)
        tiles = tiles_of(union, s, s)
        require(not bool((torch.diff(tiles) == 1).all()), "a non-contiguous tile list")
        eq, inner = ivf._family_arrays(ivf.encode_query(queries)[1])
        qcodes, qoff = eq
        codes, voff, mult = inner
        corr = (torch.repeat_interleave(ivf_corr(ivf, q_dev, union), s // 512, dim=0)
                .contiguous() if with_corr else None)
        rows = ktile.tile_rows(tiles, s)
        scores = sq_kernel.sq_scores_plain(qcodes, qoff, codes[rows], voff[rows], mult,
                                           distance_type=DistanceType.DOT,
                                           n_valid=rows.shape[0])
        if corr is not None:
            scores = scores + ktile.expand_corr(corr, selection=True)
        col = column_map(rows, codes.shape[0], dev)
        for mode in ("exact", "approx"):
            kname = "sq_search_indexed_" + mode
            kw = dict(distance_type=DistanceType.DOT, k=kk2, mode=mode, tile_n=s)
            args = (qcodes, qoff, codes, voff, mult, tiles, corr)
            v, i = sq_kernel.sq_search_indexed(*args, **kw)
            pv, pi = sq_kernel.sq_search_indexed_plain(*args, **kw)
            torch.cuda.synchronize()
            what = f"{'K9b' if mode == 'exact' else 'K9a'} {name}"
            if mode == "exact":
                check_exact_pairs(v, i, pv, scores, col, what)
                # The radix select (kk past ktile.QUEUE_K_MAX) over the same tiles.
                kw6 = dict(kw, k=600)
                v6, i6 = sq_kernel.sq_search_indexed(*args, **kw6)
                p6, _ = sq_kernel.sq_search_indexed_plain(*args, **kw6)
                torch.cuda.synchronize()
                check_exact_pairs(v6, i6, p6, scores, col, f"{what} k=600")
            else:
                require(torch.equal(v, pv) and torch.equal(i, pi), f"{what}: equal plain")
            if with_corr:  # the path's shape: the residual index's scan
                if mode == "exact":  # K9a / K9b's yardstick: the selected rows, gathered once
                    lib9 = library_time(
                        f"torch._int_mm + epilogue + corr + torch.topk (k={kk2}) over the "
                        f"{rows.shape[0]} selected rows, K9a / K9b's yardstick",
                        sq_composite(qcodes, qoff, codes[rows], voff[rows], mult, kk2,
                                     ktile.expand_corr(corr, selection=True)), smi)
                record(kname, 0.0, lambda a=args, k=kw: sq_kernel.sq_search_indexed(*a, **k),
                       lambda a=args, k=kw: sq_kernel.sq_search_indexed_plain(*a, **k),
                       sq_bound(rows.shape[0], codes.shape[1], corr.shape[0], tiles.shape[0]),
                       lib9)
        say("K9", f"{name}: K9b (k={kk2}, queue select; k=600, radix select) / K9a over "
            f"{tiles.shape[0]} permuted tiles of {s} rows{' with corr' if with_corr else ''}: "
            "equal to plain")
        if with_corr:  # K1 / K2 with corr: the compact scan of the same union
            nb = ivf.metadata.nbuckets
            width = union.shape[0] * s
            g = ivf_mod._gather_buckets(codes, union, nb, s, 0)
            gv = ivf_mod._gather_buckets(voff, union, nb, s, 0)
            corr_c = torch.repeat_interleave(ivf_corr(ivf, q_dev, union).T, s // 512, dim=1)
            corr_c = corr_c.contiguous()
            sc = sq_kernel.sq_scores_plain(qcodes, qoff, g, gv, mult,
                                           distance_type=DistanceType.DOT, n_valid=width)
            sc = sc + ktile.expand_corr(corr_c)
            for mode in ("exact", "approx"):
                kw = dict(distance_type=DistanceType.DOT, n_valid=width, k=kk2, mode=mode)
                args = (qcodes, qoff, g, gv, mult, corr_c)
                v, i = sq_kernel.sq_search(*args, **kw)
                pv, pi = sq_kernel.sq_search_plain(*args, **kw)
                torch.cuda.synchronize()
                what = f"{'K1' if mode == 'exact' else 'K2'} corr"
                if mode == "exact":
                    check_exact_pairs(v, i, pv, sc, torch.arange(width, device=dev), what)
                else:
                    require(torch.equal(v, pv) and torch.equal(i, pi), f"{what}: equal plain")
                record(f"sq_search_{mode}_ivf", 0.0,
                       lambda a=args, k=kw: sq_kernel.sq_search(*a, **k),
                       lambda a=args, k=kw: sq_kernel.sq_search_plain(*a, **k),
                       sq_bound(width, g.shape[1], width // 512))
            say("K1/K2", f"corr forms over the compact {width}-row union: equal to plain")

    # K10 and K5c (the compact exact scan) on IVF-BQ.
    ivf = idx["bq"]
    s, nb = ivf.metadata.bucket_size, ivf.metadata.nbuckets
    planes = ivf.quantizer.planes
    qw = ivf.encode_query(queries)[1].planes
    union = ivf_union(ivf, q_dev, IVF_NPROBE, nscan)
    itile = bq_kernel.indexed_tile_n(planes.shape[0] * 32, s)
    tiles = tiles_of(union, s, itile)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=PD, k=kk2, tile_n=itile)
    v, i = bq_kernel.bq_search_indexed(qw, planes, tiles, **kw)
    pv, pi = bq_kernel.bq_search_indexed_plain(qw, planes, tiles, **kw)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi), "K10: equal to plain")
    wt = bq_kernel.true_words(PD)
    rows = tiles.shape[0] * itile
    bnd, i8 = bq_bound(rows * wt * 4 + Q * wt * 4 + tiles.shape[0] * 4 + Q * kk2 * 8, Q,
                       rows, PD)
    sel_rows = ktile.tile_rows(tiles, itile)
    lib10 = library_time(
        f"torch._int_mm of the +-1 signs + torch.topk (k={kk2}) over the {rows} selected "
        "rows, K10's yardstick",
        sign_composite(pm1_rows(qw, PD), pm1_rows(planes[:, sel_rows].t(), PD),
                       bq_kernel.metric_sign(DistanceType.DOT, False), kk2), smi)
    record("bq_search_indexed", 0.0,
           lambda: bq_kernel.bq_search_indexed(qw, planes, tiles, **kw),
           lambda: bq_kernel.bq_search_indexed_plain(qw, planes, tiles, **kw), bnd, lib10)
    say("bound", f"bq_search_indexed: as +-1 int8 multiply-adds at 1,979 TOPS {i8:.4f} ms")
    g = ivf_mod._gather_buckets(planes, union, nb, s, 1)
    g = torch.nn.functional.pad(g, (0, (-g.shape[1]) % bq_kernel.TILE_N)).contiguous()
    width = union.shape[0] * s
    bkw = dict(distance_type=DistanceType.DOT, invert=False, dim=PD, n_valid=width, k=kk2)
    v, i = bq_kernel.bq_search(qw, g, **bkw)
    pv, _ = bq_kernel.bq_search_plain(qw, g, **bkw)
    sc = bq_kernel.bq_scores_plain(qw, g, distance_type=DistanceType.DOT, invert=False,
                                   dim=PD, n_valid=width)
    torch.cuda.synchronize()
    check_exact_pairs(v, i, pv, sc, torch.arange(width, device=dev), "K5c compact")
    bnd, i8 = bq_bound(width * wt * 4 + Q * wt * 4 + Q * kk2 * 8, Q, width, PD)
    record("bq_search_exact_ivf", 0.0, lambda: bq_kernel.bq_search(qw, g, **bkw),
           lambda: bq_kernel.bq_search_plain(qw, g, **bkw), bnd)
    say("bound", f"bq_search_exact_ivf: as +-1 int8 multiply-adds at 1,979 TOPS {i8:.4f} ms")
    say("K10/K5c", f"IVF-BQ: K10 over {tiles.shape[0]} permuted tiles of {itile} rows and "
        f"K5c over the compact {width}-row union: equal to plain")

    # K11 (residual OPQ at S = 1024), with and without the additives, three
    # LUT words, and once at 4 bits; K7a / K7b with them at the README geometry.
    ivf = idx["opq_res"]
    s = ivf.metadata.bucket_size
    lut = ivf.encode_query(queries)[1].lut
    ct = ivf.quantizer.codes_t
    m = ivf.quantizer.num_chunks
    union = ivf_union(ivf, q_dev, IVF_NPROBE, nscan)
    tiles = tiles_of(union, s, s)
    corr = torch.repeat_interleave(ivf_corr(ivf, q_dev, union), s // 512, dim=0).contiguous()
    rowadd = ivf._resid_pq
    rows = tiles.shape[0] * s
    for precision in ("int8", "bf16", "bf16x2"):
        for add in ((rowadd, corr), (None, None)):
            kw = dict(k=kk2, precision=precision, tile_n=s)
            v, i = pq_kernel.pq_search_indexed(lut, ct, tiles, *add, **kw)
            pv, pi = pq_kernel.pq_search_indexed_plain(lut, ct, tiles, *add, **kw)
            torch.cuda.synchronize()
            require(torch.equal(v, pv) and torch.equal(i, pi),
                    f"K11 {precision}{' residual' if add[0] is not None else ''}: equal plain")
    g4 = torch.Generator(device=dev)
    g4.manual_seed(SEED + 4)
    lut4 = torch.randn(Q, m, 16, generator=g4, device=dev)
    ct4 = ct & 15
    kw4 = dict(k=kk2, precision="int8", tile_n=s)
    v, i = pq_kernel.pq_search_indexed(lut4, ct4, tiles, rowadd, corr, **kw4)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut4, ct4, tiles, rowadd, corr, **kw4)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi),
            "K11 4-bit with (rowadd, corr): equal plain")
    prec = pq_kernel.lut_precision(residual=True)
    kw = dict(k=kk2, precision=prec, tile_n=s)
    record("pq_search_indexed", 0.0,
           lambda: pq_kernel.pq_search_indexed(lut, ct, tiles, rowadd, corr, **kw),
           lambda: pq_kernel.pq_search_indexed_plain(lut, ct, tiles, rowadd, corr, **kw),
           pq_bound("search", Q, rows, m, 256, kk2, prec, props, clock))
    say("K11", f"residual OPQ: K11 over {tiles.shape[0]} permuted tiles of {s} rows, int8 / "
        "bf16 / bf16x2 LUT with and without (rowadd, corr), and 4-bit int8 with them (the "
        "one-hot route): equal to plain")
    # K11 of the 4-bit IVF-PQ index at its own selection: the one-hot route.
    ivf = idx["pq4"]
    s = ivf.metadata.bucket_size
    lut4, ct4 = ivf.encode_query(queries)[1].lut, ivf.quantizer.codes_t
    m4 = ivf.quantizer.num_chunks
    tiles4 = tiles_of(ivf_union(ivf, q_dev, IVF_NPROBE, nscan), s, s)
    kw4 = dict(k=kk2, precision="int8", tile_n=s)
    v, i = pq_kernel.pq_search_indexed(lut4, ct4, tiles4, **kw4)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut4, ct4, tiles4, **kw4)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi), "K11 4-bit IVF-PQ: equal plain")
    rows4 = tiles4.shape[0] * s
    record("pq_search_indexed_4bit", 0.0,
           lambda: pq_kernel.pq_search_indexed(lut4, ct4, tiles4, **kw4),
           lambda: pq_kernel.pq_search_indexed_plain(lut4, ct4, tiles4, **kw4),
           pq_bound("search", Q, rows4, m4, 16, kk2, "int8", props, clock))
    say("K11", f"4-bit IVF-PQ (m = {m4}): K11 over {tiles4.shape[0]} permuted tiles of {s} "
        "rows, int8 LUT (the one-hot route): equal to plain")

    ivf = idx["opq_res_512"]
    s, nb = ivf.metadata.bucket_size, ivf.metadata.nbuckets
    lut = ivf.encode_query(queries)[1].lut
    union = ivf_union(ivf, q_dev, IVF_NPROBE, nscan)
    width = union.shape[0] * s
    rows_u = (union[:, None] * s + torch.arange(s, device=dev)).reshape(-1)
    qz = ivf.quantizer
    ctu = qz._codes[rows_u].T if qz._codes is not None else qz._codes_t[:, rows_u]
    npadc = width + (-width) % pq_kernel.TILE_N
    ctu = torch.nn.functional.pad(ctu, (0, npadc - width)).contiguous()
    ra = torch.nn.functional.pad(ivf_mod._gather_buckets(ivf._resid_pq, union, nb, s, 0),
                                 (0, npadc - width))
    corr_c = torch.repeat_interleave(ivf_corr(ivf, q_dev, union).T, s // 512, dim=1)
    corr_c = torch.nn.functional.pad(corr_c, (0, (npadc - width) // 512)).contiguous()
    for mode in ("exact", "approx"):
        kname = f"pq_search_{mode}_ivf"
        kw = dict(n_valid=width, k=kk2, mode=mode, precision=prec)
        args = (lut, ctu, ra, corr_c)
        v, i = pq_kernel.pq_search(*args, **kw)
        pv, pi = pq_kernel.pq_search_plain(*args, **kw)
        torch.cuda.synchronize()
        if mode == "exact":
            sc = pq_kernel.lut_scores_plain(lut, ctu, n_valid=width, precision=prec)
            sc = (sc + ra[None, :width]) + ktile.expand_corr(corr_c)[:, :width]
            check_exact_pairs(v, i, pv, sc, torch.arange(width, device=dev), "K7b residual")
        else:
            require(torch.equal(v, pv) and torch.equal(i, pi), "K7a residual: equal plain")
        record(kname, 0.0, lambda a=args, k=kw: pq_kernel.pq_search(*a, **k),
               lambda a=args, k=kw: pq_kernel.pq_search_plain(*a, **k),
               pq_bound("search", Q, width, qz.num_chunks, 256, kk2, prec, props, clock))
    say("K7", f"README geometry (S = {s}): K7b / K7a with (rowadd, corr) over the compact "
        f"{width}-row union, {prec} LUT: equal to plain")

    # --------------------------------------------------- batches and breakdown
    batch = {}
    for name, ivf in idx.items():
        eq = ivf.encode_query(queries)
        for method in ("exact", "approx"):
            batch[f"{name}/{method}"] = wall_ms(
                lambda ivf=ivf, eq=eq, method=method: ivf.top_k(
                    eq, K, method=method, nprobe=IVF_NPROBE, nscan=nscan), reps=11)
    for name, two in twos.items():
        batch[name] = wall_ms(lambda two=two: two.top_k(two.encode_query(queries), K), reps=11)
    batch["full_sq_exact"] = wall_ms(lambda: full_sq.top_k(eq_full, K), reps=11)
    for key, t in batch.items():
        say("time", f"{key}: {t:.4f} ms host wall per {Q}-query batch (nprobe {IVF_NPROBE}, "
            f"nscan {nscan}; two-stage at the serving defaults) on {smi}")
    say("time", f"beside them: the full SQ scan {batch['full_sq_exact']:.4f} ms (K1 over "
        f"{PN} rows) at recall@{K} {rec['full_sq']:.4f}, and path 3's OPQ -> f32 full scan "
        f"{opq_f32_ms:.4f} ms, on {smi}")
    breakdown = {}
    for name in ("sq", "opq_res"):
        ivf = idx[name]
        eqn = ivf.encode_query(queries)
        eq, inner = ivf._family_arrays(eqn[1])
        s = ivf.metadata.bucket_size
        union = ivf_union(ivf, q_dev, IVF_NPROBE, nscan)
        tiles = tiles_of(union, s, s)
        parts = {"probe_union_ms": timed_ms(lambda ivf=ivf: ivf_union(ivf, q_dev, IVF_NPROBE,
                                                                      nscan))}
        if name == "sq":
            def scan():
                return sq_kernel.sq_search_indexed(*eq, *inner, tiles, distance_type=DistanceType.DOT,
                                                   k=kk2, mode="approx", tile_n=s)
        else:
            parts["corr_ms"] = timed_ms(lambda ivf=ivf, union=union: ivf_corr(ivf, q_dev, union))
            corr = torch.repeat_interleave(ivf_corr(ivf, q_dev, union), s // 512,
                                           dim=0).contiguous()

            def scan(ivf=ivf, corr=corr, eq=eq, tiles=tiles, s=s):
                return pq_kernel.pq_search_indexed(eq[0], ivf.quantizer.codes_t, tiles,
                                                   ivf._resid_pq, corr, k=kk2,
                                                   precision=prec, tile_n=s)
        parts["kernel_ms"] = timed_ms(scan)
        sv, loc = scan()
        ids = ivf._slot_ids_dev.reshape(-1)[loc.clamp(min=0).long()]
        parts["dedupe_ms"] = timed_ms(lambda: ivf_mod._dedupe_select(sv, ids, Q, K, kk2))
        parts["chunk_merge_ms"] = 0.0  # not reached: T tiles <= _INDEXED_CHUNK_TILES
        parts["span_ms"] = timed_ms(lambda ivf=ivf, eqn=eqn: ivf.top_k_device(
            eqn, K, method="approx", nprobe=IVF_NPROBE, nscan=nscan))
        parts["wall_ms"] = wall_ms(lambda ivf=ivf, eqn=eqn: ivf.top_k(
            eqn, K, method="approx", nprobe=IVF_NPROBE, nscan=nscan))
        parts["host_ms"] = parts["wall_ms"] - parts["span_ms"]
        breakdown[name] = parts
        say("breakdown", f"{name} approx top_k, nscan {nscan} ({tiles.shape[0]} tiles): "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f" (chunk merge not reached below {ivf_mod._INDEXED_CHUNK_TILES} tiles), on {smi}")
        if do_profile:
            profile(f"IVF {name} approx top_k_device", lambda ivf=ivf, eqn=eqn: ivf.top_k_device(
                eqn, K, method="approx", nprobe=IVF_NPROBE, nscan=nscan))
    keep = {"idx": idx, "data": data, "data_dev": data_dev, "queries": queries,
            "oracle": oracle, "rec": rec}
    return recs, {"recall_at_10": rec, "build_s": build_s, "batch_ms": batch,
                  "breakdown_ms": breakdown,
                  "nbuckets": {n: i.metadata.nbuckets for n, i in idx.items()}}, keep


def res_corpus(n, q, dim, gen, dev, chunk=100_000):
    """The JAX package's residual-regime corpus (tests/test_ivf.py:307-318),
    made on the card: 6 gaussian centres x 3, each row a centre plus 0.3
    noise, not normalized; queries are distinct corpus rows plus 0.05 noise.
    Returns (data [n, dim], queries [q, dim])."""
    centers = torch.randn(6, dim, generator=gen, device=dev) * 3
    data = torch.empty((n, dim), device=dev)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        a = torch.randint(0, 6, (r1 - r0,), generator=gen, device=dev)
        data[r0:r1] = centers[a] + 0.3 * torch.randn(r1 - r0, dim, generator=gen, device=dev)
    pick = torch.randperm(n, generator=gen, device=dev)[:q]
    return data, data[pick] + 0.05 * torch.randn(q, dim, generator=gen, device=dev)


def rbq_recalls(dev, n, dim, seed):
    """Plain and residual IVF-BQ recall@10 over every bucket (exact search)
    on the residual-regime corpus at the automatic geometry: the lift the
    card's run is held to, rehearsed on the CPU."""
    from quantization_tpu_torch import DistanceType, IVFIndex, VectorParameters

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data_dev, q_dev = res_corpus(n, Q, dim, gen, dev)
    data, queries = data_dev.cpu().numpy(), q_dev.cpu().numpy()
    oracle = torch.topk(q_dev @ data_dev.T, K, dim=1).indices.cpu().numpy()
    params = VectorParameters(dim, n, DistanceType.DOT, False)
    out = {}
    for residual in (False, True):
        ivf = IVFIndex.encode(data, params, quantizer="bq", residual=residual, device=dev)
        nb = ivf.metadata.nbuckets
        _, ids = ivf.top_k(ivf.encode_query(queries), K, method="exact", nprobe=nb, nscan=nb)
        out["residual" if residual else "plain"] = recall(ids, oracle, K)
    out["nbuckets"] = nb
    return out


def ids_equal_where_untied(s, i, ws, wi, what):
    for r in range(s.shape[0]):
        vals, cnt = np.unique(ws[r], return_counts=True)
        untied = np.isin(ws[r], vals[cnt == 1]) & (ws[r] != ws[r][-1])
        require(np.array_equal(i[r][untied], wi[r][untied]), f"{what}: ids equal where untied")


def ids_equal_where_apart(s, i, ws, wi, what, rtol=1e-5, atol=1e-4):
    """Ids equal wherever the reference's value stands further than the
    tolerance from its neighbours in the row (a residual search's values
    agree only to that tolerance, so closer ones may swap)."""
    for r in range(s.shape[0]):
        tol = atol + rtol * np.abs(ws[r])
        gaps = np.abs(np.diff(ws[r]))
        apart = np.ones(ws.shape[1], bool)
        apart[:-1] &= gaps > tol[:-1]
        apart[1:] &= gaps > tol[1:]
        apart[-1] = False  # the k-th may tie with rows past k
        require(np.array_equal(i[r][apart], wi[r][apart]), f"{what}: ids equal where apart")


def sync_counts(prof):
    """Host waits and copies in a profiler window, by name: the runtime's
    synchronize calls and the device's memcpy kinds."""
    out = {}
    for e in prof.key_averages():
        if "Synchronize" in e.key or "Memcpy" in e.key or "memcpy" in e.key.lower():
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def pinned_pool():
    """PyTorch's pinned host pool: (blocks it has made, microseconds spent in
    the CUDA allocations that made them)."""
    st = torch.cuda.host_memory_stats()
    return st.get("num_host_alloc") or 0, st.get("host_alloc_time.total") or 0


class SearchSpans:
    """A searchable whose ``top_k_device`` calls are each bracketed by two
    timing events on the current stream. A span runs from the stream
    reaching the search to its last kernel, so a gap inside one search
    (the device waiting for the host's next launch) counts as busy: the
    idle share read from the spans is a lower bound."""

    def __init__(self, index):
        self.index, self.events = index, []

    def encode_query(self, queries):
        return self.index.encode_query(queries)

    def top_k_device(self, eq, k, **knobs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.index.top_k_device(eq, k, **knobs)
        b.record()
        self.events.append((a, b))
        return out


def rbq_path(dev, smi, do_profile):
    """Path 5: residual IVF-BQ at 1M x 768 on the residual-regime corpus (the
    JAX package's measured regime), SQ L1 at 100k x 1024, and the serving
    layer — recommend -> plan.serve -> search_stream — over the residual
    index behind an f32 rescorer; every new kernel against its plain version
    at the path's shapes, and the times."""
    import warnings

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from quantization_tpu_torch import (
        DistanceType, IVFIndex, PipelinedSearcher, ScalarQuantizerU8, VectorParameters,
        exact_topk, ivf_from_numpy, ivf_to_numpy, recall_at_k, recommend,
    )
    from quantization_tpu_torch.models import ivf as ivf_mod
    from quantization_tpu_torch.ops import bq as bq_ops
    from quantization_tpu_torch.ops.kernels import bq_kernel, ktile, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel)
    dot = DistanceType.DOT
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    data_dev, q_all = res_corpus(PN, (2 + SERVE_BATCHES) * Q, PD, gen, dev)
    data = data_dev.cpu().numpy()
    q_dev = q_all[:Q].contiguous()
    queries, calib = q_dev.cpu().numpy(), q_all[Q:2 * Q].cpu().numpy()
    serve = [q_all[(2 + j) * Q:(3 + j) * Q].cpu().numpy() for j in range(SERVE_BATCHES)]
    params = VectorParameters(PD, PN, dot, False)
    gt_s = q_dev @ data_dev.T  # [Q, PN] exact f32 scores, TF32 off
    oracle = torch.topk(gt_s, K, dim=1).indices.cpu().numpy()
    say("rbq-data", f"{PN} x {PD} residual-regime corpus (6 centres x 3, sigma 0.3, not "
        f"normalized) and {(2 + SERVE_BATCHES) * Q} queries made on the card")

    # ------------------------------------------------------------- builds
    idx, build_s = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the unnormalized regime must not warn
        for name, residual in (("bq", False), ("rbq", True)):
            t0 = time.perf_counter()
            idx[name] = IVFIndex.encode(data, params, quantizer="bq", residual=residual)
            torch.cuda.synchronize()
            build_s[name] = time.perf_counter() - t0
            m = idx[name].metadata
            say("rbq-build", f"{name}: nlist {m.nlist}, bucket_size {m.bucket_size}, "
                f"{m.nbuckets} buckets, residual_scale {m.residual_scale:.6f}, built in "
                f"{build_s[name]:.2f} s, no warning")
            require((m.nlist, m.bucket_size) == ivf_mod.auto_geometry(PN, residual),
                    f"{name}: auto geometry")
    rbq = idx["rbq"]
    require(rbq.metadata.residual_scale > 0, "residual_scale (beta) set by the build")

    # ----------------------------------------- the main path, counted
    reset_all(*mods)
    t0 = time.perf_counter()
    full = {}
    for name, ivf in idx.items():  # every bucket, exact: K5b (K5c for plain BQ)
        nb = ivf.metadata.nbuckets
        full[name] = ivf.top_k(ivf.encode_query(queries), K, method="exact", nprobe=nb,
                               nscan=nb)
    eq = rbq.encode_query(queries)
    res = {}
    for nscan in IVF_NSCANS:
        for method, scan in (("approx", "auto"), ("approx", "compact"), ("exact", "auto")):
            res[method, scan, nscan] = rbq.top_k(eq, K, method=method, nprobe=IVF_NPROBE,
                                                 nscan=nscan, scan=scan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(*mods)
    say("rbq-main", f"2 full-probe + {len(res)} residual IVF-BQ searches in {wall:.2f} s; "
        f"launches {launches}")
    for kname in ("bq_search_exact_res", "bq_search_approx_res", "bq_search_indexed_res"):
        require(launches[kname] > 0, f"residual IVF-BQ main path launched {kname}")
    require(launches["bq_search_indexed_res"] == len(IVF_NSCANS)
            and launches["bq_search_approx_res"] == len(IVF_NSCANS)
            and launches["bq_search_exact_res"] == 1 + len(IVF_NSCANS),
            "one residual scan kernel per residual search")

    rec = {name: recall(i, oracle, K) for name, (_, i) in full.items()}
    for key, (sv, i) in list(full.items()) + list(res.items()):
        require(sv.shape == (Q, K) and bool(np.isfinite(sv).all())
                and bool(((i >= 0) & (i < PN)).all())
                and all(len(set(r.tolist())) == K for r in i), f"{key}: finite, valid, distinct")
    for key, (_, i) in res.items():
        rec["rbq/" + "/".join(map(str, key))] = recall(i, oracle, K)
    sv, ids = full["rbq"]
    exact_vals = torch.gather(gt_s, 1, torch.from_numpy(ids).to(dev).long()).cpu().numpy()
    err = float(np.mean(np.abs(sv - exact_vals)))
    spread = float((gt_s.amax(1) - gt_s.amin(1)).mean())
    lift = rec["rbq"] - rec["bq"]
    say("rbq-main", f"recall@{K} vs the f32 oracle: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec.items()) + f"; lift over every bucket {lift:.4f} "
        f"(CPU rehearsal {RBQ_LIFT_REHEARSAL}); residual scores' mean |error| {err:.4f} "
        f"against a mean per-query spread of {spread:.4f}")
    require(lift >= 0.5 * RBQ_LIFT_REHEARSAL,
            f"residual IVF-BQ recall >= plain + half the rehearsed lift ({RBQ_LIFT_REHEARSAL})")
    require(err < 0.25 * spread, "residual scores in data units (tests/test_ivf.py:442-451)")

    # ---------------------------------------------- the path's invariants
    nb, s = rbq.metadata.nbuckets, rbq.metadata.bucket_size
    planes = rbq.quantizer.planes
    qaff = (eq[1].codes, eq[1].mult, eq[1].qb)
    union_all = ivf_union(rbq, q_dev, nb, nb)
    qc_all = ivf_corr(rbq, q_dev, union_all)  # [nb, Q], the model's bucket term
    corr_rows = torch.empty((Q, nb), device=dev)
    corr_rows[:, union_all] = qc_all.T
    plain_full = bq_ops.score_affine(*qaff, planes[:, :nb * s]) + torch.repeat_interleave(
        corr_rows, s, dim=1)
    plain_full[:, rbq._slot_ids_dev.reshape(-1) < 0] = float("-inf")  # pad slots
    fv = torch.topk(plain_full, K, dim=1).values.cpu().numpy()
    require(np.array_equal(full["rbq"][0], fv), "the full probe == a plain scan of every row")
    del plain_full
    old_chunk = ivf_mod._INDEXED_CHUNK_TILES
    try:
        u = rbq.top_k(eq, K, method="approx", nprobe=IVF_NPROBE, nscan=IVF_NSCANS[1])
        ivf_mod._INDEXED_CHUNK_TILES = IVF_CHECK_CHUNK_TILES
        c = rbq.top_k(eq, K, method="approx", nprobe=IVF_NPROBE, nscan=IVF_NSCANS[1])
    finally:
        ivf_mod._INDEXED_CHUNK_TILES = old_chunk
    require(np.array_equal(u[0], c[0]), "chunked indexed scan == unchunked (values)")
    carried = ivf_from_numpy(*ivf_to_numpy(rbq))
    with tempfile.TemporaryDirectory() as tmp:
        d, mpath = os.path.join(tmp, "rbq.bin"), os.path.join(tmp, "rbq.json")
        rbq.save(d, mpath)
        back = IVFIndex.load(d, mpath, params)
    for other, what in ((back, "save/load"), (carried, "ivf_to_numpy -> ivf_from_numpy")):
        require(other.metadata.residual_scale == rbq.metadata.residual_scale, what)
        for method in ("exact", "approx"):
            a = rbq.top_k(eq, K, method=method)
            b = other.top_k(other.encode_query(queries), K, method=method)
            require(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
                    f"{what} {method}: search equals search before")
    say("rbq-check", "full probe == plain scan of every row, chunked == unchunked, "
        "save/load and the numpy round trip equal: all hold")

    # ------------------------- every kernel against plain, at the path's shapes
    kk2 = 2 * K
    nscan = IVF_NSCANS[0]
    union = ivf_union(rbq, q_dev, IVF_NPROBE, nscan)
    qc_u = ivf_corr(rbq, q_dev, union)
    itile = bq_kernel.indexed_tile_n(planes.shape[0] * 32, s)
    tiles = tiles_of(union, s, itile)
    require(not bool((torch.diff(tiles) == 1).all()), "a non-contiguous tile list")
    corr_t = torch.repeat_interleave(qc_u, s // ktile.CORR_BLK, dim=0).contiguous()
    kw_i = dict(distance_type=dot, invert=False, dim=PD, k=kk2, tile_n=itile, query_affine=qaff,
                rowadd=rbq._resid_bq)
    v, i = bq_kernel.bq_search_indexed(None, planes, tiles, corr_t, **kw_i)
    pv, pi = bq_kernel.bq_search_indexed_plain(None, planes, tiles, corr_t, **kw_i)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi),
            "K10 value query + rowadd + corr: equal plain")
    width = union.shape[0] * s
    g = ivf_mod._gather_buckets(planes, union, nb, s, 1)
    npadc = width + (-width) % bq_kernel.TILE_N
    g = torch.nn.functional.pad(g, (0, npadc - width)).contiguous()
    corr_c = torch.repeat_interleave(qc_u.T, s // ktile.CORR_BLK, dim=1)
    corr_c = torch.nn.functional.pad(corr_c, (0, (npadc - width) // ktile.CORR_BLK)).contiguous()
    ra = torch.nn.functional.pad(ivf_mod._gather_buckets(rbq._resid_bq, union, nb, s, 0),
                                 (0, npadc - width), value=ktile.NEG)
    kw_c = dict(distance_type=dot, invert=False, dim=PD, n_valid=width, k=kk2, query_affine=qaff,
                rowadd=ra)
    v, i = bq_kernel.bq_search(None, g, corr_c, mode="approx", **kw_c)
    pv, pi = bq_kernel.bq_search_plain(None, g, corr_c, mode="approx", **kw_c)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi),
            "K5a value query + rowadd + corr: equal plain")
    v, i = bq_kernel.bq_search(None, g, corr_c, mode="exact", **kw_c)
    pv, _ = bq_kernel.bq_search_plain(None, g, corr_c, mode="exact", **kw_c)
    sc = bq_kernel._plain_scores(None, g, corr_c, qaff, distance_type=dot, invert=False,
                                 dim=PD, rowadd=ra)[:, :width]
    torch.cuda.synchronize()
    check_exact_pairs(v, i, pv, sc, torch.arange(width, device=dev), "K5b compact")
    kw6 = dict(kw_c, k=600)  # the radix select, past ktile.QUEUE_K_MAX
    v, i = bq_kernel.bq_search(None, g, corr_c, mode="exact", **kw6)
    pv, _ = bq_kernel.bq_search_plain(None, g, corr_c, mode="exact", **kw6)
    torch.cuda.synchronize()
    check_exact_pairs(v, i, pv, sc, torch.arange(width, device=dev), "K5b compact k=600")
    del sc
    say("K10/K5a/K5b", f"value query + rowadd + corr: K10 over {tiles.shape[0]} permuted "
        f"tiles of {itile} rows, K5a and K5b (k={kk2}, queue select; k=600, radix select) "
        f"over the compact {width}-row union: equal to plain")

    recs = []
    rows_b = planes.shape[0] * 4  # plane bytes per row
    dp = planes.shape[0] * 32

    def res_bound(rows, sel=0):
        """Planes, rowadd, queries (values, mult, qb), corr and the tile list
        read once, the candidates written once; 2 * Q * rows * dims int8
        ops."""
        b = rows * (rows_b + 4) + Q * (dp + 8) + Q * rows // ktile.CORR_BLK * 4 + sel * 4
        return bound(b + Q * kk2 * 8, 2 * Q * rows * PD, INT8_OPS_PER_S)

    # K10's and K5a's yardstick: the expanded planes through torch._int_mm,
    # the epilogue, rowadd, corr and torch.topk (K5b: none, as K1's exact
    # composite is K1's).
    lib_rows = ktile.tile_rows(tiles, itile)
    lib_i = value_composite(planes, qaff, rbq._resid_bq,
                            ktile.expand_corr(corr_t, selection=True), kk2, rows=lib_rows)
    lib_c = value_composite(g, qaff, ra, ktile.expand_corr(corr_c), kk2, n_valid=width)
    for name, fn, plain_fn, bnd, lib_fn in (
        ("bq_search_indexed_res",
         lambda: bq_kernel.bq_search_indexed(None, planes, tiles, corr_t, **kw_i),
         lambda: bq_kernel.bq_search_indexed_plain(None, planes, tiles, corr_t, **kw_i),
         res_bound(width, tiles.shape[0]), lib_i),
        ("bq_search_approx_res",
         lambda: bq_kernel.bq_search(None, g, corr_c, mode="approx", **kw_c),
         lambda: bq_kernel.bq_search_plain(None, g, corr_c, mode="approx", **kw_c),
         res_bound(width), lib_c),
        ("bq_search_exact_res",
         lambda: bq_kernel.bq_search(None, g, corr_c, mode="exact", **kw_c),
         lambda: bq_kernel.bq_search_plain(None, g, corr_c, mode="exact", **kw_c),
         res_bound(width), None),
    ):
        recs.append(dict(name=name, launches=launches[name], max_abs_err=0.0, ms=timed_ms(fn),
                         plain_ms=plain_ms(plain_fn), bound=bnd,
                         library_ms=lib_fn and library_time(
                             f"{name}: torch._int_mm of the expanded planes + epilogue + "
                             "rowadd + corr + torch.topk", lib_fn, smi)))
        r = recs[-1]
        say("time", f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) per {Q}-query batch over {width} rows "
            f"x {PD} dims, k={kk2}, on {smi}")

    # --------------------------------------------------- SQ L1 (K12), counted
    rng = np.random.default_rng(SEED + 6)
    l1_data = rng.random((N, D), dtype=np.float32) * 2.0 - 1.0
    l1_queries = rng.random((Q, D), dtype=np.float32) * 2.0 - 1.0
    l1_params = VectorParameters(D, N, DistanceType.L1, True)
    ivf_l1 = IVFIndex.encode(l1_data, l1_params, quantizer="sq")
    reset_all(*mods)
    t0 = time.perf_counter()
    enc = ScalarQuantizerU8.encode(l1_data, l1_params)
    eq1 = enc.encode_query(l1_queries)
    scores = enc.score_batch(eq1)
    s_ex, i_ex = enc.top_k(eq1, K)
    eqi = ivf_l1.encode_query(l1_queries)
    s_iv, i_iv = ivf_l1.top_k(eqi, K, nprobe=IVF_NPROBE)
    torch.cuda.synchronize()
    l1_wall = time.perf_counter() - t0
    l1_launches = counts(*mods)
    say("l1-main", f"SQ-u8 L1 at {N} x {D}: encode + score_batch + top_k exact, and IVF-SQ "
        f"L1 ({ivf_l1.metadata.nbuckets} buckets, compact scan) in {l1_wall:.2f} s; "
        f"launches {l1_launches}")
    require(l1_launches["sq_scores_l1"] == 3, "L1 score_batch, top_k and the IVF scan through "
            "K12, one launch each")
    require(sum(v for k_, v in l1_launches.items() if k_ != "sq_scores_l1") == 0,
            "L1 launches no other kernel")
    args = (eq1.codes, eq1.offsets, enc.codes, enc.voffsets, enc._mult)
    l1_kw = dict(distance_type=DistanceType.L1, n_valid=N)
    pscores = sq_kernel.sq_scores_plain(*args, **l1_kw)
    torch.cuda.synchronize()
    require(torch.equal(scores, pscores), "K12 equals plain to the bit")
    require(np.array_equal(s_ex, torch.topk(pscores, K, dim=1).values.cpu().numpy()),
            "L1 top_k exact values == plain top-k")
    require(bool(np.isfinite(s_iv).all()) and bool(((i_iv >= 0) & (i_iv < N)).all()),
            "IVF-SQ L1: finite, valid")
    l1_dev = torch.from_numpy(l1_data).to(dev)
    _, l1_oracle = exact_topk(l1_queries, l1_dev, DistanceType.L1, True, K)
    rec["sq_l1_exact"] = recall_at_k(i_ex, l1_oracle)
    rec["ivf_sq_l1"] = recall_at_k(i_iv, l1_oracle)
    say("l1-main", f"K12 equals plain to the bit; recall@{K} vs the f32 L1 oracle: SQ L1 "
        f"exact {rec['sq_l1_exact']:.4f}, IVF-SQ L1 (nprobe {IVF_NPROBE}) "
        f"{rec['ivf_sq_l1']:.4f}")

    def cdist_l1():  # the library yardstick; the port never calls it
        d = torch.cdist(eq1.codes.float()[None], enc.codes[:N].float()[None], p=1)[0]
        return enc._mult * d + eq1.offsets[:, None] + enc.voffsets[None, :N]

    lib = timed_ms(cdist_l1, warmup=1, iters=3, reps=3)
    l1_bnd, l1_int8, l1_pairs, l1_thermo = l1_bound(
        N * D + N * 4 + Q * D + Q * 8 + Q * N * 4, Q, N, D)
    recs.append(dict(name="sq_scores_l1", launches=l1_launches["sq_scores_l1"],
                     max_abs_err=0.0,
                     ms=timed_ms(lambda: sq_kernel.sq_scores(*args, **l1_kw)),
                     plain_ms=plain_ms(lambda: sq_kernel.sq_scores_plain(*args, **l1_kw)),
                     bound=l1_bnd, library_ms=lib))
    r = recs[-1]
    say("time", f"sq_scores_l1: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"torch.cdist(p=1) + epilogue {lib:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}: the cheaper of {Q * N * D / 4:.3e} __vabsdiffu4 + __dp4a pairs "
        f"at {ABSDIFF_PAIRS_PER_S_PER_SM:.3e} pairs/s/SM, {l1_pairs:.4f} ms, and "
        f"{Q * N * D * L1_LEVELS:.3e} thermometer bit products at the b1 rate, "
        f"{l1_thermo:.4f} ms; {100 * r['bound'][0] / r['ms']:.1f} % of it) "
        f"[as int8 multiply-adds at 1,979 TOPS {l1_int8:.4f} ms] per {Q}-query batch at "
        f"N={N} D={D} on {smi}")
    del scores, pscores, l1_dev

    # ------------------------------------------------------------- serving
    t0 = time.perf_counter()
    plan = recommend(rbq, SERVE_TARGET, k=K, queries=calib, data=data_dev)
    rec_s = time.perf_counter() - t0
    say("serve", f"recommend(residual IVF-BQ, target {SERVE_TARGET}) in {rec_s:.2f} s: "
        f"nscan {plan.nscan}, oversampling {plan.oversampling}, expected recall "
        f"{plan.expected_recall:.4f}, calibrated {plan.calibrated}; {plan.notes}; history "
        + "; ".join(f"{h[0]} -> {h[1]:.4f}" for h in plan.history))
    searcher = plan.serve(rbq, data_dev, k=K, depth=SERVE_DEPTH)
    direct = plan.build(rbq, data_dev, k=K)
    searcher.warmup(serve[0])
    reset_all(*mods)
    pinned0 = pinned_pool()
    t0 = time.perf_counter()
    outs = list(searcher.search_stream(serve))
    pipe_ms = (time.perf_counter() - t0) * 1e3 / SERVE_BATCHES
    pinned1 = pinned_pool()
    serve_launches = {k_: v for k_, v in counts(*mods).items() if v}
    t0 = time.perf_counter()  # the same searcher again, its pinned pool grown
    list(searcher.search_stream(serve))
    pipe2_ms = (time.perf_counter() - t0) * 1e3 / SERVE_BATCHES
    pinned2 = pinned_pool()
    grow = [(b[0] - a[0], (b[1] - a[1]) / 1e3) for a, b in ((pinned0, pinned1), (pinned1, pinned2))]
    say("serve", f"pipelined per batch: first window {pipe_ms:.4f} ms (pinned host pool grew by "
        f"{grow[0][0]} blocks, {grow[0][1]:.4f} ms in its CUDA allocations), second "
        f"{pipe2_ms:.4f} ms ({grow[1][0]} blocks, {grow[1][1]:.4f} ms), on {smi}")
    t0 = time.perf_counter()
    blocking = [direct.top_k(direct.encode_query(b), K) for b in serve]
    block_ms = (time.perf_counter() - t0) * 1e3 / SERVE_BATCHES
    require(len(outs) == SERVE_BATCHES, "one result per batch")
    held = []
    for j, ((sv_, iv_), (bs, bi)) in enumerate(zip(outs, blocking)):
        require(np.array_equal(sv_, bs), f"serving batch {j}: FIFO, values equal blocking")
        ids_equal_where_untied(sv_, iv_, bs, bi, f"serving batch {j}")
        held.append(recall_at_k(iv_, exact_topk(serve[j], data_dev, dot, False, K)[1]))
    held_recall = float(np.mean(held))
    rec["serve_held_out"] = held_recall
    say("serve", f"{SERVE_BATCHES} batches of {Q} through search_stream (depth {SERVE_DEPTH}):"
        f" {pipe_ms:.4f} ms per batch pipelined, {block_ms:.4f} ms blocking, on {smi}; "
        f"launches {serve_launches}; held-out recall@{K} {held_recall:.4f} (calibrated "
        f"{plan.expected_recall:.4f})")
    require(held_recall >= plan.expected_recall - SERVE_RECALL_SLACK,
            "held-out recall >= the calibrated recall - 0.05")
    # K10 with a value query as the plan runs it: the arguments of one
    # search's scan, caught on the way in, then the kernel against plain.
    calls = []
    scan_fn = bq_kernel.bq_search_indexed
    bq_kernel.bq_search_indexed = lambda *a, **kw_: calls.append((a, kw_)) or scan_fn(*a, **kw_)
    try:
        direct.top_k_device(direct.encode_query(serve[0]), K)
    finally:
        bq_kernel.bq_search_indexed = scan_fn
    require(len(calls) == 1 and calls[0][1].get("query_affine") is not None,
            "the plan's search scans through K10 with a value query")
    sa, skw = calls[0]
    v, i = scan_fn(*sa, **skw)
    pv, pi = bq_kernel.bq_search_indexed_plain(*sa, **skw)
    torch.cuda.synchronize()
    require(torch.equal(v, pv) and torch.equal(i, pi),
            "K10 value query at the serving width: equal plain")
    del pv, pi
    s_tiles, s_k = sa[2], skw["k"]
    s_rows = s_tiles.shape[0] * skw["tile_n"]
    s_bytes = (s_rows * (rows_b + 4) + Q * (dp + 8) + Q * s_rows // ktile.CORR_BLK * 4
               + s_tiles.shape[0] * 4 + Q * s_k * 8)
    s_corr = sa[3] if len(sa) > 3 else skw.get("corr")
    s_lib = value_composite(sa[1], skw["query_affine"], skw["rowadd"],
                            ktile.expand_corr(s_corr, selection=True), s_k,
                            rows=ktile.tile_rows(s_tiles, skw["tile_n"]))
    recs.append(dict(name="bq_search_indexed_res_serve",
                     launches=serve_launches.get("bq_search_indexed_res", 0), max_abs_err=0.0,
                     ms=timed_ms(lambda: scan_fn(*sa, **skw)),
                     plain_ms=plain_ms(lambda: bq_kernel.bq_search_indexed_plain(*sa, **skw)),
                     bound=bound(s_bytes, 2 * Q * s_rows * PD, INT8_OPS_PER_S),
                     library_ms=library_time(
                         "bq_search_indexed_res_serve: torch._int_mm of the expanded planes + "
                         "epilogue + rowadd + corr + torch.topk", s_lib, smi)))
    del s_lib
    r = recs[-1]
    require(r["launches"] > 0, "the served searches launched K10 with a value query")
    say("time", f"bq_search_indexed_res_serve: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) per {Q}-query "
        f"batch over {s_tiles.shape[0]} tiles = {s_rows} rows x {PD} dims, k={s_k}, launched "
        f"{r['launches']} times by the served batches, on {smi}")
    # The idle share, from unprofiled windows: 1 - (sum of the searches'
    # CUDA-event spans) / host wall of the pipelined loop.
    spans = SearchSpans(direct)
    eq_s = direct.encode_query(serve[0])
    search_ms = timed_ms(lambda: direct.top_k_device(eq_s, K), warmup=1, iters=5, reps=3)
    idle_windows = []
    for _ in range(SERVE_IDLE_WINDOWS):
        spans.events.clear()
        timed = PipelinedSearcher(spans, k=K, depth=SERVE_DEPTH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(timed.search_stream(serve))
        w = (time.perf_counter() - t0) * 1e3
        busy_ = sum(a.elapsed_time(b) for a, b in spans.events)
        idle_windows.append({"wall_ms": w, "busy_ms": busy_, "idle_share": 1.0 - busy_ / w})
    idle = statistics.median(x["idle_share"] for x in idle_windows)
    say("serve", f"idle share of the pipelined loop, {SERVE_IDLE_WINDOWS} unprofiled windows "
        f"of {SERVE_BATCHES} batches: " + "; ".join(
            f"wall {x['wall_ms']:.4f} ms, searches' event spans {x['busy_ms']:.4f} ms, idle "
            f"{100 * x['idle_share']:.1f} %" for x in idle_windows)
        + f"; median {100 * idle:.1f} %; one search back to back {search_ms:.4f} ms of device "
        f"time, on {smi}")
    # Host syncs per search, from profiled windows (the profiler's own host
    # work stretches their walls, so they are not read for the idle share;
    # two windows, to see whether the first carries the profiler's start-up).
    prof_windows = []
    for _ in range(2):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            list(searcher.search_stream(serve))
            w = (time.perf_counter() - t0) * 1e3
        busy_ = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA") / 1e3
        prof_windows.append({"wall_ms": w, "busy_ms": busy_})
    syncs = sync_counts(prof)
    say("serve", "profiled pipelined loops: " + "; ".join(
        f"wall {x['wall_ms']:.4f} ms, profiler device busy {x['busy_ms']:.4f} ms"
        for x in prof_windows) + "; per search (second window): " + ", ".join(
            f"{k_} {v / SERVE_BATCHES:.2f}" for k_, v in sorted(syncs.items())) + f", on {smi}")
    if do_profile:
        profile("residual IVF-BQ approx top_k_device", lambda: rbq.top_k_device(
            eq, K, method="approx", nprobe=IVF_NPROBE, nscan=nscan))
    keep = {"rbq": rbq, "queries": queries, "l1": ivf_l1, "l1_queries": l1_queries}
    return recs, {"recall_at_10": rec, "build_s": build_s, "lift": lift,
                  "score_err": err, "score_spread": spread,
                  "plan": {"nscan": plan.nscan, "oversampling": plan.oversampling,
                           "expected_recall": plan.expected_recall,
                           "history": plan.history},
                  "serve_ms": {"pipelined": pipe_ms, "pipelined_second": pipe2_ms,
                               "blocking": block_ms, "search_device": search_ms},
                  "pinned_growth": grow,
                  "idle_windows": idle_windows, "idle_share": idle,
                  "profiled_windows": prof_windows,
                  "syncs_per_search": {k_: v / SERVE_BATCHES for k_, v in syncs.items()}}, keep


class Tee(io.TextIOBase):
    """A stdout that also keeps what it was given, for the lines an entry
    point prints (the CLI's encode wall, the examples' recall lines)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.buf.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


def captured(fn, *args):
    """(fn(*args), what it printed), printed as it goes."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(*args)
    return out, tee.buf.getvalue()


@contextlib.contextmanager
def recorded(*modules, body=None):
    """Every kernel wrapper of ``modules`` (a function ``f`` beside its plain
    version ``f_plain``) wrapped to keep, for each launch counter it moved,
    its last such call and that call's result; yields {counter: (module,
    name, args, kwargs, result)} and puts the wrappers back on exit. The
    models reach the wrappers through their modules, so they call these.
    ``body(module, name, args, kwargs)``, where given, names the kernel
    body a call ran when one counter counts several: such a call is kept
    as "counter (body)", the last of each body."""
    calls, saved = {}, []
    for m in modules:
        for pname in [n for n in vars(m) if n.endswith("_plain")]:
            name = pname[: -len("_plain")]
            fn = getattr(m, name, None)
            if fn is None:
                continue

            def rec(*a, _m=m, _name=name, _fn=fn, **kw):
                before = dict(_m.LAUNCHES)
                out = _fn(*a, **kw)
                tag = body and body(_m, _name, a, kw)
                for c, n in _m.LAUNCHES.items():
                    if n != before[c]:
                        calls[f"{c} ({tag})" if tag else c] = (_m, _name, a, kw, out)
                return out

            saved.append((m, name, fn))
            setattr(m, name, rec)
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def plain_row_scores(m, bound):
    """[Q, Npad] plain scores of every corpus row that a search of module
    ``m`` selects from, given its bound arguments; path 6 runs no residual
    additive, so none is taken."""
    from quantization_tpu_torch.ops.kernels import bq_kernel, pq_kernel, sq_kernel

    require(all(bound.get(x) is None for x in ("corr", "rowadd", "query_affine")),
            "path 6's searches take no residual additive")
    if m is sq_kernel:
        codes = bound["codes"]
        return sq_kernel.sq_scores_plain(
            bound["qcodes"], bound["qoff"], codes, bound["voff"], bound["multiplier"],
            distance_type=bound["distance_type"], n_valid=codes.shape[0])
    if m is bq_kernel:
        planes = bound["planes"]
        return bq_kernel.bq_scores_plain(
            bound["qwords"], planes, distance_type=bound["distance_type"],
            invert=bound["invert"], dim=bound["dim"], n_valid=planes.shape[1])
    require(m is pq_kernel, f"plain row scores for {m.__name__}")
    codes_t = bound["codes_t"]
    return pq_kernel.lut_scores_plain(bound["lut"], codes_t, n_valid=codes_t.shape[1],
                                      precision=bound.get("precision"))


def hold_to_plain(calls, launches, what):
    """Each launch counter that ``launches`` shows moved, held on its last
    recorded call (``recorded``): the wrapper's result against its plain
    version on the same inputs on the card. Score matrices and candidate
    scores equal plain to the bit; a search's values equal the plain
    search's and each id is a distinct row of its scan whose plain score is
    its value (ids differ only among ties; ``check_topk``). Returns
    {counter: (shape of the result, max |error|)}."""
    import inspect

    from quantization_tpu_torch.ops.kernels import ktile

    require(set(launches) <= set(calls), f"{what}: a recorded call of every launched "
            f"kernel ({sorted(launches)} against {sorted(calls)})")
    torch.cuda.synchronize()
    held = {}
    for counter in sorted(launches):
        m, name, a, kw, got = calls[counter]
        plain_fn = getattr(m, name + "_plain")
        plain = plain_fn(*a, **kw)
        tag = f"{what}: {counter}"
        if not isinstance(got, tuple):
            require(torch.equal(got, plain), f"{tag} {list(got.shape)} equals plain to the bit")
            held[counter] = (list(got.shape), 0.0)
            continue
        bound = inspect.signature(plain_fn).bind(*a, **kw)
        bound.apply_defaults()
        bound = bound.arguments
        scores = plain_row_scores(m, bound)
        vals, ids = got
        if "tile_sel" in bound:  # an indexed scan: ids are rows of its tiles
            scanned = torch.zeros(scores.shape[1], dtype=torch.bool, device=ids.device)
            scanned[ktile.tile_rows(bound["tile_sel"], bound["tile_n"]).long()] = True
            live = ids >= 0
            require(bool(scanned[ids[live].long()].all()), f"{tag}: ids are rows of the scan")
        err = check_topk(vals, ids, plain[0], scores, bound.get("n_valid", scores.shape[1]),
                         tag)
        held[counter] = ([*vals.shape, scores.shape[1]], err)
        del scores, plain
    return held


def ann_method(data, flags, dev, knn_batch=None):
    """One method of the CLI through its own functions on a loaded corpus:
    build_index, test_knn (in batches of ``knn_batch`` queries, else
    --query-batch), with --bench bench_scoring and with --bench-f32
    bench_f32. On the card every kernel it launched is then held against
    its plain version on its inputs (``hold_to_plain``). Returns (entry,
    encode seconds, launches by wrapper, {counter: (shape, max |error|)})."""
    from quantization_tpu_torch.bench import ann_benchmark as cli
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    args = cli.parser().parse_args(flags + (["--device", "cpu"] if dev.type == "cpu" else []))
    reset_all(*mods)
    with recorded(*mods) as calls:
        t0 = time.perf_counter()
        index = cli.build_index(args.method, data, args)
        encode_s = time.perf_counter() - t0
        res = cli.test_knn(data, index, query_batch=knn_batch or args.query_batch,
                           topk_method=args.topk_method, recall_target=args.recall_target)
        entry = {"same_10": res.same_10, "same_20": res.same_20, "same_30": res.same_30,
                 **res.timings(), "batches": len(res.latencies_us)}
        if args.bench:
            entry["qps"] = cli.bench_scoring(data, index, args, args.method)
        if args.bench_f32:
            entry["f32_qps"] = cli.bench_f32(data, args)
    launches = {k_: v for k_, v in counts(*mods).items() if v}
    what = f"{args.method} {args.topk_method}"
    held = hold_to_plain(calls, launches, what) if dev.type == "cuda" else {}
    del index, calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return entry, encode_s, launches, held


def ann_recalls(dev, count):
    """recall@10 of every path-6 method at ``count`` rows on ``dev``: the
    deep-image methods on one corpus, ivf-sq-f32 on glove-100."""
    from quantization_tpu_torch.bench.ann_data import DATASETS, AnnBenchmarkData

    out = {}
    for name, labels in ((ANN_DATASET, list(ANN_METHODS)), (ANN_IVF_DATASET, ["ivf-sq-f32"])):
        data = AnnBenchmarkData.load(DATASETS[name], synthetic_count=count, device=dev)
        data.preprocess_cosine()
        for label in labels:
            flags = ANN_METHODS.get(label, ["--method", label])
            entry, *_ = ann_method(data, flags + ["--test-acc", "--query-batch", "256"], dev)
            out[label] = entry["same_10"]
    return out


def offsets_agree(a, b, rtol=1e-5, atol=1e-2):
    """Whether two SQ-u8 encodings of one corpus (DOT) hold the same row
    offsets within the JAX native test's tolerance (tests/test_native.py),
    once the difference their codes make is taken out: a code one apart
    (ROADMAP F7) moves its row's offset by alpha * offset."""
    m = a.metadata
    dsum = (a.codes.to(torch.int32).sum(1) - b.codes.to(torch.int32).sum(1)).double()
    want = b.voffsets.double() + dsum * (float(m.alpha) * float(m.offset))
    return bool(((a.voffsets.double() - want).abs()
                 <= atol + rtol * b.voffsets.double().abs()).all())


def harness_path(dev, smi):
    """Path 6: the port's user-facing harness on the card. (a) the
    ann-benchmarks CLI at deep-image-96-angular's 9,990,000 rows (every
    method through the CLI's functions on one corpus; ivf-sq-f32 through
    main() on glove-100 at 1,183,514 rows), each kernel launched held
    against plain on its inputs, and the 20,000-row run held to the CPU
    rehearsal;
    (b) the native host encoders at 1M x 768 on 8 threads against the
    device encoders; (c) micro; (d) cpu_baseline; (e) the five examples."""
    import re

    from quantization_tpu_torch import BinaryQuantizer, DistanceType, ScalarQuantizerU8
    from quantization_tpu_torch import VectorParameters
    from quantization_tpu_torch.bench import ann_benchmark as cli
    from quantization_tpu_torch.bench import cpu_baseline, micro
    from quantization_tpu_torch.bench.ann_data import DATASETS, AnnBenchmarkData
    from quantization_tpu_torch.examples import (
        basic, ivf_serving, pipelined_serving, serving_two_stage, streaming_ingest,
    )
    from quantization_tpu_torch.native import loader
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    t_path = time.perf_counter()
    info = {"ann": {}}

    def say_entry(label, n, entry, encode_s, launches, held):
        say("harness", f"{label} on {n:,} rows: recall@10/20/30 {entry['same_10']:.4f} / "
            f"{entry['same_20']:.4f} / {entry['same_30']:.4f}; latency/query us over "
            f"{entry['batches']} batches min {entry['min_us']:.1f} avg {entry['avg_us']:.1f} "
            f"p95 {entry['p95_us']:.1f} p99 {entry['p99_us']:.1f} max {entry['max_us']:.1f}; "
            f"encode {encode_s:.4f} s ({n / encode_s:,.0f} vectors/s); "
            f"{entry.get('qps', float('nan')):,.1f} q/s; launches {launches}; on {smi}")
        figures = [entry[k_] for k_ in ("same_10", "same_20", "same_30", "min_us", "avg_us",
                                        "p95_us", "p99_us", "max_us", "qps")] + [encode_s]
        require(all(np.isfinite(x) for x in figures), f"{label}: every figure finite")
        require(all(launches.get(w, 0) > 0 for w in ANN_LAUNCHES[label]),
                f"{label} launched {ANN_LAUNCHES[label]} ({launches})")
        say("harness", f"{label} on {n:,} rows, each kernel's last launch against plain on "
            "its inputs: " + ", ".join(f"{c} {shape} max |err| {e:g}"
                                        for c, (shape, e) in held.items()))
        info["ann"][label] = {**entry, "encode_s": encode_s, "rows": n, "launches": launches,
                              "held_max_abs_err": {c: e for c, (_, e) in held.items()}}

    # ---------------------------------------------- (a) the CLI at 9.99M rows
    t0 = time.perf_counter()
    data = AnnBenchmarkData.load(DATASETS[ANN_DATASET], synthetic_count=ANN_COUNT, device=dev)
    data.preprocess_cosine()
    info["load_s"] = time.perf_counter() - t0
    say("harness", f"{data.name} made and its exact neighbours found: "
        f"{data.train.shape[0]:,} x {data.train.shape[1]} ({data.train.nbytes / 1e9:.2f} GB "
        f"f32) in {info['load_s']:.1f} s")
    for label, flags in ANN_METHODS.items():
        extra = ["--bench-f32"] if label == "u8" else []
        entry, encode_s, launches, held = ann_method(
            data, ["--dataset", ANN_DATASET] + flags + extra + ANN_FLAGS, dev, ANN_KNN_BATCH)
        say_entry(label, ANN_COUNT, entry, encode_s, launches, held)
    del data
    ann = info["ann"]
    require(np.isfinite(ann["u8"]["f32_qps"]), "the f32 baseline's q/s is finite")
    say("harness", f"f32 baseline (matmul + top-10, Q = 100) {ann['u8']['f32_qps']:,.1f} q/s; "
        f"u8 scoring {ann['u8']['qps']:,.1f} q/s, on {smi}")
    require(ann["u8-f32"]["same_10"] >= ann["u8-approx"]["same_10"],
            "u8-f32 recall@10 >= u8 approx's")
    require(ann["bq-u8"]["same_10"] >= ann["bq"]["same_10"], "bq-u8 recall@10 >= bq's")

    # ivf-sq-f32 through main(): --query-batch sets test_knn's batches and --bench's alike.
    argv = ["--dataset", ANN_IVF_DATASET, "--synthetic-count", str(ANN_IVF_COUNT),
            "--method", "ivf-sq-f32", "--test-acc", "--bench", "--query-batch",
            str(ANN_KNN_BATCH), "--json"]
    reset_all(*mods)
    t0 = time.perf_counter()
    with recorded(*mods) as calls:
        (res,), printed = captured(cli.main, argv)
    info["main_ivf_s"] = time.perf_counter() - t0
    launches = {k_: v for k_, v in counts(*mods).items() if v}
    held = hold_to_plain(calls, launches, "ivf-sq-f32")
    del calls
    require(json.loads(printed.strip().splitlines()[-1])[0] == res, "--json prints the results")
    encode_s = float(re.search(r"\] ivf-sq-f32 encode: ([0-9.]+)s", printed).group(1))
    res["batches"] = -(-ANN_QUERIES // ANN_KNN_BATCH)
    say_entry("ivf-sq-f32", ANN_IVF_COUNT, res, encode_s, launches, held)
    say("harness", f"main() for ivf-sq-f32 in {info['main_ivf_s']:.1f} s (corpus made and "
        f"its exact neighbours found in it); q/s at Q = {ANN_KNN_BATCH}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    card = ann_recalls(dev, ANN_REHEARSAL_COUNT)
    for label, r in card.items():
        want = ANN_RECALL_REHEARSAL[label]
        say("harness", f"{label} at {ANN_REHEARSAL_COUNT:,} rows: recall@10 {r:.4f} on the "
            f"card, {want:.4f} in the CPU rehearsal (--rehearse ann)")
        require(abs(r - want) <= ANN_REHEARSAL_SLACK,
                f"{label}: the card's recall@10 at {ANN_REHEARSAL_COUNT} rows within "
                f"{ANN_REHEARSAL_SLACK} of the CPU rehearsal's")
    info["rehearsal_recall_at_10"] = card
    info["rehearsal_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ------------------------------------------------- (b) native host encode
    t0 = time.perf_counter()
    loader.get_lib()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    x = (torch.rand(NATIVE_N, NATIVE_D, generator=gen, device=dev) * 2 - 1).cpu().numpy()
    params = VectorParameters(NATIVE_D, NATIVE_N, DistanceType.DOT, False)

    def build(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sq_n, sq_n_s = build(lambda: ScalarQuantizerU8.encode(
        x, params, use_native=True, max_threads=NATIVE_THREADS))
    sq_d, sq_d_s = build(lambda: ScalarQuantizerU8.encode(x, params))
    diff = (sq_n.codes.to(torch.int16) - sq_d.codes.to(torch.int16)).abs()
    differ = float((diff != 0).double().mean())
    require(int(diff.max()) <= 1 and differ < 0.01,
            f"native SQ codes within one of the device's on under 1 % of entries (F7; "
            f"max {int(diff.max())}, {100 * differ:.4f} %)")
    require(offsets_agree(sq_n, sq_d), "native SQ offsets within rtol 1e-5 / atol 1e-2 of the "
            "device's, less the DOT term of the codes one apart (F7)")
    bq_n, bq_n_s = build(lambda: BinaryQuantizer.encode(
        x, params, use_native=True, max_threads=NATIVE_THREADS))
    bq_d, bq_d_s = build(lambda: BinaryQuantizer.encode(x, params))
    require(torch.equal(bq_n.planes, bq_d.planes), "native BQ planes byte-equal the default's")
    per_m = 1e6 / NATIVE_N
    info["native"] = {"g++_s": build_s, "sq_native_s_per_1m": sq_n_s * per_m,
                      "sq_device_s_per_1m": sq_d_s * per_m, "bq_native_s_per_1m": bq_n_s * per_m,
                      "bq_numpy_s_per_1m": bq_d_s * per_m, "sq_codes_differ": differ}
    say("harness", f"native encode at {NATIVE_N:,} x {NATIVE_D}, {NATIVE_THREADS} threads "
        f"(library built in {build_s:.2f} s): SQ {sq_n_s * per_m:.3f} s per 1M rows native, "
        f"{sq_d_s * per_m:.3f} on the device ({100 * differ:.4f} % of codes one apart, F7); "
        f"BQ {bq_n_s * per_m:.3f} native, {bq_d_s * per_m:.3f} numpy packer (planes equal); "
        f"codes on the card, on {smi}")
    del x, sq_n, sq_d, bq_n, bq_d, diff
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ (c) micro
    rows = micro.main([])
    for row in rows:
        require(np.isfinite(row["ms_per_batch"]) and row["ms_per_batch"] > 0,
                f"micro {row['bench']}: time finite and positive")
    info["micro"] = rows
    say("harness", "micro (100k x 1024, Q = 256, top-10): " + ", ".join(
        f"{r['bench']} {r['ms_per_batch']:.4f} ms" for r in rows) + f", on {smi}")
    torch.cuda.empty_cache()

    # ----------------------------------------------------- (d) cpu_baseline
    cpu = cpu_baseline.measure(100_000, 1024)
    require(cpu["cpu_sq_u8_scan_qps"] > 0 and cpu["cpu_f32_scan_qps"] > 0,
            "cpu_baseline q/s positive")
    info["cpu_baseline"] = cpu
    say("harness", f"cpu_baseline at 100,000 x 1024 (one host core, native scans; not a "
        f"device number): SQ u8 {cpu['cpu_sq_u8_scan_qps']:,.1f} q/s, f32 "
        f"{cpu['cpu_f32_scan_qps']:,.1f} q/s")

    # --------------------------------------------------------- (e) examples
    info["examples_s"] = {}
    for mod, argv, line in [
        (basic, [], "u8 dot scores within"),
        (serving_two_stage, [], "recall@10 vs exact f32"),
        (pipelined_serving, [], "recall@10 on the last batch"),
        (ivf_serving, [], "recall@10 vs exact f32"),
        (streaming_ingest, ["--n", str(STREAMING_N)], "recall@10 vs exact ="),
    ]:
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        _, printed = captured(mod.main, argv)
        info["examples_s"][name] = time.perf_counter() - t0
        require(line in printed, f"example {name} printed its result lines")
        torch.cuda.empty_cache()
    say("harness", "examples: " + ", ".join(
        f"{k_} {v:.1f} s" for k_, v in info["examples_s"].items()) + f", on {smi}")

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("harness", f"path 6 wall {wall:.1f} s (limit {HARNESS_WALL_LIMIT_S:.0f} s) on {smi}")
    require(wall <= HARNESS_WALL_LIMIT_S, f"path 6 within {HARNESS_WALL_LIMIT_S:.0f} s")
    return info


def shards_equal(sharded, whole, dim, count):
    """Whether a ShardedArray holds the first ``count`` entries of ``whole``
    along ``dim`` (shard s its entries from s * n_local on) and zeros past
    them."""
    nl = sharded.n_local
    for s, t in enumerate(sharded.shards):
        nv = max(0, min(count - s * nl, nl))
        if not torch.equal(t.narrow(dim, 0, nv), whole.narrow(dim, s * nl, nv).to(t.device)):
            return False
        if bool(t.narrow(dim, nv, nl - nv).any()):
            return False
    return True


def live_shards(arr, count):
    """Shards of a ShardedArray that hold rows of a ``count``-row corpus."""
    return min(arr.n_shards, -(-count // arr.n_local))


def tie_recall(vals, exact_vals):
    """Mean share of each row's k values that reach the exact k-th value: an
    approx search's overlap with the exact top-k, ties counted as hits
    (each value is its id's true score; the holds check that)."""
    return float(np.mean(vals >= exact_vals[:, -1:]))


def same_as_single(got, want, what):
    """Values equal to the bit, ids equal where the values are untied."""
    gs, gi = (t.cpu().numpy() for t in got)
    ws, wi = (t.cpu().numpy() for t in want)
    require(np.array_equal(gs, ws), f"{what}: values equal the single-device search's")
    ids_equal_where_untied(gs, gi, ws, wi, what)


def sharded_path(dev, smi, pq_keep):
    """Path 7: the sharded engines (parallel/sharded.py) on a mesh of SHARDS
    shards of the one card. (a) Path 2's neighbourhood corpus (1M x 1536)
    encoded by the single-device and the sharded-native streaming encoders,
    codes byte-equal, the last shard ragged; path 3's PQ quantizers (1M x
    768, 8- and 4-bit) wrapped. (b) The main path, counted per search: the
    sharded SQ / BQ / PQ searches (fused, and past the fused caps the score
    matrices), K4 rescoring and BQ -> SQ / f32 two-stage over sharded
    stages, every kernel held against plain on its last launch's inputs (the
    last shard's). (c) Each equal to the single-device search; approx
    overlap, two-stage recall, score_candidates (-inf for ids no shard
    owns), score_internal_batch. (d) Files both ways. (e) The streaming PQ
    encode. (f) Empty shards. (g) Per-batch device times. Wall limited to
    SHARDED_WALL_LIMIT_S."""
    from quantization_tpu_torch import (
        BinaryQuantizer, DistanceType, ExactRescorer, ProductQuantizer, ScalarQuantizerU8,
        TwoStageIndex, VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel
    from quantization_tpu_torch.parallel.sharded import (
        ShardedBinaryQuantizer, ShardedExactRescorer, ShardedProductQuantizer,
        ShardedScalarQuantizer, make_mesh,
    )

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    t_path = time.perf_counter()
    info = {"launches": {}, "held_max_abs_err": {}, "batch_ms": {}}
    mesh = make_mesh(devices=[dev] * SHARDS)
    require(mesh.shape["shard"] == SHARDS and mesh.first_device == dev,
            f"a {SHARDS}-shard mesh of the one card")

    # ------------------------------- (a) path 2's corpus, encoded both ways
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    data_dev, queries_dev = neighbourhoods(BN, Q, BD, gen, dev)
    data, queries = data_dev.cpu().numpy(), queries_dev.cpu().numpy()
    params = VectorParameters(BD, BN, DistanceType.DOT, False)
    t0 = time.perf_counter()
    bq1, sq1 = BinaryQuantizer.encode(data, params), ScalarQuantizerU8.encode(data, params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sbq = ShardedBinaryQuantizer.encode(data, params, mesh)
    ssq = ShardedScalarQuantizer.encode(data, params, mesh)
    torch.cuda.synchronize()
    info["encode_s"] = {"single": t1 - t0, "sharded_streaming": time.perf_counter() - t1}
    require(shards_equal(ssq.codes, sq1.codes, 0, BN)
            and shards_equal(ssq.voffsets, sq1.voffsets, 0, BN),
            "the streamed sharded SQ codes and offsets byte-equal the single-device encode's")
    require(shards_equal(sbq.planes, bq1.planes, 1, BN),
            "the streamed sharded BQ planes byte-equal the single-device encode's")
    for name, arr in (("SQ", ssq.codes), ("BQ", sbq.planes)):
        nl = arr.n_local
        last = BN - (SHARDS - 1) * nl
        require(arr.n_shards == SHARDS and 0 < last < nl
                and all(t.device == dev for t in arr.shards),
                f"{name}: {SHARDS} shards on the card, the last one ragged")
        info[name.lower() + "_rows_per_shard"] = {"n_local": nl, "last_valid": last}
        say("sharded", f"{name}: {SHARDS} shards of {nl:,} rows; the last holds {last:,} "
            f"valid rows (ragged)")
    sx = ShardedExactRescorer(data_dev, DistanceType.DOT, False, mesh)
    x1 = ExactRescorer(data_dev, DistanceType.DOT, False)
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    spq = {label: ShardedProductQuantizer(pq_keep[label], mesh) for label in ("8bit", "4bit")}
    peq = {label: pq_keep[label].encode_query(pq_keep["queries"]) for label in spq}
    say("sharded", f"{BN:,} x {BD} neighbourhood corpus (path 2's): BQ + SQ encoded "
        f"single-device in {info['encode_s']['single']:.2f} s, sharded-native streaming in "
        f"{info['encode_s']['sharded_streaming']:.2f} s, codes byte-equal; path 3's PQ "
        f"8-bit / 4-bit wrapped")

    seq, sbeq = ssq.encode_query(queries), sbq.encode_query(queries)
    eq1, beq1 = sq1.encode_query(queries), bq1.encode_query(queries)
    require(torch.equal(seq.codes, eq1.codes) and torch.equal(seq.offsets, eq1.offsets)
            and torch.equal(sbeq.planes, beq1.planes),
            "queries encoded from the sharded metadata equal the single-device encoding")
    stages = {"bq_sq_approx": ("sq", "approx"), "bq_sq_exact": ("sq", "exact"),
              "bq_f32": ("f32", "approx")}
    two = {n: TwoStageIndex(sbq, ssq if f == "sq" else sx, OVERSAMPLING, coarse_method=m)
           for n, (f, m) in stages.items()}
    two1 = {n: TwoStageIndex(bq1, sq1 if f == "sq" else x1, OVERSAMPLING, coarse_method=m)
            for n, (f, m) in stages.items()}
    teq = {n: t.encode_query(queries) for n, t in two.items()}
    teq1 = {n: t.encode_query(queries) for n, t in two1.items()}
    _, cand = bq1.top_k_device(beq1, R)
    cand = cand.clone()
    cand[:, 0], cand[:, 1] = -1, BN + 5  # ids no shard owns

    # ------------------------------- (b) the main path, counted per search
    def search(fn, **kw):
        return lambda: with_lut("int8", lambda: fn(**kw))

    # Launches per search: one per shard holding rows (every shard here).
    live = {"sq": live_shards(ssq.codes, BN), "bq": live_shards(sbq.planes, BN),
            **{label: live_shards(spq[label].codes_t, PN) for label in spq}}
    groups = {
        "sq_bq_two_stage": [
            ("sq exact", search(ssq.top_k_device, equery=seq, k=K),
             {"sq_search_exact": live["sq"]}),
            ("sq approx", search(ssq.top_k_device, equery=seq, k=K, method="approx"),
             {"sq_search_approx": live["sq"]}),
            ("sq scores", search(ssq.top_k_device, equery=seq, k=SHARD_K_SCORES),
             {"sq_scores": live["sq"]}),
            ("bq exact", search(sbq.top_k_device, equery=sbeq, k=R),
             {"bq_search_exact": live["bq"]}),
            ("bq approx", search(sbq.top_k_device, equery=sbeq, k=R, method="approx"),
             {"bq_search_approx": live["bq"]}),
            ("bq scores", search(sbq.top_k_device, equery=sbeq, k=SHARD_K_SCORES),
             {"bq_scores": live["bq"]}),
            ("sq candidates", search(ssq.score_candidates, equery=seq, cand=cand),
             {"sq_score_candidates": live["sq"]}),
        ] + [(n, search(two[n].top_k_device, equery=teq[n], k=K),
              {"bq_search_" + stages[n][1]: live["bq"],
               **({"sq_score_candidates": live["sq"]} if stages[n][0] == "sq" else {})})
             for n in stages],
    }
    for label in spq:
        groups["pq_" + label] = [
            (f"pq {label} exact", search(spq[label].top_k_device, equery=peq[label], k=K),
             {"pq_search_exact": live[label]}),
            (f"pq {label} approx", search(spq[label].top_k_device, equery=peq[label], k=K,
                                          method="approx"), {"pq_search_approx": live[label]}),
            (f"pq {label} scores", search(spq[label].top_k_device, equery=peq[label],
                                          k=SHARD_K_SCORES), {"pq_scores": live[label]}),
        ]
    res = {}
    for group, runs in groups.items():
        with recorded(*mods) as calls:
            moved = {}
            for label, fn, want in runs:
                reset_all(*mods)
                res[label] = fn()
                torch.cuda.synchronize()
                got = {c: n for c, n in counts(*mods).items() if n}
                require(got == want, f"sharded {label}: one launch a live shard, {want} "
                        f"(got {got})")
                if label.startswith("pq 4bit"):
                    onehot = {c: n for c, n in pq_kernel.ONEHOT_LAUNCHES.items() if n}
                    require(onehot == got, f"sharded {label}: on the one-hot route ({onehot})")
                info["launches"][label] = got
                for c, n in got.items():
                    moved[c] = moved.get(c, 0) + n
        held = hold_to_plain(calls, moved, f"sharded {group}")
        del calls
        info["held_max_abs_err"][group] = {c: e for c, (_, e) in held.items()}
        say("sharded", f"{group}: launches {moved}; each kernel's last launch (the last "
            "shard's) against plain on its inputs: " + ", ".join(
                f"{c} {shape} max |err| {e:g}" for c, (shape, e) in held.items()))

    # ------------------------------- (c) against the single-device searches
    same_as_single(res["sq exact"], sq1.top_k_device(eq1, K), "sharded SQ exact top-10")
    same_as_single(res["sq scores"], sq1.top_k_device(eq1, SHARD_K_SCORES),
                   f"sharded SQ top-{SHARD_K_SCORES} (K3)")
    same_as_single(res["bq exact"], bq1.top_k_device(beq1, R), f"sharded BQ exact top-{R}")
    same_as_single(res["bq scores"], bq1.top_k_device(beq1, SHARD_K_SCORES),
                   f"sharded BQ top-{SHARD_K_SCORES} (K6)")
    # Two-stage with the exact coarse stage: the rescoring ranks the sharded
    # coarse candidates as the single-device SQ does, and where both coarse
    # searches pick the same R candidates (they differ only by a tie across
    # the R-th BQ score) the results equal the single-device two-stage's.
    got = res["bq_sq_exact"]
    want = two1["bq_sq_exact"].top_k_device(teq1["bq_sq_exact"], K)
    sh_c, one_c = res["bq exact"][1], bq1.top_k_device(beq1, R)[1]
    require(torch.equal(got[0], torch.topk(sq1.score_candidates(eq1, sh_c), K, dim=1).values),
            "sharded BQ -> SQ two-stage, exact coarse: the SQ rescoring of its candidates")
    agree = (torch.sort(sh_c, dim=1).values == torch.sort(one_c, dim=1).values).all(dim=1)
    require(int(agree.sum()) >= Q - TWO_STAGE_DISAGREE_MAX,
            f"sharded BQ -> SQ two-stage, exact coarse: the coarse candidates agree on at least "
            f"{Q - TWO_STAGE_DISAGREE_MAX} of {Q} queries (got {int(agree.sum())}); the "
            f"coarse top-{R} values are equal on all of them (sharded BQ exact top-{R} above)")
    same_as_single((got[0][agree], got[1][agree]), (want[0][agree], want[1][agree]),
                   "sharded BQ -> SQ two-stage, exact coarse, where the candidates agree")
    info["two_stage_exact_candidates_agree"] = int(agree.sum())
    for label in spq:
        one = pq_keep[label]
        same_as_single(res[f"pq {label} exact"],
                       with_lut("int8", lambda: one.top_k_device(peq[label], K)),
                       f"sharded PQ {label} exact top-10")
        sc = with_lut("int8", lambda: one.score_batch(peq[label]))
        want = torch.topk(sc, SHARD_K_SCORES, dim=1)
        require(torch.equal(res[f"pq {label} scores"][0], want.values),
                f"sharded PQ {label} top-{SHARD_K_SCORES} (K8) values equal the top-k of the "
                "single-device score_batch")
        del sc, want
    overlap = {
        "sq": tie_recall(res["sq approx"][0].cpu().numpy(), res["sq exact"][0].cpu().numpy()),
        "bq": tie_recall(res["bq approx"][0].cpu().numpy(), res["bq exact"][0].cpu().numpy()),
        **{f"pq_{label}": tie_recall(res[f"pq {label} approx"][0].cpu().numpy(),
                                     res[f"pq {label} exact"][0].cpu().numpy())
           for label in spq},
    }
    info["approx_overlap"] = overlap
    require(all(v >= 0.8 for v in overlap.values()),
            f"sharded approx overlap with the exact top-k >= 0.8 (F6): {overlap}")
    rec = {n: recall(res[n][1].cpu().numpy(), oracle, K) for n in stages}
    info["two_stage_recall_at_10"] = rec
    require(all(v >= TWO_STAGE_RECALL_MIN for v in rec.values()),
            f"sharded two-stage recall@{K} >= {TWO_STAGE_RECALL_MIN}: {rec}")
    require(torch.equal(res["sq candidates"], sq1.score_candidates(eq1, cand)),
            "sharded SQ score_candidates equal the single-device K4's (-inf where unowned)")
    owned = (cand >= 0) & (cand < BN)
    cand_x = torch.where(owned, cand, -1)
    checks = {
        "bq": (sbq.score_candidates(sbeq, cand), bq1.score_candidates(beq1, cand)),
        "f32": (sx.score_candidates(sx.encode_query(queries), cand),
                x1.score_candidates(x1.encode_query(queries), cand_x)),
    }
    candp = res["pq 8bit exact"][1].clone()
    candp[:, 0], candp[:, 1] = -1, PN + 5
    ownedp = (candp >= 0) & (candp < PN)
    for label in spq:
        checks[f"pq_{label}"] = (spq[label].score_candidates(peq[label], candp),
                                 pq_keep[label].score_candidates(peq[label],
                                                                 candp.clamp(0, PN - 1)))
    for name, (got, want) in checks.items():
        ow = ownedp if name.startswith("pq") else owned
        require(torch.equal(got[ow], want[ow]) and bool(torch.isneginf(got[~ow]).all()),
                f"sharded {name} score_candidates equal the single-device's on owned ids, "
                "-inf on ids no shard owns")
    for name, sh, one, n in [("sq", ssq, sq1, BN), ("bq", sbq, bq1, BN)] + [
            (f"pq_{label}", spq[label], pq_keep[label], PN) for label in spq]:
        ia = torch.randint(0, n, (4096,), generator=gen, device=dev)
        ib = torch.randint(0, n, (4096,), generator=gen, device=dev)
        require(torch.equal(sh.score_internal_batch(ia, ib), one.score_internal_batch(ia, ib)),
                f"sharded {name} score_internal_batch equals the single-device's")
    say("sharded", f"exact searches equal the single-device ones (values to the bit, ids "
        f"where untied), at k = {SHARD_K_SCORES} too; BQ -> SQ exact-coarse two-stage equal "
        f"on the {int(agree.sum())} of {Q} queries whose coarse candidates agree; approx "
        f"overlap with exact {overlap}; two-stage recall@{K} {rec}; score_candidates and "
        f"score_internal_batch equal")

    # ------------------------------- (d) files, both ways
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def paths(tag):
            return os.path.join(tmp, tag + ".bin"), os.path.join(tmp, tag + ".json")

        ssq.save(*paths("sq_sharded"))
        back = ScalarQuantizerU8.load(*paths("sq_sharded"), params)
        require(torch.equal(back.codes[:BN], sq1.codes[:BN])
                and torch.equal(back.voffsets[:BN], sq1.voffsets[:BN]),
                "sharded SQ save -> single-device load equals the original")
        sq1.save(*paths("sq_single"))
        back = ShardedScalarQuantizer.load(*paths("sq_single"), params, mesh)
        require(shards_equal(back.codes, sq1.codes, 0, BN)
                and shards_equal(back.voffsets, sq1.voffsets, 0, BN),
                "single-device SQ save -> sharded load equals the original")
        same_as_single(back.top_k_device(seq, K), res["sq exact"], "SQ sharded load search")
        sbq.save(*paths("bq_sharded"))
        back = BinaryQuantizer.load(*paths("bq_sharded"), params)
        require(torch.equal(back.planes[:, :BN], bq1.planes[:, :BN]),
                "sharded BQ save -> single-device load equals the original")
        bq1.save(*paths("bq_single"))
        back = ShardedBinaryQuantizer.load(*paths("bq_single"), params, mesh)
        require(shards_equal(back.planes, bq1.planes, 1, BN),
                "single-device BQ save -> sharded load equals the original")
        for label in spq:
            one, pparams = pq_keep[label], pq_keep[label].params
            spq[label].save(*paths("pq_sharded" + label))
            back = ProductQuantizer.load(*paths("pq_sharded" + label), pparams)
            require(torch.equal(back.codes_t[:, :PN], one.codes_t[:, :PN]),
                    f"sharded PQ {label} save -> single-device load equals the original")
            one.save(*paths("pq_single" + label))
            back = ShardedProductQuantizer.load(*paths("pq_single" + label), pparams, mesh)
            require(shards_equal(back.codes_t, one.codes_t, 1, PN),
                    f"single-device PQ {label} save -> sharded load equals the original")
            del back
    info["files_s"] = time.perf_counter() - t0
    say("sharded", f"files both ways (SQ {BN * (sq1.metadata.actual_dim + 4) / 1e9:.2f} GB, "
        f"BQ, PQ 8-bit and 4-bit): sharded save -> single-device load and single-device "
        f"save -> sharded load equal the originals, in {info['files_s']:.1f} s")

    # ------------------------------- (e) the streaming PQ encode
    rows = pq_keep["data"]
    p100 = VectorParameters(PD, rows.shape[0], DistanceType.DOT, False)
    t0 = time.perf_counter()
    pe1 = ProductQuantizer.encode(rows, p100, chunk_size=PQ_CHUNK, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    spe = ShardedProductQuantizer.encode(rows, p100, chunk_size=PQ_CHUNK, mesh=mesh)
    torch.cuda.synchronize()
    info["pq_encode_s"] = {"single": t1 - t0, "sharded_streaming": time.perf_counter() - t1}
    require(np.array_equal(spe.metadata.centroids, pe1.metadata.centroids)
            and shards_equal(spe.codes_t, pe1.codes_t, 1, rows.shape[0]),
            "streamed sharded PQ centroids and codes equal the single-device encode's")
    say("sharded", f"PQ 8-bit streaming encode at {rows.shape[0]:,} x {PD}: centroids and "
        f"codes equal the single-device encode's (single {info['pq_encode_s']['single']:.2f} "
        f"s, sharded {info['pq_encode_s']['sharded_streaming']:.2f} s; last shard "
        f"{rows.shape[0] - (SHARDS - 1) * spe.codes_t.n_local:,} of "
        f"{spe.codes_t.n_local:,} rows)")
    del pe1, spe

    # ------------------------------- (f) empty shards
    mesh8 = make_mesh(devices=[dev] * EMPTY_SHARDS)
    ps = VectorParameters(BD, EMPTY_N, DistanceType.DOT, False)
    pps = VectorParameters(PD, EMPTY_N, DistanceType.DOT, False)
    small, psmall = data[:EMPTY_N], rows[:EMPTY_N]
    e_pq = ProductQuantizer.encode(psmall, pps, chunk_size=PQ_CHUNK, device=dev)
    empties = {
        "sq": (ShardedScalarQuantizer.encode(small, ps, mesh8),
               ScalarQuantizerU8.encode(small, ps), "sq_search_exact"),
        "bq": (ShardedBinaryQuantizer.encode(small, ps, mesh8),
               BinaryQuantizer.encode(small, ps), "bq_search_exact"),
        "pq": (ShardedProductQuantizer(e_pq, mesh8), e_pq, "pq_search_exact"),
    }
    info["empty_shards"] = {}
    for name, (sh, one, kname) in empties.items():
        qs = pq_keep["queries"] if name == "pq" else queries
        eqs, eqo = sh.encode_query(qs), one.encode_query(qs)
        arr = {"sq": "codes", "bq": "planes", "pq": "codes_t"}[name]
        n_local = getattr(sh, arr).n_local
        live = -(-EMPTY_N // n_local)
        reset_all(*mods)
        got = with_lut("int8", lambda: sh.top_k_device(eqs, K))
        torch.cuda.synchronize()
        n = counts(*mods)[kname]
        require(live < EMPTY_SHARDS and n == live,
                f"empty shards, {name}: {live} of {EMPTY_SHARDS} shards hold rows and launch "
                f"{kname} ({n} launches)")
        same_as_single(got, with_lut("int8", lambda: one.top_k_device(eqo, K)),
                       f"empty shards, {name} exact top-10")
        ids = torch.tensor([[0, EMPTY_N - 1, EMPTY_N, live * n_local + 3, -1]] * Q,
                           dtype=torch.int64, device=dev)
        sc = sh.score_candidates(eqs, ids)
        require(bool(torch.isfinite(sc[:, :2]).all()) and bool(torch.isneginf(sc[:, 2:]).all()),
                f"empty shards, {name}: ids past count and in empty shards score -inf")
        info["empty_shards"][name] = {"n_local": n_local, "live_shards": live, "launches": n}
    say("sharded", f"empty shards: {EMPTY_N:,} rows on {EMPTY_SHARDS} shards, exact top-10 "
        f"equal the single-device searches; live shards and launches "
        f"{info['empty_shards']}")
    del empties, e_pq, mesh8

    # ------------------------------- (g) per-batch device time
    pairs = {
        "sq exact top-10": (lambda: ssq.top_k_device(seq, K), lambda: sq1.top_k_device(eq1, K)),
        "sq approx top-10": (lambda: ssq.top_k_device(seq, K, method="approx"),
                             lambda: sq1.top_k_device(eq1, K, method="approx")),
        f"bq exact top-{R}": (lambda: sbq.top_k_device(sbeq, R),
                              lambda: bq1.top_k_device(beq1, R)),
        f"bq approx top-{R}": (lambda: sbq.top_k_device(sbeq, R, method="approx"),
                               lambda: bq1.top_k_device(beq1, R, method="approx")),
        "bq -> sq two-stage": (lambda: two["bq_sq_approx"].top_k_device(teq["bq_sq_approx"], K),
                               lambda: two1["bq_sq_approx"].top_k_device(
                                   teq1["bq_sq_approx"], K)),
        **{f"pq {label} exact top-10": (
            lambda label=label: with_lut("int8", lambda: spq[label].top_k_device(peq[label], K)),
            lambda label=label: with_lut("int8", lambda: pq_keep[label].top_k_device(
                peq[label], K))) for label in spq},
    }
    for name, (fs, f1) in pairs.items():
        ms_s, ms_1 = timed_ms(fs, warmup=2, iters=5, reps=5), timed_ms(f1, warmup=2, iters=5,
                                                                         reps=5)
        info["batch_ms"][name] = {"sharded": ms_s, "single": ms_1}
        say("time", f"sharded {name}: {ms_s:.4f} ms per {Q}-query batch on {SHARDS} shards "
            f"of one card, single-device {ms_1:.4f} ms ({ms_s / ms_1:.2f}x), CUDA events, "
            f"on {smi}")

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("sharded", f"path 7 wall {wall:.1f} s (limit {SHARDED_WALL_LIMIT_S:.0f} s) on {smi}")
    require(wall <= SHARDED_WALL_LIMIT_S, f"path 7 within {SHARDED_WALL_LIMIT_S:.0f} s")
    return info


def hold_searches(calls, launches, what):
    """Each launch counter that ``launches`` shows moved, held on its last
    recorded call (``recorded``) against its plain version on the same
    inputs, the residual additives included (PERF.md §2's kernel rule):
    score matrices to the bit; exact searches' values equal, ids equal
    where untied and distinct; approx searches' values and ids equal.
    Returns {counter: (shape of the result, max |error|)}."""
    require(set(launches) <= set(calls), f"{what}: a recorded call of every launched "
            f"kernel ({sorted(launches)} against {sorted(calls)})")
    torch.cuda.synchronize()
    held = {}
    for counter in sorted(launches):
        m, name, a, kw, got = calls[counter]
        plain = getattr(m, name + "_plain")(*a, **kw)
        tag = f"{what}: {counter}"
        if not isinstance(got, tuple):
            require(torch.equal(got, plain), f"{tag} {list(got.shape)} equals plain to the bit")
            held[counter] = (list(got.shape), 0.0)
            continue
        (v, i), (pv, pi) = got, plain
        require(torch.equal(v, pv), f"{tag}: values equal plain")
        if kw.get("mode", "approx") == "exact":
            s, ids, ws, wi = (t.cpu().numpy() for t in (v, i, pv, pi))
            ids_equal_where_untied(s, ids, ws, wi, tag)
            srt = torch.sort(i, dim=1).values
            require(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()),
                    f"{tag}: distinct ids")
        else:
            require(torch.equal(i, pi), f"{tag}: ids equal plain")
        held[counter] = (list(v.shape), 0.0)
    return held


def sharded_ivf_path(dev, smi, ivf_keep, rbq_keep):
    """Path 8: the sharded IVF engine (parallel/sharded_ivf.py) on a mesh of
    SHARDS shards of the one card. (a) Path 4's indexes (IVF-SQ, residual
    IVF-SQ, IVF-BQ, 4-bit IVF-PQ at the automatic geometry, residual
    IVF-OPQ at the README geometry) and path 5's (residual IVF-BQ, IVF-SQ
    L1) wrapped, no build repeated. (b) The main path, counted per search:
    exact and approx at nprobe 32 over 256 / 512 buckets, indexed and
    compact where the family allows, k = 600 past the fused cap, every
    kernel held against plain on its last launch's inputs (the last
    shard's). (c) The full union against the single-device search, indexed
    == compact, recall. (d) The streaming builds of IVF-SQ and residual
    IVF-SQ from path 4's corpus, and their files both ways. (e) A pipelined
    searcher over the sharded IVF-SQ rescored to f32. (f) Fewer buckets
    than shards. (g) Per-batch device times. Wall limited to
    SHARDED_IVF_WALL_LIMIT_S."""
    from quantization_tpu_torch import (
        DistanceType, IVFIndex, PipelinedSearcher, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel, pq_kernel, sq_kernel
    from quantization_tpu_torch.parallel.sharded import ShardedExactRescorer, make_mesh
    from quantization_tpu_torch.parallel.sharded_ivf import ShardedIVF

    mods = (sq_kernel, bq_kernel, pq_kernel)
    t_path = time.perf_counter()
    info = {"launches": {}, "held_max_abs_err": {}, "batch_ms": {}, "recall_at_10": {}}
    mesh = make_mesh(devices=[dev] * SHARDS)
    data, data_dev = ivf_keep["data"], ivf_keep["data_dev"]
    queries, oracle = ivf_keep["queries"], ivf_keep["oracle"]
    params = VectorParameters(PD, PN, DistanceType.DOT, False)

    # ------------------------------------------------ (a) wrap, no rebuild
    single = {n: ivf_keep["idx"][n] for n in SHARDED_IVF_WRAPPED}
    single["rbq"], single["l1"] = rbq_keep["rbq"], rbq_keep["l1"]
    qsets = {n: queries for n in SHARDED_IVF_WRAPPED}
    qsets["rbq"], qsets["l1"] = rbq_keep["queries"], rbq_keep["l1_queries"]
    t0 = time.perf_counter()
    sh = {n: ShardedIVF(ivf, mesh) for n, ivf in single.items()}
    torch.cuda.synchronize()
    info["wrap_s"] = time.perf_counter() - t0
    for n, x in sh.items():
        m = x.metadata
        require(len(x._slot_ids.shards) == SHARDS
                and all(t.device == dev for t in x._slot_ids.shards),
                f"{n}: {SHARDS} shards on the card")
        say("sharded-ivf", f"{n}: {m.nbuckets} buckets of {m.bucket_size} -> {SHARDS} shards "
            f"of {x._b_loc} ({x._b_pad - m.nbuckets} pad bucket(s)), kind {m.kind}"
            f"{', residual' if m.residual else ''}")
    require(sh["sq"].metadata.nbuckets == 1139 and sh["sq"]._b_loc == 285
            and sh["sq"]._b_pad == 1140, "IVF-SQ at auto geometry: b_loc 285, one pad bucket")
    say("sharded-ivf", f"path 4's and path 5's indexes wrapped in {info['wrap_s']:.2f} s")
    seq = {n: x.encode_query(qsets[n]) for n, x in sh.items()}
    eq1 = {n: ivf.encode_query(qsets[n]) for n, ivf in single.items()}
    for n in sh:
        require(all(torch.equal(a, b) for a, b in zip(
            [seq[n][0], *vars(seq[n][1]).values()], [eq1[n][0], *vars(eq1[n][1]).values()])),
            f"{n}: queries encoded from the sharded metadata equal the single-device ones")

    # ------------------------------------------- (b) the main path, counted
    groups = {}
    for nscan in IVF_NSCANS:
        for n, plan in SHARDED_IVF_SEARCHES.items():
            for method, scan, want in plan:
                groups.setdefault(n, []).append((f"{n} {method} {scan} nscan {nscan}", K,
                                                 dict(method=method, scan=scan, nscan=nscan),
                                                 want))
    groups["sq"].append((f"sq exact k = {SHARDED_IVF_K_SCORES}", SHARDED_IVF_K_SCORES,
                         dict(nscan=IVF_NSCANS[0]), "sq_scores"))
    res = {}
    for n, group in groups.items():
        with recorded(*mods) as calls:
            moved = {}
            for label, k, kw, want in group:
                reset_all(*mods)
                res[label] = sh[n].top_k(seq[n], k, nprobe=IVF_NPROBE, **kw)
                torch.cuda.synchronize()
                got = {c: v for c, v in counts(*mods).items() if v}
                require(got == {want: SHARDS}, f"sharded IVF {label}: {want} once a shard "
                        f"({SHARDS}; got {got})")
                if n == "pq4":
                    onehot = {c: v for c, v in pq_kernel.ONEHOT_LAUNCHES.items() if v}
                    require(onehot == got, f"sharded IVF {label}: on the one-hot route")
                info["launches"][label] = got
                moved[want] = moved.get(want, 0) + SHARDS
        held = hold_searches(calls, moved, f"sharded IVF {n}")
        del calls
        info["held_max_abs_err"][n] = {c: e for c, (_, e) in held.items()}
        say("sharded-ivf", f"{n}: launches {moved} over {len(group)} searches ({SHARDS} a "
            "search); each kernel's last launch (the last shard's) against plain on its "
            "inputs: " + ", ".join(f"{c} {shape}" for c, (shape, _) in held.items()))

    # --------------------------------- (c) against the single-device index
    for n, x in sh.items():
        nb = x.metadata.nbuckets
        got = x.top_k(seq[n], K, nprobe=nb, nscan=nb)
        want = single[n].top_k(eq1[n], K, nprobe=nb, nscan=nb)
        what = f"sharded IVF {n}, every bucket"
        if x.metadata.residual:
            require(np.allclose(got[0], want[0], rtol=1e-5, atol=1e-4),
                    f"{what}: values within rtol 1e-5 / atol 1e-4 of the single-device ones")
            ids_equal_where_apart(got[0], got[1], want[0], want[1], what)
        else:
            require(np.array_equal(got[0], want[0]), f"{what}: values equal the single-device "
                    "search's")
            ids_equal_where_untied(got[0], got[1], want[0], want[1], what)
        require(all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in got[1]),
                f"{what}: no id twice")
        res[f"{n} full"] = got
    for n in ("sq", "sq_res"):
        for nscan in IVF_NSCANS:
            a = res[f"{n} exact indexed nscan {nscan}"][0]
            b = res[f"{n} exact compact nscan {nscan}"][0]
            require(np.array_equal(a, b), f"sharded {n} nscan {nscan}: indexed == compact exact")
    rec = info["recall_at_10"]
    for nscan in IVF_NSCANS:
        rec[f"sq/{nscan}"] = recall(res[f"sq exact indexed nscan {nscan}"][1], oracle, K)
    rec["sq/full"] = recall(res["sq full"][1], oracle, K)
    rec["sq/single/256"] = ivf_keep["rec"][f"sq/exact/{IVF_NSCANS[0]}"]
    require(rec[f"sq/{IVF_NSCANS[0]}"] >= rec["sq/single/256"] - 0.05,
            f"sharded IVF-SQ recall@{K} at nscan {IVF_NSCANS[0]} >= the single-device one - 0.05")
    require(rec["sq/full"] >= rec[f"sq/{IVF_NSCANS[0]}"], "recall at the full union >= at 256")
    say("sharded-ivf", f"every bucket: plain indexes equal the single-device search to the "
        f"bit (ids where untied), residual within rtol 1e-5 / atol 1e-4 (ids where further "
        f"apart than that), none twice; "
        f"indexed == compact; recall@{K} {rec}")

    # ---------------------------------- (d) streaming builds and their files
    sm = {}
    for n, residual in (("sq_stream", False), ("sq_res_stream", True)):
        t0 = time.perf_counter()
        sm[n] = ShardedIVF.encode(data, params, mesh=mesh, quantizer="sq", residual=residual)
        torch.cuda.synchronize()
        info.setdefault("build_s", {})[n] = time.perf_counter() - t0
        x = sm[n]
        nsl = x._b_loc * x.metadata.bucket_size
        require(all(t.shape[0] == nsl for t in x._inner[0].shards),
                f"{n}: each shard holds its b_loc * S = {nsl} rows, no more")
        say("sharded-ivf", f"{n}: ShardedIVF.encode of path 4's {PN:,} x {PD} corpus on "
            f"{SHARDS} shards in {info['build_s'][n]:.2f} s: {x.metadata.nbuckets} buckets of "
            f"{x.metadata.bucket_size}, {nsl:,} rows a shard")
    eqs = sm["sq_stream"].encode_query(queries)
    _, i_s = sm["sq_stream"].top_k(eqs, K, nprobe=IVF_NPROBE, nscan=IVF_NSCANS[0])
    rec["sq_stream/256"] = recall(i_s, oracle, K)
    require(rec["sq_stream/256"] >= rec["sq/single/256"] - 0.02,
            f"streamed sharded IVF-SQ recall@{K} at nscan {IVF_NSCANS[0]} >= path 4's "
            "single-device IVF-SQ - 0.02")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for n, x in sm.items():
            nb = x.metadata.nbuckets
            full = dict(nprobe=nb, nscan=nb)
            want = x.top_k(x.encode_query(queries), K, **full)
            d1, m1 = os.path.join(tmp, n + ".bin"), os.path.join(tmp, n + ".json")
            x.save(d1, m1)
            one = IVFIndex.load(d1, m1, params, device=dev)
            got1 = one.top_k(one.encode_query(queries), K, **full)
            d2, m2 = os.path.join(tmp, n + "_1.bin"), os.path.join(tmp, n + "_1.json")
            one.save(d2, m2)
            del one
            back = ShardedIVF.load(d2, m2, params, mesh=mesh)
            got2 = back.top_k(back.encode_query(queries), K, **full)
            del back
            for what, got in (("save -> IVFIndex.load", got1),
                              ("IVFIndex.save -> ShardedIVF.load", got2)):
                tag = f"{n} {what}"
                if x.metadata.residual:
                    require(np.allclose(got[0], want[0], rtol=1e-5, atol=1e-4),
                            f"{tag}: full-union values within rtol 1e-5 / atol 1e-4")
                    ids_equal_where_apart(got[0], got[1], want[0], want[1], tag)
                else:
                    require(np.array_equal(got[0], want[0]), f"{tag}: full-union values equal")
                    ids_equal_where_untied(got[0], got[1], want[0], want[1], tag)
    info["files_s"] = time.perf_counter() - t0
    say("sharded-ivf", f"streamed IVF-SQ recall@{K} at nscan {IVF_NSCANS[0]} "
        f"{rec['sq_stream/256']:.4f} (path 4's single-device {rec['sq/single/256']:.4f}); "
        f"files both ways (sharded save -> IVFIndex.load, IVFIndex.save -> ShardedIVF.load) "
        f"equal at the full union, in {info['files_s']:.1f} s")
    del sm, eqs

    # ------------------------------------------- (e) serving over the engine
    fine = ShardedExactRescorer(data_dev, DistanceType.DOT, False, mesh)
    two = TwoStageIndex(sh["sq"], fine, oversampling=OVERSAMPLING)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    batches = []
    for _ in range(SHARDED_IVF_SERVE_BATCHES):
        pick = torch.randint(0, PN, (Q,), generator=gen, device=dev)
        batches.append((data_dev[pick] + 0.05 * torch.randn(Q, PD, generator=gen, device=dev))
                       .cpu().numpy())
    searcher = PipelinedSearcher(two, k=K, depth=SHARDED_IVF_SERVE_DEPTH)
    t0 = time.perf_counter()
    served = list(searcher.search_stream(batches))
    info["serve_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / len(batches)
    for j, (b, (gs, gi)) in enumerate(zip(batches, served)):
        ds, di = two.top_k(two.encode_query(b), K)
        require(np.array_equal(gs, ds) and np.array_equal(gi, di),
                f"pipelined batch {j} equals the blocking search (FIFO)")
    say("sharded-ivf", f"PipelinedSearcher(depth {SHARDED_IVF_SERVE_DEPTH}) over the sharded "
        f"IVF-SQ (path 4's serving defaults: nprobe {sh['sq'].metadata.nprobe}, nscan "
        f"{sh['sq'].metadata.nscan}) rescored by ShardedExactRescorer (R = {R}): "
        f"{len(batches)} batches equal the blocking "
        f"search in order, {info['serve_ms_per_batch']:.2f} ms a batch (host wall), on {smi}")
    del searcher, served, two, fine

    # ------------------------------------------- (f) fewer buckets than shards
    mesh8 = make_mesh(devices=[dev] * EMPTY_SHARDS)
    small = np.ascontiguousarray(data[:EMPTY_N])
    ps = VectorParameters(PD, EMPTY_N, DistanceType.DOT, False)
    one = IVFIndex.encode(small, ps, quantizer="sq", nlist=2, bucket_size=2048, device=dev)
    x8 = ShardedIVF(one, mesh8)
    x8s = ShardedIVF.encode(small, ps, mesh=mesh8, quantizer="sq", nlist=2, bucket_size=2048)
    nb = one.metadata.nbuckets
    require(nb < EMPTY_SHARDS and x8._b_loc == 1, f"small case: {nb} buckets on "
            f"{EMPTY_SHARDS} shards, {EMPTY_SHARDS - nb} holding only pad buckets")
    full_sq = ScalarQuantizerU8.encode(small, ps, device=dev)
    want = full_sq.top_k(full_sq.encode_query(queries), K)
    for what, x in (("wrapped", x8), ("streamed", x8s)):
        got = x.top_k(x.encode_query(queries), K, nprobe=nb, nscan=nb)
        require(np.array_equal(got[0], want[0]), f"small case {what}: every bucket equals the "
                "single-device full SQ scan")
        ids_equal_where_untied(got[0], got[1], want[0], want[1], f"small case {what}")
    say("sharded-ivf", f"{EMPTY_N:,} rows, nlist 2, buckets of 2048: {nb} buckets on "
        f"{EMPTY_SHARDS} shards ({EMPTY_SHARDS - nb} hold only pad buckets), wrapped and "
        "streamed: every bucket equals the single-device full scan")
    del x8, x8s, one, full_sq, mesh8

    # ------------------------------------------- (g) per-batch device time
    for n, method in SHARDED_IVF_TIMED:
        def fs(n=n, method=method):
            return sh[n].top_k_device(seq[n], K, method=method, nprobe=IVF_NPROBE,
                                      nscan=IVF_NSCANS[0])

        def f1(n=n, method=method, scan="auto"):
            return single[n].top_k_device(eq1[n], K, method=method, nprobe=IVF_NPROBE,
                                          nscan=IVF_NSCANS[0], scan=scan)

        ms = {"sharded": timed_ms(fs, warmup=2, iters=5, reps=5),
              "single": timed_ms(f1, warmup=2, iters=5, reps=5)}
        extra = ""
        if sh[n].metadata.kind == "pq" and method == "approx":
            # The sharded PQ scan is compact; the single-device one indexed.
            ms["single_compact"] = timed_ms(lambda f1=f1: f1(scan="compact"), warmup=2,
                                            iters=5, reps=5)
            extra = (f", single-device compact {ms['single_compact']:.4f} ms "
                     f"({ms['sharded'] / ms['single_compact']:.2f}x)")
        info["batch_ms"][f"{n} {method}"] = ms
        say("time", f"sharded IVF {n} {method} top-{K}, nprobe {IVF_NPROBE}, nscan "
            f"{IVF_NSCANS[0]}: {ms['sharded']:.4f} ms per {Q}-query batch on {SHARDS} shards "
            f"of one card, single-device {ms['single']:.4f} ms "
            f"({ms['sharded'] / ms['single']:.2f}x){extra}, CUDA events, on {smi}")

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("sharded-ivf", f"path 8 wall {wall:.1f} s (limit {SHARDED_IVF_WALL_LIMIT_S:.0f} s; "
        f"wrap {info['wrap_s']:.1f}, builds {sum(info['build_s'].values()):.1f}, files "
        f"{info['files_s']:.1f}) on {smi}")
    require(wall <= SHARDED_IVF_WALL_LIMIT_S, f"path 8 within {SHARDED_IVF_WALL_LIMIT_S:.0f} s")
    return info


# Path 9 (the 10M anchor harness): bench_10m.main with the flags of
# BASELINE.md's anchor (tools/bench_10m.py --dist realistic --normalize;
# BASELINE.md:261-300) on the JAX harness's realistic corpus, Q = 256, k =
# 10, the automatic IVF geometry (S = 1024), on one card: at 5,000,000 x 768
# since paths 10-11 need the smoke's time (nlist 1,627; PERF.md §4), the
# anchor's 10,000,000 by `python -m quantization_tpu_torch.bench.bench_10m`.
BENCH10M_ARGV = ["--n", "5000000", "--d", "768", "--dist", "realistic", "--normalize",
                 "--opq", "--ivf", "--ivf-residual"]
# The legs those flags define, by family (at 5M the IVF-SQ ladder's
# fractions 1.19 and 4.75 % both round to 256 buckets, so its nscans are 3
# distinct values, as every other ladder's): 21 full-scan legs and 39 IVF
# legs.
BENCH10M_LEGS = {
    "BQ fused ": 2, "PQ fused ": 2, "PQ4 fused ": 2, "OPQ fused ": 2, "2s OPQ->f32 ": 3,
    "SQ fused ": 2, "2s SQ->f32 ": 3, "two-stage ": 3, "2s BQ->f32 ": 2,
    "IVF-SQ p=": 3, "2s IVF-SQ->f32 ": 5, "IVF-BQ p=": 3, "2s IVF-BQ->f32 ": 4,
    "IVF-OPQ p=": 3, "2s IVF-OPQ->f32 ": 3, "IVF-BQr p=": 3, "2s IVF-BQr->f32 ": 4,
    "IVF-SQr p=": 3, "2s IVF-SQr->f32 ": 2, "IVF-OPQr p=": 3, "2s IVF-OPQr->f32 ": 3,
}
# The same flags at 30,000 rows (3 batches of 10,000) on the card, held to
# the CPU rehearsal's recall@10 of every leg within BENCH10M_REHEARSAL_SLACK
# (python3 chip_smoke.py --rehearse 10m, 2,062 s on the CPU; rerun it and
# update these when the harness, the codecs or the corpus change).
BENCH10M_REHEARSAL_ARGV = BENCH10M_ARGV + ["--n", "30000", "--batch", "10000"]
BENCH10M_RECALL_REHEARSAL = {
    "BQ fused exact": 0.853, "BQ fused approx": 0.848, "PQ fused exact": 0.784,
    "PQ fused approx": 0.783, "PQ4 fused exact": 0.732, "PQ4 fused approx": 0.732,
    "OPQ fused exact": 0.855, "OPQ fused approx": 0.853, "2s OPQ->f32 ov=4": 0.988,
    "2s OPQ->f32 ov=16": 0.995, "2s OPQ->f32 ov=64": 0.995, "SQ fused exact": 0.991,
    "SQ fused approx": 0.989, "2s SQ->f32 ov=4": 0.998, "2s SQ->f32 ov=8": 0.998,
    "2s SQ->f32 ov=16": 0.998, "two-stage ov=8": 0.982, "two-stage ov=32": 0.983,
    "two-stage ov=128": 0.983, "2s BQ->f32 ov=16": 0.991, "2s BQ->f32 ov=64": 0.991,
    "IVF-SQ p=64 nscan=256": 0.980, "2s IVF-SQ->f32 R=40 p=64 nscan=256": 0.987,
    "IVF-BQ p=64 nscan=256": 0.848, "2s IVF-BQ->f32 R=160 p=64 nscan=256": 0.984,
    "2s IVF-BQ->f32 R=320 p=64 nscan=256": 0.984, "IVF-OPQ p=64 nscan=256": 0.846,
    "2s IVF-OPQ->f32 R=80 p=64 nscan=256": 0.983, "2s IVF-OPQ->f32 R=160 p=64 nscan=256": 0.984,
    "IVF-BQr p=64 nscan=256": 0.574, "2s IVF-BQr->f32 R=160 p=64 nscan=256": 0.932,
    "2s IVF-BQr->f32 R=320 p=64 nscan=256": 0.958, "IVF-SQr p=64 nscan=256": 0.980,
    "2s IVF-SQr->f32 R=40 p=64 nscan=256": 0.986, "IVF-OPQr p=64 nscan=256": 0.895,
    "2s IVF-OPQr->f32 R=40 p=64 nscan=256": 0.984,
    "2s IVF-OPQr->f32 R=160 p=64 nscan=256": 0.984,
}
BENCH10M_REHEARSAL_SLACK = 0.02
# The row kernel is held against plain threefry on these (first id, ids):
# the 10M corpus's last batch (timed), a batch across 2^24, path 10's 100M
# corpus's last batch and its 256 queries (ids from 100,000,000).
BENCH10M_ROWGEN_FROM = ((10_000_000 - 250_000, 250_000), (2**24 - 125_000, 250_000),
                        (100_000_000 - 250_000, 250_000), (100_000_000, 256))
BENCH10M_ROWGEN_MAX_ULPS = 2.0
# Its bound: one Threefry-2x32 hash a value, ~75 32-bit integer operations
# (20 add-rotate-xor rounds, the key injections, the words' xor and the
# mantissa's shift-or; csrc/rowgen_kernels.cu), at the 64 INT32 lanes an SM
# has (NVIDIA's Hopper white paper) at the card's top SM clock; 9 hashes a
# row more for its draws.
ROWGEN_INT_OPS_PER_HASH = 75
INT32_LANES_PER_SM = 64
ROWGEN_ROW_HASHES = 9
# Path 9 keeps to this many seconds of card wall.
BENCH10M_WALL_LIMIT_S = 240.0
# recall@10 of the same legs on one TPU v5e chip (BASELINE.md:268-279 and
# :315-328, :397-408, older JAX code at nlist 4096 / S 512, whose nscan
# 256 / 1024 / 2560 / 5120 are the ladders' fractions 0.0119 / 0.0475 /
# 0.1186 / 0.2372): printed beside the card's as a figure, not a bound.
BENCH10M_LADDER = {0.0119: 256, 0.0475: 1024, 0.1186: 2560, 0.2372: 5120}
BENCH10M_TPU_RECALL = {
    "SQ fused exact": 0.880, "SQ fused approx": 0.875, "BQ fused approx": 0.336,
    "PQ fused approx": 0.004, "OPQ fused approx": 0.188, "PQ4 fused approx": 0.002,
    "2s SQ->f32 ov=4": 0.983, "two-stage ov=8": 0.762, "2s BQ->f32 ov=64": 0.979,
    "2s OPQ->f32 ov=4": 0.393, "2s OPQ->f32 ov=16": 0.634, "2s OPQ->f32 ov=64": 0.833,
    "IVF-SQ nscan=256": 0.162, "IVF-SQ nscan=1024": 0.525, "IVF-SQ nscan=2560": 0.814,
    "IVF-SQ nscan=5120": 0.868, "2s IVF-SQ->f32 R=40 nscan=2560": 0.896,
    "2s IVF-SQ->f32 R=40 nscan=5120": 0.979, "2s IVF-SQ->f32 R=80 nscan=5120": 0.980,
    "IVF-BQ nscan=5120": 0.330, "2s IVF-BQ->f32 R=160 nscan=5120": 0.886,
    "2s IVF-BQ->f32 R=320 nscan=5120": 0.935, "IVF-OPQ nscan=2560": 0.178,
    "2s IVF-OPQ->f32 R=160 nscan=5120": 0.623, "IVF-SQr nscan=2560": 0.859,
    "IVF-SQr nscan=5120": 0.928, "2s IVF-SQr->f32 R=40 nscan=2560": 0.896,
    "2s IVF-SQr->f32 R=40 nscan=5120": 0.979, "IVF-OPQr nscan=5120": 0.604,
    "2s IVF-OPQr->f32 R=40 nscan=5120": 0.918, "2s IVF-OPQr->f32 R=160 nscan=5120": 0.972,
    "IVF-BQr nscan=5120": 0.277, "2s IVF-BQr->f32 R=320 nscan=2560": 0.857,
    "2s IVF-BQr->f32 R=320 nscan=5120": 0.918,
}
# Full-scan searches whose last launch is held against a plain version
# computed in blocks of this many rows (a multiple of every approx span,
# SPAN x 2048): at 10M rows a plain [256, N] score matrix and its f64
# product (61 GB for SQ) do not fit beside the resident codes.
DENSE_HOLD_BLOCK_ROWS = 1 << 20
DENSE_SEARCHES = ("sq_search_exact", "sq_search_approx", "bq_search_exact",
                  "bq_search_approx", "pq_search_exact", "pq_search_approx")


def ulps_apart(got, want):
    """max |got - want| in units of the last place of want."""
    step = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    return float(((got - want).abs() / step).max())


def leg_recalls(printed):
    """{leg: recall@10} of the harness's lines, and the FAILED legs."""
    import re

    rec, failed = {}, []
    for line in printed.splitlines():
        m = re.match(r"(\S.*?)\s*: .* recall@\d+ vs exact = ([0-9.naif]+)", line)
        if m:
            rec[m.group(1)] = float(m.group(2))
        elif re.match(r"\S.*?\s*: FAILED ", line):
            failed.append(line)
    return rec, failed


def tpu_key(leg, nbk):
    """The BASELINE.md label of a leg: its nscan as the TPU run's at the
    same fraction of the buckets."""
    import re

    m = re.match(r"(.*?) p=\d+ nscan=(\d+)$", leg)
    if not m:
        return leg
    head = m.group(1).replace(" R=", "\0R=").split("\0")
    frac = int(m.group(2)) / nbk
    near = min(BENCH10M_LADDER, key=lambda f: abs(f - frac))
    label = head[0] + ("" if len(head) == 1 else " " + head[1])
    return f"{label} nscan={BENCH10M_LADDER[near]}"


def dense_plain_blocked(m, name, a, kw):
    """The plain version of a full-scan search (K1 / K2, K5c / K5a, K7b /
    K7a, no residual additive) on its recorded inputs, in row blocks of
    DENSE_HOLD_BLOCK_ROWS: each block's plain scores (the module's own),
    exact top-k or the approx stride-class candidates of the whole corpus's
    geometry, then the exact merge. Equal to the unblocked plain version:
    approx candidates of whole spans, in the same order; exact values (ids
    among ties in torch.topk's order)."""
    from quantization_tpu_torch.ops import sq as sq_ops
    from quantization_tpu_torch.ops.kernels import bq_kernel, ktile, pq_kernel, sq_kernel

    b = bound_args(m, name, a, kw)
    require(all(b.get(x) is None for x in ("corr", "rowadd", "query_affine")),
            f"{name}: a full-scan search with no residual additive")
    if m is sq_kernel:
        codes = b["codes"]
        npad, tile = codes.shape[0], sq_kernel.approx_tile_n(codes.shape[0])

        def scores(r0, r1):
            return sq_ops.score_batch(b["qcodes"], b["qoff"], codes[r0:r1], b["voff"][r0:r1],
                                      b["multiplier"], distance_type=b["distance_type"])
    elif m is bq_kernel:
        planes = b["planes"]
        npad = planes.shape[1]
        tile = bq_kernel.mxu_tile_n(planes.shape[0] * 32, npad)

        def scores(r0, r1):
            return bq_kernel._plain_scores(b["qwords"], planes[:, r0:r1], None, None,
                                           distance_type=b["distance_type"],
                                           invert=b["invert"], dim=b["dim"])
    else:
        require(m is pq_kernel, f"a blocked plain version for {m.__name__}")
        codes_t = b["codes_t"]
        npad, tile = codes_t.shape[1], pq_kernel.TILE_N
        words, scale, bias = pq_kernel._operands(
            b["lut"], b["precision"] or pq_kernel.lut_precision())

        def scores(r0, r1):
            return pq_kernel._plain_scores(words, scale, bias, codes_t[:, r0:r1], r1 - r0)

    require(DENSE_HOLD_BLOCK_ROWS % (ktile.SPAN * tile) == 0, "blocks of whole spans")
    exact, k, n_valid = b["mode"] == "exact", b["k"], b["n_valid"]
    end = n_valid if exact else npad
    vals, ids = [], []
    for r0 in range(0, end, DENSE_HOLD_BLOCK_ROWS):
        r1 = min(r0 + DENSE_HOLD_BLOCK_ROWS, end)
        s = scores(r0, r1)
        if exact:
            v, i = torch.topk(s, min(k, r1 - r0), dim=1)
        else:
            s[:, max(0, n_valid - r0):] = ktile.NEG
            v, i = ktile.approx_candidates(s, tile)
        vals.append(v)
        ids.append(i.to(torch.int32) + r0)
        del s
    v, i = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
    return ktile.merge_exact(v, i, k) if exact else ktile.merge_candidates(v, i, k)


def bound_args(m, name, a, kw):
    """The arguments of a recorded call by name, defaults applied."""
    import inspect

    b = inspect.signature(getattr(m, name + "_plain")).bind(*a, **kw)
    b.apply_defaults()
    return b.arguments


def pq_body(m, name, a, kw):
    """The body a PQ search ran (``recorded``'s ``body``): the anchor's 4-bit
    searches take the one-hot body and its 8-bit ones the LUT gather, under
    one counter each for exact and approx."""
    from quantization_tpu_torch.ops.kernels import pq_kernel

    if m is not pq_kernel or name != "pq_search":
        return None
    b = bound_args(m, name, a, kw)
    onehot = pq_kernel.onehot_route(b["lut"].shape[2], b["precision"] or
                                    pq_kernel.lut_precision(), b["mode"])
    return "one-hot" if onehot else "lut-gather"


def hold_at_scale(calls, launches, what):
    """Path 9's holds, on the last call of each launched counter and body
    (``recorded`` with ``pq_body``): the full-scan searches against
    ``dense_plain_blocked`` (values equal; exact ids equal where untied and
    distinct, approx ids equal), every other launched kernel through
    ``hold_searches`` (the indexed scans and the residual additives
    included)."""
    keys = {key: launches[key.split(" ")[0]] for key in calls
            if key.split(" ")[0] in launches}
    require(set(launches) <= {key.split(" ")[0] for key in keys},
            f"{what}: a recorded call of every launched kernel")
    dense = {c for c in keys if c.split(" ")[0] in DENSE_SEARCHES and all(
        bound_args(*calls[c][:4]).get(x) is None for x in ("corr", "rowadd", "query_affine"))}
    held = hold_searches(calls, {c: n for c, n in keys.items() if c not in dense}, what)
    for counter in sorted(dense):
        m, name, a, kw, (v, i) = calls[counter]
        torch.cuda.synchronize()
        pv, pi = dense_plain_blocked(m, name, a, kw)
        tag = f"{what}: {counter}"
        require(torch.equal(v, pv), f"{tag}: values equal plain")
        if bound_args(m, name, a, kw)["mode"] == "exact":
            ids_equal_where_untied(*(t.cpu().numpy() for t in (v, i, pv, pi)), tag)
            srt = torch.sort(i, dim=1).values
            require(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()),
                    f"{tag}: distinct ids")
        else:
            require(torch.equal(i, pi), f"{tag}: ids equal plain")
        held[counter] = (list(v.shape), 0.0)
        del pv, pi
        torch.cuda.empty_cache()
    return held


def rowgen_check(dev, smi):
    """The row kernel against plain threefry on the anchor's corpus (the
    same rows at 10M and 100M: a row is drawn from its id alone): clusters
    equal, rows within BENCH10M_ROWGEN_MAX_ULPS, both distributions, on
    each of BENCH10M_ROWGEN_FROM's id ranges; then timed on the first of
    them (250,000 x 768, the harness's batch) beside its plain version and
    its bound. Returns its kernels-line-shaped record."""
    from quantization_tpu_torch.bench import bench_10m, threefry

    rows = bench_10m.RowSource(bench_10m.parser().parse_args(BENCH10M_ARGV), dev)
    worst = 0.0
    for first, count in BENCH10M_ROWGEN_FROM:
        ids = torch.arange(first, first + count, device=dev)
        for spectrum in (rows.spectrum, None):
            got, gc = threefry.latent_rows(ids, rows.centers, spectrum, rows.sigma, rows.base,
                                           return_clusters=True)
            want, wc = threefry.latent_rows_plain(ids, rows.centers, spectrum, rows.sigma,
                                                  rows.base, return_clusters=True)
            dist = "realistic" if spectrum is not None else "clustered"
            require(torch.equal(gc, wc), f"row kernel: clusters of ids {first}.. ({dist}) "
                    "equal plain threefry's")
            ulps = ulps_apart(got, want)
            require(ulps <= BENCH10M_ROWGEN_MAX_ULPS, f"row kernel: rows of ids {first}.. "
                    f"({dist}) within {BENCH10M_ROWGEN_MAX_ULPS} ulp of plain ({ulps})")
            worst = max(worst, float((got - want).abs().max()))
            say("bench10m", f"row kernel, {count:,} ids from {first:,} "
                f"({dist}): clusters equal, max {ulps:g} ulp from plain threefry, "
                f"{100 * float((got == want).float().mean()):.4f} % equal to the bit")
    first, n = BENCH10M_ROWGEN_FROM[0]
    d = rows.centers.shape[1]
    ids = torch.arange(first, first + n, device=dev)

    def kernel():
        return threefry.latent_rows(ids, rows.centers, rows.spectrum, rows.sigma, rows.base)

    ms = timed_ms(kernel)
    p_ms = plain_ms(lambda: threefry.latent_rows_plain(ids, rows.centers, rows.spectrum,
                                                       rows.sigma, rows.base))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops = n * (d + ROWGEN_ROW_HASHES) * ROWGEN_INT_OPS_PER_HASH
    nbytes = 4 * (n * d + n) + rows.centers.numel() * 4 + d * 4
    bnd = bound(nbytes, int_ops, INT32_LANES_PER_SM * sms * max_sm_clock_hz())
    say("bench10m", f"row kernel at {n:,} x {d} (realistic): {ms:.4f} ms, plain threefry "
        f"{p_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}: {int_ops:.3e} int32 operations), "
        f"{100 * bnd[0] / ms:.1f} % of it; a 10M pass {ms * 40:.1f} ms; on {smi}")
    return {"name": "latent_rows", "route": "cuda", "source": SRC + "rowgen_kernels.cu",
            "replaces": "none (tools/bench_10m.py:164-222 draws with jax.random)",
            "max_abs_err": worst, "ms": ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def ivf_breakdown(ivf, eq, nprobe, nscan, smi):
    """One IVF-SQ search of the harness's deepest coarse leg, split as path
    4 splits it (probe + union, the indexed scan, dedupe, the device span
    and the host wall), and torch.profiler's kernel times of it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from quantization_tpu_torch import DistanceType
    from quantization_tpu_torch.models import ivf as ivf_mod
    from quantization_tpu_torch.ops.kernels import sq_kernel

    q_dev, eqi = eq
    meta = ivf.metadata
    _, _, kk2, _, _, itile = ivf_mod._search_plan(meta, ivf._max_dup, K, nprobe, nscan,
                                                  "approx", "auto", None)
    require(itile > 0, "the deepest IVF-SQ leg scans indexed")
    a, inner = ivf._family_arrays(eqi)
    union = ivf_union(ivf, q_dev, nprobe, nscan)
    tiles = tiles_of(union, meta.bucket_size, itile)

    def scan():
        return sq_kernel.sq_search_indexed(*a, *inner, tiles, distance_type=DistanceType.DOT,
                                           k=kk2, mode="approx", tile_n=itile)

    parts = {"probe_union_ms": timed_ms(lambda: ivf_union(ivf, q_dev, nprobe, nscan)),
             "kernel_ms": timed_ms(scan)}
    sv, loc = scan()
    ids = ivf._slot_ids_dev.reshape(-1)[loc.clamp(min=0).long()]
    parts["dedupe_ms"] = timed_ms(lambda: ivf_mod._dedupe_select(sv, ids, Q, K, kk2))

    def search():
        return ivf.top_k_device(eq, K, method="approx", nprobe=nprobe, nscan=nscan)

    parts["span_ms"] = timed_ms(search)
    parts["wall_ms"] = wall_ms(lambda: ivf.top_k(eq, K, method="approx", nprobe=nprobe,
                                                 nscan=nscan))
    parts["host_ms"] = parts["wall_ms"] - parts["span_ms"]
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        search()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type.name == "CUDA"), key=lambda kv: -kv[1])
    parts["profiler_kernel_ms"] = sum(t for _, t in kernels)
    say("breakdown", f"path 9 IVF-SQ approx top_k, nprobe {nprobe}, nscan {nscan} "
        f"({tiles.shape[0]} tiles of {itile} rows, {tiles.shape[0] * itile:,} rows): "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in parts.items()) + f", on {smi}")
    say("breakdown", "  profiler, by kernel: " + ", ".join(
        f"{k_[:48]} {t:.4f} ms" for k_, t in kernels[:6]))
    return parts


def bench10m_path(dev, smi):
    """Path 9: the 10M anchor harness (bench/bench_10m.py) in process at
    BENCH10M_ARGV. The row kernel held against plain threefry; every leg
    present, none FAILED, exit 0, recall figures finite in [0, 1], each
    rescored leg at least its coarse leg, the IVF-SQ ladder non-decreasing;
    every TPU kernel it launched held against plain on its last launch; a
    breakdown of its deepest IVF-SQ search; the same flags at 30,000 rows
    held to the CPU rehearsal (--rehearse 10m). Its wall is held to
    BENCH10M_WALL_LIMIT_S."""
    import re

    from quantization_tpu_torch.bench import bench_10m, threefry
    from quantization_tpu_torch.models.ivf import IVFIndex
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    t_path = time.perf_counter()
    info = {"rowgen": rowgen_check(dev, smi)}
    torch.cuda.empty_cache()

    deepest = {}
    report_serve = bench_10m.Harness.report_serve

    def keep_deepest(self, name, index, eq, gt, iters=10, **knobs):
        report_serve(self, name, index, eq, gt, iters, **knobs)
        if (name.startswith("IVF-SQ p=") and isinstance(index, IVFIndex)
                and knobs["nscan"] >= deepest.get("nscan", 0)):
            deepest.update(index=index, eq=eq, nprobe=knobs["nprobe"], nscan=knobs["nscan"])

    reset_all(*mods, threefry)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bench_10m.Harness.report_serve = keep_deepest
    try:
        with recorded(*mods, body=pq_body) as calls:
            rc, printed = captured(bench_10m.main, BENCH10M_ARGV)
    finally:
        bench_10m.Harness.report_serve = report_serve
    info["main_s"] = time.perf_counter() - t0
    info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = {k_: v for k_, v in counts(*mods).items() if v}
    info["rowgen"]["launches"] = threefry.LAUNCHES["latent_rows"]
    info["launches"] = launches
    say("bench10m", f"main() at {BENCH10M_ARGV[1]} x 768 in {info['main_s']:.1f} s (peak "
        f"{info['peak_gb']:.1f} GB allocated), exit {rc}; launches {launches}, row kernel "
        f"{info['rowgen']['launches']}; on {smi}")
    require(rc == 0, "bench_10m.main exits 0")
    require_sign_ws("10M anchor", launches, ("bq_search_approx", "bq_search_indexed"))
    rec, failed = leg_recalls(printed)
    require(not failed, f"no FAILED leg ({failed})")
    for prefix, n in BENCH10M_LEGS.items():
        got = [leg for leg in rec if leg.startswith(prefix)]
        require(len(got) == n, f"{n} '{prefix}' legs ({got})")
    require(len(rec) == sum(BENCH10M_LEGS.values()), f"the flags' legs and no other ({len(rec)})")
    require(all(0.0 <= r <= 1.0 for r in rec.values()), "every recall finite in [0, 1]")
    coarse = {"SQ": "SQ fused approx", "OPQ": "OPQ fused approx", "BQ": "BQ fused approx"}
    for leg, r in rec.items():
        m = re.match(r"2s (IVF-\w+)->f32 R=\d+ (p=\d+ nscan=\d+)$", leg)
        base = f"{m.group(1)} {m.group(2)}" if m else None
        m2 = re.match(r"2s (\w+)->f32 ov=", leg)
        base = base or (coarse[m2.group(1)] if m2 else None)
        if base:
            require(r >= rec[base] - 0.01, f"{leg} ({r}) >= {base} ({rec[base]}) - 0.01")
    ladder = [rec[leg] for leg in sorted((leg for leg in rec if leg.startswith("IVF-SQ p=")),
                                         key=lambda s: int(s.rsplit("=", 1)[1]))]
    require(all(b >= a - 0.01 for a, b in zip(ladder, ladder[1:])),
            f"the IVF-SQ ladder's recall non-decreasing ({ladder})")
    nbk = int(re.search(r"\((\d+) buckets x (\d+)", printed).group(1))
    info["nbuckets"] = nbk
    info["recall_at_10"] = rec
    info["times_ms"] = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(\S.*?)\s*: .*\(\s*([0-9.]+) ms/batch\)", printed, re.M)}
    info["passes_s"] = {m.group(1): float(m.group(2)) for m in (
        re.match(r"(.*?):? (\d+)s\b", line) for line in printed.splitlines()
        if "recall@" not in line and not line.startswith(("IVF geometry", "residual SQ")))
        if m}
    for leg, r in rec.items():
        tpu = BENCH10M_TPU_RECALL.get(tpu_key(leg, nbk))
        say("bench10m", f"{leg}: recall@10 {r:.3f} on the card"
            + (f", {tpu:.3f} on the TPU (BASELINE.md, as {tpu_key(leg, nbk)})"
               if tpu is not None else ""))

    say("bench10m", "the PQ legs (device ms a batch): " + ", ".join(
        f"{leg} {t:.3f}" for leg, t in info["times_ms"].items() if "PQ" in leg))
    info["breakdown_ms"] = ivf_breakdown(deepest["index"], deepest["eq"], deepest["nprobe"],
                                         deepest["nscan"], smi)
    deepest.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = hold_at_scale(calls, launches, "10M anchor")
    info["hold_s"] = time.perf_counter() - t0
    info["held_max_abs_err"] = {c: e for c, (_, e) in held.items()}
    bodies = {f"{c} ({b})" for c in ("pq_search_exact", "pq_search_approx")
              for b in ("one-hot", "lut-gather")}
    require(bodies <= set(held), "10M anchor: the 4-bit one-hot and the 8-bit LUT-gather "
            f"PQ searches each held on their last launch ({sorted(held)})")
    say("bench10m", "each launched kernel's last launch against plain on its inputs: "
        + ", ".join(f"{c} {shape}" for c, (shape, _) in sorted(held.items()))
        + f" ({info['hold_s']:.1f} s)")
    del calls
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc, printed = captured(bench_10m.main, BENCH10M_REHEARSAL_ARGV)
    require(rc == 0, "the 30,000-row run exits 0")
    small, failed = leg_recalls(printed)
    require(not failed, f"no FAILED leg at 30,000 rows ({failed})")
    require(set(small) == set(BENCH10M_RECALL_REHEARSAL),
            f"the 30,000-row legs are the rehearsal's ({sorted(set(small) ^ set(BENCH10M_RECALL_REHEARSAL))})")
    for leg, r in small.items():
        want = BENCH10M_RECALL_REHEARSAL[leg]
        require(abs(r - want) <= BENCH10M_REHEARSAL_SLACK,
                f"{leg} at 30,000 rows: {r:.4f} on the card within "
                f"{BENCH10M_REHEARSAL_SLACK} of the CPU rehearsal's {want:.4f}")
    info["rehearsal_recall_at_10"] = small
    info["rehearsal_s"] = time.perf_counter() - t0
    say("bench10m", f"the same flags at 30,000 rows: {len(small)} legs within "
        f"{BENCH10M_REHEARSAL_SLACK} of the CPU rehearsal (--rehearse 10m), max |diff| "
        f"{max(abs(r - BENCH10M_RECALL_REHEARSAL[k_]) for k_, r in small.items()):.4f}, "
        f"{info['rehearsal_s']:.1f} s")
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("bench10m", f"path 9 wall {wall:.1f} s (limit {BENCH10M_WALL_LIMIT_S:.0f} s; main "
        f"{info['main_s']:.1f}, holds {info['hold_s']:.1f}, 30,000 rows "
        f"{info['rehearsal_s']:.1f}) on {smi}")
    require(wall <= BENCH10M_WALL_LIMIT_S, f"path 9 within {BENCH10M_WALL_LIMIT_S:.0f} s")
    return info


# Path 10 (the capacity configuration): bench_10m.main at 100,000,000 x 768
# with the JAX run's flags (BASELINE.md:520-521, tools/bench_10m.py --n
# 100000000 --batch 250000 --dist realistic --normalize --only none --ivf
# --ivf-base bq), Q = 256, k = 10, the automatic geometry, on one card.
CAPACITY_N = 100_000_000
CAPACITY_ARGV = ["--n", str(CAPACITY_N), "--batch", "250000", "--d", "768", "--dist",
                 "realistic", "--normalize", "--only", "none", "--ivf", "--ivf-base", "bq"]
CAPACITY_GEOMETRY = (32_552, 1024)  # (nlist, S) of auto_geometry at 100M, the JAX run's
CAPACITY_PLANE_BYTES_PER_SLOT = 96  # 768 sign bits in 24 int32 words
# The serving peak's limit: the 16 GB TPU v5e chip the JAX package served
# the same index from (BASELINE.md:528).
CAPACITY_PEAK_LIMIT_B = 16 * 2**30
CAPACITY_WALL_LIMIT_S = 360.0
CAPACITY_RECALL_SLACK = 0.03
# The JAX run on one TPU v5e chip (BASELINE.md:585-594): recall@10, q/s and
# ms a batch by (R, None for a coarse leg; ladder fraction). Legs are
# matched by fraction: at another bucket count the nscans may differ by
# 256. R = 160 over the widest scan has no figure there.
CAPACITY_FRACTIONS = (0.0475, 0.1186, 0.2372)
CAPACITY_TPU = {
    (None, 0.0475): (0.207, 13264, 19.3), (None, 0.1186): (0.207, 8252, 31.0),
    (None, 0.2372): (0.206, 5086, 50.3), (160, 0.1186): (0.676, 5502, 46.5),
    (320, 0.1186): (0.783, 3920, 65.3), (320, 0.2372): (0.783, 2627, 97.4),
    (640, 0.2372): (0.856, 1508, 169.7), (1280, 0.2372): (0.895, 804, 318.5),
}


def capacity_leg(leg, nbk):
    """(R or None, ladder fraction) of an IVF-BQ leg's name at ``nbk``
    buckets."""
    import re

    m = re.match(r"(?:2s IVF-BQ->f32 R=(\d+)|IVF-BQ) p=\d+ nscan=(\d+)$", leg)
    require(m, f"an IVF-BQ leg ({leg})")
    frac = min(CAPACITY_FRACTIONS, key=lambda f: abs(f - int(m.group(2)) / nbk))
    return (int(m.group(1)) if m.group(1) else None), frac


def capacity_path(dev, smi, keep):
    """Path 10: the capacity configuration, bench_10m.main at CAPACITY_ARGV
    in process, its build left in ``keep`` (main's holder) for path 11. Checks the geometry (CAPACITY_GEOMETRY), that every row
    sits in exactly one slot, the planes' 96 B a slot, the serving peak
    (reset after the build) against CAPACITY_PEAK_LIMIT_B, each leg's
    recall@10 within CAPACITY_RECALL_SLACK of the TPU's, each rescored leg
    at least its coarse leg and recall not falling as R grows (0.01 slack),
    no FAILED leg, K10 held against plain on its last launch (a chunk of the
    widest leg's scan), and the path's wall against CAPACITY_WALL_LIMIT_S. Prints
    the build phases, the resident bytes and each leg's q/s and device ms
    beside the TPU's."""
    import re

    from quantization_tpu_torch.bench import bench_10m, threefry
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    t_path = time.perf_counter()
    served = {}
    report_serve = bench_10m.Harness.report_serve

    def keep_index(self, name, index, eq, gt, iters=10, **knobs):
        served.setdefault("index", index)
        report_serve(self, name, index, eq, gt, iters, **knobs)

    torch.cuda.empty_cache()
    reset_all(*mods, threefry)
    bench_10m.Harness.report_serve = keep_index
    try:
        with recorded(bq_kernel) as calls:
            rc, printed = captured(bench_10m.main, CAPACITY_ARGV, keep)
    finally:
        bench_10m.Harness.report_serve = report_serve
    info = {"main_s": time.perf_counter() - t_path}
    launches = {k_: v for k_, v in counts(*mods).items() if v}
    info["launches"] = launches
    info["rowgen_launches"] = threefry.LAUNCHES["latent_rows"]
    say("capacity", f"main() at 100,000,000 x 768 in {info['main_s']:.1f} s, exit {rc}; "
        f"launches {launches}, row kernel {info['rowgen_launches']}; on {smi}")
    require(rc == 0, "bench_10m.main at 100M exits 0")
    rec, failed = leg_recalls(printed)
    require(not failed, f"no FAILED leg at 100M ({failed})")
    require(set(launches) == {"bq_search_indexed"}, f"path 10 launches K10 alone ({launches})")
    require_sign_ws("100M capacity", launches, ("bq_search_indexed",))

    geo = re.search(r"^IVF geometry: nlist=(\d+) S=(\d+)", printed, re.M)
    nlist, s = int(geo.group(1)), int(geo.group(2))
    nbk = int(re.search(r"\((\d+) buckets x (\d+)", printed).group(1))
    info.update(nlist=nlist, bucket_size=s, nbuckets=nbk)
    say("capacity", f"geometry nlist {nlist}, S {s}, {nbk:,} buckets ({nbk * s:,} slots) on {smi}")
    require((nlist, s) == CAPACITY_GEOMETRY, f"the automatic geometry {CAPACITY_GEOMETRY}")
    require("kept build" not in printed and "build" in keep, "path 10 builds afresh and keeps "
            "its build")

    index = served.pop("index")
    ids = index.bucket_ids[index.bucket_ids >= 0]
    require(ids.size == CAPACITY_N and bool((np.bincount(ids, minlength=CAPACITY_N) == 1).all()),
            "every row in exactly one slot: the slot ids >= 0 are a permutation of 0..N-1")
    planes = index.quantizer.planes
    npad_i = nbk * s + (-(nbk * s)) % 2048
    plane_b = planes.numel() * planes.element_size()
    require(tuple(planes.shape) == (24, npad_i)
            and plane_b == CAPACITY_PLANE_BYTES_PER_SLOT * npad_i,
            f"the planes hold {CAPACITY_PLANE_BYTES_PER_SLOT} B a slot ({list(planes.shape)})")
    del index, planes, ids

    res = re.search(r"^IVF-BQ resident: planes ([\d,]+) B, bucket means ([\d,]+) B, slot ids "
                    r"([\d,]+) B .*bucket tables ([\d,]+) B on the host", printed, re.M)
    info["resident_b"] = {k_: int(res.group(i).replace(",", "")) for i, k_ in enumerate(
        ("planes", "bucket_means", "slot_ids", "host_bucket_tables"), 1)}
    peak = int(re.search(r"^IVF-BQ serving peak: ([\d,]+) B", printed, re.M).group(1)
               .replace(",", ""))
    info["serving_peak_b"] = peak
    dev_b = sum(v for k_, v in info["resident_b"].items() if k_ != "host_bucket_tables")
    say("capacity", "resident serving state: " + ", ".join(
        f"{k_} {v:,} B" for k_, v in info["resident_b"].items())
        + f" ({dev_b / 1e9:.3f} GB on the card); serving peak {peak:,} B allocated "
        f"({peak / 2**30:.3f} GiB, limit {CAPACITY_PEAK_LIMIT_B / 2**30:.0f} GiB) on {smi}")
    require(peak <= CAPACITY_PEAK_LIMIT_B, "the serving peak within 16 GiB")

    info["build_s"] = {m.group(1): int(m.group(2)) for m in (
        re.match(r"(.*?):? (\d+)s\b", line) for line in printed.splitlines()
        if "recall@" not in line and not line.startswith("IVF geometry")) if m}
    say("capacity", "build phases (s): " + ", ".join(
        f"{k_} {v}" for k_, v in info["build_s"].items()) + f" on {smi}")

    coarse, rescored = bench_10m.ivf_bq_legs(CAPACITY_N, nbk)
    want = [f"IVF-BQ p=64 nscan={u}" for u in coarse]
    want += [f"2s IVF-BQ->f32 R={rr} p={p} nscan={u}" for rr, p, u in rescored]
    require(list(rec) == want, f"the IVF-BQ legs of the JAX harness at 100M ({list(rec)})")
    times = {m.group(1): (float(m.group(2)), float(m.group(3)), float(m.group(4))) for m in
             re.finditer(r"^(\S.*?)\s*:\s+(\d+) qps\s+\(\s*([0-9.]+) ms/batch\).*"
                         r"\[device ([0-9.]+) ms/batch\]", printed, re.M)}
    info["legs"] = {}
    for leg, r in rec.items():
        rr, frac = capacity_leg(leg, nbk)
        qps, host_ms, dev_ms = times[leg]
        tpu = CAPACITY_TPU.get((rr, frac))
        info["legs"][leg] = {"recall_at_10": r, "qps": qps, "ms_batch": host_ms,
                             "device_ms_batch": dev_ms, "fraction": frac,
                             "tpu": None if tpu is None else dict(zip(
                                 ("recall_at_10", "qps", "ms_batch"), tpu))}
        say("capacity", f"{leg} ({100 * frac:.2f} % of the buckets): recall@10 {r:.3f}, "
            f"{qps:.0f} q/s, {host_ms:.2f} ms a batch, device {dev_ms:.3f} ms on {smi}"
            + (f"; TPU v5e (BASELINE.md) {tpu[0]:.3f}, {tpu[1]} q/s, {tpu[2]} ms"
               if tpu else "; no TPU figure"))
        if tpu:
            require(abs(r - tpu[0]) <= CAPACITY_RECALL_SLACK,
                    f"{leg}: recall@10 {r:.3f} within {CAPACITY_RECALL_SLACK} of the TPU's "
                    f"{tpu[0]:.3f}")
    by = {capacity_leg(leg, nbk): r for leg, r in rec.items()}
    for (rr, frac), r in by.items():
        if rr is not None:
            require(r >= by[(None, frac)] - 0.01, f"R={rr} at {frac}: {r:.3f} >= coarse "
                    f"{by[(None, frac)]:.3f} - 0.01")
            deeper = [(r2, v) for (r2, f2), v in by.items() if f2 == frac and r2 and r2 > rr]
            require(all(v >= r - 0.01 for _, v in deeper),
                    f"recall not falling as R grows at {frac} ({r:.3f} at R={rr}, {deeper})")

    t0 = time.perf_counter()
    held = hold_searches(calls, {"bq_search_indexed": launches["bq_search_indexed"]},
                         "100M capacity")
    m, name, a, kw, _ = calls["bq_search_indexed"]
    tiles = bound_args(m, name, a, kw)["tile_sel"]
    info["k10_held"] = {"tiles": int(tiles.shape[0]), "tile_n": kw["tile_n"],
                        "rows": int(tiles.shape[0]) * kw["tile_n"],
                        "hold_s": time.perf_counter() - t0}
    say("capacity", f"K10's last launch (a chunk of the widest leg's scan: {tiles.shape[0]:,} "
        f"tiles of {kw['tile_n']} rows, {info['k10_held']['rows']:,} rows) against plain: values "
        f"and ids equal ({info['k10_held']['hold_s']:.1f} s); {held}")
    del calls, m, a, kw, tiles
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("capacity", f"path 10 wall {wall:.1f} s (limit {CAPACITY_WALL_LIMIT_S:.0f} s; main "
        f"{info['main_s']:.1f}) on {smi}")
    require(wall <= CAPACITY_WALL_LIMIT_S, f"path 10 within {CAPACITY_WALL_LIMIT_S:.0f} s")
    return info


# Path 11 (the quality-first capacity point): path 10's flags with the
# IVF-OPQ(r) inner codes (BASELINE.md:612-622), on the build path 10 kept.
CAPACITY_OPQ_ARGV = CAPACITY_ARGV[:-1] + ["opq", "--ivf-residual"]
CAPACITY_CODE_BYTES_PER_SLOT = 96  # m = 96 chunks of 8 dims, one byte each
CAPACITY_OPQ_WALL_LIMIT_S = 240.0
# The JAX run on one TPU v5e chip (BASELINE.md:624-635): recall@10, q/s and
# ms a batch by (index, R or None for a coarse leg, ladder fraction). The
# legs without a figure there are printed without a bound.
CAPACITY_OPQ_TPU = {
    ("IVF-OPQ", None, 0.0475): (0.105, 1253, 204),
    ("IVF-OPQ", 640, 0.1186): (0.554, 445, 575),
    ("IVF-OPQr", None, 0.0475): (0.514, 340, 753),
    ("IVF-OPQr", None, 0.1186): (0.514, 140, 1829),
    ("IVF-OPQr", 40, 0.0475): (0.827, 339, 756),
    ("IVF-OPQr", 160, 0.0475): (0.923, 333, 768),
    ("IVF-OPQr", 320, 0.0475): (0.929, 326, 785),
    ("IVF-OPQr", 160, 0.1186): (0.949, 139, 1845),
    ("IVF-OPQr", 320, 0.1186): (0.957, 137, 1863),
}


# F40: the TPU's plain IVF-OPQ figures come from the JAX harness's f32
# products at XLA's default precision on a TPU, one bf16 pass
# (bench/precision_ab.py); the port keeps f32 and reads above them. Those two
# legs are held to beat the TPU's figure by at least a margin, which the
# port's own one-bf16-pass runs fail (coarse 0.100 / 0.116 against 0.105,
# R = 640 0.536 / 0.582 against 0.554) and its f32 meets (0.154, 0.737).
CAPACITY_OPQ_F32_MARGIN = {
    ("IVF-OPQ", None, 0.0475): 0.02,
    ("IVF-OPQ", 640, 0.1186): 0.10,
}


def harness_legs(printed):
    """[(leg, recall@10)] of the harness's lines, in order."""
    import re

    return [(m.group(1), float(m.group(2))) for m in re.finditer(
        r"^(\S.*?)\s*: .* recall@\d+ vs exact = ([0-9.naif]+)", printed, re.M)]


def opq_leg_names(tag, legs_fn, nbk):
    """The leg names of ``legs_fn`` (ivf_opq_legs / ivf_opqr_legs) at 100M."""
    coarse, rescored = legs_fn(CAPACITY_N, nbk)
    return ([f"{tag} p=64 nscan={u}" for u in coarse]
            + [f"2s {tag}->f32 R={rr} p={p} nscan={u}" for rr, p, u in rescored])


def capacity_opq_leg(leg, nbk):
    """(index, R or None, ladder fraction) of an IVF-OPQ(r) leg's name at
    ``nbk`` buckets."""
    import re

    m = re.match(r"(?:2s (IVF-OPQr?)->f32 R=(\d+)|(IVF-OPQr?)) p=\d+ nscan=(\d+)$", leg)
    require(m, f"an IVF-OPQ(r) leg ({leg})")
    frac = min(CAPACITY_FRACTIONS, key=lambda f: abs(f - int(m.group(4)) / nbk))
    return m.group(1) or m.group(3), (int(m.group(2)) if m.group(2) else None), frac


def capacity_opq_path(dev, smi, keep, nbk10):
    """Path 11: bench_10m.main at CAPACITY_OPQ_ARGV in process, on the
    build path 10 left in ``keep`` (``nbk10`` buckets). Checks that the
    build was taken, the geometry, exactly the legs of ``ivf_opq_legs``
    then ``ivf_opqr_legs`` in order (the duplicate leg kept), each index's
    codes [96, slots] u8 at 96 B a slot and the appender's own buffer, each
    serving peak against CAPACITY_PEAK_LIMIT_B, each leg with a TPU figure
    within CAPACITY_RECALL_SLACK of it (plain IVF-OPQ's above it by
    CAPACITY_OPQ_F32_MARGIN, F40), rescored legs at least their coarse
    leg and not falling as R grows (0.01), no FAILED leg, every K11 launch
    on the LUT-gather ring, K11 held against plain on the last launch of
    each LUT word (at the end of its index's legs, where its codes are
    still resident; the held launch is then timed against its bound, and
    none of these launches is counted), and the path's wall against
    CAPACITY_OPQ_WALL_LIMIT_S. Prints the phases (the two OPQ trainings
    apart from their encodes), the resident bytes, the peaks and each leg's
    q/s and device ms beside the TPU's."""
    import re

    from quantization_tpu_torch.bench import bench_10m, threefry
    from quantization_tpu_torch.models.pq import ProductQuantizer
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

    mods = (sq_kernel, bq_kernel, pq_kernel, gather)
    props = torch.cuda.get_device_properties(0)
    clock = max_sm_clock_hz()
    t_path = time.perf_counter()
    made, trains, words = [], [], {}
    saved = (bench_10m.Harness.serving_peak, bench_10m.train_opq,
             ProductQuantizer.__dict__["from_transposed"])

    def from_transposed(cls, codes_t, metadata):
        q = saved[2].__func__(cls, codes_t, metadata)
        made.append((tuple(q.codes_t.shape), q.codes_t.dtype, q.codes_t.data_ptr()
                     == codes_t.data_ptr()))
        return q

    def train_opq(*a, **kw):
        t0 = time.perf_counter()
        out = saved[1](*a, **kw)
        trains.append(time.perf_counter() - t0)
        return out

    def lut_word(m, name, a, kw):
        if m is not pq_kernel or name != "pq_search_indexed":
            return None
        return bound_args(m, name, a, kw)["precision"] or pq_kernel.lut_precision()

    def hold_index(self, tag):
        """After ``tag``'s serving peak: its K11 launches, all of one LUT
        word, held and timed on the last."""
        saved[0](self, tag)
        keys = [c for c in calls if c.startswith("pq_search_indexed")]
        require(len(keys) == 1, f"{tag}: one LUT word since the last index ({keys})")
        c = keys[0]
        word = c[c.index("(") + 1 : -1]
        n = pq_kernel.LAUNCHES["pq_search_indexed"] - sum(w["launches"] for w in words.values())
        before = {m_: dict(m_.LAUNCHES) for m_ in mods}
        t0 = time.perf_counter()
        held = hold_searches(calls, {c: n}, f"100M {tag}")
        m, name, a, kw, _ = calls[c]
        b = bound_args(m, name, a, kw)
        rows = int(b["tile_sel"].shape[0]) * b["tile_n"]
        require(tuple(b["codes_t"].shape)[0] == CAPACITY_CODE_BYTES_PER_SLOT,
                f"{tag}: K11 reads [96, slots] codes ({list(b['codes_t'].shape)})")
        ms = timed_ms(lambda: m.pq_search_indexed(*a, **kw), warmup=1, iters=3, reps=3)
        bnd, by = pq_bound("search", b["lut"].shape[0], rows, b["codes_t"].shape[0],
                           b["lut"].shape[2], b["k"], word, props, clock)
        for m_ in mods:
            m_.LAUNCHES.update(before[m_])
        del calls[c], m, a, kw, b
        words[word] = {"index": tag, "launches": n, "held_rows": rows, "ms": ms,
                       "bound_ms": bnd, "bound_by": by, "hold_s": time.perf_counter() - t0}
        say("capacity-opq", f"{tag}: {n} K11 launches, {word} LUT; the last ({rows:,} rows, "
            f"top {held[c][0][1]} of {held[c][0][0]} queries) against plain: values and ids "
            f"equal; {ms:.4f} ms against a bound of {bnd:.4f} ms ({by}), "
            f"{100 * bnd / ms:.1f} % of it, on {smi}")

    torch.cuda.empty_cache()
    reset_all(*mods, threefry)
    bench_10m.Harness.serving_peak = hold_index
    bench_10m.train_opq = train_opq
    ProductQuantizer.from_transposed = classmethod(from_transposed)
    try:
        with recorded(pq_kernel, body=lut_word) as calls:
            rc, printed = captured(bench_10m.main, CAPACITY_OPQ_ARGV, keep)
    finally:
        bench_10m.Harness.serving_peak, bench_10m.train_opq = saved[:2]
        ProductQuantizer.from_transposed = saved[2]
    info = {"main_s": time.perf_counter() - t_path}
    launches = {k_: v for k_, v in counts(*mods).items() if v}
    info["launches"] = launches
    info["rowgen_launches"] = threefry.LAUNCHES["latent_rows"]
    info["k11"] = words
    say("capacity-opq", f"main() at 100,000,000 x 768, IVF-OPQ and IVF-OPQr, in "
        f"{info['main_s']:.1f} s, exit {rc}; launches {launches}, row kernel "
        f"{info['rowgen_launches']}; on {smi}")
    require(rc == 0, "bench_10m.main at the OPQ capacity flags exits 0")
    _, failed = leg_recalls(printed)
    require(not failed, f"no FAILED leg ({failed})")
    require(set(launches) == {"pq_search_indexed"}, f"path 11 launches K11 alone ({launches})")
    require(pq_kernel.ONEHOT_LAUNCHES["pq_search_indexed"] == 0,
            "every K11 launch on the LUT-gather ring body")
    require(set(words) == {"int8", "bf16x2"}
            and sum(w["launches"] for w in words.values()) == launches["pq_search_indexed"],
            f"K11 held on the last launch of each LUT word ({sorted(words)})")

    require(re.search(r"^kept build: ", printed, re.M), "path 11 takes path 10's build")
    geo = re.search(r"^IVF geometry: nlist=(\d+) S=(\d+)", printed, re.M)
    nlist, s = int(geo.group(1)), int(geo.group(2))
    nbk = int(re.search(r"\((\d+) buckets x (\d+)", printed).group(1))
    info.update(nlist=nlist, bucket_size=s, nbuckets=nbk)
    require((nlist, s) == CAPACITY_GEOMETRY and nbk == nbk10,
            f"path 10's geometry and buckets ({nlist}, {s}, {nbk})")
    npad_i = nbk * s + (-(nbk * s)) % 2048

    require(len(made) == 2 and all(
        m_ == ((CAPACITY_CODE_BYTES_PER_SLOT, npad_i), torch.uint8, True) for m_ in made),
        f"each index's codes [{CAPACITY_CODE_BYTES_PER_SLOT}, {npad_i:,}] u8, the appender's "
        f"buffer itself ({made})")
    info["resident_b"], info["serving_peak_b"] = {}, {}
    for tag in ("IVF-OPQ", "IVF-OPQr"):
        res = re.search(rf"^{tag} resident: (.*) \(([\d,]+) B on the device; codes (\d+) B a "
                        r"slot x ([\d,]+) slots\); bucket tables ([\d,]+) B on the host",
                        printed, re.M)
        parts = {k_.replace(" ", "_"): int(v.replace(",", "")) for k_, v in
                 re.findall(r"(?:^|, )([a-z ]+) ([\d,]+) B", res.group(1))}
        parts["host_bucket_tables"] = int(res.group(5).replace(",", ""))
        require(int(res.group(3)) == CAPACITY_CODE_BYTES_PER_SLOT
                and parts["codes"] == CAPACITY_CODE_BYTES_PER_SLOT * npad_i,
                f"{tag}: codes at 96 B a slot ({res.group(0)})")
        peak = int(re.search(rf"^{tag} serving peak: ([\d,]+) B", printed, re.M).group(1)
                   .replace(",", ""))
        info["resident_b"][tag], info["serving_peak_b"][tag] = parts, peak
        on_card = int(res.group(2).replace(",", ""))
        say("capacity-opq", f"{tag} resident: " + ", ".join(
            f"{k_} {v:,} B" for k_, v in parts.items()) + f" ({on_card / 1e9:.3f} GB on the "
            f"card); serving peak {peak:,} B allocated ({peak / 2**30:.3f} GiB, limit "
            f"{CAPACITY_PEAK_LIMIT_B / 2**30:.0f} GiB) on {smi}")
        require(peak <= CAPACITY_PEAK_LIMIT_B, f"{tag}: the serving peak within 16 GiB")

    info["build_s"] = {m_.group(1): int(m_.group(2)) for m_ in (
        re.match(r"(.*?):? (\d+)s\b", line) for line in printed.splitlines()
        if "recall@" not in line and not line.startswith(("IVF geometry", "["))) if m_}
    require(len(trains) == 2, f"two OPQ trainings ({trains})")
    info["opq_train_s"] = trains
    say("capacity-opq", "phases (s): " + ", ".join(
        f"{k_} {v}" for k_, v in info["build_s"].items()) + "; of these the OPQ trainings "
        f"{trains[0]:.1f} and {trains[1]:.1f} (the residual one on r_smp[:20,000]), the 100M "
        f"encodes the rest, on {smi}")

    legs = harness_legs(printed)
    want = (opq_leg_names("IVF-OPQ", bench_10m.ivf_opq_legs, nbk)
            + opq_leg_names("IVF-OPQr", bench_10m.ivf_opqr_legs, nbk))
    require([leg for leg, _ in legs] == want,
            f"the IVF-OPQ and IVF-OPQr legs of the JAX harness at 100M ({[x for x, _ in legs]})")
    times = [(float(m_.group(1)), float(m_.group(2)), float(m_.group(3))) for m_ in
             re.finditer(r"^\S.*?\s*:\s+(\d+) qps\s+\(\s*([0-9.]+) ms/batch\).*"
                         r"\[device ([0-9.]+) ms/batch\]", printed, re.M)]
    require(len(times) == len(legs), "a device time for every leg")
    info["legs"] = []
    pts = []  # (index, R or None, fraction, recall) in leg order
    for (leg, r), (qps, host_ms, dev_ms) in zip(legs, times):
        key = capacity_opq_leg(leg, nbk)
        pts.append((*key, r))
        tpu = CAPACITY_OPQ_TPU.get(key)
        info["legs"].append({"leg": leg, "recall_at_10": r, "qps": qps, "ms_batch": host_ms,
                             "device_ms_batch": dev_ms, "fraction": key[2],
                             "tpu": None if tpu is None else dict(zip(
                                 ("recall_at_10", "qps", "ms_batch"), tpu))})
        say("capacity-opq", f"{leg} ({100 * key[2]:.2f} % of the buckets): recall@10 {r:.3f}, "
            f"{qps:.0f} q/s, {host_ms:.2f} ms a batch, device {dev_ms:.3f} ms on {smi}"
            + (f"; TPU v5e (BASELINE.md) {tpu[0]:.3f}, {tpu[1]} q/s, {tpu[2]} ms"
               if tpu else "; no TPU figure"))
        if key in CAPACITY_OPQ_F32_MARGIN:
            margin = CAPACITY_OPQ_F32_MARGIN[key]
            require(r >= tpu[0] + margin,
                    f"{leg}: recall@10 {r:.3f} >= the TPU's {tpu[0]:.3f} + {margin} (F40: f32, "
                    f"not one bf16 pass)")
        elif tpu:
            require(abs(r - tpu[0]) <= CAPACITY_RECALL_SLACK,
                    f"{leg}: recall@10 {r:.3f} within {CAPACITY_RECALL_SLACK} of the TPU's "
                    f"{tpu[0]:.3f}")
    for tag, rr, frac, r in pts:
        if rr is None:
            continue
        coarse_r = [v for t2, r2, f2, v in pts if (t2, r2, f2) == (tag, None, frac)]
        require(len(coarse_r) == 1 and r >= coarse_r[0] - 0.01,
                f"{tag} R={rr} at {frac}: {r:.3f} >= coarse {coarse_r} - 0.01")
        deeper = [(r2, v) for t2, r2, f2, v in pts
                  if t2 == tag and f2 == frac and r2 and r2 > rr]
        require(all(v >= r - 0.01 for _, v in deeper),
                f"{tag}: recall not falling as R grows at {frac} ({r:.3f} at R={rr}, {deeper})")
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_path
    info["wall_s"] = wall
    say("capacity-opq", f"path 11 wall {wall:.1f} s (limit {CAPACITY_OPQ_WALL_LIMIT_S:.0f} s; "
        f"main {info['main_s']:.1f}) on {smi}")
    require(wall <= CAPACITY_OPQ_WALL_LIMIT_S, f"path 11 within {CAPACITY_OPQ_WALL_LIMIT_S:.0f} s")
    return info


def rehearse(which, n=30_000):
    """The CPU rehearsal at ``n`` rows, with the plain versions: path 3's
    recalls ("pq"), path 4's IVF-SQ -> f32 ("ivf") and path 5's residual
    IVF-BQ lift ("rbq"), the predictions the card's run is held to (not
    device numbers)."""
    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    if "10m" in which:
        from quantization_tpu_torch.bench import bench_10m

        # Recall only: each leg's search once (the plain versions take
        # seconds a call here), coarse legs without the pipelined loop,
        # whose results equal the blocking search's.
        def one_call(self, fn, iters=10):
            fn()
            return 1.0, None

        def one_search(self, name, index, eq, gt, iters=10, **knobs):
            self.report(name, lambda: index.top_k_device(eq, self.K, **knobs), gt)

        t0 = time.perf_counter()
        saved = bench_10m.Harness.timeit, bench_10m.Harness.report_serve
        bench_10m.Harness.timeit, bench_10m.Harness.report_serve = one_call, one_search
        try:
            rc, printed = captured(bench_10m.main,
                                   BENCH10M_REHEARSAL_ARGV + ["--device", "cpu"])
        finally:
            bench_10m.Harness.timeit, bench_10m.Harness.report_serve = saved
        rec, failed = leg_recalls(printed)
        say("rehearsal", f"CPU, the path-9 flags at 30,000 rows, exit {rc}, "
            f"{time.perf_counter() - t0:.0f} s (not a device number); {len(failed)} FAILED; "
            f"recall@{K}: {json.dumps(rec)}")
    if "ann" in which:
        t0 = time.perf_counter()
        rec = ann_recalls(cpu, ANN_REHEARSAL_COUNT)
        say("rehearsal", f"CPU, the path-6 methods at {ANN_REHEARSAL_COUNT} rows, "
            f"{time.perf_counter() - t0:.0f} s (not a device number); recall@10: "
            + ", ".join(f"{k}: {v:.4f}" for k, v in rec.items()))
    if "pq" in which:
        t0 = time.perf_counter()
        rec, _ = pq_recalls(cpu, n, PD, SEED + 3)
        say("rehearsal", f"CPU, {n} x {PD} neighbourhood corpus, "
            f"{time.perf_counter() - t0:.0f} s (not a device number); recall@{K} vs the f32 "
            "oracle: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    if "rbq" in which:
        t0 = time.perf_counter()
        rec = rbq_recalls(cpu, n, PD, SEED + 5)
        say("rehearsal", f"CPU, {n} x {PD} residual-regime corpus, IVF-BQ with "
            f"{rec['nbuckets']} buckets, every bucket scanned exactly, "
            f"{time.perf_counter() - t0:.0f} s (not a device number); recall@{K}: plain "
            f"{rec['plain']:.4f}, residual {rec['residual']:.4f}, lift "
            f"{rec['residual'] - rec['plain']:.4f}")
    if "ivf" in which:
        t0 = time.perf_counter()
        rec = ivf_sq_recalls(cpu, n, PD, SEED + 3)
        say("rehearsal", f"CPU, {n} x {PD} neighbourhood corpus, IVF-SQ with "
            f"{rec['nbuckets']} buckets, nprobe {rec['nprobe']}, nscan {rec['nscan']}, "
            f"{time.perf_counter() - t0:.0f} s (not a device number); recall@{K}: IVF-SQ "
            f"{rec['ivf_sq']:.4f}, IVF-SQ -> f32 {rec['ivf_sq_f32']:.4f}")
    return 0


def sass_functions(build):
    """{mangled entry function name: its SASS} of the built library, read
    with cuobjdump."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path()], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {part.split("\n", 1)[0].strip(): part for part in sass.split("Function : ")[1:]}


# bq_sign_approx_ws_kernel's instantiations: both query tiles at every depth
# it is built for (bq_kernels.cu sign_ws_depth, 256-bit steps a row).
SIGN_WS_ENTRIES = {f"bq_sign_approx_ws_kernel<TQ {tq}, n {n}>"
                   for tq in (64, 128) for n in (1, 2, 3, 4, 6, 8)}
# The 4-bit int8 one-hot kernels with A in registers (pq4_mma_kernels.cu):
# the score matrix's and the approx kernel in both geometries (queries a
# block, m64 blocks a warpgroup) and the exact queue kernel.
ONEHOT_ENTRIES = {"pq4_scores_ws_kernel<128, 2>", "pq4_scores_ws_kernel<64, 4>",
                  "pq4_approx_ws_kernel<128, 2>", "pq4_approx_ws_kernel<64, 4>",
                  "pq4_queue_kernel"}


def tensor_core_bodies(funcs):
    """The wgmma instructions (SASS *GMMA) in each entry function of the
    shared scan body (the scores_kernel, approx_ws_kernel, approx_parts_kernel,
    search_queue_kernel and search_exact_kernel
    instantiations: K3, the SQ
    and BQ searches on both exact selects, and 4-bit int8-LUT PQ's radix K7b
    on NibbleRows), in the one-hot kernels with A in registers
    (pq4_scores_ws_kernel for K8, pq4_approx_ws_kernel for K7a / K11,
    pq4_queue_kernel for K7b with the queue select), in the bf16 one-hot K8
    (pq4_bf16_scores_kernel, bf16 HGMMA) and in the BQ sign-query kernels
    (K6's bq_sign_scores_kernel, K5c's bq_sign_queue_kernel and
    bq_sign_exact_kernel, K5a / K10's bq_sign_approx_ws_kernel at both query
    tiles and bq_sign_approx_kernel: single-bit BGMMA); every one must have
    some."""
    import re

    found = {}
    for name, part in funcs.items():
        m = re.search(r"\d(scores_kernel|approx_parts_kernel|approx_ws_kernel|"
                      r"search_exact_kernel|search_queue_kernel)INS_\d+"
                      r"(CodeRows|PlaneRows|NibbleRows)", name)
        if m:
            key = f"{m.group(1)}<{m.group(2)}>"
            found[key] = found.get(key, 0) + part.count("GMMA")
        elif re.search(r"\dpq4_bf16_scores_kernel", name):
            found["pq4_bf16_scores_kernel"] = part.count("HGMMA")
        elif m := re.search(r"\dpq4_approx_ws_kernelILb0ELi(\d+)ELi(\d+)E", name):
            found[f"pq4_approx_ws_kernel<{m.group(1)}, {m.group(2)}>"] = part.count("GMMA")
        elif m := re.search(r"\dpq4_scores_ws_kernelILi0ELi(\d+)ELi(\d+)E", name):
            found[f"pq4_scores_ws_kernel<{m.group(1)}, {m.group(2)}>"] = part.count("GMMA")
        elif re.search(r"\dpq4_queue_kernelILb0E", name):
            found["pq4_queue_kernel"] = part.count("GMMA")
        elif m := re.search(r"\dbq_sign_approx_ws_kernelILb0ELi(\d+)ELi(\d+)E", name):
            found[f"bq_sign_approx_ws_kernel<TQ {m.group(1)}, n {m.group(2)}>"] = \
                part.count("BGMMA")
        elif m := re.search(r"\d(bq_sign_exact_kernel|bq_sign_queue_kernel|"
                            r"bq_sign_approx_kernel|bq_sign_scores_kernel)", name):
            found[m.group(1)] = part.count("BGMMA")
    require(set(found) == {"scores_kernel<CodeRows>",
                           "approx_parts_kernel<CodeRows>", "approx_parts_kernel<PlaneRows>",
                           "approx_ws_kernel<CodeRows>",
                           "approx_ws_kernel<PlaneRows>", "search_exact_kernel<CodeRows>",
                           "search_exact_kernel<PlaneRows>", "search_exact_kernel<NibbleRows>",
                           "search_queue_kernel<CodeRows>", "search_queue_kernel<PlaneRows>",
                           *ONEHOT_ENTRIES,
                           "pq4_bf16_scores_kernel", "bq_sign_exact_kernel",
                           "bq_sign_queue_kernel", "bq_sign_approx_kernel",
                           "bq_sign_scores_kernel"} | SIGN_WS_ENTRIES,
            f"the tensor-core entry functions in the library ({sorted(found)})")
    require(all(n > 0 for n in found.values()), f"every scan body runs on wgmma ({found})")
    return found


def bf16_onehot_loop(funcs):
    """(instructions, HGMMA, FADD, MOV) of the bf16 one-hot K8's main loop,
    one group of 8 chunks (pq4_bf16_scores_kernel), read from the SASS: the
    shortest loop (a backward branch) holding 8 bf16 products. A thread
    sums 32 outputs a chunk, one add each: 256 FADD a group."""
    import re

    for name, part in funcs.items():
        if not re.search(r"\dpq4_bf16_scores_kernel", name):
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        best = None
        for addr, op in ins:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not b or int(b.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins if int(b.group(1), 16) <= a <= addr]
            if sum("HGMMA" in o for o in body) >= 8 and (best is None or len(body) < best[0]):
                best = (len(body), sum("HGMMA" in o for o in body),
                        sum(bool(re.match(r"(@!?U?P\w+\s+)?FADD\b", o)) for o in body),
                        sum(bool(re.match(r"(@!?U?P\w+\s+)?MOV\b", o)) for o in body))
        require(best is not None, "the bf16 one-hot K8's group loop in the SASS")
        return best
    require(False, "pq4_bf16_scores_kernel in the library")


def ring_bodies(funcs):
    """The bulk copies (SASS UBLKCP) and mbarrier operations (SYNCS) in each
    instantiation of the LUT-gather body's kernels, every one on the ring
    (pq_search_exact_kernel, pq_search_approx_kernel: K7b, K7a / K11, 2 code
    widths x 3 LUT words each; pq_scores_kernel: K8 at 8 bits, int8 and
    bf16 words): every one must have both."""
    found = {key: (part.count("UBLKCP"), part.count("SYNCS"))
             for key, part in ((gather_entry(name), part) for name, part in funcs.items())
             if key}
    require(len(found) == 14 and {"pq_scores_kernel<256, int8>", "pq_scores_kernel<256, bf16>"}
            <= set(found),
            f"the ring kernels' instantiations in the library ({sorted(found)})")
    require(all(a > 0 and b > 0 for a, b in found.values()),
            f"every ring kernel stages by bulk copies on mbarriers ({found})")
    return found


LUT_GATHER_ENTRY = (r"\d(pq_scores_kernel|pq_search_approx_kernel|pq_search_exact_kernel)"
                    r"ILi(\d+)ELi(\d)E")


def gather_entry(name):
    """'kernel<kc, word>' of a LUT-gather entry function's mangled name, or None."""
    import re

    m = re.search(LUT_GATHER_ENTRY, name)
    return m and f"{m.group(1)}<{m.group(2)}, {('int8', 'bf16', 'bf16x2')[int(m.group(3))]}>"


def lookup_loops(funcs):
    """{kernel<kc, word>: (instructions, LUT loads, lookups)} of the LUT-gather
    body's lookup loop in every entry function that runs it (K8's
    pq_scores_kernel, K7b's pq_search_exact_kernel, K7a / K11's
    pq_search_approx_kernel; 8- and 4-bit codes), read from the SASS: the
    shortest loop (a backward branch) holding at least 64 lookups' 8-byte
    LUT loads (LDS.64) and as many code bytes (LDS.U8), one chunk of a
    thread's rows (a group of 8 chunks at 4 bits). Lookups a load come from
    the layout (LOOKUPS_PER_LOAD). With 8-bit codes that is the loop over a
    ring stage's chunks, whose instructions a lookup must stay within
    LOOP_SASS_MAX; a 4-bit stage holds one group, so there the loop is the
    stage's, its wait, release and bf16x2 lo fold included."""
    import re

    out = {}
    for name, part in funcs.items():
        key = gather_entry(name)
        if not key:
            continue
        per = LOOKUPS_PER_LOAD[key.split(", ")[1][:-1]]
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        best = None
        for addr, op in ins:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not b or int(b.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins if int(b.group(1), 16) <= a <= addr]
            lds = sum(1 for o in body if re.match(r"(@!?U?P\w+\s+)?LDS\.64\b", o))
            codes = sum(1 for o in body if re.match(r"(@!?U?P\w+\s+)?LDS\.U8\b", o))
            if lds * per >= 64 and codes >= lds and (best is None or len(body) < best[0]):
                best = (len(body), lds, lds * per)
        out[key] = best
    require(len(out) == 14 and all(out.values()), f"the lookup loops in the SASS ({out})")
    for key, (n, _, look) in out.items():
        word = key.split(", ")[1][:-1]
        if "<256," in key and word in LOOP_SASS_MAX:
            require(n / look <= LOOP_SASS_MAX[word],
                    f"{key}: {n / look:.2f} SASS instructions a lookup, at most "
                    f"{LOOP_SASS_MAX[word]}")
    return out


def ptxas_usage(log):
    """{kernel<kc, word>: (registers, stack bytes, spill stores, spill loads)}
    of the LUT-gather entry functions, from the build's ptxas -v lines."""
    import re

    out, cur, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, frame = gather_entry(m.group(1)), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *frame)
            cur = None
    return out


def approx_usage(log):
    """[(instantiation, registers, stack, spill stores, spill loads)] of the
    approx bodies' entry functions (approx_ws_kernel, approx_parts_kernel,
    the sign-query bq_sign_approx_ws_kernel and bq_sign_approx_kernel, the
    one-hot pq4_approx_ws_kernel) and of the one-hot K8's
    pq4_scores_ws_kernel and K7b's pq4_queue_kernel,
    from the build's ptxas -v lines. The int8 and sign-query warp-specialized
    bodies' count is the launch's (168 a thread at 384 threads); at 128
    queries their consumers run on 224 and their producer on 56
    (setmaxnreg); pq4_approx_ws_kernel's 288 threads allow 224 a thread."""
    import re

    out, cur, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = re.search(r"approx_parts_kernelINS_\d+(\w+?)ELb(\d)E", m.group(1))
            x = re.search(r"approx_ws_kernelINS_\d+(\w+?)ELb(\d)ELb(\d)ELi(\d+)E", m.group(1))
            y = re.search(r"bq_sign_approx_ws_kernelILb0ELi(\d+)ELi(\d+)E", m.group(1))
            z = re.search(r"\dpq4_(approx|scores)_ws_kernelIL[ib]0ELi(\d+)ELi(\d+)E",
                          m.group(1))
            cur = (w and f"approx_parts_kernel<{w.group(1)}, kOnce {w.group(2)}>") or \
                  (x and f"approx_ws_kernel<{x.group(1)}, kOnce {x.group(2)}, TQ {x.group(4)}>") or \
                  (y and f"bq_sign_approx_ws_kernel<TQ {y.group(1)}, n {y.group(2)}>") or \
                  ("bq_sign_approx_kernel" if "bq_sign_approx_kernel" in m.group(1) else None) or \
                  (z and f"pq4_{z.group(1)}_ws_kernel<{z.group(2)}, {z.group(3)}>") or \
                  ("pq4_queue_kernel" if re.search(r"\dpq4_queue_kernelILb0E", m.group(1))
                   else None)
            frame = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((cur, int(m.group(1)), *frame))
            cur = None
    return out


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def main():
    t_start = time.perf_counter()
    if "--rehearse" in sys.argv[1:]:
        which = sys.argv[sys.argv.index("--rehearse") + 1:] or ["pq", "ivf", "rbq"]
        return rehearse(which)
    do_profile = "--profile" in sys.argv[1:]
    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", f"{name} capability {cap[0]}.{cap[1]}; nvidia-smi: {smi}; "
        f"max SM clock {max_sm_clock_hz() / 1e6:.0f} MHz; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    require(cap[0] == 9, "compute capability 9.x (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False

    from quantization_tpu_torch.ops.kernels import build

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    start_select_probe(build.find_nvcc())
    build.load_library()
    info = build.BUILD_INFO or {"seconds": 0.0, "log": "(already built)"}
    say("build", f"ok in {time.perf_counter() - t0:.1f} s (nvcc, one process per source: "
        f"{info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            say("build", "ptxas " + line.strip())
    funcs = sass_functions(build)
    gmma = tensor_core_bodies(funcs)
    say("build", "wgmma instructions (SASS GMMA) in " + ", ".join(
        f"{k} {v}" for k, v in sorted(gmma.items())))
    ring = ring_bodies(funcs)
    say("build", "bulk copies and mbarrier operations (SASS UBLKCP, SYNCS) in " + ", ".join(
        f"{k} {a} / {b}" for k, (a, b) in sorted(ring.items())))
    loops = lookup_loops(funcs)
    LOOP_SASS.update({k: n / look for k, (n, _, look) in loops.items()})
    say("build", "the LUT-gather lookup loop (SASS instructions, 8-byte LUT loads, lookups a "
        "pass): " + ", ".join(f"{k} {n}, {lds}, {look} ({n / look:.2f} a lookup)"
                              for k, (n, lds, look) in sorted(loops.items())))
    usage = ptxas_usage(info["log"])
    say("build", "the LUT-gather entries (ptxas: registers, stack, spill stores / loads in "
        "bytes): " + (", ".join(f"{k} {r}, {st}, {a} / {b}"
                                for k, (r, st, a, b) in sorted(usage.items()))
                      or "no ptxas log: the library was already built"))
    approx = approx_usage(info["log"])
    say("build", "the approx bodies, the one-hot K8 and K7b (ptxas: registers, stack, spill "
        "stores / loads in bytes): " + (
            ", ".join(f"{k} {r}, {st}, {a} / {b}" for k, r, st, a, b in approx)
            or "no ptxas log: the library was already built"))
    if approx:
        sign = {k for k, *_ in approx if k.startswith("bq_sign_approx")}
        require(sign == SIGN_WS_ENTRIES | {"bq_sign_approx_kernel"},
                f"the sign-query approx bodies' ptxas lines ({sorted(sign)})")
        onehot = {k for k, *_ in approx if k.startswith("pq4_")}
        require(onehot == ONEHOT_ENTRIES, f"the one-hot kernels' ptxas lines ({sorted(onehot)})")
    n, hg, fadd, mov = bf16_onehot_loop(funcs)
    say("build", f"the bf16 one-hot K8's group loop (SASS; 8 chunks x 32 outputs a thread): "
        f"{n} instructions, {hg} HGMMA, {fadd} FADD, {mov} MOV ({n / 256:.2f} an output "
        "and chunk)")

    asplit = approx_split(smi)

    # ------------------------------------------------------- 3. the paths
    sq_recs, sq_info = sq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    bq_recs, bq_info = bq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    neigh = bq_neighbour_path(dev, smi)
    torch.cuda.empty_cache()
    pq_recs, pq_info, pq_keep = pq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    ivf_recs, ivf_info, ivf_keep = ivf_path(dev, smi, do_profile, pq_info["opq_f32_batch_ms"])
    torch.cuda.empty_cache()
    rbq_recs, rbq_info, rbq_keep = rbq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    harness_info = harness_path(dev, smi)
    torch.cuda.empty_cache()
    sharded_info = sharded_path(dev, smi, pq_keep)
    del pq_keep
    torch.cuda.empty_cache()
    sharded_ivf_info = sharded_ivf_path(dev, smi, ivf_keep, rbq_keep)
    del ivf_keep, rbq_keep
    torch.cuda.empty_cache()
    bench10m_info = bench10m_path(dev, smi)
    torch.cuda.empty_cache()
    keep = {}  # path 10's build on the host, for path 11
    capacity_info = capacity_path(dev, smi, keep)
    torch.cuda.empty_cache()
    capacity_opq_info = capacity_opq_path(dev, smi, keep, capacity_info["nbuckets"])
    del keep

    kernels = []
    for r in sq_recs + bq_recs + pq_recs + ivf_recs + rbq_recs:
        src, replaces = KERNELS[r["name"]]
        bound_ms, bound_by = r.pop("bound")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SRC + src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
            **({"select": r["ms"].select} if getattr(r["ms"], "select", None) else {}),
        })
    for kr in kernels:
        say("bound", f"{kr['name']}: {kr['ms']:.4f} ms against a bound of "
            f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), "
            f"{100 * kr['bound_ms'] / kr['ms']:.1f} % of it, on {smi}")
    say("wall", f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "kernels": kernels,
        "sq_small_batch_ms": {"q": Q_SMALL, **sq_info["small_batch_ms"]},
        "f32_baseline_ms": {"sq_100k_x_1024": sq_info["f32_ms"],
                            "bq_1m_x_1536": bq_info["f32_ms"]},
        "recall_at_10": {"sq_exact": sq_info["recall_exact"],
                         "sq_approx": sq_info["recall_approx"], **bq_info["recall"]},
        "two_stage_batch_ms": bq_info["batch_ms"],
        "bq_scores_pm1_expand_ms": bq_info["bq_scores_pm1_expand_ms"],
        "bq_score_batch_ms": bq_info["score_batch_ms"],
        "k4_wrapper_ms": bq_info["k4_wrapper_ms"],
        "ties_at_r": bq_info["ties_at_r"],
        "neighbourhoods": neigh,
        "pq": pq_info,
        "ivf": ivf_info,
        "residual_bq_l1_serving": rbq_info,
        "harness": harness_info,
        "sharded": sharded_info,
        "sharded_ivf": sharded_ivf_info,
        "bench_10m": bench10m_info,
        "capacity_100m": capacity_info,
        "capacity_opq_100m": capacity_opq_info,
        "approx_split": {f"{k}/{d}/{p}": {x: v[x] for x in ("pass1_ms", "scan_ms", "combine_ms")}
                         for (k, d, p), v in asplit.items()},
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
