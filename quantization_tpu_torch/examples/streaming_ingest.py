"""Streaming single-pass ingestion at a scale beyond host memory.

Twin of ``examples/streaming_ingest.py``. Builds SQ, BQ and PQ indexes over
an N x D corpus that never exists in host memory whole (batches are
generated, uploaded once, encoded on the card into preallocated buffers,
``utils.device_store.DeviceAppender``, and discarded), then serves top-k
from all three plus a two-stage BQ -> SQ pipeline, reporting the time per
batch and recall against the exact f32 ground truth, which is computed
incrementally on the same uploaded batches, so the f32 data crosses to the
card once.

This answers the reference's streaming encode from a re-cloneable iterator
(encoded_vectors_u8.rs:35, SURVEY.md §7 hard part 5), scaled to corpora
where neither the f32 data (30 GB at 10M x 768) nor the [Q, N] score matrix
fit anywhere: scoring uses the fused search kernels.

    python -m quantization_tpu_torch.examples.streaming_ingest --n 10000000 --d 768
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=1024)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import quantization_tpu_torch as qt
    from quantization_tpu_torch.models.bq import BQMetadata
    from quantization_tpu_torch.models.pq import PQMetadata
    from quantization_tpu_torch.models.sq import SQMetadata
    from quantization_tpu_torch.ops import pq as pq_ops
    from quantization_tpu_torch.ops import sq as sq_ops
    from quantization_tpu_torch.ops.dispatch import resolve_device, upload
    from quantization_tpu_torch.ops.kernels import bq_kernel, sq_kernel
    from quantization_tpu_torch.ops.kmeans import kmeans_batched
    from quantization_tpu_torch.utils.device_store import DeviceAppender
    from quantization_tpu_torch.utils.profiling import timed

    dev = resolve_device(args.device)
    N, D, B, Q, K = args.n, args.d, args.batch, args.queries, args.k
    if D % args.chunk_size:
        raise SystemExit("the demo wants D divisible by the chunk size")
    m = D // args.chunk_size
    nb = -(-N // B)

    # --- seeded clustered generator: batch i is reproducible in isolation ---
    centers = np.random.default_rng(7).random((args.clusters, D), np.float32) * 2 - 1

    # Preallocated buffers, filled in place (fresh pages fault slowly on
    # lazily backed hosts); a copy to the card from pageable memory ends
    # before the next batch overwrites them.
    gen_buf = np.empty((B, D), np.float32)
    noise_buf = np.empty((B, D), np.float32)

    def gen(i: int) -> np.ndarray:
        # Symmetric per-point noise at a scale comparable to the centers:
        # sign bits then vary within a cluster, so BQ / PQ recall reflects
        # within-cluster ranking, not just cluster identification.
        rng = np.random.default_rng(1000 + i)
        rows = min(B, N - i * B)
        assign = rng.integers(0, args.clusters, rows)
        out = gen_buf[:rows]
        noise = noise_buf[:rows]
        rng.standard_normal(dtype=np.float32, out=noise)
        np.take(centers, assign, axis=0, out=out)
        noise *= 0.5
        out += noise
        return out

    queries = (
        centers[np.random.default_rng(2).integers(0, args.clusters, Q)]
        + np.random.default_rng(3).standard_normal((Q, D), np.float32) * 0.5
    ).astype(np.float32)

    # --- pass 0 (host only): SQ min/max calibration + PQ training sample ---
    t0 = time.perf_counter()
    mn, mx = np.inf, -np.inf
    stride = max(1, N // 10_000)
    sample = []
    for i in range(nb):
        b = gen(i)
        mn = min(mn, float(b.min()))
        mx = max(mx, float(b.max()))
        sample.append(b[::stride].copy())  # b is a reused buffer
    sample = np.concatenate(sample)[:10_000]
    print(f"pass0 (calibration scan, host): {time.perf_counter() - t0:.0f}s")

    # --- PQ training on the sample (batched k-means on the card) ---
    t0 = time.perf_counter()
    division = pq_ops.get_vector_division(D, args.chunk_size)
    cent_chunks = kmeans_batched(
        torch.from_numpy(pq_ops.chunk_tensor(sample, division)).to(dev), pq_ops.CENTROIDS_COUNT
    )
    centroids = pq_ops.chunks_to_centroids(cent_chunks.cpu().numpy(), division, D)
    print(f"PQ k-means ({m} chunks x 256): {time.perf_counter() - t0:.0f}s")

    # --- pass 1 (the single upload pass): encode SQ + BQ + PQ, running exact GT ---
    params_dot = qt.VectorParameters(D, N, qt.DistanceType.DOT, False)
    alpha, offset = sq_ops.alpha_offset_from_min_max(mn, mx)
    actual = sq_ops.actual_dim(D)
    lane = sq_ops.lane_dim(D)
    w = -(-D // 32)
    w8 = w + (-w) % bq_kernel.W_ALIGN
    dp = w8 * 32

    sq_codes = DeviceAppender((N + (-N) % sq_kernel.TILE_N, lane), torch.int8, dev)
    sq_voff = DeviceAppender((N + (-N) % sq_kernel.TILE_N,), torch.float32, dev)
    bq_rows = DeviceAppender((N + (-N) % bq_kernel.TILE_N, w8), torch.int32, dev)
    pq_codes = DeviceAppender((N, m), torch.uint8, dev)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)

    def pack_bits_dev(x):
        """f32 [B, D] -> int32 [B, w8] holding the LSB-first uint32 words of
        the sign bits (v > 0), the BQ plane layout transposed."""
        bits = torch.nn.functional.pad((x > 0).to(torch.int64), (0, dp - D))
        words = (bits.reshape(-1, w8, 32) << shifts).sum(dim=2)
        return (words - ((words >> 31) << 32)).to(torch.int32)

    cents_dev = torch.from_numpy(pq_ops.centroids_to_chunks(centroids, division)).to(dev)
    queries_dev = upload(queries, dev)
    best_s = torch.full((Q, K), -np.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, K), -1, dtype=torch.int64, device=dev)

    t0 = time.perf_counter()
    for i in range(nb):
        xb = torch.from_numpy(gen(i)).to(dev)  # the one upload
        codes, voff = sq_ops.quantize_batch(
            xb, alpha=alpha, offset=offset, distance_type=qt.DistanceType.DOT, invert=False,
            dpad=actual, lane=lane,
        )
        sq_codes.append(codes)
        sq_voff.append(voff)
        bq_rows.append(pack_bits_dev(xb))
        pq_codes.append(pq_ops.encode_batch(pq_ops.chunk_rows_device(xb, division), cents_dev))
        # the exact f32 oracle on the batch already on the card
        s = qt.pairwise_score(queries_dev, xb, qt.DistanceType.DOT, False)
        ids = torch.arange(i * B, i * B + xb.shape[0], device=dev).expand(Q, -1)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), K, dim=1)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)
        if i % 16 == 0:
            print(f"  batch {i + 1}/{nb}", end="\r", flush=True)
    gt = best_i.cpu().numpy()  # waits for the card
    dt = time.perf_counter() - t0
    print(f"pass1 (upload+encode x3+GT): {dt:.0f}s  "
          f"({N / dt:.0f} vec/s, {N * D * 4 / dt / 2**30:.2f} GiB/s up)")

    # --- assemble the quantizers from the device buffers ---
    mult = sq_ops.multiplier_for(qt.DistanceType.DOT, False, alpha)
    sq = qt.ScalarQuantizerU8(
        sq_codes.finish(), sq_voff.finish(), SQMetadata(actual, alpha, offset, mult, params_dot)
    )
    bq = qt.BinaryQuantizer(bq_rows.finish().T, BQMetadata(params_dot))
    pq = qt.ProductQuantizer(pq_codes.finish(), PQMetadata(centroids, division, params_dot))

    eq_sq = sq.encode_query(queries)
    eq_bq = bq.encode_query(queries)
    eq_pq = pq.encode_query(queries)
    two = qt.TwoStageIndex(bq, sq, oversampling=8.0)

    for name, fn in [
        ("SQ fused full-scan", lambda: sq.top_k_device(eq_sq, K)),
        ("SQ fused approx", lambda: sq.top_k_device(eq_sq, K, method="approx")),
        ("BQ fused full-scan", lambda: bq.top_k_device(eq_bq, K)),
        ("BQ fused approx", lambda: bq.top_k_device(eq_bq, K, method="approx")),
        ("PQ full-scan", lambda: pq.top_k_device(eq_pq, K)),
        ("two-stage BQ->SQ", lambda: two.top_k_device((eq_bq, eq_sq), K)),
    ]:
        t = timed(fn, iters=20)
        _, ids = fn()
        print(f"{name:22s}: {Q / t:10.0f} qps  ({t * 1e3:6.2f} ms/batch)  "
              f"recall@{K} vs exact = {qt.recall_at_k(ids, gt):.3f}")


if __name__ == "__main__":
    main()
