"""Criterion-equivalent microbenchmarks.

Twin of ``quantization_tpu/bench/micro.py``: the reference's three
criterion bench configurations (demos/benches/{encode,pq,binary}.rs: 100k x
1024, SQ DOT and L1, PQ with chunk_size=2, BQ on both word tiers) as
steady-state device time per query batch (``top_k_device``, top-k), each
against the unquantized f32 baseline: a full-f32 matmul (TF32 off) and
``torch.topk``, the stand-in for the reference's AVX f32 kernels
(demos/src/metrics/). Every time comes from ``utils.profiling.timed``:
between CUDA events on the card.

The reference also distinguishes linear from random access order, a CPU
cache effect with no counterpart here (batch scoring reads the whole code
matrix either way), so each configuration is one number.

    python -m quantization_tpu_torch.bench.micro [--n N] [--d D] [--q Q] [--device cpu]

Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import quantization_tpu_torch as qt
    from ..ops.dispatch import resolve_device, upload
    from ..utils.profiling import timed

    dev = resolve_device(args.device)
    N, D, Q, K = args.n, args.d, args.q, args.k
    rng = np.random.default_rng(42)
    data = rng.random((N, D), np.float32) * 2 - 1
    queries = rng.random((Q, D), np.float32) * 2 - 1

    data_dev = torch.from_numpy(data).to(dev)
    queries_dev = upload(queries, dev)

    def f32_search():
        return torch.topk(qt.pairwise_score(queries_dev, data_dev, qt.DistanceType.DOT, False),
                          K, dim=1)

    t_f32 = timed(f32_search, iters=20, warmup=3)
    rows = []

    def emit(name, t, extra=None):
        row = {"bench": name, "qps": Q / t, "ms_per_batch": t * 1e3, "vs_f32": t_f32 / t,
               "n": N, "d": D, "q": Q}
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)
        rows.append(row)

    def encode(fn):
        t0 = time.perf_counter()
        enc = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return enc, time.perf_counter() - t0

    emit("f32_dot", t_f32)

    # --- SQ u8, dot & L1 (demos/benches/encode.rs) ---
    for dt, name in [(qt.DistanceType.DOT, "sq_u8_dot"), (qt.DistanceType.L1, "sq_u8_l1")]:
        params = qt.VectorParameters(D, N, dt, False)
        enc, enc_s = encode(lambda: qt.ScalarQuantizerU8.encode(data, params, device=dev))
        eq = enc.encode_query(queries)
        t = timed(enc.top_k_device, eq, K, iters=20, warmup=3)
        emit(name, t, {"encode_s": enc_s})

    # --- PQ chunk_size=2 (demos/benches/pq.rs) ---
    params = qt.VectorParameters(D, N, qt.DistanceType.DOT, False)
    pq, enc_s = encode(lambda: qt.ProductQuantizer.encode(data, params, chunk_size=2, device=dev))
    eqp = pq.encode_query(queries)
    t = timed(pq.top_k_device, eqp, K, iters=5, warmup=2)
    emit("pq_chunk2", t, {"encode_s": enc_s, "chunks": pq.num_chunks})

    # --- BQ, both word tiers (demos/benches/binary.rs; the tiers differ only
    # in the on-disk row size, the device scores the same bit planes) ---
    for tier in ("u8", "u128"):
        bq, enc_s = encode(lambda: qt.BinaryQuantizer.encode(data, params, store_type=tier,
                                                             device=dev))
        eqb = bq.encode_query(queries)
        t = timed(bq.top_k_device, eqb, K, iters=20, warmup=3)
        emit(f"bq_{tier}", t, {"encode_s": enc_s})
    return rows


if __name__ == "__main__":
    main()
