"""Two-stage serving demo: quantized coarse search + original-vector rescore.

Twin of ``examples/serving_two_stage.py``. The qdrant serving pattern (the
reason quantization exists there: shrink the resident index, then buy
recall back by rescoring a few dozen survivors with the original f32
vectors), built from public parts over a 100k x 768 corpus:

    ScalarQuantizerU8.encode(...)            # 8-bit resident codes
    ExactRescorer(data, ...)                 # f32 rescoring stage
    TwoStageIndex(coarse, fine, oversampling=4)
    index.top_k(index.encode_query(q), 10)

It reports recall@10 against the exact f32 scan and the steady-state time
per batch (back-to-back searches between CUDA events on the card).

    python -m quantization_tpu_torch.examples.serving_two_stage [--n 500000] [--device cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--oversampling", type=float, default=4.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from quantization_tpu_torch import (
        DistanceType,
        ExactRescorer,
        ScalarQuantizerU8,
        TwoStageIndex,
        VectorParameters,
        exact_topk,
        recall_at_k,
    )
    from quantization_tpu_torch.ops.dispatch import resolve_device
    from quantization_tpu_torch.utils.profiling import timed

    dev = resolve_device(args.device)
    n, d, q, k = args.n, args.d, args.queries, args.k
    rng = np.random.default_rng(7)
    data = rng.standard_normal((n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    params = VectorParameters(d, n, DistanceType.DOT, False)
    t0 = time.perf_counter()
    coarse = ScalarQuantizerU8.encode(data, params, device=dev)
    fine = ExactRescorer(data, DistanceType.DOT, invert=False, device=dev)
    index = TwoStageIndex(coarse, fine, oversampling=args.oversampling, coarse_method="approx")
    build_s = time.perf_counter() - t0
    print(f"encode: {build_s:.1f}s ({n / build_s:,.0f} vec/s)")

    eq = index.encode_query(queries)
    _, ids = index.top_k_device(eq, k)
    _, gt = exact_topk(queries, data, DistanceType.DOT, False, k, device=dev)
    recall = recall_at_k(ids, gt)
    print(f"recall@{k} vs exact f32: {recall:.3f} "
          f"(coarse oversampling {args.oversampling:g} -> R={int(args.oversampling * k)})")

    t = timed(index.top_k_device, eq, k, iters=20, warmup=2)
    print(f"serve: {t * 1e3:.2f} ms/batch ({q / t:,.0f} qps, Q={q}, N={n:,})")
    if recall < 0.9:
        raise RuntimeError(f"two-stage recall {recall:.3f} < 0.9")
    print("OK")


if __name__ == "__main__":
    main()
