"""IVF serving demo: probe-limited coarse search + original-vector rescore.

Twin of ``examples/ivf_serving.py``. Built from public parts, on a
clustered corpus so probing has structure to find (IVF on uniform noise
degenerates to a full scan):

    IVFIndex.encode(data, params, quantizer="sq", nlist=..., bucket_size=...)
    TwoStageIndex(ivf, ExactRescorer(data, ...), oversampling=8)
    index.top_k(index.encode_query(q), 10)

Geometry rules that make probing pay (the JAX package's measurements):
``bucket_size`` well under the average cluster size (several buckets per
cluster; a bucket bigger than its cluster is mostly padding), and
``nscan`` covering (distinct clusters in the batch) x (buckets per
cluster), since a query's neighbours spread over its whole cluster; the
scan fraction, IVF's whole advantage, comes from the corpus having many
more clusters than the batch touches.

    python -m quantization_tpu_torch.examples.ivf_serving [--n 200000] [--nscan 160]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--nlist", type=int, default=256)
    ap.add_argument("--bucket-size", type=int, default=512)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--nscan", type=int, default=160)
    ap.add_argument("--oversampling", type=float, default=8.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from quantization_tpu_torch import (
        DistanceType,
        ExactRescorer,
        IVFIndex,
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
    centers = rng.standard_normal((args.clusters, d)).astype(np.float32)
    assign = rng.integers(0, args.clusters, n)
    data = centers[assign] + 0.25 * rng.standard_normal((n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    qi = rng.integers(0, n, q)
    queries = data[qi] + 0.05 * rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    params = VectorParameters(d, n, DistanceType.DOT, False)
    t0 = time.perf_counter()
    ivf = IVFIndex.encode(
        data, params, quantizer="sq", nlist=args.nlist, bucket_size=args.bucket_size,
        nprobe=args.nprobe, nscan=args.nscan, device=dev,
    )
    fine = ExactRescorer(data, DistanceType.DOT, invert=False, device=dev)
    index = TwoStageIndex(ivf, fine, oversampling=args.oversampling, coarse_method="approx")
    print(f"build: {time.perf_counter() - t0:.1f}s "
          f"({ivf.metadata.nbuckets} buckets x {args.bucket_size})")

    eq = index.encode_query(queries)
    _, ids = index.top_k_device(eq, k)
    _, gt = exact_topk(queries, data, DistanceType.DOT, False, k, device=dev)
    recall = recall_at_k(ids, gt)
    scanned = min(args.nscan, ivf.metadata.nbuckets) * args.bucket_size
    print(f"recall@{k} vs exact f32: {recall:.3f} "
          f"(scanned <= {scanned:,} of {n:,} rows/batch)")

    t = timed(index.top_k_device, eq, k, iters=20, warmup=2)
    print(f"serve: {t * 1e3:.2f} ms/batch ({q / t:,.0f} qps, Q={q}, N={n:,})")
    if recall < 0.85:
        raise RuntimeError(f"probed two-stage recall {recall:.3f} < 0.85")
    print("OK")


if __name__ == "__main__":
    main()
