"""ANN benchmark CLI of the PyTorch port (demos/src/ann_benchmark.rs).

Twin of ``quantization_tpu/bench/ann_benchmark.py``, with its flags
(mirroring the reference's clap interface, ann_benchmark.rs:20-44) and one
more, ``--device``:
  --dataset SUBSTR   filter the 11-dataset registry
  --method  u8|pq|bq|bq-u8|bq-exact|u8-f32|ivf-*  quantizer (+ optional
            rescoring stage; u8-f32 = SQ-approx coarse -> original-vector
            rescore)
  --quantile F       SQ quantile calibration
  --chunk-size N     PQ chunk size
  --pq-bits 4|8      PQ code width
  --opq              learn an OPQ rotation before PQ chunking
  --nlist/--nprobe/--bucket-size/--nscan/--residual  IVF geometry for the
                     ivf-* methods (ivf-sq | ivf-pq | ivf-bq, -f32 for an
                     original-vector rescore)
  --auto-config R    calibrate a serving plan to recall@10 R (policy.recommend)
  --test-acc         measure recall@10/20/30 + latency percentiles
  --bench            measure quantized scoring throughput
  --bench-f32        measure the unquantized f32 baseline (a full-f32
                     matmul + torch.topk, TF32 off: the yardstick, not a
                     kernel of the port)
  --query-batch N    queries per device call
  --device DEV       torch device (default: the CUDA card; without one the
                     CLI raises NoDeviceError unless --device cpu is given)

Datasets load from --data-dir when the ann-benchmarks HDF5 file exists there,
else from a seeded synthetic corpus of the same shape (the JAX package's
generator, byte for byte). ``--sharded`` waits for the sharded engines
(ROADMAP Queue 1, item 10) and raises.

    python -m quantization_tpu_torch.bench.ann_benchmark --dataset sift \\
        --method u8 --test-acc --synthetic-count 3000 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.distances import pairwise_score
from ..core.types import ArgumentsError, DistanceType, VectorParameters
from ..ops.dispatch import resolve_device, upload
from ..utils.profiling import timed
from .ann_data import DATASETS, AnnBenchmarkData, test_knn

METHODS = ["u8", "pq", "bq", "bq-u8", "bq-exact", "u8-f32", "ivf-sq", "ivf-pq", "ivf-bq",
           "ivf-sq-f32", "ivf-pq-f32", "ivf-bq-f32"]


def _refuse_sharded(args) -> None:
    if args.sharded:
        raise ArgumentsError(
            "--sharded is not ported yet: it waits for the sharded engines "
            "(ROADMAP Queue 1, item 10)")


def build_index(method: str, data: AnnBenchmarkData, args):
    """The index ``method`` names over ``data.train``, built on
    ``args.device``; prints its encode wall and vectors/s."""
    from ..models.bq import BinaryQuantizer
    from ..models.pipeline import ExactRescorer, TwoStageIndex
    from ..models.pq import ProductQuantizer
    from ..models.sq import ScalarQuantizerU8

    _refuse_sharded(args)
    dev = resolve_device(args.device)
    n, dim = data.train.shape
    invert = data.distance_type != DistanceType.DOT
    params = VectorParameters(dim, n, data.distance_type, invert)
    t0 = time.perf_counter()
    if method == "u8":
        index = ScalarQuantizerU8.encode(data.train, params, quantile=args.quantile, device=dev)
    elif method == "pq":
        index = ProductQuantizer.encode(
            data.train, params, chunk_size=args.chunk_size, bits=args.pq_bits,
            rotation="opq" if args.opq else None, device=dev,
        )
    elif method == "bq":
        index = BinaryQuantizer.encode(data.train, params, device=dev)
    elif method == "bq-u8":
        coarse = BinaryQuantizer.encode(data.train, params, device=dev)
        fine = ScalarQuantizerU8.encode(data.train, params, quantile=args.quantile, device=dev)
        index = TwoStageIndex(coarse, fine, oversampling=args.oversampling)
    elif method == "bq-exact":
        coarse = BinaryQuantizer.encode(data.train, params, device=dev)
        fine = ExactRescorer(data.train, data.distance_type, invert, device=dev)
        index = TwoStageIndex(coarse, fine, oversampling=args.oversampling)
    elif method.startswith("ivf-"):
        from ..models.ivf import IVFIndex

        kind = method.split("-")[1]  # ivf-<kind>[-f32]
        kw = {}
        if kind == "sq":
            kw["quantile"] = args.quantile
        elif kind == "pq":
            kw["chunk_size"] = args.chunk_size
            kw["bits"] = args.pq_bits
            if args.opq:
                kw["rotation"] = "opq"
        index = IVFIndex.encode(
            data.train, params, quantizer=kind, nlist=args.nlist,
            bucket_size=args.bucket_size, nprobe=args.nprobe, nscan=args.nscan,
            residual=args.residual, device=dev, **kw,
        )
        if method.endswith("-f32"):
            fine = ExactRescorer(data.train, data.distance_type, invert, device=dev)
            index = TwoStageIndex(index, fine, oversampling=args.oversampling,
                                  coarse_method="approx")
    elif method == "u8-f32":
        # SQ-approx coarse -> rescore the survivors with the original f32
        # vectors: the serving configuration with the highest recall.
        coarse = ScalarQuantizerU8.encode(data.train, params, quantile=args.quantile, device=dev)
        fine = ExactRescorer(data.train, data.distance_type, invert, device=dev)
        index = TwoStageIndex(coarse, fine, oversampling=args.oversampling,
                              coarse_method="approx")
    else:
        raise SystemExit(f"unknown method {method!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    encode_s = time.perf_counter() - t0
    print(f"[{data.name}] {method} encode: {encode_s:.4f}s "
          f"({n / max(encode_s, 1e-9):,.0f} vectors/s)", flush=True)
    return index


def bench_scoring(data: AnnBenchmarkData, index, args, label: str):
    """Quantized full-scan scoring throughput (reference --bench path,
    ann_benchmark.rs:245-261): ``score_batch`` per call, timed by
    ``utils.profiling.timed`` (CUDA events on the card). Indexes without a
    dense ``score_batch`` (two-stage pipelines, IVF) bench the search path
    through the port's ``PipelinedSearcher`` instead: ``depth`` searches in
    flight, each result copied to the host, the window closed by a sync."""
    q = data.test[: args.query_batch]
    eq = index.encode_query(q)
    iters = max(args.iters, 1)

    if not hasattr(index, "score_batch"):
        from ..serving import PipelinedSearcher

        s = PipelinedSearcher(index, k=10, depth=8)
        s.warmup(eq, encoded=True)
        for _ in range(8):
            s.submit(eq, encoded=True)
        s.sync()  # the pipe is full before the timed window
        t0 = time.perf_counter()
        for _ in range(iters):
            s.submit(eq, encoded=True)
        s.sync()
        dt = (time.perf_counter() - t0) / iters
        for _ in s.flush():
            pass
        label = f"{label} search-top10"
    else:
        dt = timed(index.score_batch, eq, iters=iters, warmup=2)
    n = data.train.shape[0]
    qps = q.shape[0] / dt
    pairs_ps = q.shape[0] * n / dt
    print(
        f"[{data.name}] {label} scoring: {qps:,.0f} q/s, "
        f"{pairs_ps / 1e9:.2f}G pairs/s (batch={q.shape[0]}, N={n})", flush=True
    )
    return qps


def bench_f32(data: AnnBenchmarkData, args):
    """Unquantized f32 baseline: the exact scores of a query batch (a
    full-f32 matmul, TF32 off; L1 / L2 through ``core.distances``) and their
    top-10 by ``torch.topk``, per call, timed like ``bench_scoring``."""
    dev = resolve_device(args.device)
    invert = data.distance_type != DistanceType.DOT
    train = torch.from_numpy(data.train).to(dev)
    q = upload(data.test[: args.query_batch], dev)

    def run():
        return torch.topk(pairwise_score(q, train, data.distance_type, invert),
                          min(10, train.shape[0]), dim=1)

    dt = timed(run, iters=max(args.iters, 1), warmup=2)
    qps = q.shape[0] / dt
    print(
        f"[{data.name}] f32 baseline scoring: {qps:,.0f} q/s "
        f"(batch={q.shape[0]}, N={data.train.shape[0]})", flush=True
    )
    return qps


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="", help="substring filter")
    p.add_argument("--method", default="u8", choices=METHODS)
    p.add_argument("--quantile", type=float, default=None)
    p.add_argument("--chunk-size", type=int, default=2)
    p.add_argument("--pq-bits", type=int, default=8, choices=[4, 8],
                   help="PQ code width: 8 = reference parity, 4 = Quick-ADC")
    p.add_argument("--opq", action="store_true",
                   help="learn an OPQ rotation before PQ chunking")
    p.add_argument("--auto-config", type=float, default=None, metavar="TARGET_RECALL",
                   help="calibrate a serving plan to this recall@10 on a "
                   "query sample (policy.recommend) instead of hand-picked "
                   "--nscan/--oversampling")
    p.add_argument("--nlist", type=int, default=None,
                   help="IVF cluster count (ivf-* methods; default: auto_geometry)")
    p.add_argument("--nprobe", type=int, default=32,
                   help="IVF probed buckets per query (ivf-* methods)")
    p.add_argument("--bucket-size", type=int, default=None,
                   help="IVF rows per bucket (ivf-* methods)")
    p.add_argument("--nscan", type=int, default=None,
                   help="IVF batch-union scanned buckets (default 4 * nprobe)")
    p.add_argument("--residual", action="store_true",
                   help="IVF inner codes over v - bucket_center (ivf-sq / "
                   "ivf-pq DOT/L2, ivf-bq DOT only, bucket-size multiple of 512)")
    p.add_argument("--oversampling", type=float, default=4.0)
    p.add_argument("--test-acc", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--bench-f32", action="store_true")
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--synthetic-count", type=int, default=100_000)
    p.add_argument("--topk-method", default="exact", choices=["exact", "approx"])
    p.add_argument("--recall-target", type=float, default=None,
                   help="approx mode: the JAX package's final-merge recall "
                   "dial; accepted and checked, and ignored by the port, "
                   "whose approx merge is exact (ROADMAP F9)")
    p.add_argument("--sharded", action="store_true",
                   help="shard the corpus over all devices (not ported yet: "
                   "raises, ROADMAP Queue 1 item 10)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                   "plain PyTorch versions)")
    p.add_argument("--json", action="store_true", help="emit JSON results")
    return p


def run(data: AnnBenchmarkData, args) -> dict:
    """One dataset through the CLI: build, then the measurements the flags
    ask for. Returns the JSON entry."""
    index = build_index(args.method, data, args)
    if args.auto_config is not None:
        # Calibrated serving plan (policy.recommend): sweep the nscan /
        # rescore ladder on a query sample against the exact f32 oracle
        # until the target recall is met, then serve through the plan.
        from ..models.pipeline import TwoStageIndex
        from ..policy import recommend

        base = index.coarse if isinstance(index, TwoStageIndex) else index
        plan = recommend(base, args.auto_config, queries=data.test[:32], data=data.train,
                         q_batch=args.query_batch)
        index = plan.build(base, data.train)
        print(
            f"[{data.name}] auto-config: nscan={plan.nscan} "
            f"oversampling={plan.oversampling} "
            f"measured_recall={plan.expected_recall:.3f} ({plan.notes})", flush=True
        )
    entry = {"dataset": data.name, "method": args.method}
    if args.test_acc:
        res = test_knn(data, index, query_batch=args.query_batch,
                       topk_method=args.topk_method, recall_target=args.recall_target)
        timings = res.timings()
        print(f"[{data.name}] recall: same_10={res.same_10:.4f} "
              f"same_20={res.same_20:.4f} same_30={res.same_30:.4f}", flush=True)
        print(f"[{data.name}] latency/query: "
              + ", ".join(f"{k}={v:,.0f}" for k, v in timings.items()), flush=True)
        entry.update(same_10=res.same_10, same_20=res.same_20, same_30=res.same_30,
                     **timings)
    if args.bench and (hasattr(index, "score_batch") or hasattr(index, "top_k_device")):
        entry["qps"] = bench_scoring(data, index, args, args.method)
    if args.bench_f32:
        entry["f32_qps"] = bench_f32(data, args)
    return entry


def main(argv=None):
    args = parser().parse_args(argv)
    _refuse_sharded(args)
    resolve_device(args.device)  # NoDeviceError before any data is made
    results = []
    for name, spec in DATASETS.items():
        if args.dataset and args.dataset not in name:
            continue
        data = AnnBenchmarkData.load(spec, args.data_dir, synthetic_count=args.synthetic_count,
                                     device=args.device)
        data.preprocess_cosine()
        results.append(run(data, args))
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
