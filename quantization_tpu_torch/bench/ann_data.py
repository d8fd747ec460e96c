"""ANN benchmark datasets and measurement harness.

Twin of ``quantization_tpu/bench/ann_data.py``, the port of
demos/src/ann_benchmark_data.rs: the same metrics vocabulary (recall
``same_10/same_20/same_30`` at ann_benchmark_data.rs:168-183, latency
min/avg/p95/p99/max at :202-220, encode wall-clock), the same HDF5 layout
(train/test/neighbors/distances) and the same cosine preprocessing
(:223-230). Nothing is downloaded: the loader reads a local HDF5 file when
there is one and otherwise generates a seeded clustered synthetic corpus of
the dataset's shape, with the same numpy calls as the JAX package, so both
packages make byte-equal ``train`` and ``test`` for a seed. The exact
neighbours of a synthetic corpus are computed on a torch device (default:
the CUDA card).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict

import numpy as np
import torch

from ..core.distances import pairwise_score
from ..core.types import DistanceType
from ..ops.dispatch import resolve_device, upload

# Queries per block of the exact-neighbour scan: the [block, N] score matrix
# is the largest transient (2.6 GB at 9.99M rows).
EXACT_QUERY_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    filename: str
    dim: int
    distance_type: DistanceType


# The reference's 11-dataset registry (demos/src/ann_benchmark.rs:46-102),
# keyed by the ann-benchmarks basename.
DATASETS: Dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        DatasetSpec("glove-200-angular", "glove-200-angular.hdf5", 200, DistanceType.DOT),
        DatasetSpec("glove-100-angular", "glove-100-angular.hdf5", 100, DistanceType.DOT),
        DatasetSpec("glove-50-angular", "glove-50-angular.hdf5", 50, DistanceType.DOT),
        DatasetSpec("glove-25-angular", "glove-25-angular.hdf5", 25, DistanceType.DOT),
        DatasetSpec("deep-image-96-angular", "deep-image-96-angular.hdf5", 96, DistanceType.DOT),
        DatasetSpec("nytimes-256-angular", "nytimes-256-angular.hdf5", 256, DistanceType.DOT),
        DatasetSpec("lastfm-64-dot", "lastfm-64-dot.hdf5", 64, DistanceType.DOT),
        DatasetSpec("fashion-mnist-784-euclidean", "fashion-mnist-784-euclidean.hdf5", 784,
                    DistanceType.L2),
        DatasetSpec("gist-960-euclidean", "gist-960-euclidean.hdf5", 960, DistanceType.L2),
        DatasetSpec("mnist-784-euclidean", "mnist-784-euclidean.hdf5", 784, DistanceType.L2),
        DatasetSpec("sift-128-euclidean", "sift-128-euclidean.hdf5", 128, DistanceType.L2),
    ]
}


def cosine_preprocess(data: np.ndarray) -> np.ndarray:
    """Row-normalize (ann_benchmark_data.rs:223-230) so dot == cosine."""
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return (data / norms).astype(np.float32)


@dataclasses.dataclass
class AnnBenchmarkData:
    name: str
    distance_type: DistanceType
    train: np.ndarray  # [N, D] f32
    test: np.ndarray  # [Q, D] f32
    neighbors: np.ndarray  # [Q, >=30] int — exact top neighbors

    @classmethod
    def load(
        cls,
        spec: DatasetSpec,
        data_dir: str = "test_data",
        synthetic_count: int = 100_000,
        synthetic_queries: int = 100,
        seed: int = 42,
        device=None,
    ) -> "AnnBenchmarkData":
        """The HDF5 file ``data_dir/spec.filename`` when it exists, else the
        synthetic corpus, whose exact neighbours are computed on ``device``
        (default: the CUDA card)."""
        path = os.path.join(data_dir, spec.filename)
        if os.path.exists(path):
            return cls.from_hdf5(spec, path)
        return cls.synthetic(spec, synthetic_count, synthetic_queries, seed, device=device)

    @classmethod
    def from_hdf5(cls, spec: DatasetSpec, path: str) -> "AnnBenchmarkData":
        import h5py

        with h5py.File(path, "r") as f:
            train = np.asarray(f["train"], dtype=np.float32)
            test = np.asarray(f["test"], dtype=np.float32)
            neighbors = np.asarray(f["neighbors"], dtype=np.int64)
        return cls(spec.name, spec.distance_type, train, test, neighbors)

    @classmethod
    def synthetic(
        cls, spec: DatasetSpec, count: int, queries: int, seed: int, device=None
    ) -> "AnnBenchmarkData":
        """Clustered gaussian corpus of the dataset's shape: 64 centers with
        anisotropic spread gives realistic (non-uniform) neighbor structure.
        The JAX package's draws and arithmetic, so ``train`` and ``test`` are
        byte-equal to its corpus for a seed."""
        rng = np.random.default_rng(seed)
        n_centers = 64
        centers = rng.standard_normal((n_centers, spec.dim)).astype(np.float32)
        scales = (0.3 + rng.random(n_centers, dtype=np.float32))[:, None]
        assign = rng.integers(0, n_centers, count)
        train = (
            centers[assign]
            + rng.standard_normal((count, spec.dim)).astype(np.float32)
            * scales[assign]
            * 0.5
        )
        qassign = rng.integers(0, n_centers, queries)
        test = (
            centers[qassign]
            + rng.standard_normal((queries, spec.dim)).astype(np.float32)
            * scales[qassign]
            * 0.5
        )
        data = cls(
            spec.name + "-synthetic",
            spec.distance_type,
            train.astype(np.float32),
            test.astype(np.float32),
            np.zeros((queries, 0), np.int64),
        )
        # Ground truth must reflect the metric actually benchmarked: angular
        # datasets are scored post-normalization, so normalize first
        # (normalization is idempotent, so the harness's later
        # preprocess_cosine() is a no-op).
        data.preprocess_cosine()
        data.neighbors = data.exact_neighbors(100, device=device)
        return data

    def preprocess_cosine(self) -> None:
        if self.distance_type == DistanceType.DOT:
            self.train = cosine_preprocess(self.train)
            self.test = cosine_preprocess(self.test)

    def exact_neighbors(self, k: int, device=None) -> np.ndarray:
        """Exact top-k ids [Q, k] of the f32 scores, on ``device`` (default:
        the CUDA card) in blocks of 64 queries: a full-f32 matmul (TF32
        off; L1 and L2 through ``core.distances``) and ``torch.topk``."""
        dev = resolve_device(device)
        invert = self.distance_type != DistanceType.DOT
        train = torch.from_numpy(self.train).to(dev)
        out = []
        for start in range(0, self.test.shape[0], EXACT_QUERY_BLOCK):
            q = upload(self.test[start : start + EXACT_QUERY_BLOCK], dev)
            scores = pairwise_score(q, train, self.distance_type, invert)
            out.append(torch.topk(scores, min(k, scores.shape[1]), dim=1).indices.cpu().numpy())
            del scores
        return np.concatenate(out, axis=0)


def same_count(a: np.ndarray, b: np.ndarray) -> int:
    return len(set(a.tolist()) & set(b.tolist()))


@dataclasses.dataclass
class KnnResult:
    same_10: float
    same_20: float
    same_30: float
    latencies_us: np.ndarray

    def timings(self) -> Dict[str, float]:
        """min/avg/p95/p99/max in microseconds
        (ann_benchmark_data.rs:202-220)."""
        lat = np.sort(self.latencies_us)
        p95 = min(int(len(lat) * 0.95), len(lat) - 1)
        p99 = min(int(len(lat) * 0.99), len(lat) - 1)
        return {
            "min_us": float(lat[0]),
            "avg_us": float(lat.mean()),
            "p95_us": float(lat[p95]),
            "p99_us": float(lat[p99]),
            "max_us": float(lat[-1]),
        }


def test_knn(
    data: AnnBenchmarkData,
    index,
    query_batch: int = 1,
    topk_method: str = "exact",
    recall_target=None,
) -> KnnResult:
    """Full-scan top-30 per query; recall@10/20/30 vs exact ground truth +
    per-batch latency (the reference's per-query loop,
    ann_benchmark_data.rs:123-185, batched). A batch's latency runs from
    its host queries to its ids on the host."""
    q_total = data.test.shape[0]
    same10 = same20 = same30 = 0.0
    latencies = []
    all_idx = []
    for start in range(0, q_total, query_batch):
        q = data.test[start : start + query_batch]
        t0 = time.perf_counter()
        eq = index.encode_query(q)
        if recall_target is None:
            _, idx = index.top_k(eq, 30, method=topk_method)
        else:
            _, idx = index.top_k(
                eq, 30, method=topk_method, recall_target=recall_target
            )
        idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
        latencies.append((time.perf_counter() - t0) * 1e6 / q.shape[0])
        all_idx.append(idx)
    idx = np.concatenate(all_idx, axis=0)
    gt = data.neighbors
    for qi in range(q_total):
        same10 += same_count(idx[qi, :10], gt[qi, :10])
        same20 += same_count(idx[qi, :20], gt[qi, :20])
        same30 += same_count(idx[qi, :30], gt[qi, :30])
    return KnnResult(
        same_10=same10 / (10 * q_total),
        same_20=same20 / (20 * q_total),
        same_30=same30 / (30 * q_total),
        latencies_us=np.asarray(latencies),
    )
