"""OPQ — Optimized Product Quantization: a learned orthogonal rotation
applied before PQ chunking (Ge et al., "Optimized Product Quantization",
CVPR 2013).

Twin of ``quantization_tpu/ops/opq.py``. ``pca_allocation_init`` is the JAX
package's numpy code, copied as it is. ``train_opq`` alternates warm-started
batched k-means (``ops/kmeans.py``) with the orthogonal Procrustes solve
R = U V^T of svd(X^T X_hat): its matmuls run in torch on the sample's device
at full f32 (no TF32), its [D, D] SVD on the host in f64. Codes and LUTs live
in the rotated space; DOT and L2 scores are rotation-invariant, L1 is not and
is rejected at the model layer.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.types import check_stop
from . import pq as pq_ops
from .kmeans import kmeans_batched

OPQ_OUTER_ITERATIONS = 10
OPQ_INNER_ITERATIONS = 25


def pca_allocation_init(
    sample: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """OPQ-P init: rotation whose output coordinates are the sample's
    principal directions, permuted so each chunk receives an
    (approximately) equal product of eigenvalues — the balanced-variance
    allocation of Ge et al. §4. Greedy: walk eigenvalues in descending
    order; each goes to the chunk with the smallest current log-product
    AMONG the least-filled chunks. The fill constraint is load-bearing:
    eigenvalues are < 1 on normalized data, so an unconstrained
    min-log-product greedy feeds every new eigenvalue to whichever bucket
    just got one (its product only shrank) and the top of the spectrum
    piles into the first chunk — the exact opposite of balance.
    Returns f32[dim, dim], orthogonal (columns are permuted eigenvectors
    of a symmetric matrix)."""
    x = np.asarray(sample, np.float64)
    dim = x.shape[1]
    cov = (x.T @ x) / max(1, x.shape[0])
    w, e = np.linalg.eigh(cov)  # ascending
    order = np.argsort(w)[::-1]
    w, e = w[order], e[:, order]
    caps = [en - st for st, en in division]
    m = len(division)
    logs = np.zeros(m)
    buckets: List[List[int]] = [[] for _ in range(m)]
    for j in range(dim):
        open_b = [b for b in range(m) if len(buckets[b]) < caps[b]]
        min_fill = min(len(buckets[b]) for b in open_b)
        level_b = [b for b in open_b if len(buckets[b]) == min_fill]
        b = min(level_b, key=lambda bb: logs[bb])
        buckets[b].append(j)
        logs[b] += np.log(max(w[j], 1e-12))
    perm = [j for b in range(m) for j in buckets[b]]
    return np.ascontiguousarray(e[:, perm], dtype=np.float32)


def reconstruct_rows(codes: torch.Tensor, c_chunks: torch.Tensor, dim: int) -> torch.Tensor:
    """Decode codes back to rotated-space rows: u8[S, m] + f32[m, k, dmax]
    -> f32[S, dim] (the inverse of chunk_rows_device's pad + reshape)."""
    idx = codes.T.long()[:, :, None].expand(-1, -1, c_chunks.shape[2])  # [m, S, dmax]
    rec = torch.gather(c_chunks, 1, idx)
    return rec.permute(1, 0, 2).reshape(codes.shape[0], -1)[:, :dim]


def train_opq(
    sample: np.ndarray,
    division: List[Tuple[int, int]],
    k: int,
    *,
    seed: int = 0,
    stop_condition=None,
    outer_iterations: int = OPQ_OUTER_ITERATIONS,
    inner_iterations: int = OPQ_INNER_ITERATIONS,
    final_iterations: int = pq_ops.KMEANS_MAX_ITERATIONS,
    accuracy: float = pq_ops.KMEANS_ACCURACY,
    init_rotation: np.ndarray = None,
    device="cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """Train (rotation, centroids) on a sample, on ``device``.

    Returns (R f32[dim, dim], centroids f32[k, dim]); the centroids live in
    the rotated space (they quantize x @ R). The final k-means runs the
    reference's full iteration budget (encoded_vectors_pq.rs:23), so a
    rotation-less run of this function would match plain PQ training."""
    sample = np.asarray(sample, np.float32)
    dim = sample.shape[1]
    rot = (
        np.asarray(init_rotation, np.float32)
        if init_rotation is not None
        else pca_allocation_init(sample, division)
    )
    x = torch.from_numpy(sample).to(device)
    cents = None
    for _ in range(outer_iterations):
        check_stop(stop_condition)
        with pq_ops.full_f32():
            xc = pq_ops.chunk_rows_device(x @ torch.from_numpy(rot).to(device), division)
        cents = kmeans_batched(
            xc, k, max_iterations=inner_iterations, accuracy=accuracy,
            seed=seed, stop_condition=stop_condition, init=cents,
        )
        xhat = reconstruct_rows(pq_ops.encode_batch(xc, cents), cents, dim)
        # Procrustes step: R = U V^T of X^T X_hat, the SVD on the host in f64
        # (it conditions the whole fit and is tiny at [D, D]).
        with pq_ops.full_f32():
            m64 = (x.T @ xhat).cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(m64)
        rot = np.ascontiguousarray(u @ vt, dtype=np.float32)
    check_stop(stop_condition)
    with pq_ops.full_f32():
        xc = pq_ops.chunk_rows_device(x @ torch.from_numpy(rot).to(device), division)
    cents = kmeans_batched(
        xc, k, max_iterations=final_iterations, accuracy=accuracy,
        seed=seed, stop_condition=stop_condition, init=cents,
    )
    return rot, pq_ops.chunks_to_centroids(cents.cpu().numpy(), division, dim)
