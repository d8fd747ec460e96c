"""Product-quantization ops: chunking, batched nearest-centroid encode, LUT
build, and the plain LUT scoring.

Twin of ``quantization_tpu/ops/pq.py``, in PyTorch (the chunking helpers are
numpy copies: the port imports nothing of the JAX package). Encode is a
batched argmin over a distance tensor; scoring sums per-chunk LUT gathers.
Chunks are padded to a common width with zeros — zero pads in both operands
contribute 0 to every distance used here, so results are unchanged.

The fused scans (score matrix and searches) are the CUDA kernels of
``ops/kernels/pq_kernel.py``; ``score_lut`` here is the f32-LUT path the JAX
package computes in XLA (``score_lut_xla``).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from ..core.types import DistanceType

CENTROIDS_COUNT = 256  # encoded_vectors_pq.rs:25
CENTROIDS_COUNT4 = 16  # 4-bit (Quick-ADC style) extension — not in reference
KMEANS_SAMPLE_SIZE = 10_000  # rs:22
KMEANS_MAX_ITERATIONS = 100  # rs:23
KMEANS_ACCURACY = 1e-5  # rs:24


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products at full precision (no TF32 on the card) for
    the block, whatever the caller set: the LUT, the OPQ rotation and the
    k-means distances rank by differences far below TF32's ~1e-3."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def get_vector_division(dim: int, chunk_size: int) -> List[Tuple[int, int]]:
    """Split [0, dim) into chunks of <= chunk_size
    (encoded_vectors_pq.rs:116-121)."""
    return [
        (i, min(i + chunk_size, dim)) for i in range(0, dim, max(1, chunk_size))
    ]


def chunk_tensor(
    data: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """[B, dim] -> [m, B, dmax] with zero padding on ragged last chunk."""
    dmax = max(e - s for s, e in division)
    m = len(division)
    out = np.zeros((m, data.shape[0], dmax), dtype=np.float32)
    for ci, (s, e) in enumerate(division):
        out[ci, :, : e - s] = data[:, s:e]
    return out


def chunk_rows_device(x: torch.Tensor, division: List[Tuple[int, int]]) -> torch.Tensor:
    """Device-side ``chunk_tensor``: f32[B, dim] -> f32[m, B, dmax] with a
    pad + reshape. Valid for the contiguous equal-width-except-ragged-tail
    divisions ``get_vector_division`` produces."""
    m = len(division)
    dmax = max(e - s for s, e in division)
    dim = division[-1][1]
    assert all(s == i * dmax for i, (s, e) in enumerate(division)), division
    x = torch.nn.functional.pad(x, (0, m * dmax - dim))
    return x.reshape(x.shape[0], m, dmax).permute(1, 0, 2).contiguous()


def centroids_to_chunks(
    centroids: np.ndarray, division: List[Tuple[int, int]]
) -> np.ndarray:
    """Full-dim centroids [k, dim] -> chunked [m, k, dmax] (zero-padded)."""
    return chunk_tensor(centroids, division)


def chunks_to_centroids(
    chunked: np.ndarray, division: List[Tuple[int, int]], dim: int
) -> np.ndarray:
    """Chunked centroids [m, k, dmax] -> full-dim [k, dim]."""
    k = chunked.shape[1]
    out = np.zeros((k, dim), dtype=np.float32)
    for ci, (s, e) in enumerate(division):
        out[:, s:e] = chunked[ci, :, : e - s]
    return out


def sq_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances f32[g, B, k] of x[g, B, d] to c[g, k, d]
    as ``x^2 + c^2 - 2 x.c`` (the JAX package's form, so argmins agree)."""
    x2 = torch.sum(x * x, dim=2)[:, :, None]
    c2 = torch.sum(c * c, dim=2)
    with full_f32():
        xc = torch.bmm(x, c.transpose(1, 2))
    # The doubling is exact, so subtracting 2 x.c in place rounds as the
    # expression does, without a [g, B, k] temporary for 2 x.c.
    return (x2 + c2[:, None, :]).sub_(xc, alpha=2.0)


def encode_batch(x_chunks: torch.Tensor, c_chunks: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes for a batch.

    x_chunks: f32[m, B, dmax], c_chunks: f32[m, k, dmax] -> u8[B, m].
    Per-chunk argmin (the first minimum wins) of squared euclidean distance
    — PQ always encodes with the euclid metric whatever the scoring distance
    (encoded_vectors_pq.rs:250-256). The chunk axis runs in groups of
    ``group_size`` so the [g, B, k] distance tensor stays bounded."""
    from .kmeans import group_size

    m, b, _ = x_chunks.shape
    k = c_chunks.shape[1]
    g = group_size(m, b, k)
    parts = [
        torch.argmin(sq_distances(x_chunks[i : i + g], c_chunks[i : i + g]), dim=2)
        for i in range(0, m, g)
    ]
    return torch.cat(parts, dim=0).to(torch.uint8).T


def build_lut(
    q_chunks: torch.Tensor,
    c_chunks: torch.Tensor,
    *,
    distance_type: DistanceType,
    invert: bool,
) -> torch.Tensor:
    """Per-query lookup table lut[Q, m, k]: exact distance from each query
    sub-vector to each centroid sub-vector (encoded_vectors_pq.rs:525-547),
    negated under ``invert``. Products at full f32 (``full_f32``), as the
    JAX package builds it at ``Precision.HIGHEST``."""
    if distance_type == DistanceType.L1:
        lut = torch.sum(
            torch.abs(q_chunks[:, :, None, :] - c_chunks[:, None, :, :]), dim=-1
        )  # [m, Q, k]
    else:
        with full_f32():
            qc = torch.bmm(q_chunks, c_chunks.transpose(1, 2))  # [m, Q, k]
        if distance_type == DistanceType.DOT:
            lut = qc
        else:
            q2 = torch.sum(q_chunks * q_chunks, dim=2)[:, :, None]
            c2 = torch.sum(c_chunks * c_chunks, dim=2)[:, None, :]
            lut = q2 + c2 - 2.0 * qc
    lut = lut.permute(1, 0, 2).contiguous()
    return -lut if invert else lut


def score_lut(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[Q, N] scores = sum over chunks of lut[q, m, codes[n, m]], in f32 and
    in chunk order (the twin of ``score_lut_xla``'s scan). codes u8 [N, m]."""
    q, m, _ = lut.shape
    idx = codes.long()
    acc = lut.new_zeros((q, codes.shape[0]))
    for c in range(m):
        acc += lut[:, c, idx[:, c]]
    return acc


def score_candidates_lut(
    lut: torch.Tensor, codes: torch.Tensor, cand: torch.Tensor
) -> torch.Tensor:
    """[Q, R] PQ scores against per-query candidate lists: gather candidate
    code rows, then gather into the LUT."""
    g = codes[cand.long()].long()  # [Q, R, m]
    picked = torch.gather(lut, 2, g.transpose(1, 2))  # [Q, m, R]
    return torch.sum(picked, dim=1)


def centroid_distance_table(
    c_chunks: torch.Tensor, *, distance_type: DistanceType, invert: bool
) -> torch.Tensor:
    """cdist[m, k, k]: pairwise distance between centroids of each chunk —
    the batched form of the reference's decode-and-compare score_internal
    (encoded_vectors_pq.rs:566-593)."""
    if distance_type == DistanceType.L1:
        cdist = torch.sum(
            torch.abs(c_chunks[:, :, None, :] - c_chunks[:, None, :, :]), dim=-1
        )
    else:
        with full_f32():
            ab = torch.bmm(c_chunks, c_chunks.transpose(1, 2))
        if distance_type == DistanceType.DOT:
            cdist = ab
        else:
            c2 = torch.sum(c_chunks * c_chunks, dim=2)
            cdist = c2[:, :, None] + c2[:, None, :] - 2.0 * ab
    return -cdist if invert else cdist


def score_internal_lut(
    cdist: torch.Tensor, codes_a: torch.Tensor, codes_b: torch.Tensor
) -> torch.Tensor:
    """[P] scores between stored code rows via the centroid-distance table.
    codes_a/b: u8[P, m]."""
    m, k, _ = cdist.shape
    chunk_ids = torch.arange(m, device=cdist.device)[None, :]
    idx = (chunk_ids * k + codes_a.long()) * k + codes_b.long()  # [P, m]
    return torch.sum(cdist.reshape(-1)[idx], dim=1)
