"""Exact f32 distance oracle, batched — the recall reference.

Twin of ``quantization_tpu/core/distances.py`` (the batched form of the
reference's scalar ``DistanceType::distance``, encoded_vectors.rs:37-45).
DOT and L2 products go to ``torch.matmul`` in full float32: TF32 is switched
off for them, since it keeps only about three decimal digits.
"""

from __future__ import annotations

import torch

from .types import DistanceType

# Corpus rows per L1 tile: peak memory is Q * L1_TILE * D.
L1_TILE = 1024


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def distance(a, b, distance_type: DistanceType) -> torch.Tensor:
    """Exact distance over the last axis (broadcasts leading axes).

    DOT is the raw dot product (a similarity), L1/L2 are distances; L2 is
    the *squared* euclidean distance."""
    a, b = _f32(a), _f32(b)
    if distance_type == DistanceType.DOT:
        return torch.sum(a * b, dim=-1)
    if distance_type == DistanceType.L1:
        return torch.sum(torch.abs(a - b), dim=-1)
    if distance_type == DistanceType.L2:
        d = a - b
        return torch.sum(d * d, dim=-1)
    raise ValueError(f"unknown distance type {distance_type}")


def pairwise(queries, corpus, distance_type: DistanceType) -> torch.Tensor:
    """Exact [Q, N] distance matrix between queries[Q, D] and corpus[N, D]."""
    queries, corpus = _f32(queries), _f32(corpus)
    torch.backends.cuda.matmul.allow_tf32 = False
    if distance_type == DistanceType.DOT:
        return queries @ corpus.T
    if distance_type == DistanceType.L2:
        qq = torch.sum(queries * queries, dim=-1, keepdim=True)  # [Q, 1]
        nn = torch.sum(corpus * corpus, dim=-1)  # [N]
        return qq + nn[None, :] - 2.0 * (queries @ corpus.T)
    if distance_type == DistanceType.L1:
        tiles = [
            torch.sum(
                torch.abs(queries[:, None, :] - corpus[None, n0 : n0 + L1_TILE]),
                dim=-1,
            )
            for n0 in range(0, corpus.shape[0], L1_TILE)
        ]
        if not tiles:
            return queries.new_zeros((queries.shape[0], 0))
        return torch.cat(tiles, dim=1)
    raise ValueError(f"unknown distance type {distance_type}")


def score(a, b, distance_type: DistanceType, invert: bool) -> torch.Tensor:
    """Exact score with the library's sign convention (invert => negate)."""
    d = distance(a, b, distance_type)
    return -d if invert else d


def pairwise_score(
    queries, corpus, distance_type: DistanceType, invert: bool
) -> torch.Tensor:
    d = pairwise(queries, corpus, distance_type)
    return -d if invert else d
