"""Top-k selection over a score matrix (the score-then-select path).

Twin of ``quantization_tpu/ops/topk.py``. PyTorch has no ``approx_max_k``,
so ``method="approx"`` selects exactly here: recall is never lower than the
JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Sentinel contract: when fewer than k candidates exist, missing slots hold
# score -inf and index -1 — never a valid corpus id. The fused exact
# searches keep it too (ktile.merge_exact).
NEG_INF = float("-inf")

METHODS = ("exact", "approx")


def _pad_k(s: torch.Tensor, i: torch.Tensor, k: int, fill: float = NEG_INF):
    got = s.shape[1]
    i = i.to(torch.int32)
    if got < k:
        s = torch.cat([s, s.new_full((s.shape[0], k - got), fill)], dim=1)
        i = torch.cat([i, i.new_full((i.shape[0], k - got), -1)], dim=1)
    return s, i


def topk_exact(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (scores[Q, k], indices[Q, k]), padded with -inf / -1."""
    s, i = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
    return _pad_k(s, i, k)


def top_k(
    scores: torch.Tensor, k: int, method: str = "exact"
) -> Tuple[torch.Tensor, torch.Tensor]:
    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    return topk_exact(scores, k)


# Corpus rows per block in blocked_topk: [256 queries, 1M rows] f32 scores
# is 1 GB of transient device memory — bounded regardless of corpus size.
BLOCK_ROWS = 1 << 20


def blocked_topk(
    score_block,
    count: int,
    k: int,
    method: str = "exact",
    block_rows: int = BLOCK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-at-any-k selection with O(Q * block_rows) peak memory.

    ``score_block(b0, b1) -> f32[Q, b1-b0]`` scores one corpus slice. Blocks
    are scored + selected independently and merged with one final top-k."""
    parts_s, parts_i = [], []
    for b0 in range(0, count, block_rows):
        b1 = min(b0 + block_rows, count)
        s, i = top_k(score_block(b0, b1), min(k, b1 - b0), method=method)
        parts_s.append(s)
        parts_i.append(i + b0)
    s = torch.cat(parts_s, dim=1)
    i = torch.cat(parts_i, dim=1)
    ss, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
    return _pad_k(ss, torch.gather(i, 1, pos), k)
