"""Two-stage retrieval: coarse quantized scan -> candidate rescoring.

Twin of ``quantization_tpu/models/pipeline.py``: the Qdrant-style serving
pattern the reference enables by exposing all quantizers over one trait. A
cheap coarse scorer (BQ Hamming, typically: K5a / K5c) produces an
oversampled candidate set, and a finer scorer (SQ through the K4 rescoring
kernel, or exact f32) re-ranks just those candidates. Both stages run on the
device; only the final (scores, indices) land on the host.

Padding ids (-1) from a coarse stage score -inf in every port rescorer;
the JAX package's rescorers read some row for them (ROADMAP F4), and both
packages mask them in ``_mask_select``. ``recall_target`` is checked and
ignored: the port's approx merges are exact, so its recall is never lower
(ROADMAP F9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.distances import pairwise_score, score
from ..core.interface import EncodedVectors, as_ids, check_recall_target
from ..core.types import ArgumentsError
from ..ops.dispatch import resolve_device, upload


class ExactRescorer:
    """f32 rescoring stage backed by the original vectors.

    ``host_resident=False`` (default) keeps the corpus on ``device``
    (default: the CUDA card); a tensor already there is used without a copy.
    ``host_resident=True`` keeps it on the host — a numpy array or an
    ``np.memmap``, so a corpus beyond the card's memory rescores from
    disk-backed memory: per call only the gathered [Q, R, D] candidate rows
    cross to the device."""

    def __init__(
        self,
        data,
        distance_type,
        invert: bool,
        host_resident: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self._host = host_resident
        if host_resident:
            self._data = data if isinstance(data, np.ndarray) else np.asarray(data)
        else:
            self._data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        self._dt = distance_type
        self._invert = invert

    def encode_query(self, queries) -> torch.Tensor:
        q = upload(np.asarray(queries, np.float32), self.device)
        return q[None, :] if q.ndim == 1 else q

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        """f32 rows at ids (ids < 0 read row 0; callers mask them)."""
        safe = ids.clamp(min=0)
        if self._host:
            idx = safe.cpu().numpy()
            sub = np.asarray(self._data[idx.reshape(-1)], np.float32)
            return torch.from_numpy(sub).to(self.device).reshape(
                tuple(ids.shape) + (self._data.shape[1],)
            )
        return self._data[safe]

    def score_points(self, equery, ids) -> torch.Tensor:
        ids = as_ids(ids, self.device)
        s = pairwise_score(equery, self._rows(ids), self._dt, self._invert)
        return torch.where(ids[None, :] >= 0, s, s.new_full((), float("-inf")))

    def score_candidates(self, equery, cand) -> torch.Tensor:
        """[Q, R] exact scores of per-query candidates; -inf where cand < 0."""
        cand = as_ids(cand, self.device)
        s = score(equery[:, None, :], self._rows(cand), self._dt, self._invert)
        return torch.where(cand >= 0, s, s.new_full((), float("-inf")))


def _mask_select(cand: torch.Tensor, fine_scores: torch.Tensor, k: int):
    """Masked final selection: a padding id (-1) of the coarse stage can
    never outrank a true candidate, whatever its rescorer made of it."""
    fine_scores = torch.where(cand >= 0, fine_scores, fine_scores.new_full((), float("-inf")))
    s, pos = torch.topk(fine_scores, k, dim=1)
    return s, torch.gather(cand, 1, pos)


class TwoStageIndex:
    """Coarse quantized top-R + fine rescoring top-k."""

    def __init__(
        self,
        coarse: EncodedVectors,
        fine,
        oversampling: float = 4.0,
        coarse_method: str = "approx",
    ):
        """``coarse_method`` defaults to the approx fused search (K5a for
        BQ): the coarse stage feeds an oversampled candidate set into exact
        rescoring, so its own selection can be approximate. Pass "exact" for
        strict two-stage equivalence."""
        if oversampling < 1.0:
            raise ArgumentsError("oversampling must be >= 1")
        self.coarse = coarse
        self.fine = fine
        self.oversampling = float(oversampling)
        self.coarse_method = coarse_method

    def encode_query(self, queries):
        return (
            self.coarse.encode_query(queries),
            self.fine.encode_query(queries),
        )

    def top_k_device(self, equery, k: int, method: str = None,
                     recall_target: Optional[float] = None):
        """Both stages stay on the device; no host sync between coarse and
        fine. ``method`` overrides the constructor's coarse_method;
        ``recall_target``: checked and ignored (``check_recall_target``)."""
        check_recall_target(recall_target)
        eq_coarse, eq_fine = equery
        r = int(np.ceil(k * self.oversampling))
        r = min(r, self.coarse.count if self.coarse.count else r)
        _, cand = self.coarse.top_k_device(
            eq_coarse, r, method=method or self.coarse_method
        )
        fine_scores = self.fine.score_candidates(eq_fine, cand)  # [Q, R]
        return _mask_select(cand, fine_scores, min(k, r))

    def top_k(
        self, equery, k: int, method: str = None, recall_target: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        s, idx = self.top_k_device(equery, k, method=method, recall_target=recall_target)
        return s.cpu().numpy(), idx.cpu().numpy()
