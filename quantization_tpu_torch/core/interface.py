"""The EncodedVectors contract — batched, with results as torch tensors.

Twin of ``quantization_tpu/core/interface.py``. The reference exposes
point-at-a-time scoring (encoded_vectors.rs:21-35); here the batch is the
primitive:

  - ``encode_query(queries)``     — accepts [D] or [Q, D]
  - ``score_batch(equery)``       — full [Q, N] score matrix
  - ``score_points(equery, ids)`` — [Q, P] scores against selected points
  - ``score_point(equery, i)``    — scalar parity shim over score_points
  - ``score_internal(i, j)``      — point-vs-point inside the encoded corpus
  - ``top_k(equery, k)``          — fused score + top-k, returned as numpy
  - ``save/load``                 — two-file checkpoint (JSON meta + raw blob)

Ingestion accepts either a materialized [count, dim] float32 array or a
re-iterable stream of row batches (the reference's re-cloneable iterator
contract, encoded_vectors_u8.rs:35).
"""

from __future__ import annotations

import abc
import numbers
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .types import ArgumentsError, VectorParameters

# A dataset is either a [count, dim] array or a zero-arg factory returning an
# iterator of [batch, dim] float32 arrays: encode passes over the data more
# than once (calibration pass + encode pass).
DataLike = Union[np.ndarray, Callable[[], Iterable[np.ndarray]]]


def check_recall_target(recall_target: Optional[float]) -> None:
    """The JAX package's approx-merge dial (``approx_max_k``'s
    ``recall_target``, default 0.95): None or a float in (0, 1], else
    ``ArgumentsError``. The port accepts it and ignores it: its approx merge
    is an exact top-k over the same candidates, so its recall is never lower
    (ROADMAP F9)."""
    if recall_target is None:
        return
    if isinstance(recall_target, bool) or not isinstance(recall_target, numbers.Real):
        raise ArgumentsError(f"recall_target must be None or a float in (0, 1], "
                             f"got {recall_target!r}")
    if not 0.0 < float(recall_target) <= 1.0:
        raise ArgumentsError(f"recall_target must be in (0, 1], got {recall_target!r}")


def iter_batches(
    data: DataLike, batch_size: int = 65536
) -> Iterator[np.ndarray]:
    """Yield float32 [b, dim] batches from an array or a stream factory."""
    if callable(data):
        for batch in data():
            arr = np.asarray(batch, dtype=np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            yield arr
    else:
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 2:
            raise ArgumentsError(f"expected [count, dim] data, got shape {arr.shape}")
        for start in range(0, arr.shape[0], batch_size):
            yield arr[start : start + batch_size]


def checked_batches(
    batches: Iterable[np.ndarray], params: VectorParameters
) -> Iterator[np.ndarray]:
    """The batches of an encode pass, each checked as it comes: its dim,
    the running count, and after the last one the total count
    (encoded_vectors.rs:47-70; the overflow message is
    encoded_vectors_u8.rs's). One check for every encode loop, single-device
    and sharded."""
    total = 0
    for batch in batches:
        if batch.shape[1] != params.dim:
            raise ArgumentsError(
                f"Vector length {batch.shape[1]} does not match vector "
                f"parameters dim {params.dim}"
            )
        total += batch.shape[0]
        if total > params.count:
            raise ArgumentsError(
                f"Vector count exceeds vector parameters count {params.count}"
            )
        yield batch
    if total != params.count:
        raise ArgumentsError(
            f"Vector count {total} does not match vector parameters count "
            f"{params.count}"
        )


def as_ids(ids, device, dtype=torch.int64) -> torch.Tensor:
    """Point ids (a tensor, array or list) as a ``dtype`` tensor on ``device``."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(ids), dtype=dtype).to(device)


def validate_vector_parameters(data: DataLike, params: VectorParameters) -> None:
    """Check every batch's dim and the total count
    (reference validate_vector_parameters, encoded_vectors.rs:47-70).
    Stream factories are validated incrementally inside the encode loops
    instead — pre-iterating a stream here would double ingestion cost."""
    if not callable(data):
        arr = np.asarray(data)
        if arr.ndim != 2 or arr.shape[1] != params.dim:
            got = arr.shape[1] if arr.ndim == 2 else arr.shape
            raise ArgumentsError(
                f"Vector length {got} does not match vector "
                f"parameters dim {params.dim}"
            )
        if arr.shape[0] != params.count:
            raise ArgumentsError(
                f"Vector count {arr.shape[0]} does not match vector "
                f"parameters count {params.count}"
            )
        return
    count = 0
    for batch in iter_batches(data):
        if batch.shape[1] != params.dim:
            raise ArgumentsError(
                f"Vector length {batch.shape[1]} does not match vector "
                f"parameters dim {params.dim}"
            )
        count += batch.shape[0]
    if count != params.count:
        raise ArgumentsError(
            f"Vector count {count} does not match vector parameters count "
            f"{params.count}"
        )


class EncodedVectors(abc.ABC):
    """Base class for the quantizers."""

    #: filled by subclasses
    params: VectorParameters

    # -- checkpoint ---------------------------------------------------------
    @abc.abstractmethod
    def save(self, data_path, meta_path) -> None:
        ...

    @classmethod
    @abc.abstractmethod
    def load(cls, data_path, meta_path, params: VectorParameters, device=None):
        ...

    # -- query path ---------------------------------------------------------
    @abc.abstractmethod
    def encode_query(self, queries):
        """Encode one query [D] or a batch [Q, D] into the quantizer's
        query representation."""

    @abc.abstractmethod
    def score_batch(self, equery) -> torch.Tensor:
        """[Q, N] scores of every encoded query against the whole corpus."""

    @abc.abstractmethod
    def score_points(self, equery, ids) -> torch.Tensor:
        """[Q, P] scores against the selected point ids."""

    def score_candidates(self, equery, cand) -> torch.Tensor:
        """[Q, R] scores where cand[Q, R] holds per-query candidate ids —
        the rescoring primitive of two-stage retrieval."""
        raise NotImplementedError

    def score_point(self, equery, i: int) -> float:
        """Scalar parity shim matching the reference's score_point
        (encoded_vectors.rs:32)."""
        out = self.score_points(equery, np.asarray([i]))
        return float(out.reshape(-1)[0])

    # -- internal scoring ---------------------------------------------------
    @abc.abstractmethod
    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        """[P] scores between corpus points ids_a[P] and ids_b[P]."""

    def score_internal(self, i: int, j: int) -> float:
        out = self.score_internal_batch(np.asarray([i]), np.asarray([j]))
        return float(out.reshape(-1)[0])

    # -- serving ------------------------------------------------------------
    def top_k_device(self, equery, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        """(scores[Q, k], indices[Q, k]) as tensors on the corpus device, with
        no host sync. ``top_k`` is the sync-and-convert wrapper.
        ``recall_target``: see ``check_recall_target``."""
        from ..ops.topk import top_k as _topk

        check_recall_target(recall_target)
        return _topk(self.score_batch(equery), k, method=method)

    def top_k(
        self, equery, k: int, method: str = "exact",
        recall_target: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores[Q, k], indices[Q, k]) of the best-scoring points, as numpy.

        "Best" always means largest score — callers encode their ranking
        direction via ``invert`` exactly as in the reference contract.
        ``method``: "exact" or "approx"; ``recall_target``: see
        ``check_recall_target``."""
        s, i = self.top_k_device(equery, k, method=method, recall_target=recall_target)
        return s.cpu().numpy(), i.cpu().numpy()
