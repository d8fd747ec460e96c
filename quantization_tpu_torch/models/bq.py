"""Binary quantizer — the EncodedVectorsBin of the PyTorch port.

Twin of ``quantization_tpu/models/bq.py``: sign-bit packing (v > 0 -> 1)
scored by XOR + popcount, with the Hamming count mapped onto the dot/L1/L2
score contract. The in-memory layout is the JAX package's, so the plane
arrays of the two packages compare whole:

  * planes: int32 [W8, Npad] holding the uint32 bit-plane words
    (``ops/bq.py``), W8 a multiple of 8 words and Npad of 2048 rows; words
    past the packed row and rows >= count are zero.
  * the on-disk blob keeps the reference's row-major packed-bytes layout
    with its word-size tiers (``store_type`` "u8" | "u128" reproduces the
    two BitsStoreType instantiations, encoded_vectors_binary.rs:44-160), so
    checkpoints load across the two packages and the reference.

Scores and searches go through the hand-written kernels on a CUDA device
(``ops/kernels/bq_kernel.py``: K6 scores, K5c exact and K5a approx search)
and through their plain versions on the CPU. The host packer is numpy, or
the native library with ``use_native=True``, on every device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.interface import (
    DataLike,
    EncodedVectors,
    as_ids,
    check_recall_target,
    iter_batches,
    validate_vector_parameters,
)
from ..core.storage import EncodedStorage
from ..core.types import (
    ArgumentsError,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..native import loader as native_loader
from ..ops import bq as bq_ops
from ..ops.dispatch import resolve_device, upload
from ..ops.kernels import bq_kernel
from ..ops.kernels.bq_kernel import TILE_N, W_ALIGN
from ..ops.kernels.ktile import APPROX_K_MAX, FUSED_K_MAX
from ..ops.topk import BLOCK_ROWS, blocked_topk
from ..utils.padding import pad_dim_to
from ..utils.parallel_encode import ordered_parallel_map


@dataclass
class BQMetadata:
    """Reference metadata is just the vector parameters
    (encoded_vectors_binary.rs:21-24)."""

    vector_parameters: VectorParameters

    def to_json(self) -> dict:
        return {"vector_parameters": self.vector_parameters.to_json()}

    @classmethod
    def from_json(cls, obj: dict) -> "BQMetadata":
        return cls(VectorParameters.from_json(obj["vector_parameters"]))


@dataclass
class EncodedQueryBin:
    """Bit-packed query batch: int32 words [Q, W8] holding uint32 bits."""

    planes: torch.Tensor


class BinaryQuantizer(EncodedVectors):
    """Sign-bit codec with XOR-popcount scoring on one torch device."""

    def __init__(
        self,
        planes: torch.Tensor,  # int32 [W, N] bit-plane words
        metadata: BQMetadata,
        store_type: str = "u128",
    ):
        # Pad the corpus axis to the kernel tile and the word axis to the
        # 8-word tile (zero words XOR to zero popcount; rows >= count are
        # sliced off or masked by count).
        count = metadata.vector_parameters.count
        npad = count + (-count) % TILE_N
        if planes.shape[0] % W_ALIGN:
            planes = pad_dim_to(planes, 0, planes.shape[0] + (-planes.shape[0]) % W_ALIGN)
        if planes.shape[1] < npad:
            planes = pad_dim_to(planes, 1, npad)
        self.planes = planes.contiguous()
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.store_type = store_type
        self.count = count
        self.device = self.planes.device

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        stop_condition=None,
        batch_size: int = 65536,
        store_type: str = "u128",
        use_native: bool = False,
        max_threads: int = 1,
        *,
        device=None,
    ) -> "BinaryQuantizer":
        """Pack sign bits batch by batch on the host
        (encoded_vectors_binary.rs:165-191) with a cancellation check between
        batches, then move the planes to ``device`` (default: the CUDA
        card). The packer, numpy or with ``use_native=True`` the native
        library (``native/loader.py``), runs on an ordered pool of
        ``max_threads`` threads; both give the same bytes. ``use_native=True`` raises
        ``NativeBuildError`` where the library cannot be built (ROADMAP
        F30)."""
        device = resolve_device(device)
        if use_native:
            native_loader.get_lib()  # raises where the library cannot be built
        if not callable(data):
            validate_vector_parameters(data, params)
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)

        def pack_one(batch):
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )
            if use_native and row_bytes > 0:
                return native_loader.pack_bits(batch, row_bytes)
            return bq_ops.pack_rows(batch, row_bytes)

        chunks = list(ordered_parallel_map(pack_one, iter_batches(data, batch_size),
                                           max_threads, stop_condition))
        total = sum(c.shape[0] for c in chunks)
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters count "
                f"{params.count}"
            )
        rows = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.zeros((0, row_bytes), np.uint8)
        )
        return cls._from_rows(rows, BQMetadata(params), store_type, device)

    @classmethod
    def _from_rows(cls, rows, metadata, store_type, device) -> "BinaryQuantizer":
        """Planes on ``device`` from [count, row_bytes] packed rows, padded on
        the host so the device holds one copy."""
        planes = bq_ops.rows_to_planes(rows)
        count = metadata.vector_parameters.count
        w, n = planes.shape
        padded = np.zeros(
            (w + (-w) % W_ALIGN, max(n, count + (-count) % TILE_N)), np.uint32
        )
        padded[:w, :n] = planes
        return cls(bq_ops.words_to_tensor(padded, device), metadata, store_type)

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryBin:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        row_bytes = bq_ops.storage_bytes(self.params.dim, self.store_type)
        words = bq_ops.rows_to_planes(bq_ops.pack_rows(q, row_bytes)).T  # [Q, W]
        w8 = self.planes.shape[0]
        if words.shape[1] < w8:  # match the stored planes' padded word count
            words = np.pad(words, ((0, 0), (0, w8 - words.shape[1])))
        return EncodedQueryBin(upload(np.asarray(words, np.uint32).view(np.int32), self.device))

    # ------------------------------------------------------------------ score
    def _kw(self) -> dict:
        return dict(
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dim=self.params.dim,
        )

    def score_batch(self, equery: EncodedQueryBin) -> torch.Tensor:
        """[Q, count] scores: K6 on a CUDA device."""
        if self.count == 0:
            return bq_ops.score_batch(equery.planes, self.planes[:, :0], **self._kw())
        return bq_kernel.bq_scores(
            equery.planes, self.planes, n_valid=self.count, **self._kw()
        )

    def top_k_device(self, equery: EncodedQueryBin, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        """Fused search (K5c exact, K5a approx — the coarse stage of
        two-stage retrieval scans the whole corpus, so the [Q, N] score
        matrix is never built). Beyond the fused caps: score then select,
        blocked over the corpus at large N so peak memory is [Q, block]."""
        check_recall_target(recall_target)
        cap = FUSED_K_MAX if method == "exact" else APPROX_K_MAX
        if self.count and k <= cap:
            return bq_kernel.bq_search(
                equery.planes, self.planes, n_valid=self.count, k=k, mode=method,
                **self._kw(),
            )
        if self.count > BLOCK_ROWS:

            def score_block(b0, b1):
                return bq_ops.score_batch(
                    equery.planes, self.planes[:, b0:b1], **self._kw()
                )

            return blocked_topk(score_block, self.count, k, method)
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryBin, ids) -> torch.Tensor:
        ids = as_ids(ids, self.device)
        return bq_ops.score_batch(equery.planes, self.planes[:, ids], **self._kw())

    def score_candidates(self, equery: EncodedQueryBin, cand) -> torch.Tensor:
        return bq_ops.score_candidates(
            equery.planes, self.planes, as_ids(cand, self.device), **self._kw()
        )

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        a = self.planes[:, as_ids(ids_a, self.device)]  # [W, P]
        b = self.planes[:, as_ids(ids_b, self.device)]
        xor = bq_ops.popcount32(a ^ b).sum(dim=0)
        return bq_ops.metric_from_xor(xor, **self._kw())

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        return bq_ops.storage_bytes(self.params.dim, self.store_type)

    def save(self, data_path, meta_path) -> None:
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        rows = bq_ops.planes_to_rows(
            bq_ops.tensor_to_words(self.planes[:, : self.count]),
            self.get_quantized_vector_size(),
        )
        EncodedStorage(rows).save_to_file(data_path)

    @classmethod
    def load(
        cls,
        data_path,
        meta_path,
        params: VectorParameters,
        store_type: str = "u128",
        device=None,
    ) -> "BinaryQuantizer":
        """Load onto ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        try:
            with open(meta_path) as f:
                meta = BQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        storage = EncodedStorage.from_file(data_path, row_bytes, params.count)
        return cls._from_rows(storage.data, meta, store_type, device)


# Reference-parity alias.
EncodedVectorsBin = BinaryQuantizer
