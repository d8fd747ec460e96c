"""Scalar u8 quantizer — the EncodedVectorsU8 of the PyTorch port.

Twin of ``quantization_tpu/models/sq.py``, with the same in-memory layout so
the code arrays of the two packages compare whole:

  * codes int8 [Npad, lane_dim] and voffsets f32 [Npad] on one torch device,
    Npad a multiple of 512; rows >= count and columns >= actual_dim are zero
    (score-neutral for both integer kernels).
  * the on-disk format is the reference's interleaved [f32 offset | u8 codes]
    rows over the 16-aligned actual_dim (encoded_vectors_u8.rs:12,252-259),
    so checkpoints load across the two packages and the reference.

Scoring math (parity with encoded_vectors_u8.rs:145-158,386-453):
    score(q, i)        = multiplier * kernel(Q, V_i) + q.offset + v_offset[i]
    score_internal(i,j)= multiplier * kernel(V_i, V_j) + off_i + off_j - diff
    diff               = actual_dim * offset^2   (negated when invert)

Scores go through the hand-written kernels on a CUDA device
(``ops/kernels/sq_kernel.py``): K3 for DOT and L2, K12 for L1. DOT and L2
searches are fused (K1 exact, K2 approx); L1 has no fused search in either
package, so it scores through K12 and then selects, blocked over the corpus
past ``L1_BLOCK_ROWS``. Candidate rescoring (``score_candidates``, the fine
stage of two-stage retrieval) goes through the K4 kernel
(``ops/kernels/gather.py``) for every metric. Data is placed on the CUDA
card unless the caller names another device.
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
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..native import loader as native_loader
from ..ops import sq as sq_ops
from ..ops.dispatch import resolve_device, upload
from ..ops.kernels import gather, sq_kernel
from ..ops.kernels.ktile import APPROX_K_MAX, FUSED_K_MAX
from ..ops.quantile import (
    QUANTILE_SAMPLE_SIZE,
    find_min_max_batches,
    find_quantile_interval,
    sample_rows,
)
from ..ops.topk import blocked_topk
from ..utils.parallel_encode import ordered_parallel_map
from ..utils.padding import pad_dim_to

# Corpus rows per score-then-select block (see top_k_device): bounds the
# transient score matrix at [Q, 1M] (~1GB at Q=256) regardless of corpus size.
L1_BLOCK_ROWS = 1 << 20


@dataclass
class SQMetadata:
    """Serialized metadata — field names match the reference serde struct
    (encoded_vectors_u8.rs:24-31)."""

    actual_dim: int
    alpha: float
    offset: float
    multiplier: float
    vector_parameters: VectorParameters

    def to_json(self) -> dict:
        return {
            "actual_dim": self.actual_dim,
            "alpha": self.alpha,
            "offset": self.offset,
            "multiplier": self.multiplier,
            "vector_parameters": self.vector_parameters.to_json(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "SQMetadata":
        return cls(
            actual_dim=int(obj["actual_dim"]),
            alpha=float(obj["alpha"]),
            offset=float(obj["offset"]),
            multiplier=float(obj["multiplier"]),
            vector_parameters=VectorParameters.from_json(obj["vector_parameters"]),
        )


@dataclass
class EncodedQueryU8:
    """Encoded query batch: int8 codes [Q, D_lane] + f32 correction [Q]."""

    codes: torch.Tensor
    offsets: torch.Tensor


def _lane_pad(n: int) -> int:
    return n + (-n) % sq_ops.LANE


def calibrate_sq(
    batches_fn, params: VectorParameters, quantile, stop_condition, seed: int
):
    """Two-pass SQ calibration (encoded_vectors_u8.rs:57-71): full min/max
    scan, then an optional quantile interval over a <=100k-row sample.
    ``batches_fn`` is a zero-arg callable returning a fresh batch iterator.
    Returns (alpha, offset)."""
    mn, mx = find_min_max_batches(batches_fn())
    alpha, offset = sq_ops.alpha_offset_from_min_max(mn, mx)
    if quantile is not None:
        check_stop(stop_condition)
        sample = sample_rows(batches_fn, params.count, QUANTILE_SAMPLE_SIZE, seed)
        interval = find_quantile_interval(sample, params.count, float(quantile))
        if interval is not None:
            alpha, offset = sq_ops.alpha_offset_from_min_max(*interval)
    return alpha, offset


class ScalarQuantizerU8(EncodedVectors):
    """u8 affine codec with integer scoring on one torch device."""

    def __init__(
        self,
        codes: torch.Tensor,
        voffsets: torch.Tensor,
        metadata: SQMetadata,
    ):
        count = metadata.vector_parameters.count
        npad = count + (-count) % sq_kernel.TILE_N
        if codes.shape[0] < npad:
            codes = pad_dim_to(codes, 0, npad)
            voffsets = pad_dim_to(voffsets, 0, npad)
        self.codes = codes.contiguous()
        self.voffsets = voffsets.contiguous()
        self.metadata = metadata
        self.device = self.codes.device
        self._mult = torch.tensor(
            [metadata.multiplier], dtype=torch.float32, device=self.device
        )
        self.params = metadata.vector_parameters
        self.count = count

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        quantile: Optional[float] = None,
        stop_condition=None,
        batch_size: int = 65536,
        seed: int = 0,
        use_native: bool = False,
        max_threads: int = 1,
        *,
        device=None,
    ) -> "ScalarQuantizerU8":
        """Calibrate + encode (reference encode, encoded_vectors_u8.rs:34-140).

        Two passes over ``data`` (which may be a re-iterable batch stream):
        pass 1 scans min/max (+ optional quantile sample) on the host, pass 2
        quantizes batch by batch with a cancellation check between batches,
        on ``device`` (default: the CUDA card), or with ``use_native=True``
        on the host by the native library (``native/loader.py``) on an
        ordered pool of ``max_threads`` threads, whose codes go up to
        ``device`` once. Native codes may differ by one from the device's at
        exact boundaries (ROADMAP F7). ``use_native=True`` raises
        ``NativeBuildError`` where the library cannot be built (ROADMAP
        F30)."""
        device = resolve_device(device)
        if use_native:
            native_loader.get_lib()  # raises where the library cannot be built
        if not callable(data):
            validate_vector_parameters(data, params)
        actual = sq_ops.actual_dim(params.dim)
        lane = _lane_pad(actual)
        if params.count == 0:
            # Early-out with zeroed metadata (encoded_vectors_u8.rs:43-54).
            meta = SQMetadata(actual, 0.0, 0.0, 0.0, params)
            return cls(
                torch.zeros((0, lane), dtype=torch.int8, device=device),
                torch.zeros((0,), dtype=torch.float32, device=device),
                meta,
            )

        def batches():
            return iter_batches(data, batch_size)

        alpha, offset = calibrate_sq(batches, params, quantile, stop_condition, seed)
        dt, inv = params.distance_type, params.invert
        multiplier = sq_ops.multiplier_for(dt, inv, alpha)
        meta = SQMetadata(actual, alpha, offset, multiplier, params)

        def check_dim(batch):
            if batch.shape[1] != params.dim:
                raise ArgumentsError(
                    f"Vector length {batch.shape[1]} does not match vector "
                    f"parameters dim {params.dim}"
                )

        npad = params.count + (-params.count) % sq_kernel.TILE_N
        if use_native:
            dt_index = [DistanceType.DOT, DistanceType.L1, DistanceType.L2].index(dt)
            pad = sq_ops.pad_code(dt, alpha, offset)

            def encode_one(batch):
                check_dim(batch)
                codes, voff = native_loader.quantize_u8(batch, actual, alpha, offset, pad,
                                                        dt_index, inv)
                return codes.view(np.int8), voff

            encoded = ordered_parallel_map(encode_one, batches(), max_threads, stop_condition)
            codes_all = np.zeros((npad, lane), np.int8)
            voff_all = np.zeros((npad,), np.float32)
        else:

            def encode_all():
                for batch in batches():
                    check_stop(stop_condition)
                    check_dim(batch)
                    # Only the f32 batch crosses to the device; the codes stay there.
                    yield sq_ops.quantize_batch(
                        torch.from_numpy(np.ascontiguousarray(batch)).to(device),
                        alpha=alpha, offset=offset, distance_type=dt, invert=inv,
                        dpad=actual, lane=lane,
                    )

            encoded = encode_all()
            codes_all = torch.zeros((npad, lane), dtype=torch.int8, device=device)
            voff_all = torch.zeros((npad,), dtype=torch.float32, device=device)
        total = 0
        for codes, voff in encoded:
            n = codes.shape[0]
            if total + n > params.count:
                raise ArgumentsError(
                    f"Vector count exceeds vector parameters count {params.count}"
                )
            codes_all[total : total + n, : codes.shape[1]] = codes
            voff_all[total : total + n] = voff
            total += n
        if total != params.count:
            raise ArgumentsError(
                f"Vector count {total} does not match vector parameters count "
                f"{params.count}"
            )
        if use_native:  # the host codes go up to the device once
            codes_all, voff_all = upload(codes_all, device), upload(voff_all, device)
        return cls(codes_all, voff_all, meta)

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryU8:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.params.dim:
            raise ArgumentsError(
                f"query dim {q.shape[1]} != corpus dim {self.params.dim}"
            )
        m = self.metadata
        codes, qoff = sq_ops.encode_query_batch(
            upload(q, self.device),
            alpha=m.alpha,
            offset=m.offset,
            distance_type=self.params.distance_type,
            invert=self.params.invert,
            dpad=m.actual_dim,
            lane=self.codes.shape[1],
        )
        return EncodedQueryU8(codes, qoff)

    # ------------------------------------------------------------------ score
    def _fused_ok(self) -> bool:
        """The fused searches (K1 / K2) take DOT and L2; the score kernels
        (K3 / K12) take every metric."""
        return self.count > 0 and self.params.distance_type != DistanceType.L1

    def _scores(self, equery: EncodedQueryU8, b0: int, b1: int) -> torch.Tensor:
        """[Q, b1 - b0] scores of corpus rows [b0, b1) through K3 / K12 (the
        plain versions on the CPU). The slice runs to the next multiple of
        512 rows, inside the padded codes, and only b1 - b0 are scored."""
        end = min(b1 + (b0 - b1) % sq_kernel.TILE_N, self.codes.shape[0])
        return sq_kernel.sq_scores(
            equery.codes,
            equery.offsets,
            self.codes[b0:end],
            self.voffsets[b0:end],
            self._mult,
            distance_type=self.params.distance_type,
            n_valid=b1 - b0,
        )

    def score_batch(self, equery: EncodedQueryU8) -> torch.Tensor:
        return self._scores(equery, 0, self.count)

    def top_k_device(self, equery: EncodedQueryU8, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        """Fused search for DOT/L2 (K1 exact, K2 approx): the [Q, N] score
        matrix is never materialized. L1 and k beyond the fused caps score
        (K3 / K12) then select, blocked over the corpus at large N so peak
        memory is [Q, block] + codes, never [Q, N]."""
        check_recall_target(recall_target)
        cap = FUSED_K_MAX if method == "exact" else APPROX_K_MAX
        if self._fused_ok() and k <= cap:
            return sq_kernel.sq_search(
                equery.codes,
                equery.offsets,
                self.codes,
                self.voffsets,
                self._mult,
                distance_type=self.params.distance_type,
                n_valid=self.count,
                k=k,
                mode=method,
            )
        if self.count > L1_BLOCK_ROWS:
            return blocked_topk(
                lambda b0, b1: self._scores(equery, b0, b1), self.count, k, method,
                block_rows=L1_BLOCK_ROWS,
            )
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryU8, ids) -> torch.Tensor:
        ids = as_ids(ids, self.device)
        return sq_ops.score_batch(
            equery.codes,
            equery.offsets,
            self.codes[ids],
            self.voffsets[ids],
            self._mult,
            distance_type=self.params.distance_type,
        )

    def score_candidates(self, equery: EncodedQueryU8, cand) -> torch.Tensor:
        """[Q, R] scores of per-query candidate ids, the fine stage of
        two-stage retrieval: the K4 rescoring kernel on a CUDA device (no
        [Q, R, D] gather is written), the plain gather on the CPU. An id
        outside [0, count) (a coarse stage's padding) scores -inf on both."""
        return gather.sq_score_candidates(
            equery.codes,
            equery.offsets,
            self.codes,
            self.voffsets,
            as_ids(cand, self.device, torch.int32),
            self._mult,
            distance_type=self.params.distance_type,
            n_valid=self.count,
        )

    def _internal_diff(self) -> float:
        m = self.metadata
        diff = m.actual_dim * m.offset * m.offset
        return -diff if self.params.invert else diff

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        ids_a = as_ids(ids_a, self.device)
        ids_b = as_ids(ids_b, self.device)
        return sq_ops.score_internal_batch(
            self.codes[ids_a],
            self.voffsets[ids_a],
            self.codes[ids_b],
            self.voffsets[ids_b],
            self._mult,
            self._internal_diff(),
            distance_type=self.params.distance_type,
        )

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        """Bytes per stored row in the on-disk format
        (encoded_vectors_u8.rs:252-255)."""
        return self.metadata.actual_dim + 4

    def save(self, data_path, meta_path) -> None:
        """Two-file save: JSON metadata + raw blob with the reference's
        interleaved [f32 offset | u8 codes] rows."""
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)

        m = self.metadata
        n = self.count
        codes_np = self.codes[:n, : m.actual_dim].cpu().numpy()
        voff_np = self.voffsets[:n].cpu().numpy().astype(np.float32)
        rows = np.zeros((n, m.actual_dim + 4), dtype=np.uint8)
        if n:
            rows[:, :4] = voff_np.view(np.uint8).reshape(n, 4)
            rows[:, 4:] = codes_np.view(np.uint8)
        EncodedStorage(rows).save_to_file(data_path)

    @classmethod
    def load(
        cls, data_path, meta_path, params: VectorParameters, device=None
    ) -> "ScalarQuantizerU8":
        """Load onto ``device`` (default: the CUDA card); metadata is
        authoritative for semantics, ``params`` for sizing (the reference's
        asymmetry)."""
        try:
            with open(meta_path) as f:
                meta = SQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        row_size = meta.actual_dim + 4
        storage = EncodedStorage.from_file(data_path, row_size, params.count)
        rows = storage.data
        n = params.count
        if n:
            voff = rows[:, :4].copy().view(np.float32).reshape(n)
            codes = rows[:, 4:].view(np.int8)
        else:
            voff = np.zeros((0,), np.float32)
            codes = np.zeros((0, meta.actual_dim), np.int8)
        lane = _lane_pad(meta.actual_dim)
        if lane > meta.actual_dim:
            codes = np.pad(codes, ((0, 0), (0, lane - meta.actual_dim)))
        device = resolve_device(device)
        return cls(
            torch.from_numpy(np.ascontiguousarray(codes)).to(device),
            torch.from_numpy(np.ascontiguousarray(voff)).to(device),
            meta,
        )


# Reference-parity alias.
EncodedVectorsU8 = ScalarQuantizerU8
