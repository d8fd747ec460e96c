"""Product quantizer — the EncodedVectorsPQ of the PyTorch port.

Twin of ``quantization_tpu/models/pq.py``: batched k-means over every chunk
at once (``ops/kmeans.py``), encode as a batched nearest-centroid argmin,
queries as [Q, m, k] lookup tables, with the JAX package's in-memory layouts,
so the code arrays of the two packages compare whole:

  * codes u8 [Npad, Mpad] and their transpose ``codes_t`` u8 [Mpad, Npad] on
    one torch device, Npad a multiple of 1024 and Mpad of 16; rows >= count
    and chunk columns >= m are zero (their LUT rows are zero, so padding
    scores nothing). ``codes_t`` puts the corpus on the fast axis, the
    kernels' layout; each of the two is built from the other on first use.
  * the on-disk format is the reference's row-major codes, one byte per
    chunk, or two 4-bit chunks per byte for ``bits=4``; the metadata JSON
    carries the optional ``bits`` and ``rotation`` keys of the JAX package.

Reference constants preserved: 256 centroids per chunk, a <= 10k-row
training sample, 100 iterations, accuracy 1e-5 (encoded_vectors_pq.rs:22-25);
with count <= 256 the centroids are the points themselves, zero-filled
(rs:290-297). ``bits=4`` trains 16 centroids per chunk; ``rotation="opq"``
learns an orthogonal rotation first (``ops/opq.py``).

Scores and searches go through the hand-written kernels on a CUDA device
(``ops/kernels/pq_kernel.py``: K8 scores, K7b exact and K7a approx search)
and through their plain versions on the CPU, with the LUT in the word that
``lut_precision()`` names at each call (``QTPU_PQ_LUT``, int8 by default).
Points, candidates and internal scores use the f32 LUT, as in the JAX
package. Data is placed on the CUDA card unless the caller names another
device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.interface import (
    DataLike,
    EncodedVectors,
    as_ids,
    check_recall_target,
    checked_batches,
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
from ..ops import pq as pq_ops
from ..ops.dispatch import resolve_device, upload
from ..ops.kernels import pq_kernel
from ..ops.kernels.ktile import APPROX_K_MAX, FUSED_K_MAX
from ..ops.kmeans import kmeans_batched
from ..ops.quantile import sample_rows
from ..ops.topk import BLOCK_ROWS, blocked_topk
from ..utils.padding import pad_dim_to


@dataclass
class PQMetadata:
    """Field names match the reference serde struct
    (encoded_vectors_pq.rs:39-44); Range<usize> serializes as
    {"start", "end"}."""

    centroids: np.ndarray  # f32 [k, dim]
    vector_division: List[Tuple[int, int]]
    vector_parameters: VectorParameters
    bits: int = 8  # 8 (reference parity, 256 centroids) or 4 (16 centroids)
    # OPQ rotation f32[dim, dim] or None: codes and centroids quantize
    # x @ rotation. The key is absent in reference-written files.
    rotation: Optional[np.ndarray] = None

    def to_json(self) -> dict:
        out = {
            "centroids": [[float(v) for v in row] for row in np.asarray(self.centroids)],
            "vector_division": [{"start": s, "end": e} for s, e in self.vector_division],
            "vector_parameters": self.vector_parameters.to_json(),
        }
        if self.bits != 8:
            out["bits"] = self.bits
        if self.rotation is not None:
            out["rotation"] = [[float(v) for v in row] for row in np.asarray(self.rotation)]
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "PQMetadata":
        rot = obj.get("rotation")
        return cls(
            centroids=np.asarray(obj["centroids"], dtype=np.float32),
            vector_division=[
                (int(r["start"]), int(r["end"])) for r in obj["vector_division"]
            ],
            vector_parameters=VectorParameters.from_json(obj["vector_parameters"]),
            bits=int(obj.get("bits", 8)),
            rotation=None if rot is None else np.asarray(rot, dtype=np.float32),
        )


@dataclass
class EncodedQueryPQ:
    """Per-query lookup table lut f32 [Q, m, k]
    (reference EncodedQueryPQ, encoded_vectors_pq.rs:35-37)."""

    lut: torch.Tensor


def encoded_batches(batches, metadata: PQMetadata, c_chunks, rot_t, stop_condition, device):
    """Pass 2 of the encode on ``device``, for the single-device and the
    sharded encoders: each checked batch's nearest-centroid codes u8 [b, m]
    (after the rotation, at full f32, where there is one), with a
    cancellation check between batches."""
    division = metadata.vector_division
    for batch in checked_batches(batches, metadata.vector_parameters):
        check_stop(stop_condition)
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(device)
        if rot_t is not None:
            with pq_ops.full_f32():
                x = x @ rot_t
        yield pq_ops.encode_batch(pq_ops.chunk_rows_device(x, division), c_chunks)


def encode_queries(queries, metadata: PQMetadata, c_chunks, rot, device) -> EncodedQueryPQ:
    """A [D] or [Q, D] query batch as its f32 LUT on ``device``: the
    single-device and the sharded quantizers' ``encode_query``."""
    p = metadata.vector_parameters
    q = np.asarray(queries, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != p.dim:
        raise ArgumentsError(f"query dim {q.shape[1]} != corpus dim {p.dim}")
    x = upload(q, device)
    if rot is not None:
        # OPQ: queries rotate into code space at full f32 (a rotation at
        # reduced precision shifts every LUT entry coherently).
        with pq_ops.full_f32():
            x = x @ rot
    lut = pq_ops.build_lut(
        pq_ops.chunk_rows_device(x, metadata.vector_division),
        c_chunks,
        distance_type=p.distance_type,
        invert=p.invert,
    )
    return EncodedQueryPQ(lut)


class ProductQuantizer(EncodedVectors):
    """Chunked vector -> per-chunk nearest-centroid u8 codes, LUT scoring."""

    def __init__(self, codes: torch.Tensor, metadata: PQMetadata):
        """``codes`` u8 [N, m] (or already padded) on the quantizer's device."""
        npad, mpad = self._pads(metadata)
        self._codes = pad_dim_to(pad_dim_to(codes, 0, max(npad, codes.shape[0])), 1,
                                 max(mpad, codes.shape[1])).contiguous()
        self._codes_t = None
        self._init_common(metadata, self._codes.device)

    @classmethod
    def from_transposed(cls, codes_t: torch.Tensor, metadata: PQMetadata) -> "ProductQuantizer":
        """Construct with the transposed [Mpad, Npad] layout as the primary
        storage (the kernels' layout); the row-major ``codes`` are built on
        first use (save, score_points, score_internal)."""
        npad, mpad = cls._pads(metadata)
        obj = cls.__new__(cls)
        obj._codes = None
        obj._codes_t = pad_dim_to(pad_dim_to(codes_t, 0, max(mpad, codes_t.shape[0])), 1,
                                  max(npad, codes_t.shape[1])).contiguous()
        obj._init_common(metadata, obj._codes_t.device)
        return obj

    @staticmethod
    def _pads(metadata: PQMetadata) -> tuple:
        count = metadata.vector_parameters.count
        m = len(metadata.vector_division)
        return (count + (-count) % pq_kernel.TILE_N, m + (-m) % pq_kernel.M_BLK)

    def _init_common(self, metadata: PQMetadata, device) -> None:
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.count = metadata.vector_parameters.count
        self.num_chunks = len(metadata.vector_division)
        self.device = torch.device(device)
        self._c_chunks = torch.from_numpy(
            pq_ops.centroids_to_chunks(np.asarray(metadata.centroids), metadata.vector_division)
        ).to(self.device)  # f32 [m, k, dmax]
        self._rot = (
            None if metadata.rotation is None
            else torch.as_tensor(metadata.rotation, dtype=torch.float32, device=self.device)
        )
        self._cdist: Optional[torch.Tensor] = None

    @property
    def codes(self) -> torch.Tensor:
        """Row-major [Npad, Mpad] codes, built from ``codes_t`` on first use
        for a transposed-first quantizer."""
        if self._codes is None:
            self._codes = self._codes_t.T.contiguous()
        return self._codes

    @property
    def resident_codes(self) -> Tuple[torch.Tensor, bool]:
        """(the code layout the quantizer holds, whether it is the
        transposed [Mpad, Npad] one): for readers of a few rows, which need
        neither layout built."""
        if self._codes is not None:
            return self._codes, False
        return self._codes_t, True

    @property
    def codes_t(self) -> torch.Tensor:
        """The kernels' [Mpad, Npad] copy, built on first use and kept: it
        doubles the resident code bytes, so consumers that never scan the
        whole corpus never pay for it."""
        if self._codes_t is None:
            self._codes_t = self._codes.T.contiguous()
        return self._codes_t

    # ------------------------------------------------------------------ train
    @classmethod
    def encode(
        cls,
        data: DataLike,
        params: VectorParameters,
        chunk_size: int,
        stop_condition=None,
        batch_size: int = 16384,
        seed: int = 0,
        bits: int = 8,
        rotation=None,
        device=None,
    ) -> "ProductQuantizer":
        """k-means train + batched encode (encoded_vectors_pq.rs:56-107), on
        ``device`` (default: the CUDA card).

        ``bits=4`` trains 16 centroids per chunk (half the code bytes); 8 is
        reference parity. ``rotation="opq"`` learns an orthogonal rotation on
        the training sample (``ops/opq.py``); an explicit f32[dim, dim]
        orthogonal matrix is used as is. Codes and centroids then quantize
        ``x @ R``; DOT and L2 scores are unchanged by the rotation, L1 is not
        and is rejected."""
        device = resolve_device(device)
        if not callable(data):
            validate_vector_parameters(data, params)

        def batches():
            return iter_batches(data, batch_size)

        meta, c_chunks, rot_t = cls._codebook(batches, params, chunk_size, stop_condition, seed,
                                              bits, rotation, device)
        parts = list(encoded_batches(batches(), meta, c_chunks, rot_t, stop_condition, device))
        codes = (
            torch.cat(parts, dim=0) if parts
            else torch.zeros((0, len(meta.vector_division)), dtype=torch.uint8, device=device)
        )
        return cls(codes, meta)

    @classmethod
    def _codebook(cls, batches, params, chunk_size, stop_condition, seed, bits, rotation,
                  device):
        """Pass 1 of the encode, for the single-device and the sharded
        encoders: the chunking, the centroids (and an OPQ rotation) trained
        on ``device``. Returns (metadata, the centroids as f32 [m, k, dmax]
        chunks on ``device``, the rotation on ``device`` or None)."""
        if bits not in (4, 8):
            raise ArgumentsError(f"bits must be 4 or 8, got {bits}")
        if rotation is not None and params.distance_type == DistanceType.L1:
            raise ArgumentsError("OPQ rotation does not preserve L1 distances; use DOT or L2")
        division = pq_ops.get_vector_division(params.dim, chunk_size)
        k = pq_ops.CENTROIDS_COUNT if bits == 8 else pq_ops.CENTROIDS_COUNT4
        centroids, rot = cls._find_centroids(
            batches, division, params, stop_condition, seed, k, rotation, device
        )
        c_chunks = torch.from_numpy(pq_ops.centroids_to_chunks(centroids, division)).to(device)
        rot_t = None if rot is None else torch.from_numpy(rot).to(device)
        return PQMetadata(centroids, division, params, bits=bits, rotation=rot), c_chunks, rot_t

    @classmethod
    def _find_centroids(cls, batches, division, params, stop_condition, seed, k, rotation,
                        device):
        """Sample + per-chunk k-means (encoded_vectors_pq.rs:278-342), run as
        one batched clustering over all chunks on ``device``. Returns
        (centroids f32[k, dim], rotation f32[dim, dim] or None); with a
        rotation the centroids live in the rotated space."""
        if params.count <= k:
            # Too few vectors: the centroids are the points, zero-filled to k
            # (rs:290-297). OPQ has nothing to learn here (the quantization is
            # lossless), so "opq" is the identity; an explicit matrix applies.
            rows = list(batches())
            points = (
                np.concatenate(rows, axis=0) if rows
                else np.zeros((0, params.dim), np.float32)
            )
            rot = None
            if rotation is not None and not isinstance(rotation, str):
                rot = cls._check_rotation(rotation, params.dim)
                points = points @ rot
            centroids = np.zeros((k, params.dim), dtype=np.float32)
            centroids[: points.shape[0]] = points
            return centroids, rot
        check_stop(stop_condition)
        sample = sample_rows(batches, params.count, pq_ops.KMEANS_SAMPLE_SIZE, seed)
        if isinstance(rotation, str):
            if rotation != "opq":
                raise ArgumentsError(
                    f'rotation must be None, "opq", or a [dim, dim] matrix; got {rotation!r}'
                )
            from ..ops.opq import train_opq

            rot, centroids = train_opq(
                sample, division, k, seed=seed, stop_condition=stop_condition, device=device
            )
            return centroids, rot
        rot = None
        if rotation is not None:
            rot = cls._check_rotation(rotation, params.dim)
            sample = sample @ rot
        chunked = kmeans_batched(
            torch.from_numpy(pq_ops.chunk_tensor(sample, division)).to(device),
            k,
            max_iterations=pq_ops.KMEANS_MAX_ITERATIONS,
            accuracy=pq_ops.KMEANS_ACCURACY,
            seed=seed,
            stop_condition=stop_condition,
        )
        return pq_ops.chunks_to_centroids(chunked.cpu().numpy(), division, params.dim), rot

    @staticmethod
    def _check_rotation(rotation, dim: int) -> np.ndarray:
        rot = np.asarray(rotation, dtype=np.float32)
        if rot.shape != (dim, dim):
            raise ArgumentsError(f"rotation shape {rot.shape} != ({dim}, {dim})")
        if not np.allclose(rot @ rot.T, np.eye(dim), atol=1e-3):
            raise ArgumentsError("rotation matrix is not orthogonal")
        return rot

    # ------------------------------------------------------------------ query
    def encode_query(self, queries) -> EncodedQueryPQ:
        return encode_queries(queries, self.metadata, self._c_chunks, self._rot, self.device)

    # ------------------------------------------------------------------ score
    def _rows(self) -> torch.Tensor:
        """The codes of the corpus, u8 [count, m]."""
        return self.codes[: self.count, : self.num_chunks]

    def score_batch(self, equery: EncodedQueryPQ) -> torch.Tensor:
        """[Q, count] scores: K8 on a CUDA device, with the LUT in the word
        ``lut_precision()`` names (bf16 for bf16x2, as in the JAX package)."""
        if self.count == 0:
            return pq_ops.score_lut(equery.lut, self._rows())
        return pq_kernel.pq_scores(equery.lut, self.codes_t, n_valid=self.count,
                                   precision=pq_kernel.lut_precision())

    def top_k_device(self, equery: EncodedQueryPQ, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        """Fused search (K7b exact, K7a approx): no [Q, N] score matrix.
        ``method="exact"`` is exact selection over the LUT scores of
        ``lut_precision()`` (int8 by default, one quantization step from the
        f32 LUT; ``QTPU_PQ_LUT=bf16`` for near-f32 scores), read at each call.
        Beyond the fused caps: the f32 LUT, blocked over the corpus at large N
        so peak memory is [Q, block], else score then select."""
        check_recall_target(recall_target)
        cap = FUSED_K_MAX if method == "exact" else APPROX_K_MAX
        if self.count and k <= cap:
            return pq_kernel.pq_search(equery.lut, self.codes_t, n_valid=self.count, k=k,
                                       mode=method, precision=pq_kernel.lut_precision())
        if self.count > BLOCK_ROWS:
            sub = self._rows()

            def score_block(b0, b1):
                return pq_ops.score_lut(equery.lut, sub[b0:b1])

            return blocked_topk(score_block, self.count, k, method)
        return super().top_k_device(equery, k, method=method)

    def score_points(self, equery: EncodedQueryPQ, ids) -> torch.Tensor:
        sub = self.codes[:, : self.num_chunks]
        return pq_ops.score_lut(equery.lut, sub[as_ids(ids, self.device)])

    def score_candidates(self, equery: EncodedQueryPQ, cand) -> torch.Tensor:
        return pq_ops.score_candidates_lut(equery.lut, self.codes[:, : self.num_chunks],
                                           as_ids(cand, self.device))

    def _centroid_distances(self) -> torch.Tensor:
        if self._cdist is None:
            self._cdist = pq_ops.centroid_distance_table(
                self._c_chunks, distance_type=self.params.distance_type,
                invert=self.params.invert,
            )
        return self._cdist

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        sub = self.codes[:, : self.num_chunks]
        return pq_ops.score_internal_lut(
            self._centroid_distances(), sub[as_ids(ids_a, self.device)],
            sub[as_ids(ids_b, self.device)],
        )

    # ----------------------------------------------------------------- debug
    def dump_to_image(self, data: np.ndarray, prefix: str = "kmeans") -> list:
        """Debug view: per chunk, a scatter of the first two chunk dimensions
        coloured by assigned centroid, centroids in red (the reference's
        ``dump_image`` feature, encoded_vectors_pq.rs:344-403). Returns the
        written paths."""
        from PIL import Image

        rng = np.random.default_rng(0)
        colors = rng.integers(0, 256, (pq_ops.CENTROIDS_COUNT, 3), dtype=np.uint8)
        data = np.asarray(data, dtype=np.float32)
        if self.metadata.rotation is not None:
            data = data @ np.asarray(self.metadata.rotation)  # the centroids' space
        mn, mx = float(data.min()), float(data.max())
        span = max(mx - mn, 1e-9)
        codes = self._rows().cpu().numpy()
        centroids = np.asarray(self.metadata.centroids)
        size = 1000
        paths = []
        for ci, (s, e) in enumerate(self.metadata.vector_division):
            if e - s < 2:
                continue
            img = np.full((size, size, 3), 255, dtype=np.uint8)
            xy = np.clip(((data[:, [s, s + 1]] - mn) / span * size), 0, size - 1).astype(np.int32)
            img[xy[:, 1], xy[:, 0]] = colors[codes[:, ci]]
            cxy = np.clip(
                ((centroids[:, [s, s + 1]] - mn) / span * size), 0, size - 2
            ).astype(np.int32)
            for dx in (0, 1):
                for dy in (0, 1):
                    img[cxy[:, 1] + dy, cxy[:, 0] + dx] = (255, 0, 0)
            path = f"{prefix}-{ci}.png"
            Image.fromarray(img).save(path)
            paths.append(path)
        return paths

    # ------------------------------------------------------------- checkpoint
    def get_quantized_vector_size(self) -> int:
        """One byte per chunk (encoded_vectors_pq.rs:109-114); 4-bit codes
        pack two chunks per byte on disk."""
        m = self.num_chunks
        return m if self.metadata.bits == 8 else (m + 1) // 2

    def save(self, data_path, meta_path) -> None:
        meta_dir = os.path.dirname(os.fspath(meta_path))
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(self.metadata.to_json(), f)
        rows = self._rows().cpu().numpy()
        if self.metadata.bits == 4:
            if rows.shape[1] % 2:
                rows = np.pad(rows, ((0, 0), (0, 1)))
            rows = (rows[:, 0::2] | (rows[:, 1::2] << 4)).astype(np.uint8)
        EncodedStorage(np.ascontiguousarray(rows)).save_to_file(data_path)

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters,
             device=None) -> "ProductQuantizer":
        """Load onto ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        try:
            with open(meta_path) as f:
                meta = PQMetadata.from_json(json.load(f))
        except (OSError, json.JSONDecodeError, KeyError) as e:
            raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e
        m = len(meta.vector_division)
        row_size = m if meta.bits == 8 else (m + 1) // 2
        rows = EncodedStorage.from_file(data_path, row_size, params.count).data
        if meta.bits == 4:
            unpacked = np.empty((rows.shape[0], row_size * 2), np.uint8)
            unpacked[:, 0::2] = rows & 0x0F
            unpacked[:, 1::2] = rows >> 4
            rows = unpacked[:, :m]
        return cls(torch.from_numpy(np.ascontiguousarray(rows)).to(device), meta)


# Reference-parity alias.
EncodedVectorsPQ = ProductQuantizer
