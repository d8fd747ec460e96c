"""Sharded corpus scoring over a device mesh — all three quantizers.

Twin of ``quantization_tpu/parallel/sharded.py``. The corpus axis is split
into equal shards over the mesh's ``shard`` axis; every shard scores its
rows with the port's kernels and selects a *local* top-k, and the only
cross-shard step is a merge of (k scores, k global ids) per shard on the
mesh's first device. The port is single-controller, as the JAX package is:
one process owns the mesh and every shard, launches each shard's kernels on
that shard's device (all of them before the first copy, so shards on
different cards overlap) and merges. A mesh's devices may repeat: on one
card, four shards are four launches each, and a one-device mesh is the
single-device search with a merge behind it.

Construction paths:
  * wrap an already-encoded single-device quantizer (its arrays re-laid as
    shards on the mesh's devices);
  * ``ShardedX.encode(data, params, mesh=...)`` — streaming sharded-native
    ingestion: each host batch is quantized and committed straight into
    per-shard device buffers (``utils.device_store.DeviceAppender``), so
    the corpus codes never gather on one device;
  * ``ShardedX.load(...)`` — reads the reference two-file format shard by
    shard (each shard's slice goes from a memory map straight to its
    device).

``save`` writes the same reference-compatible blob shard by shard. A global
id is ``s * n_local + local``: ``n_local`` follows the port's kernel tiles
(and so differs from the JAX package's), but ids are row numbers, so results
and files do not change.

For two-stage retrieval every sharded class exposes ``top_k_device``
(results stay on the mesh's first device) and ``score_candidates`` (each
shard rescoring the ids it owns, merged by one select per shard; an id no
shard owns scores -inf), so a ``TwoStageIndex`` runs entirely on sharded
stages.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.distances import score as _score
from ..core.interface import as_ids, check_recall_target, iter_batches
from ..core.types import ArgumentsError, DistanceType, StorageIOError, VectorParameters
from ..models import bq as bq_model
from ..models import pq as pq_model
from ..models import sq as sq_model
from ..models.bq import BinaryQuantizer, BQMetadata, EncodedQueryBin
from ..models.pq import EncodedQueryPQ, PQMetadata, ProductQuantizer
from ..models.sq import EncodedQueryU8, ScalarQuantizerU8, SQMetadata
from ..ops import bq as bq_ops
from ..ops import pq as pq_ops
from ..ops import sq as sq_ops
from ..ops.dispatch import NoDeviceError, upload
from ..ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel
from ..ops.kernels.ktile import APPROX_K_MAX, FUSED_K_MAX
from ..ops.topk import _pad_k, blocked_topk
from ..utils.device_store import DeviceAppender, ShardedArray
from ..utils.padding import pad_dim_to

NEG_INF = float("-inf")


class Mesh:
    """A named grid of torch devices, the port's ``jax.sharding.Mesh``:
    ``devices`` an object ndarray of ``torch.device``, one ``axis_names``
    entry per axis, ``shape[name]`` that axis's size. A device may appear
    more than once (the port's counterpart of virtual devices): the shards
    it holds run one after another on it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ArgumentsError(
                f"{len(self.axis_names)} axis names for a {devices.ndim}-D device grid")
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first_device(self) -> torch.device:
        """Where queries are encoded and shard results are merged."""
        return self.devices.flat[0]

    def shard_devices(self, axis: str) -> List[torch.device]:
        """For each index along ``axis``, the device holding that shard: the
        first device of the grid's slice at that index. The other axes
        hold no copy of the corpus: no search reads one yet (ROADMAP item
        10's multi-axis note)."""
        if axis not in self.axis_names:
            raise ArgumentsError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        a = self.axis_names.index(axis)
        return [np.take(self.devices, [s], axis=a).flat[0] for s in range(self.devices.shape[a])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("shard",),
    shape: Optional[Sequence[int]] = None,
    *,
    devices=None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` of ``devices``.

    ``devices`` defaults to every CUDA card (``NoDeviceError`` without one:
    never the CPU unless asked); an explicit list may repeat a device, e.g.
    ``[torch.device("cpu")] * 8`` or ``["cuda:0"] * 4``. Default is a 1-D
    ``('shard',)`` mesh over all of them. Pass ``axis_names=('shard',
    'qdp')`` with a ``shape`` for a grid: the corpus is sharded along the
    named axis, each shard on the first device of its slice."""
    if devices is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device: make_mesh() takes every card; pass devices=[...] "
                "(e.g. [torch.device('cpu')] * 8) to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ArgumentsError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    grid = np.empty(n_devices, dtype=object)
    for i, d in enumerate(devices[:n_devices]):
        grid[i] = d
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ArgumentsError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != n_devices:
        raise ArgumentsError(f"mesh shape {tuple(shape)} does not hold {n_devices} devices")
    return Mesh(grid.reshape(tuple(shape)), tuple(axis_names))


def _indexed(d: torch.device) -> torch.device:
    """``d`` with its index: a bare "cuda" is the current card, as its
    tensors report it, so a shard's tensors and its mesh slot name one
    device (per-device copies are keyed by device)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


# ------------------------------------------------------------- shard helpers


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def _per_device(devices, *tensors) -> dict:
    """{device: the operands on it}, each copied once to each device."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = tuple(_to(t, d) for t in tensors)
    return out


def _live_shards(count: int, n_local: int, n_shards: int) -> Iterator[Tuple[int, int]]:
    """(s, n_valid) of every shard holding rows, n_valid =
    clamp(count - s * n_local, 0, n_local). A shard past ``count`` (a small
    corpus on many shards) holds none: it launches nothing and contributes
    no candidates."""
    for s in range(n_shards):
        nv = max(0, min(count - s * n_local, n_local))
        if nv:
            yield s, nv


def _global_ids(v, li, s: int, n_local: int, n_valid: int):
    """A shard's local top-k as (scores, global ids): slots that hold no row
    of the shard's valid prefix (an exact search's -1, an approx search's
    padding candidates) become -inf / -1."""
    valid = (li >= 0) & (li < n_valid)
    return (torch.where(valid, v, v.new_full((), NEG_INF)),
            torch.where(valid, li.to(torch.int32) + s * n_local, -1).to(torch.int32))


def _shard_rows(t: torch.Tensor, count: int, n_pad: int, devices, dim: int) -> ShardedArray:
    """The first ``count`` entries of ``t`` along ``dim`` as ``len(devices)``
    zero-padded shards of ``n_pad / len(devices)``, shard s copied to
    ``devices[s]``. A shard already on its device that needs no padding or
    copy to be contiguous is a view of ``t``."""
    n_local = n_pad // len(devices)
    shards = []
    for s, d in enumerate(devices):
        r0 = s * n_local
        v = max(0, min(count - r0, n_local))
        piece = t.narrow(dim, min(r0, t.shape[dim]), v)
        shards.append(pad_dim_to(_to(piece, d), dim, n_local).contiguous())
    return ShardedArray(shards, dim)


def _load_shards(fill, n: int, n_local: int, devices, dim: int) -> ShardedArray:
    """Shards read by ``fill(r0, v)`` (a host array of one shard whose first
    ``v`` entries along ``dim`` are rows ``[r0, r0 + v)``), shard s copied
    to ``devices[s]``."""
    return ShardedArray([torch.from_numpy(fill(s * n_local, max(0, min(n - s * n_local, n_local))))
                         .to(d) for s, d in enumerate(devices)], dim)


def plane_words(rows: np.ndarray, wpad: int) -> torch.Tensor:
    """Packed BQ rows [b, row_bytes] as the kernels' int32 bit planes
    [wpad, b], zero words past the row's."""
    planes = bq_ops.rows_to_planes(rows)
    if planes.shape[0] < wpad:
        planes = np.pad(planes, ((0, wpad - planes.shape[0]), (0, 0)))
    return torch.from_numpy(np.ascontiguousarray(planes).view(np.int32))


def _write_meta(meta_path, metadata) -> None:
    meta_dir = os.path.dirname(os.fspath(meta_path))
    if meta_dir:
        os.makedirs(meta_dir, exist_ok=True)
    with open(meta_path, "w") as f:
        json.dump(metadata.to_json(), f)


def _read_meta(meta_cls, meta_path):
    try:
        with open(meta_path) as f:
            return meta_cls.from_json(json.load(f))
    except (OSError, json.JSONDecodeError, KeyError) as e:
        raise StorageIOError(f"cannot read metadata {meta_path}: {e}") from e


def _open_blob(data_path, n: int, row_size: int):
    """The blob's [n, row_size] rows as a read-only memory map (None when
    empty), after the reference's exact-size check."""
    expected = n * row_size
    actual = os.path.getsize(data_path)
    if actual != expected:
        raise StorageIOError(
            f"file size {actual} does not match expected "
            f"{expected} ({n} rows x {row_size} bytes)"
        )
    return np.memmap(data_path, np.uint8, "r").reshape(n, row_size) if n else None


# ---------------------------------------------------------------- merges


def gathered_topk_merge(
    s: Sequence[torch.Tensor],  # per shard [Q, kk]: local top scores
    gi: Sequence[torch.Tensor],  # per shard [Q, kk]: matching GLOBAL ids
    axis: str,
    k: int,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-shard tail: each shard's [Q, kk] rows go to ``device`` (default:
    the first shard's) without blocking, are concatenated in shard order
    along ``axis`` and merged exactly, k padded with -inf / -1. The sort is
    stable, so ties resolve in shard order, as ``jax.lax.top_k`` resolves
    them over the gathered columns."""
    device = s[0].device if device is None else device
    s_all = torch.cat([_to(x, device) for x in s], dim=1)
    gi_all = torch.cat([_to(x, device).to(torch.int32) for x in gi], dim=1)
    vals, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    kk = min(k, s_all.shape[1])
    return _pad_k(vals[:, :kk], torch.gather(gi_all, 1, pos[:, :kk]), k)


def _merge(parts, q: int, k: int, device, axis: str):
    """``gathered_topk_merge`` of the live shards' (scores, global ids); all
    -inf / -1 when no shard holds a row."""
    if not parts:
        return _pad_k(torch.empty((q, 0), dtype=torch.float32, device=device),
                      torch.empty((q, 0), dtype=torch.int32, device=device), k)
    return gathered_topk_merge([p[0] for p in parts], [p[1] for p in parts], axis, k,
                               device=device)


def local_topk_merge(
    scores: Sequence[torch.Tensor],  # per shard [Q, n]: its first n rows' scores
    axis: str,
    k: int,
    count: int,
    method: str = "exact",
    recall_target: float = 0.95,
    *,
    n_local: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared tail of a sharded score matrix: mask rows >= ``count``, local
    top-k per shard, gathered merge. Shard i's scores cover global rows
    ``i * n_local ..`` (``n_local`` defaults to the first shard's width).
    ``method="approx"`` selects exactly, as every score-then-select path of
    the port does (ROADMAP F9). The engines below select each shard in
    blocks (``blocked_topk``), so a shard's [Q, n_local] matrix is never
    whole; this is the form for a caller that holds the matrices."""
    check_recall_target(recall_target)
    n_local = scores[0].shape[1] if n_local is None else n_local
    device = scores[0].device if device is None else device
    parts = []
    for s, sc in enumerate(scores):
        nv = max(0, min(count - s * n_local, sc.shape[1]))
        if nv:
            v, li = torch.topk(sc[:, :nv], min(k, nv), dim=1)
            parts.append(_global_ids(v, li, s, n_local, nv))
    return _merge(parts, scores[0].shape[0], k, device, axis)


def _owned_rows_psum(arr_shards, ids, rows_axis: int, *, device):
    """arr[ids] along ``rows_axis`` on ``device``: every shard gathers the
    requested rows it owns and one select per shard completes the
    distributed gather (the JAX package's psum of owned rows). ``ids`` must
    be pre-clipped to [0, count), so each is owned by exactly one shard."""
    n_local = arr_shards[0].shape[rows_axis]
    gathered = []
    for s, a in enumerate(arr_shards):
        lid = _to(ids, a.device) - s * n_local
        owned = (lid >= 0) & (lid < n_local)
        rows = torch.index_select(a, rows_axis, lid.clamp(0, n_local - 1).long())
        gathered.append((rows, owned))
    shape = list(arr_shards[0].shape)
    shape[rows_axis] = ids.shape[0]
    out = torch.zeros(shape, dtype=arr_shards[0].dtype, device=device)
    mask_shape = [1] * len(shape)
    mask_shape[rows_axis] = -1
    for rows, owned in gathered:
        out = torch.where(_to(owned, device).reshape(mask_shape), _to(rows, device), out)
    return out


def _owned_scores_psum(scores, owned, *, shape, device):
    """Merge per-shard owned-candidate scores: each candidate takes the
    score of the shard that owns it. A candidate id owned by NO shard
    (negative / >= count padding ids, which coarse approx stages can emit)
    scores -inf, not 0.0 — with ``invert`` metrics all real scores are
    negative, so a silent 0.0 would rank garbage first in the downstream
    top-k."""
    out = torch.full(tuple(shape), NEG_INF, dtype=torch.float32, device=device)
    for sc, ow in zip(scores, owned):
        out = torch.where(_to(ow, device), _to(sc, device), out)
    return out


# ------------------------------------------------------------------ base


class _ShardedBase:
    """Common state: the corpus's metadata and the mesh. A wrapped
    single-device quantizer is not kept: its arrays are re-laid as shards,
    and queries are encoded from the metadata, as on the single-device
    class."""

    def __init__(self, metadata, mesh: Optional[Mesh], axis: str):
        self.mesh = mesh if mesh is not None else make_mesh()
        if axis not in self.mesh.axis_names:
            raise ArgumentsError(f"mesh has no axis {axis!r} (axes {self.mesh.axis_names})")
        self.axis = axis
        self.metadata = metadata
        self.params = self.metadata.vector_parameters
        self.count = self.params.count
        self.n_shards = self.mesh.shape[axis]
        self.device = self.mesh.first_device

    def top_k(self, equery, k: int, method: str = "exact", recall_target=None):
        s, i = self.top_k_device(equery, k, method=method, recall_target=recall_target)
        return s.cpu().numpy(), i.cpu().numpy()

    def score_internal(self, i: int, j: int) -> float:
        """Scalar parity shim over score_internal_batch (the trait method
        of encoded_vectors.rs:34)."""
        out = self.score_internal_batch(np.asarray([i]), np.asarray([j]))
        return float(out.reshape(-1)[0])

    def _shard_dim(self, n: int, tile: int = 1) -> int:
        """Pad the corpus axis so every shard is a multiple of ``tile`` (the
        port's kernels take tile-aligned shards; the padding is never
        scored: each shard's kernels take its own n_valid)."""
        return self._shard_dim_for(self.mesh, self.axis, n, tile)

    @staticmethod
    def _shard_dim_for(mesh: Mesh, axis: str, n: int, tile: int) -> int:
        step = mesh.shape[axis] * tile
        return max(n + (-n) % step, step)

    def _devices(self):
        return self.mesh.shard_devices(self.axis)

    def _clipped(self, ids) -> torch.Tensor:
        return as_ids(ids, self.device).clamp(0, max(self.count - 1, 0))

    def _write_blob_sharded(self, path, arr: ShardedArray, axis_dim: int, row_writer,
                            row_size: int):
        """Write the reference blob shard by shard: ``row_writer(data_np, s)``
        converts shard s's valid slice to file rows; shards past ``count``
        (padding) are skipped."""
        n = self.count
        with open(path, "wb") as f:
            f.truncate(n * row_size)
            for s, t in enumerate(arr.shards):
                r0 = s * arr.n_local
                if r0 >= n:
                    continue
                valid = min(arr.n_local, n - r0)
                rows = row_writer(t.narrow(axis_dim, 0, valid).cpu().numpy(), s)
                f.seek(r0 * row_size)
                f.write(rows.tobytes())


# --------------------------------------------------------------------- SQ


class ShardedScalarQuantizer(_ShardedBase):
    """SQ corpus sharded over the mesh: codes int8[N/s, D] per shard."""

    def __init__(self, quantizer: ScalarQuantizerU8, mesh: Optional[Mesh] = None,
                 axis: str = "shard"):
        super().__init__(quantizer.metadata, mesh, axis)
        n_pad = self._shard_dim(self.count, sq_kernel.TILE_N)
        devices = self._devices()
        self.codes = _shard_rows(quantizer.codes, self.count, n_pad, devices, 0)
        self.voffsets = _shard_rows(quantizer.voffsets, self.count, n_pad, devices, 0)
        self._mult = _to(quantizer._mult, self.device)

    @classmethod
    def _from_parts(cls, codes: ShardedArray, voffsets: ShardedArray, metadata: SQMetadata,
                    mesh: Mesh, axis: str) -> "ShardedScalarQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, metadata, mesh, axis)
        obj.codes = codes
        obj.voffsets = voffsets
        obj._mult = torch.tensor([metadata.multiplier], dtype=torch.float32,
                                 device=obj.device)
        return obj

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        quantile: Optional[float] = None,
        stop_condition=None,
        batch_size: int = 65536,
        seed: int = 0,
    ) -> "ShardedScalarQuantizer":
        """Sharded-native streaming encode: calibrate over the batch stream,
        then quantize batch by batch on the mesh's first device, each batch
        committed straight into the shards it spans — the corpus never
        gathers on one device. Cancellation is checked between batches (≙
        stop_condition, encoded_vectors_u8.rs:74). The codes equal the
        single-device encode's byte for byte."""
        mesh = mesh if mesh is not None else make_mesh()

        def batches():
            return iter_batches(data, batch_size)

        meta = sq_model.sq_metadata(batches, params, quantile, stop_condition, seed)
        lane = meta.actual_dim + (-meta.actual_dim) % sq_ops.LANE
        npad = cls._shard_dim_for(mesh, axis, params.count, sq_kernel.TILE_N)
        codes_app = DeviceAppender((npad, lane), torch.int8, mesh=mesh, mesh_axis=axis)
        voff_app = DeviceAppender((npad,), torch.float32, mesh=mesh, mesh_axis=axis)
        for cb, vb in sq_model.quantized_batches(batches(), meta, stop_condition,
                                                 mesh.first_device):
            codes_app.append(cb)
            voff_app.append(vb)
        return cls._from_parts(codes_app.finish(), voff_app.finish(), meta, mesh, axis)

    def encode_query(self, queries) -> EncodedQueryU8:
        return sq_model.encode_queries(queries, self.metadata, self.codes.shape[1], self.device)

    def top_k_device(self, equery: EncodedQueryU8, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        check_recall_target(recall_target)
        return _sq_sharded_topk(
            equery.codes, equery.offsets, self.codes, self.voffsets, self._mult,
            mesh=self.mesh, axis=self.axis, k=k, count=self.count,
            distance_type=self.params.distance_type, method=method,
        )

    def score_candidates(self, equery: EncodedQueryU8, cand) -> torch.Tensor:
        """[Q, R] scores for global candidate ids: each shard rescores the
        ids it owns through K4; an id no shard owns (< 0 or >= count)
        scores -inf."""
        return _sq_sharded_score_candidates(
            equery.codes, equery.offsets, self.codes, self.voffsets, self._mult,
            as_ids(cand, self.device, torch.int32),
            mesh=self.mesh, count=self.count, distance_type=self.params.distance_type,
        )

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        """[P] stored-vs-stored scores (encoded_vectors.rs:34 /
        encoded_vectors_u8.rs:386-453) with the corpus sharded: each pair's
        rows are gathered from their owning shards, then scored on the
        mesh's first device. Ids are clipped to [0, count)."""
        m = self.metadata
        diff = m.actual_dim * m.offset * m.offset
        diff = -diff if self.params.invert else diff
        return _sq_sharded_score_internal(
            self._clipped(ids_a), self._clipped(ids_b), self.codes, self.voffsets,
            self._mult, diff, mesh=self.mesh, distance_type=self.params.distance_type,
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        """Reference two-file format (encoded_vectors_u8.rs:263-271), the blob
        written shard by shard — no single-device gather."""
        _write_meta(meta_path, self.metadata)
        m = self.metadata
        row_size = m.actual_dim + 4

        def rows_of(codes_np, s):
            v = codes_np.shape[0]
            rows = np.zeros((v, row_size), np.uint8)
            rows[:, 4:] = codes_np[:, : m.actual_dim].view(np.uint8)
            voff = self.voffsets.shards[s][:v].cpu().numpy().astype(np.float32)
            rows[:, :4] = voff.view(np.uint8).reshape(v, 4)
            return rows

        self._write_blob_sharded(data_path, self.codes, 0, rows_of, row_size)

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters,
             mesh: Optional[Mesh] = None, axis: str = "shard") -> "ShardedScalarQuantizer":
        """Load the reference two-file format shard by shard: each shard reads
        only its slice of the blob (a memory map) and goes straight to its
        devices."""
        mesh = mesh if mesh is not None else make_mesh()
        meta = _read_meta(SQMetadata, meta_path)
        n = params.count
        mm = _open_blob(data_path, n, meta.actual_dim + 4)
        lane = meta.actual_dim + (-meta.actual_dim) % sq_ops.LANE
        devices = mesh.shard_devices(axis)
        n_local = cls._shard_dim_for(mesh, axis, n, sq_kernel.TILE_N) // len(devices)

        def codes_of(r0, v):
            out = np.zeros((n_local, lane), np.int8)
            if v:
                out[:v, : meta.actual_dim] = mm[r0 : r0 + v, 4:].view(np.int8)
            return out

        def voff_of(r0, v):
            out = np.zeros((n_local,), np.float32)
            if v:
                out[:v] = mm[r0 : r0 + v, :4].copy().view(np.float32).reshape(v)
            return out

        return cls._from_parts(_load_shards(codes_of, n, n_local, devices, 0),
                               _load_shards(voff_of, n, n_local, devices, 0), meta, mesh, axis)


def _sq_sharded_topk(
    qcodes, qoff, codes: ShardedArray, voff: ShardedArray, multiplier, *, mesh, axis, k,
    count, distance_type, method="exact",
):
    """Per shard: the fused search (K1 exact / K2 approx) while kk fits its
    cap, else the score matrix (K3; K12 for L1) selected in blocks; then the
    gathered merge. Each shard passes its own n_valid (its rows < count)."""
    n_local = codes.n_local
    kk = min(k, n_local)
    fused = distance_type != DistanceType.L1 and kk <= (
        APPROX_K_MAX if method == "approx" else FUSED_K_MAX)
    ops = _per_device([c.device for c in codes.shards], qcodes, qoff, multiplier)
    parts = []
    for s, nv in _live_shards(count, n_local, codes.n_shards):
        c, vo = codes.shards[s], voff.shards[s]
        qc, qo, mult = ops[c.device]
        if fused:
            v, li = sq_kernel.sq_search(qc, qo, c, vo, mult, distance_type=distance_type,
                                        n_valid=nv, k=kk, mode=method)
        else:

            def block(b0, b1, qc=qc, qo=qo, c=c, vo=vo, mult=mult):
                end = min(b1 + (b0 - b1) % sq_kernel.TILE_N, n_local)
                return sq_kernel.sq_scores(qc, qo, c[b0:end], vo[b0:end], mult,
                                           distance_type=distance_type, n_valid=b1 - b0)

            v, li = blocked_topk(block, nv, kk, method)
        parts.append(_global_ids(v, li, s, n_local, nv))
    return _merge(parts, qcodes.shape[0], k, mesh.first_device, axis)


def _sq_sharded_score_candidates(
    qcodes, qoff, codes: ShardedArray, voff: ShardedArray, multiplier, cand, *, mesh, count,
    distance_type,
):
    n_local = codes.n_local
    ops = _per_device([c.device for c in codes.shards], qcodes, qoff, multiplier, cand)
    scores, owned = [], []
    for s, nv in _live_shards(count, n_local, codes.n_shards):
        qc, qo, mult, cd = ops[codes.shards[s].device]
        local = cd - s * n_local
        # K4 scores an id outside [0, nv) -inf without reading it.
        scores.append(gather.sq_score_candidates(
            qc, qo, codes.shards[s], voff.shards[s], local, mult,
            distance_type=distance_type, n_valid=nv))
        owned.append((local >= 0) & (local < nv))
    return _owned_scores_psum(scores, owned, shape=cand.shape, device=mesh.first_device)


def _sq_sharded_score_internal(ia, ib, codes: ShardedArray, voff: ShardedArray, mult, diff, *,
                               mesh, distance_type):
    dev = mesh.first_device

    def full_rows(ids):
        return (_owned_rows_psum(codes.shards, ids, 0, device=dev),
                _owned_rows_psum(voff.shards, ids, 0, device=dev))

    ca, va = full_rows(ia)
    cb, vb = full_rows(ib)
    return sq_ops.score_internal_batch(ca, va, cb, vb, mult, diff,
                                       distance_type=distance_type)


# --------------------------------------------------------------------- BQ


class ShardedBinaryQuantizer(_ShardedBase):
    """BQ bit-planes sharded over the corpus axis: int32[W8, N/s] per shard
    (uint32 bits, ``ops/bq.py``), each shard a multiple of the kernels'
    2048-row tile."""

    def __init__(self, quantizer: BinaryQuantizer, mesh: Optional[Mesh] = None,
                 axis: str = "shard"):
        super().__init__(quantizer.metadata, mesh, axis)
        self.store_type = quantizer.store_type
        n_pad = self._shard_dim(self.count, bq_kernel.TILE_N)
        self.planes = _shard_rows(quantizer.planes, self.count, n_pad, self._devices(), 1)

    @classmethod
    def _from_parts(cls, planes: ShardedArray, metadata: BQMetadata, mesh: Mesh, axis: str,
                    store_type: str) -> "ShardedBinaryQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, metadata, mesh, axis)
        obj.planes = planes
        obj.store_type = store_type
        return obj

    @staticmethod
    def _wpad(row_bytes: int) -> int:
        w = (row_bytes + 3) // 4
        return max(w + (-w) % bq_kernel.W_ALIGN, bq_kernel.W_ALIGN)

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        stop_condition=None,
        batch_size: int = 65536,
        store_type: str = "u128",
    ) -> "ShardedBinaryQuantizer":
        """Streaming sharded-native sign-bit packing
        (encoded_vectors_binary.rs:165-191 semantics): each batch packed on
        the host and its planes copied straight into the shards it spans.
        The planes equal the single-device encode's byte for byte."""
        mesh = mesh if mesh is not None else make_mesh()
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        wpad = cls._wpad(row_bytes)
        npad = cls._shard_dim_for(mesh, axis, params.count, bq_kernel.TILE_N)
        app = DeviceAppender((wpad, npad), torch.int32, mesh=mesh, mesh_axis=axis, axis=1)
        for rows in bq_model.packed_batches(data, params, batch_size, row_bytes, stop_condition):
            app.append(plane_words(rows, wpad))
        return cls._from_parts(app.finish(), BQMetadata(params), mesh, axis, store_type)

    def encode_query(self, queries) -> EncodedQueryBin:
        return bq_model.encode_queries(queries, self.params.dim, self.store_type,
                                       self.planes.shape[0], self.device)

    def _kw(self) -> dict:
        p = self.params
        return dict(distance_type=p.distance_type, invert=p.invert, dim=p.dim)

    def top_k_device(self, equery: EncodedQueryBin, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        check_recall_target(recall_target)
        return _bq_sharded_topk(
            equery.planes, self.planes, mesh=self.mesh, axis=self.axis, k=k,
            count=self.count, method=method, **self._kw(),
        )

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        """[P] Hamming-metric scores between stored rows, their plane columns
        gathered from the owning shards (encoded_vectors_binary.rs:302)."""
        return _bq_sharded_score_internal(
            self._clipped(ids_a), self._clipped(ids_b), self.planes, mesh=self.mesh,
            **self._kw(),
        )

    def score_candidates(self, equery: EncodedQueryBin, cand) -> torch.Tensor:
        """[Q, R] scores of global candidate ids; an id no shard owns scores
        -inf, where the single-device BinaryQuantizer wraps -1 to the last
        padded column, as the JAX package's two classes do (ROADMAP F13)."""
        return _bq_sharded_score_candidates(
            equery.planes, self.planes, as_ids(cand, self.device), mesh=self.mesh,
            count=self.count, **self._kw(),
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        _write_meta(meta_path, self.metadata)
        row_bytes = bq_ops.storage_bytes(self.params.dim, self.store_type)
        self._write_blob_sharded(
            data_path, self.planes, 1,
            lambda planes_np, s: bq_ops.planes_to_rows(planes_np.view(np.uint32), row_bytes),
            row_bytes,
        )

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters,
             mesh: Optional[Mesh] = None, axis: str = "shard",
             store_type: str = "u128") -> "ShardedBinaryQuantizer":
        mesh = mesh if mesh is not None else make_mesh()
        meta = _read_meta(BQMetadata, meta_path)
        row_bytes = bq_ops.storage_bytes(params.dim, store_type)
        n = params.count
        mm = _open_blob(data_path, n, row_bytes)
        wpad = cls._wpad(row_bytes)
        devices = mesh.shard_devices(axis)
        n_local = cls._shard_dim_for(mesh, axis, n, bq_kernel.TILE_N) // len(devices)

        def planes_of(c0, v):
            out = np.zeros((wpad, n_local), np.uint32)
            if v:
                planes = bq_ops.rows_to_planes(np.ascontiguousarray(mm[c0 : c0 + v]))
                out[: planes.shape[0], :v] = planes
            return out.view(np.int32)

        return cls._from_parts(_load_shards(planes_of, n, n_local, devices, 1), meta, mesh,
                               axis, store_type)


def _bq_sharded_topk(
    qplanes, planes: ShardedArray, *, mesh, axis, k, count, distance_type, invert, dim,
    method="exact",
):
    """Per shard: the fused search (K5c exact / K5a approx) while kk fits its
    cap, else the score matrix (K6) selected in blocks; then the gathered
    merge."""
    n_local = planes.n_local
    kk = min(k, n_local)
    fused = kk <= (APPROX_K_MAX if method == "approx" else FUSED_K_MAX)
    kw = dict(distance_type=distance_type, invert=invert, dim=dim)
    ops = _per_device([p.device for p in planes.shards], qplanes)
    parts = []
    for s, nv in _live_shards(count, n_local, planes.n_shards):
        pl = planes.shards[s]
        (qp,) = ops[pl.device]
        if fused:
            v, li = bq_kernel.bq_search(qp, pl, n_valid=nv, k=kk, mode=method, **kw)
        else:

            def block(b0, b1, qp=qp, pl=pl):
                end = min(b1 + (b0 - b1) % bq_kernel.TILE_N, n_local)
                return bq_kernel.bq_scores(qp, pl[:, b0:end].contiguous(), n_valid=b1 - b0,
                                           **kw)

            v, li = blocked_topk(block, nv, kk, method)
        parts.append(_global_ids(v, li, s, n_local, nv))
    return _merge(parts, qplanes.shape[0], k, mesh.first_device, axis)


def _bq_sharded_score_candidates(qplanes, planes: ShardedArray, cand, *, mesh, count,
                                 distance_type, invert, dim):
    n_local = planes.n_local
    ops = _per_device([p.device for p in planes.shards], qplanes, cand)
    scores, owned = [], []
    for s, nv in _live_shards(count, n_local, planes.n_shards):
        qp, cd = ops[planes.shards[s].device]
        local = cd - s * n_local
        scores.append(bq_ops.score_candidates(
            qp, planes.shards[s], local.clamp(0, n_local - 1),
            distance_type=distance_type, invert=invert, dim=dim))
        owned.append((local >= 0) & (local < nv))
    return _owned_scores_psum(scores, owned, shape=cand.shape, device=mesh.first_device)


def _bq_sharded_score_internal(ia, ib, planes: ShardedArray, *, mesh, distance_type, invert,
                               dim):
    dev = mesh.first_device
    a = _owned_rows_psum(planes.shards, ia, 1, device=dev)  # [W, P]
    b = _owned_rows_psum(planes.shards, ib, 1, device=dev)
    xor = bq_ops.popcount32(a ^ b).sum(dim=0)
    return bq_ops.metric_from_xor(xor, distance_type=distance_type, invert=invert, dim=dim)


# --------------------------------------------------------------------- PQ


class ShardedProductQuantizer(_ShardedBase):
    """PQ codes sharded over the corpus axis in the kernels' transposed
    layout, u8[Mpad, N/s] per shard; the LUT, the centroids and an OPQ
    rotation live on the mesh's first device, and each query's LUT is
    copied once to every shard device."""

    def __init__(self, quantizer: ProductQuantizer, mesh: Optional[Mesh] = None,
                 axis: str = "shard"):
        super().__init__(quantizer.metadata, mesh, axis)
        n_pad = self._shard_dim(self.count, pq_kernel.TILE_N)
        self.num_chunks = quantizer.num_chunks
        self.codes_t = _shard_rows(quantizer.codes_t, self.count, n_pad, self._devices(), 1)
        self._c_chunks = _to(quantizer._c_chunks, self.device)
        self._rot = None if quantizer._rot is None else _to(quantizer._rot, self.device)
        self._cdist = None

    @classmethod
    def _from_parts(cls, codes_t: ShardedArray, metadata: PQMetadata, mesh: Mesh,
                    axis: str) -> "ShardedProductQuantizer":
        obj = cls.__new__(cls)
        _ShardedBase.__init__(obj, metadata, mesh, axis)
        obj.codes_t = codes_t
        obj.num_chunks = len(metadata.vector_division)
        obj._c_chunks = torch.from_numpy(pq_ops.centroids_to_chunks(
            np.asarray(metadata.centroids), metadata.vector_division)).to(obj.device)
        obj._rot = (None if metadata.rotation is None
                    else torch.as_tensor(metadata.rotation, dtype=torch.float32,
                                         device=obj.device))
        obj._cdist = None
        return obj

    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        chunk_size: int,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        stop_condition=None,
        batch_size: int = 16384,
        seed: int = 0,
        bits: int = 8,
        rotation=None,
    ) -> "ShardedProductQuantizer":
        """Streaming sharded-native PQ: k-means on a sample on the mesh's
        first device (centroids are tiny), then nearest-centroid codes
        committed batch by batch into the sharded transposed code buffer.
        ``rotation`` enables OPQ exactly as on the single-device class
        (models/pq.py); with the same data and seed the centroids, rotation
        and codes are the single-device encode's."""
        mesh = mesh if mesh is not None else make_mesh()
        dev = mesh.first_device

        def batches():
            return iter_batches(data, batch_size)

        meta, c_chunks, rot_t = ProductQuantizer._codebook(
            batches, params, chunk_size, stop_condition, seed, bits, rotation, dev)
        m = len(meta.vector_division)
        mpad = max(m + (-m) % pq_kernel.M_BLK, pq_kernel.M_BLK)
        npad = cls._shard_dim_for(mesh, axis, params.count, pq_kernel.TILE_N)
        app = DeviceAppender((mpad, npad), torch.uint8, mesh=mesh, mesh_axis=axis, axis=1)
        for codes in pq_model.encoded_batches(batches(), meta, c_chunks, rot_t, stop_condition,
                                              dev):
            app.append(pad_dim_to(codes.T, 0, mpad))
        return cls._from_parts(app.finish(), meta, mesh, axis)

    def encode_query(self, queries) -> EncodedQueryPQ:
        return pq_model.encode_queries(queries, self.metadata, self._c_chunks, self._rot,
                                       self.device)

    def top_k_device(self, equery: EncodedQueryPQ, k: int, method: str = "exact",
                     recall_target: Optional[float] = None):
        """Per shard the fused search with the LUT word ``lut_precision()``
        names, read at each call as on the single-device class; beyond the
        fused caps the score matrix (K8) with that word at any count, where
        the single-device class turns to the f32 LUT past ``BLOCK_ROWS``
        (ROADMAP F31)."""
        check_recall_target(recall_target)
        return _pq_sharded_topk(
            equery.lut, self.codes_t, mesh=self.mesh, axis=self.axis, k=k,
            count=self.count, method=method, precision=pq_kernel.lut_precision(),
        )

    def score_candidates(self, equery: EncodedQueryPQ, cand) -> torch.Tensor:
        return _pq_sharded_score_candidates(
            equery.lut, self.codes_t, as_ids(cand, self.device), mesh=self.mesh,
            count=self.count, num_chunks=self.num_chunks,
        )

    def _centroid_distances(self) -> torch.Tensor:
        if self._cdist is None:
            self._cdist = pq_ops.centroid_distance_table(
                self._c_chunks, distance_type=self.params.distance_type,
                invert=self.params.invert,
            )
        return self._cdist

    def score_internal_batch(self, ids_a, ids_b) -> torch.Tensor:
        """[P] stored-vs-stored scores via the centroid-distance table
        (encoded_vectors_pq.rs semantics): each pair's code columns are
        gathered from their owning shards, then looked up on the mesh's
        first device."""
        return _pq_sharded_score_internal(
            self._clipped(ids_a), self._clipped(ids_b), self.codes_t,
            self._centroid_distances(), mesh=self.mesh, num_chunks=self.num_chunks,
        )

    # ----------------------------------------------------------- checkpoint
    def save(self, data_path, meta_path) -> None:
        _write_meta(meta_path, self.metadata)
        m = self.num_chunks
        bits4 = self.metadata.bits == 4
        row_size = (m + 1) // 2 if bits4 else m

        def writer(ct_np, s):
            rows = np.ascontiguousarray(ct_np[:m].T)
            if bits4:
                # Two 4-bit codes per byte, the single-device layout, so
                # sharded and single-device blobs interoperate.
                if rows.shape[1] % 2:
                    rows = np.pad(rows, ((0, 0), (0, 1)))
                rows = (rows[:, 0::2] | (rows[:, 1::2] << 4)).astype(np.uint8)
            return rows

        self._write_blob_sharded(data_path, self.codes_t, 1, writer, row_size)

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters,
             mesh: Optional[Mesh] = None, axis: str = "shard") -> "ShardedProductQuantizer":
        mesh = mesh if mesh is not None else make_mesh()
        meta = _read_meta(PQMetadata, meta_path)
        m = len(meta.vector_division)
        n = params.count
        row_size = m if meta.bits == 8 else (m + 1) // 2
        mm = _open_blob(data_path, n, row_size)
        mpad = max(m + (-m) % pq_kernel.M_BLK, pq_kernel.M_BLK)
        devices = mesh.shard_devices(axis)
        n_local = cls._shard_dim_for(mesh, axis, n, pq_kernel.TILE_N) // len(devices)

        def codes_of(c0, v):
            out = np.zeros((mpad, n_local), np.uint8)
            if v:
                rows = mm[c0 : c0 + v]
                if meta.bits == 4:
                    # Nibble pairs, low nibble the even chunk
                    # (ProductQuantizer.load).
                    un = np.empty((v, row_size * 2), np.uint8)
                    un[:, 0::2] = rows & 0x0F
                    un[:, 1::2] = rows >> 4
                    rows = un[:, :m]
                out[:m, :v] = rows.T
            return out

        return cls._from_parts(_load_shards(codes_of, n, n_local, devices, 1), meta, mesh,
                               axis)


def _pq_sharded_topk(
    lut, codes_t: ShardedArray, *, mesh, axis, k, count, method="exact", precision=None,
):
    """Per shard: the fused search (K7b exact / K7a approx; 4-bit codes with
    the int8 LUT on the one-hot route) while kk fits its cap, else the score
    matrix (K8) selected in blocks; then the gathered merge."""
    n_local = codes_t.n_local
    kk = min(k, n_local)
    fused = kk <= (APPROX_K_MAX if method == "approx" else FUSED_K_MAX)
    ops = _per_device([c.device for c in codes_t.shards], lut)
    parts = []
    for s, nv in _live_shards(count, n_local, codes_t.n_shards):
        ct = codes_t.shards[s]
        (lt,) = ops[ct.device]
        if fused:
            v, li = pq_kernel.pq_search(lt, ct, n_valid=nv, k=kk, mode=method,
                                        precision=precision)
        else:

            def block(b0, b1, lt=lt, ct=ct):
                end = min(b1 + (b0 - b1) % pq_kernel.TILE_N, n_local)
                return pq_kernel.pq_scores(lt, ct[:, b0:end].contiguous(), n_valid=b1 - b0,
                                           precision=precision)

            v, li = blocked_topk(block, nv, kk, method)
        parts.append(_global_ids(v, li, s, n_local, nv))
    return _merge(parts, lut.shape[0], k, mesh.first_device, axis)


def _pq_sharded_score_candidates(lut, codes_t: ShardedArray, cand, *, mesh, count,
                                 num_chunks):
    n_local = codes_t.n_local
    ops = _per_device([c.device for c in codes_t.shards], lut, cand)
    scores, owned = [], []
    for s, nv in _live_shards(count, n_local, codes_t.n_shards):
        lt, cd = ops[codes_t.shards[s].device]
        local = cd - s * n_local
        scores.append(pq_ops.score_candidates_lut(
            lt, codes_t.shards[s].T[:, :num_chunks], local.clamp(0, n_local - 1)))
        owned.append((local >= 0) & (local < nv))
    return _owned_scores_psum(scores, owned, shape=cand.shape, device=mesh.first_device)


def _pq_sharded_score_internal(ia, ib, codes_t: ShardedArray, cdist, *, mesh, num_chunks):
    dev = mesh.first_device

    def code_rows(ids):
        cols = _owned_rows_psum(codes_t.shards, ids, 1, device=dev)  # [Mpad, P]
        # Row-major, as the single-device rows are: the table lookup's sum
        # over chunks runs in the order of its index's layout.
        return cols.T[:, :num_chunks].contiguous()

    return pq_ops.score_internal_lut(cdist, code_rows(ia), code_rows(ib))


# ------------------------------------------------------------ f32 rescorer


class ShardedExactRescorer:
    """f32 rescoring stage with the original vectors sharded over the
    points axis — the sharded counterpart of models.pipeline.ExactRescorer,
    for two-stage configurations whose f32 corpus exceeds one device.
    ``data`` is a numpy array (or memmap) or a tensor; each shard copies
    only its rows to its devices."""

    def __init__(
        self,
        data,
        distance_type: DistanceType,
        invert: bool,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        self._dt = distance_type
        self._invert = invert
        self.device = self.mesh.first_device
        devices = self.mesh.shard_devices(axis)
        if isinstance(data, torch.Tensor):
            t = data.to(torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(data, np.float32)))
        self.count = t.shape[0]
        n = len(devices)
        npad = max(self.count + (-self.count) % n, n)
        self._data = _shard_rows(t, self.count, npad, devices, 0)

    def encode_query(self, queries) -> torch.Tensor:
        q = upload(np.asarray(queries, np.float32), self.device)
        return q[None, :] if q.ndim == 1 else q

    def score_candidates(self, equery, cand) -> torch.Tensor:
        """[Q, R] exact scores of per-query candidates; -inf for an id no
        shard owns (< 0 or >= count)."""
        return _exact_sharded_score_candidates(
            equery, self._data, as_ids(cand, self.device), mesh=self.mesh, count=self.count,
            distance_type=self._dt, invert=self._invert,
        )


def _exact_sharded_score_candidates(queries, data: ShardedArray, cand, *, mesh, count,
                                    distance_type, invert):
    n_local = data.n_local
    ops = _per_device([d.device for d in data.shards], queries, cand)
    scores, owned = [], []
    for s, nv in _live_shards(count, n_local, data.n_shards):
        q, cd = ops[data.shards[s].device]
        local = cd - s * n_local
        g = data.shards[s][local.clamp(0, n_local - 1)]  # [Q, R, D]
        scores.append(_score(q[:, None, :], g, distance_type, invert))
        owned.append((local >= 0) & (local < nv))
    return _owned_scores_psum(scores, owned, shape=cand.shape, device=mesh.first_device)
