"""ShardedIVF — probe-limited IVF search over a device mesh.

Twin of ``quantization_tpu/parallel/sharded_ivf.py``. The corpus is clustered
into buckets (``models/ivf.py``) AND the bucket axis is sharded over the
mesh's ``shard`` axis, so a search scans only the probed fraction of the rows
and each shard scans only its own buckets. Each shard's (kk2 scores, kk2
global ids) go to the mesh's first device, are concatenated in shard order
(the JAX package's tiled ``all_gather``) and deduped by id once. The port is
single-controller, as ``parallel/sharded.py`` is: one process owns the mesh,
launches every shard's kernels on that shard's device (all of them before the
merge copies) and merges.

Nothing in the class's life gathers the corpus or its codes on one device:

  * ``ShardedIVF.encode`` streams host batches: coarse centers trained on a
    sample, every batch assigned on the device, then inner-encoded and
    committed straight to its rows' bucket slots in per-shard buffers
    (``utils.device_store.DeviceScatter``);
  * ``ShardedIVF.load`` reads the four-file checkpoint shard by shard, each
    shard's buckets from a memory map straight to its device;
  * ``ShardedIVF.save`` writes ``IVFIndex.save``'s four files, the inner blob
    shard by shard in the ORIGINAL bucket order (the sharding is a runtime
    layout, not a storage property);
  * ``ShardedIVF(ivf, mesh)`` re-lays a built single-device ``IVFIndex`` and
    keeps no reference to it.

Design, as the JAX package's:

* **Round-robin bucket placement.** ``build_buckets`` lays buckets out
  cluster-major, so shard ``sh`` owns original buckets ``sh, sh+ns, ...``:
  every cluster's buckets spread over the mesh. The bucket count is padded
  to a multiple of the shard count with COPIES of real buckets, so a pad
  bucket that wins a union slot costs only work; the final id dedupe drops
  the copies, and the dedupe margin counts the extra copy (``_max_dup + 1``).
* **Per-shard union quota.** The rank-fair priority (``_bucket_priority``)
  is computed once, on the mesh's first device, over the relaid means; each
  shard scans the top ``ceil(nscan / n_shards)`` of the buckets it owns.
  With ``nscan >= the bucket count`` every bucket is scanned and the result
  is the single-device full probe's.
* **The scan per shard** is the single-device glue: the indexed scan
  (``_scan_buckets_indexed``) or the compact one (``_scan_buckets_compact``),
  with the residual bucket term computed union-first against the shard's
  copy of the means. PQ always scans compact, as in the JAX package.

A shard stores its b_loc buckets' slots, BQ's plane columns padded to the
kernels' 2048-column tile (never scanned), so the kernels take a shard as
they take a single-device corpus. Residual BQ scores its pad slots NEG
through a per-slot ``rowadd``, as the single-device index does (ROADMAP F25,
F33).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.interface import checked_batches, iter_batches
from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..models import bq as bq_model
from ..models import pq as pq_model
from ..models import sq as sq_model
from ..models.bq import BQMetadata
from ..models.ivf import (
    NEG,
    IVFIndex,
    IVFMetadata,
    _bucket_priority,
    _bucket_term,
    _dedupe_select,
    _derive_slot_ids,
    _registry,
    _residual_coeffs,
    _scan_union,
    _search_plan,
    _stable_top,
    auto_geometry,
    encode_ivf_query,
)
from ..models.pq import PQMetadata, ProductQuantizer
from ..models.sq import SQMetadata
from ..ops import bq as bq_ops
from ..ops import ivf as ivf_ops
from ..ops import pq as pq_ops
from ..ops.kernels import bq_kernel
from ..ops.kernels.ktile import CORR_BLK
from ..ops.pq import full_f32
from ..ops.quantile import sample_rows
from ..utils.device_store import DeviceScatter, ShardedArray
from ..utils.padding import pad_dim_to, round_up
from .sharded import (
    Mesh, ShardedBinaryQuantizer, _open_blob, _per_device, _read_meta, _to, _write_meta,
    make_mesh, plane_words,
)

# Rows of a plain-argmin assignment block, bounding its [rows, nlist] scores.
_ASSIGN_BYTES_CAP = 1 << 31


def _round_robin_layout(b: int, ns: int):
    """``(old, is_primary, b_loc, b_pad)``: shard ``sh`` owns NEW bucket
    positions ``[sh*b_loc, (sh+1)*b_loc)`` holding ORIGINAL buckets ``sh,
    sh+ns, sh+2*ns, ...``; positions whose pre-wrap index is past ``b`` are
    pad buckets, COPIES of real buckets (``old`` wraps; ``is_primary`` marks
    the one canonical position of each original bucket)."""
    b_loc = -(-b // ns)
    b_pad = b_loc * ns
    pre = np.concatenate([np.arange(sh, b_pad, ns) for sh in range(ns)])
    return pre % b, pre < b, b_loc, b_pad


def _shard_slots(old: np.ndarray, sh: int, b_loc: int, s: int) -> np.ndarray:
    """The original-layout slots that shard ``sh`` holds, in its order."""
    return (old[sh * b_loc:(sh + 1) * b_loc, None] * s + np.arange(s)).reshape(-1)


def _shard_width(kind: str, b_loc: int, s: int) -> int:
    """Slots a shard stores: its b_loc buckets, BQ's plane columns padded to
    the kernels' 2048-column tile (the indexed scan reads a tile-aligned
    corpus). SQ needs none: its indexed tile divides a bucket, and the
    compact scans pad what they gather."""
    return round_up(b_loc * s, bq_kernel.TILE_N) if kind == "bq" else b_loc * s


def _ivf_sharded_search(q, eq, means, slot_ids: ShardedArray, inner, resid=None, *, kind, k,
                        p, u_loc, b_loc, method, dt, invert, s, dim, use_fused, kk2, itile=0,
                        precision=None, means_rep=None):
    """One sharded IVF search: the priority on the first device, each
    shard's top-``u_loc`` local buckets, each shard's scan (``_scan_union``,
    the single-device index's), the candidates concatenated in shard order
    on the first device, one dedupe.

    ``q`` / ``eq`` / ``means`` on the first device; ``inner[sh]`` shard sh's
    family arrays on its device. ``resid`` (residual indexes): ``(a,
    rowadd)``, ``rowadd`` a ShardedArray (PQ, BQ) or None (SQ); the bucket
    term a * (q . c_b) is computed per shard union-first against
    ``means_rep`` (the means on each shard's device)."""
    nq = q.shape[0]
    first = q.device
    ns = len(inner)
    devices = [slot_ids.shards[sh].device for sh in range(ns)]
    prio = _bucket_priority(q, means, dt, invert, p)  # [B_pad]
    _, union_all = _stable_top(prio.reshape(ns, b_loc), u_loc)  # local bucket indices
    ops = _per_device(devices, q, union_all, *eq)
    rc = _residual_coeffs(dt, invert)[1] if kind == "pq" else 0.0
    parts = []
    for sh in range(ns):
        qd, un_all, *eqd = ops[devices[sh]]
        union = un_all[sh]
        qc_u = rowadd = None
        if resid is not None:
            a, rowadds = resid
            qc_u = _bucket_term(qd, means_rep[devices[sh]], union + sh * b_loc, a, rc)
            rowadd = None if rowadds is None else rowadds.shards[sh]
        parts.append(_scan_union(
            kind, eqd, inner[sh], union, slot_ids.shards[sh], qc_u, rowadd, nb=b_loc, s=s,
            itile=itile, dt=dt, invert=invert, dim=dim, use_fused=use_fused, kk2=kk2,
            method=method, precision=precision))
    sv_all = torch.cat([_to(v, first) for v, _ in parts], dim=1)
    ids_all = torch.cat([_to(i, first).to(torch.int32) for _, i in parts], dim=1)
    return _dedupe_select(sv_all, ids_all, nq, k, sv_all.shape[1])


class _Tap:
    """A batch-stream factory that also queues each batch it yields, so a
    loop over a pass's outputs (which may read ahead) can pair each output
    with its input batch, in order."""

    def __init__(self, batches):
        self._batches = batches
        self.queue: deque = deque()

    def __call__(self):
        for batch in self._batches():
            self.queue.append(batch)
            yield batch


class ShardedIVF:
    """IVF index with its bucket axis sharded over a device mesh.

    Three construction paths: streaming sharded-native ``encode``, per-shard
    ``load``, or wrapping a built single-device ``IVFIndex`` (see the module
    docstring). Per shard: the inner codes (SQ rows, BQ plane columns, PQ
    rows), the slot-id map and the residual row terms; on the first device:
    the relaid bucket means (the probe targets) and the query-side metadata;
    the residual indexes copy the means once to each other device."""

    def __init__(self, ivf: IVFIndex, mesh: Optional[Mesh] = None, axis: str = "shard"):
        """Wrap (re-lay) a built single-device index. The wrapped object is
        not retained: its arrays are gathered in the round-robin order shard
        by shard, and its query-side metadata is copied out."""
        mesh = mesh if mesh is not None else make_mesh()
        _check_axis(mesh, axis)
        meta = ivf.metadata
        b, s, kind = meta.nbuckets, meta.bucket_size, meta.kind
        ns = mesh.shape[axis]
        old, _, b_loc, b_pad = _round_robin_layout(b, ns)
        width = _shard_width(kind, b_loc, s)
        devices = mesh.shard_devices(axis)
        src = ivf.device

        def relaid(x, dim=0, fill=0):
            """x's slots in the round-robin order, shard by shard, each
            padded to ``width`` and copied to its device."""
            out = []
            for sh, d in enumerate(devices):
                rows = torch.from_numpy(_shard_slots(old, sh, b_loc, s)).to(src)
                part = x.index_select(dim, rows)
                out.append(pad_dim_to(part, dim, width, value=fill).to(d).contiguous())
            return ShardedArray(out, dim)

        qz = ivf.quantizer
        voff_inner = rowadd = None
        if kind == "sq":
            # A residual index scans the derived |decoded|^2-or-NEG terms
            # and keeps the inner DOT voffsets for save.
            voff = relaid(ivf._resid_sq if meta.residual else qz.voffsets)
            inner = (relaid(qz.codes), voff)
            if meta.residual:
                voff_inner = relaid(qz.voffsets)
        elif kind == "bq":
            inner = (relaid(qz.planes, 1),)
            if meta.residual:
                rowadd = relaid(ivf._resid_bq, fill=NEG)
        else:
            codes, transposed = qz.resident_codes
            inner = (relaid(codes.T if transposed else codes),)
            if meta.residual:
                rowadd = relaid(ivf._resid_pq, fill=NEG)
        self._init_from_parts(
            mesh=mesh, axis=axis, metadata=meta, inner_meta=qz.metadata,
            bucket_ids=ivf.bucket_ids, bucket_means=ivf.bucket_means,
            slot_ids_new=_derive_slot_ids(ivf.bucket_ids, meta.vector_parameters.count)[0][old],
            inner=inner, voff_inner=voff_inner, rowadd=rowadd,
            max_dup=ivf._max_dup + (1 if b_pad > b else 0),
            store_type=getattr(qz, "store_type", "u128"))

    def _init_from_parts(self, *, mesh, axis, metadata, inner_meta, bucket_ids, bucket_means,
                         slot_ids_new, inner, voff_inner, rowadd, max_dup, store_type="u128"):
        self.mesh = mesh
        self.axis = axis
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.inner_meta = inner_meta
        self.n_shards = mesh.shape[axis]
        self.device = mesh.first_device
        b = metadata.nbuckets
        self._old, self._is_primary, self._b_loc, self._b_pad = _round_robin_layout(
            b, self.n_shards)
        self._max_dup = max_dup
        # Host copies in ORIGINAL bucket order (the storage layout; the
        # round-robin relay is runtime-only): the id mask and probe means.
        self.bucket_ids = np.asarray(bucket_ids, np.int32)
        self.bucket_means = np.asarray(bucket_means, np.float32)
        devices = mesh.shard_devices(axis)
        self._means_dev = torch.from_numpy(
            np.ascontiguousarray(self.bucket_means[self._old])).to(self.device)
        if metadata.residual and metadata.kind == "bq":
            # Residual BQ masks within-bucket pad slots (id -1), as
            # IVFIndex does: a pad duplicates a row of another bucket, whose
            # residual code is garbage against this bucket's term.
            slot_ids_new = np.where(self.bucket_ids[self._old] >= 0, slot_ids_new, -1)
        sid = np.ascontiguousarray(slot_ids_new, np.int32)
        bl = self._b_loc
        self._slot_ids = ShardedArray(
            [torch.from_numpy(sid[sh * bl:(sh + 1) * bl]).to(d) for sh, d in enumerate(devices)],
            0)
        self._inner = inner
        self._voff_inner = voff_inner  # residual SQ: the inner DOT voffsets
        self._rowadd = rowadd  # residual PQ / BQ: per-slot additive, NEG at pads
        kind = metadata.kind
        self._store_type = store_type
        self._c_chunks = self._rot = None
        if kind == "sq":
            self._mult = torch.tensor([inner_meta.multiplier], dtype=torch.float32,
                                      device=self.device)
        elif kind == "pq":
            self._c_chunks = torch.from_numpy(pq_ops.centroids_to_chunks(
                np.asarray(inner_meta.centroids), inner_meta.vector_division)).to(self.device)
            self._rot = (None if inner_meta.rotation is None
                         else torch.as_tensor(inner_meta.rotation, dtype=torch.float32,
                                              device=self.device))
        self._means_rep = None
        if metadata.residual:
            self._res_a, self._res_rowcoef = _residual_coeffs(self.params.distance_type,
                                                              self.params.invert)
            self._means_rep = {d: m for d, (m,) in _per_device(devices, self._means_dev).items()}

    # ------------------------------------------------------------- build
    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = "shard",
        quantizer: str = "sq",
        nlist: Optional[int] = None,
        bucket_size: Optional[int] = None,
        nprobe: int = 32,
        nscan: Optional[int] = None,
        seed: int = 0,
        residual: bool = False,
        stop_condition=None,
        batch_size: int = 65536,
        **quantizer_kwargs,
    ) -> "ShardedIVF":
        """Sharded-native streaming build: the corpus and its codes never
        gather on one device. ``data`` is an array or a re-iterable stream
        factory; the build passes over it a few times:

          1. sample <= 262k rows (``sample_rows``) and train the coarse
             centers on the mesh's first device;
          2. assign every row to its center there, batch by batch (a plain
             argmin of |c|^2 - 2 x.c, the JAX package's; near-ties may
             differ from ``assign_clusters``, ROADMAP F21);
          3. the bucket layout (``build_buckets``) and each row's slot in
             the round-robin layout, on the host;
          4. calibrate / train the inner quantizer over the stream (residual
             indexes over ``v - bucket mean``);
          5. encode each batch and scatter its codes to their slots in the
             per-shard buffers (``DeviceScatter``), the bucket-mean sums on
             the first device in the same pass (residual indexes: a pass
             of their own first);
          6. fill the duplicate slots (pads, pad buckets) from their primary
             rows, then the residual row terms per shard.

        Kwargs pass to the inner family: ``quantile`` (SQ), ``chunk_size`` /
        ``bits`` / ``rotation`` (PQ), ``store_type`` (BQ); the constraints
        are ``IVFIndex.encode``'s. The build host holds ~24 B a row at the
        layout step (the argsort), ~16 B a row through the encode pass."""
        mesh = mesh if mesh is not None else make_mesh()
        _check_axis(mesh, axis)
        ns = mesh.shape[axis]
        dev = mesh.first_device
        registry = _registry()
        if isinstance(quantizer, str) and quantizer in registry:
            kind = quantizer
        else:
            kind = next((kk for kk, c in registry.items() if c is quantizer), None)
            if kind is None:
                raise ArgumentsError(
                    f"quantizer must be 'sq' | 'pq' | 'bq' or a quantizer class, got "
                    f"{quantizer!r}")
        if params.count < 1:
            raise ArgumentsError("ShardedIVF needs a non-empty corpus")
        if bucket_size is None:
            bucket_size = auto_geometry(params.count, residual)[1]
        if nlist is None:
            nlist = max(1, params.count // (3 * bucket_size))
        if bucket_size < 1 or nlist < 1:
            raise ArgumentsError("nlist and bucket_size must be >= 1")
        if residual:
            if params.distance_type == DistanceType.L1:
                raise ArgumentsError("residual=True needs DOT or L2 (dot-expansion)")
            if kind == "bq" and params.distance_type != DistanceType.DOT:
                raise ArgumentsError(
                    "residual=True with quantizer 'bq' supports DOT only (the L2 expansion "
                    "needs a per-slot |v^|^2 additive, which the 1-bit plane layout has no "
                    "carrier for)")
            if bucket_size % CORR_BLK:
                raise ArgumentsError(
                    f"residual=True needs bucket_size to be a multiple of {CORR_BLK}, "
                    f"got {bucket_size}")
        n, dim, s = params.count, params.dim, int(bucket_size)

        def batches():
            return iter_batches(data, batch_size)

        # 1. sample + coarse centers (the sampling caps of IVFIndex.encode).
        check_stop(stop_condition)
        sample_n = min(n, max(nlist, ivf_ops.IVF_SAMPLE_PER_CENTER * nlist),
                       ivf_ops.sample_cap(nlist))
        sample = sample_rows(batches, n, sample_n, seed)
        if sample.shape[0] and sample.shape[1] != dim:
            raise ArgumentsError(
                f"Vector length {sample.shape[1]} does not match vector parameters dim {dim}")
        centers = ivf_ops.train_centers(sample, nlist, seed=seed, stop_condition=stop_condition,
                                        device=dev)
        del sample

        # 2. streaming assignment.
        assignments = _assign_stream(batches(), params, centers, stop_condition, dev)

        # 3. bucket layout and each row's slot in the sharded order.
        _, bucket_ids = ivf_ops.build_buckets(assignments, s)
        del assignments
        b = bucket_ids.shape[0]
        old, is_primary, b_loc, b_pad = _round_robin_layout(b, ns)
        slot_ids_orig, max_dup = _derive_slot_ids(bucket_ids, n)
        slot_ids_new = slot_ids_orig[old]
        del slot_ids_orig
        flat_ids = bucket_ids[old].reshape(-1)
        prim_mask = np.repeat(is_primary, s) & (flat_ids >= 0)
        slot_of_row = np.empty((n,), np.int64)
        slot_of_row[flat_ids[prim_mask]] = np.flatnonzero(prim_mask)
        # Duplicate slots (pads in real buckets, whole pad buckets): filled
        # after the encode pass from their rows' primary slots.
        fill_dst = np.flatnonzero(~prim_mask)
        fill_src = slot_of_row[slot_ids_new.reshape(-1)[fill_dst]]
        oflat = bucket_ids.reshape(-1)
        omask = oflat >= 0
        bucket_of_row = np.empty((n,), np.int64)
        bucket_of_row[oflat[omask]] = np.flatnonzero(omask) // s
        del prim_mask, flat_ids, oflat, omask
        if b_pad > b:
            max_dup += 1
        width = _shard_width(kind, b_loc, s)
        nsl = b_loc * s

        def at(slots):
            """Global slots -> positions in the shard-padded buffers."""
            sh = slots // nsl
            return sh * width + (slots - sh * nsl)

        # Bucket-mean sums on the first device, ORIGINAL bucket order, by
        # one-hot products (deterministic, unlike index_add_ on the card);
        # the counts are the bucket layout's.
        msum = torch.zeros((b, dim), dtype=torch.float32, device=dev)

        def acc_means(batch, r0):
            bidx = bucket_of_row[r0:r0 + batch.shape[0]]
            ivf_ops.add_onehot_sums(msum, torch.from_numpy(np.ascontiguousarray(batch)).to(dev),
                                    torch.from_numpy(bidx).to(dev))

        def finalize_means():
            cnts = np.maximum((bucket_ids >= 0).sum(axis=1), 1).astype(np.float32)
            return msum.cpu().numpy() / cnts[:, None]

        means_orig = None
        if residual:
            # The means need their own pass: residualization depends on them.
            r0 = 0
            for batch in checked_batches(batches(), params):
                check_stop(stop_condition)
                acc_means(batch, r0)
                r0 += batch.shape[0]
            means_orig = finalize_means()

            def enc_batches():
                r = 0
                for batch in batches():
                    bsz = batch.shape[0]
                    yield batch - means_orig[bucket_of_row[r:r + bsz]]
                    r += bsz

            inner_dt, inner_inv = DistanceType.DOT, False
        else:
            enc_batches = batches
            inner_dt, inner_inv = params.distance_type, params.invert
        inner_vp = VectorParameters(dim, b * s, inner_dt, inner_inv)
        train_vp = VectorParameters(dim, n, inner_dt, inner_inv)
        tap = _Tap(enc_batches)
        kw = dict(mesh=mesh, mesh_axis=axis)

        # 4. + 5. the inner family's training and its encode pass: each
        # batch's codes land at their slots; the input batch is the tap's.
        beta = [0.0, 0]
        if kind == "sq":
            quantile = quantizer_kwargs.pop("quantile", None)
            _no_more(quantizer_kwargs, "SQ")
            train_meta = sq_model.sq_metadata(enc_batches, train_vp, quantile, stop_condition,
                                              seed)
            inner_meta = dataclasses.replace(train_meta, vector_parameters=inner_vp)
            lane = sq_model._lane_pad(train_meta.actual_dim)
            stores = (DeviceScatter((ns * width, lane), torch.int8, **kw),
                      DeviceScatter((ns * width,), torch.float32, **kw))
            encoded = sq_model.quantized_batches(tap(), train_meta, stop_condition, dev)
        elif kind == "pq":
            if "chunk_size" not in quantizer_kwargs:
                raise ArgumentsError("PQ inner quantizer needs chunk_size")
            chunk_size = quantizer_kwargs.pop("chunk_size")
            bits = quantizer_kwargs.pop("bits", 8)
            rotation = quantizer_kwargs.pop("rotation", None)
            _no_more(quantizer_kwargs, "PQ")
            train_meta, c_chunks, rot_t = ProductQuantizer._codebook(
                enc_batches, train_vp, chunk_size, stop_condition, seed, bits, rotation, dev)
            inner_meta = dataclasses.replace(train_meta, vector_parameters=inner_vp)
            mpad = ProductQuantizer._pads(train_meta)[1]
            stores = (DeviceScatter((ns * width, mpad), torch.uint8, **kw),)
            encoded = ((pad_dim_to(c, 1, mpad),) for c in pq_model.encoded_batches(
                tap(), train_meta, c_chunks, rot_t, stop_condition, dev))
        else:
            store_type = quantizer_kwargs.pop("store_type", "u128")
            _no_more(quantizer_kwargs, "BQ")
            inner_meta = BQMetadata(inner_vp)
            row_bytes = bq_ops.storage_bytes(dim, store_type)
            wpad = ShardedBinaryQuantizer._wpad(row_bytes)
            stores = (DeviceScatter((wpad, ns * width), torch.int32, axis=1, **kw),)
            encoded = ((plane_words(rows, wpad),) for rows in bq_model.packed_batches(
                tap, train_vp, batch_size, row_bytes, stop_condition))
        r0 = 0
        for outs in encoded:
            batch = tap.queue.popleft()
            bsz = batch.shape[0]
            pos = at(slot_of_row[r0:r0 + bsz])
            for st, out in zip(stores, outs):
                st.scatter(out, pos)
            if not residual:
                acc_means(batch, r0)
            elif kind == "bq":
                # beta = E|r_i| over the whole residual stream (the
                # single-device build samples <= 262k rows).
                beta[0] += float(np.sum(np.abs(batch)))
                beta[1] += batch.size
            r0 += bsz

        # 6. duplicate slots from their primary rows; the means; row terms.
        for st in stores:
            st.fill_from(at(fill_dst), at(fill_src))
        inner = tuple(st.finish() for st in stores)
        if means_orig is None:
            means_orig = finalize_means()
        residual_scale = 0.0
        if residual and kind == "bq":
            residual_scale = max(beta[0] / max(beta[1], 1), 1e-30)
        meta = IVFMetadata(nlist=nlist, bucket_size=s, nprobe=nprobe, kind=kind, nbuckets=b,
                           vector_parameters=params, nscan=nscan, residual=residual,
                           residual_scale=residual_scale)
        return cls._assemble(mesh, axis, meta, inner_meta, bucket_ids, means_orig,
                             slot_ids_new, inner, max_dup,
                             store_type if kind == "bq" else "u128")

    @classmethod
    def _assemble(cls, mesh, axis, meta, inner_meta, bucket_ids, means_orig, slot_ids_new,
                  inner, max_dup, store_type):
        """A built or loaded index from its shard-padded inner arrays: a
        residual index's row terms are derived per shard here (the inner
        voffsets kept for save), as ``IVFIndex`` derives them at load."""
        obj = cls.__new__(cls)
        voff_inner = rowadd = None
        if meta.residual:
            rowadd, voff_inner, inner = _row_terms(meta, inner_meta, bucket_ids, means_orig,
                                                   inner, mesh, axis)
        obj._init_from_parts(
            mesh=mesh, axis=axis, metadata=meta, inner_meta=inner_meta, bucket_ids=bucket_ids,
            bucket_means=means_orig, slot_ids_new=slot_ids_new, inner=inner,
            voff_inner=voff_inner, rowadd=rowadd, max_dup=max_dup, store_type=store_type)
        return obj

    # ------------------------------------------------------------- query
    @property
    def count(self) -> int:
        return self.params.count

    def encode_query(self, queries):
        """(f32 queries [Q, D], the inner family's encoded queries) on the
        mesh's first device: ``IVFIndex.encode_query``'s function, from the
        inner metadata (residual folds included)."""
        kind = self.metadata.kind
        if kind == "pq":
            return encode_ivf_query(queries, self.metadata, self.inner_meta, self.device,
                                    c_chunks=self._c_chunks, rot=self._rot)
        codes = self._inner[0]
        return encode_ivf_query(
            queries, self.metadata, self.inner_meta, self.device,
            width=codes.shape[1] if kind == "sq" else codes.shape[0],
            store_type=self._store_type)

    def top_k_device(self, equery, k: int, method: str = "exact", nprobe: Optional[int] = None,
                     nscan: Optional[int] = None, scan: str = "auto",
                     recall_target: Optional[float] = None):
        """Probe + per-shard probed-bucket scan + merge, results on the
        mesh's first device. ``nscan`` is the GLOBAL scanned-bucket budget;
        each shard scans ``ceil(nscan / n_shards)`` of its own buckets.
        ``scan`` as ``IVFIndex.top_k_device``, except PQ, which always scans
        compact here (``scan="indexed"`` raises). ``recall_target``:
        checked and ignored (``check_recall_target``)."""
        q, eq_inner = equery
        meta = self.metadata
        kind = meta.kind
        p, u_loc, kk2, use_fused, precision, itile = _search_plan(
            meta, self._max_dup, k, nprobe, nscan, method, scan, recall_target,
            n_shards=self.n_shards, b_loc=self._b_loc,
            dp=self._inner[0].shape[0] * 32 if kind == "bq" else None, allow_pq=False)
        devices = [t.device for t in self._slot_ids.shards]
        if kind == "sq":
            eq = (eq_inner.codes, eq_inner.offsets)
            mult = eq_inner.mult if meta.residual else self._mult
            mults = _per_device(devices, mult)
            inner = [(c, v, mults[c.device][0])
                     for c, v in zip(self._inner[0].shards, self._inner[1].shards)]
        elif kind == "bq":
            eq = ((eq_inner.codes, eq_inner.mult, eq_inner.qb) if meta.residual
                  else (eq_inner.planes,))
            inner = [(pl,) for pl in self._inner[0].shards]
        else:
            eq = (eq_inner.lut,)
            inner = [(c, False) for c in self._inner[0].shards]
        resid = (self._res_a, self._rowadd) if meta.residual else None
        return _ivf_sharded_search(
            q, eq, self._means_dev, self._slot_ids, inner, resid, kind=kind, k=int(k), p=p,
            u_loc=u_loc, b_loc=self._b_loc, method=method, dt=self.params.distance_type,
            invert=self.params.invert, s=meta.bucket_size, dim=self.params.dim, use_fused=use_fused, kk2=kk2,
            itile=itile, precision=precision, means_rep=self._means_rep)

    def top_k(self, equery, k: int, method: str = "exact", nprobe: Optional[int] = None,
              nscan: Optional[int] = None, scan: str = "auto",
              recall_target: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        sv, ids = self.top_k_device(equery, k, method=method, nprobe=nprobe, nscan=nscan,
                                    scan=scan, recall_target=recall_target)
        return sv.cpu().numpy(), ids.cpu().numpy()

    # ----------------------------------------------------------- storage
    def save(self, data_path, meta_path) -> None:
        """``IVFIndex.save``'s four files (either class loads them), the
        inner blob written shard by shard: each shard's arrays come to the
        host once and each of its primary buckets goes to its ORIGINAL
        bucket's offset; pad buckets are skipped."""
        _write_meta(meta_path, self.inner_meta)
        with open(f"{os.fspath(meta_path)}.ivf.json", "w") as f:
            json.dump(self.metadata.to_json(), f)
        with open(f"{os.fspath(data_path)}.ivf", "wb") as f:
            f.write(self.bucket_ids.astype("<i4").tobytes())
            f.write(self.bucket_means.astype("<f4").tobytes())
        meta, im = self.metadata, self.inner_meta
        kind, s, b = meta.kind, meta.bucket_size, meta.nbuckets
        nsl = self._b_loc * s
        if kind == "sq":
            row_size = im.actual_dim + 4
            voff = self._voff_inner if meta.residual else self._inner[1]

            def shard_rows(sh):
                codes = self._inner[0].shards[sh][:nsl].cpu().numpy()
                rows = np.zeros((nsl, row_size), np.uint8)
                rows[:, 4:] = codes[:, : im.actual_dim].view(np.uint8)
                vo = voff.shards[sh][:nsl].cpu().numpy().astype(np.float32)
                rows[:, :4] = vo.view(np.uint8).reshape(nsl, 4)
                return rows
        elif kind == "pq":
            m = len(im.vector_division)
            row_size = (m + 1) // 2 if im.bits == 4 else m

            def shard_rows(sh):
                rows = np.ascontiguousarray(self._inner[0].shards[sh][:nsl, :m].cpu().numpy())
                if im.bits == 4:
                    # Two 4-bit codes a byte, low nibble the even chunk.
                    if m % 2:
                        rows = np.pad(rows, ((0, 0), (0, 1)))
                    rows = (rows[:, 0::2] | (rows[:, 1::2] << 4)).astype(np.uint8)
                return rows
        else:
            row_size = bq_ops.storage_bytes(self.params.dim, self._store_type)

            def shard_rows(sh):
                planes = self._inner[0].shards[sh][:, :nsl].cpu().numpy().view(np.uint32)
                return bq_ops.planes_to_rows(planes, row_size)

        with open(data_path, "wb") as f:
            f.truncate(b * s * row_size)
            for sh in range(self.n_shards):
                rows = shard_rows(sh)
                for lb in range(self._b_loc):
                    np0 = sh * self._b_loc + lb
                    if not self._is_primary[np0]:
                        continue
                    f.seek(int(self._old[np0]) * s * row_size)
                    f.write(rows[lb * s:(lb + 1) * s].tobytes())

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters, mesh: Optional[Mesh] = None,
             axis: str = "shard") -> "ShardedIVF":
        """Per-shard load of the four-file format: each shard reads its
        buckets' rows of the inner blob through a memory map, straight to
        its device; residual row terms are derived per shard, as
        ``IVFIndex.load`` derives them."""
        mesh = mesh if mesh is not None else make_mesh()
        _check_axis(mesh, axis)
        ns = mesh.shape[axis]
        try:
            with open(f"{os.fspath(meta_path)}.ivf.json") as f:
                meta = IVFMetadata.from_json(json.load(f))
        except (OSError, KeyError, ValueError) as e:
            raise StorageIOError(f"cannot read IVF metadata: {e}") from e
        b, s, dim, kind = meta.nbuckets, meta.bucket_size, params.dim, meta.kind
        sizes = (b * s * 4, b * dim * 4)
        try:
            with open(f"{os.fspath(data_path)}.ivf", "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StorageIOError(f"cannot read IVF data: {e}") from e
        if len(blob) != sum(sizes):
            raise StorageIOError(f"IVF blob size {len(blob)} != expected {sum(sizes)}")
        bucket_ids = np.frombuffer(blob[: sizes[0]], "<i4").reshape(b, s)
        means_orig = np.frombuffer(blob[sizes[0]:], "<f4").reshape(b, dim)
        old, _, b_loc, b_pad = _round_robin_layout(b, ns)
        slot_ids_orig, max_dup = _derive_slot_ids(bucket_ids, params.count)
        if b_pad > b:
            max_dup += 1
        n_rows, nsl = b * s, b_loc * s
        width = _shard_width(kind, b_loc, s)
        devices = mesh.shard_devices(axis)

        def shards(fill, dim_=0):
            """Each shard's blob rows (``fill(rows)``: its host array) padded
            to ``width`` and copied to its device."""
            out = []
            for sh, d in enumerate(devices):
                rows = fill(_shard_slots(old, sh, b_loc, s))
                out.append(pad_dim_to(torch.from_numpy(rows), dim_, width).to(d))
            return ShardedArray(out, dim_)

        store_type = "u128"
        if kind == "sq":
            inner_meta = _read_meta(SQMetadata, meta_path)
            row_size = inner_meta.actual_dim + 4
            mm = _open_blob(data_path, n_rows, row_size)
            lane = sq_model._lane_pad(inner_meta.actual_dim)

            def codes_of(rows):
                out = np.zeros((rows.shape[0], lane), np.int8)
                out[:, : inner_meta.actual_dim] = mm[rows, 4:].view(np.int8)
                return out

            inner = (shards(codes_of),
                     shards(lambda rows: np.ascontiguousarray(mm[rows, :4]).view(np.float32)
                            .reshape(-1)))
        elif kind == "pq":
            inner_meta = _read_meta(PQMetadata, meta_path)
            m = len(inner_meta.vector_division)
            row_size = m if inner_meta.bits == 8 else (m + 1) // 2
            mm = _open_blob(data_path, n_rows, row_size)
            mpad = ProductQuantizer._pads(inner_meta)[1]

            def pq_of(rows):
                r = mm[rows]
                if inner_meta.bits == 4:
                    un = np.empty((r.shape[0], row_size * 2), np.uint8)
                    un[:, 0::2] = r & 0x0F
                    un[:, 1::2] = r >> 4
                    r = un[:, :m]
                out = np.zeros((r.shape[0], mpad), np.uint8)
                out[:, :m] = r
                return out

            inner = (shards(pq_of),)
        else:
            inner_meta = _read_meta(BQMetadata, meta_path)
            # BQ metadata does not record the word tier; the blob size does.
            row_size = bq_ops.storage_bytes(dim, store_type)
            if os.path.getsize(data_path) != n_rows * row_size:
                store_type = "u8"
                row_size = bq_ops.storage_bytes(dim, store_type)
            mm = _open_blob(data_path, n_rows, row_size)
            wpad = ShardedBinaryQuantizer._wpad(row_size)
            inner = (shards(lambda rows: plane_words(np.ascontiguousarray(mm[rows]), wpad)
                            .numpy(), 1),)
        return cls._assemble(mesh, axis, meta, inner_meta, bucket_ids, means_orig,
                             slot_ids_orig[old], inner, max_dup, store_type)


# ------------------------------------------------------------------ helpers


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis not in mesh.axis_names:
        raise ArgumentsError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")


def _no_more(kwargs: dict, family: str) -> None:
    if kwargs:
        raise ArgumentsError(f"unknown {family} kwargs {sorted(kwargs)}")


def _assign_stream(batches, params: VectorParameters, centers: np.ndarray, stop_condition,
                   dev) -> np.ndarray:
    """Each row's nearest center, i32 [count]: a plain argmin of |c|^2 -
    2 x.c at full f32 on ``dev``, batch by batch (in row blocks whose
    [rows, nlist] scores stay under ``_ASSIGN_BYTES_CAP``)."""
    cen = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(dev)
    cc = torch.sum(cen * cen, dim=1)
    rows_per = max(1, _ASSIGN_BYTES_CAP // (4 * cen.shape[0]))
    out = np.empty((params.count,), np.int32)
    r0 = 0
    for batch in checked_batches(batches, params):
        check_stop(stop_condition)
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
        for b0 in range(0, x.shape[0], rows_per):
            xb = x[b0:b0 + rows_per]
            with full_f32():
                a = torch.argmin(cc[None, :] - 2.0 * (xb @ cen.T), dim=1)
            out[r0 + b0:r0 + b0 + xb.shape[0]] = a.cpu().numpy()
        r0 += x.shape[0]
    return out


def _row_terms(meta, inner_meta, bucket_ids, means_orig, inner, mesh, axis):
    """(rowadd, inner DOT voffsets, inner) of a residual index, per shard:
    SQ's scanned voffsets become rowcoef * |c_b + r^|^2 (``ops/ivf.py``
    ``sq_decoded_rowterm``), PQ's rowadd rowcoef * its PQ twin, BQ's rowadd
    zero; every one NEG at pad slots and past the shard's buckets, as
    ``IVFIndex._init_residual`` makes them on one device."""
    params = meta.vector_parameters
    _, rowcoef = _residual_coeffs(params.distance_type, params.invert)
    ns = mesh.shape[axis]
    devices = mesh.shard_devices(axis)
    s, kind = meta.bucket_size, meta.kind
    old, _, b_loc, _ = _round_robin_layout(meta.nbuckets, ns)
    pad = (bucket_ids[old] < 0).reshape(ns, b_loc * s)
    means_new = means_orig[old]
    nsl = b_loc * s
    extra = []
    ops = None
    if kind == "pq":
        c_chunks = torch.from_numpy(pq_ops.centroids_to_chunks(
            np.asarray(inner_meta.centroids), inner_meta.vector_division))
        rot = (None if inner_meta.rotation is None
               else torch.as_tensor(inner_meta.rotation, dtype=torch.float32))
        ops = _per_device(devices, c_chunks, *(() if rot is None else (rot,)))
    for sh, d in enumerate(devices):
        width = inner[0].shards[sh].shape[1 if kind == "bq" else 0]
        e = torch.zeros(width, device=d)
        mb = torch.from_numpy(np.ascontiguousarray(means_new[sh * b_loc:(sh + 1) * b_loc])).to(d)
        if rowcoef != 0.0 and kind == "sq":
            e[:nsl] = rowcoef * ivf_ops.sq_decoded_rowterm(
                inner[0].shards[sh], inner_meta.alpha, inner_meta.offset, mb, s, params.dim)
        elif rowcoef != 0.0 and kind == "pq":
            cc, *r = ops[d]
            e[:nsl] = rowcoef * ivf_ops.pq_decoded_rowterm(
                inner[0].shards[sh], cc, r[0] if r else None, mb, s,
                inner_meta.vector_division)
        e[:nsl] = torch.where(torch.from_numpy(pad[sh]).to(d), e.new_full((), NEG), e[:nsl])
        e[nsl:] = NEG
        extra.append(e)
    extra = ShardedArray(extra, 0)
    if kind == "sq":
        return None, inner[1], (inner[0], extra)
    return extra, None, inner
