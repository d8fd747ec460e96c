"""IVFIndex — inverted-file search over any quantizer family.

Twin of ``quantization_tpu/models/ivf.py``. The corpus is clustered and
permuted bucket-major at build (``ops/ivf.py``), and a search scans only a
probed subset of buckets. The inner quantizer (SQ, PQ with or without OPQ,
BQ) encodes the S-aligned permuted corpus, so bucket b owns inner rows
[b*S, (b+1)*S).

A search is a batch union, as in the JAX package: each query votes for its
``nprobe`` nearest buckets, the ``nscan`` buckets of highest rank-fair
priority are scanned for the whole batch by the family's fused search, and
the candidates are deduped by id. Two scans:

  * indexed (``scan="indexed"``, or ``"auto"`` where the family and the
    bucket size allow it): the kernel walks the union's tiles of the
    resident codes in place — K9b / K9a for SQ (exact / approx), K10 for BQ
    and K11 for PQ (approx);
  * compact: the union's buckets are gathered into one sub-corpus, which
    the family's dense search scans — K1 / K2 (SQ), K5c / K5a (BQ),
    K7b / K7a (PQ). PQ gathers from whichever code layout the quantizer
    holds, so no second full copy is made (ROADMAP Queue 3, F2).

Residual indexes (``residual=True``: SQ and PQ with DOT or L2, BQ with
DOT) encode v - bucket mean; the search restores the bucket term q . c_b as
the kernels' ``corr`` additive (one value per query and 512-row block,
built for the union only), and PQ's decoded-norm term and pad mask ride
the per-row ``rowadd``. Residual BQ keeps the residuals' sign bits and
scores them against the query's int8 VALUES (``_ResidualQueryBQ``; K5b and
the value forms of K5a / K10), with beta = E|r_i| (``residual_scale``)
bringing sign units back to data units; its pad slots score NEG through a
per-slot ``rowadd`` (as SQ's voff and PQ's rowadd poison theirs) and are
masked in the id map as in the JAX package (ROADMAP F25). It lifts recall
on clustered, unnormalized corpora and loses on unit-normalized ones, where
the build warns.

Where the JAX package leaves the fused kernels — SQ with L1, kk2 above the
fused cap, exact residual PQ with an int8 LUT — it scores with XLA and then
selects. The port does the same on that branch with the score kernels
where one exists (K3 for SQ DOT / L2, K12 for SQ L1, K6 for BQ), plain
torch for the residual-BQ affine scores and the f32-LUT PQ scores (which
have no score kernel in either package), a torch add for the additives and
``torch.topk``: that branch is the JAX package's unfused search, not a
fallback of a fused kernel. ``recall_target`` is accepted, checked and
ignored: the port's approx merges are exact, so its recall is never lower
(ROADMAP Queue 3, F9; ``core.interface.check_recall_target``).

Plugs into ``TwoStageIndex`` as a coarse stage (``encode_query`` /
``top_k_device`` / ``count``). Entry points place data on the CUDA card
unless the caller names another device.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.distances import pairwise_score
from ..core.interface import check_recall_target
from ..core.types import (
    ArgumentsError,
    DistanceType,
    StorageIOError,
    VectorParameters,
    check_stop,
)
from ..ops import bq as bq_ops
from ..ops import ivf as ivf_ops
from ..ops import pq as pq_ops
from ..ops.dispatch import resolve_device, upload
from ..ops.kernels import bq_kernel, pq_kernel, sq_kernel
from ..ops.kernels.ktile import APPROX_K_MAX, CORR_BLK, FUSED_K_MAX, SLOT, merge_chunks
from ..ops.pq import full_f32
from ..utils.fallback import warn_unfused
from ..utils.padding import pad_dim_to
from . import bq as bq_model
from . import pq as pq_model
from . import sq as sq_model
from .pq import EncodedQueryPQ

# Score of a masked candidate (the JAX package's models/ivf.py NEG, as f32).
NEG = float(np.float32(-3.0e38))

# Indexed scans split their tile list into chunks past this many tiles, so
# the kernels' candidate buffers stay bounded; each chunk's top-kk2 is exact
# over its tiles, and the chunk merge (ktile.merge_chunks) loses nothing.
_INDEXED_CHUNK_TILES = 4096

# scan="auto" takes the PQ indexed scan, which reads the transposed code
# layout, only while building that layout (when the quantizer lacks it)
# fits this budget; QTPU_PQ_T_CAP overrides it in bytes.
_PQ_T_BYTES_CAP = int(os.environ.get("QTPU_PQ_T_CAP", 4 << 30))

@dataclass
class _ResidualQueryU8:
    """Signed zero-centered query codes for residual-SQ scoring (see
    ``_residual_query_sq``): int8 [Q, Dpad] in [-127, 127], f32 [Q] offsets
    and the per-query effective multiplier A*aq*ar, f32 [Q]."""

    codes: torch.Tensor
    offsets: torch.Tensor
    mult: torch.Tensor


@dataclass
class _ResidualQueryBQ:
    """Asymmetric residual-BQ query (see ``_residual_query_bq``): the corpus
    keeps 1-bit residual signs, the query its quantized values, int8
    [Q, Dpad] in [-127, 127]; ``mult`` = 2*A*beta*aq and ``qb`` =
    -A*beta*aq*sum(q^), f32 [Q, 1] each, so that mult * (qs . bits) + qb =
    A*beta*(q^ . sign(r))."""

    codes: torch.Tensor
    mult: torch.Tensor
    qb: torch.Tensor


def _registry():
    from .bq import BinaryQuantizer
    from .pq import ProductQuantizer
    from .sq import ScalarQuantizerU8

    return {"sq": ScalarQuantizerU8, "pq": ProductQuantizer, "bq": BinaryQuantizer}


@dataclass
class IVFMetadata:
    nlist: int
    bucket_size: int
    nprobe: int
    kind: str
    nbuckets: int
    vector_parameters: VectorParameters  # the original corpus (count = N)
    nscan: Optional[int] = None  # default batch-union width (None: 4 * nprobe)
    residual: bool = False  # inner codes encode v - bucket mean
    residual_scale: float = 0.0  # beta = E|r_i| (residual BQ only)

    def to_json(self) -> dict:
        out = {
            "nlist": self.nlist,
            "bucket_size": self.bucket_size,
            "nprobe": self.nprobe,
            "kind": self.kind,
            "nbuckets": self.nbuckets,
            "vector_parameters": self.vector_parameters.to_json(),
        }
        if self.nscan is not None:
            out["nscan"] = self.nscan
        if self.residual:
            out["residual"] = True
        if self.residual_scale:
            out["residual_scale"] = float(self.residual_scale)
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "IVFMetadata":
        return cls(
            nlist=int(obj["nlist"]),
            bucket_size=int(obj["bucket_size"]),
            nprobe=int(obj["nprobe"]),
            kind=str(obj["kind"]),
            nbuckets=int(obj["nbuckets"]),
            vector_parameters=VectorParameters.from_json(obj["vector_parameters"]),
            nscan=int(obj["nscan"]) if obj.get("nscan") is not None else None,
            residual=bool(obj.get("residual", False)),
            residual_scale=float(obj.get("residual_scale", 0.0)),
        )


def _derive_slot_ids(bucket_ids: np.ndarray, n: int):
    """``(slot_ids [B, S], max_dup)``: pad slots hold the id of the row they
    duplicate (``build_buckets`` fills pads from one global cyclic cursor,
    so the map needs no storage); ``max_dup`` bounds the slots per id, the
    dedupe margin."""
    slot_ids = np.array(bucket_ids, np.int32)
    pad_mask = slot_ids < 0
    total_pads = int(pad_mask.sum())
    if total_pads:
        slot_ids[pad_mask] = (np.arange(total_pads, dtype=np.int64) % max(int(n), 1)).astype(
            np.int32)
    max_dup = 1 + (-(-total_pads // max(int(n), 1)) if total_pads else 0)
    return slot_ids, max_dup


def _residual_coeffs(dt: DistanceType, invert: bool):
    """Dot-expansion coefficients ``(a, rowcoef)`` of a residual search: ``a``
    scales the inner score and the q.c_b bucket term, ``rowcoef`` the
    |v^|^2 per-row term (0 for DOT)."""
    s_sign = -1.0 if invert else 1.0
    if dt == DistanceType.DOT:
        return s_sign, 0.0
    return -2.0 * s_sign, s_sign  # L2 (L1 is rejected at encode)


def _residual_query_sq(q, alpha, offset, dpad, a, rc) -> _ResidualQueryU8:
    """Residual-SQ query codes: zero-centered signed codes, each query scaled
    by its own aq = max|q_i| / 127, |q|^2 folded into the offset, the
    effective multiplier A*alpha*aq one value per query."""
    qn = torch.sum(q * q, dim=1)
    # max / 127 in f64, rounded once: the card's division by a Python number
    # multiplies by the reciprocal and can miss the correctly rounded f32.
    aq = torch.clamp((q.abs().amax(dim=1, keepdim=True).double() / 127.0).float(), min=1e-30)
    qc = torch.clamp(torch.round(q / aq), -127, 127).to(torch.int8)
    qc = pad_dim_to(qc, 1, dpad)
    qoff = (a * offset) * torch.sum(q, dim=1) + rc * qn
    mult = aq[:, 0] * float(np.float32(a * alpha))  # an f32 product, no upload
    return _ResidualQueryU8(qc.contiguous(), qoff, mult)


def _residual_query_bq(q, dp, a, beta) -> _ResidualQueryBQ:
    """Residual-BQ query: value codes, each query scaled by its own aq =
    max|q_i| / 127, the affine completed so that mult * (q^ . bits) + qb =
    A*beta*aq*(2*(q^ . bits) - sum(q^)) = A*beta*(q . sign(r)) on the true
    dims (pad dims hit q^ = 0)."""
    # max / 127 in f64, rounded once (see _residual_query_sq).
    aq = torch.clamp((q.abs().amax(dim=1, keepdim=True).double() / 127.0).float(), min=1e-30)
    qc = torch.clamp(torch.round(q / aq), -127, 127).to(torch.int8)
    qc = pad_dim_to(qc, 1, dp)
    total = torch.sum(qc.to(torch.float32), dim=1, keepdim=True)  # integers: exact
    ab = aq * float(np.float32(a * beta))  # an f32 product, as the JAX package's
    return _ResidualQueryBQ(qc.contiguous(), 2.0 * ab, -ab * total)


def _residual_query_pq(lut, a) -> EncodedQueryPQ:
    """Residual-PQ query LUT: ``a`` rescales the inner DOT entries; the
    rc*|q|^2 term joins the f32 corr additive instead (see ``_ivf_search``)."""
    return EncodedQueryPQ(a * lut)


def encode_ivf_query(queries, metadata: IVFMetadata, inner_meta, device, *, width=None,
                     store_type: str = "u128", c_chunks=None, rot=None):
    """(f32 queries [Q, D] on ``device``, the inner family's encoded queries,
    or for a residual index their residual form): ``encode_query`` of the
    single-device and the sharded IVF indexes, from the inner quantizer's
    metadata and its query-side operands: ``width`` the SQ code lane or the
    BQ word count of the stored codes; ``store_type`` BQ's; ``c_chunks`` /
    ``rot`` PQ's centroids and OPQ rotation on ``device``."""
    params = metadata.vector_parameters
    qh = np.asarray(queries, np.float32)
    if qh.ndim == 1:
        qh = qh[None, :]
    if qh.shape[1] != params.dim:
        raise ArgumentsError(f"query dim {qh.shape[1]} != corpus dim {params.dim}")
    q = upload(qh, device)
    kind = metadata.kind
    if not metadata.residual:
        if kind == "sq":
            return q, sq_model.encode_queries(qh, inner_meta, width, device)
        if kind == "bq":
            return q, bq_model.encode_queries(qh, params.dim, store_type, width, device)
        return q, pq_model.encode_queries(qh, inner_meta, c_chunks, rot, device)
    a, rc = _residual_coeffs(params.distance_type, params.invert)
    if kind == "bq":
        return q, _residual_query_bq(q, width * 32, a, metadata.residual_scale)
    if kind == "sq":
        return q, _residual_query_sq(q, inner_meta.alpha, inner_meta.offset, width, a, rc)
    return q, _residual_query_pq(
        pq_model.encode_queries(qh, inner_meta, c_chunks, rot, device).lut, a)


def auto_geometry(count: int, residual: bool = False):
    """``(nlist, bucket_size)`` from the JAX package's geometry rules:
    bucket_size the widest indexed tile (1024), halved for small corpora so
    the index keeps >= ~8 buckets of probing headroom, floored at CORR_BLK
    (512) for residual indexes; then nlist * bucket_size ~ count / 3."""
    s = 1024
    while s > 32 and count < 3 * 8 * s:
        s //= 2
    if residual:
        s = max(s, CORR_BLK)
    return max(1, count // (3 * s)), s


def _stable_top(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _bucket_priority(q, means, dt, invert, p):
    """Rank-fair batch-union priority per bucket [B]: a bucket's rank is the
    best probe rank any query gave it (so every query's rank-0 bucket enters
    the union before anyone's rank-1 bucket), votes break ties within a
    rank, and the batch-max probe score mapped into (0, 0.5) breaks vote
    ties and fills unvoted slots. f32, in the JAX package's order; the std
    is the population std."""
    probe_scores = pairwise_score(q, means, dt, invert)  # [Q, B]
    _, probes = _stable_top(probe_scores, p)
    nq, nb = q.shape[0], means.shape[0]
    flat = probes.reshape(-1)
    ranks = torch.arange(p, dtype=torch.float32, device=q.device).repeat(nq)
    minrank = torch.full((nb,), float(p), device=q.device).scatter_reduce(
        0, flat, ranks, "amin")
    votes = torch.zeros((nb,), device=q.device).index_add_(
        0, flat, torch.ones_like(ranks))  # whole numbers: exact in any order
    bmax = torch.amax(probe_scores, dim=0)
    tie = 0.5 * torch.sigmoid((bmax - bmax.mean()) / (bmax.std(correction=0) + 1e-6))
    return (float(p) - minrank) * float(nq * p + 1) + votes + tie


def _union(q, means, dt, invert, p, u):
    """The batch union: the ``u`` buckets of highest priority, in priority
    order (ties in bucket order, as ``lax.top_k`` gives them)."""
    return _stable_top(_bucket_priority(q, means, dt, invert, p), u)[1]


def _bucket_term(q, means, union, a, pq_rc=0.0):
    """The residual bucket term of the union, [U, Q]: a * (q . c_b),
    computed union-first (one [U, D] x [D, Q] product over the scanned
    buckets' means only) in full f32; PQ also carries rc*|q|^2 here
    (``_residual_query_pq``)."""
    with full_f32():
        qc = (means[union] @ q.T) * a
    if pq_rc:
        qc = qc + pq_rc * torch.sum(q * q, dim=1)[None, :]
    return qc


def _gather_buckets(x: torch.Tensor, union: torch.Tensor, nb: int, s: int, axis: int):
    """The union's buckets of ``x`` (rows along ``axis``), in union order."""
    if axis == 0:
        return x[: nb * s].reshape(nb, s, *x.shape[1:])[union].reshape(-1, *x.shape[1:])
    return x[:, : nb * s].reshape(x.shape[0], nb, s)[:, union].reshape(x.shape[0], -1)


def _scan_buckets_compact(kind, eq, inner, union, *, nb, s, dt, invert, dim, use_fused,
                          kk2, method, corr=None, rowadd=None, precision=None):
    """Gather the union's buckets into one compact sub-corpus and scan it
    with the family's own search (fused when ``use_fused``, else score and
    select). Returns (sv [Q, kk2], loc [Q, kk2]) with ``loc`` a position in
    union-slot space [0, U*s), or -1 / past it for an empty slot.

    ``inner``: SQ (codes, voff, mult), BQ (planes,), PQ (codes,
    transposed), the codes u8 [Npad, Mpad] rows or with ``transposed`` the
    kernels' [Mpad, Npad] layout, whichever the caller holds (no second
    copy is made). ``corr`` [Q, U] (residual indexes): the bucket term of
    each union bucket, expanded here to one column per 512 rows; ``rowadd``
    a per-slot additive [>= nb*s] (PQ, BQ; SQ's rides its voff)."""
    width = union.shape[0] * s
    mode = "approx" if method == "approx" else "exact"
    corr_c = None if corr is None else torch.repeat_interleave(corr, s // CORR_BLK, dim=1)

    def padded_corr(npadc):
        return None if corr_c is None else pad_dim_to(corr_c, 1, npadc // CORR_BLK)

    if kind == "sq":
        qcodes, qoff = eq
        codes, voff, mult = inner
        npadc = width + (-width) % sq_kernel.TILE_N
        g = pad_dim_to(_gather_buckets(codes, union, nb, s, 0), 0, npadc)
        gv = pad_dim_to(_gather_buckets(voff, union, nb, s, 0), 0, npadc)
        if use_fused:
            return sq_kernel.sq_search(qcodes, qoff, g, gv, mult, padded_corr(npadc),
                                       distance_type=dt, n_valid=width, k=kk2, mode=mode)
        # K3 for DOT / L2, K12 for L1
        scores = sq_kernel.sq_scores(qcodes, qoff, g, gv, mult, distance_type=dt,
                                     n_valid=width)
        if corr_c is not None:
            scores = scores + torch.repeat_interleave(corr_c, CORR_BLK, dim=1)
    elif kind == "bq":
        qwords, qaff = _bq_query(eq)
        (planes,) = inner
        npadc = width + (-width) % bq_kernel.TILE_N
        g = pad_dim_to(_gather_buckets(planes, union, nb, s, 1), 1, npadc).contiguous()
        ra = None if rowadd is None else _gather_buckets(rowadd, union, nb, s, 0)
        kw = dict(distance_type=dt, invert=invert, dim=dim, n_valid=width)
        if use_fused:
            return bq_kernel.bq_search(
                qwords, g, padded_corr(npadc), k=kk2, mode=mode, query_affine=qaff,
                rowadd=None if ra is None else pad_dim_to(ra, 0, npadc, value=NEG), **kw)
        if qaff is None:
            scores = bq_kernel.bq_scores(qwords, g, **kw)
        else:
            scores = bq_ops.score_affine(*qaff, g[:, :width])
        if ra is not None:
            scores = scores + ra[None, :]
        if corr_c is not None:
            scores = scores + torch.repeat_interleave(corr_c, CORR_BLK, dim=1)
    else:  # pq: the codes in either layout, rows [Npad, Mpad] or transposed
        (lut,) = eq
        codes, transposed = inner
        rows = (union[:, None] * s + torch.arange(s, device=union.device)).reshape(-1)
        ct = codes[:, rows] if transposed else codes[rows].T
        ra = None if rowadd is None else _gather_buckets(rowadd, union, nb, s, 0)
        if use_fused:
            npadc = width + (-width) % pq_kernel.TILE_N
            return pq_kernel.pq_search(
                lut, pad_dim_to(ct, 1, npadc).contiguous(),
                None if ra is None else pad_dim_to(ra, 0, npadc), padded_corr(npadc),
                n_valid=width, k=kk2, mode=mode, precision=precision)
        scores = pq_ops.score_lut(lut, ct[: lut.shape[1]].T)
        if ra is not None:
            scores = (scores + ra[None, :]) + torch.repeat_interleave(corr_c, CORR_BLK, dim=1)
    sv, loc = torch.topk(scores, kk2, dim=1)
    return sv, loc


def _bq_query(eq):
    """(sign query words, None) or (None, (qs, mult, qb)) of a residual
    index's value query."""
    return (None, tuple(eq)) if len(eq) == 3 else (eq[0], None)


def _scan_tiles_indexed(kind, eq, inner, tiles, *, itile, dt, invert, dim, kk2, mode,
                        corr=None, rowadd=None, precision=None):
    if kind == "sq":
        qcodes, qoff = eq
        codes, voff, mult = inner
        return sq_kernel.sq_search_indexed(qcodes, qoff, codes, voff, mult, tiles, corr,
                                           distance_type=dt, k=kk2, mode=mode, tile_n=itile)
    if kind == "bq":
        qwords, qaff = _bq_query(eq)
        return bq_kernel.bq_search_indexed(qwords, inner[0], tiles, corr, distance_type=dt,
                                           invert=invert, dim=dim, k=kk2, tile_n=itile,
                                           query_affine=qaff, rowadd=rowadd)
    return pq_kernel.pq_search_indexed(eq[0], inner[0], tiles, rowadd, corr, k=kk2,
                                       precision=precision, tile_n=itile)


def _scan_buckets_indexed(kind, eq, inner, union, *, s, itile, dt, invert, dim, kk2, method,
                          corr=None, rowadd=None, precision=None):
    """In-place probed scan: the kernel walks the union's tiles of the
    resident codes. Returns (sv [Q, kk2], gloc [Q, kk2]) with ``gloc`` an
    inner row or -1. ``corr`` [U*s/512, Q] in selection order; ``rowadd``
    indexed by inner row. Past ``_INDEXED_CHUNK_TILES`` tiles the list is
    scanned in chunks of near-even size and merged exactly; unlike the JAX
    package, the last chunk is not padded with copies of its last tile, so
    no candidate can appear twice in the merge."""
    mode = "approx" if method == "approx" else "exact"
    tpb = s // itile
    tiles = (union[:, None] * tpb + torch.arange(tpb, device=union.device)).reshape(-1)
    tiles = tiles.to(torch.int32)
    nt = tiles.shape[0]
    kw = dict(itile=itile, dt=dt, invert=invert, dim=dim, kk2=kk2, mode=mode,
              precision=precision, rowadd=rowadd)
    if nt <= _INDEXED_CHUNK_TILES:
        return _scan_tiles_indexed(kind, eq, inner, tiles, corr=corr, **kw)
    nc = -(-nt // _INDEXED_CHUNK_TILES)
    c = -(-nt // nc)
    cb = itile // CORR_BLK  # corr rows per tile
    parts = [
        _scan_tiles_indexed(kind, eq, inner, tiles[j * c : (j + 1) * c].contiguous(),
                            corr=None if corr is None
                            else corr[j * c * cb : (j + 1) * c * cb].contiguous(), **kw)
        for j in range(nc)
    ]
    return merge_chunks(parts, kk2, neg=NEG)


def _indexed_tile(kind, s, method, scan, *, dp=None, allow_pq=True):
    """Tile width of an indexed probed scan, or 0 when the family or the
    geometry cannot take it: SQ (exact and approx) the widest multiple of
    512 up to 2048 dividing the bucket; BQ and PQ approx only, BQ at
    ``indexed_tile_n``, PQ at 1024 halved down to 256 to divide the bucket
    (under scan="auto" only the full 1024 tile, as the JAX package
    measured a derated PQ tile losing to the compact scan). ``allow_pq``
    False (the sharded index, which scans PQ compact) gives PQ 0."""
    if kind == "sq":
        if s % sq_kernel.TILE_N:
            return 0
        t = sq_kernel.TILE_N
        while t * 2 <= 2048 and s % (t * 2) == 0:
            t *= 2
        return t
    if method != "approx":
        return 0
    if kind == "bq":
        return bq_kernel.indexed_tile_n(dp, s)
    if not allow_pq:
        return 0
    t = pq_kernel.TILE_N
    while t > SLOT and s % t:
        t //= 2
    if t <= SLOT or s % t:
        return 0
    return 0 if scan == "auto" and t != pq_kernel.TILE_N else t


def _dedupe_select(sv, out_ids, nq, k, kk2):
    """Dedupe by id, keeping each id's highest-scored copy: stable sort by
    score (descending), stable sort by id, poison repeats and ids < 0 with
    NEG, reselect with ties in index order. Empty slots come back as NEG /
    -1, the JAX package's values (ROADMAP Queue 3, F20)."""
    so = torch.argsort(-sv, dim=1, stable=True)
    sv = torch.gather(sv, 1, so)
    out_ids = torch.gather(out_ids, 1, so)
    order = torch.argsort(out_ids, dim=1, stable=True)
    sid = torch.gather(out_ids, 1, order)
    ssv = torch.gather(sv, 1, order)
    dup = torch.cat([torch.zeros((nq, 1), dtype=torch.bool, device=sv.device),
                     sid[:, 1:] == sid[:, :-1]], dim=1)
    ssv = torch.where(dup | (sid < 0), ssv.new_full((), NEG), ssv)
    kk = min(k, kk2)
    sv2, pos = _stable_top(ssv, kk)
    out = torch.gather(sid, 1, pos)
    out = torch.where(sv2 > NEG, out, out.new_full((), -1))
    if kk < k:
        sv2 = pad_dim_to(sv2, 1, k, value=NEG)
        out = pad_dim_to(out, 1, k, value=-1)
    return sv2, out.to(torch.int32)


def _search_plan(meta, max_dup, k, nprobe, nscan, method, scan, recall_target, *,
                 n_shards=1, b_loc=None, dp=None, allow_pq=True):
    """The argument checks and the plan of one IVF search, for ``IVFIndex``
    and ``ShardedIVF``: ``(p, u, kk2, use_fused, precision, itile)``.

    ``u`` is the buckets each device scans: the batch union on one device,
    and on a mesh of ``n_shards`` the top ceil(u / n_shards) of a shard's
    ``b_loc``. ``precision`` is PQ's fused LUT precision (None off the fused
    path). ``itile`` is the indexed scan's tile, 0 for a compact scan; the
    single-device PQ's ``scan="auto"`` budget is its caller's. ``dp``: BQ's
    plane width in bits; ``allow_pq`` False (the sharded index) scans PQ
    compact. A search that leaves the fused path over >= 1M rows warns."""
    check_recall_target(recall_target)
    if method not in ("exact", "approx"):
        raise ArgumentsError(f"unknown search method {method!r}")
    if scan not in ("auto", "indexed", "compact"):
        raise ArgumentsError(f"unknown scan strategy {scan!r}")
    nb, s, kind = meta.nbuckets, meta.bucket_size, meta.kind
    params = meta.vector_parameters
    p = min(int(nprobe or meta.nprobe), nb)
    if p < 1 or nb == 0:
        raise ArgumentsError("empty index or nprobe < 1")
    if nscan is None:
        nscan = meta.nscan
    u = max(min(int(nscan) if nscan else 4 * p, nb), p)
    u = min(-(-u // n_shards), nb if b_loc is None else b_loc)
    k = int(k)
    kk2 = min(max(2 * k, k * max_dup), u * s)
    cap = APPROX_K_MAX if method == "approx" else FUSED_K_MAX
    precision = pq_kernel.lut_precision(residual=meta.residual) if kind == "pq" else None
    use_fused = bool(
        kk2 <= cap
        and not (kind == "sq" and params.distance_type == DistanceType.L1)
        # Exact residual PQ selects over the additive-corrected scores;
        # the JAX package's int8 exact kernel cannot take the additives,
        # so QTPU_PQ_LUT=int8 sends it to the unfused branch there.
        and not (meta.residual and kind == "pq" and method != "approx"
                 and precision == "int8")
    )
    if not use_fused:
        warn_unfused("IVF", n_shards * u * s, k, method)
        precision = None
    itile = 0
    if use_fused and scan != "compact":
        itile = _indexed_tile(kind, s, method, scan, dp=dp, allow_pq=allow_pq)
    if scan == "indexed" and not itile:
        raise ArgumentsError(
            "scan='indexed' needs the fused kernel path, bucket_size divisible by the "
            "family's kernel tile, and SQ or method='approx'"
            + ("" if allow_pq else " with BQ (sharded PQ scans compact)"))
    return p, u, kk2, use_fused, precision, itile


def _scan_union(kind, eq, inner, union, slot_ids, qc_u=None, rowadd=None, *, nb, s, itile,
                dt, invert, dim, use_fused, kk2, method, precision):
    """One device's scan of its union of buckets: the indexed scan when
    ``itile``, else the compact one. Returns (sv [Q, kk2], ids [Q, kk2]),
    the ids through ``slot_ids`` [nb, s] (-1 for an empty slot).

    ``qc_u`` [U, Q] (residual indexes): the union's bucket term
    (``_bucket_term``), added in the kernel before selection; ``rowadd``:
    a per-slot additive (residual PQ and BQ), NEG past its length."""
    if itile:
        corr = None
        if qc_u is not None:
            corr = torch.repeat_interleave(qc_u, s // CORR_BLK, dim=0).contiguous()
        if rowadd is not None and rowadd.shape[0] < inner[0].shape[1]:
            rowadd = pad_dim_to(rowadd, 0, inner[0].shape[1], value=NEG)
        sv, loc = _scan_buckets_indexed(
            kind, eq, inner, union, s=s, itile=itile, dt=dt, invert=invert, dim=dim,
            kk2=kk2, method=method, corr=corr, rowadd=rowadd, precision=precision)
        gids = slot_ids.reshape(-1)  # loc is an inner row
    else:
        sv, loc = _scan_buckets_compact(
            kind, eq, inner, union, nb=nb, s=s, dt=dt, invert=invert, dim=dim,
            use_fused=use_fused, kk2=kk2, method=method,
            corr=None if qc_u is None else qc_u.T.contiguous(), rowadd=rowadd,
            precision=precision)
        gids = slot_ids[union].reshape(-1)  # loc is a union slot
    live = (loc >= 0) & (loc < gids.shape[0])
    return sv, torch.where(live, gids[loc.clamp(0, gids.shape[0] - 1).long()], -1)


def _ivf_search(q, eq, means, slot_ids, inner, resid=None, *, kind, k, p, u, method, dt,
                invert, s, dim, use_fused, kk2, itile, precision):
    """One batch-union IVF search: probe priority, union, the family's scan
    (``_scan_union``), dedupe and select.

    ``resid`` (residual indexes): ``(a,)`` for SQ or ``(a, rowadd)`` for PQ
    and BQ; the bucket term (``_bucket_term``) is added in the kernel before
    selection."""
    nq, nb = q.shape[0], means.shape[0]
    union = _union(q, means, dt, invert, p, u)
    qc_u = rowadd = None
    if resid is not None:
        rc = _residual_coeffs(dt, invert)[1] if kind == "pq" else 0.0
        qc_u = _bucket_term(q, means, union, resid[0], rc)  # [U, Q]
        if len(resid) > 1:
            rowadd = resid[1]
    sv, out_ids = _scan_union(
        kind, eq, inner, union, slot_ids, qc_u, rowadd, nb=nb, s=s, itile=itile, dt=dt,
        invert=invert, dim=dim, use_fused=use_fused, kk2=kk2, method=method,
        precision=precision)
    return _dedupe_select(sv, out_ids, nq, k, kk2)


def _warn_if_normalized(data: np.ndarray, count: int, seed: int) -> None:
    """The JAX package's measured regime rule for residual BQ: on a
    unit-normalized corpus the within-bucket score spread sits below the
    1-bit estimator's noise floor, and residual BQ loses recall against
    plain signs, so the build warns (4,096 row norms sampled from their own
    stream)."""
    nidx = np.random.default_rng(seed ^ 0x5EED).choice(count, size=min(count, 4096),
                                                      replace=False)
    norms = np.linalg.norm(np.asarray(data[nidx], np.float32), axis=1)
    if norms.size and float(np.mean(np.abs(norms - 1.0))) < 0.02:
        warnings.warn(
            "residual=True with quantizer='bq' on a unit-normalized corpus: measured on "
            "this regime residual-BQ REDUCES recall vs plain IVF-BQ (the JAX package's "
            "10M x 768 normalized run: coarse 0.330 -> 0.277, rescored 0.935 -> 0.918 at "
            "equal scan cost). Keep residual=False for BQ here and spend the win on "
            "rescore depth R, or use residual SQ/PQ.",
            stacklevel=3,
        )


class IVFIndex:
    """Bucket-probing search index over an inner quantizer.

    ``quantizer`` scores the S-aligned permuted corpus (count = B*S, pad
    slots duplicate real rows); ``bucket_ids`` maps slot (b, s) — inner row
    b*S + s — back to its original row id, -1 marking pad slots;
    ``bucket_means`` are the probe targets. Everything lives on the inner
    quantizer's device."""

    def __init__(self, quantizer, bucket_ids: np.ndarray, bucket_means: np.ndarray,
                 metadata: IVFMetadata):
        self.quantizer = quantizer
        self.metadata = metadata
        self.params = metadata.vector_parameters
        self.device = quantizer.device
        self.bucket_ids = np.asarray(bucket_ids, np.int32)
        self.bucket_means = np.asarray(bucket_means, np.float32)
        slot_ids, self._max_dup = _derive_slot_ids(self.bucket_ids, self.params.count)
        if metadata.residual and metadata.kind == "bq":
            # Residual BQ masks pad slots in the id map, as the JAX package
            # does: a pad duplicates a row of another bucket, and a residual
            # code scored with a foreign bucket's q . c_b term is garbage.
            # The scan also scores them NEG (_init_residual), so they never
            # crowd real rows out of the kk2 candidates (ROADMAP F25).
            slot_ids = np.where(self.bucket_ids >= 0, slot_ids, -1)
        self._slot_ids_dev = torch.from_numpy(slot_ids).to(self.device)
        self._means_dev = torch.from_numpy(np.array(self.bucket_means)).to(self.device)
        self._resid_sq = self._resid_pq = self._resid_bq = None
        if metadata.residual:
            self._init_residual()

    def _init_residual(self):
        """The residual search's arrays from the inner DOT scorer, by
        dot-expansion (r = v - c_b, v^ = c_b + r^ the decoded point):

          DOT:  S = s * (q.v^)     = s*inner + s*(q.c_b)
          L2:   S = s * |q - v^|^2 = -2s*inner - 2s*(q.c_b) + s*|q|^2 + s*|v^|^2

        (s = -1 under ``invert``). A rescales the inner multiplier / LUT and
        the corr term; |v^|^2, the decoded norm recomputed from the codes,
        joins voff (SQ) or rowadd (PQ), where pad slots and rows past the
        buckets get NEG: their residuals belong to another bucket. Residual
        BQ (DOT only) needs only that mask, as its ``rowadd``: A and beta
        ride the query."""
        a, rowcoef = _residual_coeffs(self.params.distance_type, self.params.invert)
        self._res_a, self._res_rowcoef = a, rowcoef
        if self.metadata.kind == "bq":
            if not self.metadata.residual_scale > 0.0:
                raise ArgumentsError(
                    "residual BQ index needs metadata.residual_scale > 0 "
                    "(beta = E|r_i|, set by IVFIndex.encode)")
        pad = torch.from_numpy(self.bucket_ids.reshape(-1) < 0).to(self.device)
        nslots = self.bucket_ids.size
        if self.metadata.kind == "bq":
            npad = self.quantizer.planes.shape[1]
            self._resid_bq = self._mask_pads(torch.zeros(npad, device=self.device), pad, nslots)
            return
        s = self.metadata.bucket_size
        qz = self.quantizer
        if self.metadata.kind == "sq":
            meta = qz.metadata
            extra = torch.zeros(qz.voffsets.shape[0], device=self.device)
            if rowcoef != 0.0:
                extra[:nslots] = rowcoef * ivf_ops.sq_decoded_rowterm(
                    qz.codes, meta.alpha, meta.offset, self._means_dev, s, self.params.dim)
            self._resid_sq = self._mask_pads(extra, pad, nslots)
        else:
            codes, transposed = qz.resident_codes
            extra = torch.zeros(codes.shape[1 if transposed else 0], device=self.device)
            if rowcoef != 0.0:
                extra[:nslots] = rowcoef * ivf_ops.pq_decoded_rowterm(
                    None if transposed else codes, qz._c_chunks, qz._rot,
                    self._means_dev, s, qz.metadata.vector_division,
                    codes_t=codes if transposed else None)
            self._resid_pq = self._mask_pads(extra, pad, nslots)

    @staticmethod
    def _mask_pads(extra, pad, nslots):
        extra[:nslots] = torch.where(pad, extra.new_full((), NEG), extra[:nslots])
        extra[nslots:] = NEG
        return extra

    # ------------------------------------------------------------- build
    @classmethod
    def encode(
        cls,
        data,
        params: VectorParameters,
        *,
        quantizer: str = "sq",
        nlist: Optional[int] = None,
        bucket_size: Optional[int] = None,
        nprobe: int = 32,
        nscan: Optional[int] = None,
        seed: int = 0,
        residual: bool = False,
        stop_condition=None,
        device=None,
        **quantizer_kwargs,
    ) -> "IVFIndex":
        """Cluster, permute and inner-encode on ``device`` (default: the CUDA
        card), as the JAX package builds it, draw for draw.

        ``nlist`` / ``bucket_size`` default to ``auto_geometry``. ``data`` is
        a materialized [count, dim] array. ``quantizer`` is "sq" | "pq" |
        "bq" or one of the quantizer classes; extra kwargs (quantile,
        chunk_size, bits, rotation, ...) pass to its ``encode``. The inner
        corpus is padded to nbuckets * bucket_size rows with duplicates of
        real rows, masked at search. ``residual=True`` (SQ / PQ with DOT or
        L2, BQ with DOT; bucket_size a multiple of 512) encodes v - bucket
        mean. Residual BQ lifts recall where buckets are tight against the
        data scale (clustered, unnormalized corpora) and loses on
        unit-normalized ones, where the build warns (the JAX package's
        measured rule)."""
        device = resolve_device(device)
        registry = _registry()
        if isinstance(quantizer, str):
            if quantizer not in registry:
                raise ArgumentsError(
                    f"quantizer must be one of {sorted(registry)}, got {quantizer!r}")
            kind = quantizer
        else:
            kind = next((kk for kk, c in registry.items() if c is quantizer), None)
            if kind is None:
                raise ArgumentsError(f"unsupported quantizer class {quantizer!r}")
        qcls = registry[kind]
        if callable(data) and not hasattr(data, "shape"):
            raise ArgumentsError(
                "IVFIndex.encode needs a materialized array (the build permutes the corpus)")
        data = np.asarray(data, np.float32)
        if data.shape != (params.count, params.dim):
            raise ArgumentsError(
                f"data shape {data.shape} does not match vector parameters "
                f"({params.count}, {params.dim})")
        if params.count < 1:
            raise ArgumentsError("IVFIndex needs a non-empty corpus")
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
                    "residual=True with quantizer 'bq' supports DOT only (the L2 "
                    "expansion needs a per-slot |v^|^2 additive, which the 1-bit plane "
                    "layout has no carrier for)")
            if bucket_size % CORR_BLK:
                raise ArgumentsError(
                    f"residual=True needs bucket_size to be a multiple of {CORR_BLK}, "
                    f"got {bucket_size}")
            if kind == "bq":
                _warn_if_normalized(data, params.count, seed)
        check_stop(stop_condition)

        n = params.count
        rng = np.random.default_rng(seed)
        sample_n = min(n, max(nlist, ivf_ops.IVF_SAMPLE_PER_CENTER * nlist),
                       ivf_ops.sample_cap(nlist))
        sample_idx = rng.choice(n, size=sample_n, replace=False) if sample_n < n else np.arange(n)
        centers = ivf_ops.train_centers(data[sample_idx], nlist, seed=seed,
                                        stop_condition=stop_condition, device=device)
        assignments = ivf_ops.assign_clusters(data, centers, stop_condition=stop_condition,
                                              device=device)
        perm, bucket_ids = ivf_ops.build_buckets(assignments, bucket_size)
        means = ivf_ops.bucket_means(data, perm, bucket_ids)
        check_stop(stop_condition)
        permuted = data[perm]
        residual_scale = 0.0
        if residual:
            ivf_ops.residualize_inplace(permuted, means, bucket_ids)
            if kind == "bq":
                # beta = E|r_i| over a row sample, drawn from the same stream
                # after the training sample, as the JAX package draws it.
                ridx = rng.choice(perm.shape[0], size=min(perm.shape[0], 262_144),
                                  replace=False)
                residual_scale = max(float(np.mean(np.abs(permuted[ridx]))), 1e-30)
            inner_params = VectorParameters(params.dim, perm.shape[0], DistanceType.DOT, False)
        else:
            inner_params = VectorParameters(params.dim, perm.shape[0], params.distance_type,
                                            params.invert)
        inner = qcls.encode(permuted, inner_params, stop_condition=stop_condition,
                            device=device, **quantizer_kwargs)
        meta = IVFMetadata(
            nlist=nlist, bucket_size=bucket_size, nprobe=nprobe, kind=kind,
            nbuckets=bucket_ids.shape[0], vector_parameters=params, nscan=nscan,
            residual=residual, residual_scale=residual_scale,
        )
        return cls(inner, bucket_ids, means, meta)

    # ------------------------------------------------------------- query
    @property
    def count(self) -> int:
        return self.params.count

    def encode_query(self, queries):
        """(f32 queries [Q, D] on the device, the inner quantizer's encoded
        queries, or for a residual index its residual form)."""
        qz, kind = self.quantizer, self.metadata.kind
        if kind == "pq":
            return encode_ivf_query(queries, self.metadata, qz.metadata, self.device,
                                    c_chunks=qz._c_chunks, rot=qz._rot)
        return encode_ivf_query(
            queries, self.metadata, qz.metadata, self.device,
            width=qz.codes.shape[1] if kind == "sq" else qz.planes.shape[0],
            store_type=getattr(qz, "store_type", "u128"))

    def _family_arrays(self, eq_inner) -> Tuple[tuple, Optional[tuple]]:
        kind = self.metadata.kind
        qz = self.quantizer
        if kind == "sq":
            if self.metadata.residual:
                return ((eq_inner.codes, eq_inner.offsets),
                        (qz.codes, self._resid_sq, eq_inner.mult))
            return (eq_inner.codes, eq_inner.offsets), (qz.codes, qz.voffsets, qz._mult)
        if kind == "bq":
            if self.metadata.residual:
                return (eq_inner.codes, eq_inner.mult, eq_inner.qb), (qz.planes,)
            return (eq_inner.planes,), (qz.planes,)
        # PQ's inner arrays depend on the scan: indexed reads the transposed
        # layout, compact whichever layout the quantizer holds.
        return (eq_inner.lut,), None

    def top_k_device(self, equery, k: int, method: str = "exact", nprobe: Optional[int] = None,
                     nscan: Optional[int] = None, scan: str = "auto",
                     recall_target: Optional[float] = None):
        """Probe + probed-bucket scan + select, on the device.

        ``nprobe``: per-query probe votes; ``nscan``: batch-shared scanned
        buckets (default ``4 * nprobe``, capped at the bucket count).
        ``method``: "exact" (value-exact selection over the scanned buckets)
        or "approx" (stride-class candidates). ``scan``: "indexed" reads the
        selected buckets in place (SQ, and BQ / PQ approx, with a bucket
        size the family's tile divides), "compact" gathers them first,
        "auto" prefers indexed where it is available. ``recall_target``:
        checked and ignored (``check_recall_target``)."""
        q, eq_inner = equery
        meta, qz = self.metadata, self.quantizer
        kind = meta.kind
        p, u, kk2, use_fused, precision, itile = _search_plan(
            meta, self._max_dup, k, nprobe, nscan, method, scan, recall_target,
            dp=qz.planes.shape[0] * 32 if kind == "bq" else None)
        if (itile and kind == "pq" and scan == "auto" and qz._codes_t is None
                and qz._codes.numel() > _PQ_T_BYTES_CAP):
            itile = 0  # the transposed layout it would build is past its budget
        eq, inner = self._family_arrays(eq_inner)
        if kind == "pq":
            inner = (qz.codes_t, True) if itile else qz.resident_codes
        resid = None
        if meta.residual:
            rowadd = {"pq": self._resid_pq, "bq": self._resid_bq}.get(kind)
            resid = (self._res_a,) if rowadd is None else (self._res_a, rowadd)
        return _ivf_search(
            q, eq, self._means_dev, self._slot_ids_dev, inner, resid, kind=kind, k=int(k),
            p=p, u=u, method=method, dt=self.params.distance_type, invert=self.params.invert,
            s=meta.bucket_size, dim=self.params.dim, use_fused=use_fused, kk2=kk2,
            itile=itile, precision=precision,
        )

    def top_k(self, equery, k: int, method: str = "exact", nprobe: Optional[int] = None,
              nscan: Optional[int] = None, scan: str = "auto",
              recall_target: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        sv, ids = self.top_k_device(equery, k, method=method, nprobe=nprobe, nscan=nscan,
                                    scan=scan, recall_target=recall_target)
        return sv.cpu().numpy(), ids.cpu().numpy()

    # ----------------------------------------------------------- storage
    def save(self, data_path, meta_path) -> None:
        """Four files, the JAX package's format: the inner quantizer's own
        (data_path, meta_path) pair plus ``<data_path>.ivf`` (bucket_ids and
        bucket_means, raw little-endian) and ``<meta_path>.ivf.json``. A
        residual index's inner pair scores residuals under DOT parameters;
        its search arrays are derived again at load."""
        self.quantizer.save(data_path, meta_path)
        with open(f"{os.fspath(meta_path)}.ivf.json", "w") as f:
            json.dump(self.metadata.to_json(), f)
        with open(f"{os.fspath(data_path)}.ivf", "wb") as f:
            f.write(self.bucket_ids.astype("<i4").tobytes())
            f.write(self.bucket_means.astype("<f4").tobytes())

    @classmethod
    def load(cls, data_path, meta_path, params: VectorParameters, device=None) -> "IVFIndex":
        """Load onto ``device`` (default: the CUDA card). ``params`` describes
        the original corpus (count = N); the inner quantizer is loaded with
        the padded count of the IVF metadata (and DOT parameters for a
        residual index)."""
        device = resolve_device(device)
        try:
            with open(f"{os.fspath(meta_path)}.ivf.json") as f:
                meta = IVFMetadata.from_json(json.load(f))
        except (OSError, KeyError, ValueError) as e:
            raise StorageIOError(f"cannot read IVF metadata: {e}") from e
        b, s, d = meta.nbuckets, meta.bucket_size, params.dim
        if meta.residual:
            inner_params = VectorParameters(d, b * s, DistanceType.DOT, False)
        else:
            inner_params = VectorParameters(d, b * s, params.distance_type, params.invert)
        inner = _registry()[meta.kind].load(data_path, meta_path, inner_params, device=device)
        sizes = (b * s * 4, b * d * 4)
        try:
            with open(f"{os.fspath(data_path)}.ivf", "rb") as f:
                blob = f.read()
        except OSError as e:
            raise StorageIOError(f"cannot read IVF data: {e}") from e
        if len(blob) != sum(sizes):
            raise StorageIOError(f"IVF blob size {len(blob)} != expected {sum(sizes)}")
        ids = np.frombuffer(blob[: sizes[0]], "<i4").reshape(b, s)
        means = np.frombuffer(blob[sizes[0] :], "<f4").reshape(b, d)
        return cls(inner, ids, means, meta)
