"""BQ scoring and fused search: wrappers of the hand-written CUDA kernels,
each beside its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/bq_kernel.py``. The kernels live in
``quantization_tpu_torch/csrc/bq_kernels.cu``:

  * K6  ``bq_scores``          — the [Q, n_valid] f32 score matrix (the JAX
    package's ``bq_scores_mxu`` and ``bq_scores_pallas`` compute the same
    function for two TPU units; one kernel here stands for both);
  * K5c ``bq_search`` exact    — scores fused with an exact per-split top-k;
  * K5a ``bq_search`` approx   — scores fused with the stride-class maxima
    of the JAX approx kernel, over spans of ``SPAN * mxu_tile_n`` rows;
  * K10 ``bq_search_indexed``  — the K5a body walking a selected list of
    corpus tiles in place (the IVF probe scan), for packed sign queries.
    With sign queries K6, K5c, K5a and K10 run on the tensor cores:
    single-bit AND-popcount products (``wgmma`` b1) on the int8 scan body of
    ``csrc/dot_scan.cuh``, Hamming = popc(q) + popc(c) - 2 popc(q & c);
    K5a and K10 on ``bq_sign_approx_ws_kernel`` (warp-specialized, A from
    registers) at the depths it is built for, where its layout fits
    (counted in ``SIGN_WS_LAUNCHES`` too);
  * the residual-BQ forms, with ``query_affine=(qs, mult, qb)`` — an int8
    VALUE query [Q, W8*32] scored ``mult * (qs . bits) + qb`` against the
    sign bits — a per-row additive ``rowadd`` and the bucket additive
    ``corr``: K5b (``bq_search``
    exact), K5a (approx) and K10 (``bq_search_indexed``). They are the SQ
    scan bodies over bit planes expanded to 0/1 bytes
    (``csrc/dot_scan.cuh``), counted as ``*_res`` in ``LAUNCHES``.

Operands: query words int32 [Q, W8] and corpus planes int32 [W8, Npad]
holding uint32 bits (``ops/bq.py``), Npad a multiple of ``TILE_N``, W8 of
``W_ALIGN``. Sign-query scores are exact integers, so those kernels equal
the plain versions to the bit and exact top-k values compare with ``==``.
The residual scores round ``mult * acc + qb`` once, in f64 (ROADMAP F24),
then add ``corr`` in f32, in the kernels and the plain versions alike, so
they too are equal to the bit. ``corr`` is one f32 per query and 512-row
block: [Q, Npad/512] for the dense searches, [T*tile_n/512, Q] in selection
order for the indexed one.

Each wrapper takes the plain version for a CPU tensor. For a CUDA tensor it
checks device, dtype, shape and contiguity, allocates its outputs, launches
on the current stream without synchronising, counts the launch in
``LAUNCHES``, and raises on any error — it never falls back.
"""

from __future__ import annotations

import torch

from ...core.types import ArgumentsError, DistanceType
from .. import bq as bq_ops
from ..dispatch import use_kernels
from .build import check, load_library
from .ktile import (
    CORR_BLK,
    EXACT_SPLIT,
    NEG,
    SELECT_LAUNCHES,
    SPAN,
    approx_buffers,
    approx_candidates,
    approx_geometry,
    check_search,
    check_tensors,
    corr_strides,
    exact_geometry,
    expand_corr,
    merge_candidates,
    merge_exact,
    sm_count,
    tile_rows,
)
from .sq_kernel import EXACT_TQ, mult_arg

# Corpus rows are padded to a multiple of this by the quantizer (the JAX
# package's TILE_N, bq_kernel.py:50).
TILE_N = 2048
# Plane words are padded to a multiple of this (the 8-sublane tile).
W_ALIGN = 8
# Queries per K5c block on the queue select (csrc/bq_kernels.cu
# SignQueueTile), whose blocks cover ranges of EXACT_SPLIT rows
# (ktile.exact_geometry); the radix select's blocks take 32 queries and one
# split. K5b runs the int8 exact body (EXACT_TQ).
SIGN_QUEUE_TQ = 64
# Corpus rows per pass-1 block of the sign-query K5a / K10 off the
# warp-specialized body (bq_sign_approx_kernel); divides every approx span.
# On that body a work item is approx_geometry's.
APPROX_PART = 2048
# Narrowest approx tile of the JAX package (its MXU_TILE_N); see mxu_tile_n.
MXU_TILE_N = 512

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"bq_scores": 0, "bq_search_exact": 0, "bq_search_approx": 0,
            "bq_search_indexed": 0, "bq_search_exact_res": 0, "bq_search_approx_res": 0,
            "bq_search_indexed_res": 0}
#: Of the sign-query K5a / K10 launches, those on the warp-specialized body
#: (csrc/bq_kernels.cu bq_sign_approx_ws_kernel).
SIGN_WS_LAUNCHES = {"bq_search_approx": 0, "bq_search_indexed": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, SIGN_WS_LAUNCHES):
        for name in counts:
            counts[name] = 0


def mxu_tile_n(dp: int, n: int) -> int:
    """The JAX approx tile width (``_mxu_tile_n``, bq_kernel.py:80-88): 512
    widened to 2048 while it divides the padded corpus and the TPU unpack
    temporaries (5 * dp * tile bytes) stay within 8 MB. At dim 1536 it is
    1024, so an approx span is 4096 rows."""
    tn = MXU_TILE_N
    while tn * 2 <= 2048 and n % (tn * 2) == 0 and 5 * dp * tn * 2 <= 8 * 2**20:
        tn *= 2
    return tn


def indexed_tile_n(dp: int, bucket_size: int) -> int:
    """The JAX indexed tile width (``indexed_tile_n``, bq_kernel.py:220-223):
    ``mxu_tile_n`` over one bucket, or 0 when the bucket is not a multiple
    of MXU_TILE_N rows."""
    return 0 if bucket_size % MXU_TILE_N else mxu_tile_n(dp, bucket_size)


def metric_sign(distance_type: DistanceType, invert: bool) -> int:
    """score = sign * (dim - 2 * xor): +1 for DOT or inverted L1/L2."""
    return 1 if (distance_type == DistanceType.DOT) != invert else -1


def true_words(dim: int) -> int:
    return -(-dim // 32)


def _check_planes(planes, n_valid):
    w8, npad = planes.shape
    check_tensors(planes.device, (("planes", planes, torch.int32, (w8, npad)),))
    if npad % TILE_N or w8 % W_ALIGN:
        raise ArgumentsError(
            f"planes [{w8}, {npad}] must be padded to [{W_ALIGN}k, {TILE_N}k]"
        )
    if not 0 <= n_valid <= npad:
        raise ArgumentsError(f"n_valid={n_valid} outside [0, {npad}]")


def _check_operands(qwords, planes, dim, n_valid):
    """A sign query's operands (a value query's: ``_check_planes`` and
    ``_launch_res``). The single-bit products copy the query words in
    16-byte pieces, so they must be 16-byte aligned."""
    w8 = planes.shape[0]
    check_tensors(planes.device, (("qwords", qwords, torch.int32, (qwords.shape[0], w8)),),
                  align=16)
    _check_planes(planes, n_valid)
    if not 1 <= true_words(dim) <= w8:
        raise ArgumentsError(f"dim={dim} needs 1..{w8} words")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ K6


def bq_scores_plain(qwords, planes, *, distance_type, invert, dim, n_valid):
    """Plain version of K6: [Q, n_valid] f32 scores by XOR + popcount."""
    return bq_ops.score_batch(
        qwords, planes[:, :n_valid],
        distance_type=distance_type, invert=invert, dim=dim,
    )


def bq_scores(qwords, planes, *, distance_type, invert, dim, n_valid):
    """[Q, n_valid] f32 binary scores."""
    if not use_kernels(planes):
        return bq_scores_plain(
            qwords, planes, distance_type=distance_type, invert=invert, dim=dim,
            n_valid=n_valid,
        )
    _check_operands(qwords, planes, dim, n_valid)
    q, w8 = qwords.shape
    out = torch.empty((q, n_valid), dtype=torch.float32, device=planes.device)
    if q == 0 or n_valid == 0:
        return out
    lib = load_library()
    err = lib.qtt_bq_scores(
        qwords.data_ptr(), planes.data_ptr(), out.data_ptr(), q, w8, planes.shape[1],
        n_valid, dim, metric_sign(distance_type, invert), _stream(planes),
    )
    check(lib, err, "bq_scores")
    LAUNCHES["bq_scores"] += 1
    return out


# ------------------------------------------------------------ K5c / K5a


def _plain_scores(qwords, planes, corr, query_affine, *, distance_type, invert, dim,
                  selection=False, rowadd=None):
    """[Q, N] scores of the plain versions: XOR + popcount for sign queries;
    for a value query ``score_affine``, plus ``rowadd`` [N] per row, plus the
    expanded ``corr``, in the kernels' order."""
    if query_affine is None:
        return bq_ops.score_batch(
            qwords, planes, distance_type=distance_type, invert=invert, dim=dim)
    scores = bq_ops.score_affine(*query_affine, planes)
    if rowadd is not None:
        scores = scores + rowadd[None, :]
    return scores if corr is None else scores + expand_corr(corr, selection=selection)


def _check_value_query(qwords, planes, corr, query_affine, rowadd, corr_shape):
    """A value query's optional operands: ``corr`` and ``rowadd`` ride a
    value query only; on a card, their types, shapes and devices."""
    if query_affine is None:
        if corr is not None or rowadd is not None:
            raise ArgumentsError("corr and rowadd are taken with a value query "
                                 "(query_affine) only")
        return
    if use_kernels(planes):
        if corr is not None:
            check_tensors(planes.device, (("corr", corr, torch.float32, corr_shape),))
        if rowadd is not None:
            check_tensors(planes.device, (
                ("rowadd", rowadd, torch.float32, (planes.shape[1],)),))


def bq_search_plain(
    qwords, planes, corr=None, *, distance_type, invert, dim, n_valid, k, mode="exact",
    query_affine=None, rowadd=None,
):
    """Plain version of K5c / K5b (exact) and K5a (approx): (f32 [Q, k],
    i32 [Q, k]).

    Exact: top-k of the valid scores, -inf / -1 past n_valid. Approx: the
    stride-class candidates of the JAX approx kernel over SPAN tiles of
    ``mxu_tile_n`` rows (rows >= n_valid score NEG), then an exact merge."""
    scores = _plain_scores(qwords, planes, corr, query_affine, distance_type=distance_type,
                           invert=invert, dim=dim, rowadd=rowadd)
    q, npad = scores.shape
    if mode == "exact":
        ids = torch.arange(n_valid, dtype=torch.int32, device=scores.device)
        return merge_exact(scores[:, :n_valid], ids.expand(q, n_valid), k)
    scores[:, n_valid:] = NEG
    vals, ids = approx_candidates(scores, mxu_tile_n(planes.shape[0] * 32, npad))
    return merge_candidates(vals, ids, k)


def bq_search(
    qwords, planes, corr=None, *, distance_type, invert, dim, n_valid, k, mode="exact",
    query_affine=None, rowadd=None,
):
    """Fused BQ search, never materializing the [Q, N] score matrix.
    Returns (scores f32[Q, k], indices i32[Q, k]).

    ``mode="exact"`` (K5c; K5b with ``query_affine``): value-exact for any
    k <= FUSED_K_MAX — each 512-row split returns its exact top-min(k, 512),
    so no spill bound and no fallback are needed; ids may differ from
    torch.topk's only among tied scores (BQ scores are small integers and
    tie constantly); slots beyond n_valid hold -inf / -1. ``mode="approx"``
    (K5a): one max per stride class of SPAN tiles, exact merge, k <=
    APPROX_K_MAX. ``query_affine=(qs, mult, qb)`` scores an int8 value
    query (``qwords`` is then unused) and takes ``corr`` [Q, Npad/512] and a
    per-row additive ``rowadd`` f32 [Npad] (residual IVF-BQ's NEG on pad
    slots), added before ``corr``."""
    check_search(mode, k)
    kw = dict(distance_type=distance_type, invert=invert, dim=dim, n_valid=n_valid)
    w8, npad = planes.shape
    _check_value_query(qwords, planes, corr, query_affine, rowadd,
                       None if query_affine is None
                       else (query_affine[0].shape[0], npad // CORR_BLK))
    if not use_kernels(planes):
        return bq_search_plain(qwords, planes, corr, k=k, mode=mode,
                               query_affine=query_affine, rowadd=rowadd, **kw)
    if query_affine is not None:
        _check_planes(planes, n_valid)
        return _launch_res(query_affine, planes, corr, rowadd, None, 0, npad, n_valid, k,
                           mode, SPAN * mxu_tile_n(w8 * 32, npad),
                           "bq_search_" + mode + "_res")
    _check_operands(qwords, planes, dim, n_valid)
    q = qwords.shape[0]
    dev = planes.device
    args = (q, w8, npad, n_valid, dim, metric_sign(distance_type, invert))
    if mode == "exact":
        kk, split, width, route = exact_geometry(k, npad, q, SIGN_QUEUE_TQ)
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q:
            lib = load_library()
            err = lib.qtt_bq_search_exact(
                qwords.data_ptr(), planes.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                *args, split, kk, _stream(planes),
            )
            check(lib, err, "bq_search_exact")
            LAUNCHES["bq_search_exact"] += 1
            SELECT_LAUNCHES[route] += 1
        return merge_exact(vals, ids, k)

    return _launch_approx(qwords, planes, args, None, 0, npad,
                          SPAN * mxu_tile_n(w8 * 32, npad), k, "bq_search_approx")


def _launch_res(query_affine, planes, corr, rowadd, sel, tile_n, ncomp, n_valid, k, mode,
                span_rows, name):
    """Launch K5b (exact) or K5a / K10 (approx, ``sel`` None: dense) with a
    value query over ``ncomp`` compact rows, and merge; counts ``name``."""
    qs, mult, qb = query_affine
    w8, npad = planes.shape
    q, dev = qs.shape[0], planes.device
    qb = qb.reshape(-1)
    check_tensors(dev, (("qs", qs, torch.int8, (q, w8 * 32)),), align=16)
    check_tensors(dev, (("qb", qb, torch.float32, (q,)),))
    m, mstride = mult_arg(mult, q, dev)
    scan = (
        0 if sel is None else sel.data_ptr(), tile_n,
        0 if corr is None else corr.data_ptr(),
        *(corr_strides(corr, q, sel is not None) if corr is not None else (0, 0)),
    )
    if rowadd is None:  # the kernels always add one (csrc/dot_scan.cuh epilogue)
        rowadd = torch.zeros(npad, dtype=torch.float32, device=dev)
    head = (qs.data_ptr(), qb.data_ptr(), m.data_ptr(), planes.data_ptr(), rowadd.data_ptr())
    lib = load_library()
    if mode == "exact":
        kk, split, width, route = exact_geometry(k, ncomp, q, EXACT_TQ)
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q and ncomp:
            err = lib.qtt_bq_search_exact_res(
                *head, vals.data_ptr(), ids.data_ptr(), q, w8, npad, ncomp, n_valid,
                split, kk, mstride, *scan, _stream(planes))
            check(lib, err, name)
            LAUNCHES[name] += 1
            SELECT_LAUNCHES[route] += 1
        return merge_exact(vals, ids, k)
    part = approx_geometry(ncomp, q, span_rows, sm_count(dev))
    bufs = approx_buffers(q, ncomp, span_rows, part, dev)
    if q and ncomp:
        err = lib.qtt_bq_search_approx_res(
            *head, *(b.data_ptr() for b in bufs), q, w8, npad, ncomp, n_valid, part,
            span_rows, mstride, *scan, _stream(planes))
        check(lib, err, name)
        LAUNCHES[name] += 1
    return merge_candidates(bufs[2], bufs[3], k)


def _sign_route(lib, q: int, w8: int) -> int:
    """The sign-query approx body for ``q`` queries of ``w8`` words, a
    function of the depth and the layout's fit alone (csrc/bq_kernels.cu
    sign_ws_tq): the query tile of bq_sign_approx_ws_kernel (128, or 64
    where q <= 64), or 0 off its route (bq_sign_approx_kernel)."""
    return lib.qtt_bq_sign_approx_ws_tq(q, w8)


def _launch_approx(qwords, planes, args, sel, tile_n, ncomp, span_rows, k, name):
    """Launch K5a / K10 over ``ncomp`` compact rows (``sel`` None: dense)
    and merge; counts the launch as ``name``. On the warp-specialized body
    (``_sign_route``; counted in SIGN_WS_LAUNCHES too) a work item is
    ``approx_geometry``'s part (span blocks in place, or smaller parts and
    the combine); on bq_sign_approx_kernel APPROX_PART rows and the
    combine."""
    q, dev = qwords.shape[0], planes.device
    lib = load_library() if q and ncomp else None
    tq = _sign_route(lib, q, qwords.shape[1]) if lib else 0
    part = approx_geometry(ncomp, q, span_rows, sm_count(dev)) if tq else APPROX_PART
    bufs = approx_buffers(q, ncomp, span_rows, part, dev)
    if lib:
        err = lib.qtt_bq_search_approx(
            qwords.data_ptr(), planes.data_ptr(), *(b.data_ptr() for b in bufs), *args,
            part, span_rows, 0 if sel is None else sel.data_ptr(), tile_n, ncomp, tq,
            _stream(planes),
        )
        check(lib, err, name)
        LAUNCHES[name] += 1
        SIGN_WS_LAUNCHES[name] += bool(tq)
    return merge_candidates(bufs[2], bufs[3], k)


# ------------------------------------------------------------------ K10


def bq_search_indexed_plain(qwords, planes, tile_sel, corr=None, *, distance_type, invert,
                            dim, k, tile_n, query_affine=None, rowadd=None):
    """Plain version of K10: the selected tiles' plane columns gathered in
    selection order (``rowadd`` and ``corr`` with them), their stride-class
    candidates over spans of SPAN tiles, an exact merge; ids are corpus
    rows."""
    rows = tile_rows(tile_sel, tile_n)
    scores = _plain_scores(qwords, planes[:, rows], corr, query_affine,
                           distance_type=distance_type, invert=invert, dim=dim,
                           selection=True, rowadd=None if rowadd is None else rowadd[rows])
    vals, loc = approx_candidates(scores, tile_n)
    return merge_candidates(vals, rows.to(torch.int32)[loc.long()], k)


def bq_search_indexed(qwords, planes, tile_sel, corr=None, *, distance_type, invert, dim, k,
                      tile_n, query_affine=None, rowadd=None):
    """Fused approx BQ search (K10) over the selected tiles ``tile_sel``
    i32 [T] of ``tile_n`` rows (tile t = corpus rows [t*tile_n, (t+1)*
    tile_n), tile_n a multiple of 512 dividing Npad, as ``indexed_tile_n``
    gives it): the IVF probe scan, reading the selected plane columns in
    place. Every selected row is valid. ``query_affine`` / ``rowadd`` /
    ``corr`` as in ``bq_search``, ``rowadd`` [Npad] by corpus row, ``corr``
    [T*tile_n/512, Q] in selection order. Returns (scores f32[Q, k], ids
    i32[Q, k]), ids corpus rows; k <= APPROX_K_MAX."""
    check_search("approx", k)
    kw = dict(distance_type=distance_type, invert=invert, dim=dim)
    npad = planes.shape[1]
    ncomp = tile_sel.shape[0] * tile_n
    _check_value_query(qwords, planes, corr, query_affine, rowadd,
                       None if query_affine is None
                       else (ncomp // CORR_BLK, query_affine[0].shape[0]))
    if not use_kernels(planes):
        return bq_search_indexed_plain(qwords, planes, tile_sel, corr, k=k, tile_n=tile_n,
                                       query_affine=query_affine, rowadd=rowadd, **kw)
    if query_affine is None:
        _check_operands(qwords, planes, dim, npad)
    else:
        _check_planes(planes, npad)
    if tile_n % MXU_TILE_N or npad % tile_n:
        raise ArgumentsError(
            f"tile_n={tile_n} must be a multiple of {MXU_TILE_N} dividing N={npad}")
    nt = tile_sel.shape[0]
    check_tensors(planes.device, (("tile_sel", tile_sel, torch.int32, (nt,)),))
    if query_affine is not None:
        return _launch_res(query_affine, planes, corr, rowadd, tile_sel, tile_n, ncomp, ncomp,
                           k, "approx", SPAN * tile_n, "bq_search_indexed_res")
    args = (qwords.shape[0], qwords.shape[1], npad, ncomp, dim,
            metric_sign(distance_type, invert))
    return _launch_approx(qwords, planes, args, tile_sel, tile_n, ncomp, SPAN * tile_n, k,
                          "bq_search_indexed")
