"""SQ scoring and fused search: wrappers of the hand-written CUDA kernels,
each beside its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/sq_kernel.py``. The kernels live in
``quantization_tpu_torch/csrc/sq_kernels.cu``:

  * K3 ``sq_scores``            — the [Q, n_valid] f32 score matrix, DOT / L2;
  * K12 ``sq_scores`` with L1    — the same with the sum of absolute
    differences, ``mult*L1 + qoff`` rounded once, then ``+ voff`` (F24);
  * K1 ``sq_search`` exact      — scores fused with an exact per-split top-k;
  * K2 ``sq_search`` approx     — scores fused with the stride-class maxima;
  * K9b / K9a ``sq_search_indexed`` exact / approx — the K1 / K2 bodies
    walking a selected list of corpus tiles in place (the IVF probe scan).

The searches take an optional residual-IVF ``corr``: one f32 per query and
512-row block (``ktile.CORR_BLK``), added after the epilogue and before
selection, in the dense layout [Q, Npad/512] or, for the indexed scans, in
selection order [T*tile_n/512, Q] (the j-th selected tile's blocks at rows
j*tile_n/512 ..), as the JAX kernels take it.

Each wrapper takes the plain version for a CPU tensor. For a CUDA tensor it
checks device, dtype, shape and contiguity, allocates its outputs, launches
on the current stream without synchronising, counts the launch in
``LAUNCHES``, and raises on any error — it never falls back.
"""

from __future__ import annotations

import torch

from ...core.types import ArgumentsError, DistanceType
from .. import sq as sq_ops
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

# Corpus rows are padded to a multiple of this by the quantizer.
TILE_N = 512
# Queries per block of the exact body (csrc/dot_scan.cuh ExactTile); its
# blocks cover ranges of EXACT_SPLIT rows (ktile.exact_geometry).
EXACT_TQ = 64
# Depth of a staged code chunk in the kernels: D must be a multiple.
D_ALIGN = 128

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"sq_scores": 0, "sq_scores_l1": 0, "sq_search_exact": 0,
            "sq_search_approx": 0, "sq_search_indexed_exact": 0,
            "sq_search_indexed_approx": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def approx_tile_n(npad: int) -> int:
    """The JAX approx tile width (sq_kernel.py:314-316): 512 widened to 2048
    while it divides npad. Slot blocks span SPAN such tiles."""
    tile_n = TILE_N
    while tile_n * 2 <= 2048 and npad % (tile_n * 2) == 0:
        tile_n *= 2
    return tile_n


def mult_arg(multiplier, q: int, device):
    """The multiplier as the SQ kernels read it, (f32 tensor, stride), query
    q's value at q * stride: one value for all (stride 0) or one per query
    ([Q] or [Q, 1]). A model's multiplier tensor on the card passes without
    a copy."""
    m = torch.as_tensor(multiplier, dtype=torch.float32, device=device).reshape(-1)
    if m.numel() == 1:
        return m, 0
    if m.numel() != q:
        raise ArgumentsError(f"multiplier has {m.numel()} values for {q} queries")
    return m.contiguous(), 1


def _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid, search=True):
    if search and distance_type == DistanceType.L1:
        raise ArgumentsError("the fused SQ searches take DOT and L2; L1 scores, then selects")
    q, d = qcodes.shape
    npad = codes.shape[0]
    check_tensors(codes.device, (
        ("qcodes", qcodes, torch.int8, (q, d)),
        ("qoff", qoff, torch.float32, (q,)),
        ("codes", codes, torch.int8, (npad, d)),
        ("voff", voff, torch.float32, (npad,)),
    ), align=16)
    if d % D_ALIGN:
        raise ArgumentsError(f"D={d} must be a multiple of {D_ALIGN}")
    if npad % TILE_N:
        raise ArgumentsError(f"N={npad} must be padded to a multiple of {TILE_N}")
    if not 0 <= n_valid <= npad:
        raise ArgumentsError(f"n_valid={n_valid} outside [0, {npad}]")


# ------------------------------------------------------------ K3 / K12


def sq_scores_plain(qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid):
    """Plain version of K3 (DOT / L2) and K12 (L1): [Q, n_valid] f32 scores."""
    return sq_ops.score_batch(
        qcodes, qoff, codes[:n_valid], voff[:n_valid], multiplier,
        distance_type=distance_type,
    )


def sq_scores(qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid):
    """[Q, n_valid] f32 scores (mult*dot + qoff) + voff (K3), or with L1
    (mult*L1 + qoff, rounded once) + voff (K12). Rows [n_valid, Npad) are
    never scored, so a caller may pass a slice of a corpus padded to 512
    rows."""
    if not use_kernels(codes):
        return sq_scores_plain(
            qcodes, qoff, codes, voff, multiplier,
            distance_type=distance_type, n_valid=n_valid,
        )
    _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid, search=False)
    q, d = qcodes.shape
    out = torch.empty((q, n_valid), dtype=torch.float32, device=codes.device)
    if q == 0 or n_valid == 0:
        return out
    mult, mstride = mult_arg(multiplier, q, codes.device)
    lib = load_library()
    args = (qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(), codes.data_ptr(),
            voff.data_ptr(), out.data_ptr(), q, n_valid, d, mstride)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    name = "sq_scores_l1" if distance_type == DistanceType.L1 else "sq_scores"
    err = getattr(lib, "qtt_" + name)(*args, stream)
    check(lib, err, name)
    LAUNCHES[name] += 1
    return out


# ------------------------------------------------------------- K1 / K2


def sq_search_plain(
    qcodes, qoff, codes, voff, multiplier, corr=None, *, distance_type, n_valid, k,
    mode="exact",
):
    """Plain version of K1 (exact) and K2 (approx): (f32 [Q, k], i32 [Q, k]).

    Exact: top-k of the valid scores (plus ``corr``), padded with -inf / -1
    when k > n_valid. Approx: the same stride-class candidates as the kernel
    (``ktile``), then an exact merge."""
    scores = sq_ops.score_batch(
        qcodes, qoff, codes, voff, multiplier, distance_type=distance_type
    )
    if corr is not None:
        scores = scores + expand_corr(corr)
    q, npad = scores.shape
    if mode == "exact":
        ids = torch.arange(n_valid, dtype=torch.int32, device=scores.device)
        return merge_exact(scores[:, :n_valid], ids.expand(q, n_valid), k)
    scores[:, n_valid:] = NEG
    vals, ids = approx_candidates(scores, approx_tile_n(npad))
    return merge_candidates(vals, ids, k)


def sq_search(
    qcodes, qoff, codes, voff, multiplier, corr=None, *, distance_type, n_valid, k,
    mode="exact",
):
    """Fused SQ search, never materializing the [Q, N] score matrix.
    Returns (scores f32[Q, k], indices i32[Q, k]). DOT/L2 only.

    ``mode="exact"`` (K1): value-exact for any k <= FUSED_K_MAX; ids may
    differ from torch.topk's only among tied scores; slots beyond n_valid
    hold -inf / -1. ``mode="approx"`` (K2):
    one max per stride class of SPAN tiles, exact merge, k <= APPROX_K_MAX.
    ``corr`` f32 [Q, Npad/512]: the residual-IVF additive (see above)."""
    check_search(mode, k)
    if not use_kernels(codes):
        return sq_search_plain(
            qcodes, qoff, codes, voff, multiplier, corr,
            distance_type=distance_type, n_valid=n_valid, k=k, mode=mode,
        )
    _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid)
    npad = codes.shape[0]
    if corr is not None:
        check_tensors(codes.device, (
            ("corr", corr, torch.float32, (qcodes.shape[0], npad // CORR_BLK)),))
    return _launch_search(
        qcodes, qoff, codes, voff, multiplier, None, TILE_N, corr, npad, n_valid, k, mode,
        "sq_search_" + mode, span_rows=SPAN * approx_tile_n(npad),
    )


def _launch_search(qcodes, qoff, codes, voff, multiplier, sel, tile_n, corr, ncomp,
                   n_valid, k, mode, name, span_rows):
    """Launch K1 / K9b (exact) or K2 / K9a (approx) over ``ncomp`` compact
    rows (``sel`` None: dense) and merge; counts the launch as ``name``."""
    q, d = qcodes.shape
    dev = codes.device
    mult, mstride = mult_arg(multiplier, q, dev)
    scan = (
        0 if sel is None else sel.data_ptr(), tile_n,
        0 if corr is None else corr.data_ptr(),
        *(corr_strides(corr, q, sel is not None) if corr is not None else (0, 0)),
    )
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "exact":
        kk, split, width, route = exact_geometry(k, ncomp, q, EXACT_TQ)
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q and ncomp:
            err = lib.qtt_sq_search_exact(
                qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(),
                codes.data_ptr(), voff.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                q, ncomp, n_valid, d, split, kk, mstride, *scan, stream,
            )
            check(lib, err, name)
            LAUNCHES[name] += 1
            SELECT_LAUNCHES[route] += 1
        return merge_exact(vals, ids, k)

    part = approx_geometry(ncomp, q, span_rows, sm_count(dev))
    part_v, part_i, vals, ids = approx_buffers(q, ncomp, span_rows, part, dev)
    if q and ncomp:
        err = lib.qtt_sq_search_approx(
            qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(), codes.data_ptr(),
            voff.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), q, ncomp, n_valid, d, part, span_rows, mstride,
            *scan, stream,
        )
        check(lib, err, name)
        LAUNCHES[name] += 1
    return merge_candidates(vals, ids, k)


# ------------------------------------------------------------ K9b / K9a


def _check_indexed(tile_sel, tile_n, npad, corr, q, dev):
    if tile_n % TILE_N or npad % tile_n:
        raise ArgumentsError(
            f"tile_n={tile_n} must be a multiple of {TILE_N} dividing N={npad}")
    nt = tile_sel.shape[0]
    check_tensors(dev, (("tile_sel", tile_sel, torch.int32, (nt,)),))
    if corr is not None:
        check_tensors(dev, (
            ("corr", corr, torch.float32, (nt * tile_n // CORR_BLK, q)),))


def sq_search_indexed_plain(
    qcodes, qoff, codes, voff, multiplier, tile_sel, corr=None, *, distance_type, k,
    mode="approx", tile_n=TILE_N,
):
    """Plain version of K9b (exact) and K9a (approx): the selected tiles'
    rows gathered in selection order and searched as K1 / K2 search them,
    with ``corr`` in selection order; ids are corpus rows."""
    rows = tile_rows(tile_sel, tile_n)
    scores = sq_ops.score_batch(
        qcodes, qoff, codes[rows], voff[rows], multiplier, distance_type=distance_type
    )
    if corr is not None:
        scores = scores + expand_corr(corr, selection=True)
    q, n = scores.shape
    gid = rows.to(torch.int32)
    if mode == "exact":
        return merge_exact(scores, gid.expand(q, n), k)
    vals, loc = approx_candidates(scores, tile_n)
    return merge_candidates(vals, gid[loc.long()], k)


def sq_search_indexed(
    qcodes, qoff, codes, voff, multiplier, tile_sel, corr=None, *, distance_type, k,
    mode="approx", tile_n=TILE_N,
):
    """Fused SQ search over the selected tiles ``tile_sel`` i32 [T] of
    ``tile_n`` rows (tile t = corpus rows [t*tile_n, (t+1)*tile_n), tile_n a
    multiple of 512 dividing Npad): the IVF probe scan, K9b (exact) and K9a
    (approx). The kernels read the selected tiles in place, so no [T*tile_n,
    D] copy and no [Q, T*tile_n] score matrix is made. Every selected row is
    valid. ``corr`` f32 [T*tile_n/512, Q] in selection order. Returns
    (scores f32[Q, k], ids i32[Q, k]), ids corpus rows. DOT/L2 only."""
    check_search(mode, k)
    if not use_kernels(codes):
        return sq_search_indexed_plain(
            qcodes, qoff, codes, voff, multiplier, tile_sel, corr,
            distance_type=distance_type, k=k, mode=mode, tile_n=tile_n,
        )
    npad = codes.shape[0]
    _check_operands(qcodes, qoff, codes, voff, distance_type, npad)
    _check_indexed(tile_sel, tile_n, npad, corr, qcodes.shape[0], codes.device)
    ncomp = tile_sel.shape[0] * tile_n
    return _launch_search(
        qcodes, qoff, codes, voff, multiplier, tile_sel, tile_n, corr, ncomp, ncomp, k,
        mode, "sq_search_indexed_" + mode, span_rows=SPAN * tile_n,
    )
