"""SQ scoring and fused search: wrappers of the hand-written CUDA kernels,
each beside its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/sq_kernel.py``. The kernels live in
``quantization_tpu_torch/csrc/sq_kernels.cu``:

  * K3 ``sq_scores``            — the [Q, n_valid] f32 score matrix;
  * K1 ``sq_search`` exact      — scores fused with an exact per-split top-k;
  * K2 ``sq_search`` approx     — scores fused with the stride-class maxima.

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
    NEG,
    SPAN,
    approx_candidates,
    check_search,
    check_tensors,
    merge_candidates,
    merge_exact,
)

# Corpus rows are padded to a multiple of this by the quantizer.
TILE_N = 512
# Corpus rows per K1 block (csrc: one split of shared-memory keys).
EXACT_SPLIT = 512
# Corpus rows per K2 pass-1 block; divides every approx span (SPAN * tile_n).
APPROX_PART = 2048
# Depth of a staged code chunk in the kernels: D must be a multiple.
D_ALIGN = 128

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"sq_scores": 0, "sq_search_exact": 0, "sq_search_approx": 0}


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


def _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid):
    if distance_type == DistanceType.L1:
        raise ArgumentsError("the SQ kernels score DOT and L2; L1 takes the plain path")
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


# ------------------------------------------------------------------ K3


def sq_scores_plain(qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid):
    """Plain version of K3: [Q, n_valid] f32 scores."""
    return sq_ops.score_batch(
        qcodes, qoff, codes[:n_valid], voff[:n_valid], multiplier,
        distance_type=distance_type,
    )


def sq_scores(qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid):
    """[Q, n_valid] f32 scores (mult*dot + qoff) + voff."""
    if not use_kernels(codes):
        return sq_scores_plain(
            qcodes, qoff, codes, voff, multiplier,
            distance_type=distance_type, n_valid=n_valid,
        )
    _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid)
    q, d = qcodes.shape
    out = torch.empty((q, n_valid), dtype=torch.float32, device=codes.device)
    if q == 0 or n_valid == 0:
        return out
    mult, mstride = mult_arg(multiplier, q, codes.device)
    lib = load_library()
    err = lib.qtt_sq_scores(
        qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(), codes.data_ptr(),
        voff.data_ptr(), out.data_ptr(), q, n_valid, d, mstride,
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    check(lib, err, "sq_scores")
    LAUNCHES["sq_scores"] += 1
    return out


# ------------------------------------------------------------- K1 / K2


def sq_search_plain(
    qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid, k, mode="exact"
):
    """Plain version of K1 (exact) and K2 (approx): (f32 [Q, k], i32 [Q, k]).

    Exact: top-k of the valid scores, padded with -inf / -1 when k > n_valid.
    Approx: the same stride-class candidates as the kernel (``ktile``), then
    an exact merge."""
    scores = sq_ops.score_batch(
        qcodes, qoff, codes, voff, multiplier, distance_type=distance_type
    )
    q, npad = scores.shape
    if mode == "exact":
        ids = torch.arange(n_valid, dtype=torch.int32, device=scores.device)
        return merge_exact(scores[:, :n_valid], ids.expand(q, n_valid), k)
    scores[:, n_valid:] = NEG
    vals, ids = approx_candidates(scores, approx_tile_n(npad))
    return merge_candidates(vals, ids, k)


def sq_search(
    qcodes, qoff, codes, voff, multiplier, *, distance_type, n_valid, k, mode="exact"
):
    """Fused SQ search, never materializing the [Q, N] score matrix.
    Returns (scores f32[Q, k], indices i32[Q, k]). DOT/L2 only.

    ``mode="exact"`` (K1): value-exact for any k <= FUSED_K_MAX; ids may
    differ from torch.topk's only among tied scores; slots beyond n_valid
    hold -inf / -1. ``mode="approx"`` (K2):
    one max per stride class of SPAN tiles, exact merge, k <= APPROX_K_MAX."""
    check_search(mode, k)
    if not use_kernels(codes):
        return sq_search_plain(
            qcodes, qoff, codes, voff, multiplier,
            distance_type=distance_type, n_valid=n_valid, k=k, mode=mode,
        )
    _check_operands(qcodes, qoff, codes, voff, distance_type, n_valid)
    q, d = qcodes.shape
    npad = codes.shape[0]
    dev = codes.device
    mult, mstride = mult_arg(multiplier, q, dev)
    lib = load_library()
    if mode == "exact":
        kk = min(k, EXACT_SPLIT)
        width = -(-npad // EXACT_SPLIT) * kk
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q:
            err = lib.qtt_sq_search_exact(
                qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(),
                codes.data_ptr(), voff.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                q, npad, n_valid, d, EXACT_SPLIT, kk, mstride,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            check(lib, err, "sq_search_exact")
            LAUNCHES["sq_search_exact"] += 1
        return merge_exact(vals, ids, k)

    span_rows = SPAN * approx_tile_n(npad)
    nparts = -(-npad // APPROX_PART)
    nblocks = -(-npad // span_rows)
    part_v = torch.empty((q, nparts * 128), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, nparts * 128), dtype=torch.int32, device=dev)
    vals = torch.empty((q, nblocks * 128), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nblocks * 128), dtype=torch.int32, device=dev)
    if q:
        err = lib.qtt_sq_search_approx(
            qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(), codes.data_ptr(),
            voff.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), q, npad, n_valid, d, APPROX_PART, span_rows, mstride,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(lib, err, "sq_search_approx")
        LAUNCHES["sq_search_approx"] += 1
    return merge_candidates(vals, ids, k)
