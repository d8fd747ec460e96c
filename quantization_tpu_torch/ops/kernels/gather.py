"""SQ candidate rescoring: the wrapper of the hand-written K4 kernel, beside
its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/gather.py`` together with the scoring
that follows the gather in ``quantization_tpu/models/sq.py``
(``_score_candidates_gathered``). The TPU gathered the candidate code rows
into a dense [Q*R, D] tile by DMA and scored it on the matrix unit; the
kernel (``csrc/gather_kernels.cu``) reads each row with one warp and scores
it where it lands, so the gathered rows are never written, and the TPU's
chunking of the id list (its SMEM budget) has no counterpart.

The wrapper takes the plain version for a CPU tensor. For a CUDA tensor it
checks its operands, launches on the current stream (reading the model's
multiplier tensor in place, with no per-call copy), counts the launch in
``LAUNCHES`` and raises on any error — it never falls back.
"""

from __future__ import annotations

import torch

from ...core.types import ArgumentsError, DistanceType
from .. import sq as sq_ops
from ..dispatch import use_kernels
from .build import check, load_library
from .ktile import check_tensors
from .sq_kernel import mult_arg

#: Kernel launches since the last reset (plain runs not counted).
LAUNCHES = {"sq_score_candidates": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sq_score_candidates_plain(
    qcodes, qoff, codes, voff, cand, multiplier, *, distance_type, n_valid
):
    """Plain version of K4: [Q, R] f32, -inf where an id is outside
    [0, n_valid)."""
    return sq_ops.score_candidates(
        qcodes, qoff, codes, voff, cand, multiplier,
        distance_type=distance_type, n_valid=n_valid,
    )


def sq_score_candidates(
    qcodes, qoff, codes, voff, cand, multiplier, *, distance_type, n_valid
):
    """[Q, R] f32 scores of per-query candidate ids cand[Q, R]:
    (mult * k(q, codes[id]) + qoff) + voff[id], k the int8 dot (DOT, L2) or
    the L1 distance; -inf, with no read, where an id is outside
    [0, n_valid)."""
    if not use_kernels(codes):
        return sq_score_candidates_plain(
            qcodes, qoff, codes, voff, cand, multiplier,
            distance_type=distance_type, n_valid=n_valid,
        )
    cand = cand.to(torch.int32).contiguous()
    q, d = qcodes.shape
    npad = codes.shape[0]
    r = cand.shape[-1]
    check_tensors(codes.device, (
        ("qcodes", qcodes, torch.int8, (q, d)),
        ("codes", codes, torch.int8, (npad, d)),
    ), align=16)
    check_tensors(codes.device, (
        ("qoff", qoff, torch.float32, (q,)),
        ("voff", voff, torch.float32, (npad,)),
        ("cand", cand, torch.int32, (q, r)),
    ))
    if d % 16:
        raise ArgumentsError(f"D={d} must be a multiple of 16")
    if not 0 <= n_valid <= npad:
        raise ArgumentsError(f"n_valid={n_valid} outside [0, {npad}]")
    out = torch.empty((q, r), dtype=torch.float32, device=codes.device)
    if q == 0 or r == 0:
        return out
    mult, mstride = mult_arg(multiplier, q, codes.device)
    lib = load_library()
    err = lib.qtt_sq_rescore(
        qcodes.data_ptr(), qoff.data_ptr(), mult.data_ptr(), codes.data_ptr(),
        voff.data_ptr(), cand.data_ptr(), out.data_ptr(), q, r, n_valid, d,
        int(distance_type == DistanceType.L1), mstride,
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    check(lib, err, "sq_score_candidates")
    LAUNCHES["sq_score_candidates"] += 1
    return out
