"""Scalar (u8) quantization ops: affine codec + batched integer scoring.

Twin of ``quantization_tpu/ops/sq.py``, in eager PyTorch:

  * codes live in [0, 127] (alpha = (max-min)/127, offset = min —
    encoded_vectors_u8.rs:228-232), so they fit **int8** and dot products
    are exact int32 sums.
  * layout is SoA: codes int8[N, D_lane] + per-vector f32 offsets[N].
  * D is padded in two steps exactly as in the JAX package: ``pad_code`` up
    to the reference's 16-aligned ``actual_dim``, then zeros up to the
    128-wide lane layout (zero columns contribute 0 to every kernel and sum),
    so the code matrices of the two packages compare whole.

Score contract (encoded_vectors_u8.rs:145-158):
    score = multiplier * int_kernel(Q, V) + query_offset + vector_offset
with multiplier = alpha^2 (DOT), alpha (L1), -2*alpha^2 (L2), negated when
``invert`` is set; DOT and L2 share the integer dot kernel, L1 uses the
sum-of-absolute-differences kernel.

Everything here is plain tensor code on whatever device its inputs lie on;
``score_batch`` is the plain version of the K3 kernel
(``ops/kernels/sq_kernel.py``), ``score_candidates`` that of the K4
rescoring kernel (``ops/kernels/gather.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.types import DistanceType

ALIGNMENT = 16  # reference row alignment (encoded_vectors_u8.rs:12)
LANE = 128  # in-memory code matrices are padded to this width
CODE_MAX = 127.0


def actual_dim(dim: int, alignment: int = ALIGNMENT) -> int:
    """dim rounded up to the reference's 16-byte alignment (get_actual_dim,
    encoded_vectors_u8.rs:257-259): the on-disk row width."""
    return dim + (alignment - dim % alignment) % alignment


def lane_dim(dim: int) -> int:
    """The in-memory column count: actual_dim rounded up to the lane width."""
    a = actual_dim(dim)
    return a + (-a) % LANE


def alpha_offset_from_min_max(mn: float, mx: float) -> Tuple[float, float]:
    """(alpha, offset) of the affine code map (encoded_vectors_u8.rs:228-232).
    alpha is clamped away from zero so constant data encodes to code 0."""
    alpha = (mx - mn) / CODE_MAX
    if not np.isfinite(alpha) or alpha <= 0.0:
        alpha = 1.0
    return float(alpha), float(mn)


def multiplier_for(distance_type: DistanceType, invert: bool, alpha: float) -> float:
    """Scalar applied to the raw integer kernel output
    (encoded_vectors_u8.rs:119-128)."""
    if distance_type == DistanceType.DOT:
        m = alpha * alpha
    elif distance_type == DistanceType.L1:
        m = alpha
    else:  # L2
        m = -2.0 * alpha * alpha
    return -m if invert else m


def _inv_alpha(alpha: float) -> float:
    """f32 reciprocal of alpha: the JAX package quantizes by multiplying with
    it, not by a true division, and codes must match it byte for byte."""
    return float(np.float32(1.0) / np.float32(alpha))


def _f32_to_code(x: torch.Tensor, alpha: float, offset: float) -> torch.Tensor:
    """clamp((x-offset)*inv_alpha, 0, 127), NaN -> 0, then floor — the JAX
    package's order of operations, in float32 (Python scalars combine with a
    float32 tensor in float32)."""
    q = (x - offset) * _inv_alpha(alpha)
    q = torch.clamp(q, 0.0, CODE_MAX)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return torch.floor(q)


def pad_code(distance_type: DistanceType, alpha: float, offset: float) -> int:
    """Code value used for padding up to actual_dim (encoded_vectors_u8.rs:84-93):
    DOT pads with the code of real value 0.0; L1/L2 pad with the code of
    `offset`, which is always 0. Host-computed with true IEEE division."""
    if distance_type == DistanceType.DOT:
        q = (np.float32(0.0) - np.float32(offset)) / np.float32(alpha)
        q = min(max(q, 0.0), CODE_MAX)
        if np.isnan(q):
            q = 0.0
        return int(q)
    return 0


def _encode(x, alpha, offset, distance_type, invert, dpad, lane, with_const):
    b, dim = x.shape
    if lane is None:
        lane = dpad
    codes_f = _f32_to_code(x.to(torch.float32), alpha, offset)
    if dpad > dim:
        pc = float(pad_code(distance_type, alpha, offset))
        codes_f = torch.cat([codes_f, codes_f.new_full((b, dpad - dim), pc)], dim=1)
    # The constants are Python doubles that round to f32 as scalars, as in
    # the JAX code; the code sums are integers < 2^24, exact in any order.
    if distance_type == DistanceType.L1:
        off = codes_f.new_zeros((b,))
    else:
        if distance_type == DistanceType.DOT:
            sums, scale = torch.sum(codes_f, dim=1), alpha * offset
        else:  # L2
            sums, scale = torch.sum(codes_f * codes_f, dim=1), alpha * alpha
        if with_const:
            # sum * scale + const with ONE rounding, as the JAX package's
            # compiled code does (XLA fuses it into a fused multiply-add):
            # in float64 the product of two f32 values is exact.
            off = (
                sums.to(torch.float64) * float(np.float32(scale))
                + float(np.float32(dpad * offset * offset))
            ).to(torch.float32)
        else:
            off = sums * scale
    if invert:
        off = -off
    if lane > dpad:
        codes_f = torch.cat([codes_f, codes_f.new_zeros((b, lane - dpad))], dim=1)
    return codes_f.to(torch.int8), off.to(torch.float32)


def quantize_batch(
    x: torch.Tensor,
    *,
    alpha: float,
    offset: float,
    distance_type: DistanceType,
    invert: bool,
    dpad: int,
    lane: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a [B, dim] float32 batch -> (codes int8[B, lane], voffset f32[B])
    (encoded_vectors_u8.rs:73-118): quantize, pad with ``pad_code`` to the
    16-aligned ``dpad``, zero-pad to ``lane``, and compute the per-vector
    correction term over the dpad width as the reference does."""
    return _encode(x, alpha, offset, distance_type, invert, dpad, lane, True)


def encode_query_batch(
    q: torch.Tensor,
    *,
    alpha: float,
    offset: float,
    distance_type: DistanceType,
    invert: bool,
    dpad: int,
    lane: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize queries exactly like data (encoded_vectors_u8.rs:290-329).
    The query offset is Sum(Q)*alpha*offset for DOT and Sum(Q^2)*alpha^2 for
    L2 (zero for L1), negated under invert."""
    return _encode(q, alpha, offset, distance_type, invert, dpad, lane, False)


# ---------------------------------------------------------------------------
# Integer kernels (plain). The hand-written CUDA kernels live in ops/kernels/.
# ---------------------------------------------------------------------------


def int_dot(qcodes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[Q, N] exact int32 dot between int8 code matrices.

    On the CPU the product runs in int32. PyTorch has no int32 matrix product
    on CUDA, so there it runs in float64, which is exact for any realistic D
    (every partial sum is an integer far below 2^53)."""
    if qcodes.is_cuda:
        return (qcodes.to(torch.float64) @ codes.to(torch.float64).T).to(torch.int32)
    return qcodes.to(torch.int32) @ codes.to(torch.int32).T


def int_l1(qcodes: torch.Tensor, codes: torch.Tensor, tile: int = 2048) -> torch.Tensor:
    """[Q, N] exact int32 sum-of-absolute-differences, tiled over N so peak
    memory is Q * tile * D."""
    q32 = qcodes.to(torch.int32)
    parts = [
        torch.sum(
            torch.abs(q32[:, None, :] - codes[n0 : n0 + tile].to(torch.int32)[None]),
            dim=-1,
            dtype=torch.int32,
        )
        for n0 in range(0, codes.shape[0], tile)
    ]
    if not parts:
        return q32.new_zeros((qcodes.shape[0], 0))
    return torch.cat(parts, dim=1)


def _mult_col(multiplier, q: int, device) -> torch.Tensor:
    """A scalar or per-query [Q] / [Q, 1] multiplier as an f32 column [q, 1]."""
    m = torch.as_tensor(multiplier, dtype=torch.float32, device=device)
    return m.reshape(-1, 1).expand(q, 1)


def affine_once(mult, acc: torch.Tensor, qoff: torch.Tensor) -> torch.Tensor:
    """f32 ``mult * acc + qoff`` [Q, N] computed in f64 and rounded once: the
    value of the JAX package's compiled code, which fuses that multiply-add
    (ROADMAP F24). ``mult`` a scalar or per query, ``qoff`` [Q] or [Q, 1],
    ``acc`` integer [Q, N]."""
    m = torch.as_tensor(mult, dtype=torch.float32, device=acc.device).reshape(-1, 1)
    return (m.double() * acc.double() + qoff.reshape(-1, 1).double()).float()


def score_batch(
    qcodes: torch.Tensor,
    qoff: torch.Tensor,
    codes: torch.Tensor,
    voff: torch.Tensor,
    multiplier,
    *,
    distance_type: DistanceType,
) -> torch.Tensor:
    """[Q, N] scores: (multiplier * kernel + qoff) + voff
    (encoded_vectors_u8.rs:145-158). DOT and L2 share the dot kernel; L1
    rounds ``multiplier * kernel + qoff`` once (``affine_once``), as the JAX
    package's compiled L1 and the K12 kernel do. ``multiplier`` is a scalar
    or per-query [Q] / [Q, 1]."""
    if distance_type == DistanceType.L1:
        return affine_once(multiplier, int_l1(qcodes, codes), qoff) + voff[None, :]
    raw = int_dot(qcodes, codes)
    m = _mult_col(multiplier, qcodes.shape[0], qcodes.device)
    return m * raw.to(torch.float32) + qoff[:, None] + voff[None, :]


def _score_gathered(
    qcodes, qoff, g, goff, multiplier, *, distance_type: DistanceType
) -> torch.Tensor:
    """[Q, R] scores of qcodes[Q, D] against gathered rows g[Q, R, D]."""
    q32 = qcodes.to(torch.int32)[:, None, :]
    g32 = g.to(torch.int32)
    if distance_type == DistanceType.L1:
        raw = torch.sum(torch.abs(q32 - g32), dim=-1, dtype=torch.int32)
    else:
        raw = torch.sum(q32 * g32, dim=-1, dtype=torch.int32)
    m = _mult_col(multiplier, qcodes.shape[0], qcodes.device)
    return m * raw.to(torch.float32) + qoff[:, None] + goff


def score_candidates(
    qcodes: torch.Tensor,  # int8 [Q, D]
    qoff: torch.Tensor,  # f32 [Q]
    codes: torch.Tensor,  # int8 [N, D]
    voff: torch.Tensor,  # f32 [N]
    cand: torch.Tensor,  # int [Q, R] per-query candidate ids
    multiplier,
    *,
    distance_type: DistanceType,
    n_valid: int,
) -> torch.Tensor:
    """[Q, R] scores against per-query candidate lists (two-stage rescore);
    the plain version of the K4 kernel (``ops/kernels/gather.py``).

    An id outside [0, n_valid) — the padding (-1) of a coarse stage, a
    padding row, a row past the matrix — scores -inf, so it can never
    outrank a real candidate. The JAX package's gather reads some row for
    -1 instead (``jnp.take`` wraps it to the last row; its DMA gather starts
    at row -8: ROADMAP F4/F5)."""
    cand = cand.to(torch.int64)
    live = (cand >= 0) & (cand < n_valid)
    safe = torch.where(live, cand, 0)
    s = _score_gathered(
        qcodes,
        qoff,
        codes[safe],  # [Q, R, D]
        voff[safe],  # [Q, R]
        multiplier,
        distance_type=distance_type,
    )
    return torch.where(live, s, s.new_full((), float("-inf")))


def score_internal_batch(
    codes_a: torch.Tensor,
    voff_a: torch.Tensor,
    codes_b: torch.Tensor,
    voff_b: torch.Tensor,
    multiplier: float,
    diff: float,
    *,
    distance_type: DistanceType,
) -> torch.Tensor:
    """[P] stored-vs-stored scores (encoded_vectors_u8.rs:386-453):
    multiplier * kernel + off_a + off_b - diff, where
    diff = actual_dim * offset^2 (sign-flipped under invert)."""
    a32 = codes_a.to(torch.int32)
    b32 = codes_b.to(torch.int32)
    if distance_type == DistanceType.L1:
        raw = torch.sum(torch.abs(a32 - b32), dim=-1, dtype=torch.int32)
    else:
        raw = torch.sum(a32 * b32, dim=-1, dtype=torch.int32)
    m = torch.as_tensor(multiplier, dtype=torch.float32, device=codes_a.device)
    return m.reshape(-1) * raw.to(torch.float32) + voff_a + voff_b - diff
