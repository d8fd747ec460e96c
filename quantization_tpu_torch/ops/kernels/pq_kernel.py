"""PQ scoring and fused search: wrappers of the hand-written CUDA kernels,
each beside its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/pq_kernel.py``. The kernels live in
``quantization_tpu_torch/csrc/pq_kernels.cu``:

  * K8  ``pq_scores``          — the [Q, n_valid] f32 score matrix (the JAX
    package's int8-LUT and bf16-LUT ``pq_scores_pallas`` kernels; one
    kernel here, templated on the LUT word);
  * K7b ``pq_search`` exact    — scores fused with an exact per-split top-k;
  * K7a ``pq_search`` approx   — scores fused with the stride-class maxima of
    the JAX approx kernel over spans of ``SPAN * TILE_N`` rows.

Operands, in the JAX layouts: a LUT f32 [Q, m, kc] (kc = 256 for 8-bit
codes, 16 for 4-bit) and the transposed codes u8 [Mpad, Npad], Mpad a
multiple of ``M_BLK`` and Npad of ``TILE_N``, with zero codes in the padding.
The LUT is put in its working type here, outside the kernel, as the JAX
package does before its ``pallas_call``:

  * ``int8``: per-(query, chunk) mid-range centering, a per-query scale and a
    bias, the sum of the mids (``quantize_lut``); the score is
    ``scale * sum + bias``, computed in f64 and rounded once, which is what
    the JAX package's compiled epilogue does (ROADMAP Queue 3, F14);
  * ``bf16``: the entries rounded to bf16, summed in f32 in chunk order (for
    4-bit codes, each group of ``GRP4`` chunks summed first, in pairs, then
    added);
  * ``bf16x2``: two bf16 words, ``hi + lo / LO_SCALE`` (``split_lut_bf16x2``),
    two f32 sums with the lo sum folded in every ``M_BLK`` chunks. Only the
    searches take it: ``pq_scores`` rounds the LUT to bf16 for every
    precision but int8, as ``pq_scores_pallas`` does (Queue 3, F15).

The plain versions sum in the kernels' order, so on the card each kernel
equals its plain version to the bit; exact top-k values are equal and ids
differ only among tied scores.

Each wrapper takes the plain version for a CPU tensor. For a CUDA tensor it
checks device, dtype, shape and contiguity, allocates its outputs, launches
on the current stream without synchronising, counts the launch in
``LAUNCHES``, and raises on any error — it never falls back.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ...core.types import ArgumentsError
from ...utils.padding import pad_dim_to
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

# Corpus rows are padded to a multiple of this, chunks to a multiple of
# M_BLK (the JAX package's code padding, pq_kernel.py:71-73).
TILE_N = 1024
M_BLK = 16
K = 256  # centroids per chunk, 8-bit codes
K4 = 16  # centroids per chunk, 4-bit codes
GRP4 = 8  # 4-bit chunks the JAX kernel sums in one matmul (pq_kernel.py:87)
# lo-word prescale of the bf16x2 split (a power of two: exact in bf16).
LO_SCALE = 256.0
# Queries per kernel block (one per lane) and corpus rows per K7b split.
TQ = 32
EXACT_SPLIT = 512

PRECISIONS = ("int8", "bf16", "bf16x2")
_KIND = {"int8": 0, "bf16": 1, "bf16x2": 2}
# Chunks per block of the int8 bias sum (the JAX package's compiled
# reduction order for m a multiple of 32 or at most 32).
_BIAS_BLOCK = 32

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"pq_scores": 0, "pq_search_exact": 0, "pq_search_approx": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def lut_precision(residual: bool = False) -> str:
    """The LUT word of the fused PQ kernels, as the JAX package chooses it
    (``_lut_precision``, pq_kernel.py:90-113): ``QTPU_PQ_LUT`` when set,
    else ``bf16x2`` for residual LUTs and ``int8`` otherwise. Read at the
    model layer on every call."""
    env = os.environ.get("QTPU_PQ_LUT")
    if env is not None:
        return env
    return "bf16x2" if residual else "int8"


def _sum_mids(mid: torch.Tensor) -> torch.Tensor:
    """[Q, m] -> [Q]: an f32 sum, in order within blocks of 32 chunks, then
    in order over the blocks."""
    q, m = mid.shape
    nb = -(-m // _BIAS_BLOCK)
    x = pad_dim_to(mid, 1, nb * _BIAS_BLOCK).reshape(q, nb, _BIAS_BLOCK)
    part = x[:, :, 0].clone()
    for i in range(1, _BIAS_BLOCK):
        part += x[:, :, i]
    out = part[:, 0].clone()
    for b in range(1, nb):
        out += part[:, b]
    return out


def quantize_lut(lut: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 [Q, m, kc] -> (int8 [Q, m, kc], scale f32 [Q], bias f32 [Q]) with
    score = scale * sum_c lutq[c, code] + bias (``_quantize_lut``,
    pq_kernel.py:116-133): entries centred on their (query, chunk) mid-range,
    one scale per query (max |centred| / 127, at least 1e-30), rounded half
    to even."""
    mid = 0.5 * (lut.amax(dim=2, keepdim=True) + lut.amin(dim=2, keepdim=True))
    centered = lut - mid
    # max / 127 correctly rounded on every device: PyTorch's CUDA division
    # by a Python number multiplies by its reciprocal, which can miss by an
    # ulp; the f64 quotient rounded to f32 cannot.
    scale = torch.clamp((centered.abs().amax(dim=(1, 2), keepdim=True).double() / 127.0)
                        .float(), min=1e-30)
    lutq = torch.round(centered / scale).to(torch.int8)
    return lutq, scale.reshape(-1), _sum_mids(mid[:, :, 0])


def split_lut_bf16x2(lut: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi bf16, lo bf16) with hi + lo / LO_SCALE ~= entry to ~2^-17
    (``_split_lut_bf16x2``, pq_kernel.py:289-306). An eager cast rounds, so
    ``lo`` keeps the residual the JAX package needs ``reduce_precision``
    for."""
    hi = lut.to(torch.bfloat16)
    lo = ((lut - hi.to(torch.float32)) * LO_SCALE).to(torch.bfloat16)
    return hi, lo


def _operands(lut: torch.Tensor, precision: str):
    """(LUT words [Q, m, kc] — one tensor, or hi and lo — scale, bias)."""
    if precision not in PRECISIONS:
        raise ArgumentsError(f"LUT precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "int8":
        lutq, scale, bias = quantize_lut(lut)
        return (lutq,), scale, bias
    if precision == "bf16":
        return (lut.to(torch.bfloat16),), None, None
    return split_lut_bf16x2(lut), None, None


def _plain_scores(words, scale, bias, codes_t: torch.Tensor, n: int) -> torch.Tensor:
    """[Q, n] f32: the LUT sum of rows [0, n) in the kernels' order and
    rounding. Chunks past m have zero LUT rows, so they are skipped. 4-bit
    float sums go by groups of GRP4 chunks, each group summed on its own and
    then added, as the JAX kernel adds one block-diagonal matmul per group."""
    q, m, kc = words[0].shape
    dev = codes_t.device

    def entries(w, c):
        return w[:, c, codes_t[c, :n].long() & (kc - 1)]

    if words[0].dtype == torch.int8:
        acc = torch.zeros((q, n), dtype=torch.int32, device=dev)
        for c in range(m):
            acc += entries(words[0], c)
        return (scale.double()[:, None] * acc.double() + bias.double()[:, None]).float()
    grp = GRP4 if kc == K4 else 1

    def group_sum(w, g0):
        """A 4-bit group: chunks summed in pairs, then the pairs in order
        (the order of the JAX package's CPU dot, ROADMAP Queue 3, F19)."""
        if grp == 1:
            return entries(w, g0).float()
        s = None
        for c in range(g0, min(g0 + grp, m), 2):
            p = entries(w, c).float()
            if c + 1 < m:
                p += entries(w, c + 1).float()
            s = p if s is None else s + p
        return s

    acc = torch.zeros((q, n), dtype=torch.float32, device=dev)
    lo_acc = torch.zeros_like(acc) if len(words) == 2 else None
    for g0 in range(0, m, grp):
        acc += group_sum(words[0], g0)
        if lo_acc is not None:
            lo_acc += group_sum(words[1], g0)
            if (g0 + grp) % M_BLK == 0 or g0 + grp >= m:
                acc = acc + (1.0 / LO_SCALE) * lo_acc
                lo_acc.zero_()
    return acc


def _check_operands(lut, codes_t, n_valid):
    q, m, kc = lut.shape
    mpad, npad = codes_t.shape
    if kc not in (K, K4):
        raise ArgumentsError(f"LUT has {kc} centroids per chunk, expected {K} or {K4}")
    if mpad % M_BLK or npad % TILE_N or mpad < m:
        raise ArgumentsError(
            f"codes_t [{mpad}, {npad}] must be padded to [{M_BLK}k >= {m}, {TILE_N}k]"
        )
    check_tensors(codes_t.device, (
        ("lut", lut, torch.float32, (q, m, kc)),
        ("codes_t", codes_t, torch.uint8, (mpad, npad)),
    ), align=16)
    if not 0 <= n_valid <= npad:
        raise ArgumentsError(f"n_valid={n_valid} outside [0, {npad}]")


def _kernel_lut(words, mpad: int) -> torch.Tensor:
    """The kernels' LUT layout, [ceil(Q/32), mpad, kc, 32] words: each block's
    32 queries side by side for every (chunk, code), zero past m and Q. The
    bf16x2 word holds lo in its low and hi in its high 16 bits."""
    q, _, kc = words[0].shape
    qt = -(-q // TQ)

    def tiled(w):
        w = pad_dim_to(pad_dim_to(w, 1, mpad), 0, qt * TQ)
        return w.reshape(qt, TQ, mpad, kc).permute(0, 2, 3, 1)

    if len(words) == 1:
        return tiled(words[0]).contiguous()
    hi, lo = (tiled(w.view(torch.int16)) for w in words)
    return torch.stack([lo, hi], dim=-1).contiguous().view(torch.int32)


def _launch(name, lut, codes_t, precision, n_valid, outs, *extra):
    """Put the LUT in the kernels' layout and launch ``qtt_<name>`` on the
    current stream: (lut, scale, bias, codes_t, *outs, Q, mpad, npad,
    n_valid, kc, kind, *extra, stream). Counts the launch; raises on any
    error."""
    _check_operands(lut, codes_t, n_valid)
    words, scale, bias = _operands(lut, precision)
    if scale is None:  # read only by the int8 kernels
        scale = bias = torch.zeros(1, dtype=torch.float32, device=codes_t.device)
    klut = _kernel_lut(words, codes_t.shape[0])
    lib = load_library()
    mpad, npad = codes_t.shape
    q, _, kc = lut.shape
    err = getattr(lib, f"qtt_{name}")(
        klut.data_ptr(), scale.data_ptr(), bias.data_ptr(), codes_t.data_ptr(),
        *(o.data_ptr() for o in outs), q, mpad, npad, n_valid, kc, _KIND[precision],
        *extra, torch.cuda.current_stream(codes_t.device).cuda_stream,
    )
    check(lib, err, name)
    LAUNCHES[name] += 1


# ------------------------------------------------------------------ K8


def scores_precision(precision: str) -> str:
    """K8 has no bf16x2 variant: ``pq_scores_pallas`` rounds the LUT to bf16
    for every precision but int8 (pq_kernel.py:956-961)."""
    if precision not in PRECISIONS:
        raise ArgumentsError(f"LUT precision must be one of {PRECISIONS}, got {precision!r}")
    return "int8" if precision == "int8" else "bf16"


def lut_scores_plain(lut, codes_t, *, n_valid, precision=None):
    """[Q, n_valid] f32: the scores the fused searches select over, with the
    LUT in ``precision`` (bf16x2 included)."""
    words, scale, bias = _operands(lut, precision or lut_precision())
    return _plain_scores(words, scale, bias, codes_t, n_valid)


def pq_scores_plain(lut, codes_t, *, n_valid, precision=None):
    """Plain version of K8: [Q, n_valid] f32 scores."""
    return lut_scores_plain(lut, codes_t, n_valid=n_valid,
                            precision=scores_precision(precision or lut_precision()))


def pq_scores(lut, codes_t, *, n_valid, precision=None):
    """[Q, n_valid] f32 PQ scores: the LUT sum of every row's codes."""
    if not use_kernels(codes_t):
        return pq_scores_plain(lut, codes_t, n_valid=n_valid, precision=precision)
    precision = scores_precision(precision or lut_precision())
    out = torch.empty((lut.shape[0], n_valid), dtype=torch.float32, device=codes_t.device)
    if lut.shape[0] and n_valid:
        _launch("pq_scores", lut, codes_t, precision, n_valid, (out,))
    return out


# ------------------------------------------------------------ K7b / K7a


def pq_search_plain(lut, codes_t, *, n_valid, k, mode="exact", precision=None):
    """Plain version of K7b (exact) and K7a (approx): (f32 [Q, k],
    i32 [Q, k]).

    Exact: top-k of the valid scores, -inf / -1 past n_valid. Approx: the
    stride-class candidates of the JAX approx kernel over SPAN tiles of
    TILE_N rows (rows >= n_valid score NEG), then an exact merge."""
    words, scale, bias = _operands(lut, precision or lut_precision())
    q = lut.shape[0]
    if mode == "exact":
        scores = _plain_scores(words, scale, bias, codes_t, n_valid)
        ids = torch.arange(n_valid, dtype=torch.int32, device=codes_t.device)
        return merge_exact(scores, ids.expand(q, n_valid), k)
    scores = _plain_scores(words, scale, bias, codes_t, codes_t.shape[1])
    scores[:, n_valid:] = NEG
    vals, ids = approx_candidates(scores, TILE_N)
    return merge_candidates(vals, ids, k)


def pq_search(lut, codes_t, *, n_valid, k, mode="exact", precision=None):
    """Fused PQ search, never materializing the [Q, N] score matrix.
    Returns (scores f32[Q, k], indices i32[Q, k]).

    ``mode="exact"`` (K7b): value-exact over the LUT scores of ``precision``
    for any k <= FUSED_K_MAX — each 512-row split returns its exact
    top-min(k, 512), so no spill bound and no fallback are needed; ids may
    differ from torch.topk's only among tied scores; slots beyond n_valid
    hold -inf / -1. ``mode="approx"`` (K7a): one max per stride class of
    SPAN tiles, exact merge, k <= APPROX_K_MAX."""
    check_search(mode, k)
    if not use_kernels(codes_t):
        return pq_search_plain(lut, codes_t, n_valid=n_valid, k=k, mode=mode,
                               precision=precision)
    precision = precision or lut_precision()
    q, npad, dev = lut.shape[0], codes_t.shape[1], codes_t.device
    if mode == "exact":
        kk = min(k, EXACT_SPLIT)
        width = (npad // EXACT_SPLIT) * kk
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q and npad:
            _launch("pq_search_exact", lut, codes_t, precision, n_valid, (vals, ids), kk)
        return merge_exact(vals, ids, k)
    nblocks = -(-npad // (SPAN * TILE_N))
    vals = torch.empty((q, nblocks * 128), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nblocks * 128), dtype=torch.int32, device=dev)
    if q and npad:
        _launch("pq_search_approx", lut, codes_t, precision, n_valid, (vals, ids))
    return merge_candidates(vals, ids, k)
