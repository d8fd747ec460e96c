"""PQ scoring and fused search: wrappers of the hand-written CUDA kernels,
each beside its plain PyTorch version.

Twin of ``quantization_tpu/ops/pallas/pq_kernel.py``. The kernels live in
``quantization_tpu_torch/csrc/pq_kernels.cu`` (the LUT-gather body) and
``pq4_mma_kernels.cu`` (4-bit codes on the tensor cores, see
``onehot_route`` and ``bf16_onehot_route``):

  * K8  ``pq_scores``          — the [Q, n_valid] f32 score matrix (the JAX
    package's int8-LUT and bf16-LUT ``pq_scores_pallas`` kernels; one
    kernel here, templated on the LUT word);
  * K7b ``pq_search`` exact    — scores fused with an exact per-split top-k;
  * K7a ``pq_search`` approx   — scores fused with the stride-class maxima of
    the JAX approx kernel over spans of ``SPAN * TILE_N`` rows;
  * K11 ``pq_search_indexed``  — the K7a body walking a selected list of
    corpus tiles in place (the IVF probe scan), over spans of SPAN tiles.

The searches take the residual-IVF additives as a pair, ``rowadd`` f32
[Npad] (one per corpus row: the decoded-norm term and the pad mask) and
``corr`` (one per query and 512-row block: the bucket term, [Q, Npad/512]
dense or [T*tile_n/512, Q] in selection order), added in the JAX order
``(score + rowadd) + corr`` after the LUT score and before selection.

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

4-bit codes with the int8 LUT take another route for every kernel
(``onehot_route``): ``wgmma`` products of the LUT flattened to [Q, Mpad *
16] (``onehot_operands``) and the codes' one-hot bytes: K8, K7a / K11 and
K7b up to ``ktile.QUEUE_K_MAX`` on kernels of their own in
``csrc/pq4_mma_kernels.cu`` that build the one-hot A operand in registers
(K8's ``pq4_scores_ws_kernel`` drains its score rows by bulk stores under
the next products), K7b past it on the int8 scan body of
``csrc/dot_scan.cuh`` (the bytes expanded in shared memory).
Their int32 sum and f64 epilogue are the gather body's, so both routes
equal the same plain version to the bit. K8 with 4-bit codes and the bf16 LUT (``pq_scores``
rounds bf16x2 to bf16) takes a route of its own (``bf16_onehot_route``):
one-hot bf16 products on ``wgmma``, one chunk each from a zero accumulator,
so each lands a LUT entry exactly, summed on the CUDA cores in the plain
version's order (``bf16_onehot_operand``). Every other launch runs the
LUT-gather body, which streams the LUT through a ring fed by bulk copies
(``csrc/pq_kernels.cuh``).

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
    CORR_BLK,
    EXACT_SPLIT,
    NEG,
    SELECT_LAUNCHES,
    SPAN,
    approx_candidates,
    check_search,
    check_tensors,
    corr_strides,
    exact_geometry,
    expand_corr,
    merge_candidates,
    merge_exact,
    tile_rows,
)
from .sq_kernel import EXACT_TQ

# Corpus rows are padded to a multiple of this, chunks to a multiple of
# M_BLK (the JAX package's code padding, pq_kernel.py:71-73).
TILE_N = 1024
M_BLK = 16
K = 256  # centroids per chunk, 8-bit codes
K4 = 16  # centroids per chunk, 4-bit codes
GRP4 = 8  # 4-bit chunks the JAX kernel sums in one matmul (pq_kernel.py:87)
# lo-word prescale of the bf16x2 split (a power of two: exact in bf16).
LO_SCALE = 256.0
# Queries per kernel block (one per lane); the LUT-gather K7b's splits of
# EXACT_SPLIT rows are the rows of one kernel tile (csrc kPTR).
TQ = 32

PRECISIONS = ("int8", "bf16", "bf16x2")
_KIND = {"int8": 0, "bf16": 1, "bf16x2": 2}
# Chunks per block of the int8 bias sum (the JAX package's compiled
# reduction order for m a multiple of 32 or at most 32).
_BIAS_BLOCK = 32

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"pq_scores": 0, "pq_search_exact": 0, "pq_search_approx": 0,
            "pq_search_indexed": 0}
#: Of those, the launches that took the one-hot route (``onehot_route``).
ONEHOT_LAUNCHES = dict(LAUNCHES)
#: And those that took the bf16 one-hot route (``bf16_onehot_route``: K8).
BF16_ONEHOT_LAUNCHES = {"pq_scores": 0}
# The one-hot approx kernel's largest part: a part's 128-row segment number
# must fit a byte (csrc/pq4_mma_kernels.cu pq4_approx_ws_kernel).
ONEHOT_PART_MAX = 255 * 128


def reset_launches() -> None:
    for counts in (LAUNCHES, ONEHOT_LAUNCHES, BF16_ONEHOT_LAUNCHES):
        for name in counts:
            counts[name] = 0


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


def onehot_route(kc: int, precision: str, mode: str = "scores", tile_n: int = TILE_N) -> bool:
    """Whether a launch runs on the one-hot route
    (``csrc/pq4_mma_kernels.cu``): K8 (``mode="scores"``), K7b
    (``"exact"``), K7a (``"approx"``) and K11 (``"indexed"``, whose span
    of SPAN tiles must fit one part, at most ONEHOT_PART_MAX rows) with 4-bit
    codes and the int8 LUT. The bf16 and bf16x2 LUTs and 8-bit codes run
    the LUT-gather body."""
    if mode == "indexed" and SPAN * tile_n > ONEHOT_PART_MAX:
        return False
    return kc == K4 and precision == "int8" and mode in ("scores", "exact", "approx",
                                                         "indexed")


def bf16_onehot_route(kc: int, precision: str) -> bool:
    """Whether K8 runs on the bf16 one-hot route (``csrc/pq4_mma_kernels.cu``
    ``qtt_pq4_mma_scores_bf16``): with 4-bit codes and the bf16 LUT, which
    ``pq_scores`` also uses for bf16x2 (``scores_precision``). The 4-bit
    bf16 / bf16x2 searches and 8-bit codes run the LUT-gather body."""
    return kc == K4 and precision in ("bf16", "bf16x2")


def bf16_onehot_operand(lut: torch.Tensor, mpad: int) -> torch.Tensor:
    """The bf16 one-hot route's B operand: the LUT rounded to bf16 [Q, mpad
    * kc], zero past m, flattened with no transposition (the JAX package's
    bf16 ``lut_flat``, pq_kernel.py:956-961). Element 16c + i of a query's
    row meets the one-hot 1.0 of code i of chunk c."""
    q, _, kc = lut.shape
    return pad_dim_to(lut.to(torch.bfloat16), 1, mpad).reshape(q, mpad * kc).contiguous()


def onehot_operands(lut: torch.Tensor, mpad: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The one-hot route's operands: (int8 LUT [Q, mpad * kc], scale f32
    [Q], bias f32 [Q]), ``quantize_lut``'s entries zero past m, flattened
    with no transposition (the JAX package's ``lut_flat``). Byte 16c + i of
    a query's row meets the one-hot byte of code i of chunk c."""
    lutq, scale, bias = quantize_lut(lut)
    q, _, kc = lut.shape
    return pad_dim_to(lutq, 1, mpad).reshape(q, mpad * kc), scale, bias


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
    """The kernels' LUT layout, [ceil(Q/32), mpad, kc, 32 queries' entries],
    zero past m and Q, packed so that one 32-bit word holds one (chunk,
    code)'s entries of neighbouring queries (``csrc/pq_kernels.cuh``
    ``Lanes``): int8 4 queries, each entry biased by 128 (``x ^ 0x80``, so
    a word's bytes split into 16-bit sums), returned as uint8; bf16 2
    queries; bf16x2 a query pair's hi halves in one int32 word and its lo
    halves in the next."""
    q, _, kc = words[0].shape
    qt = -(-q // TQ)

    def tiled(w):
        w = pad_dim_to(pad_dim_to(w, 1, mpad), 0, qt * TQ)
        return w.reshape(qt, TQ, mpad, kc).permute(0, 2, 3, 1).contiguous()

    if len(words) == 2:
        hi, lo = (tiled(w.view(torch.int16)).view(torch.int32) for w in words)
        return torch.stack([hi, lo], dim=-1).contiguous()
    w = tiled(words[0])
    return w.view(torch.uint8) ^ 0x80 if w.dtype == torch.int8 else w


def onehot_voff(rowadd, npad: int, dev) -> torch.Tensor:
    """The one-hot searches' row additive, never null in the scan body:
    rowadd, or a row of -0.0, which adds nothing to any score, where +0.0
    would turn a -0.0 score into +0.0 (a different key of the exact
    select)."""
    return rowadd if rowadd is not None else torch.full((npad,), -0.0, device=dev)


def _launch_onehot(name, lut, codes_t, n_valid, outs, voff=None, res=(0, 0, 0), *, kk=0,
                   split=0, sel=None, tile_n=0, ncomp=0, part=0):
    """The one-hot route of ``name``: ``qtt_pq4_mma_scores`` (K8), ``_search_exact``
    (K7b: voff, the block rows ``split``, kk and the corr triple ``res``) or
    ``_search_approx`` (K7a,
    and K11 with ``sel`` / ``tile_n``: voff, part, the selection and
    ``res``) on the current stream. Counts the launch in LAUNCHES and
    ONEHOT_LAUNCHES; raises on any error."""
    mpad, npad = codes_t.shape
    lutq, scale, bias = onehot_operands(lut, mpad)
    lib = load_library()
    stream = torch.cuda.current_stream(codes_t.device).cuda_stream
    head = [lutq.data_ptr(), scale.data_ptr(), bias.data_ptr(), codes_t.data_ptr()]
    dims = [lut.shape[0], mpad, npad, n_valid]
    if name == "pq_scores":
        fn, args = "qtt_pq4_mma_scores", [*head, outs[0].data_ptr(), *dims]
    elif name == "pq_search_exact":
        fn = "qtt_pq4_mma_search_exact"
        args = [*head, voff.data_ptr(), *(o.data_ptr() for o in outs), *dims, split, kk,
                *res]
    else:
        fn = "qtt_pq4_mma_search_approx"
        args = [*head, voff.data_ptr(), *(o.data_ptr() for o in outs), *dims, part,
                0 if sel is None else sel.data_ptr(), tile_n, ncomp or npad, *res]
    check(lib, getattr(lib, fn)(*args, stream), name)
    LAUNCHES[name] += 1
    ONEHOT_LAUNCHES[name] += 1


def _launch_bf16_onehot(lut, codes_t, n_valid, out):
    """K8 on the bf16 one-hot route (``qtt_pq4_mma_scores_bf16``) on the
    current stream. Counts the launch in LAUNCHES and BF16_ONEHOT_LAUNCHES;
    raises on any error."""
    mpad, npad = codes_t.shape
    lutb = bf16_onehot_operand(lut, mpad)
    lib = load_library()
    err = lib.qtt_pq4_mma_scores_bf16(
        lutb.data_ptr(), codes_t.data_ptr(), out.data_ptr(), lut.shape[0], mpad, npad, n_valid,
        torch.cuda.current_stream(codes_t.device).cuda_stream)
    check(lib, err, "pq_scores")
    LAUNCHES["pq_scores"] += 1
    BF16_ONEHOT_LAUNCHES["pq_scores"] += 1


def _launch(name, lut, codes_t, precision, n_valid, outs, *extra, fn=None):
    """Put the LUT in the kernels' layout and launch ``qtt_<fn or name>`` on
    the current stream: (lut, scale, bias, codes_t, *outs, Q, mpad, npad,
    n_valid, kc, kind, *extra, stream). Counts the launch as ``name``;
    raises on any error."""
    words, scale, bias = _operands(lut, precision)
    if scale is None:  # read only by the int8 kernels
        scale = bias = torch.zeros(1, dtype=torch.float32, device=codes_t.device)
    klut = _kernel_lut(words, codes_t.shape[0])
    lib = load_library()
    mpad, npad = codes_t.shape
    q, _, kc = lut.shape
    err = getattr(lib, f"qtt_{fn or name}")(
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
        _check_operands(lut, codes_t, n_valid)
        if onehot_route(lut.shape[2], precision):
            _launch_onehot("pq_scores", lut, codes_t, n_valid, (out,))
        elif bf16_onehot_route(lut.shape[2], precision):
            _launch_bf16_onehot(lut, codes_t, n_valid, out)
        else:
            _launch("pq_scores", lut, codes_t, precision, n_valid, (out,))
    return out


# ------------------------------------------------------------ K7b / K7a


def _residual_pair(rowadd, corr):
    if (rowadd is None) != (corr is None):
        raise ArgumentsError("the residual additives come as a pair: rowadd and corr")


def _add_residual(scores, rowadd, corr, selection=False):
    """(scores + rowadd) + corr, each add rounded once, as the kernels add
    them; ``rowadd`` already indexed by the scores' columns."""
    if rowadd is None:
        return scores
    return (scores + rowadd[None, :]) + expand_corr(corr, selection)[:, : scores.shape[1]]


def pq_search_plain(lut, codes_t, rowadd=None, corr=None, *, n_valid, k, mode="exact",
                    precision=None):
    """Plain version of K7b (exact) and K7a (approx): (f32 [Q, k],
    i32 [Q, k]).

    Exact: top-k of the valid scores, -inf / -1 past n_valid. Approx: the
    stride-class candidates of the JAX approx kernel over SPAN tiles of
    TILE_N rows (rows >= n_valid score NEG), then an exact merge. Both with
    the residual additives when given."""
    _residual_pair(rowadd, corr)
    words, scale, bias = _operands(lut, precision or lut_precision())
    q = lut.shape[0]
    if mode == "exact":
        scores = _add_residual(_plain_scores(words, scale, bias, codes_t, n_valid),
                               None if rowadd is None else rowadd[:n_valid], corr)
        ids = torch.arange(n_valid, dtype=torch.int32, device=codes_t.device)
        return merge_exact(scores, ids.expand(q, n_valid), k)
    scores = _add_residual(_plain_scores(words, scale, bias, codes_t, codes_t.shape[1]),
                           rowadd, corr)
    scores[:, n_valid:] = NEG
    vals, ids = approx_candidates(scores, TILE_N)
    return merge_candidates(vals, ids, k)


def _residual_args(rowadd, corr, q, npad, ncorr, selection, dev):
    """(rowadd, corr, corr_qs, corr_bs) for the C interface, checked."""
    if rowadd is None:
        return 0, 0, 0, 0
    check_tensors(dev, (
        ("rowadd", rowadd, torch.float32, (npad,)),
        ("corr", corr, torch.float32, (ncorr, q) if selection else (q, ncorr)),
    ))
    return (rowadd.data_ptr(), corr.data_ptr(), *corr_strides(corr, q, selection))


def pq_search(lut, codes_t, rowadd=None, corr=None, *, n_valid, k, mode="exact",
              precision=None):
    """Fused PQ search, never materializing the [Q, N] score matrix.
    Returns (scores f32[Q, k], indices i32[Q, k]).

    ``mode="exact"`` (K7b): value-exact over the LUT scores of ``precision``
    for any k <= FUSED_K_MAX — each 512-row split returns its exact
    top-min(k, 512), so no spill bound and no fallback are needed; ids may
    differ from torch.topk's only among tied scores; slots beyond n_valid
    hold -inf / -1. ``mode="approx"`` (K7a): one max per stride class of
    SPAN tiles, exact merge, k <= APPROX_K_MAX. ``rowadd`` [Npad] and
    ``corr`` [Q, Npad/512]: the residual additives (see above)."""
    check_search(mode, k)
    _residual_pair(rowadd, corr)
    if not use_kernels(codes_t):
        return pq_search_plain(lut, codes_t, rowadd, corr, n_valid=n_valid, k=k, mode=mode,
                               precision=precision)
    precision = precision or lut_precision()
    q, npad, dev = lut.shape[0], codes_t.shape[1], codes_t.device
    _check_operands(lut, codes_t, n_valid)
    res = _residual_args(rowadd, corr, q, npad, npad // CORR_BLK, False, dev)
    onehot = onehot_route(lut.shape[2], precision, mode)
    if mode == "exact":
        # The one-hot route runs the int8 body's exact select (the queue up
        # to ktile.QUEUE_K_MAX); the LUT-gather body keeps the radix select
        # of EXACT_SPLIT-row splits at every kk.
        kk, split, width, route = (exact_geometry(k, npad, q, EXACT_TQ) if onehot else
                                   (min(k, EXACT_SPLIT), EXACT_SPLIT,
                                    npad // EXACT_SPLIT * min(k, EXACT_SPLIT), "radix"))
        vals = torch.empty((q, width), dtype=torch.float32, device=dev)
        ids = torch.empty((q, width), dtype=torch.int32, device=dev)
        if q and npad:
            if onehot:
                _launch_onehot("pq_search_exact", lut, codes_t, n_valid, (vals, ids),
                               onehot_voff(rowadd, npad, dev), res[1:], kk=kk, split=split)
            else:
                _launch("pq_search_exact", lut, codes_t, precision, n_valid, (vals, ids), kk,
                        *res)
            SELECT_LAUNCHES[route] += 1
        return merge_exact(vals, ids, k)
    nblocks = -(-npad // (SPAN * TILE_N))
    vals = torch.empty((q, nblocks * 128), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nblocks * 128), dtype=torch.int32, device=dev)
    if q and npad:
        if onehot:
            _launch_onehot("pq_search_approx", lut, codes_t, n_valid, (vals, ids),
                           onehot_voff(rowadd, npad, dev), res[1:], part=SPAN * TILE_N)
        else:
            _launch("pq_search_approx", lut, codes_t, precision, n_valid, (vals, ids),
                    *res, 0, 0, npad, SPAN * TILE_N)
    return merge_candidates(vals, ids, k)


# ------------------------------------------------------------------ K11


def pq_search_indexed_plain(lut, codes_t, tile_sel, rowadd=None, corr=None, *, k,
                            precision=None, tile_n=TILE_N):
    """Plain version of K11: the selected tiles' code columns gathered in
    selection order, LUT-scored as K7a scores them (with ``rowadd`` of each
    corpus row and ``corr`` in selection order), their stride-class
    candidates over spans of SPAN tiles, an exact merge; ids are corpus
    rows."""
    _residual_pair(rowadd, corr)
    words, scale, bias = _operands(lut, precision or lut_precision())
    rows = tile_rows(tile_sel, tile_n)
    scores = _plain_scores(words, scale, bias, codes_t[:, rows], rows.shape[0])
    scores = _add_residual(scores, None if rowadd is None else rowadd[rows], corr,
                           selection=True)
    vals, loc = approx_candidates(scores, tile_n)
    return merge_candidates(vals, rows.to(torch.int32)[loc.long()], k)


def pq_search_indexed(lut, codes_t, tile_sel, rowadd=None, corr=None, *, k,
                      precision=None, tile_n=TILE_N):
    """Fused approx PQ search (K11) over the selected tiles ``tile_sel`` i32
    [T] of ``tile_n`` rows (tile t = corpus rows [t*tile_n, (t+1)*tile_n),
    tile_n a multiple of 128 dividing Npad; with the additives a multiple
    of 512): the IVF probe scan, reading the selected code columns in place.
    Every selected row is valid. ``rowadd`` [Npad] (indexed by corpus row)
    and ``corr`` [T*tile_n/512, Q] (selection order). Returns (scores
    f32[Q, k], ids i32[Q, k]), ids corpus rows; k <= APPROX_K_MAX."""
    check_search("approx", k)
    _residual_pair(rowadd, corr)
    if not use_kernels(codes_t):
        return pq_search_indexed_plain(lut, codes_t, tile_sel, rowadd, corr, k=k,
                                       precision=precision, tile_n=tile_n)
    precision = precision or lut_precision()
    q, npad, dev = lut.shape[0], codes_t.shape[1], codes_t.device
    nt = tile_sel.shape[0]
    if tile_n % 128 or npad % tile_n or (corr is not None and tile_n % CORR_BLK):
        raise ArgumentsError(
            f"tile_n={tile_n} must be a multiple of 128 (512 with the residual additives) "
            f"dividing N={npad}")
    _check_operands(lut, codes_t, npad)
    check_tensors(dev, (("tile_sel", tile_sel, torch.int32, (nt,)),))
    res = _residual_args(rowadd, corr, q, npad, nt * tile_n // CORR_BLK, True, dev)
    n_valid = nt * tile_n
    # The kernel scores EXACT_SPLIT-row tiles of compact rows: pad the list
    # to whole tiles with its last entry, whose rows past n_valid score NEG.
    per = max(1, EXACT_SPLIT // tile_n)
    sel = tile_sel
    if nt % per:
        sel = torch.cat([tile_sel, tile_sel[-1:].expand(per - nt % per)])
    ncomp = sel.shape[0] * tile_n
    span = SPAN * tile_n
    nblocks = -(-ncomp // span)
    vals = torch.empty((q, nblocks * 128), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nblocks * 128), dtype=torch.int32, device=dev)
    if q and nt:
        if onehot_route(lut.shape[2], precision, "indexed", tile_n):
            _launch_onehot("pq_search_indexed", lut, codes_t, n_valid, (vals, ids),
                           onehot_voff(rowadd, npad, dev), res[1:], sel=sel, tile_n=tile_n,
                           ncomp=ncomp, part=span)
        else:
            _launch("pq_search_indexed", lut, codes_t, precision, n_valid, (vals, ids), *res,
                    sel.data_ptr(), tile_n, ncomp, span, fn="pq_search_approx")
    return merge_candidates(vals, ids, k)
