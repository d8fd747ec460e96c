"""Top-k selection constants and the candidate merges that run outside the
search kernels.

Twin of ``quantization_tpu/ops/pallas/ktile.py``. The fused search kernels
(``sq_kernel.py``) never write the [Q, N] score matrix: they reduce it to
per-block candidates, and the merges here select the final top-k from those
candidates with ``torch.topk`` — outside the kernel, as the JAX package
merges with ``lax.top_k`` outside Pallas.

Exact mode needs no spill bound and no fallback: each kernel block returns
the exact top-min(k, rows) of the compact rows it covers, the lower row
first among equal scores, so the union of the blocks' candidates holds the
exact top-k by construction. An empty slot (k > n_valid) comes back as
-inf / -1, as in the JAX package (``merge_exact``). The blocks' rows and
select follow from kk alone (``exact_geometry``): up to QUEUE_K_MAX a
threshold-filtered queue over a range of several EXACT_SPLIT-row splits,
above it the radix select of one split.

Approx mode keeps the JAX candidate geometry (one max per 128-wide stride
class over SPAN consecutive tiles). Its final merge is exact here, where the
JAX package uses ``approx_max_k``, so the port's recall is never lower.

The kernels share the same selection code on the card: ``csrc/ktile.cuh``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.types import ArgumentsError

# Score of a masked (padding) row and of an empty kernel candidate slot.
NEG = -3.4e38

# Stride-class count of the approx extraction (one candidate slot per class).
SLOT = 128

# Exact fused search cap: the JAX contract (models/sq.py:362-365).
FUSED_K_MAX = 1024

# Corpus rows a block of the radix select covers, and the unit of the
# queue select's ranges.
EXACT_SPLIT = 512

# The queue select's largest kk (csrc/ktile.cuh kQueueK); larger kk take
# the radix select. No switch chooses between them.
QUEUE_K_MAX = 64

# Blocks of one queue-select launch: two a SM on an H100's 132 SMs, so one
# wave fills the card. A constant, so the blocks' rows (and the ids among
# tied scores) do not depend on the card.
QUEUE_WAVE = 264

#: Exact-search launches per select since the last reset.
SELECT_LAUNCHES = {"queue": 0, "radix": 0}

# Approx fused search cap: bounded by the merge width, not the tile.
APPROX_K_MAX = 4096

# Corpus tiles max-merged into one [Q, SLOT] approx candidate block.
SPAN = 4

# The int8 approx body (csrc/dot_scan.cuh approx_ws_kernel: K2 / K9a, the
# value-query K5a / K10): a block takes APPROX_TQ queries (64 where there
# are no more), one block a SM, and walks work items of a part of rows each
# (approx_geometry). An item is a whole span block (pass 1 writes the
# candidates in place, no combine) unless smaller parts, at least
# APPROX_MIN_PART rows, end the walk sooner by more than the margin: on an
# NVIDIA H100 80GB HBM3 at 700 W (csrc/probe/approx_split.cu) K9a's span
# items in place took 0.1632 ms against 0.2021 + 0.0215 for 2048-row items
# and the combine, whose walk the model puts equal, and dense K2 at 100k x
# 1024 rows (26 span items on 132 SMs) 0.3731 against 0.1251 + 0.0056. A
# segment number is a byte (0xff: none), so a part holds at most
# APPROX_MAX_SEGS segments of SLOT rows.
APPROX_TQ = 128
APPROX_MIN_PART = 2048
APPROX_MAX_SEGS = 255
APPROX_INPLACE_MARGIN = 0.9

# Rows per value of a residual-IVF ``corr`` additive (the JAX package's
# CORR_BLK, sq_kernel.py:55): IVF buckets are CORR_BLK-aligned, so one value
# per query and 512-row block carries the bucket term exactly.
CORR_BLK = 512


def select_route(k: int) -> str:
    """The exact kernels' select for a top-``k`` search: "queue" or "radix"."""
    return "queue" if min(k, EXACT_SPLIT) <= QUEUE_K_MAX else "radix"


def exact_geometry(k: int, ncomp: int, q: int, tq: int) -> Tuple[int, int, int, str]:
    """(kk, split, width, route) of an exact kernel launch over ``ncomp``
    compact rows and ``q`` queries in tiles of ``tq``: each block covers
    ``split`` rows and writes its top-kk, so the candidates are [q, width],
    width = ceil(ncomp / split) * kk. The radix select takes one
    EXACT_SPLIT; the queue select a range of whole splits, as few as give
    QUEUE_WAVE blocks over the ceil(q / tq) query tiles."""
    kk = min(k, EXACT_SPLIT)
    nsplit = -(-ncomp // EXACT_SPLIT)
    route = select_route(k)
    split = EXACT_SPLIT
    if route == "queue":
        per = max(1, QUEUE_WAVE // max(1, -(-q // tq)))
        split *= max(1, -(-nsplit // per))
    return kk, split, -(-ncomp // split) * kk, route


def approx_geometry(ncomp: int, q: int, span_rows: int, nsm: int) -> int:
    """Rows of an approx work item (pass 1's ``part``) over ``ncomp`` compact
    rows, ``q`` queries and span blocks of ``span_rows``, on a card of
    ``nsm`` SMs. The body runs one block a SM (the grid a multiple of the
    query tiles), each walking every grid-th item, so the launch lasts about
    ceil(items / grid) items of ``part`` rows: the span block, unless a part
    of span / 2, / 4, ... (at least APPROX_MIN_PART rows) cuts that below
    APPROX_INPLACE_MARGIN of it or the span block holds more than
    APPROX_MAX_SEGS segments; then the smallest such time, the larger part on
    a tie. The candidates do not depend on it: the combine of smaller parts
    is the span block's own in-order maximum."""
    nqt = -(-q // (APPROX_TQ if q > 64 else 64))
    grid = max(1, nsm // nqt) * nqt

    def cost(part):
        items = -(-ncomp // part) * nqt
        return -(-items // min(grid, items)) * part

    def fits(part):
        return part // SLOT <= APPROX_MAX_SEGS

    parts, part = [], span_rows
    while part % 2 == 0 and part // 2 >= APPROX_MIN_PART and (part // 2) % SLOT == 0:
        part //= 2
        if fits(part):
            parts.append(part)
    small = min(parts, key=lambda p: (cost(p), -p), default=None)
    if not fits(span_rows):
        if small is None:
            raise ValueError(f"no approx work item of at most {APPROX_MAX_SEGS} segments "
                             f"divides a span block of {span_rows} rows")
        return small
    if small is not None and cost(small) < APPROX_INPLACE_MARGIN * cost(span_rows):
        return small
    return span_rows


def approx_buffers(q: int, ncomp: int, span_rows: int, part: int, dev):
    """(part_v, part_i, vals, ids) of an approx launch: pass 1's maxima
    [q, ceil(ncomp / part) * SLOT] and the span blocks' candidates [q,
    ceil(ncomp / span_rows) * SLOT]; one pair where ``part`` is the span
    block, which pass 1 then writes in place."""
    nblocks = -(-ncomp // span_rows)
    vals = torch.empty((q, nblocks * SLOT), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nblocks * SLOT), dtype=torch.int32, device=dev)
    if part == span_rows:
        return vals, ids, vals, ids
    nparts = -(-ncomp // part)
    return (torch.empty((q, nparts * SLOT), dtype=torch.float32, device=dev),
            torch.empty((q, nparts * SLOT), dtype=torch.int32, device=dev), vals, ids)


def sm_count(dev) -> int:
    """The SMs of the CUDA card ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def corr_strides(corr: torch.Tensor, q: int, selection: bool):
    """(corr_qs, corr_bs) of ``corr`` as the kernels read it (ktile.cuh
    ScanMap): the dense layout [Q, N/CORR_BLK], or the indexed scans'
    selection order [T*tile_n/CORR_BLK, Q]."""
    return (1, q) if selection else (corr.shape[1], 1)


def expand_corr(corr: torch.Tensor, selection: bool = False) -> torch.Tensor:
    """Plain version of the kernels' corr read: [Q, blocks*CORR_BLK], the
    value of each row's 512-row block (dense [Q, blocks] or selection order
    [blocks, Q])."""
    c = corr.T if selection else corr
    return torch.repeat_interleave(c, CORR_BLK, dim=1)


def tile_rows(tile_sel: torch.Tensor, tile_n: int) -> torch.Tensor:
    """int64 [T * tile_n]: the corpus rows of the selected tiles, in
    selection order — the compact rows of an indexed scan."""
    base = tile_sel.to(torch.int64)[:, None] * tile_n
    return (base + torch.arange(tile_n, device=tile_sel.device)).reshape(-1)


def merge_chunks(parts, kk: int, neg: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-kk over per-chunk results [(sv [Q, kk], loc [Q, kk]), ...]
    of a scan split into chunks of tiles (models/ivf.py:598-603 of the JAX
    package): empty slots (loc < 0) score ``neg``, and every merged slot not
    above it comes back as ``neg`` / -1. Chunks cover disjoint tiles, so no
    candidate appears twice."""
    sv = torch.cat([s for s, _ in parts], dim=1)
    loc = torch.cat([i for _, i in parts], dim=1)
    sv = torch.where(loc >= 0, sv, sv.new_full((), neg))
    s, pos = torch.topk(sv, kk, dim=1)
    loc = torch.gather(loc, 1, pos)
    return s, torch.where(s > neg, loc, loc.new_full((), -1))


def check_search(mode: str, k: int) -> None:
    """Reject a fused-search mode or k outside the caps above."""
    if mode not in ("exact", "approx"):
        raise ArgumentsError(f"unknown search mode {mode!r}")
    cap = FUSED_K_MAX if mode == "exact" else APPROX_K_MAX
    if not 1 <= k <= cap:
        raise ArgumentsError(f"{mode} fused search takes 1 <= k <= {cap}, got {k}")


def check_tensors(device, specs, align: int = 1) -> None:
    """Reject a kernel operand: each (name, tensor, dtype, shape) of
    ``specs`` must lie on ``device`` with that dtype and shape, contiguous,
    its data ``align``-byte aligned."""
    for name, t, dtype, shape in specs:
        if t.device != device:
            raise ArgumentsError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ArgumentsError(
                f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ArgumentsError(f"{name} must be contiguous and {align}-byte aligned")


def merge_candidates(
    vals: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over candidate pools vals/ids [Q, W]; slots beyond the
    pool width hold NEG / -1 (ktile.py:272-274 of the JAX package)."""
    kk = min(k, vals.shape[1])
    s, pos = torch.topk(vals, kk, dim=1)
    gi = torch.gather(ids, 1, pos)
    if kk < k:
        q = vals.shape[0]
        s = torch.cat([s, s.new_full((q, k - kk), NEG)], dim=1)
        gi = torch.cat([gi, gi.new_full((q, k - kk), -1)], dim=1)
    return s, gi


def merge_exact(
    vals: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_candidates`` for the exact searches: every slot whose id is
    < 0 after the merge — an empty kernel slot or the padding beyond the
    pool — scores -inf, the JAX package's sentinel when k > n_valid
    (ops/topk.py:49-57). The mask reads the id, never the value, so a real
    row is never taken for an empty one."""
    s, gi = merge_candidates(vals, ids, k)
    return torch.where(gi >= 0, s, s.new_full((), float("-inf"))), gi


def approx_candidates(
    scores: torch.Tensor, tile_n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the approx extraction (``extract_approx_tile`` +
    ``combine_slots`` of the JAX package, ktile.py:392-435).

    scores f32[Q, Npad], rows >= n_valid already NEG, Npad % tile_n == 0.
    Returns (vals f32, ids i32), each [Q, ceil(nt/SPAN) * SLOT]: slot l of
    block b holds the max over rows {b*SPAN*tile_n + m*SLOT + l} of the
    block, the smallest row winning ties — the order in which the Pallas
    kernel's strict ``>`` compares meet them."""
    q, npad = scores.shape
    block = SPAN * tile_n
    nb = -(-npad // block)
    pad = nb * block - npad
    if pad:
        # Padding loses every comparison against a real (or NEG) score.
        scores = torch.cat(
            [scores, scores.new_full((q, pad), float("-inf"))], dim=1
        )
    members = scores.reshape(q, nb, block // SLOT, SLOT)
    win = torch.argmax(members, dim=2)  # first maximum: smallest row
    vals = torch.gather(members, 2, win[:, :, None]).squeeze(2)
    base = torch.arange(nb, device=scores.device)[None, :, None] * block
    lane = torch.arange(SLOT, device=scores.device)[None, None, :]
    ids = base + win * SLOT + lane
    return vals.reshape(q, nb * SLOT), ids.reshape(q, nb * SLOT).to(torch.int32)
