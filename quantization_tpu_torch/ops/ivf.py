"""IVF — inverted-file coarse index: cluster the corpus, store it
bucket-major, and scan only the buckets nearest each query.

Twin of ``quantization_tpu/ops/ivf.py``. The layout is the JAX package's:
  * fixed-size buckets: each k-means cluster's run is split evenly into
    buckets of exactly ``bucket_size`` rows, so a probe reads whole
    [S, row] blocks;
  * an S-aligned permutation: bucket b owns inner rows [b*S, (b+1)*S); pad
    slots duplicate real rows from one global cyclic cursor (id -1 in the
    bucket id map), so the permuted corpus holds only genuine vectors;
  * probing scores the queries against per-bucket means.

The host bookkeeping (``build_buckets``, ``bucket_means``,
``residualize_inplace``) is the JAX package's numpy, step for step, so its
outputs are byte-equal; training and assignment run in torch on the
caller's device, in full f32 (TF32 off), with the JAX package's blocking
and reseed stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import check_stop
from .kmeans import kmeans_batched
from .pq import chunk_rows_device, full_f32

IVF_SAMPLE_PER_CENTER = 64  # training rows per center (cap below)
# Sample caps: the small one bounds the in-core trainer's [n, nlist]
# distance tensor; past it the streamed blocked-Lloyd trainer takes over,
# whose own cap bounds the build host's sample memory.
IVF_SAMPLE_CAP = 262_144
IVF_SAMPLE_CAP_BIG = 4_194_304
ASSIGN_BLOCK = 65_536  # rows per assignment block
# Cap on any [rows, centers] f32 score transient (assignment + training).
_SCORES_BYTES_CAP = 1 << 31


def sample_cap(nlist: int) -> int:
    """Training-sample row cap for ``nlist`` centers: the in-core cap while
    it gives >= IVF_SAMPLE_PER_CENTER rows per center, else the streamed
    trainer's."""
    if IVF_SAMPLE_PER_CENTER * nlist <= IVF_SAMPLE_CAP:
        return IVF_SAMPLE_CAP
    return IVF_SAMPLE_CAP_BIG


def train_centers(
    sample,
    nlist: int,
    *,
    seed: int = 0,
    stop_condition=None,
    max_iterations: int = 25,
    device=None,
) -> np.ndarray:
    """k-means centers f32[nlist, D] on a sample (host numpy or a tensor),
    trained on ``device`` (default: the sample's, else the CPU).

    Small problems (the [n, nlist] distance tensor fits
    ``_SCORES_BYTES_CAP``) run the batched trainer of PQ (``ops/kmeans.py``,
    one chunk); big ones the streamed blocked-Lloyd trainer."""
    n = int(sample.shape[0])
    nlist = min(nlist, n)
    x = _as_f32(sample, device)
    if n * nlist * 4 <= _SCORES_BYTES_CAP:
        cents = kmeans_batched(
            x[None], nlist, max_iterations=max_iterations, seed=seed,
            stop_condition=stop_condition,
        )
        return cents[0].cpu().numpy()
    return _train_centers_streamed(
        x, nlist, seed=seed, stop_condition=stop_condition,
        max_iterations=max_iterations,
    )


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device or "cpu")


def _center_blocks(nlist: int) -> tuple:
    """(ncb, cb): ``nlist`` centers in ncb blocks of cb (a multiple of 128,
    near-even) whose [ASSIGN_BLOCK, cb] score transient respects the cap."""
    max_cb = max(128, _SCORES_BYTES_CAP // (4 * ASSIGN_BLOCK))
    ncb = -(-nlist // max_cb)
    cb = -(-nlist // ncb)
    cb += (-cb) % 128
    return ncb, cb


def _pad_centers(centers: torch.Tensor, nlist: int):
    """(centers [ncb, cb, D], cc [ncb, cb]) blocked and padded; pad rows
    carry a +inf squared norm so argmin never selects them."""
    ncb, cb = _center_blocks(nlist)
    c = torch.nn.functional.pad(centers, (0, 0, 0, ncb * cb - nlist))
    cc = torch.sum(c * c, dim=1)
    cc[nlist:] = float("inf")
    return c.reshape(ncb, cb, -1), cc.reshape(ncb, cb)


def _assign_blocked(x: torch.Tensor, cblk: torch.Tensor, ccblk: torch.Tensor) -> torch.Tensor:
    """argmin_c ||x - c||^2 (as |c|^2 - 2 x.c) of one row block, over the
    center blocks with a running (best, argbest): an earlier block keeps a
    tie, and within a block the first minimum wins."""
    cb = cblk.shape[1]
    best = torch.full((x.shape[0],), float("inf"), device=x.device)
    arg = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for i in range(cblk.shape[0]):
        with full_f32():
            s = ccblk[i][None, :] - 2.0 * (x @ cblk[i].T)
        m, a = torch.min(s, dim=1)
        take = m < best
        best = torch.where(take, m, best)
        arg = torch.where(take, a + i * cb, arg)
    return arg


def assign_clusters(data, centers, *, stop_condition=None, device=None) -> np.ndarray:
    """Nearest-center (L2) assignment i32[N] on ``device``, blocked over rows
    (ASSIGN_BLOCK) and, past the transient cap, over centers."""
    nlist = int(centers.shape[0])
    cblk, ccblk = _pad_centers(_as_f32(centers, device), nlist)
    out = np.empty((data.shape[0],), np.int32)
    for b0 in range(0, data.shape[0], ASSIGN_BLOCK):
        check_stop(stop_condition)
        xb = _as_f32(data[b0 : b0 + ASSIGN_BLOCK], cblk.device)
        out[b0 : b0 + xb.shape[0]] = _assign_blocked(xb, cblk, ccblk).cpu().numpy()
    return out


def add_onehot_sums(sums, x, idx, counts=None) -> None:
    """sums[j] += the rows of x [n, D] whose ``idx`` is j (and counts[j] +=
    their number), for j over sums' rows: one-hot products in full f32, in
    row blocks of ASSIGN_BLOCK / 8 and target blocks of ``_center_blocks``
    (a [rows, cb] transient of <= 256 MB). Deterministic on the card, where
    ``index_add_`` would sum in atomic order."""
    nt = sums.shape[0]
    cb = _center_blocks(nt)[1]
    rb = ASSIGN_BLOCK // 8
    for r0 in range(0, x.shape[0], rb):
        xr, ir = x[r0 : r0 + rb], idx[r0 : r0 + rb]
        for j0 in range(0, nt, cb):
            j1 = min(j0 + cb, nt)
            onehot = (ir[:, None] == torch.arange(j0, j1, device=x.device)).to(torch.float32)
            with full_f32():
                sums[j0:j1] += onehot.T @ xr
            if counts is not None:
                counts[j0:j1] += onehot.sum(dim=0)


def _lloyd_streamed_iter(sample, centers, reseed, *, rb: int, nlist: int):
    """One Lloyd iteration over the sample in row blocks of ``rb`` (the last
    one partial): assign against the center blocks, accumulate per-center
    sums and counts (``add_onehot_sums``). Empty centers reseed from the
    sample rows ``reseed``. Returns (new_centers, diff)."""
    n, d = sample.shape
    cblk, ccblk = _pad_centers(centers, nlist)
    ncb, cb = ccblk.shape
    sums = torch.zeros((ncb * cb, d), device=sample.device)
    counts = torch.zeros((ncb * cb,), device=sample.device)
    for r0 in range(0, n, rb):
        x = sample[r0 : r0 + rb]
        add_onehot_sums(sums, x, _assign_blocked(x, cblk, ccblk), counts)
    sums, counts = sums[:nlist], counts[:nlist]
    mean = sums / torch.clamp(counts, min=1.0)[:, None]
    new_c = torch.where((counts == 0)[:, None], sample[reseed], mean)
    diff = torch.sum(torch.abs(new_c - centers))
    return new_c, diff


def _train_centers_streamed(
    sample: torch.Tensor,
    nlist: int,
    *,
    seed: int = 0,
    stop_condition=None,
    max_iterations: int = 25,
    accuracy: float = 1e-3,
) -> np.ndarray:
    """Blocked-Lloyd k-means for large (sample x nlist): first-k init, random
    reseed of empty clusters from a host stream drawn as the JAX package
    draws it, L1-diff convergence, cancellation between iterations.

    Unlike the JAX package (ROADMAP Queue 3, F1), the last partial row
    block is kept: the JAX trainer drops it, so with nlist above the rows
    left it has fewer than nlist centers to start from. Here every sample
    row is trained on and nlist <= n always holds (``train_centers`` clamps
    it), and reseeds draw from all n rows (the same stream whenever n is a
    multiple of the block)."""
    n = int(sample.shape[0])
    rb = min(n, ASSIGN_BLOCK // 8)  # [rb, cb] transient ~256 MB
    centers = sample[:nlist].clone()
    host_rng = np.random.default_rng(seed)
    for _ in range(max_iterations):
        check_stop(stop_condition)
        reseed = torch.from_numpy(host_rng.integers(0, n, size=(nlist,))).to(sample.device)
        centers, diff = _lloyd_streamed_iter(sample, centers, reseed, rb=rb, nlist=nlist)
        if float(diff) < accuracy * nlist:
            break
    return centers.cpu().numpy()


def build_buckets(assignments: np.ndarray, bucket_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split each cluster's run into fixed-size S-aligned buckets.

    Returns ``(perm, bucket_ids)``:
      * ``perm`` i64[B*S]: bucket b's slot s holds original row
        ``perm[b*S + s]``; pad slots repeat real rows drawn from one global
        cyclic cursor over 0..N-1 in bucket order;
      * ``bucket_ids`` i32[B, S]: original row ids per slot, -1 in pad
        slots (the search-time mask; one non-negative slot per id).
    A cluster's run is split evenly over its buckets, so no bucket is
    mostly pads."""
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    s = int(bucket_size)
    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    starts = (
        np.flatnonzero(np.diff(sorted_assign, prepend=sorted_assign[0] - 1))
        if n else np.zeros((0,), np.int64)
    )
    ends = np.append(starts[1:], n)
    perm_rows, id_rows = [], []
    pad_cursor = 0
    for st, en in zip(starts, ends):
        c = en - st
        nb_c = max(1, -(-c // s))
        for bi in range(nb_c):
            members = order[st + (c * bi) // nb_c : st + (c * (bi + 1)) // nb_c]
            fill = s - members.shape[0]
            ids = np.full((s,), -1, np.int32)
            ids[: members.shape[0]] = members
            if fill:
                pad = (pad_cursor + np.arange(fill)) % n
                pad_cursor = int((pad_cursor + fill) % n)
                members = np.concatenate([members, pad])
            perm_rows.append(members)
            id_rows.append(ids)
    if not perm_rows:
        return np.zeros((0,), np.int64), np.zeros((0, s), np.int32)
    return np.concatenate(perm_rows).astype(np.int64), np.stack(id_rows).astype(np.int32)


def bucket_means(
    data: np.ndarray, perm: np.ndarray, bucket_ids: np.ndarray, *, block_buckets: int = 1024
) -> np.ndarray:
    """f32[B, D] mean of each bucket's real member rows (pads excluded by the
    id mask): the probe targets. Blocked, so no full permuted copy is made."""
    nb, s = bucket_ids.shape
    dim = data.shape[1]
    out = np.empty((nb, dim), np.float32)
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        rows = data[perm[b0 * s : b1 * s]].reshape(b1 - b0, s, dim)
        valid = (bucket_ids[b0:b1] >= 0).astype(np.float32)[:, :, None]
        out[b0:b1] = ((rows * valid).sum(axis=1) / valid.sum(axis=1)).astype(np.float32)
    return out


def residualize_inplace(
    permuted: np.ndarray, means: np.ndarray, bucket_ids: np.ndarray, *, block_buckets: int = 1024
) -> None:
    """Turn the S-aligned permuted corpus into residuals in place (row -= its
    bucket's mean); pad slots get residual 0 (they are masked at search and
    stay out of the inner quantizer's calibration)."""
    nb, s = bucket_ids.shape
    for b0 in range(0, nb, block_buckets):
        b1 = min(b0 + block_buckets, nb)
        permuted[b0 * s : b1 * s] -= np.repeat(means[b0:b1], s, axis=0)
    pad = bucket_ids.reshape(-1) < 0
    if pad.any():
        permuted[pad] = 0.0


def sq_decoded_rowterm(
    codes: torch.Tensor, alpha: float, offset: float, means: torch.Tensor, bucket_size: int,
    dim: int, *, block_buckets: int = 64,
) -> torch.Tensor:
    """f32[B*S] squared norms |c_b + r^|^2 of the decoded points over the
    real dims (r^ = alpha * code + offset): the residual L2 score pairs the
    quantized cross term with the norm of the same decoded point, so code
    errors cancel in the ranking."""
    s = bucket_size
    parts = []
    for b0 in range(0, means.shape[0], block_buckets):
        b1 = min(b0 + block_buckets, means.shape[0])
        v = codes[b0 * s : b1 * s, :dim].to(torch.float32) * alpha + offset
        vhat = v + torch.repeat_interleave(means[b0:b1], s, dim=0)
        parts.append(torch.sum(vhat * vhat, dim=1))
    return torch.cat(parts) if parts else means.new_zeros((0,))


def pq_decoded_rowterm(
    codes: Optional[torch.Tensor], c_chunks: torch.Tensor, rot: Optional[torch.Tensor],
    means: torch.Tensor, bucket_size: int, division, *, block_buckets: int = 64,
    codes_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PQ twin of ``sq_decoded_rowterm``: |c_b + r^|^2 with r^ the rows'
    chunk centroids (OPQ: the norm is rotation-invariant, the cross term
    uses the rotated means). Per bucket block, T2[b, chunk, code] =
    2 (R c_b)_chunk . cent + |cent|^2, gathered by the rows' codes and
    summed over the chunks, plus |c_b|^2. ``codes`` u8 [Npad, Mpad], or
    ``codes_t`` [Mpad, Npad] for a transposed-first quantizer (only a
    block's columns are transposed, never the whole matrix)."""
    s = bucket_size
    m = len(division)
    with full_f32():
        mr = means if rot is None else means @ rot
        mean_norm = torch.sum(means * means, dim=1)
        cent_norm = torch.sum(c_chunks * c_chunks, dim=2)  # [m, k]
        parts = []
        for b0 in range(0, means.shape[0], block_buckets):
            b1 = min(b0 + block_buckets, means.shape[0])
            bb = b1 - b0
            mc = chunk_rows_device(mr[b0:b1], division)  # [m, bb, dmax]
            t2 = 2.0 * torch.bmm(mc, c_chunks.transpose(1, 2)) + cent_norm[:, None, :]
            cb = codes[b0 * s : b1 * s] if codes is not None else codes_t[:, b0 * s : b1 * s].T
            ct = cb[:, :m].reshape(bb, s, m).permute(2, 0, 1).long()  # [m, bb, s]
            g = torch.gather(t2, 2, ct)  # [m, bb, s]
            parts.append((torch.sum(g, dim=0) + mean_norm[b0:b1, None]).reshape(bb * s))
    return torch.cat(parts) if parts else means.new_zeros((0,))
