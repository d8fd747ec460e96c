"""Batched k-means: Lloyd's iterations over every PQ chunk at once.

Twin of ``quantization_tpu/ops/kmeans.py`` (replacement of the reference's
per-chunk rayon k-means, quantization/src/kmeans.rs). Assignment is a
batched matmul + argmin; the update sums the rows with a one-hot matmul,
which is deterministic on the card (``index_add_``'s atomics would reorder
the sums from run to run).

Reference semantics preserved:
  * init = first k sample points (kmeans.rs:25)
  * empty clusters reseeded from a random data point (kmeans.rs:111-118)
  * convergence when sum |c_new - c_old| < accuracy, per chunk
    (kmeans.rs:125-135); converged chunks freeze while the rest iterate
  * cooperative cancellation between iterations (kmeans.rs:29-31)

The reseed rows come from ``np.random.default_rng(seed).integers(0, n,
(t, g, k))``, drawn once per block of t iterations for each group of g
chunks not yet converged. The port keeps the JAX package's blocks (10
iterations, 1 under a ``stop_condition``), groups, group order and skip of
converged groups, so both packages draw the same reseeds from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ArgumentsError, check_stop
from .pq import full_f32, sq_distances

# Cap on the transient [g, n, k] f32 distance tensor per group.
_DIST_BYTES_CAP = 512 * 1024 * 1024


def group_size(m: int, n: int, k: int, cap: int = _DIST_BYTES_CAP) -> int:
    """Largest balanced chunk-group size whose [g, n, k] f32 tensor fits cap."""
    gmax = max(1, min(m, cap // max(1, n * k * 4)))
    ngroups = -(-m // gmax)
    return -(-m // ngroups)


def lloyd_iteration(centroids, data, reseed_rows, frozen):
    """One Lloyd iteration for a group of chunks: centroids f32[g, k, d],
    data f32[g, n, d], reseed_rows int64[g, k], frozen bool[g] ->
    (new centroids f32[g, k, d], diff f32[g])."""
    k = centroids.shape[1]
    idx = torch.argmin(sq_distances(data, centroids), dim=2)  # first minimum
    onehot = torch.zeros(idx.shape + (k,), dtype=torch.float32, device=data.device)
    onehot.scatter_(2, idx[:, :, None], 1.0)  # [g, n, k]
    counts = torch.sum(onehot, dim=1)  # [g, k]
    with full_f32():
        sums = torch.bmm(onehot.transpose(1, 2), data)  # [g, k, d]
    mean = sums / torch.clamp(counts, min=1.0)[:, :, None]
    reseed = torch.gather(
        data, 1, reseed_rows[:, :, None].expand(-1, -1, data.shape[2])
    )
    new_c = torch.where((counts == 0)[:, :, None], reseed, mean)
    new_c = torch.where(frozen[:, None, None], centroids, new_c)
    diff = torch.sum(torch.abs(new_c - centroids), dim=(1, 2))
    return new_c, diff


def _kmeans_block(centroids, data, reseed_rows, frozen, accuracy):
    """t Lloyd iterations (reseed_rows [t, g, k]); a chunk that converges
    freezes at once (kmeans.rs:125-135). Returns (centroids, frozen)."""
    for rr in reseed_rows:
        centroids, diff = lloyd_iteration(centroids, data, rr, frozen)
        frozen = frozen | (diff < accuracy)
    return centroids, frozen


def kmeans_batched(
    data: torch.Tensor,
    k: int,
    max_iterations: int = 100,
    accuracy: float = 1e-5,
    seed: int = 0,
    stop_condition=None,
    init: torch.Tensor = None,
) -> torch.Tensor:
    """Cluster every chunk of ``data`` f32[m, n, d] into ``k`` centroids on
    the data's device. Returns f32[m, k, d]. ``init`` [m, k, d] warm-starts
    the centroids (OPQ's alternating refinement); the default is the first
    k points (kmeans.rs:25). The caller's cancellation flag is checked
    between blocks."""
    data = data.to(torch.float32)
    m, n, d = data.shape
    if n < k:
        raise ArgumentsError(f"kmeans needs >= {k} points per chunk, got {n}")
    g = group_size(m, n, k)
    ngroups = -(-m // g)
    mpad = ngroups * g
    if init is not None:
        init = init.to(device=data.device, dtype=torch.float32)
        if tuple(init.shape) != (m, k, d):
            raise ArgumentsError(f"kmeans init shape {tuple(init.shape)} != {(m, k, d)}")
        if mpad != m:
            init = torch.cat([init, init[: mpad - m]], dim=0)
    if mpad != m:
        # Trailing chunks duplicated to whole groups, as in the JAX package
        # (whose groups share one compiled shape); their results are dropped.
        data = torch.cat([data, data[: mpad - m]], dim=0)
    groups = [data[i * g : (i + 1) * g] for i in range(ngroups)]
    if init is not None:
        cents = [init[i * g : (i + 1) * g] for i in range(ngroups)]
    else:
        cents = [grp[:, :k, :].clone() for grp in groups]
    converged = np.zeros((mpad,), bool)
    host_rng = np.random.default_rng(seed)
    block = 1 if stop_condition is not None else min(10, max_iterations)
    it = 0
    while it < max_iterations:
        check_stop(stop_condition)
        t = min(block, max_iterations - it)
        for gi in range(ngroups):
            sl = slice(gi * g, (gi + 1) * g)
            if converged[sl].all():
                continue
            rr = torch.from_numpy(host_rng.integers(0, n, size=(t, g, k))).to(data.device)
            froz = torch.from_numpy(converged[sl].copy()).to(data.device)
            cents[gi], froz = _kmeans_block(cents[gi], groups[gi], rr, froz, accuracy)
            converged[sl] = froz.cpu().numpy()
        it += t
        if converged.all():
            break
    out = torch.cat(cents, dim=0) if ngroups > 1 else cents[0]
    return out[:m]
