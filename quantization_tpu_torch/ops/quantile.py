"""Calibration: global min/max scan and quantile-interval estimation.

Twin of ``quantization_tpu/ops/quantile.py`` (host numpy, carried over
unchanged). Equivalent of quantization/src/quantile.rs. The reference samples
up to 100k vectors via a random permutation and cuts both tails with two
``select_nth_unstable`` passes (quantile.rs:21-71); we sample with numpy and
cut with ``np.partition`` — same estimator, same guard conditions, same quirk
that the cut index is computed from the *vector* sample size rather than the
element count (quantile.rs:53-57).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

QUANTILE_SAMPLE_SIZE = 100_000  # reference quantile.rs:3
MIN_COUNT_FOR_QUANTILE = 127  # reference quantile.rs:27


def find_min_max_batches(batches: Iterator[np.ndarray]) -> Tuple[float, float]:
    """Global (min, max) over all values (reference quantile.rs:5-19)."""
    mn = np.float32(np.inf)
    mx = np.float32(-np.inf)
    for batch in batches:
        if batch.size == 0:
            continue
        mn = min(mn, np.min(batch))
        mx = max(mx, np.max(batch))
    if not np.isfinite(mn):
        return 0.0, 0.0
    return float(mn), float(mx)


def sample_rows(
    data_iterator_factory, count: int, sample_size: int, seed: int = 0
) -> np.ndarray:
    """Gather ``sample_size`` random distinct rows across a batch stream.

    The reference draws a random permutation of indices and walks the iterator
    once (quantile.rs:32-46); we do the same with a sorted index sample.
    """
    sample_size = min(count, sample_size)
    rng = np.random.default_rng(seed)
    if count <= sample_size:
        selected = np.arange(count)
    else:
        selected = np.sort(rng.choice(count, size=sample_size, replace=False))
    out = []
    sel_pos = 0
    row_base = 0
    for batch in data_iterator_factory():
        b = batch.shape[0]
        # indices of `selected` that fall in [row_base, row_base + b)
        hi = np.searchsorted(selected, row_base + b, side="left")
        if hi > sel_pos:
            local = selected[sel_pos:hi] - row_base
            out.append(np.asarray(batch, dtype=np.float32)[local])
            sel_pos = hi
            if sel_pos == len(selected):
                break
        row_base += b
    if not out:
        return np.zeros((0, 0), dtype=np.float32)
    return np.concatenate(out, axis=0)


def find_quantile_interval(
    sample: np.ndarray, count: int, quantile: float
) -> Optional[Tuple[float, float]]:
    """Two-sided quantile cut over a row sample.

    ``sample`` is the [slice_size, dim] row sample; ``count`` is the full
    corpus size (used only for the reference's guard). Returns None when the
    guards fire, exactly as quantile.rs:27-29,49-50,63-64 — the caller then
    falls back to plain min/max.
    """
    if count < MIN_COUNT_FOR_QUANTILE or quantile >= 1.0:
        return None
    slice_size = sample.shape[0]
    flat = np.asarray(sample, dtype=np.float32).ravel()
    n = flat.size
    if n < 4:
        return None
    # Quirk preserved from quantile.rs:53-57: the cut is sized from the number
    # of sampled *vectors*, not elements.
    cut = min((n - 1) // 2, int(slice_size * (1.0 - quantile) / 2.0))
    cut = max(cut, 1)
    if n - 2 * cut - 1 < 2:
        return None
    # Selected ranks are [cut+1, n-cut-1] (see the double select_nth at
    # quantile.rs:59-61); min/max of that range are these two order statistics.
    lo_rank = cut + 1
    hi_rank = n - cut - 1
    part = np.partition(flat, (lo_rank, hi_rank))
    return float(part[lo_rank]), float(part[hi_rank])
