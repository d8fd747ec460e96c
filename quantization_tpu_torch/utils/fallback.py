"""One-line warnings when a search leaves the fused kernel path.

Twin of ``quantization_tpu/utils/fallback.py``. The fused searches exist to
avoid the [Q, N] score matrix; a call that cannot take them (k beyond the
fused cap, a metric without a kernel) scores and then selects, which is
exact but slower and holds the matrix. At large N that should never be
silent."""

from __future__ import annotations

import warnings

# Below this many scanned rows the unfused paths are cheap enough that a
# warning would be noise.
WARN_MIN_COUNT = 1_000_000


def warn_unfused(model: str, count: int, k: int, method: str) -> None:
    if count < WARN_MIN_COUNT:
        return
    warnings.warn(
        f"{model} {method} top-k (k={k}) left the fused kernel path at "
        f"N={count}: it scores the [Q, N] matrix and then selects (exact, but "
        f"slower than the fused search). Use method='approx', a smaller k, or "
        f"a two-stage index for serving.",
        RuntimeWarning,
        stacklevel=3,
    )
