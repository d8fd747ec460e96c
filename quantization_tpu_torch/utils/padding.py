"""Shape-alignment helpers shared by the kernel wrappers.

Twin of ``quantization_tpu/utils/padding.py``, for torch tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return x + (-x) % m


def pad_dim_to(t: torch.Tensor, axis: int, target: int, value=0) -> torch.Tensor:
    """Pad one axis of a tensor up to ``target`` with ``value`` (same device)."""
    n = t.shape[axis]
    if n == target:
        return t
    if n > target:
        raise ValueError(f"axis {axis} is {n}, larger than target {target}")
    # F.pad lists (left, right) pairs from the LAST axis backwards.
    widths = [0, 0] * (t.ndim - 1 - axis % t.ndim) + [0, target - n]
    return F.pad(t, widths, value=value)
