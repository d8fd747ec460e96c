"""State exchange with the JAX package, through numpy only.

The JAX quantizer's state is ``np.asarray(enc.codes)``,
``np.asarray(enc.voffsets)`` and ``enc.metadata.to_json()``; both packages
keep the same in-memory layout (int8 [Npad, lane_dim] codes, f32 [Npad]
offsets), so the arrays carry over whole. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .models.sq import ScalarQuantizerU8, SQMetadata


def sq_from_numpy(
    codes: np.ndarray, voffsets: np.ndarray, metadata_json: dict, device=None
) -> ScalarQuantizerU8:
    """The port's ScalarQuantizerU8 on ``device`` from a quantizer's arrays."""
    device = torch.device("cpu") if device is None else torch.device(device)
    # np.array copies: the caller's arrays (often read-only JAX buffers) are
    # never aliased.
    return ScalarQuantizerU8(
        torch.from_numpy(np.array(codes, dtype=np.int8)).to(device),
        torch.from_numpy(np.array(voffsets, dtype=np.float32)).to(device),
        SQMetadata.from_json(metadata_json),
    )


def sq_to_numpy(enc: ScalarQuantizerU8) -> Tuple[np.ndarray, np.ndarray, dict]:
    """(codes, voffsets, metadata json) of the port's quantizer, on the host."""
    return enc.codes.cpu().numpy(), enc.voffsets.cpu().numpy(), enc.metadata.to_json()
