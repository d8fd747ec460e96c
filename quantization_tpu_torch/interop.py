"""State exchange with the JAX package, through numpy only.

The JAX quantizers' state is, for SQ, ``np.asarray(enc.codes)``,
``np.asarray(enc.voffsets)`` and ``enc.metadata.to_json()``; for BQ,
``np.asarray(enc.planes)`` (uint32 [W8, Npad]), ``enc.metadata.to_json()``
and ``enc.store_type``. Both packages keep the same in-memory layouts, so
the arrays carry over whole. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .models.bq import BinaryQuantizer, BQMetadata
from .models.sq import ScalarQuantizerU8, SQMetadata
from .ops import bq as bq_ops
from .ops.dispatch import resolve_device


def sq_from_numpy(
    codes: np.ndarray, voffsets: np.ndarray, metadata_json: dict, device=None
) -> ScalarQuantizerU8:
    """The port's ScalarQuantizerU8 on ``device`` (default: the CUDA card)
    from a quantizer's arrays."""
    device = resolve_device(device)
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


def bq_from_numpy(
    planes_u32: np.ndarray, metadata_json: dict, store_type: str = "u128",
    device=None,
) -> BinaryQuantizer:
    """The port's BinaryQuantizer on ``device`` (default: the CUDA card) from
    a quantizer's uint32 bit planes [W, N]."""
    device = resolve_device(device)
    return BinaryQuantizer(
        bq_ops.words_to_tensor(planes_u32, device),
        BQMetadata.from_json(metadata_json),
        store_type,
    )


def bq_to_numpy(enc: BinaryQuantizer) -> Tuple[np.ndarray, dict, str]:
    """(uint32 planes, metadata json, store_type) of the port's quantizer."""
    return bq_ops.tensor_to_words(enc.planes), enc.metadata.to_json(), enc.store_type
