"""State exchange with the JAX package, through numpy only.

The JAX quantizers' state is, for SQ, ``np.asarray(enc.codes)``,
``np.asarray(enc.voffsets)`` and ``enc.metadata.to_json()``; for BQ,
``np.asarray(enc.planes)`` (uint32 [W8, Npad]), ``enc.metadata.to_json()``
and ``enc.store_type``; for PQ, ``np.asarray(enc.codes)`` (uint8 [Npad,
Mpad]) and ``enc.metadata.to_json()``. An IVF index is its inner quantizer's state
plus ``bucket_ids`` (int32 [B, S]), ``bucket_means`` (f32 [B, D]) and
``metadata.to_json()``. Both packages keep the same in-memory layouts, so
the arrays carry over whole. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .models.bq import BinaryQuantizer, BQMetadata
from .models.ivf import IVFIndex, IVFMetadata
from .models.pq import PQMetadata, ProductQuantizer
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


def pq_from_numpy(codes: np.ndarray, metadata_json: dict, device=None) -> ProductQuantizer:
    """The port's ProductQuantizer on ``device`` (default: the CUDA card)
    from a quantizer's uint8 codes [N or Npad, m or Mpad]."""
    device = resolve_device(device)
    return ProductQuantizer(
        torch.from_numpy(np.array(codes, dtype=np.uint8)).to(device),
        PQMetadata.from_json(metadata_json),
    )


def pq_to_numpy(enc: ProductQuantizer) -> Tuple[np.ndarray, dict]:
    """(uint8 codes [Npad, Mpad], metadata json) of the port's quantizer."""
    return enc.codes.cpu().numpy(), enc.metadata.to_json()


_INNER = {
    "sq": (sq_from_numpy, sq_to_numpy),
    "pq": (pq_from_numpy, pq_to_numpy),
    "bq": (bq_from_numpy, bq_to_numpy),
}


def ivf_from_numpy(
    inner: tuple, bucket_ids: np.ndarray, bucket_means: np.ndarray, metadata_json: dict,
    device=None,
) -> IVFIndex:
    """The port's IVFIndex on ``device`` (default: the CUDA card) from an
    index's state: ``inner`` the arguments of ``sq_/pq_/bq_from_numpy`` for
    its quantizer (metadata["kind"]), then its bucket ids, bucket means and
    metadata json. A residual index's search arrays are derived again here,
    as at load."""
    meta = IVFMetadata.from_json(metadata_json)
    quantizer = _INNER[meta.kind][0](*inner, device=device)
    return IVFIndex(quantizer, np.array(bucket_ids, np.int32),
                    np.array(bucket_means, np.float32), meta)


def ivf_to_numpy(ivf: IVFIndex) -> Tuple[tuple, np.ndarray, np.ndarray, dict]:
    """(inner quantizer state, bucket_ids, bucket_means, metadata json) of
    the port's index, on the host."""
    inner = _INNER[ivf.metadata.kind][1](ivf.quantizer)
    return inner, ivf.bucket_ids.copy(), ivf.bucket_means.copy(), ivf.metadata.to_json()
