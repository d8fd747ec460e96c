"""Binary quantization ops: sign-bit packing + XOR-popcount Hamming scoring.

Twin of ``quantization_tpu/ops/bq.py`` (the reference's
encoded_vectors_binary.rs and its xor-popcnt loops, cpp/sse.c:49-106):

  * storage is bit-packed, little-endian bit order within bytes and
    little-endian bytes within words — byte-identical to the reference's
    packed rows (encoded_vectors_binary.rs:193-208), 32x smaller than f32.
    The packing runs in numpy on the host, as in the JAX package.
  * on the device the codes live in **bit-plane layout**: [W, N] 32-bit
    words with the corpus axis last. torch has no uint32 arithmetic worth
    the name, so the device tensors are int32 holding the same bits, viewed
    as ``np.uint32`` at the numpy boundary; ``>>`` on them is arithmetic,
    so every shift here is masked.
  * zero bits beyond ``dim`` are zero in both operands, so padding never
    contributes to the XOR count (encoded_vectors_binary.rs:36-38).

torch has no popcount either: ``popcount32`` counts bits with the SWAR
method on int64, so the plain versions need nothing beyond torch. The
hand-written kernels (``ops/kernels/bq_kernel.py``) count a sign query's
Hamming distances as popc(q) + popc(c) - 2 popc(q & c), the AND counts from
the tensor cores' single-bit products.

Metric mapping from the XOR count x with true dimension d
(encoded_vectors_binary.rs:219-253):
    DOT:    (d - x) - x = d - 2x      (invert: 2x - d)
    L1/L2:  x - (d - x) = 2x - d      (invert: d - 2x)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import ArgumentsError, DistanceType
from .sq import affine_once, int_dot


def storage_bytes(dim: int, store_type: str = "u128") -> int:
    """Bytes per packed row, matching the reference's word-size tiers.

    ``u8`` tier (encoded_vectors_binary.rs:99-116): word size escalates with
    dim (1/4/8/16 bytes); ``u128`` (rs:152-159): always 16-byte words.
    """
    if store_type == "u8":
        if dim > 128:
            word = 16
        elif dim > 64:
            word = 8
        elif dim > 32:
            word = 4
        else:
            word = 1
    elif store_type == "u128":
        word = 16
    else:
        raise ArgumentsError(f"unknown bits store type {store_type!r}")
    bits = 8 * word
    words = dim // bits + (1 if dim % bits else 0)
    return words * word


def pack_rows(data: np.ndarray, row_bytes: int) -> np.ndarray:
    """Sign-pack a [B, dim] f32 batch into [B, row_bytes] uint8 rows
    (bit i of byte i//8 set iff value > 0 — encoded_vectors_binary.rs:199-207)."""
    bits = (np.asarray(data) > 0.0).astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")
    if packed.shape[1] < row_bytes:
        packed = np.pad(packed, ((0, 0), (0, row_bytes - packed.shape[1])))
    return packed


def rows_to_planes(rows: np.ndarray) -> np.ndarray:
    """[N, B] packed bytes -> bit-plane uint32[W, N] device layout."""
    n, b = rows.shape
    pad = (-b) % 4
    if pad:
        rows = np.pad(rows, ((0, 0), (0, pad)))
    rows = np.ascontiguousarray(rows)
    words = rows.reshape(n, -1, 4).view(np.uint32).reshape(n, -1)  # LE combine
    return np.ascontiguousarray(words.T)


def planes_to_rows(planes: np.ndarray, row_bytes: int) -> np.ndarray:
    """Invert rows_to_planes back to [N, row_bytes] uint8 rows."""
    words = np.ascontiguousarray(planes.T)  # [N, W] uint32
    rows = words.view(np.uint8).reshape(words.shape[0], -1)
    return rows[:, :row_bytes]


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> an int32 tensor holding the same bits on ``device``."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    if not arr.flags.writeable:  # e.g. a JAX buffer: never alias it
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """The inverse of ``words_to_tensor``: uint32 words on the host."""
    return t.cpu().numpy().view(np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int64 (SWAR on
    int64, so no step overflows or shifts a sign bit in)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def metric_from_xor(
    xor: torch.Tensor, *, distance_type: DistanceType, invert: bool, dim: int
) -> torch.Tensor:
    """Map XOR counts to the score contract
    (truth table at encoded_vectors_binary.rs:221-252)."""
    x = xor.to(torch.float32)
    d = float(dim)
    if distance_type == DistanceType.DOT:
        return x + x - d if invert else d - x - x
    return d - x - x if invert else x + x - d


def xor_counts(qwords: torch.Tensor, planes: torch.Tensor, tile: int = 65536):
    """[Q, N] int64 XOR counts of qwords [Q, W] against planes [W, N], one
    plane word at a time over N tiles, so peak memory is a few [Q, tile]."""
    q = qwords.shape[0]
    w, n = planes.shape
    out = torch.zeros((q, n), dtype=torch.int64, device=planes.device)
    for n0 in range(0, n, tile):
        acc = out[:, n0 : n0 + tile]
        for wi in range(min(w, qwords.shape[1])):
            acc += popcount32(qwords[:, wi, None] ^ planes[None, wi, n0 : n0 + tile])
    return out


def score_batch(
    qwords: torch.Tensor,
    planes: torch.Tensor,
    *,
    distance_type: DistanceType,
    invert: bool,
    dim: int,
) -> torch.Tensor:
    """[Q, N] binary scores (plain XOR + popcount); the plain version of the
    K6 kernel. ``qwords`` int32 [Q, W]; ``planes`` int32 [W, N]."""
    return metric_from_xor(
        xor_counts(qwords, planes),
        distance_type=distance_type, invert=invert, dim=dim,
    )


def unpack_bits(planes: torch.Tensor) -> torch.Tensor:
    """int32 planes [W, n] -> int8 0/1 [W*32, n]: row 32w + j is bit j of
    word w, LSB first (``_unpack_bits`` of the JAX kernels). The shift is
    arithmetic, but ``& 1`` keeps only the bit shifted down."""
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = (planes[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(-1, planes.shape[1]).to(torch.int8)


def score_affine(
    qs: torch.Tensor,  # int8 [Q, W*32] quantized query values, 0 on pad dims
    mult,  # f32 scalar or per-query [Q] / [Q, 1]
    qb: torch.Tensor,  # f32 [Q, 1] per-query bias
    planes: torch.Tensor,  # int32 [W, N]
    *,
    tile: int = 1 << 15,
) -> torch.Tensor:
    """[Q, N] affine bit scores ``mult * (qs . bits) + qb`` (the residual-BQ
    asymmetric query against the unpacked 0/1 corpus bits); the plain version
    of the residual kernels (K5b, value-query K5a / K10). Twin of
    ``score_affine_xla``, tiled over N as it is: a [W*32, tile] int8 unpack
    per step, never the [W*32, N] one."""
    n = planes.shape[1]
    out = torch.empty((qs.shape[0], n), dtype=torch.float32, device=planes.device)
    for n0 in range(0, n, tile):
        acc = int_dot(qs, unpack_bits(planes[:, n0 : n0 + tile]).T)
        out[:, n0 : n0 + tile] = affine_once(mult, acc, qb)
    return out


def score_candidates(
    qwords: torch.Tensor,  # int32 [Q, W]
    planes: torch.Tensor,  # int32 [W, N]
    cand: torch.Tensor,  # int [Q, R]
    *,
    distance_type: DistanceType,
    invert: bool,
    dim: int,
) -> torch.Tensor:
    """[Q, R] binary scores against per-query candidate lists. An id < 0
    indexes from the end, as ``jnp.take`` does in the JAX twin."""
    g = planes[:, cand.to(torch.int64)]  # [W, Q, R]
    x = popcount32(g ^ qwords.T[:, :, None]).sum(dim=0)
    return metric_from_xor(x, distance_type=distance_type, invert=invert, dim=dim)
