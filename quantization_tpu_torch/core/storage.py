"""Flat byte-blob storage seam + two-file (JSON meta, raw blob) checkpoint format.

Twin of ``quantization_tpu/core/storage.py`` (numpy-only copy, pinned to the
original by ``tests/test_torch_core.py``): the equivalent of the reference
storage abstraction
(quantization/src/encoded_storage.rs:7-70): fixed-stride row access, file
save/load with a total-size check, and a push-style builder. Qdrant injects
mmap-backed storages through this seam; we keep the seam and provide both an
in-RAM (numpy) and an mmap (np.memmap) implementation.

On-device layout is the quantizers' concern (SoA device arrays); this layer
owns the host-side bytes and the on-disk format, which is byte-compatible with
the reference where layouts coincide (raw row-major codes, no header; size is
validated against ``row_size * count`` on load, cf. encoded_storage.rs:40-51).
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from .types import StorageIOError


class EncodedStorage:
    """Row-major byte matrix of encoded vectors (count x row_size)."""

    def __init__(self, data: np.ndarray):
        if data.dtype != np.uint8 or data.ndim != 2:
            raise StorageIOError(
                f"EncodedStorage expects a 2-D uint8 array, got "
                f"{data.dtype} with shape {data.shape}"
            )
        self._data = data

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def count(self) -> int:
        return self._data.shape[0]

    @property
    def row_size(self) -> int:
        return self._data.shape[1]

    def get_vector_data(self, index: int) -> np.ndarray:
        """Row access (reference EncodedStorage::get_vector_data,
        encoded_storage.rs:8)."""
        return self._data[index]

    @classmethod
    def from_file(
        cls, path: Union[str, os.PathLike], row_size: int, count: int,
        mmap: bool = False,
    ) -> "EncodedStorage":
        """Load a raw blob, validating its exact size (encoded_storage.rs:40-51)."""
        expected = row_size * count
        try:
            actual = os.path.getsize(path)
        except OSError as e:
            raise StorageIOError(f"cannot stat {path}: {e}") from e
        if actual != expected:
            raise StorageIOError(
                f"storage file {path} has size {actual}, expected "
                f"{expected} ({count} rows x {row_size} bytes)"
            )
        if count == 0:
            return cls(np.zeros((0, max(row_size, 0)), dtype=np.uint8))
        try:
            if mmap:
                arr = np.memmap(path, dtype=np.uint8, mode="r", shape=(count, row_size))
                arr = np.asarray(arr)  # keep a read-only ndarray view semantics
            else:
                arr = np.fromfile(path, dtype=np.uint8).reshape(count, row_size)
        except OSError as e:
            raise StorageIOError(f"cannot read {path}: {e}") from e
        return cls(arr)

    def save_to_file(self, path: Union[str, os.PathLike]) -> None:
        parent = os.path.dirname(os.fspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            with open(path, "wb") as f:
                f.write(np.ascontiguousarray(self._data).tobytes())
        except OSError as e:
            raise StorageIOError(f"cannot write {path}: {e}") from e


class EncodedStorageBuilder:
    """Append-only builder (reference EncodedStorageBuilder,
    encoded_storage.rs:21-25).

    The reference pushes one vector at a time from a thread ring; on TPU we
    encode whole device batches, so ``push_batch`` is the primary API and
    ``push_vector_data`` the per-row compatibility shim.
    """

    def __init__(self, row_size: int):
        self._row_size = int(row_size)
        self._chunks: list[np.ndarray] = []
        self._count = 0

    def push_vector_data(self, row: Union[bytes, np.ndarray]) -> None:
        arr = np.frombuffer(bytes(row), dtype=np.uint8).reshape(1, -1)
        self.push_batch(arr)

    def push_batch(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.uint8)
        if rows.ndim != 2 or rows.shape[1] != self._row_size:
            raise StorageIOError(
                f"builder expects rows of {self._row_size} bytes, got {rows.shape}"
            )
        self._chunks.append(rows)
        self._count += rows.shape[0]

    def build(self) -> EncodedStorage:
        if not self._chunks:
            return EncodedStorage(np.zeros((0, self._row_size), dtype=np.uint8))
        return EncodedStorage(np.concatenate(self._chunks, axis=0))
