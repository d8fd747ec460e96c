"""Device-resident growable store for streaming ingestion.

Twin of ``quantization_tpu/utils/device_store.py`` (``DeviceAppender`` only).
The encode loop streams host batches up and keeps codes on the device; the
output is preallocated once and every batch is written into its rows in
place, so peak device memory is the padded corpus, not 2x (list + concat).
PyTorch runs eagerly and allocates when asked, so no periodic host sync is
needed to bound outstanding work.
"""

from __future__ import annotations

import torch


class DeviceAppender:
    """Append chunks along axis 0 of a preallocated zero-filled buffer."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self._buf = torch.zeros(shape, dtype=dtype, device=device)
        self._pos = 0
        self._cap = shape[0]

    @property
    def pos(self) -> int:
        return self._pos

    def append(self, chunk: torch.Tensor) -> None:
        b = chunk.shape[0]
        if self._pos + b > self._cap:
            raise ValueError(
                f"DeviceAppender overflow: {self._pos}+{b} > {self._cap}"
            )
        self._buf[self._pos : self._pos + b] = chunk
        self._pos += b

    def finish(self) -> torch.Tensor:
        """The full buffer (rows past ``pos`` keep the zero fill)."""
        buf = self._buf
        self._buf = None  # guard reuse
        return buf
