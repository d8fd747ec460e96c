"""Kernel-path dispatch: hand-written CUDA kernels for CUDA tensors, the
plain PyTorch versions for CPU tensors.

Twin of ``quantization_tpu/ops/dispatch.py``. The route depends on where
the tensor lies and on nothing else: no environment variable changes it.
Entry points that place data (``encode``, ``load``, ``*_from_numpy``,
``ExactRescorer``) put it on the CUDA card unless the caller names another
device; without a card such a call raises rather than run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


class NoDeviceError(RuntimeError):
    """No device was given and no CUDA card is present."""


def use_kernels(t: torch.Tensor) -> bool:
    return t.is_cuda


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, which must
    exist. The CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device(DEFAULT_DEVICE)


def upload(array, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a CUDA card it is staged in
    pinned memory and copied without blocking: PyTorch synchronises the
    stream after a copy from pageable memory, which would hold a query batch
    behind every search still in flight (``serving.PipelinedSearcher``)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
