"""Kernel-path dispatch: hand-written CUDA kernels for CUDA tensors, the
plain PyTorch versions for CPU tensors.

Twin of ``quantization_tpu/ops/dispatch.py``. The route depends on where
the tensor lies and on nothing else: no environment variable changes it.
"""

from __future__ import annotations

import torch


def use_kernels(t: torch.Tensor) -> bool:
    return t.is_cuda
