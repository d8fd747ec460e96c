"""quantization_tpu_torch — the PyTorch + CUDA port of quantization_tpu.

The SQ-u8 slice: calibrate, encode corpus and queries into int8 codes with
per-row f32 corrections, and search them with hand-written Hopper kernels
(``csrc/``) — or, for CPU tensors, their plain PyTorch versions. The JAX
package ``quantization_tpu`` stays the reference; this package never imports
JAX.
"""

from .core.distances import distance, pairwise, pairwise_score, score
from .core.interface import EncodedVectors, validate_vector_parameters
from .core.storage import EncodedStorage, EncodedStorageBuilder
from .core.types import (
    ArgumentsError,
    DistanceType,
    EncodingError,
    QuantizationError,
    StoppedError,
    StorageIOError,
    VectorParameters,
)
from .interop import sq_from_numpy, sq_to_numpy
from .models.sq import EncodedQueryU8, EncodedVectorsU8, ScalarQuantizerU8

__all__ = [
    "ArgumentsError",
    "DistanceType",
    "EncodedQueryU8",
    "EncodedStorage",
    "EncodedStorageBuilder",
    "EncodedVectors",
    "EncodedVectorsU8",
    "EncodingError",
    "QuantizationError",
    "ScalarQuantizerU8",
    "StoppedError",
    "StorageIOError",
    "VectorParameters",
    "distance",
    "pairwise",
    "pairwise_score",
    "score",
    "sq_from_numpy",
    "sq_to_numpy",
    "validate_vector_parameters",
]

__version__ = "0.1.0"
