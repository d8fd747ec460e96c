"""quantization_tpu_torch — the PyTorch + CUDA port of quantization_tpu.

Two slices so far. SQ-u8: calibrate, encode corpus and queries into int8
codes with per-row f32 corrections, and search them. BQ and two-stage
retrieval: sign-bit planes scored by XOR + popcount, whose oversampled
candidates are rescored by SQ-u8 or by the f32 vectors (``TwoStageIndex``).
Every kernel is hand-written for Hopper (``csrc/``); CPU tensors take their
plain PyTorch versions. Entry points place data on the CUDA card unless the
caller names another device. The JAX package ``quantization_tpu`` stays the
reference; this package never imports JAX.
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
from .interop import bq_from_numpy, bq_to_numpy, sq_from_numpy, sq_to_numpy
from .models.bq import BinaryQuantizer, EncodedQueryBin, EncodedVectorsBin
from .models.pipeline import ExactRescorer, TwoStageIndex
from .models.sq import EncodedQueryU8, EncodedVectorsU8, ScalarQuantizerU8
from .ops.dispatch import NoDeviceError

__all__ = [
    "ArgumentsError",
    "BinaryQuantizer",
    "DistanceType",
    "EncodedQueryBin",
    "EncodedQueryU8",
    "EncodedStorage",
    "EncodedStorageBuilder",
    "EncodedVectors",
    "EncodedVectorsBin",
    "EncodedVectorsU8",
    "EncodingError",
    "ExactRescorer",
    "NoDeviceError",
    "QuantizationError",
    "ScalarQuantizerU8",
    "StoppedError",
    "StorageIOError",
    "TwoStageIndex",
    "VectorParameters",
    "bq_from_numpy",
    "bq_to_numpy",
    "distance",
    "pairwise",
    "pairwise_score",
    "score",
    "sq_from_numpy",
    "sq_to_numpy",
    "validate_vector_parameters",
]

__version__ = "0.1.0"
