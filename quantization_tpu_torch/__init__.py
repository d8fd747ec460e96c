"""quantization_tpu_torch — the PyTorch + CUDA port of quantization_tpu.

Six slices so far. SQ-u8: calibrate, encode corpus and queries into int8
codes with per-row f32 corrections, and search them. BQ and two-stage
retrieval: sign-bit planes scored by XOR + popcount, whose oversampled
candidates are rescored by SQ-u8 or by the f32 vectors (``TwoStageIndex``).
PQ: batched k-means per chunk (8-bit and 4-bit codes, optionally behind an
OPQ rotation), queries as lookup tables, fused LUT scoring and search.
IVF: an inverted-file index over any of them (``IVFIndex``), probing a
batch union of buckets and scanning it in place or gathered, with residual
SQ, PQ and BQ (value queries against residual sign bits). Serving:
``recommend`` calibrates a ``ServingPlan`` against the exact f32 oracle, and
``plan.serve`` runs it in a ``PipelinedSearcher`` that keeps several
searches in flight on the card. The harness: the ann-benchmarks CLI, micro
and CPU baselines (``bench/``), the examples (``examples/``) and the native
host encoders (``encode(use_native=True)``, ``native/``).
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
from .interop import (
    bq_from_numpy,
    bq_to_numpy,
    ivf_from_numpy,
    ivf_to_numpy,
    pq_from_numpy,
    pq_to_numpy,
    sq_from_numpy,
    sq_to_numpy,
)
from .models.bq import BinaryQuantizer, EncodedQueryBin, EncodedVectorsBin
from .models.ivf import IVFIndex, IVFMetadata, auto_geometry
from .models.pipeline import ExactRescorer, TwoStageIndex
from .models.pq import EncodedQueryPQ, EncodedVectorsPQ, PQMetadata, ProductQuantizer
from .models.sq import EncodedQueryU8, EncodedVectorsU8, ScalarQuantizerU8
from .ops.dispatch import NoDeviceError
from .policy import ServingPlan, exact_topk, recall_at_k, recommend
from .serving import PipelinedSearcher

__all__ = [
    "ArgumentsError",
    "BinaryQuantizer",
    "DistanceType",
    "EncodedQueryBin",
    "EncodedQueryPQ",
    "EncodedQueryU8",
    "EncodedStorage",
    "EncodedStorageBuilder",
    "EncodedVectors",
    "EncodedVectorsBin",
    "EncodedVectorsPQ",
    "EncodedVectorsU8",
    "EncodingError",
    "ExactRescorer",
    "IVFIndex",
    "IVFMetadata",
    "NoDeviceError",
    "PQMetadata",
    "PipelinedSearcher",
    "ProductQuantizer",
    "QuantizationError",
    "ScalarQuantizerU8",
    "ServingPlan",
    "StoppedError",
    "StorageIOError",
    "TwoStageIndex",
    "VectorParameters",
    "auto_geometry",
    "bq_from_numpy",
    "bq_to_numpy",
    "ivf_from_numpy",
    "ivf_to_numpy",
    "distance",
    "exact_topk",
    "pairwise",
    "pairwise_score",
    "pq_from_numpy",
    "pq_to_numpy",
    "recall_at_k",
    "recommend",
    "score",
    "sq_from_numpy",
    "sq_to_numpy",
    "validate_vector_parameters",
]

__version__ = "0.1.0"
