"""Core contracts: distance types, vector parameters, and error taxonomy.

Twin of ``quantization_tpu/core/types.py``, kept as a numpy-only copy so the
PyTorch port never imports the JAX package (whose ``__init__`` loads JAX);
``tests/test_torch_core.py`` pins the two copies to each other.

(reference: quantization/src/encoded_vectors.rs:6-19, quantization/src/lib.rs:18-24).
The JSON wire format of ``DistanceType`` ("Dot" / "L1" / "L2") and
``VectorParameters`` ({dim, count, distance_type, invert}) matches the
reference's serde output so metadata files are drop-in compatible.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict


class DistanceType(enum.Enum):
    """Distance/similarity used for scoring.

    Matches reference ``DistanceType`` (encoded_vectors.rs:6-11). Scores follow
    the reference contract: the returned score *is* the (approximate) distance
    or similarity value, negated when ``invert`` is set, so that callers can
    always rank "bigger is better" by choosing ``invert`` appropriately.
    """

    DOT = "Dot"
    L1 = "L1"
    L2 = "L2"

    def to_json(self) -> str:
        return self.value

    @classmethod
    def from_json(cls, value: str) -> "DistanceType":
        for member in cls:
            if member.value == value:
                return member
        # Accept lowercase aliases for ergonomic Python callers.
        lowered = str(value).lower()
        aliases = {"dot": cls.DOT, "l1": cls.L1, "l2": cls.L2, "euclid": cls.L2,
                   "cosine": cls.DOT}
        if lowered in aliases:
            return aliases[lowered]
        raise ArgumentsError(f"Unknown distance type: {value!r}")


@dataclass(frozen=True)
class VectorParameters:
    """Parameters of the original (unquantized) vector data.

    Matches reference ``VectorParameters`` (encoded_vectors.rs:13-19).

    ``invert`` flips the sign of every score so that "higher is better" holds
    regardless of whether the caller ranks by similarity (dot) or by distance
    (l1/l2).
    """

    dim: int
    count: int
    distance_type: DistanceType
    invert: bool = False

    def __post_init__(self) -> None:
        if self.dim < 0 or self.count < 0:
            raise ArgumentsError(
                f"dim and count must be non-negative, got dim={self.dim}, "
                f"count={self.count}"
            )
        if not isinstance(self.distance_type, DistanceType):
            object.__setattr__(
                self, "distance_type", DistanceType.from_json(self.distance_type)
            )

    def to_json(self) -> Dict[str, Any]:
        return {
            "dim": self.dim,
            "count": self.count,
            "distance_type": self.distance_type.to_json(),
            "invert": self.invert,
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "VectorParameters":
        return cls(
            dim=int(obj["dim"]),
            count=int(obj["count"]),
            distance_type=DistanceType.from_json(obj["distance_type"]),
            invert=bool(obj["invert"]),
        )


class QuantizationError(Exception):
    """Base class for all errors raised by this library.

    Mirrors reference ``EncodingError`` (lib.rs:18-24) as an exception
    hierarchy instead of a result enum.
    """


class EncodingError(QuantizationError):
    """Encoding failed (reference: EncodingError::EncodingError)."""


class ArgumentsError(QuantizationError):
    """Invalid arguments (reference: EncodingError::ArgumentsError)."""


class StorageIOError(QuantizationError):
    """I/O failure while reading/writing code blobs or metadata
    (reference: EncodingError::IOError)."""


class StoppedError(QuantizationError):
    """Cooperative cancellation: the caller's stop condition fired mid-encode
    (reference: EncodingError::Stopped; checks at encoded_vectors_u8.rs:74,
    encoded_vectors_pq.rs:198,303, kmeans.rs:29)."""


def check_stop(stop_condition) -> None:
    """Raise StoppedError if the caller's cancellation flag is set.

    Called between device steps in every chunked host-side loop — the
    TPU-native equivalent of the reference's per-vector ``stop_condition()``
    checks (encode loops batch thousands of vectors per device step, so the
    check granularity is one batch instead of one vector).
    """
    if stop_condition is not None and stop_condition():
        raise StoppedError("encoding stopped by stop_condition")
