"""ctypes loader, with a lazy g++ build, for the native host helpers.

Twin of ``quantization_tpu/native/loader.py`` over the port's own copy of
``qtpu_native.cpp``: the SQ u8 quantizer, the sign-bit packer, the min/max
scan, the XOR popcount and the CPU scan baselines, on numpy arrays.

The library is built at first use with the JAX package's flags into
``quantization_tpu_torch/_build/``; its file name carries a hash of the
compiler, the flags and the source, so an edit rebuilds it. The compiler
writes a temporary file that ``os.replace`` moves into place, so processes
that race to build it (pytest-xdist workers, parallel ingestion jobs) never
load a half-written library.

There is no fallback (ROADMAP F30): where g++ is missing or the build
fails, every entry point raises ``NativeBuildError`` with the compiler's
output, and ``available()`` says False. The JAX package's encoders quietly
ignore ``use_native=True`` then; the port's raise, so a caller always knows
which encoder ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "qtpu_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
# -ffp-contract=off: GCC contracts a*b+c into an FMA by default, which
# diverges from the reference's strict f32 evaluation (rustc does not
# contract); the quantizer must match it bit for bit.
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The native library cannot be built or loaded (no g++, a failed
    build, or another ABI version)."""


def library_path() -> str:
    h = hashlib.sha256(" ".join([CXX] + CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libqtpu_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX] + CXX_FLAGS + [SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> None:
    i64, f32 = ctypes.c_int64, ctypes.c_float
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    lib.qtpu_quantize_u8.argtypes = [
        f32p, i64, i64, i64, f32, f32, ctypes.c_uint8, ctypes.c_int, ctypes.c_int, u8p, f32p,
    ]
    lib.qtpu_quantize_u8.restype = None
    lib.qtpu_pack_bits.argtypes = [f32p, i64, i64, i64, u8p]
    lib.qtpu_pack_bits.restype = None
    lib.qtpu_min_max.argtypes = [f32p, i64, f32p, f32p]
    lib.qtpu_min_max.restype = None
    lib.qtpu_xor_popcount.argtypes = [u8p, u8p, i64]
    lib.qtpu_xor_popcount.restype = ctypes.c_uint64
    for name in ("qtpu_cpu_scan_dot_u8", "qtpu_cpu_scan_l1_u8"):
        getattr(lib, name).argtypes = [u8p, u8p, i64, i64, f32, f32, f32p, f32p]
        getattr(lib, name).restype = None
    lib.qtpu_cpu_scan_hamming.argtypes = [u8p, u8p, i64, i64, f32, f32, f32p]
    lib.qtpu_cpu_scan_hamming.restype = None
    lib.qtpu_cpu_scan_dot_f32.argtypes = [f32p, f32p, i64, i64, f32p]
    lib.qtpu_cpu_scan_dot_f32.restype = None
    lib.qtpu_abi_version.argtypes = []
    lib.qtpu_abi_version.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call; raises
    ``NativeBuildError`` (the first failure's message, on every call) when
    it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeBuildError(_error)
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            _declare(lib)
            if lib.qtpu_abi_version() != ABI_VERSION:
                raise NativeBuildError(
                    f"{path} has ABI version {lib.qtpu_abi_version()}, not {ABI_VERSION}"
                )
        except NativeBuildError as e:
            _error = str(e)
            raise
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except NativeBuildError:
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _rows(a, dtype, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2:
        raise ValueError(f"{what} must be 2-D, got shape {a.shape}")
    return a


def quantize_u8(data, dpad: int, alpha: float, offset: float, pad_code: int,
                distance_type_index: int, invert: bool):
    """Native SQ encode of f32 [n, dim] rows: (codes u8 [n, dpad], voff f32
    [n]). ``distance_type_index``: 0 DOT, 1 L1, 2 L2."""
    lib = get_lib()
    data = _rows(data, np.float32, "data")
    n, dim = data.shape
    if dpad < dim:
        raise ValueError(f"dpad {dpad} < dim {dim}")
    codes = np.empty((n, dpad), dtype=np.uint8)
    voff = np.empty((n,), dtype=np.float32)
    lib.qtpu_quantize_u8(
        _f32p(data), n, dim, dpad, alpha, offset, pad_code,
        int(distance_type_index), int(bool(invert)), _u8p(codes), _f32p(voff),
    )
    return codes, voff


def pack_bits(data, row_bytes: int) -> np.ndarray:
    """Sign bits (v > 0) of f32 [n, dim] rows, packed LSB first into u8 [n,
    row_bytes]."""
    lib = get_lib()
    data = _rows(data, np.float32, "data")
    n, dim = data.shape
    if row_bytes * 8 < dim:
        raise ValueError(f"row_bytes {row_bytes} cannot hold {dim} bits")
    rows = np.empty((n, row_bytes), dtype=np.uint8)
    lib.qtpu_pack_bits(_f32p(data), n, dim, row_bytes, _u8p(rows))
    return rows


def min_max(data):
    """(min, max) over every value of ``data``."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float32)
    mn, mx = ctypes.c_float(), ctypes.c_float()
    lib.qtpu_min_max(_f32p(data), data.size, ctypes.byref(mn), ctypes.byref(mx))
    return float(mn.value), float(mx.value)


def cpu_scan_dot_u8(query, codes, multiplier: float, query_offset: float,
                    voffsets) -> np.ndarray:
    """Full-scan SQ DOT scores of one u8 query [dpad] against u8 codes [n,
    dpad] on the CPU (the reference's scalar scoring loop)."""
    lib = get_lib()
    query = np.ascontiguousarray(query, dtype=np.uint8)
    codes = _rows(codes, np.uint8, "codes")
    voffsets = np.ascontiguousarray(voffsets, dtype=np.float32)
    n, dpad = codes.shape
    if query.shape != (dpad,) or voffsets.shape != (n,):
        raise ValueError(f"query {query.shape} / voffsets {voffsets.shape} do not match "
                         f"codes {codes.shape}")
    out = np.empty((n,), dtype=np.float32)
    lib.qtpu_cpu_scan_dot_u8(_u8p(query), _u8p(codes), n, dpad, multiplier, query_offset,
                             _f32p(voffsets), _f32p(out))
    return out


def cpu_scan_dot_f32(query, data) -> np.ndarray:
    """Full-scan f32 dot scores of one query [dim] against [n, dim] rows on
    the CPU (the unquantized baseline)."""
    lib = get_lib()
    query = np.ascontiguousarray(query, dtype=np.float32)
    data = _rows(data, np.float32, "data")
    n, dim = data.shape
    if query.shape != (dim,):
        raise ValueError(f"query {query.shape} does not match data {data.shape}")
    out = np.empty((n,), dtype=np.float32)
    lib.qtpu_cpu_scan_dot_f32(_f32p(query), _f32p(data), n, dim, _f32p(out))
    return out


def xor_popcount(a, b) -> int:
    """Bits that differ between two packed byte rows of one length."""
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    if a.size != b.size:
        raise ValueError(f"rows of {a.size} and {b.size} bytes")
    return int(lib.qtpu_xor_popcount(_u8p(a), _u8p(b), a.size))
