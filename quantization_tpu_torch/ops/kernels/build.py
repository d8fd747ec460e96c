"""Build and load the hand-written CUDA kernels (``quantization_tpu_torch/csrc``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edit
rebuilds it and an unchanged tree reuses it. As in
``quantization_tpu/native/loader.py``, the compiler writes a temporary file
that ``os.replace`` moves into place, so concurrent first uses never load a
half-written library.

There is no fallback: a missing ``nvcc`` or a failed build raises, with the
compiler's output in the message. Only CPU tensors take the plain PyTorch
versions, and that choice is made by the caller from the tensor's device.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No FMA contraction: the kernels' epilogue must round like the plain
    # PyTorch version, which multiplies and adds in separate steps.
    "-fmad=false",
    # Registers, shared memory and spills of every kernel, for the build log.
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: What the last build reported: {"seconds", "log", "path"}; None when the
#: library was already built.
BUILD_INFO: Optional[dict] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, the build failed, or the library does not load."""


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then DEFAULT_CUDA_HOME."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        f"nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels cannot be built"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libqtpu_torch_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global BUILD_INFO
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    BUILD_INFO = {
        "seconds": time.perf_counter() - t0,
        "log": proc.stdout + proc.stderr,
        "path": path,
    }


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # (qcodes, qoff, mult, codes, voff, ..., stream): pointers as c_void_p,
    # never the default int, which would cut a 64-bit address.
    lib.qtt_sq_scores.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.qtt_sq_search_exact.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.qtt_sq_search_approx.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.qtt_sq_scores, lib.qtt_sq_search_exact, lib.qtt_sq_search_approx):
        fn.restype = ctypes.c_int
    lib.qtt_error_string.argtypes = [i]
    lib.qtt_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call. Raises KernelBuildError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _bind(lib)
        _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib.qtt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
