"""Build and load the hand-written CUDA kernels (``quantization_tpu_torch/csrc``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per ``.cu`` file, all started together, and linked into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``. The
library's file name carries a hash of the sources, the shared headers
(``*.cuh``) and the flags, so an edit rebuilds it and an unchanged tree
reuses it. As in
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
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


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
    for src in sources() + headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libqtpu_torch_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all. [(cmd, CompletedProcess)]."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True))
        for cmd in cmds
    ]
    done = []
    for cmd, p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        done.append((cmd, subprocess.CompletedProcess(cmd, p.returncode, out, err)))
    return done


def _check_done(done: list) -> str:
    log = ""
    for cmd, proc in done:
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log += proc.stdout + proc.stderr
    return log


def _build(path: str) -> None:
    global BUILD_INFO
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    # Objects go to a private directory that is removed whatever happens, so
    # a failed build leaves nothing behind in BUILD_DIR.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [
            os.path.join(objdir, os.path.basename(src) + ".o") for src in srcs
        ]
        log = _check_done(_run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)
        ]))
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            log += _check_done(_run_all([
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", tmp, *objs]
            ]))
        except KernelBuildError:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    os.replace(tmp, path)
    BUILD_INFO = {
        "seconds": time.perf_counter() - t0,
        "log": log,
        "path": path,
    }


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # Pointers as c_void_p, never the default int, which would cut a 64-bit
    # address; npad of the BQ planes as a 64-bit int.
    # The scan map of the searches (ktile.cuh ScanMap): sel, tile_n, corr,
    # corr_qs, corr_bs.
    scan = [p, i, p, ll, ll]
    sigs = {
        # (qcodes, qoff, mult, codes, voff, ..., mstride, [scan,] stream)
        "qtt_sq_scores": [p, p, p, p, p, p, i, i, i, i, p],
        "qtt_sq_scores_l1": [p, p, p, p, p, p, i, i, i, i, p],
        "qtt_sq_search_exact": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, *scan, p],
        "qtt_sq_search_approx": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, *scan, p],
        # (qcodes, qoff, mult, codes, voff, cand, out, Q, R, n_valid, D, l1,
        #  mstride, stream)
        "qtt_sq_rescore": [p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        # (qwords, planes, ..., Q, W8, wt, npad, n_valid, dim, sign, ...,
        #  [sel, tile_n, ncomp,] stream)
        "qtt_bq_scores": [p, p, p, i, i, ll, i, i, i, p],
        "qtt_bq_search_exact": [p, p, p, p, i, i, ll, i, i, i, i, i, p],
        "qtt_bq_search_approx": [p, p, p, p, p, p, i, i, ll, i, i, i, i, i, p, i, ll, i, p],
        # (Q, W8): the sign-query approx route's query tile, 0 past its fit
        "qtt_bq_sign_approx_ws_tq": [i, i],
        # (qs, qb, mult, planes, rowadd, outputs..., Q, W8, npad, ncomp, n_valid,
        #  ..., mstride, scan, stream): the residual forms
        "qtt_bq_search_exact_res": [p, p, p, p, p, p, p, i, i, ll, i, i, i, i, i, *scan, p],
        "qtt_bq_search_approx_res": [p, p, p, p, p, p, p, p, p, i, i, ll, i, i, i, i, i,
                                     *scan, p],
        # (lut, scale, bias, codes_t, outputs..., Q, mpad, npad, n_valid, kc,
        #  kind, [kk,] [rowadd, corr, corr_qs, corr_bs,] [sel, tile_n, ncomp,
        #  part,] stream)
        "qtt_pq_scores": [p, p, p, p, p, i, i, ll, i, i, i, p],
        "qtt_pq_search_exact": [p, p, p, p, p, p, i, i, ll, i, i, i, i, p, p, ll, ll, p],
        "qtt_pq_search_approx": [p, p, p, p, p, p, i, i, ll, i, i, i, p, p, ll, ll,
                                 p, i, ll, i, p],
        # The one-hot route (4-bit codes, int8 LUT): (lutq, scale, bias,
        # codes_t, [voff,] outputs..., Q, mpad, npad, n_valid, [split, kk |
        # part, sel, tile_n, ncomp,] [corr, corr_qs, corr_bs,] stream)
        "qtt_pq4_mma_scores": [p, p, p, p, p, i, i, ll, i, p],
        "qtt_pq4_mma_search_approx": [p, p, p, p, p, p, p, i, i, ll, i, i, p, i, ll,
                                      p, ll, ll, p],
        "qtt_pq4_mma_search_exact": [p, p, p, p, p, p, p, i, i, ll, i, i, i, p, ll, ll, p],
        # K8 with 4-bit codes and the bf16 LUT: (lut, codes_t, out, Q, mpad,
        # npad, n_valid, stream)
        "qtt_pq4_mma_scores_bf16": [p, p, p, i, i, ll, i, p],
        # The 10M harness's row generator (bench/threefry.py): (ids, n, dim,
        # centers, clusters, spectrum, sigma, base0, base1, out, clusters_out,
        # stream)
        "qtt_rowgen": [p, i, i, p, i, p, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, p, p,
                       p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
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
