"""The port imports without JAX, Triton or nvcc, and its kernel build never
falls back: a missing or failing nvcc raises."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import quantization_tpu_torch
from quantization_tpu_torch.ops.kernels import build, sq_kernel

torch.set_num_threads(1)

PKG = pathlib.Path(quantization_tpu_torch.__file__).parent
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py")
)


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'triton', 'quantization_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PKG.parent)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|quantization_tpu)\b", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_imports_jax(path):
    assert not IMPORTS_JAX.search(path.read_text())


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The build module with no library loaded and an empty build directory."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    (tmp_path / "bin").mkdir()
    return tmp_path


def test_build_without_nvcc_raises(fresh_build):
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load_library()
    assert build._lib is None


def test_failed_build_raises_with_compiler_output(fresh_build):
    nvcc = fresh_build / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'sq_kernels.cu(1): error: broken' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    with pytest.raises(build.KernelBuildError, match="error: broken"):
        build.load_library()
    assert not any((fresh_build / "build").iterdir())  # no half-written library


def test_library_path_tracks_sources_and_flags(monkeypatch):
    path = build.library_path()
    assert path == build.library_path()
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DX"])
    assert build.library_path() != path
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "-fmad=false" in build.NVCC_FLAGS


def test_launch_error_raises():
    class FakeLib:
        def qtt_error_string(self, err):
            return b"too many resources requested for launch"

    build.check(FakeLib(), 0, "ok")
    with pytest.raises(RuntimeError, match="too many resources"):
        build.check(FakeLib(), 701, "sq_scores")


def test_cpu_tensors_never_touch_the_library(monkeypatch, rng):
    def refuse():
        raise AssertionError("CPU tensors must not build or load the kernels")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(sq_kernel, "load_library", refuse)
    data = rng.random((700, 40), dtype=np.float32)
    params = quantization_tpu_torch.VectorParameters(
        40, 700, quantization_tpu_torch.DistanceType.L2, True)
    enc = quantization_tpu_torch.ScalarQuantizerU8.encode(data, params)
    eq = enc.encode_query(data[:3])
    enc.score_batch(eq)
    for method in ("exact", "approx"):
        s, i = enc.top_k(eq, 4, method=method)
        assert (i[:, 0] == np.arange(3)).all()
