"""The port imports without JAX, Triton or nvcc, and its kernel build never
falls back: a missing or failing nvcc raises. Its entry points run on the
CUDA card unless the caller names a device, and raise without one."""

import os
import pathlib
import re
import shutil
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
    enc = quantization_tpu_torch.ScalarQuantizerU8.encode(data, params, device="cpu")
    eq = enc.encode_query(data[:3])
    enc.score_batch(eq)
    for method in ("exact", "approx"):
        s, i = enc.top_k(eq, 4, method=method)
        assert (i[:, 0] == np.arange(3)).all()


def test_library_path_tracks_headers(tmp_path, monkeypatch):
    """An edit to a shared csrc header rebuilds the library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    assert [pathlib.Path(h).name for h in build.headers()] == ["ktile.cuh", "pq_kernels.cuh"]
    path = build.library_path()
    header = csrc / "ktile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path() != path


def test_build_compiles_each_source_in_its_own_nvcc(fresh_build, monkeypatch):
    """One nvcc per .cu file, then one link; the objects never land in the
    build directory."""
    log = fresh_build / "nvcc.log"
    nvcc = fresh_build / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && : > \"$2\"; shift; done\n"
    )
    nvcc.chmod(0o755)
    started = []
    real_popen = build.subprocess.Popen

    def popen(cmd, **kw):
        started.append(cmd)
        return real_popen(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", popen)
    with pytest.raises(build.KernelBuildError, match="cannot load"):
        build.load_library()  # the fake library is empty
    lines = log.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    assert sorted(ln.split()[-1] for ln in compiles) == build.sources()
    assert len(lines) == len(compiles) + 1 and "-shared" in lines[-1]
    assert len(started) == len(build.sources()) + 1
    assert [p.suffix for p in (fresh_build / "build").iterdir()] == [".so"]


def test_entry_points_need_a_device_without_cuda(monkeypatch, rng, tmp_path):
    """Without a card, a call that names no device raises; it never runs on
    the CPU quietly."""
    qt = quantization_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = rng.random((50, 16), dtype=np.float32)
    params = qt.VectorParameters(16, 50, qt.DistanceType.DOT, False)
    sq = qt.ScalarQuantizerU8.encode(data, params, device="cpu")
    bq = qt.BinaryQuantizer.encode(data, params, device="cpu")
    sq.save(tmp_path / "sq.bin", tmp_path / "sq.json")
    bq.save(tmp_path / "bq.bin", tmp_path / "bq.json")
    calls = [
        lambda: qt.ScalarQuantizerU8.encode(data, params),
        lambda: qt.ScalarQuantizerU8.load(tmp_path / "sq.bin", tmp_path / "sq.json", params),
        lambda: qt.sq_from_numpy(*qt.sq_to_numpy(sq)),
        lambda: qt.BinaryQuantizer.encode(data, params),
        lambda: qt.BinaryQuantizer.load(tmp_path / "bq.bin", tmp_path / "bq.json", params),
        lambda: qt.bq_from_numpy(*qt.bq_to_numpy(bq)),
        lambda: qt.ExactRescorer(data, qt.DistanceType.DOT, False),
    ]
    for call in calls:
        with pytest.raises(qt.NoDeviceError, match="device='cpu'"):
            call()
    assert qt.BinaryQuantizer.load(tmp_path / "bq.bin", tmp_path / "bq.json", params,
                                   device="cpu").device == torch.device("cpu")


def test_pq_cpu_tensors_never_touch_the_library(monkeypatch, rng):
    from quantization_tpu_torch.ops.kernels import pq_kernel

    def refuse():
        raise AssertionError("CPU tensors must not build or load the kernels")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(pq_kernel, "load_library", refuse)
    data = rng.standard_normal((700, 16)).astype(np.float32)
    params = quantization_tpu_torch.VectorParameters(
        16, 700, quantization_tpu_torch.DistanceType.L2, True)
    for bits in (8, 4):
        enc = quantization_tpu_torch.ProductQuantizer.encode(
            data, params, chunk_size=4, bits=bits, device="cpu")
        eq = enc.encode_query(data[:3])
        enc.score_batch(eq)
        for method in ("exact", "approx"):
            _, i = enc.top_k(eq, 4, method=method)
            assert (i[:, 0] == np.arange(3)).all()


def test_pq_entry_points_need_a_device_without_cuda(monkeypatch, rng, tmp_path):
    qt = quantization_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = rng.random((50, 16), dtype=np.float32)
    params = qt.VectorParameters(16, 50, qt.DistanceType.DOT, False)
    pq = qt.ProductQuantizer.encode(data, params, chunk_size=4, device="cpu")
    pq.save(tmp_path / "pq.bin", tmp_path / "pq.json")
    calls = [
        lambda: qt.ProductQuantizer.encode(data, params, chunk_size=4),
        lambda: qt.ProductQuantizer.load(tmp_path / "pq.bin", tmp_path / "pq.json", params),
        lambda: qt.pq_from_numpy(*qt.pq_to_numpy(pq)),
    ]
    for call in calls:
        with pytest.raises(qt.NoDeviceError, match="device='cpu'"):
            call()
    assert qt.ProductQuantizer.load(tmp_path / "pq.bin", tmp_path / "pq.json", params,
                                    device="cpu").device == torch.device("cpu")
