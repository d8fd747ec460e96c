"""The port's native host helpers (``quantization_tpu_torch/native``), built
with g++ on the CPU, against the JAX package: the five cases of
tests/test_native.py.

The native SQ codes are held to the JAX package's device encoder
(``ScalarQuantizerU8.encode``): they may differ by one at exact
quantization boundaries, where its reciprocal multiply and the native IEEE
division round apart (ROADMAP F7), on under 1 % of the entries; offsets
within a float sum's tolerance. ``pack_bits`` is byte-equal to the JAX
package's ``ops.bq.pack_rows``; ``cpu_scan_dot_u8`` equals the JAX
package's ``score_batch`` within f32 rounding. The JAX package's own native
loader is never called."""

import os

import numpy as np
import pytest
import torch

import quantization_tpu as jqt
from quantization_tpu.ops import bq as j_bq_ops
import quantization_tpu_torch as qt
from quantization_tpu_torch.native import loader

torch.set_num_threads(1)


@pytest.mark.parametrize("dt", ["DOT", "L1", "L2"])
def test_native_quantize_matches_device(rng, dt):
    n, dim = 257, 65
    data = rng.random((n, dim), dtype=np.float32) * 3 - 1
    dev = jqt.ScalarQuantizerU8.encode(
        data, jqt.VectorParameters(dim, n, getattr(jqt.DistanceType, dt), False))
    nat = qt.ScalarQuantizerU8.encode(
        data, qt.VectorParameters(dim, n, getattr(qt.DistanceType, dt), False),
        use_native=True, device="cpu")
    want = np.asarray(dev.codes, np.int32)
    got = nat.codes.numpy().astype(np.int32)[: want.shape[0], : want.shape[1]]
    diff = np.abs(want - got)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01
    np.testing.assert_allclose(np.asarray(dev.voffsets)[:n], nat.voffsets.numpy()[:n],
                               rtol=1e-5, atol=1e-2)


def test_native_pack_bits_matches_numpy(rng):
    n, dim = 100, 197
    data = rng.standard_normal((n, dim)).astype(np.float32)
    row_bytes = j_bq_ops.storage_bytes(dim)
    np.testing.assert_array_equal(loader.pack_bits(data, row_bytes),
                                  j_bq_ops.pack_rows(data, row_bytes))


def test_native_min_max(rng):
    data = rng.standard_normal((50, 20)).astype(np.float32)
    mn, mx = loader.min_max(data)
    assert mn == data.min() and mx == data.max()


def test_native_cpu_scan_matches_device(rng):
    n, dim = 300, 64
    data = rng.random((n, dim), dtype=np.float32)
    q = rng.random((dim,), dtype=np.float32)
    enc = jqt.ScalarQuantizerU8.encode(data, jqt.VectorParameters(dim, n, jqt.DistanceType.DOT,
                                                                  False))
    eq = enc.encode_query(q)
    want = np.asarray(enc.score_batch(eq))[0]
    got = loader.cpu_scan_dot_u8(
        np.asarray(eq.codes)[0].view(np.uint8),
        np.asarray(enc.codes[: enc.count]).view(np.uint8),
        enc.metadata.multiplier,
        float(np.asarray(eq.offsets)[0]),
        np.asarray(enc.voffsets[: enc.count]),
    )
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)

    f32 = loader.cpu_scan_dot_f32(q, data)
    np.testing.assert_allclose(f32, data @ q, rtol=1e-5, atol=1e-4)


def test_native_xor_popcount(rng):
    a = rng.integers(0, 256, 37, dtype=np.uint8)
    b = rng.integers(0, 256, 37, dtype=np.uint8)
    want = int(np.unpackbits(np.bitwise_xor(a, b)).sum())
    assert loader.xor_popcount(a, b) == want


@pytest.mark.parametrize("store_type", ["u8", "u128"])
@pytest.mark.parametrize("threads", [1, 3])
def test_native_bq_encode_equals_the_jax_planes(rng, store_type, threads):
    n, dim = 300, 70
    data = rng.standard_normal((n, dim)).astype(np.float32)
    want = jqt.BinaryQuantizer.encode(
        data, jqt.VectorParameters(dim, n, jqt.DistanceType.DOT, False), store_type=store_type)
    got = qt.BinaryQuantizer.encode(
        data, qt.VectorParameters(dim, n, qt.DistanceType.DOT, False), batch_size=64,
        store_type=store_type, use_native=True, max_threads=threads, device="cpu")
    w = np.asarray(want.planes)
    np.testing.assert_array_equal(got.planes.numpy().view(np.uint32)[: w.shape[0], : w.shape[1]],
                                  w)


def test_library_builds_in_the_ports_own_directory():
    """Built from the port's copy of the source into its build directory,
    never beside the JAX package's source; the copy's code is the JAX
    package's, line for line (its comments aside)."""
    path = loader.library_path()
    loader.get_lib()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(os.path.dirname(qt.__file__), "_build")
    jsrc = os.path.join(os.path.dirname(jqt.__file__), "native", "qtpu_native.cpp")

    def body(p):
        with open(p) as f:
            lines = (line.split("//", 1)[0].rstrip() for line in f)
            return [line for line in lines if line]

    assert body(loader.SRC) == body(jsrc)
