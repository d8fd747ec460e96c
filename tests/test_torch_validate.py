"""The port's parameter guards and encode signatures.

``validate_vector_parameters`` directly and as wired into every encode path
(the reference guards encoders with it under debug_assert!,
encoded_vectors_u8.rs:56, encoded_vectors_pq.rs:64,
encoded_vectors_binary.rs:171): the three cases of tests/test_validate.py
on the port, on the CPU.

The encode signatures: a call written for the JAX package's
``ScalarQuantizerU8.encode`` / ``BinaryQuantizer.encode``, positional or by
keyword, binds its arguments to the same names in the port, whose
``device`` is keyword-only, and runs there with ``use_native=True``. Where
the native library cannot be built, ``use_native=True`` raises (ROADMAP
F30) rather than fall back to the device encoder."""

import inspect

import numpy as np
import pytest
import torch

import quantization_tpu as jqt
import quantization_tpu_torch as qt
from quantization_tpu_torch.core.interface import validate_vector_parameters
from quantization_tpu_torch.native import loader

torch.set_num_threads(1)


def test_validate_direct_array(rng):
    data = rng.random((10, 8), dtype=np.float32)
    validate_vector_parameters(data, qt.VectorParameters(8, 10, qt.DistanceType.DOT, False))
    with pytest.raises(qt.ArgumentsError):
        validate_vector_parameters(data, qt.VectorParameters(9, 10, qt.DistanceType.DOT, False))
    with pytest.raises(qt.ArgumentsError):
        validate_vector_parameters(data, qt.VectorParameters(8, 11, qt.DistanceType.DOT, False))


def test_validate_direct_stream(rng):
    data = rng.random((10, 8), dtype=np.float32)

    def stream():
        yield data[:6]
        yield data[6:]

    validate_vector_parameters(lambda: stream(),
                               qt.VectorParameters(8, 10, qt.DistanceType.DOT, False))
    with pytest.raises(qt.ArgumentsError):
        validate_vector_parameters(lambda: stream(),
                                   qt.VectorParameters(8, 9, qt.DistanceType.DOT, False))


@pytest.mark.parametrize(
    "encode",
    [
        lambda d, p: qt.ScalarQuantizerU8.encode(d, p, device="cpu"),
        lambda d, p: qt.BinaryQuantizer.encode(d, p, device="cpu"),
        lambda d, p: qt.ProductQuantizer.encode(d, p, chunk_size=2, device="cpu"),
    ],
    ids=["sq", "bq", "pq"],
)
def test_encode_rejects_mismatched_params(rng, encode):
    data = rng.random((10, 8), dtype=np.float32)
    with pytest.raises(qt.ArgumentsError):
        encode(data, qt.VectorParameters(9, 10, qt.DistanceType.DOT, False))
    with pytest.raises(qt.ArgumentsError):
        encode(data, qt.VectorParameters(8, 12, qt.DistanceType.DOT, False))


# Calls written for the JAX package: (args after data and params, kwargs).
CALLS = {
    "sq": [((None, None, 65536, 0, True, 4), {}),
           ((), {"use_native": True, "max_threads": 4}),
           ((0.99,), {"batch_size": 32, "use_native": True, "max_threads": 2, "seed": 3})],
    "bq": [((None, 65536, "u128", True, 4), {}),
           ((), {"use_native": True, "max_threads": 4}),
           ((None, 32), {"store_type": "u8", "use_native": True, "max_threads": 2})],
}
CLASSES = {"sq": ("ScalarQuantizerU8", 8), "bq": ("BinaryQuantizer", 7)}


@pytest.mark.parametrize("kind", ["sq", "bq"])
def test_jax_calls_bind_alike(kind):
    """The JAX package's parameters, in its order with its defaults, then
    ``device`` keyword-only: every call form binds the same names."""
    name, npos = CLASSES[kind]
    jsig = inspect.signature(getattr(jqt, name).encode)
    tsig = inspect.signature(getattr(qt, name).encode)
    tparams = list(tsig.parameters.values())
    assert [(p.name, p.default, p.kind) for p in tparams[:npos]] == [
        (p.name, p.default, p.kind) for p in jsig.parameters.values()]
    assert [(p.name, p.kind) for p in tparams[npos:]] == [
        ("device", inspect.Parameter.KEYWORD_ONLY)]
    for args, kwargs in CALLS[kind]:
        want = jsig.bind("data", "params", *args, **kwargs)
        got = tsig.bind("data", "params", *args, **kwargs)
        want.apply_defaults()
        got.apply_defaults()
        assert got.arguments == {**want.arguments, "device": None}
    with pytest.raises(TypeError):  # no eighth positional: device is keyword-only
        tsig.bind("data", "params", *([None] * (npos - 2)), "cpu")


@pytest.mark.parametrize("kind", ["sq", "bq"])
def test_jax_calls_run_natively(rng, kind):
    """Each JAX call form runs in the port (on the CPU) and encodes as the
    port's default encoder does (SQ within one code, F7; BQ byte-equal)."""
    data = rng.random((100, 20), dtype=np.float32) * 2 - 1
    params = qt.VectorParameters(20, 100, qt.DistanceType.DOT, False)
    cls = getattr(qt, CLASSES[kind][0])
    ref = cls.encode(data, params, device="cpu")
    for args, kwargs in CALLS[kind]:
        if kind == "sq" and args[:1] == (0.99,):
            ref_q = cls.encode(data, params, 0.99, seed=3, device="cpu")
        else:
            ref_q = ref
        enc = cls.encode(data, params, *args, **kwargs, device="cpu")
        if kind == "sq":
            diff = (enc.codes.to(torch.int32) - ref_q.codes.to(torch.int32)).abs()
            assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) < 0.01
        else:
            assert torch.equal(enc.planes, ref.planes)


@pytest.mark.parametrize("kind", ["sq", "bq"])
def test_use_native_without_a_toolchain_raises(rng, kind, tmp_path, monkeypatch):
    """F30: no quiet fallback to the device encoder when g++ is missing."""
    monkeypatch.setattr(loader, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_error", None)
    data = rng.random((10, 8), dtype=np.float32)
    params = qt.VectorParameters(8, 10, qt.DistanceType.DOT, False)
    cls = getattr(qt, CLASSES[kind][0])
    assert not loader.available()
    with pytest.raises(loader.NativeBuildError, match="no-such-compiler"):
        cls.encode(data, params, use_native=True, max_threads=4, device="cpu")
    cls.encode(data, params, device="cpu")  # the device encoder still runs
