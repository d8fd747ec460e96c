"""Parity of the PyTorch port's core contracts with the JAX package: the
numpy-only modules the port copies (types, storage, quantile) are pinned to
their originals, the JSON wire format and the checkpoint blobs cross between
the packages, and the padding helpers agree."""

import ast
import inspect

import numpy as np
import pytest
import torch

import quantization_tpu.core.distances as j_distances
import quantization_tpu.core.storage as j_storage
import quantization_tpu.core.types as j_types
import quantization_tpu.ops.quantile as j_quantile
import quantization_tpu.utils.padding as j_padding
import quantization_tpu_torch.core.distances as t_distances
import quantization_tpu_torch.core.storage as t_storage
import quantization_tpu_torch.core.types as t_types
import quantization_tpu_torch.ops.quantile as t_quantile
import quantization_tpu_torch.utils.padding as t_padding
from quantization_tpu_torch.utils.device_store import DeviceAppender

torch.set_num_threads(1)


def _body_without_docstring(module) -> str:
    tree = ast.parse(inspect.getsource(module))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize(
    "pair",
    [(j_types, t_types), (j_storage, t_storage), (j_quantile, t_quantile)],
    ids=["types", "storage", "quantile"],
)
def test_numpy_copies_match_originals(pair):
    """The port keeps its own copies (importing the originals loads JAX);
    apart from the module docstring they are the same code."""
    j_mod, t_mod = pair
    assert _body_without_docstring(t_mod) == _body_without_docstring(j_mod)


@pytest.mark.parametrize("name", ["Dot", "L1", "L2", "dot", "euclid", "cosine"])
def test_distance_type_json(name):
    j = j_types.DistanceType.from_json(name)
    t = t_types.DistanceType.from_json(name)
    assert t.to_json() == j.to_json()
    assert t.name == j.name


@pytest.mark.parametrize("dt", ["Dot", "L1", "L2"])
@pytest.mark.parametrize("invert", [False, True])
def test_vector_parameters_json_crosses(dt, invert):
    j = j_types.VectorParameters(33, 1000, j_types.DistanceType.from_json(dt), invert)
    t = t_types.VectorParameters.from_json(j.to_json())
    assert t.to_json() == j.to_json()
    assert j_types.VectorParameters.from_json(t.to_json()) == j


def test_errors_and_stop():
    for name in ("EncodingError", "ArgumentsError", "StorageIOError", "StoppedError"):
        assert issubclass(getattr(t_types, name), t_types.QuantizationError)
    with pytest.raises(t_types.ArgumentsError):
        t_types.VectorParameters(-1, 1, t_types.DistanceType.DOT)
    with pytest.raises(t_types.StoppedError):
        t_types.check_stop(lambda: True)
    t_types.check_stop(lambda: False)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_encoded_storage_round_trip(rng, tmp_path, direction):
    rows = rng.integers(0, 256, (37, 20), dtype=np.uint8)
    write, read = (
        (t_storage, j_storage) if direction == "torch_to_jax" else (j_storage, t_storage)
    )
    builder = write.EncodedStorageBuilder(20)
    builder.push_batch(rows[:30])
    for r in rows[30:]:
        builder.push_vector_data(r.tobytes())
    path = tmp_path / "blob.bin"
    builder.build().save_to_file(path)
    got = read.EncodedStorage.from_file(path, 20, 37)
    np.testing.assert_array_equal(got.data, rows)
    with pytest.raises(read.StorageIOError):
        read.EncodedStorage.from_file(path, 20, 36)


@pytest.mark.parametrize("x", [0, 1, 127, 128, 129, 511, 512, 513])
@pytest.mark.parametrize("m", [16, 128, 512])
def test_round_up(x, m):
    assert t_padding.round_up(x, m) == j_padding.round_up(x, m)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pad_dim_to(rng, axis):
    arr = rng.integers(-100, 100, (5, 7)).astype(np.int8)
    target = arr.shape[axis] + 3
    want = j_padding.pad_dim_to(arr, axis, target, value=2)
    got = t_padding.pad_dim_to(torch.from_numpy(arr), axis, target, value=2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert t_padding.pad_dim_to(torch.from_numpy(arr), axis, arr.shape[axis]).shape == arr.shape
    with pytest.raises(ValueError):
        t_padding.pad_dim_to(torch.from_numpy(arr), axis, arr.shape[axis] - 1)


@pytest.mark.parametrize("dt", ["Dot", "L1", "L2"])
@pytest.mark.parametrize("invert", [False, True])
def test_f32_oracle_matches_jax(rng, dt, invert):
    """The exact f32 oracle (the recall reference): float32 sums in another
    order, so rtol 1e-5 / atol 1e-4."""
    queries = rng.standard_normal((6, 70)).astype(np.float32)
    corpus = rng.standard_normal((2100, 70)).astype(np.float32)
    jdt, tdt = j_types.DistanceType.from_json(dt), t_types.DistanceType.from_json(dt)
    want = np.asarray(j_distances.pairwise_score(queries, corpus, jdt, invert))
    got = t_distances.pairwise_score(torch.from_numpy(queries), torch.from_numpy(corpus),
                                     tdt, invert)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    one = t_distances.score(torch.from_numpy(queries[0]), torch.from_numpy(corpus[5]),
                            tdt, invert)
    np.testing.assert_allclose(float(one), want[0, 5], rtol=1e-5, atol=1e-4)


def test_device_appender():
    app = DeviceAppender((5, 3), torch.int8, torch.device("cpu"))
    app.append(torch.ones((2, 3), dtype=torch.int8))
    app.append(torch.full((2, 3), 2, dtype=torch.int8))
    assert app.pos == 4
    with pytest.raises(ValueError, match="overflow"):
        app.append(torch.ones((2, 3), dtype=torch.int8))
    buf = app.finish()
    np.testing.assert_array_equal(buf.numpy()[:, 0], [1, 1, 2, 2, 0])
