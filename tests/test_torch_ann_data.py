"""The port's benchmark data loader on the CPU: the three cases of
tests/test_ann_data.py (its HDF5 fixture, a small file in the exact
ann-benchmarks schema, is imported), the synthetic corpus byte-equal to the
JAX package's for a seed, and the exact neighbours equal to the JAX
package's up to ties (each id's exact score equals the JAX package's score
at that rank, within f32 rounding)."""

import numpy as np
import pytest
import torch

from quantization_tpu.bench import ann_data as j_ann_data
import quantization_tpu_torch as qt
from quantization_tpu_torch.bench.ann_data import (
    DATASETS,
    AnnBenchmarkData,
    DatasetSpec,
    cosine_preprocess,
    test_knn as run_knn,  # alias: pytest must not collect the harness fn
)
from test_ann_data import hdf5_dataset  # noqa: F401  (the fixture)

torch.set_num_threads(1)


def _spec(spec):
    return DatasetSpec(spec.name, spec.filename, spec.dim, qt.DistanceType[spec.distance_type.name])


def test_load_prefers_local_hdf5(hdf5_dataset):  # noqa: F811
    spec, data_dir, train, test, neighbors = hdf5_dataset
    data = AnnBenchmarkData.load(_spec(spec), data_dir=str(data_dir), device="cpu")
    assert data.name == spec.name  # not "<name>-synthetic"
    np.testing.assert_array_equal(data.train, train)
    np.testing.assert_array_equal(data.test, test)
    np.testing.assert_array_equal(data.neighbors, neighbors)


def test_load_synthetic_fallback_when_file_missing(tmp_path):
    spec = DatasetSpec("unit-32-angular", "nope.hdf5", 32, qt.DistanceType.DOT)
    data = AnnBenchmarkData.load(spec, data_dir=str(tmp_path), synthetic_count=500,
                                 synthetic_queries=8, device="cpu")
    assert data.name.endswith("-synthetic")
    assert data.train.shape == (500, 32)


def test_knn_harness_on_hdf5_data(hdf5_dataset):  # noqa: F811
    """HDF5 load -> cosine preprocess -> SQ encode -> recall: 8-bit SQ on a
    600-point corpus recovers nearly all of the exact top-10."""
    spec, data_dir, *_ = hdf5_dataset
    data = AnnBenchmarkData.load(_spec(spec), data_dir=str(data_dir), device="cpu")
    data.preprocess_cosine()
    params = qt.VectorParameters(spec.dim, data.train.shape[0], qt.DistanceType.DOT, False)
    enc = qt.ScalarQuantizerU8.encode(data.train, params, device="cpu")
    res = run_knn(data, enc, query_batch=16)
    assert res.same_10 >= 0.9
    assert res.same_30 >= 0.9
    t = res.timings()
    assert t["min_us"] <= t["p95_us"] <= t["max_us"]


def test_registry_equals_the_jax_package():
    assert list(DATASETS) == list(j_ann_data.DATASETS)
    for name, spec in DATASETS.items():
        j = j_ann_data.DATASETS[name]
        assert (spec.filename, spec.dim, spec.distance_type.name) == (
            j.filename, j.dim, j.distance_type.name)


@pytest.mark.parametrize("count", [777, 2000])
@pytest.mark.parametrize("name", ["sift-128-euclidean", "deep-image-96-angular",
                                  "lastfm-64-dot"])
def test_synthetic_equals_the_jax_package(name, count):
    """train / test byte-equal at a count of rows that is a multiple of no
    block size and at one that is; neighbours equal up to ties: where an id
    differs from the JAX package's, its exact score equals the score at
    that rank within f32 rounding."""
    t = AnnBenchmarkData.synthetic(DATASETS[name], count, 40, seed=42, device="cpu")
    j = j_ann_data.AnnBenchmarkData.synthetic(j_ann_data.DATASETS[name], count, 40, seed=42)
    assert t.name == j.name
    assert t.train.dtype == j.train.dtype == np.float32
    assert t.train.tobytes() == j.train.tobytes()
    assert t.test.tobytes() == j.test.tobytes()
    assert t.neighbors.shape == j.neighbors.shape == (40, 100)
    invert = t.distance_type != qt.DistanceType.DOT
    exact = qt.pairwise_score(t.test, t.train, t.distance_type, invert).numpy()
    got = np.take_along_axis(exact, t.neighbors, axis=1)
    want = np.take_along_axis(exact, np.asarray(j.neighbors), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (t.neighbors == np.asarray(j.neighbors)).mean() > 0.99
    for row in t.neighbors:
        assert len(set(row.tolist())) == row.size


def test_cosine_preprocess_equals_the_jax_package(rng):
    x = rng.standard_normal((50, 16)).astype(np.float32)
    x[3] = 0.0
    assert cosine_preprocess(x).tobytes() == j_ann_data.cosine_preprocess(x).tobytes()
