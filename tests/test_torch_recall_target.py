"""``recall_target=`` on every search of the port (ROADMAP F27).

The JAX package's ``top_k`` / ``top_k_device`` take ``recall_target``, its
approx merge's dial. The port accepts it, checks it (None or a float in
(0, 1]) and ignores it: its approx merge is exact (F9), so the keyword
changes no result."""

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qt

torch.set_num_threads(1)

N, D, NQ, K = 1500, 128, 5, 10
KINDS = ["sq", "bq", "pq", "ivf_sq", "two_stage"]


def build(kind):
    rng = np.random.default_rng(11)
    data = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    params = qt.VectorParameters(D, N, qt.DistanceType.DOT, False)
    if kind == "sq":
        index = qt.ScalarQuantizerU8.encode(data, params, device="cpu")
    elif kind == "bq":
        index = qt.BinaryQuantizer.encode(data, params, device="cpu")
    elif kind == "pq":
        index = qt.ProductQuantizer.encode(data, params, chunk_size=8, device="cpu")
    elif kind == "ivf_sq":
        index = qt.IVFIndex.encode(data, params, quantizer="sq", nlist=4, bucket_size=512,
                                   nprobe=2, device="cpu")
    else:
        coarse = qt.BinaryQuantizer.encode(data, params, device="cpu")
        fine = qt.ScalarQuantizerU8.encode(data, params, device="cpu")
        index = qt.TwoStageIndex(coarse, fine, oversampling=4.0)
    return index, index.encode_query(queries)


@pytest.fixture(scope="module")
def built():
    return {}


def get(built, kind):
    if kind not in built:
        built[kind] = build(kind)
    return built[kind]


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("kind", KINDS)
def test_recall_target_changes_nothing(built, kind, method):
    index, eq = get(built, kind)
    want_s, want_i = index.top_k(eq, K, method=method)
    for rt in (None, 0.95, 1.0):
        s, i = index.top_k(eq, K, method=method, recall_target=rt)
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(i, want_i)
    ds, di = index.top_k_device(eq, K, method=method, recall_target=0.95)
    np.testing.assert_array_equal(ds.cpu().numpy(), want_s)
    np.testing.assert_array_equal(di.cpu().numpy(), want_i)


@pytest.mark.parametrize("bad", [0, 1.5, -0.1, "0.9"])
@pytest.mark.parametrize("kind", KINDS)
def test_recall_target_outside_unit_interval_raises(built, kind, bad):
    index, eq = get(built, kind)
    with pytest.raises(qt.ArgumentsError):
        index.top_k(eq, K, method="approx", recall_target=bad)
    with pytest.raises(qt.ArgumentsError):
        index.top_k_device(eq, K, method="exact", recall_target=bad)
