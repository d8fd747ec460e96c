"""The port's PipelinedSearcher (quantization_tpu_torch/serving.py) against
tests/test_serving.py and the JAX package's searcher, on the CPU: FIFO depth
semantics, the generator form, the blocking one-shot and warmup, knobs
passed through to IVF, plan-built and two-stage searchables, device results
with ``materialize=False``, ``sync`` keeping results queued, and the
argument errors. A searcher over a sharded engine is in
tests/test_torch_sharded_hooks.py, over a sharded IVF index (the case of
tests/test_serving.py:133) in tests/test_torch_sharded_ivf_hooks.py.

Results are compared with the same searchable's direct ``top_k`` (equal to
the bit), and with the JAX package's searcher over the same index (carried
across with ``sq_from_numpy`` / ``ivf_from_numpy``): values rtol 1e-6 /
atol 1e-4, ids equal where the value is untied. ``sync`` as a barrier on
CUDA events is tested on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.models.sq as j_sq
import quantization_tpu.serving as j_serving
import quantization_tpu_torch as qt

torch.set_num_threads(1)

DIM, K = 48, 10


def clustered(rng, count, dim=DIM, clusters=24, sigma=0.3):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (centers[assign] + sigma * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)


def _batches(rng, n, q=8):
    return [clustered(rng, q) for _ in range(n)]


@pytest.fixture
def corpus(rng):
    count = 6000
    data = clustered(rng, count)
    return data, qt.VectorParameters(DIM, count, qt.DistanceType.DOT, False)


@pytest.fixture
def sq_pair(corpus):
    """(JAX SQ quantizer, the port's copy of it)."""
    data, params = corpus
    jsq = j_sq.ScalarQuantizerU8.encode(
        data, j_types.VectorParameters.from_json(params.to_json()))
    tsq = qt.sq_from_numpy(np.asarray(jsq.codes), np.asarray(jsq.voffsets),
                           jsq.metadata.to_json(), device="cpu")
    return jsq, tsq


def _match_jax(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-6, atol=1e-4)
    for r in range(gs.shape[0]):
        vals, counts = np.unique(np.asarray(ws)[r], return_counts=True)
        untied = np.isin(np.asarray(ws)[r], vals[counts == 1])
        np.testing.assert_array_equal(gi[r][untied], np.asarray(wi)[r][untied])


def test_depth_semantics_and_fifo(rng, sq_pair):
    jsq, tsq = sq_pair
    depth = 3
    s = qt.PipelinedSearcher(tsq, k=K, depth=depth)
    js = j_serving.PipelinedSearcher(jsq, k=K, depth=depth)
    batches = _batches(rng, 7)
    direct = [tsq.top_k(tsq.encode_query(b), K) for b in batches]
    got, jgot = [], []
    for i, b in enumerate(batches):
        out, jout = s.submit(b), js.submit(b)
        # The first `depth` submissions return nothing; afterwards each
        # submit returns the result from exactly `depth` batches ago.
        assert (out is None) == (i < depth) == (jout is None)
        if out is not None:
            got.append(out)
            jgot.append(jout)
    assert s.in_flight == depth and s.depth == depth
    got.extend(s.flush())
    jgot.extend(js.flush())
    assert s.in_flight == 0 and len(got) == len(batches)
    for g, d, w in zip(got, direct, jgot):
        assert isinstance(g[0], np.ndarray) and g[1].dtype == np.int32
        np.testing.assert_array_equal(g[0], d[0])
        np.testing.assert_array_equal(g[1], d[1])
        _match_jax(g, w)


def test_search_stream_orders_and_counts(rng, sq_pair):
    _, tsq = sq_pair
    batches = _batches(rng, 5)
    s = qt.PipelinedSearcher(tsq, k=K, depth=8)  # depth > batches: all flush
    results = list(s.search_stream(batches))
    assert len(results) == len(batches)
    for b, (_, gi) in zip(batches, results):
        np.testing.assert_array_equal(gi, tsq.top_k(tsq.encode_query(b), K)[1])


def test_blocking_search_and_warmup(rng, sq_pair):
    jsq, tsq = sq_pair
    s = qt.PipelinedSearcher(tsq, k=K, depth=4)
    q = clustered(rng, 8)
    s.warmup(q)
    assert s.in_flight == 0
    s.submit(q)
    got = s.search(q)  # drains (and drops) the in-flight search first
    assert s.in_flight == 0
    np.testing.assert_array_equal(got[1], tsq.top_k(tsq.encode_query(q), K)[1])
    _match_jax(got, j_serving.PipelinedSearcher(jsq, k=K, depth=4).search(q))
    eq = tsq.encode_query(q)
    np.testing.assert_array_equal(s.search(eq, encoded=True)[1], got[1])


def test_knobs_pass_through_ivf(rng, corpus, monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    data, params = corpus
    jivf = j_ivf.IVFIndex.encode(data, j_types.VectorParameters.from_json(params.to_json()),
                                 quantizer="sq", bucket_size=64)
    qz = jivf.quantizer
    tivf = qt.ivf_from_numpy((np.asarray(qz.codes), np.asarray(qz.voffsets),
                              qz.metadata.to_json()), jivf.bucket_ids, jivf.bucket_means,
                             jivf.metadata.to_json(), device="cpu")
    nb = tivf.metadata.nbuckets
    q = clustered(rng, 8)
    got = qt.PipelinedSearcher(tivf, k=K, depth=2, nscan=nb, method="exact").search(q)
    direct = tivf.top_k(tivf.encode_query(q), K, nscan=nb, method="exact")
    np.testing.assert_array_equal(got[0], direct[0])
    np.testing.assert_array_equal(got[1], direct[1])
    _match_jax(got, j_serving.PipelinedSearcher(jivf, k=K, depth=2, nscan=nb,
                                                method="exact").search(q))


def test_two_stage_and_plan_serve(rng, corpus):
    data, params = corpus
    ivf = qt.IVFIndex.encode(data, params, quantizer="sq", bucket_size=64, device="cpu")
    queries = clustered(rng, 8)
    plan = qt.recommend(ivf, 0.95, k=K, queries=queries, data=data, q_batch=8)
    searcher = plan.serve(ivf, data, k=K, depth=2)
    assert isinstance(searcher, qt.PipelinedSearcher) and searcher.depth == 2
    direct = plan.build(ivf, data, k=K)
    batches = _batches(rng, 4)
    for b, (gs, gi) in zip(batches, searcher.search_stream(batches)):
        ds, di = direct.top_k(direct.encode_query(b), K)
        np.testing.assert_array_equal(gs, ds)
        np.testing.assert_array_equal(gi, di)
    ts = qt.TwoStageIndex(ivf, qt.ExactRescorer(data, params.distance_type, params.invert,
                                                device="cpu"), oversampling=4.0)
    _, gi = qt.PipelinedSearcher(ts, k=K, depth=2).search(queries)
    np.testing.assert_array_equal(gi, ts.top_k(ts.encode_query(queries), K)[1])


def test_materialize_false_returns_device_tensors(rng, sq_pair):
    _, tsq = sq_pair
    s = qt.PipelinedSearcher(tsq, k=K, depth=2, materialize=False)
    q = clustered(rng, 8)
    gs, gi = s.search(q)
    assert isinstance(gs, torch.Tensor) and gi.device == tsq.device
    np.testing.assert_array_equal(gi.numpy(), tsq.top_k(tsq.encode_query(q), K)[1])


def test_sync_keeps_results_queued(rng, sq_pair):
    _, tsq = sq_pair
    s = qt.PipelinedSearcher(tsq, k=K, depth=8)
    batches = _batches(rng, 3)
    for b in batches:
        s.submit(b)
    assert s.in_flight == 3
    s.sync()
    assert s.in_flight == 3  # nothing drained
    for b, (_, gi) in zip(batches, s.flush()):
        np.testing.assert_array_equal(gi, tsq.top_k(tsq.encode_query(b), K)[1])
    s.sync()  # a no-op on an empty pipe


def test_argument_errors(sq_pair):
    _, tsq = sq_pair
    with pytest.raises(qt.ArgumentsError):
        qt.PipelinedSearcher(tsq, depth=0)
    with pytest.raises(qt.ArgumentsError):
        qt.PipelinedSearcher(object())
