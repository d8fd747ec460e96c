"""What composes with the port's ShardedIVF, against the JAX package on the
CPU, on S = 1, 3 and 8 shards: the serving policy over a sharded IVF index
(tests/test_policy.py:233, its ``ivf-sq`` family) and a
``PipelinedSearcher`` over one (tests/test_serving.py:133). The JAX side
runs in Pallas interpret mode (QTPU_FORCE_PALLAS=1) on the same carried
state and shard count, so both packages' per-shard unions are the same
buckets; calibrated recalls agree within 0.02, as in
tests/test_torch_policy.py (a tie broken another way)."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.policy as j_policy
import quantization_tpu.serving as j_serving
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from test_torch_sharded_hooks import clustered
from torch_sharded_cases import SHARDS, bit_equal, close, ids_up_to_ties
from torch_sharded_ivf_cases import jparams, wrapped_ivf

torch.set_num_threads(1)

K, DIM = 10, 48


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


@pytest.mark.parametrize("s", SHARDS)
def test_recommend_composes_with_sharded_ivf(rng, s):
    """recommend() calibrates against a sharded IVF index end to end, and a
    rescored plan's build() picks ShardedExactRescorer on the index's own
    mesh; the JAX package, calibrating its sharded index over the same
    state, reaches the same plan."""
    count = 12_000
    data = clustered(rng, count, DIM)
    queries = clustered(rng, 24, DIM)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count, dim=DIM), quantizer="sq")
    jindex, _, index = wrapped_ivf(jivf, s)
    assert index.mesh.shape["shard"] == s
    plan = qt.recommend(index, 0.9, k=K, queries=queries, data=data, q_batch=24)
    assert plan.calibrated and plan.nscan is not None
    assert plan.expected_recall >= 0.9 - 0.02
    obj = plan.build(index, data, k=K)
    if plan.oversampling > 1.0:
        assert isinstance(obj, qt.TwoStageIndex)
        assert isinstance(obj.fine, t_sharded.ShardedExactRescorer)
        assert obj.fine.mesh is index.mesh
    _, gt = qt.exact_topk(queries, data, qt.DistanceType.DOT, False, K, device="cpu")
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert abs(qt.recall_at_k(ids, gt) - plan.expected_recall) < 1e-9
    jplan = j_policy.recommend(jindex, 0.9, k=K, queries=queries, data=data, q_batch=24)
    assert (plan.oversampling, plan.nscan) == (jplan.oversampling, jplan.nscan)
    assert abs(plan.expected_recall - jplan.expected_recall) <= 0.02


@pytest.mark.parametrize("s", SHARDS)
def test_pipelined_searcher_over_sharded_ivf(rng, s):
    """Every pipelined batch equals the blocking search of the sharded IVF
    index to the bit, in FIFO order, and the JAX package's pipelined
    sharded search (ids where untied); a plan served over it, rescored by
    ShardedExactRescorer, serves alike."""
    count = 6000
    data = clustered(rng, count, DIM)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count, dim=DIM), quantizer="sq", bucket_size=64)
    jsh, _, tsh = wrapped_ivf(jivf, s)
    batches = [clustered(rng, 8, DIM) for _ in range(4)]
    searcher = qt.PipelinedSearcher(tsh, k=K, depth=2)
    jsearcher = j_serving.PipelinedSearcher(jsh, k=K, depth=2)
    for b, (gs, gi), (ws, wi) in zip(batches, searcher.search_stream(batches),
                                     jsearcher.search_stream(batches)):
        ds, di = tsh.top_k(tsh.encode_query(b), K)
        bit_equal(gs, ds)
        bit_equal(gi, di)
        close(gs, np.asarray(ws))
        ids_up_to_ties(gs, gi, np.asarray(ws), np.asarray(wi))
    plan = qt.ServingPlan(oversampling=4.0, nscan=tsh.metadata.nbuckets // 2)
    served = plan.serve(tsh, data, k=K, depth=2)
    gs, gi = served.search(batches[0])
    built = plan.build(tsh, data, k=K)
    assert isinstance(built.fine, t_sharded.ShardedExactRescorer)
    ds, di = built.top_k(built.encode_query(batches[0]), K)
    bit_equal(gs, ds)
    bit_equal(gi, di)
