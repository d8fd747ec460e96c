"""What composes with the port's sharded engines, against the JAX package on
the CPU, on S = 1, 3 and 8 shards (tests/torch_sharded_cases.py): two-stage
retrieval over sharded stages (tests/test_sharded_native.py's two-stage
cases), the serving policy's mesh branch (tests/test_policy.py:233, its
``sq`` family), a ``PipelinedSearcher`` over a sharded SQ engine (the SQ
counterpart of tests/test_serving.py:133) and the streaming store's
sharding role (``DeviceAppender`` with a mesh).

Two-stage results equal the port's single-device two-stage wherever the two
coarse searches pick the same candidates, which here is on every query: they
could differ only by a tie across the R-th coarse score, broken in shard
order on the mesh (ROADMAP F32); the coarse top-R values are equal on every
query. Recalls of the two
packages' calibrated plans agree within 0.02, as in
tests/test_torch_policy.py (a tie broken another way), with the JAX side
in Pallas interpret mode as there."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.bq as j_bq
import quantization_tpu.models.pipeline as j_pipeline
import quantization_tpu.models.sq as j_sq
import quantization_tpu.policy as j_policy
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from quantization_tpu_torch.utils.device_store import DeviceAppender
from torch_sharded_cases import (
    CPU,
    SHARDS,
    bit_equal,
    close,
    host,
    ids_up_to_ties,
    meshes,
    params,
    wrapped,
)

torch.set_num_threads(1)

K = 10


def clustered(rng, count, dim, clusters=24, sigma=0.3):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (centers[assign] + sigma * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)


def same_where_candidates_agree(two, two_ref, eq, eq_ref, k):
    """A sharded two-stage result against a reference two-stage: the coarse
    top-R values are equal on every query (a tie cannot change them), the
    fine stage ranks the sharded coarse candidates exactly, and the results
    are equal on every query whose coarse candidates agree. Returns how many
    agree."""
    r = int(np.ceil(k * two.oversampling))
    cs, cand = two.coarse.top_k_device(eq[0], r, method=two.coarse_method)
    ws_c, cand_ref = two_ref.coarse.top_k(eq_ref[0], r, method=two_ref.coarse_method)
    bit_equal(cs, ws_c)
    gs, gi = two.top_k(eq, k)
    ws, wi = two_ref.top_k(eq_ref, k)
    fine = host(two.fine.score_candidates(eq[1], cand))
    bit_equal(gs, -np.sort(-fine, axis=1)[:, :k])
    agree = np.all(np.sort(host(cand), 1) == np.sort(host(cand_ref), 1), axis=1)
    bit_equal(gs[agree], ws[agree])
    ids_up_to_ties(gs[agree], gi[agree], ws[agree], wi[agree])
    return int(agree.sum())


@pytest.mark.parametrize("s", SHARDS)
def test_two_stage_sharded_bq_to_sq(rng, s):
    """Sharded BQ coarse scan -> sharded SQ candidate rescoring (K4 per
    shard), against the port's single-device pipeline and the JAX
    package's sharded one."""
    n, dim, k = 400, 64, 10
    data = rng.random((n, dim), dtype=np.float32) * 2.0 - 1.0
    queries = rng.random((4, dim), dtype=np.float32) * 2.0 - 1.0
    jp, _ = params(dim, n)
    jbq, jsq = j_bq.BinaryQuantizer.encode(data, jp), j_sq.ScalarQuantizerU8.encode(data, jp)
    jsbq, tbq, tsbq = wrapped(jbq, s)
    jssq, tsq, tssq = wrapped(jsq, s)
    dist = qt.TwoStageIndex(tsbq, tssq, oversampling=4.0, coarse_method="exact")
    single = qt.TwoStageIndex(tbq, tsq, oversampling=4.0, coarse_method="exact")
    eq = dist.encode_query(queries)
    agree = same_where_candidates_agree(dist, single, eq, single.encode_query(queries), k)
    assert agree == len(queries)
    # Against the JAX package, whose shards are other widths and whose top-k
    # breaks a tie in another order, so that its 40 coarse candidates differ
    # from the port's by a tie on every query here: the coarse top-40 values
    # on every query, and both fine stages on the port's candidates.
    jdist = j_pipeline.TwoStageIndex(jsbq, jssq, oversampling=4.0, coarse_method="exact")
    jdeq = jdist.encode_query(queries)
    jcs, _ = jsbq.top_k(jdeq[0], 40)
    cs, cand = tsbq.top_k(eq[0], 40)
    close(cs, np.asarray(jcs))
    close(host(tssq.score_candidates(eq[1], cand)),
          np.asarray(jssq.score_candidates(jdeq[1], cand)))


@pytest.mark.parametrize("s", SHARDS)
def test_two_stage_sharded_exact_rescorer(rng, s):
    n, dim, k = 300, 32, 5
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, _ = params(dim, n, "L2", True)
    jsq = j_sq.ScalarQuantizerU8.encode(data, jp)
    _, tsq, tssq = wrapped(jsq, s)
    _, tm = meshes(s)
    fine = t_sharded.ShardedExactRescorer(data, qt.DistanceType.L2, True, tm)
    idx = qt.TwoStageIndex(tssq, fine, oversampling=6.0, coarse_method="exact")
    s_, i = idx.top_k(idx.encode_query(queries), k)
    # Exact rescoring of an oversampled candidate set must reproduce the
    # exact L2 ranking for nearly all of the top-k.
    want = host(qt.pairwise_score(torch.from_numpy(queries), torch.from_numpy(data),
                                  qt.DistanceType.L2, True))
    exact = np.argsort(-want, axis=1)[:, :k]
    for r in range(len(i)):
        assert len(set(i[r]) & set(exact[r])) >= k - 1
    single = qt.TwoStageIndex(tsq, qt.ExactRescorer(data, qt.DistanceType.L2, True,
                                                    device="cpu"),
                              oversampling=6.0, coarse_method="exact")
    assert same_where_candidates_agree(idx, single, idx.encode_query(queries),
                                       single.encode_query(queries), k) == len(queries)
    # A tensor corpus is taken as it is, each shard a slice of it.
    t = t_sharded.ShardedExactRescorer(torch.from_numpy(data), qt.DistanceType.L2, True, tm)
    cand = np.array([[0, n - 1, -1, n]] * 2)
    bit_equal(t.score_candidates(t.encode_query(queries), cand),
              fine.score_candidates(fine.encode_query(queries), cand))


@pytest.mark.parametrize("s", SHARDS)
def test_recommend_composes_with_sharded_engines(rng, s, monkeypatch):
    """tests/test_policy.py:233 (its sq family) in the port: recommend()
    calibrates against a sharded index end to end, and a rescored plan's
    build() selects ShardedExactRescorer over the index's own mesh — no
    full-corpus f32 funnel through one device. The JAX package, calibrating
    its sharded index over the same state, reaches the same plan; it runs
    its fused kernels in Pallas interpret mode (QTPU_FORCE_PALLAS=1) so both
    packages' approx coarse stages pick from the same stride classes (the
    shards are equal in both at this count)."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    dim, count = 48, 12_000
    data = clustered(rng, count, dim)
    queries = clustered(rng, 24, dim)
    jp, _ = params(dim, count)
    jsq = j_sq.ScalarQuantizerU8.encode(data, jp)
    jindex, _, index = wrapped(jsq, s)
    assert index.mesh.shape["shard"] == s
    plan = qt.recommend(index, 0.95, k=K, queries=queries, data=data, q_batch=24)
    assert plan.calibrated
    assert plan.expected_recall >= 0.95 - 0.02
    obj = plan.build(index, data, k=K)
    if plan.oversampling > 1.0:
        assert isinstance(obj, qt.TwoStageIndex)
        assert isinstance(obj.fine, t_sharded.ShardedExactRescorer)
        assert obj.fine.mesh is index.mesh
    # Replay through the built object reproduces the measured recall.
    _, gt = qt.exact_topk(queries, data, qt.DistanceType.DOT, False, K, device="cpu")
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert abs(qt.recall_at_k(ids, gt) - plan.expected_recall) < 1e-9
    jplan = j_policy.recommend(jindex, 0.95, k=K, queries=queries, data=data, q_batch=24)
    assert (plan.oversampling, plan.nscan) == (jplan.oversampling, jplan.nscan)
    assert abs(plan.expected_recall - jplan.expected_recall) <= 0.02


@pytest.mark.parametrize("s", SHARDS)
def test_pipelined_searcher_over_a_sharded_engine(rng, s):
    """The SQ counterpart of tests/test_serving.py:133: every pipelined
    batch equals the blocking search of the sharded engine, which equals the
    JAX package's sharded search (ids where untied) and the port's
    single-device one to the bit; a plan-built two-stage over it serves
    alike."""
    dim, count = 48, 6000
    data = clustered(rng, count, dim)
    jp, _ = params(dim, count)
    jsq = j_sq.ScalarQuantizerU8.encode(data, jp)
    jsh, tsq, tsh = wrapped(jsq, s)
    batches = [clustered(rng, 8, dim) for _ in range(4)]
    searcher = qt.PipelinedSearcher(tsh, k=K, depth=2)
    for b, (gs, gi) in zip(batches, searcher.search_stream(batches)):
        ds, di = tsh.top_k(tsh.encode_query(b), K)
        bit_equal(gs, ds)
        bit_equal(gi, di)
        bit_equal(gs, tsq.top_k(tsq.encode_query(b), K)[0])
        ws, wi = jsh.top_k(jsq.encode_query(b), K)
        close(gs, ws)
        ids_up_to_ties(gs, gi, ws, wi)
    plan = qt.ServingPlan(oversampling=4.0)
    served = plan.serve(tsh, data, k=K, depth=2)
    gs, gi = served.search(batches[0])
    built = plan.build(tsh, data, k=K)
    assert isinstance(built.fine, t_sharded.ShardedExactRescorer)
    ds, di = built.top_k(built.encode_query(batches[0]), K)
    bit_equal(gs, ds)
    bit_equal(gi, di)


@pytest.mark.parametrize("s", SHARDS)
def test_device_appender_splits_batches_at_shard_boundaries(s):
    """With a mesh the store is one buffer per shard, on the first device of
    its slice of the grid; each batch lands in the shards it spans, and no
    buffer of the whole corpus is made."""
    mesh = t_sharded.make_mesh(axis_names=("shard", "qdp"), shape=(s, 2), devices=[CPU] * 2 * s)
    rows = 6 * s
    app = DeviceAppender((rows, 3), torch.int8, mesh=mesh, mesh_axis="shard")
    full = torch.arange(rows * 3, dtype=torch.int8).reshape(rows, 3)
    for b0 in range(0, rows - 1, 5):  # batches of 5 straddle the 6-row shards
        app.append(full[b0 : min(b0 + 5, rows - 1)])
    assert app.pos == rows - 1
    with pytest.raises(ValueError, match="overflow"):
        app.append(full[:2])
    out = app.finish()
    assert out.n_shards == s and out.n_local == 6 and out.shape == (rows, 3)
    assert len(out.shards) == s and all(t.device == CPU for t in out.shards)
    want = full.clone()
    want[-1] = 0  # never appended: the zero fill
    bit_equal(out.numpy(), want)
    planes = DeviceAppender((2, 4 * s), torch.int32, mesh=mesh, mesh_axis="shard", axis=1)
    planes.append(torch.ones((2, 4 * s - 1), dtype=torch.int32))
    assert out.dim == 0 and planes.finish().numpy()[:, -1].sum() == 0
    if s > 1:
        with pytest.raises(ValueError, match="shards"):
            DeviceAppender((rows + 1, 3), torch.int8, mesh=mesh, mesh_axis="shard")
