"""The port's serving policy (quantization_tpu_torch/policy.py) against
tests/test_policy.py and the JAX package's policy, on the CPU: the static
seed plans equal field for field, the calibration sweep's knob ladder equal
step for step on indexes carried across (recalls within 0.02), the seed
curve and its constants, replay, unreachable targets, coarse-only plans on
full-scan quantizers, the rescorer rules, the f32 oracle and recall@k. The
sharded cases are in tests/test_torch_sharded_hooks.py.

The JAX side runs its fused kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1) so both packages search with the same approx
candidate geometry; the recalls may still differ by a tie broken another
way, hence the 0.02."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.bq as j_bq
import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.models.sq as j_sq
import quantization_tpu.policy as j_policy
import quantization_tpu_torch as qt
from quantization_tpu_torch import policy as t_policy

torch.set_num_threads(1)

DIM, K = 48, 10


def clustered(rng, count, dim=DIM, clusters=24, sigma=0.3):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (centers[assign] + sigma * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)


def _jparams(count):
    return j_types.VectorParameters(DIM, count, j_types.DistanceType.DOT, False)


def _tparams(count):
    return qt.VectorParameters(DIM, count, qt.DistanceType.DOT, False)


def _pair(family, data, **kw):
    """(JAX index, the port's copy of it) of one family."""
    n = data.shape[0]
    if family == "ivf-sq":
        j = j_ivf.IVFIndex.encode(data, _jparams(n), quantizer="sq", **kw)
        qz = j.quantizer
        return j, qt.ivf_from_numpy((np.asarray(qz.codes), np.asarray(qz.voffsets),
                                     qz.metadata.to_json()), j.bucket_ids, j.bucket_means,
                                    j.metadata.to_json(), device="cpu")
    if family == "sq":
        j = j_sq.ScalarQuantizerU8.encode(data, _jparams(n))
        return j, qt.sq_from_numpy(np.asarray(j.codes), np.asarray(j.voffsets),
                                   j.metadata.to_json(), device="cpu")
    j = j_bq.BinaryQuantizer.encode(data, _jparams(n))
    return j, qt.bq_from_numpy(np.asarray(j.planes), j.metadata.to_json(), j.store_type,
                               device="cpu")


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")


def test_static_seed_plans_equal_jax(rng):
    data = clustered(rng, 6000)
    for family in ("ivf-sq", "sq", "bq"):
        jix, tix = _pair(family, data)
        for target in (0.3, 0.5, 0.85, 0.95):
            for q_batch in (1, 8, 256, 1024):
                want = j_policy.recommend(jix, target, q_batch=q_batch)
                got = qt.recommend(tix, target, q_batch=q_batch)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (family, target)
                assert not got.calibrated


@pytest.mark.parametrize("family,target", [("ivf-sq", 0.9), ("sq", 0.95), ("bq", 0.7)])
def test_calibration_ladder_equals_jax(rng, force_pallas, family, target):
    data = clustered(rng, 12_000)
    queries = clustered(rng, 24)
    jix, tix = _pair(family, data)
    want = j_policy.recommend(jix, target, k=K, queries=queries, data=data, q_batch=24)
    got = qt.recommend(tix, target, k=K, queries=queries, data=data, q_batch=24)
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    for (_, r), (_, wr) in zip(got.history, want.history):
        assert abs(r - wr) <= 0.02
    assert (got.nscan, got.oversampling, got.calibrated) == \
        (want.nscan, want.oversampling, want.calibrated)
    assert abs(got.expected_recall - want.expected_recall) <= 0.02
    # Met, or labelled unreachable (BQ on this corpus), in both packages.
    assert ("unreachable" in got.notes) == ("unreachable" in want.notes)
    assert (got.expected_recall >= target - 0.02) != ("unreachable" in got.notes)
    # Replay: building the plan reproduces the measured recall.
    obj = got.build(tix, data, k=K)
    _, gt = qt.exact_topk(queries, data, qt.DistanceType.DOT, False, K, device="cpu")
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert abs(qt.recall_at_k(ids, gt) - got.expected_recall) < 1e-9
    assert got.history[-1][1] == got.expected_recall


def test_recommend_reports_unreachable(rng):
    # All-positive corpus: every sign code identical, BQ cannot rank.
    data = rng.random((4000, DIM)).astype(np.float32)
    queries = rng.random((6, DIM)).astype(np.float32)
    bq = qt.BinaryQuantizer.encode(data, _tparams(4000), device="cpu")
    plan = qt.recommend(bq, 0.9, k=K, queries=queries, data=data)
    assert plan.calibrated and plan.expected_recall < 0.88
    assert "unreachable" in plan.notes


def test_plan_requires_data_for_rescore(rng):
    data = clustered(rng, 2000)
    sq = qt.ScalarQuantizerU8.encode(data, _tparams(2000), device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.ServingPlan(oversampling=4.0).build(sq)
    with pytest.raises(qt.ArgumentsError):
        qt.ServingPlan(nscan=4).build(sq)  # nscan needs an IVF index


def test_coarse_only_plan_on_full_scan_index(rng):
    """A coarse-only plan over a full-scan quantizer does not forward the
    IVF-only knobs (scan=)."""
    data = clustered(rng, 2000)
    sq = qt.ScalarQuantizerU8.encode(data, _tparams(2000), device="cpu")
    queries = clustered(rng, 8)
    plan = qt.recommend(sq, 0.5)
    assert plan.oversampling <= 1.0
    obj = plan.build(sq)
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert ids.shape == (8, K)
    assert qt.recommend(sq, 0.5, k=K, queries=queries, data=data).calibrated


def test_seed_fraction_curve_equals_jax():
    for name in ("_IVF_FRACTION_CURVE", "_COARSE_CEILING", "_Q_DIVERSITY_EXP",
                 "_SEED_FRACTION_FLOOR"):
        assert getattr(t_policy, name) == getattr(j_policy, name)
    for target in (0.1, 0.162, 0.5, 0.8, 0.868, 0.99):
        for q in (1, 8, 32, 256, 1024):
            assert t_policy._seed_fraction(target, q) == j_policy._seed_fraction(target, q)
    f256 = t_policy._seed_fraction(0.8, 256) - t_policy._SEED_FRACTION_FLOOR
    f32 = t_policy._seed_fraction(0.8, 32) - t_policy._SEED_FRACTION_FLOOR
    assert f32 / f256 == pytest.approx(1 / 5, rel=0.05)


def test_seed_lands_within_two_rungs_of_calibration(rng):
    count = 12_000
    data = clustered(rng, count)
    queries = clustered(rng, 8)
    ivf = qt.IVFIndex.encode(data, _tparams(count), quantizer="sq", bucket_size=64,
                             device="cpu")
    seeded = qt.recommend(ivf, 0.85, q_batch=8)
    plan = qt.recommend(ivf, 0.85, k=K, queries=queries, data=data, q_batch=8)
    assert plan.calibrated and seeded.nscan >= 1
    assert abs(math.log2(max(plan.nscan, 1) / seeded.nscan)) <= 2.0, plan.history


def test_recommend_does_not_mutate_index(rng):
    data = clustered(rng, 4000)
    ivf = qt.IVFIndex.encode(data, _tparams(4000), quantizer="sq", device="cpu")
    before = ivf.metadata.nscan
    queries = clustered(rng, 8)
    plan = qt.recommend(ivf, 0.99, k=K, queries=queries, data=data)
    obj = plan.build(ivf, data, k=K)
    _, ids = obj.top_k(obj.encode_query(queries), K)
    assert ids.shape == (8, K) and ivf.metadata.nscan == before


def test_rescorer_rules(rng, tmp_path):
    """Host-resident for a memmap, the index's device otherwise; an index
    carrying a mesh gets the sharded rescorer over its mesh and axis."""
    data = clustered(rng, 500)
    sq = qt.ScalarQuantizerU8.encode(data, _tparams(500), device="cpu")
    mm = np.memmap(tmp_path / "d.f32", np.float32, "w+", shape=data.shape)
    mm[:] = data
    r = t_policy._make_rescorer(sq, mm, qt.DistanceType.DOT, False)
    assert r._host and r.device == sq.device
    assert not t_policy._make_rescorer(sq, data, qt.DistanceType.DOT, False)._host

    from quantization_tpu_torch.parallel.sharded import ShardedExactRescorer, make_mesh

    class Meshed:
        mesh = make_mesh(axis_names=("shard", "qdp"), shape=(2, 1), devices=["cpu"] * 2)
        axis = "shard"

    r = t_policy._make_rescorer(Meshed(), data, qt.DistanceType.DOT, False)
    assert isinstance(r, ShardedExactRescorer)
    assert r.mesh is Meshed.mesh and r.axis == "shard" and r.count == 500


def test_exact_topk_and_recall_equal_jax(rng, tmp_path):
    data = clustered(rng, 3000)
    queries = clustered(rng, 5)
    ws, wi = j_policy.exact_topk(queries, data, j_types.DistanceType.L2, True, K,
                                 block_rows=700)
    mm = np.memmap(tmp_path / "d.f32", np.float32, "w+", shape=data.shape)
    mm[:] = data
    for corpus in (data, torch.from_numpy(data), mm):
        gs, gi = qt.exact_topk(queries, corpus, qt.DistanceType.L2, True, K,
                               block_rows=700, device="cpu")
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-4)
        assert qt.recall_at_k(gi, np.asarray(wi)) == 1.0
    ids = np.asarray(wi).copy()
    ids[:, :3] = -7
    assert qt.recall_at_k(ids, wi) == j_policy.recall_at_k(ids, wi) == 0.7
