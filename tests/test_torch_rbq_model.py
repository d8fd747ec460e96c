"""Residual IVF-BQ in the port against the JAX package, on seeded data:
the build (bucket ids, planes, ``residual_scale``) on well-separated
clusters (ROADMAP F21), the value query of ``encode_query``, the recall lift
and data-unit scores of tests/test_ivf.py:414-452, the unit-normalized
warning (:455-481), checkpoints across packages (:484-500), batch
independence (:503-530), and pad slots that never crowd rows out of the
candidates (ROADMAP F25). The search parity on a JAX index carried across by
``ivf_from_numpy`` runs in tests/test_torch_ivf_search.py (config
``bq_res``).

Tolerances: codes, planes, ``residual_scale`` and the query's affine terms
equal to the bit; search scores rtol 1e-5 / atol 1e-4 against the JAX
package (the bucket term q . c_b is an f32 matrix product summed in another
order), equal to the bit between two runs of the port."""

import warnings

import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.ivf as j_ivf
import quantization_tpu_torch as qt
from quantization_tpu_torch.models import ivf as t_ivf

torch.set_num_threads(1)

DIM, K = 48, 10


def res_corpus(rng, count, dim=DIM, queries=8):
    """tests/test_ivf.py:307-318: 6 centres x 3, sigma 0.3, not normalized;
    queries are corpus rows + 0.05 noise."""
    centers = rng.standard_normal((6, dim)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (centers[assign] + 0.3 * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)
    qs = data[rng.choice(count, queries, replace=False)]
    qs = qs + 0.05 * rng.standard_normal(qs.shape).astype(np.float32)
    return data, qs.astype(np.float32)


def _tparams(count, invert=False, dt=qt.DistanceType.DOT):
    return qt.VectorParameters(DIM, count, dt, invert)


def _jparams(count, invert=False):
    return j_types.VectorParameters(DIM, count, j_types.DistanceType.DOT, invert)


def _pair(rng, count=3000, nlist=6, invert=False):
    data, queries = res_corpus(rng, count)
    kw = dict(quantizer="bq", nlist=nlist, bucket_size=512, nprobe=nlist, seed=0)
    out = {r: qt.IVFIndex.encode(data, _tparams(count, invert), residual=r, device="cpu", **kw)
           for r in (False, True)}
    return data, queries, out


def test_build_matches_jax(rng):
    """Well-separated clusters: the port's residual-BQ build equals the JAX
    package's, planes byte for byte, and beta drawn from the same stream."""
    data, _ = res_corpus(rng, 2500)
    kw = dict(quantizer="bq", nlist=6, bucket_size=512, residual=True, seed=3)
    jivf = j_ivf.IVFIndex.encode(data, _jparams(2500), **kw)
    tivf = qt.IVFIndex.encode(data, _tparams(2500), device="cpu", **kw)
    np.testing.assert_array_equal(tivf.bucket_ids, jivf.bucket_ids)
    np.testing.assert_array_equal(tivf.bucket_means, jivf.bucket_means)
    assert tivf.metadata.residual_scale == jivf.metadata.residual_scale > 0
    assert tivf.metadata.to_json() == jivf.metadata.to_json()
    np.testing.assert_array_equal(qt.ivf_to_numpy(tivf)[0][0],
                                  np.asarray(jivf.quantizer.planes))


def test_encode_query_matches_jax(rng):
    data, queries = res_corpus(rng, 2000)
    jivf = j_ivf.IVFIndex.encode(data, _jparams(2000), quantizer="bq", nlist=4,
                                 bucket_size=512, residual=True)
    tivf = qt.ivf_from_numpy((np.asarray(jivf.quantizer.planes),
                              jivf.quantizer.metadata.to_json(), jivf.quantizer.store_type),
                             jivf.bucket_ids, jivf.bucket_means, jivf.metadata.to_json(),
                             device="cpu")
    queries = np.concatenate([queries, 40.0 * queries[:2], np.zeros((1, DIM), np.float32)])
    jq, jeq = jivf.encode_query(queries)
    tq, teq = tivf.encode_query(queries)
    assert isinstance(teq, t_ivf._ResidualQueryBQ)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    for name in ("codes", "mult", "qb"):
        np.testing.assert_array_equal(getattr(teq, name).numpy(), np.asarray(getattr(jeq, name)))


@pytest.mark.parametrize("invert", [False, True])
def test_residual_bq_lifts_recall(rng, invert):
    """tests/test_ivf.py:414-452 on the port: residual signs carry the
    within-cluster ranking that plain signs lose, and the scores are in data
    units."""
    data, queries, idx = _pair(rng, invert=invert)
    gt_s = (queries @ data.T) * (-1.0 if invert else 1.0)
    gt = np.argsort(-gt_s, axis=1)[:, :K]
    rec = {}
    for residual, ivf in idx.items():
        assert ivf.metadata.residual is residual
        sv, ids = ivf.top_k(ivf.encode_query(queries), K, method="exact",
                            nscan=ivf.metadata.nbuckets)
        assert (ids >= 0).all() and all(len(set(r.tolist())) == K for r in ids)
        rec[residual] = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)]))
        if residual:
            assert ivf.metadata.residual_scale > 0
            err = np.mean(np.abs(sv - np.take_along_axis(gt_s, ids, axis=1)))
            spread = np.mean(np.ptp(gt_s, axis=1))
            assert err < 0.25 * spread, (err, spread)
    assert rec[True] >= rec[False] + 0.1, rec


def test_residual_bq_normalized_corpus_warns(rng):
    """tests/test_ivf.py:455-481: the build warns on a unit-normalized corpus
    and on nothing else."""
    data, _ = res_corpus(rng, 1500)
    kw = dict(quantizer="bq", nlist=2, bucket_size=512, device="cpu")
    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    with pytest.warns(UserWarning, match="unit-normalized"):
        qt.IVFIndex.encode(unit, _tparams(1500), residual=True, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        qt.IVFIndex.encode(data, _tparams(1500), residual=True, **kw)
        qt.IVFIndex.encode(unit, _tparams(1500), **kw)


def test_residual_bq_rejects_l2(rng):
    data, _ = res_corpus(rng, 1500)
    with pytest.raises(qt.ArgumentsError, match="DOT only"):
        qt.IVFIndex.encode(data, _tparams(1500, dt=qt.DistanceType.L2), quantizer="bq",
                           nlist=2, bucket_size=512, residual=True, device="cpu")


def test_residual_bq_checkpoints_across_packages(rng, tmp_path, monkeypatch):
    """tests/test_ivf.py:484-500 across packages: beta persists in the
    metadata sidecar, and each package loads the other's files and searches
    as the writer does."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    data, queries = res_corpus(rng, 2000)
    jivf = j_ivf.IVFIndex.encode(data, _jparams(2000), quantizer="bq", nlist=4,
                                 bucket_size=512, residual=True)
    jivf.save(tmp_path / "j.bin", tmp_path / "j.json")
    back = qt.IVFIndex.load(tmp_path / "j.bin", tmp_path / "j.json", _tparams(2000),
                            device="cpu")
    assert back.metadata.residual and back.metadata.residual_scale == \
        jivf.metadata.residual_scale > 0
    back.save(tmp_path / "t.bin", tmp_path / "t.json")
    jback = j_ivf.IVFIndex.load(tmp_path / "t.bin", tmp_path / "t.json", _jparams(2000))
    assert jback.metadata.to_json() == jivf.metadata.to_json()
    np.testing.assert_array_equal(np.asarray(jback.quantizer.planes),
                                  np.asarray(jivf.quantizer.planes))
    again = qt.IVFIndex.load(tmp_path / "t.bin", tmp_path / "t.json", _tparams(2000),
                             device="cpu")
    for method in ("exact", "approx"):
        ws, wi = jivf.top_k(jivf.encode_query(queries), K, method=method)
        gs, gi = back.top_k(back.encode_query(queries), K, method=method)
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-5, atol=1e-4)
        a = again.top_k(again.encode_query(queries), K, method=method)
        np.testing.assert_array_equal(a[0], gs)
        np.testing.assert_array_equal(a[1], gi)


def test_residual_query_batch_independence(rng):
    """tests/test_ivf.py:503-530 for BQ: a query's codes, affine terms and
    results do not depend on the other queries of its batch, even beside a
    companion 1000x the data scale."""
    data, queries, idx = _pair(rng, count=2000, nlist=4)
    ivf = idx[True]
    mixed = np.concatenate([queries, 1000.0 * rng.standard_normal((1, DIM)).astype(
        np.float32)])
    q_solo, eq_solo = ivf.encode_query(queries)
    q_mix, eq_mix = ivf.encode_query(mixed)
    nq = queries.shape[0]
    for name in ("codes", "mult", "qb"):
        np.testing.assert_array_equal(getattr(eq_solo, name).numpy(),
                                      getattr(eq_mix, name).numpy()[:nq])
    nb = ivf.metadata.nbuckets
    a = ivf.top_k((q_solo, eq_solo), K, method="exact", nscan=nb)
    b = ivf.top_k((q_mix, eq_mix), K, method="exact", nscan=nb)
    np.testing.assert_array_equal(a[0], b[0][:nq])
    np.testing.assert_array_equal(a[1], b[1][:nq])


def test_pad_slots_are_masked(rng):
    """Residual BQ drops pad slots in the id map (the JAX package's
    models/ivf.py:746-759); plain BQ keeps them as duplicates."""
    data, queries, idx = _pair(rng, count=1000, nlist=3)
    for residual, ivf in idx.items():
        pads = ivf.bucket_ids < 0
        assert pads.any()
        slots = ivf._slot_ids_dev.numpy()
        assert (slots[pads] == -1).all() == residual
        assert (slots[~pads] == ivf.bucket_ids[~pads]).all()
    ivf = idx[True]
    s, i = ivf.top_k(ivf.encode_query(queries), K, method="exact",
                     nscan=ivf.metadata.nbuckets)
    assert (i >= 0).all() and all(len(set(r.tolist())) == K for r in i)


def test_pad_slots_never_crowd_out_rows():
    """ROADMAP F25: the JAX package only drops pad slots from the id map, so
    pads that score among the top kk2 candidates leave fewer than k rows
    (-1 ids; seed and sizes chosen where it does). The port also scores them
    NEG, so every slot holds a distinct row, and the rows the JAX package
    found are the port's leading ones (exact search)."""
    rng = np.random.default_rng(0)
    data, queries = res_corpus(rng, 1500)
    jivf = j_ivf.IVFIndex.encode(data, _jparams(1500), quantizer="bq", nlist=3,
                                 bucket_size=512, residual=True, seed=0)
    carried = qt.ivf_from_numpy((np.asarray(jivf.quantizer.planes),
                                 jivf.quantizer.metadata.to_json(),
                                 jivf.quantizer.store_type), jivf.bucket_ids,
                                jivf.bucket_means, jivf.metadata.to_json(), device="cpu")
    nb, k = jivf.metadata.nbuckets, 100
    ws, wi = (np.asarray(a) for a in jivf.top_k(jivf.encode_query(queries), k, method="exact",
                                                nscan=nb, nprobe=nb))
    gs, gi = carried.top_k(carried.encode_query(queries), k, method="exact", nscan=nb,
                           nprobe=nb)
    assert (wi < 0).any()  # the JAX package's shortfall
    assert (gi >= 0).all() and all(len(set(r.tolist())) == k for r in gi)
    for r in range(gi.shape[0]):
        m = int((wi[r] >= 0).sum())
        assert (wi[r, :m] >= 0).all()
        np.testing.assert_allclose(gs[r, :m], ws[r, :m], rtol=1e-5, atol=1e-4)
        assert set(wi[r, :m].tolist()) <= set(gi[r].tolist())


def test_unfused_branch_matches_fused(rng):
    """kk2 above the fused cap leaves the kernels for score_affine + corr +
    torch.topk, as the JAX package leaves them for XLA: the same values."""
    data, queries, idx = _pair(rng, count=3000, nlist=6)
    ivf = idx[True]
    eq = ivf.encode_query(queries)
    nb = ivf.metadata.nbuckets
    fused = ivf.top_k(eq, 500, method="exact", nscan=nb)
    unfused = ivf.top_k(eq, 1100, method="exact", nscan=nb)  # kk2 = 2200 > 1024
    np.testing.assert_array_equal(unfused[0][:, :500], fused[0])
    jivf = j_ivf.IVFIndex.encode(data, _jparams(3000), quantizer="bq", nlist=6,
                                 bucket_size=512, nprobe=6, residual=True, seed=0)
    carried = qt.ivf_from_numpy((np.asarray(jivf.quantizer.planes),
                                 jivf.quantizer.metadata.to_json(),
                                 jivf.quantizer.store_type), jivf.bucket_ids,
                                jivf.bucket_means, jivf.metadata.to_json(), device="cpu")
    ws, _ = jivf.top_k(jivf.encode_query(queries), 1100, method="exact", nscan=nb)
    gs, _ = carried.top_k(carried.encode_query(queries), 1100, method="exact", nscan=nb)
    live = np.asarray(ws) > -1e38
    np.testing.assert_allclose(gs[live], np.asarray(ws)[live], rtol=1e-5, atol=1e-4)
    assert (gs[~live] <= -1e38).all()


def test_jax_queries_search_equal(rng):
    """The JAX package's own query arrays, handed to the port's search,
    give the port's results (the query is all the search needs)."""
    data, queries = res_corpus(rng, 2000)
    jivf = j_ivf.IVFIndex.encode(data, _jparams(2000), quantizer="bq", nlist=4,
                                 bucket_size=512, residual=True)
    tivf = qt.ivf_from_numpy((np.asarray(jivf.quantizer.planes),
                              jivf.quantizer.metadata.to_json(), jivf.quantizer.store_type),
                             jivf.bucket_ids, jivf.bucket_means, jivf.metadata.to_json(),
                             device="cpu")
    jq, jeq = jivf.encode_query(queries)
    eq = (torch.from_numpy(np.array(jq)), t_ivf._ResidualQueryBQ(
        *(torch.from_numpy(np.array(getattr(jeq, n))) for n in ("codes", "mult", "qb"))))
    a = tivf.top_k(eq, K, method="exact")
    b = tivf.top_k(tivf.encode_query(queries), K, method="exact")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
