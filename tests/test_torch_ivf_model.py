"""The port's IVFIndex against the JAX package's, end to end on the CPU:
build, the batch union, the indexed and compact scans (SQ, PQ, OPQ, 4-bit
PQ, BQ; plain and residual SQ / PQ; exact and approx), the chunked indexed
scan, the dedupe, checkpoints in both directions, TwoStageIndex over an IVF
coarse stage, and the residual-BQ cut.

The JAX side runs its fused kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1, as tests/test_ivf.py does); the port's wrappers take
their plain versions for CPU tensors. Search is compared on one index, the
JAX package's, carried across by ``ivf_from_numpy``, so build-time
near-ties cannot hide a search bug. Tolerances, with their causes:
  * exact and approx values: rtol 1e-5 / atol 1e-4 — the SQ epilogue (see
    tests/test_torch_sq_kernels.py), the int8-LUT epilogue (ROADMAP Queue 3,
    F14) and the residual bucket term, an f32 product of data-scale vectors
    summed in another order;
  * ids: equal where the JAX value is untied (BQ scores tie in droves: there
    the values are compared, and the ids must be distinct corpus rows);
  * build: equal bucket ids, means and SQ / BQ codes on well-separated
    clusters (assignment near-ties may flip otherwise, ROADMAP F21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.models.pipeline as j_pipeline
import quantization_tpu_torch as qt
from quantization_tpu_torch.models import ivf as t_ivf
from quantization_tpu_torch.ops.kernels import bq_kernel, pq_kernel, sq_kernel
from torch_ivf_cases import (
    DIM, K, N, assert_search_matches, carry, clustered, index, inner_state, jparams,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


@pytest.mark.parametrize("name", ["sq", "sq_res_l2", "opq_res_l2"])
def test_batch_union_equals_jax(built, name):
    jivf, tivf, queries, _ = index(built, name)
    q = torch.from_numpy(queries)
    means = torch.from_numpy(jivf.bucket_means)
    dt = tivf.params.distance_type
    for p, u in ((1, 2), (3, 5), (2, jivf.metadata.nbuckets)):
        jprio = j_ivf._bucket_priority(jnp.asarray(queries), jnp.asarray(jivf.bucket_means),
                                       jivf.params.distance_type, jivf.params.invert, p)
        _, jun = jax.lax.top_k(jprio, u)
        prio = t_ivf._bucket_priority(q, means, dt, tivf.params.invert, p)
        _, tun = t_ivf._stable_top(prio, u)
        assert set(tun.tolist()) == set(np.asarray(jun).tolist())
        np.testing.assert_allclose(prio.numpy(), np.asarray(jprio), rtol=1e-6, atol=1e-6)


def test_dedupe_select_equals_jax(rng):
    """Duplicated ids keep their best copy, ids < 0 and repeats are poisoned,
    ties reselect in index order, and empty slots hold NEG / -1 in both
    packages (ROADMAP Queue 3, F20: the JAX package's -3e38, not the -inf
    of the fused exact search)."""
    nq, kk2 = 6, 12
    sv = np.round(rng.standard_normal((nq, kk2)) * 2).astype(np.float32)  # many ties
    ids = rng.integers(-1, 7, (nq, kk2)).astype(np.int32)
    ids[0] = -1  # a row with no live candidate
    sv[1, :] = np.float32(-np.inf)
    for k in (3, 12, 15):
        ws, wi = j_ivf._dedupe_select(jnp.asarray(sv), jnp.asarray(ids), nq, k, kk2)
        gs, gi = t_ivf._dedupe_select(torch.from_numpy(sv), torch.from_numpy(ids), nq, k,
                                      kk2)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert (gs.numpy()[0] == np.float32(t_ivf.NEG)).all() and (gi.numpy()[0] == -1).all()


@pytest.mark.parametrize("name,method", [("sq", "exact"), ("sq", "approx"),
                                         ("bq", "approx"), ("pq_res", "approx")])
def test_chunked_indexed_scan_matches_unchunked(built, monkeypatch, name, method):
    """Tile lists past _INDEXED_CHUNK_TILES are scanned in chunks and merged
    exactly (forced here with 2-tile chunks over the full probe): the same
    values, no id twice, and for SQ the same ids."""
    _, tivf, queries, _ = index(built, name)
    eq = tivf.encode_query(queries)
    kw = dict(method=method, scan="indexed", nprobe=tivf.metadata.nbuckets,
              nscan=tivf.metadata.nbuckets)
    us, ui = tivf.top_k(eq, K, **kw)
    monkeypatch.setattr(t_ivf, "_INDEXED_CHUNK_TILES", 2)
    calls = []
    real = t_ivf._scan_tiles_indexed
    monkeypatch.setattr(t_ivf, "_scan_tiles_indexed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cs, ci = tivf.top_k(eq, K, **kw)
    assert len(calls) > 1
    np.testing.assert_allclose(cs, us, rtol=1e-6, atol=1e-5)
    for row in ci:
        assert len(set(row.tolist())) == K
    if name == "sq" and method == "exact":
        np.testing.assert_array_equal(ci, ui)


def test_merge_chunks_keeps_each_candidate_once():
    from quantization_tpu_torch.ops.kernels.ktile import merge_chunks

    a = (torch.tensor([[5.0, 3.0, -np.inf]]), torch.tensor([[7, 2, -1]]))
    b = (torch.tensor([[4.0, 1.0, 0.5]]), torch.tensor([[9, 8, 3]]))
    s, i = merge_chunks([a, b], 4, neg=t_ivf.NEG)
    np.testing.assert_array_equal(s.numpy(), [[5.0, 4.0, 3.0, 1.0]])
    np.testing.assert_array_equal(i.numpy(), [[7, 9, 2, 8]])
    s, i = merge_chunks([a], 3, neg=t_ivf.NEG)
    assert i.tolist() == [[7, 2, -1]] and float(s[0, 2]) == np.float32(t_ivf.NEG)


def test_build_matches_jax(rng):
    """On well-separated clusters, with the first rows one per cluster and
    the sample the whole corpus (so k-means starts from a centre per
    cluster), the port builds the JAX package's index: bucket ids, means,
    and the inner SQ codes and offsets; BQ planes likewise."""
    clusters, n = 8, 500
    centers = rng.standard_normal((clusters, DIM)).astype(np.float32) * 4
    assign = rng.integers(0, clusters, n)
    assign[:clusters] = np.arange(clusters)
    data = (centers[assign] + 0.05 * rng.standard_normal((n, DIM))).astype(np.float32)
    for kind, residual in (("sq", False), ("sq", True), ("bq", False)):
        jivf = j_ivf.IVFIndex.encode(data, jparams("Dot", False, n), quantizer=kind,
                                     nlist=clusters, bucket_size=512 if residual else 64,
                                     residual=residual)
        tivf = qt.IVFIndex.encode(data, qt.VectorParameters(DIM, n, qt.DistanceType.DOT, False),
                                  quantizer=kind, nlist=clusters,
                                  bucket_size=512 if residual else 64, residual=residual,
                                  device="cpu")
        np.testing.assert_array_equal(tivf.bucket_ids, jivf.bucket_ids)
        np.testing.assert_allclose(tivf.bucket_means, jivf.bucket_means, atol=1e-6)
        assert tivf.metadata.to_json() == jivf.metadata.to_json()
        state, want = qt.ivf_to_numpy(tivf)[0], inner_state(jivf)
        for got_a, want_a in zip(state[:-1], want[:-1]):
            np.testing.assert_array_equal(np.asarray(got_a).view(np.asarray(want_a).dtype),
                                          np.asarray(want_a))


def test_build_pq_matches_jax(rng):
    """PQ under IVF: the same buckets; codes equal but for k-means near-ties
    of the two packages' centroids (under 1 %)."""
    clusters, n = 8, 500
    centers = rng.standard_normal((clusters, DIM)).astype(np.float32) * 4
    assign = rng.integers(0, clusters, n)
    assign[:clusters] = np.arange(clusters)
    data = (centers[assign] + 0.05 * rng.standard_normal((n, DIM))).astype(np.float32)
    kw = dict(quantizer="pq", nlist=clusters, bucket_size=64, chunk_size=8)
    jivf = j_ivf.IVFIndex.encode(data, jparams("Dot", False, n), **kw)
    tivf = qt.IVFIndex.encode(data, qt.VectorParameters(DIM, n, qt.DistanceType.DOT, False),
                              device="cpu", **kw)
    np.testing.assert_array_equal(tivf.bucket_ids, jivf.bucket_ids)
    m = tivf.quantizer.num_chunks
    got = tivf.quantizer.codes[:, :m].numpy()
    want = np.asarray(jivf.quantizer.codes)[:, :m]
    assert (got != want).mean() < 0.01


@pytest.mark.parametrize("name", ["sq_res_l2", "pq_res", "bq", "pq", "bq_res"])
def test_checkpoints_load_across_packages(built, force_pallas, tmp_path, name):
    jivf, tivf, queries, _ = index(built, name)
    tparams = qt.VectorParameters.from_json(jivf.params.to_json())
    # JAX -> port
    jivf.save(tmp_path / "j.bin", tmp_path / "j.json")
    back = qt.IVFIndex.load(tmp_path / "j.bin", tmp_path / "j.json", tparams, device="cpu")
    want = tivf.top_k(tivf.encode_query(queries), K, method="approx")
    got = back.top_k(back.encode_query(queries), K, method="approx")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # port -> JAX
    tivf.save(tmp_path / "t.bin", tmp_path / "t.json")
    jback = j_ivf.IVFIndex.load(tmp_path / "t.bin", tmp_path / "t.json", jivf.params)
    np.testing.assert_array_equal(jback.bucket_ids, jivf.bucket_ids)
    for a, b in zip(inner_state(jback)[:-1], inner_state(jivf)[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ws, _ = jback.top_k(jback.encode_query(queries), K, method="approx")
    np.testing.assert_allclose(want[0], np.asarray(ws), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["sq", "pq4_res", "bq", "bq_res"])
def test_auto_scan_and_wide_union(built, force_pallas, name):
    """scan="auto" and a union of every bucket (the full probe), exact for
    SQ, approx for the others."""
    jivf, tivf, queries, _ = index(built, name)
    method = "exact" if name == "sq" else "approx"
    nb = jivf.metadata.nbuckets
    ws, wi = jivf.top_k(jivf.encode_query(queries), K, method=method, nprobe=nb)
    gs, gi = tivf.top_k(tivf.encode_query(queries), K, method=method, nprobe=nb)
    assert_search_matches(gs, gi, np.asarray(ws), np.asarray(wi), N,
                          ties=name.startswith("bq"))


@pytest.mark.parametrize("name", ["sq", "opq_res_l2"])
def test_two_stage_over_ivf_matches_jax(built, force_pallas, name):
    jivf, tivf, queries, data = index(built, name)
    dt, inv = jivf.params.distance_type, jivf.params.invert
    jtwo = j_pipeline.TwoStageIndex(jivf, j_pipeline.ExactRescorer(data, dt, inv),
                                    oversampling=4.0)
    ttwo = qt.TwoStageIndex(tivf, qt.ExactRescorer(data, tivf.params.distance_type, inv,
                                                   device="cpu"), oversampling=4.0)
    ws, wi = jtwo.top_k(jtwo.encode_query(queries), K)
    gs, gi = ttwo.top_k(ttwo.encode_query(queries), K)
    assert_search_matches(gs, gi, np.asarray(ws), np.asarray(wi), N, ties=False)


def test_residual_bq_raises(built, rng, tmp_path):
    """Residual IVF-BQ raises only where the JAX package's does: with L2
    (no per-slot |v^|^2 carrier in the planes) and without its beta; a JAX
    residual-BQ index carries across and loads, residual_scale included."""
    data = clustered(rng, 1200)
    with pytest.raises(qt.ArgumentsError, match="DOT only"):
        qt.IVFIndex.encode(data, qt.VectorParameters(DIM, 1200, qt.DistanceType.L2, False),
                           quantizer="bq", residual=True, nlist=2, bucket_size=512,
                           device="cpu")
    jivf = j_ivf.IVFIndex.encode(data, jparams("Dot", False, 1200), quantizer="bq",
                                 residual=True, nlist=2, bucket_size=512)
    tivf = carry(jivf)
    assert tivf.metadata.residual_scale == jivf.metadata.residual_scale > 0
    params = qt.VectorParameters(DIM, 1200, qt.DistanceType.DOT, False)
    jivf.save(tmp_path / "r.bin", tmp_path / "r.json")
    back = qt.IVFIndex.load(tmp_path / "r.bin", tmp_path / "r.json", params, device="cpu")
    assert back.metadata.to_json() == jivf.metadata.to_json()
    queries = clustered(rng, 4)
    a = tivf.top_k(tivf.encode_query(queries), K)
    b = back.top_k(back.encode_query(queries), K)
    np.testing.assert_array_equal(a[0], b[0])
    meta = dict(jivf.metadata.to_json())
    del meta["residual_scale"]
    with pytest.raises(qt.ArgumentsError, match="residual_scale"):
        qt.ivf_from_numpy(inner_state(jivf), jivf.bucket_ids, jivf.bucket_means, meta,
                          device="cpu")


def test_compact_pq_scan_reads_the_layout_it_has(built, force_pallas):
    """ROADMAP Queue 3, F2, resolved: a compact PQ scan gathers the union's
    rows from whichever code layout the quantizer holds and never builds the
    other full copy; an indexed scan needs (and builds) the transposed one."""
    jivf, tivf, queries, _ = index(built, "pq_res")
    want = tivf.top_k(tivf.encode_query(queries), K, method="exact", scan="compact")
    qz = tivf.quantizer
    transposed = qt.ProductQuantizer.from_transposed(qz.codes_t.clone(), qz.metadata)
    rows = qt.ProductQuantizer(qz.codes.clone(), qz.metadata)
    for inner, missing in ((transposed, "_codes"), (rows, "_codes_t")):
        ivf = qt.IVFIndex(inner, tivf.bucket_ids, tivf.bucket_means, tivf.metadata)
        for method in ("exact", "approx"):
            got = ivf.top_k(ivf.encode_query(queries), K, method=method, scan="compact")
            assert getattr(inner, missing) is None
        np.testing.assert_array_equal(
            ivf.top_k(ivf.encode_query(queries), K, method="exact", scan="compact")[0],
            want[0])
    ivf.top_k(ivf.encode_query(queries), K, method="approx", scan="indexed")
    assert rows._codes_t is not None


@pytest.mark.parametrize("count", [1, 100, 767, 768, 5000, 24_576, 100_000, 1_000_000])
def test_auto_geometry_matches_jax(count):
    for residual in (False, True):
        assert t_ivf.auto_geometry(count, residual) == j_ivf.auto_geometry(count, residual)


def test_argument_errors(built, rng):
    _, tivf, queries, data = index(built, "pq")
    eq = tivf.encode_query(queries)
    with pytest.raises(qt.ArgumentsError):
        tivf.top_k(eq, K, scan="sideways")
    with pytest.raises(qt.ArgumentsError):
        tivf.top_k(eq, K, method="fast")
    with pytest.raises(qt.ArgumentsError):
        tivf.top_k(eq, K, method="exact", scan="indexed")  # PQ indexed is approx only
    with pytest.raises(qt.ArgumentsError):
        tivf.encode_query(queries[:, :5])
    params = qt.VectorParameters(DIM, N, qt.DistanceType.L1, False)
    with pytest.raises(qt.ArgumentsError):
        qt.IVFIndex.encode(data, params, residual=True, device="cpu")
    params = qt.VectorParameters(DIM, N, qt.DistanceType.DOT, False)
    with pytest.raises(qt.ArgumentsError):
        qt.IVFIndex.encode(data, params, residual=True, bucket_size=256, device="cpu")
    small = qt.IVFIndex.encode(data, params, nlist=4, bucket_size=64, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        small.top_k(small.encode_query(queries), K, scan="indexed")


def test_cpu_search_never_touches_the_library(built, monkeypatch):
    from quantization_tpu_torch.ops.kernels import build

    def refuse():
        raise AssertionError("CPU tensors must not build or load the kernels")

    for mod in (build, sq_kernel, bq_kernel, pq_kernel):
        monkeypatch.setattr(mod, "load_library", refuse)
    for name in ("sq_res_l2", "pq_res", "bq"):
        _, tivf, queries, _ = index(built, name)
        for method in ("exact", "approx"):
            tivf.top_k(tivf.encode_query(queries), K, method=method)
