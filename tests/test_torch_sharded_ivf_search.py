"""The port's ShardedIVF probe-limited searches against the JAX package's and
against its own single-device IVFIndex, on the CPU: the cases of
tests/test_sharded_ivf.py that scan part of the buckets (probe-limited
recall, methods and arguments, indexed == compact, the fully distributed
two-stage) and save/load, on S = 1, 3 and 8 shards; the meshes, carried
state and tolerances are tests/torch_sharded_ivf_cases.py's."""

import warnings

import numpy as np
import pytest
import torch

import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.models.pipeline as j_pipeline
import quantization_tpu.parallel.sharded as j_sharded
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from quantization_tpu_torch.parallel import sharded_ivf as t_sivf
from quantization_tpu_torch.utils import fallback
from test_sharded_ivf import gt_topk, recall
from test_torch_sharded_ivf import distinct, searches
from torch_sharded_cases import SHARDS, meshes
from torch_sharded_ivf_cases import (
    DIM, FULL, K, carry, clustered, jparams, res_corpus, same_as_jax, tparams, wrapped_ivf,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


@pytest.mark.parametrize("s", SHARDS)
def test_probe_limited_recall_narrow_le_wide(rng, s):
    """The per-shard quota scans ceil(nscan / S) of each shard's buckets, a
    union at least as wide as one device's: recall lands in its regime and
    widens with nscan. The JAX package picks the same buckets on the same
    layout, so the narrow searches agree too."""
    count = 2000
    data = clustered(rng, count, clusters=32)
    queries = clustered(rng, 16, clusters=32)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer="sq", nlist=32, bucket_size=64,
                                 nprobe=8)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    gt = gt_topk(queries, data)
    want, single, narrow = searches(jsh, tivf, tsh, queries, nscan=32)
    wide = tsh.top_k(tsh.encode_query(queries), K, nscan=FULL)
    r1, r_narrow, r_wide = recall(single[1], gt), recall(narrow[1], gt), recall(wide[1], gt)
    assert r_wide >= r_narrow >= r1 - 0.15
    assert r_wide > 0.8
    same_as_jax(narrow, want, count, "sq")


@pytest.mark.parametrize("s", SHARDS)
def test_methods_and_arguments(rng, s):
    count = 512
    data, queries = clustered(rng, count), clustered(rng, 4)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count, "L2", True), quantizer="sq", nlist=8,
                                 bucket_size=64, nprobe=8)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    eq = tsh.encode_query(queries)
    sv_e, _ = tsh.top_k(eq, K, method="exact")
    sv_a, _ = tsh.top_k(eq, K, method="approx")
    # Inverted L2: every real score is negative; approx stays in range.
    assert np.all(sv_e[sv_e > -1e38] <= 1e-3)
    assert sv_a.shape == sv_e.shape
    for method in ("exact", "approx"):
        want = jsh.top_k(jsh.encode_query(queries), K, method=method)
        same_as_jax(tsh.top_k(eq, K, method=method), want, count, "sq")
    for bad in (dict(nprobe=-1), dict(scan="sideways"), dict(method="fast"),
                dict(recall_target=1.5)):
        with pytest.raises(qt.ArgumentsError):
            tsh.top_k(eq, K, **bad)
    with pytest.raises(qt.ArgumentsError):
        tsh.encode_query(queries[:, :5])
    # A mesh without the named axis.
    with pytest.raises(qt.ArgumentsError):
        t_sivf.ShardedIVF(tivf, meshes(s)[1], axis="rows")


@pytest.mark.parametrize("s", SHARDS)
def test_unfused_search_warns_as_the_single_device_index(rng, s, monkeypatch):
    """Both classes plan a search through one function (models/ivf.py
    ``_search_plan``): an L1 SQ search, which never fuses, warns with the
    rows it scans (on a mesh, each shard's ceil(nscan / S) buckets, on
    every shard); a fused search does not."""
    monkeypatch.setattr(fallback, "WARN_MIN_COUNT", 1)
    count, bsize, nscan = 512, 64, 3
    data, queries = clustered(rng, count), clustered(rng, 4)
    for dt, fused in ((qt.DistanceType.L1, False), (qt.DistanceType.DOT, True)):
        tivf = qt.IVFIndex.encode(data, qt.VectorParameters(DIM, count, dt, False),
                                  quantizer="sq", nlist=8, bucket_size=bsize, nprobe=2,
                                  nscan=nscan, device="cpu")
        tsh = t_sivf.ShardedIVF(tivf, meshes(s)[1])
        rows = (nscan * bsize, s * min(-(-nscan // s), tsh._b_loc) * bsize)
        for index, n in zip((tivf, tsh), rows):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                index.top_k(index.encode_query(queries), K)
            said = [str(w.message) for w in seen if issubclass(w.category, RuntimeWarning)]
            assert len(said) == (0 if fused else 1)
            if not fused:
                assert f"left the fused kernel path at N={n}:" in said[0]


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("kind,method", [("sq", "exact"), ("sq", "approx"), ("bq", "approx")])
def test_indexed_scan_equals_compact(rng, kind, method, s):
    """The per-shard indexed scan scores the same buckets as the per-shard
    compact scan: exact values equal; an approx scan's stride classes
    depend on the layout it walks, so each approx scan equals the JAX
    package's same scan instead. Sharded PQ has no indexed scan (it raises,
    as in the JAX package)."""
    count = 8 * 512
    data = clustered(rng, count, clusters=8, sigma=0.08)
    queries = clustered(rng, 8, clusters=8, sigma=0.08)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer=kind, nlist=8, bucket_size=512,
                                 nprobe=4)
    jsh, _, tsh = wrapped_ivf(jivf, s)
    eq = tsh.encode_query(queries)
    jeq = jsh.encode_query(queries)
    got = {scan: tsh.top_k(eq, K, method=method, scan=scan) for scan in ("indexed", "compact")}
    if method == "exact":
        np.testing.assert_array_equal(got["indexed"][0], got["compact"][0])
    for scan, res in got.items():
        distinct(res[1])
        same_as_jax(res, jsh.top_k(jeq, K, method=method, scan=scan), count, kind)
    jpq = j_ivf.IVFIndex.encode(data, jparams(count), quantizer="pq", nlist=8, bucket_size=1024,
                                nprobe=4, chunk_size=4)
    pq = t_sivf.ShardedIVF(carry(jpq), meshes(s)[1])
    with pytest.raises(qt.ArgumentsError):
        pq.top_k(pq.encode_query(queries), K, method="approx", scan="indexed")


@pytest.mark.parametrize("s", SHARDS)
def test_residual_indexed_scan_equals_compact(rng, s):
    data, queries = res_corpus(rng)
    count = data.shape[0]
    jivf = j_ivf.IVFIndex.encode(data, jparams(count, "L2", True), quantizer="sq", nlist=6,
                                 bucket_size=512, nprobe=4, residual=True)
    _, tivf, tsh = wrapped_ivf(jivf, s)
    eq = tsh.encode_query(queries)
    i_s, i_i = tsh.top_k(eq, K, scan="indexed")
    c_s, _ = tsh.top_k(eq, K, scan="compact")
    np.testing.assert_array_equal(i_s, c_s)
    distinct(i_i)


@pytest.mark.parametrize("s", SHARDS)
def test_fully_distributed_two_stage(rng, s):
    """ShardedIVF coarse -> ShardedExactRescorer fine, no single-device stage
    anywhere: recall against the f32 oracle at the index's nscan; with an
    exact coarse stage, the JAX package's sharded two-stage values at that
    nscan (the same per-shard unions), and at the full union the port's
    single-device two-stage result wherever the coarse candidates agree."""
    count = 2000
    data = clustered(rng, count, clusters=32)
    queries = clustered(rng, 16, clusters=32)
    jp = jparams(count)
    jivf = j_ivf.IVFIndex.encode(data, jp, quantizer="sq", nlist=32, bucket_size=64, nprobe=8,
                                 nscan=64)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    jm, tm = meshes(s)
    fine = t_sharded.ShardedExactRescorer(data, qt.DistanceType.DOT, False, tm)
    two = qt.TwoStageIndex(tsh, fine, oversampling=8.0)
    _, gi = two.top_k(two.encode_query(queries), K)
    assert recall(gi, gt_topk(queries, data)) > 0.8
    exact = qt.TwoStageIndex(tsh, fine, oversampling=8.0, coarse_method="exact")
    gs, _ = exact.top_k(exact.encode_query(queries), K)
    jtwo = j_pipeline.TwoStageIndex(jsh, j_sharded.ShardedExactRescorer(
        data, jp.distance_type, jp.invert, jm), oversampling=8.0, coarse_method="exact")
    js, _ = jtwo.top_k(jtwo.encode_query(queries), K)
    np.testing.assert_allclose(gs, np.asarray(js), rtol=1e-5, atol=1e-4)
    tsh.metadata.nscan = FULL  # the wrapped index shares the single-device metadata
    single = qt.TwoStageIndex(tivf, qt.ExactRescorer(data, qt.DistanceType.DOT, False,
                                                     device="cpu"),
                              oversampling=8.0, coarse_method="exact")
    _, cand = tsh.top_k(tsh.encode_query(queries), 8 * K)
    _, cand1 = tivf.top_k(tivf.encode_query(queries), 8 * K)
    agree = np.all(np.sort(cand, 1) == np.sort(cand1, 1), axis=1)
    assert agree.sum() >= len(queries) - 1
    gs, _ = exact.top_k(exact.encode_query(queries), K)
    ws, _ = single.top_k(single.encode_query(queries), K)
    np.testing.assert_array_equal(gs[agree], ws[agree])


@pytest.mark.parametrize("s", SHARDS)
def test_save_load_roundtrip(rng, s, tmp_path):
    count = 600
    data, queries = clustered(rng, count), clustered(rng, 8)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer="sq", nlist=8, bucket_size=64,
                                 nprobe=8)
    _, _, tsh = wrapped_ivf(jivf, s)
    dp, mp = tmp_path / "ivf.data", tmp_path / "ivf.meta"
    tsh.save(dp, mp)
    back = t_sivf.ShardedIVF.load(dp, mp, tparams(jparams(count)), mesh=meshes(s)[1])
    for method in ("exact", "approx"):
        a = tsh.top_k(tsh.encode_query(queries), K, method=method, nscan=FULL)
        b = back.top_k(back.encode_query(queries), K, method=method, nscan=FULL)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
