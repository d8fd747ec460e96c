"""The port's PQ codec ops (``ops/pq``, ``ops/kmeans``, ``ops/opq``) against
the JAX package's, fed the same seeded numpy inputs.

Tolerances, with their causes:
  * LUTs and centroid tables: rtol 1e-6. Both compute x.c at full f32, but
    their matmuls sum in different orders.
  * codes: byte-equal but for near-ties: where the two disagree, the two
    centroids' squared distances, recomputed in f64, agree within 1e-5
    relative (the distance matmuls round differently).
  * one Lloyd iteration: assignments equal, centroids within 1e-6; a whole
    k-means run on well-separated data: centroids within 1e-5, with the same
    reseed stream (the block and group structure is the JAX package's).
  * ``pca_allocation_init``: bit-equal (the same numpy code).
  * ``train_opq``: an orthogonal rotation whose quantization error is within
    1 % of the JAX package's (the SVDs see inputs that differ in the last
    bits, so the rotations drift apart over the outer iterations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.kmeans as j_kmeans
import quantization_tpu.ops.opq as j_opq
import quantization_tpu.ops.pq as j_pq
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import kmeans as t_kmeans
from quantization_tpu_torch.ops import opq as t_opq
from quantization_tpu_torch.ops import pq as t_pq

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dim,chunk", [(30, 8), (32, 4), (7, 3)])
def test_chunking_helpers_equal_jax(rng, dim, chunk):
    div = t_pq.get_vector_division(dim, chunk)
    assert div == j_pq.get_vector_division(dim, chunk)
    x = rng.standard_normal((9, dim)).astype(np.float32)
    np.testing.assert_array_equal(t_pq.chunk_tensor(x, div), j_pq.chunk_tensor(x, div))
    np.testing.assert_array_equal(t_pq.chunk_rows_device(_t(x), div).numpy(),
                                  np.asarray(j_pq.chunk_rows_device(jnp.asarray(x), div)))
    c = rng.standard_normal((5, dim)).astype(np.float32)
    chunks = t_pq.centroids_to_chunks(c, div)
    np.testing.assert_array_equal(chunks, j_pq.centroids_to_chunks(c, div))
    np.testing.assert_array_equal(t_pq.chunks_to_centroids(chunks, div, dim), c)
    for m, n, k in ((96, 10000, 256), (192, 16384, 16), (3, 10, 256)):
        assert t_kmeans.group_size(m, n, k) == j_kmeans.group_size(m, n, k)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("dt", ["Dot", "L1", "L2"])
def test_build_lut_equal_jax(rng, dt, invert):
    m, q, k, d = 6, 5, 256, 8
    qc = rng.standard_normal((m, q, d)).astype(np.float32)
    cc = rng.standard_normal((m, k, d)).astype(np.float32)
    want = np.asarray(j_pq.build_lut(jnp.asarray(qc), jnp.asarray(cc),
                                     distance_type=j_types.DistanceType.from_json(dt),
                                     invert=invert))
    got = t_pq.build_lut(_t(qc), _t(cc), distance_type=DistanceType.from_json(dt),
                         invert=invert)
    assert tuple(got.shape) == (q, m, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the centroid-distance table and internal scores, the same way
    wt = np.asarray(j_pq.centroid_distance_table(
        jnp.asarray(cc), distance_type=j_types.DistanceType.from_json(dt), invert=invert))
    gt = t_pq.centroid_distance_table(_t(cc), distance_type=DistanceType.from_json(dt),
                                      invert=invert)
    np.testing.assert_allclose(gt.numpy(), wt, rtol=1e-6, atol=1e-6 * np.abs(wt).max())
    a = rng.integers(0, k, (7, m)).astype(np.uint8)
    b = rng.integers(0, k, (7, m)).astype(np.uint8)
    np.testing.assert_allclose(
        t_pq.score_internal_lut(gt, _t(a), _t(b)).numpy(),
        np.asarray(j_pq.score_internal_lut(jnp.asarray(wt), jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-5)


def test_score_lut_equal_jax(rng):
    """The f32-LUT scan sums chunks in order in both packages: bit-equal;
    candidate scores (a sum over the chunk axis) to rtol 1e-6."""
    q, m, k, n = 4, 12, 256, 300
    lut = rng.standard_normal((q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    np.testing.assert_array_equal(
        t_pq.score_lut(_t(lut), _t(codes)).numpy(),
        np.asarray(j_pq.score_lut_xla(jnp.asarray(lut), jnp.asarray(codes))))
    cand = rng.integers(0, n, (q, 9)).astype(np.int32)
    np.testing.assert_allclose(
        t_pq.score_candidates_lut(_t(lut), _t(codes), _t(cand)).numpy(),
        np.asarray(j_pq.score_candidates_lut(jnp.asarray(lut), jnp.asarray(codes),
                                             jnp.asarray(cand))),
        rtol=1e-6, atol=1e-5)


def assert_codes_equal_but_near_ties(got, want, x_chunks, c_chunks, rel=1e-5):
    """got/want u8 [B, m]: equal, or the two centroids are at squared
    distances (f64) within ``rel`` of each other."""
    bad = np.argwhere(got != want)
    x = np.asarray(x_chunks, np.float64)
    c = np.asarray(c_chunks, np.float64)
    for b, ci in bad:
        d1 = np.sum((x[ci, b] - c[ci, got[b, ci]]) ** 2)
        d2 = np.sum((x[ci, b] - c[ci, want[b, ci]]) ** 2)
        assert abs(d1 - d2) <= rel * max(d1, d2, 1e-30), (b, ci, d1, d2)
    return len(bad)


@pytest.mark.parametrize("k,d", [(256, 8), (16, 4), (256, 3)])
def test_encode_batch_equal_jax_but_near_ties(rng, k, d):
    m, b = 12, 700
    x = rng.standard_normal((m, b, d)).astype(np.float32)
    c = rng.standard_normal((m, k, d)).astype(np.float32)
    want = np.asarray(j_pq.encode_batch(jnp.asarray(x), jnp.asarray(c)))
    got = t_pq.encode_batch(_t(x), _t(c))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, m)
    assert assert_codes_equal_but_near_ties(got.numpy(), want, x, c) <= b * m // 1000


def test_lloyd_iteration_equal_jax(rng):
    g, n, k, d = 3, 900, 16, 6
    data = rng.standard_normal((g, n, d)).astype(np.float32)
    cents = data[:, :k].copy()
    cents[1, 3] = 50.0  # a centroid nobody picks: reseeded from its row
    reseed = rng.integers(0, n, (g, k))
    frozen = np.array([False, False, True])
    jc, jd = j_kmeans._lloyd_iteration(jnp.asarray(cents), jnp.asarray(data),
                                       jnp.asarray(reseed, jnp.int32), jnp.asarray(frozen))
    tc, td = t_kmeans.lloyd_iteration(_t(cents), _t(data), _t(reseed), _t(frozen))
    j_assign = np.asarray(j_pq._encode_group(jnp.asarray(data), jnp.asarray(cents)))
    t_assign = torch.argmin(t_pq.sq_distances(_t(data), _t(cents)), dim=2).numpy()
    np.testing.assert_array_equal(t_assign, j_assign)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy()[1, 3], data[1, reseed[1, 3]])
    np.testing.assert_array_equal(tc.numpy()[2], cents[2])  # frozen


def _separated(rng, m, n, k, d, seed, t):
    """Chunks of k well-separated clusters whose k-means run is free of
    near-ties: rows 0..k-1 (the first-k init) hold one row of each cluster
    but cluster j, whose init row duplicates row 0, so centroid j is empty
    after the first assignment and is reseeded from row rr, which lies in
    cluster j. rr is the first reseed draw, np.random.default_rng(seed)
    .integers(0, n, (t, m, k))[0, c, j] (one group of m chunks). Every
    cluster then holds one centroid, and the two packages' runs differ only
    by the rounding of the means."""
    rr = np.random.default_rng(seed).integers(0, n, (t, m, k))[0]
    centers = rng.standard_normal((m, k, d)).astype(np.float32) * 3
    x = np.empty((m, n, d), np.float32)
    for c in range(m):
        j = next(j for j in range(1, k) if rr[c, j] >= k)
        lab = rng.integers(0, k, n)
        lab[:k] = np.arange(k)
        lab[lab == j] = 0
        lab[rr[c, j]] = j
        x[c] = centers[c, lab] + rng.standard_normal((n, d)).astype(np.float32) * 0.05
        x[c, j] = x[c, 0]
    return x


@pytest.mark.parametrize("stop", [False, True])
def test_kmeans_batched_equal_jax(rng, stop):
    m, n, k, d, seed = 5, 600, 16, 4, 3
    kw = dict(max_iterations=30, accuracy=1e-5, seed=seed)
    if stop:
        kw["stop_condition"] = lambda: False  # one iteration per block
    data = _separated(rng, m, n, k, d, seed, t=1 if stop else 10)
    want = np.asarray(j_kmeans.kmeans_batched(jnp.asarray(data), k, **kw))
    got = t_kmeans.kmeans_batched(_t(data), k, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the reseed fired: no centroid sits on the duplicated init row
    assert not any((got.numpy()[c] == data[c, 0]).all(axis=1).sum() > 1 for c in range(m))


def test_kmeans_groups_and_warm_start_equal_jax(rng, monkeypatch):
    """Several groups with a ragged tail (chunks duplicated to whole groups,
    as in the JAX package), a warm start, and a group that converges before
    the others (its later reseed draws are skipped in both)."""
    m, n, k, d = 7, 300, 16, 3
    centers = rng.standard_normal((m, k, d)).astype(np.float32) * 3
    lab = rng.integers(0, k, (m, n))
    lab[:, :k] = np.arange(k)
    data = (centers[np.arange(m)[:, None], lab]
            + rng.standard_normal((m, n, d)).astype(np.float32) * 0.05)
    init = data[:, :k].copy()
    init[:3] = centers[:3]  # the first group starts near its optimum
    for mod in (j_kmeans, t_kmeans):
        monkeypatch.setattr(mod, "group_size", lambda m, n, k: 3)
    want = np.asarray(j_kmeans.kmeans_batched(jnp.asarray(data), k, max_iterations=25,
                                              seed=1, init=jnp.asarray(init)))
    got = t_kmeans.kmeans_batched(_t(data), k, max_iterations=25, seed=1, init=_t(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pca_allocation_init_bit_equal(rng):
    x = (rng.standard_normal((400, 24)) @ rng.standard_normal((24, 24))).astype(np.float32)
    div = t_pq.get_vector_division(24, 8)
    np.testing.assert_array_equal(t_opq.pca_allocation_init(x, div),
                                  j_opq.pca_allocation_init(x, div))


def _quant_error(x, rot, centroids, div):
    xr = (x.astype(np.float64) @ rot.astype(np.float64)).astype(np.float32)
    xc = t_pq.chunk_tensor(xr, div)
    cc = t_pq.centroids_to_chunks(centroids, div)
    codes = t_pq.encode_batch(_t(xc), _t(cc))
    rec = t_opq.reconstruct_rows(codes, _t(cc), x.shape[1]).numpy()
    return float(np.mean(np.sum((xr - rec) ** 2, axis=1)))


def test_train_opq_close_to_jax(rng):
    n, dim, k = 1200, 16, 16
    x = (rng.standard_normal((n, dim)) @ rng.standard_normal((dim, dim))).astype(np.float32)
    div = t_pq.get_vector_division(dim, 4)
    kw = dict(seed=0, outer_iterations=3, inner_iterations=5, final_iterations=20)
    jr, jcent = j_opq.train_opq(x, div, k, **kw)
    tr, tcent = t_opq.train_opq(x, div, k, **kw)
    assert tr.dtype == np.float32 and tr.shape == (dim, dim)
    np.testing.assert_allclose(tr @ tr.T, np.eye(dim), atol=1e-5)
    e_j = _quant_error(x, np.asarray(jr), np.asarray(jcent), div)
    e_t = _quant_error(x, tr, tcent, div)
    assert abs(e_t - e_j) <= 0.01 * e_j, (e_t, e_j)
    # the rotation helps: below plain PQ's error on the same sample
    plain = t_kmeans.kmeans_batched(_t(t_pq.chunk_tensor(x, div)), k, max_iterations=20)
    e_plain = _quant_error(x, np.eye(dim, dtype=np.float32),
                           t_pq.chunks_to_centroids(plain.numpy(), div, dim), div)
    assert e_t < e_plain
