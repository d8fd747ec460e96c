"""The whole SQ slice against the JAX package: the port's ScalarQuantizerU8
and the JAX one, encoded from the same seeded data (3000 x 256, 8 queries,
k = 10), agree on codes (byte-equal), score_batch, top_k (exact and approx),
score_points, score_candidates and score_internal; state and checkpoints
cross between the packages in both directions.

The JAX side runs its fused search kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1, as tests/test_pallas_model_path.py does). Tolerances:
scores rtol 1e-6 / atol 1e-4; exact top-k ids equal where untied; approx
pairs are true (score, id) pairs with overlap >= 0.8 against exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.sq as j_model
import quantization_tpu_torch as qt
from quantization_tpu_torch.interop import sq_from_numpy, sq_to_numpy

torch.set_num_threads(1)

N, DIM, Q, K = 3000, 256, 8, 10
RTOL, ATOL = 1e-6, 1e-4


@pytest.fixture
def pair(rng, request, monkeypatch):
    """(jax quantizer, port quantizer, queries) for one distance type."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    dt, invert = request.param
    data = (rng.random((N, DIM), dtype=np.float32) * 2 - 1).astype(np.float32)
    queries = (rng.random((Q, DIM), dtype=np.float32) * 2 - 1).astype(np.float32)
    jparams = j_types.VectorParameters(DIM, N, j_types.DistanceType.from_json(dt), invert)
    jenc = j_model.ScalarQuantizerU8.encode(data, jparams)
    tenc = qt.ScalarQuantizerU8.encode(
        data, qt.VectorParameters.from_json(jparams.to_json()), device="cpu"
    )
    return jenc, tenc, queries


CASES = [("Dot", False), ("L2", False), ("L2", True)]
with_pair = pytest.mark.parametrize("pair", CASES, indirect=True, ids=["dot", "l2", "l2-inv"])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _untied(row):
    """Positions of a sorted top-k row whose value occurs once in it and is
    not the k-th value (which may tie with rows beyond k)."""
    vals, counts = np.unique(row, return_counts=True)
    return np.isin(row, vals[counts == 1]) & (row != row[-1])


@with_pair
def test_codes_and_metadata_equal(pair):
    jenc, tenc, queries = pair
    assert tenc.metadata.to_json() == jenc.metadata.to_json()
    np.testing.assert_array_equal(tenc.codes.numpy(), np.asarray(jenc.codes))
    np.testing.assert_array_equal(tenc.voffsets.numpy(), np.asarray(jenc.voffsets))
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.offsets.numpy(), np.asarray(jq.offsets))


@with_pair
def test_score_batch(pair):
    jenc, tenc, queries = pair
    got = tenc.score_batch(tenc.encode_query(queries))
    assert tuple(got.shape) == (Q, N)
    _close(got, jenc.score_batch(jenc.encode_query(queries)))


@with_pair
def test_top_k_exact(pair):
    jenc, tenc, queries = pair
    ws, wi = jenc.top_k(jenc.encode_query(queries), K)
    gs, gi = tenc.top_k(tenc.encode_query(queries), K)
    assert gs.shape == (Q, K) and gi.dtype == np.int32
    _close(gs, ws)
    scores = tenc.score_batch(tenc.encode_query(queries)).numpy()
    for r in range(Q):
        untied = _untied(ws[r])
        np.testing.assert_array_equal(gi[r][untied], wi[r][untied])
        _close(scores[r, gi[r]], gs[r])


@with_pair
def test_top_k_approx(pair):
    jenc, tenc, queries = pair
    eq = tenc.encode_query(queries)
    gs, gi = tenc.top_k(eq, K, method="approx")
    ws, wi = jenc.top_k(jenc.encode_query(queries), K, method="approx")
    _close(gs, ws)  # same candidates; JAX's approx_max_k is exact on the CPU
    scores = tenc.score_batch(eq).numpy()
    _, ei = tenc.top_k(eq, K)
    for r in range(Q):
        _close(scores[r, gi[r]], gs[r])
        assert len(set(gi[r].tolist()) & set(ei[r].tolist())) / K >= 0.8


@with_pair
def test_score_points_candidates_internal(pair, rng):
    jenc, tenc, queries = pair
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    ids = rng.integers(0, N, 13)
    _close(tenc.score_points(tq, ids), jenc.score_points(jq, ids))
    cand = rng.integers(0, N, (Q, 7)).astype(np.int32)
    _close(tenc.score_candidates(tq, cand), jenc.score_candidates(jq, jnp.asarray(cand)))
    a, b = rng.integers(0, N, 9), rng.integers(0, N, 9)
    _close(tenc.score_internal_batch(a, b), jenc.score_internal_batch(a, b))
    assert tenc.score_internal(5, 17) == pytest.approx(jenc.score_internal(5, 17), rel=RTOL, abs=ATOL)
    assert tenc.score_point(tq, 3) == pytest.approx(
        float(np.asarray(tenc.score_batch(tq))[0, 3]), rel=RTOL, abs=ATOL)


@with_pair
def test_interop_both_directions(pair):
    jenc, tenc, queries = pair
    from_jax = sq_from_numpy(
        np.asarray(jenc.codes), np.asarray(jenc.voffsets), jenc.metadata.to_json(), "cpu"
    )
    np.testing.assert_array_equal(
        from_jax.score_batch(from_jax.encode_query(queries)).numpy(),
        tenc.score_batch(tenc.encode_query(queries)).numpy(),
    )
    codes, voff, meta = sq_to_numpy(tenc)
    to_jax = j_model.ScalarQuantizerU8(
        jnp.asarray(codes), jnp.asarray(voff), j_model.SQMetadata.from_json(meta)
    )
    _close(to_jax.score_batch(to_jax.encode_query(queries)),
           jenc.score_batch(jenc.encode_query(queries)))


@with_pair
def test_checkpoint_loads_across_packages(pair, tmp_path):
    jenc, tenc, queries = pair
    tparams = tenc.params
    jparams = j_types.VectorParameters.from_json(tparams.to_json())
    tenc.save(tmp_path / "t.bin", tmp_path / "t.json")
    jenc.save(tmp_path / "j.bin", tmp_path / "j.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    j_from_t = j_model.ScalarQuantizerU8.load(tmp_path / "t.bin", tmp_path / "t.json", jparams)
    t_from_j = qt.ScalarQuantizerU8.load(tmp_path / "j.bin", tmp_path / "j.json", tparams,
                                         device="cpu")
    np.testing.assert_array_equal(np.asarray(j_from_t.codes), np.asarray(jenc.codes))
    np.testing.assert_array_equal(t_from_j.codes.numpy(), tenc.codes.numpy())
    np.testing.assert_array_equal(t_from_j.voffsets.numpy(), tenc.voffsets.numpy())
    gs, gi = t_from_j.top_k(t_from_j.encode_query(queries), K)
    ws, wi = tenc.top_k(tenc.encode_query(queries), K)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("invert", [False, True])
def test_l1_score_then_select(rng, invert):
    """L1 has no kernel in either package's default route: plain scores,
    then top-k. L1 scores are alpha times an integer, so ties are common:
    ids are checked up to ties."""
    n, dim = 1500, 72
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((4, dim), dtype=np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.L1, invert)
    jenc = j_model.ScalarQuantizerU8.encode(data, jparams)
    tenc = qt.ScalarQuantizerU8.encode(data, qt.VectorParameters.from_json(jparams.to_json()),
                                       device="cpu")
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    scores = tenc.score_batch(tq).numpy()
    _close(scores, jenc.score_batch(jq))
    ws, wi = jenc.top_k(jq, K)
    for method in ("exact", "approx"):
        gs, gi = tenc.top_k(tq, K, method=method)
        _close(gs, ws)
        for r in range(4):
            _close(scores[r, gi[r]], gs[r])
            untied = _untied(ws[r])
            np.testing.assert_array_equal(gi[r][untied], wi[r][untied])


def test_blocked_select_beyond_block_rows(rng, monkeypatch):
    """Past L1_BLOCK_ROWS, non-fused searches select block by block; the
    blocks merge to the same answer as one flat top-k."""
    import quantization_tpu_torch.models.sq as t_model

    n, dim, k = 2000, 48, 1100  # k > FUSED_K_MAX: not fused
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((3, dim), dtype=np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    tenc = qt.ScalarQuantizerU8.encode(data, params, device="cpu")
    tq = tenc.encode_query(queries)
    flat_s, flat_i = tenc.top_k(tq, k)
    monkeypatch.setattr(t_model, "L1_BLOCK_ROWS", 700)
    gs, gi = tenc.top_k(tq, k)
    np.testing.assert_array_equal(gs, flat_s)
    scores = tenc.score_batch(tq).numpy()
    for r in range(3):
        np.testing.assert_array_equal(scores[r, gi[r]], gs[r])
        assert len(set(gi[r].tolist())) == k
    s, i = tenc.top_k(tq, 2500)  # more than the corpus: -inf / -1 padding
    assert np.isneginf(s[:, n:]).all() and (i[:, n:] == -1).all()
