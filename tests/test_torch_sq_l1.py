"""SQ L1 against the JAX package: the plain version of K12 (``sq_scores``
with L1) against ``sq_scores_pallas(L1)`` in interpret mode and against
``score_batch_xla``, and the model's L1 ``score_batch`` / ``top_k`` (flat and
blocked past ``L1_BLOCK_ROWS``) and an IVF-SQ L1 compact scan, on seeded
data.

Tolerance: none for scores. The JAX package's compiled L1 epilogue fuses
``mult * acc + qoff`` into one multiply-add; the port computes it in f64 and
rounds once, then adds voff in f32 (ROADMAP F24), in K12 and its plain
version alike, so scores are equal to the bit. L1 scores are the multiplier
times an integer, so they tie: ids are equal where the value is untied, and
every id scores the value of its slot. The hand-written K12 kernel is held to
this plain version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.models.sq as j_model
import quantization_tpu.ops.sq as j_sq
import quantization_tpu_torch as qt
from quantization_tpu.ops.pallas.sq_kernel import sq_scores_pallas
from quantization_tpu_torch.ops.kernels import sq_kernel

torch.set_num_threads(1)

K = 10


def _untied(row):
    vals, counts = np.unique(row, return_counts=True)
    return np.isin(row, vals[counts == 1]) & (row != row[-1])


@pytest.mark.parametrize("q,per_query_mult", [(1, False), (5, False), (5, True)])
def test_k12_plain_matches_pallas_and_xla(rng, q, per_query_mult):
    n_valid, d = 700, 256
    npad = n_valid + (-n_valid) % sq_kernel.TILE_N
    codes = np.zeros((npad, d), np.int8)
    codes[:n_valid] = rng.integers(0, 128, (n_valid, d), dtype=np.int8)
    voff = np.zeros(npad, np.float32)
    voff[:n_valid] = rng.standard_normal(n_valid).astype(np.float32) * 30
    qcodes = rng.integers(0, 128, (q, d), dtype=np.int8)
    qoff = (rng.standard_normal(q) * 30).astype(np.float32)
    mult = (-(rng.random(q) * 0.02 + 0.001)).astype(np.float32) if per_query_mult \
        else np.float32(-0.0123)
    jargs = tuple(jnp.asarray(a) for a in (qcodes, qoff, codes, voff, mult))
    pallas = np.asarray(sq_scores_pallas(*jargs, distance_type=j_types.DistanceType.L1,
                                         n_valid=n_valid, interpret=True))
    xla = np.asarray(j_sq.score_batch_xla(
        *jargs[:2], jargs[2][:n_valid], jargs[3][:n_valid], jargs[4],
        distance_type=j_types.DistanceType.L1))
    got = sq_kernel.sq_scores(*(torch.from_numpy(np.asarray(a)) for a in (qcodes, qoff, codes,
                                                                            voff, mult)),
                              distance_type=qt.DistanceType.L1, n_valid=n_valid)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n_valid)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)


@pytest.fixture
def l1_pair(rng, request):
    invert = request.param
    n, dim = 1500, 72
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((4, dim), dtype=np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.L1, invert)
    jenc = j_model.ScalarQuantizerU8.encode(data, jparams)
    tenc = qt.ScalarQuantizerU8.encode(data, qt.VectorParameters.from_json(jparams.to_json()),
                                       device="cpu")
    return jenc, tenc, queries


@pytest.mark.parametrize("l1_pair", [False, True], indirect=True, ids=["l1", "l1-inv"])
def test_l1_score_batch_and_top_k_match_jax(l1_pair):
    jenc, tenc, queries = l1_pair
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    scores = tenc.score_batch(tq).numpy()
    np.testing.assert_array_equal(scores, np.asarray(jenc.score_batch(jq)))
    ws, wi = jenc.top_k(jq, K)
    for method in ("exact", "approx"):
        gs, gi = tenc.top_k(tq, K, method=method)
        np.testing.assert_array_equal(gs, np.asarray(ws))
        for r in range(gs.shape[0]):
            np.testing.assert_array_equal(scores[r, gi[r]], gs[r])
            untied = _untied(np.asarray(ws)[r])
            np.testing.assert_array_equal(gi[r][untied], np.asarray(wi)[r][untied])


@pytest.mark.parametrize("block", [512, 100, 64])
def test_l1_blocked_top_k_matches_flat(rng, monkeypatch, block):
    """The corpus-blocked L1 search crosses block and tail boundaries
    (tests/test_sq.py:182-200) and returns the flat search's values, in both
    packages; k beyond a tail block included."""
    import quantization_tpu_torch.models.sq as t_model

    n, dim, q, k = 1333, 40, 3, 70
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.L1, True)
    jenc = j_model.ScalarQuantizerU8.encode(data, jparams)
    tenc = qt.ScalarQuantizerU8.encode(data, qt.VectorParameters.from_json(jparams.to_json()),
                                       device="cpu")
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    flat_s, _ = tenc.top_k(tq, k)
    monkeypatch.setattr(t_model, "L1_BLOCK_ROWS", block)
    monkeypatch.setattr(j_model, "L1_BLOCK_ROWS", block)
    gs, gi = tenc.top_k(tq, k)
    ws, _ = jenc.top_k(jq, k)
    np.testing.assert_array_equal(gs, flat_s)
    np.testing.assert_array_equal(gs, np.asarray(ws))
    scores = tenc.score_batch(tq).numpy()
    for r in range(q):
        np.testing.assert_array_equal(scores[r, gi[r]], gs[r])
        assert len(set(gi[r].tolist())) == k


def test_ivf_sq_l1_compact_matches_jax(rng):
    """IVF-SQ with L1 scans the union compactly, through K12 on the card
    and its plain version here; the JAX index carried across searches the
    same."""
    n, dim = 3000, 32
    centers = rng.standard_normal((8, dim)).astype(np.float32)
    data = (centers[rng.integers(0, 8, n)] + 0.08 * rng.standard_normal((n, dim))).astype(
        np.float32)
    queries = (centers[rng.integers(0, 8, 6)] + 0.08 * rng.standard_normal((6, dim))).astype(
        np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.L1, True)
    jivf = j_ivf.IVFIndex.encode(data, jparams, quantizer="sq", nlist=8, bucket_size=512,
                                 nprobe=3, seed=1)
    qz = jivf.quantizer
    tivf = qt.ivf_from_numpy((np.asarray(qz.codes), np.asarray(qz.voffsets),
                              qz.metadata.to_json()), jivf.bucket_ids, jivf.bucket_means,
                             jivf.metadata.to_json(), device="cpu")
    for method in ("exact", "approx"):
        ws, wi = jivf.top_k(jivf.encode_query(queries), K, method=method)
        gs, gi = tivf.top_k(tivf.encode_query(queries), K, method=method)
        np.testing.assert_array_equal(gs, np.asarray(ws))
        for r in range(gs.shape[0]):
            untied = _untied(np.asarray(ws)[r])
            np.testing.assert_array_equal(gi[r][untied], np.asarray(wi)[r][untied])
            assert len(set(gi[r].tolist())) == K
