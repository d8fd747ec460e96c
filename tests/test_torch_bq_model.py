"""The port's BinaryQuantizer against the JAX one, encoded from the same
seeded data: planes equal word for word; score_batch, score_points,
score_candidates and score_internal_batch equal; top_k exact and approx;
state and checkpoints cross between the packages in both directions, for
both storage tiers; stop_condition and the argument errors.

The JAX side runs its fused kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1, as tests/test_pallas_model_path.py does). Tolerance:
none — BQ scores are integers, exact in f32. Ids are checked up to ties:
each is a distinct valid row whose score is its slot's value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.bq as j_model
import quantization_tpu_torch as qt
from quantization_tpu_torch.interop import bq_from_numpy, bq_to_numpy

torch.set_num_threads(1)

Q, K = 6, 10


@pytest.fixture
def pair(rng, request, monkeypatch):
    """(jax quantizer, port quantizer, queries) for one configuration."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    dt, invert, tier, dim, n = request.param
    data = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((Q, dim)).astype(np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.from_json(dt), invert)
    jenc = j_model.BinaryQuantizer.encode(data, jparams, store_type=tier)
    tenc = qt.BinaryQuantizer.encode(
        data, qt.VectorParameters.from_json(jparams.to_json()), store_type=tier,
        device="cpu",
    )
    return jenc, tenc, queries


CASES = [
    ("Dot", False, "u128", 200, 2500),
    ("L2", True, "u128", 64, 900),
    ("Dot", True, "u8", 40, 700),
    ("L1", False, "u8", 100, 1200),
]
with_pair = pytest.mark.parametrize(
    "pair", CASES, indirect=True, ids=["dot-u128", "l2inv-u128", "dotinv-u8", "l1-u8"])


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _ids_valid(gs, gi, scores, n):
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert (gi[r][live] < n).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_array_equal(scores[r, gi[r][live]], gs[r][live])


@with_pair
def test_planes_and_queries_equal(pair):
    jenc, tenc, queries = pair
    assert tenc.metadata.to_json() == jenc.metadata.to_json()
    assert tenc.planes.dtype == torch.int32
    _eq(bq_to_numpy(tenc)[0], jenc.planes)
    _eq(tenc.encode_query(queries).planes.numpy().view(np.uint32),
        jenc.encode_query(queries).planes)
    assert tenc.get_quantized_vector_size() == jenc.get_quantized_vector_size()


@with_pair
def test_scores_equal(pair, rng):
    jenc, tenc, queries = pair
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    n = tenc.count
    _eq(tenc.score_batch(tq), jenc.score_batch(jq))
    ids = rng.integers(0, n, 13)
    _eq(tenc.score_points(tq, ids), jenc.score_points(jq, ids))
    cand = rng.integers(0, n, (Q, 7)).astype(np.int32)
    _eq(tenc.score_candidates(tq, cand), jenc.score_candidates(jq, jnp.asarray(cand)))
    a, b = rng.integers(0, n, 9), rng.integers(0, n, 9)
    _eq(tenc.score_internal_batch(a, b), jenc.score_internal_batch(a, b))
    assert tenc.score_internal(3, 8) == jenc.score_internal(3, 8)


@with_pair
def test_top_k_exact_and_approx(pair):
    jenc, tenc, queries = pair
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    scores = tenc.score_batch(tq).numpy()
    for method in ("exact", "approx"):
        ws, wi = jenc.top_k(jq, K, method=method)
        gs, gi = tenc.top_k(tq, K, method=method)
        assert gs.shape == (Q, K) and gi.dtype == np.int32
        _eq(gs, ws)  # approx: the same candidates; approx_max_k is exact on the CPU
        _ids_valid(gs, gi, scores, tenc.count)


def test_top_k_beyond_the_fused_cap(rng):
    """k > FUSED_K_MAX scores then selects: the same values as the JAX
    package, and -inf / -1 past the corpus."""
    n, dim = 1500, 72
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    tenc = qt.BinaryQuantizer.encode(data, params, device="cpu")
    jenc = j_model.BinaryQuantizer.encode(
        data, j_types.VectorParameters.from_json(params.to_json()))
    tq, jq = tenc.encode_query(data[:2]), jenc.encode_query(data[:2])
    gs, gi = tenc.top_k(tq, 1100)
    ws, _ = jenc.top_k(jq, 1100)
    _eq(gs, ws)
    _ids_valid(gs, gi, tenc.score_batch(tq).numpy(), n)
    s, i = tenc.top_k(tq, 1600)
    assert np.isneginf(s[:, n:]).all() and (i[:, n:] == -1).all()


@with_pair
def test_interop_both_directions(pair):
    jenc, tenc, queries = pair
    from_jax = bq_from_numpy(np.asarray(jenc.planes), jenc.metadata.to_json(),
                             jenc.store_type, device="cpu")
    _eq(from_jax.planes, tenc.planes)
    _eq(from_jax.score_batch(from_jax.encode_query(queries)),
        tenc.score_batch(tenc.encode_query(queries)))
    planes, meta, tier = bq_to_numpy(tenc)
    to_jax = j_model.BinaryQuantizer(jnp.asarray(planes), j_model.BQMetadata.from_json(meta),
                                     tier)
    _eq(to_jax.score_batch(to_jax.encode_query(queries)),
        jenc.score_batch(jenc.encode_query(queries)))


@with_pair
def test_checkpoint_loads_across_packages(pair, tmp_path):
    jenc, tenc, queries = pair
    tparams = tenc.params
    jparams = j_types.VectorParameters.from_json(tparams.to_json())
    tier = tenc.store_type
    tenc.save(tmp_path / "t.bin", tmp_path / "t.json")
    jenc.save(tmp_path / "j.bin", tmp_path / "j.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    j_from_t = j_model.BinaryQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json",
                                            jparams, store_type=tier)
    t_from_j = qt.BinaryQuantizer.load(tmp_path / "j.bin", tmp_path / "j.json", tparams,
                                       store_type=tier, device="cpu")
    _eq(j_from_t.planes, jenc.planes)
    _eq(t_from_j.planes, tenc.planes)
    gs, gi = t_from_j.top_k(t_from_j.encode_query(queries), K)
    ws, wi = tenc.top_k(tenc.encode_query(queries), K)
    _eq(gs, ws)
    _eq(gi, wi)


def test_encode_stream_stop_and_errors(rng):
    dim, n = 48, 300
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    stream = qt.BinaryQuantizer.encode(
        lambda: (data[i : i + 70] for i in range(0, n, 70)), params, device="cpu")
    whole = qt.BinaryQuantizer.encode(data, params, device="cpu", batch_size=64)
    _eq(stream.planes, whole.planes)
    with pytest.raises(qt.StoppedError):
        qt.BinaryQuantizer.encode(data, params, stop_condition=lambda: True, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.BinaryQuantizer.encode(data[:, :40], params, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.BinaryQuantizer.encode(data[:299], params, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.BinaryQuantizer.encode(
            lambda: iter([data[:, :40]]), params, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.BinaryQuantizer.encode(lambda: iter([data, data[:5]]), params, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        whole.encode_query(np.zeros((2, 47), np.float32))
