"""The port's ProductQuantizer against the JAX one, from the same seeded
data: 8-bit and 4-bit codes, an OPQ rotation and an explicit one; training,
codes, every scoring entry point, top_k exact and approx, the count <= 256
and empty cases, stop_condition, checkpoints and state across the packages
in both directions, ``from_transposed`` and ``dump_to_image``.

The JAX side runs its fused kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1, as tests/test_pallas_model_path.py does); without it,
the JAX model would score with the f32 LUT on the CPU and the two packages
would compare different functions. Scoring is compared on one state (the
JAX quantizer's codes and centroids, carried over by ``pq_from_numpy``), so
training's near-tie differences do not reach it. Tolerances, with their
causes:
  * trained centroids: 1e-4 relative to their scale (k-means sums round in
    another order, over 100 iterations);
  * codes: equal but for near-ties of the two packages' centroids (under
    0.5 % of the codes, each a near-tie in f64);
  * int8-LUT scores: 2 ulp of |score| + |bias| (ROADMAP Queue 3, F14);
    bf16-LUT scores: equal (8-bit), 1 ulp (4-bit, F19); f32-LUT scores
    (points, candidates, internal): rtol 1e-6;
  * top-k: values within those tolerances, ids up to ties."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.pq as j_model
import quantization_tpu_torch as qt
from quantization_tpu_torch.interop import pq_from_numpy, pq_to_numpy
from quantization_tpu_torch.ops.kernels import pq_kernel

torch.set_num_threads(1)

Q, K = 6, 10


def _rotation(rng, dim):
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return q.astype(np.float32)


def _data(rng, n, dim):
    """Low-rank-ish rows, as embeddings are, so OPQ has something to learn."""
    basis = rng.standard_normal((dim // 2, dim)).astype(np.float32)
    x = rng.standard_normal((n, dim // 2)).astype(np.float32) @ basis
    return (x + 0.1 * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    """Each configuration's quantizers, trained once for the module."""
    return {}


@pytest.fixture
def pair(request, monkeypatch, trained):
    """(jax quantizer, port quantizer encoded alike, port quantizer holding
    the JAX state, queries, data) for one configuration."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    case = request.param
    if case not in trained:
        rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
        dt, invert, dim, n, chunk, bits, rot = case
        data = _data(rng, n, dim)
        queries = _data(rng, Q, dim)
        rotation = {"none": None, "opq": "opq", "explicit": _rotation(rng, dim)}[rot]
        jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.from_json(dt), invert)
        jenc = j_model.ProductQuantizer.encode(data, jparams, chunk_size=chunk, bits=bits,
                                               rotation=rotation)
        tparams = qt.VectorParameters.from_json(jparams.to_json())
        tenc = qt.ProductQuantizer.encode(data, tparams, chunk_size=chunk, bits=bits,
                                          rotation=rotation, device="cpu")
        shared = pq_from_numpy(np.asarray(jenc.codes), jenc.metadata.to_json(), device="cpu")
        trained[case] = (jenc, tenc, shared, queries, data)
    return trained[case]


CASES = [
    ("Dot", False, 32, 2500, 4, 8, "none"),
    ("L2", True, 32, 1800, 2, 4, "none"),
    ("Dot", False, 32, 1500, 4, 8, "opq"),
    ("L2", False, 24, 1200, 3, 8, "explicit"),
]
with_pair = pytest.mark.parametrize("pair", CASES, indirect=True,
                                    ids=["dot-8bit", "l2inv-4bit", "dot-opq", "l2-rotated"])


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_lut_scores(got, want, enc, lut):
    """Scores of the fused kernels' LUT word (``lut_precision()``)."""
    got, want = np.asarray(got), np.asarray(want)
    if pq_kernel.lut_precision() == "int8":
        _, _, bias = pq_kernel.quantize_lut(lut)
        assert (np.abs(got - want) <= 2 * np.spacing(
            np.abs(want) + np.abs(bias.numpy())[:, None])).all()
    elif enc.metadata.bits == 4:
        assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    else:
        _eq(got, want)


def _ids_valid(gs, gi, scores, n):
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert (gi[r][live] < n).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_array_equal(scores[r, gi[r][live]], gs[r][live])


@with_pair
def test_training_and_codes_match(pair):
    jenc, tenc, shared, queries, data = pair
    jm, tm = jenc.metadata, tenc.metadata
    assert (tm.bits, tm.vector_division) == (jm.bits, jm.vector_division)
    assert (tm.rotation is None) == (jm.rotation is None)
    jc, tc = np.asarray(jenc.codes), tenc.codes.numpy()
    assert tc.shape == jc.shape and tc.dtype == np.uint8
    if jm.rotation is not None:
        np.testing.assert_allclose(tm.rotation @ tm.rotation.T, np.eye(data.shape[1]),
                                   atol=1e-5)
        if not np.array_equal(tm.rotation, jm.rotation):
            return  # OPQ: two trained rotations, close in error but not in codes
    scale = np.abs(jm.centroids).max()
    np.testing.assert_allclose(tm.centroids, jm.centroids, rtol=0, atol=1e-4 * scale)
    bad = np.argwhere(tc != jc)
    assert len(bad) <= 0.005 * tc.size
    xr = data if tm.rotation is None else data @ tm.rotation
    div = tm.vector_division
    for b, ci in bad:
        s, e = div[ci]
        d = [np.sum((xr[b, s:e].astype(np.float64) - tm.centroids[c, s:e]) ** 2)
             for c in (tc[b, ci], jc[b, ci])]
        assert abs(d[0] - d[1]) <= 1e-4 * max(d), (b, ci, d)


@with_pair
def test_scores_equal(pair, rng):
    jenc, _, tenc, queries, _ = pair
    jq, tq = jenc.encode_query(queries), tenc.encode_query(queries)
    np.testing.assert_allclose(tq.lut.numpy(), np.asarray(jq.lut), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jq.lut)).max())
    lut = torch.from_numpy(np.asarray(jq.lut))  # one LUT for both, below
    tq = qt.EncodedQueryPQ(lut)
    n = tenc.count
    _assert_lut_scores(tenc.score_batch(tq), jenc.score_batch(jq), tenc, lut)
    # f32 sums of m entries in another order: 1e-6 of the summands' scale
    atol = 1e-6 * tenc.num_chunks * float(lut.abs().max())
    ids = rng.integers(0, n, 13)
    np.testing.assert_allclose(tenc.score_points(tq, ids), jenc.score_points(jq, ids),
                               rtol=1e-6, atol=atol)
    cand = rng.integers(0, n, (Q, 7)).astype(np.int32)
    np.testing.assert_allclose(tenc.score_candidates(tq, cand),
                               jenc.score_candidates(jq, jnp.asarray(cand)),
                               rtol=1e-6, atol=atol)
    a, b = rng.integers(0, n, 9), rng.integers(0, n, 9)
    np.testing.assert_allclose(tenc.score_internal_batch(a, b),
                               jenc.score_internal_batch(a, b), rtol=1e-5, atol=1e-4)
    assert tenc.score_internal(3, 8) == pytest.approx(jenc.score_internal(3, 8), rel=1e-5,
                                                      abs=1e-4)
    assert tenc.score_point(tq, 5) == pytest.approx(float(jenc.score_points(jq, [5])[0, 0]),
                                                    rel=1e-6, abs=1e-5)


@with_pair
def test_top_k_exact_and_approx(pair):
    jenc, _, tenc, queries, _ = pair
    jq = jenc.encode_query(queries)
    lut = torch.from_numpy(np.asarray(jq.lut))
    tq = qt.EncodedQueryPQ(lut)
    scores = tenc.score_batch(tq).numpy()
    for method in ("exact", "approx"):
        ws, wi = jenc.top_k(jq, K, method=method)
        gs, gi = tenc.top_k(tq, K, method=method)
        assert gs.shape == (Q, K) and gi.dtype == np.int32
        _assert_lut_scores(gs, ws, tenc, lut)
        _ids_valid(gs, gi, scores, tenc.count)


def test_bf16_precisions_and_the_fused_cap(rng, monkeypatch):
    """QTPU_PQ_LUT=bf16 / bf16x2 are read at each call, as in the JAX
    package; K8 scores bf16x2 as bf16 in both; beyond the fused cap the
    search scores then selects."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    n, dim = 1500, 16
    data = _data(rng, n, dim)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    jenc = j_model.ProductQuantizer.encode(
        data, j_types.VectorParameters.from_json(params.to_json()), chunk_size=4)
    tenc = pq_from_numpy(np.asarray(jenc.codes), jenc.metadata.to_json(), device="cpu")
    jq = jenc.encode_query(data[:3])
    tq = qt.EncodedQueryPQ(torch.from_numpy(np.asarray(jq.lut)))
    for prec in ("bf16", "bf16x2"):
        monkeypatch.setenv("QTPU_PQ_LUT", prec)
        _eq(tenc.score_batch(tq), jenc.score_batch(jq))
        ws, wi = jenc.top_k(jq, K)
        gs, gi = tenc.top_k(tq, K)
        _eq(gs, ws)
    _eq(tenc.score_batch(tq), tenc.score_batch(tq))
    monkeypatch.setenv("QTPU_PQ_LUT", "int8")
    gs, gi = tenc.top_k(tq, 1100)  # k > FUSED_K_MAX: score_batch + top-k
    ws, _ = jenc.top_k(jq, 1100)
    _assert_lut_scores(gs, ws, tenc, tq.lut)
    s, i = tenc.top_k(tq, 1600)
    assert np.isneginf(s[:, n:]).all() and (i[:, n:] == -1).all()


@pytest.mark.parametrize("n,bits", [(200, 8), (10, 4)])
def test_few_points_are_their_own_centroids(rng, n, bits, monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    dim = 12
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.L2, True)
    jenc = j_model.ProductQuantizer.encode(
        data, j_types.VectorParameters.from_json(params.to_json()), chunk_size=4, bits=bits,
        rotation="opq")
    tenc = qt.ProductQuantizer.encode(data, params, chunk_size=4, bits=bits, rotation="opq",
                                      device="cpu")
    assert tenc.metadata.rotation is None and jenc.metadata.rotation is None
    _eq(tenc.metadata.centroids, jenc.metadata.centroids)
    _eq(tenc.codes.numpy(), jenc.codes)
    eq = tenc.encode_query(data[:4])
    _, i = tenc.top_k(eq, 1, method="exact")
    assert (i[:, 0] == np.arange(4)).all()


def test_empty_quantizer(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    dim = 8
    data = np.zeros((0, dim), np.float32)
    params = qt.VectorParameters(dim, 0, qt.DistanceType.DOT, False)
    jenc = j_model.ProductQuantizer.encode(
        data, j_types.VectorParameters.from_json(params.to_json()), chunk_size=4)
    tenc = qt.ProductQuantizer.encode(data, params, chunk_size=4, device="cpu")
    _eq(tenc.codes.numpy(), jenc.codes)
    q = np.ones((2, dim), np.float32)
    tq, jq = tenc.encode_query(q), jenc.encode_query(q)
    assert tuple(tenc.score_batch(tq).shape) == (2, 0) == jenc.score_batch(jq).shape
    gs, gi = tenc.top_k(tq, 3)
    ws, wi = jenc.top_k(jq, 3)
    _eq(gs, ws)
    _eq(gi, wi)


def test_stop_condition_and_errors(rng):
    n, dim = 600, 16
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    calls = []

    def stop_late():
        calls.append(1)
        return len(calls) > 3

    for kw in (dict(), dict(rotation="opq")):
        calls.clear()
        with pytest.raises(qt.StoppedError):
            qt.ProductQuantizer.encode(data, params, chunk_size=4, stop_condition=stop_late,
                                       device="cpu", **kw)
    with pytest.raises(qt.ArgumentsError):
        qt.ProductQuantizer.encode(data, params, chunk_size=4, bits=2, device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.ProductQuantizer.encode(data, qt.VectorParameters(dim, n, qt.DistanceType.L1, False),
                                   chunk_size=4, rotation="opq", device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.ProductQuantizer.encode(data, params, chunk_size=4, rotation=np.ones((dim, dim)),
                                   device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.ProductQuantizer.encode(data, params, chunk_size=4, rotation="pca", device="cpu")
    with pytest.raises(qt.ArgumentsError):
        qt.ProductQuantizer.encode(data[:599], params, chunk_size=4, device="cpu")
    enc = qt.ProductQuantizer.encode(
        lambda: (data[i : i + 170] for i in range(0, n, 170)), params, chunk_size=4,
        device="cpu")
    _eq(enc.codes, qt.ProductQuantizer.encode(data, params, chunk_size=4, device="cpu",
                                              batch_size=100).codes)
    with pytest.raises(qt.ArgumentsError):
        enc.encode_query(np.zeros((2, dim - 1), np.float32))


@with_pair
def test_checkpoints_and_state_cross_packages(pair, tmp_path):
    jenc, _, tenc, queries, _ = pair
    jparams = jenc.params
    tparams = qt.VectorParameters.from_json(jparams.to_json())
    tenc.save(tmp_path / "t.bin", tmp_path / "t.json")
    jenc.save(tmp_path / "j.bin", tmp_path / "j.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tenc.get_quantized_vector_size() == jenc.get_quantized_vector_size()
    assert (tmp_path / "t.bin").stat().st_size == tenc.count * tenc.get_quantized_vector_size()
    j_from_t = j_model.ProductQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json", jparams)
    t_from_j = qt.ProductQuantizer.load(tmp_path / "j.bin", tmp_path / "j.json", tparams,
                                        device="cpu")
    _eq(j_from_t.codes, jenc.codes)
    _eq(t_from_j.codes, tenc.codes)
    tq = t_from_j.encode_query(queries)
    gs, gi = t_from_j.top_k(tq, K)
    ws, wi = tenc.top_k(tenc.encode_query(queries), K)
    _eq(gs, ws)
    _eq(gi, wi)
    codes, meta = pq_to_numpy(tenc)
    to_jax = j_model.ProductQuantizer(jnp.asarray(codes), j_model.PQMetadata.from_json(meta))
    _eq(to_jax.codes, jenc.codes)
    _eq(to_jax.score_batch(jenc.encode_query(queries)),
        jenc.score_batch(jenc.encode_query(queries)))


@with_pair
def test_from_transposed_equals_row_major(pair):
    jenc, _, tenc, queries, _ = pair
    jt = j_model.ProductQuantizer.from_transposed(jnp.asarray(np.asarray(jenc.codes).T),
                                                  jenc.metadata)
    tt = qt.ProductQuantizer.from_transposed(tenc.codes_t.clone(), tenc.metadata)
    _eq(tt.codes_t, tenc.codes_t)
    _eq(tt.codes, tenc.codes)
    _eq(tt.codes.numpy(), jt.codes)
    tq = tenc.encode_query(queries)
    _eq(tt.score_batch(tq), tenc.score_batch(tq))
    # unpadded transposed codes pad to the same layout
    m, n = tenc.num_chunks, tenc.count
    t2 = qt.ProductQuantizer.from_transposed(tenc.codes_t[:m, :n].clone(), tenc.metadata)
    _eq(t2.codes_t, tenc.codes_t)


def test_dump_to_image(rng, tmp_path):
    pytest.importorskip("PIL")
    n, dim = 400, 6
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    tenc = qt.ProductQuantizer.encode(data, params, chunk_size=3, device="cpu")
    jenc = j_model.ProductQuantizer(jnp.asarray(tenc.codes.numpy()), j_model.PQMetadata.from_json(
        tenc.metadata.to_json()))
    tp = tenc.dump_to_image(data, prefix=str(tmp_path / "t"))
    jp = jenc.dump_to_image(data, prefix=str(tmp_path / "j"))
    assert len(tp) == len(jp) == 2
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
