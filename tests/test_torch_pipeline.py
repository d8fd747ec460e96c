"""The two-stage slice as a whole: BQ coarse search -> SQ-u8 or f32 rescoring
(``TwoStageIndex``, ``ExactRescorer``, ``_mask_select``) in the port against
the JAX package.

The data is planted so that no tie can make the two packages differ: for
each query, R rows sit at 0, 1, ..., R-1 sign flips from it, in distinct
stride classes, while the random rows sit near Hamming dim/2. Both coarse
stages, exact and approx, then return the same R candidates, and the final
(scores, ids) agree: ids equal, scores within the SQ tolerance (rtol 1e-6 /
atol 1e-4: XLA may fuse a multiply-add where PyTorch rounds twice, and the
f32 sums run in another order). The JAX side runs its Pallas kernels in
interpret mode (QTPU_FORCE_PALLAS=1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.bq as j_bq
import quantization_tpu.models.pipeline as j_pipe
import quantization_tpu.models.sq as j_sq
import quantization_tpu_torch as qt
from quantization_tpu_torch.models import pipeline as t_pipe

torch.set_num_threads(1)

DIM, N_RANDOM, Q, R, K = 256, 3000, 4, 40, 10
RTOL, ATOL = 1e-6, 1e-4


def planted(rng):
    """(data [Q*R + N_RANDOM, DIM], queries [Q, DIM]): rows a*R + j hold query
    a with the signs of j coordinates flipped."""
    queries = rng.standard_normal((Q, DIM)).astype(np.float32)
    rows = []
    for a in range(Q):
        for j in range(R):
            v = queries[a].copy()
            flip = rng.choice(DIM, j, replace=False)
            v[flip] = -v[flip]
            rows.append(v)
    rand = rng.standard_normal((N_RANDOM, DIM)).astype(np.float32)
    return np.concatenate([np.stack(rows), rand]).astype(np.float32), queries


@pytest.fixture
def indexes(rng, monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    data, queries = planted(rng)
    n = data.shape[0]
    jparams = j_types.VectorParameters(DIM, n, j_types.DistanceType.DOT, False)
    tparams = qt.VectorParameters.from_json(jparams.to_json())
    jbq = j_bq.BinaryQuantizer.encode(data, jparams)
    tbq = qt.BinaryQuantizer.encode(data, tparams, device="cpu")
    jsq = j_sq.ScalarQuantizerU8.encode(data, jparams)
    tsq = qt.ScalarQuantizerU8.encode(data, tparams, device="cpu")
    return data, queries, (jbq, tbq), (jsq, tsq)


def _check_planted_candidates(tbq, queries):
    """The precondition of the comparison: the coarse top-R is exactly the
    planted rows, with distinct scores, in both search modes."""
    eq = tbq.encode_query(queries)
    for method in ("exact", "approx"):
        s, i = tbq.top_k(eq, R, method=method)
        for a in range(Q):
            np.testing.assert_array_equal(i[a], a * R + np.arange(R))
            assert len(set(s[a].tolist())) == R


@pytest.mark.parametrize("method", ["approx", "exact"])
@pytest.mark.parametrize("fine", ["sq", "f32"])
def test_two_stage_matches_jax(indexes, method, fine):
    data, queries, (jbq, tbq), (jsq, tsq) = indexes
    _check_planted_candidates(tbq, queries)
    if fine == "sq":
        jfine, tfine = jsq, tsq
    else:
        jfine = j_pipe.ExactRescorer(data, j_types.DistanceType.DOT, False)
        tfine = qt.ExactRescorer(data, qt.DistanceType.DOT, False, device="cpu")
    jidx = j_pipe.TwoStageIndex(jbq, jfine, oversampling=R / K, coarse_method=method)
    tidx = qt.TwoStageIndex(tbq, tfine, oversampling=R / K, coarse_method=method)
    ws, wi = jidx.top_k(jidx.encode_query(queries), K)
    gs, gi = tidx.top_k(tidx.encode_query(queries), K)
    assert gs.shape == (Q, K) and gi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    # The final scores are the fine stage's scores of the returned ids.
    teq = tfine.encode_query(queries)
    np.testing.assert_array_equal(
        tfine.score_candidates(teq, torch.from_numpy(gi)).numpy(), gs)


def test_mask_select_equal_with_padding_ids(rng):
    cand = rng.integers(0, 500, (3, 12)).astype(np.int32)
    cand[0, :4] = -1
    cand[2, 11] = -1
    fine = rng.standard_normal((3, 12)).astype(np.float32)
    fine[0, 0] = 99.0  # a padding slot's score never wins
    ws, wi = j_pipe._mask_select(jnp.asarray(cand), jnp.asarray(fine), 9)
    gs, gi = t_pipe._mask_select(torch.from_numpy(cand), torch.from_numpy(fine), 9)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert -1 not in gi.numpy()[0, :8]


def test_rescorers_score_padding_ids_neg_inf(indexes):
    """ROADMAP F4 pinned: a -1 id scores -inf in every port rescorer; the JAX
    device rescorer scores the last row for it (jnp.take wraps), its host
    rescorer row 0."""
    data, queries, _, (jsq, tsq) = indexes
    cand = np.array([[5, -1, 7], [-1, 2, 3]], np.int32)
    t_dev = qt.ExactRescorer(data, qt.DistanceType.DOT, False, device="cpu")
    t_host = qt.ExactRescorer(data, qt.DistanceType.DOT, False, host_resident=True,
                              device="cpu")
    j_dev = j_pipe.ExactRescorer(data, j_types.DistanceType.DOT, False)
    pad = cand < 0
    for got in (
        t_dev.score_candidates(t_dev.encode_query(queries[:2]), cand).numpy(),
        t_host.score_candidates(t_host.encode_query(queries[:2]), cand).numpy(),
        tsq.score_candidates(tsq.encode_query(queries[:2]), cand).numpy(),
    ):
        assert np.isneginf(got[pad]).all() and np.isfinite(got[~pad]).all()
    want = np.asarray(j_dev.score_candidates(j_dev.encode_query(queries[:2]), cand))
    np.testing.assert_allclose(want[0, 1], data[-1] @ queries[0], rtol=1e-5)
    got = t_dev.score_candidates(t_dev.encode_query(queries[:2]), cand).numpy()
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=RTOL, atol=ATOL)
    pts = t_dev.score_points(t_dev.encode_query(queries[:2]), [3, -1]).numpy()
    assert np.isneginf(pts[:, 1]).all() and np.isfinite(pts[:, 0]).all()


def test_host_resident_matches_device(indexes, tmp_path):
    """host_resident=True (numpy or memmap) gathers rows on the host and
    scores as the device rescorer does."""
    data, queries, _, _ = indexes
    mm = np.lib.format.open_memmap(tmp_path / "data.npy", mode="w+", dtype=np.float32,
                                   shape=data.shape)
    mm[:] = data
    dev = qt.ExactRescorer(data, qt.DistanceType.L2, True, device="cpu")
    cand = np.arange(Q * 11).reshape(Q, 11).astype(np.int32) * 7
    want = dev.score_candidates(dev.encode_query(queries), cand).numpy()
    for src in (data, mm):
        host = qt.ExactRescorer(src, qt.DistanceType.L2, True, host_resident=True,
                                device="cpu")
        np.testing.assert_array_equal(
            host.score_candidates(host.encode_query(queries), cand).numpy(), want)
        np.testing.assert_array_equal(
            host.score_points(host.encode_query(queries), cand[0]).numpy(),
            dev.score_points(dev.encode_query(queries), cand[0]).numpy())


def test_two_stage_recall_beats_coarse(rng):
    """Rescoring a BQ top-40 with SQ or f32 finds more of the f32 top-10 than
    BQ alone, on clustered, cosine-normalised data."""
    n, dim = 4000, 64
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    data = centers[rng.integers(0, 16, n)] + 0.5 * rng.standard_normal((n, dim))
    data = (data / np.linalg.norm(data, axis=1, keepdims=True)).astype(np.float32)
    queries = data[rng.integers(0, n, 8)] + 0.05 * rng.standard_normal((8, dim))
    queries = queries.astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    truth = np.argsort(-(queries @ data.T), axis=1)[:, :K]
    bq = qt.BinaryQuantizer.encode(data, params, device="cpu")
    sq = qt.ScalarQuantizerU8.encode(data, params, device="cpu")

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])

    _, coarse = bq.top_k(bq.encode_query(queries), K)
    for fine in (sq, qt.ExactRescorer(data, qt.DistanceType.DOT, False, device="cpu")):
        idx = qt.TwoStageIndex(bq, fine, oversampling=4.0)
        _, got = idx.top_k(idx.encode_query(queries), K)
        assert recall(got) >= recall(coarse)


def test_oversampling_and_device_defaults():
    with pytest.raises(qt.ArgumentsError):
        qt.TwoStageIndex(None, None, oversampling=0.5)
    if not torch.cuda.is_available():
        with pytest.raises(qt.NoDeviceError, match="device='cpu'"):
            qt.ExactRescorer(np.zeros((3, 4), np.float32), qt.DistanceType.DOT, False)
