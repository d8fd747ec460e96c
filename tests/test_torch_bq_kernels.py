"""The plain versions of the port's BQ kernels (K6 scores, K5c exact search,
K5a approx search) against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

Tolerance: none for scores and exact-search values — BQ scores are integers
below 2^24, exact in f32 on both sides. BQ scores tie constantly, so no
test compares ids position by position where ties are possible: an id must
be a distinct valid row whose score is the value claimed for its slot. The
approx candidates follow one tie rule in both packages (the first maximum in
row order), so there ids compare whole. The hand-written CUDA kernels are
held to these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.bq as j_bq
import quantization_tpu.ops.pallas.bq_kernel as j_kernel
from quantization_tpu.ops.topk import topk_exact
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel, ktile

torch.set_num_threads(1)


def _setup(rng, n_valid, dim, q, w_extra=0):
    """Seeded sign data packed to JAX-layout planes [W8, Npad] (uint32) and
    query words [Q, W8]."""
    row_bytes = t_bq.storage_bytes(dim, "u128")
    data = rng.standard_normal((n_valid, dim)).astype(np.float32)
    planes = t_bq.rows_to_planes(t_bq.pack_rows(data, row_bytes))
    w = planes.shape[0]
    w8 = w + (-w) % 8 + w_extra
    npad = n_valid + (-n_valid) % bq_kernel.TILE_N
    planes_p = np.zeros((w8, npad), np.uint32)
    planes_p[:w, :n_valid] = planes
    qrows = t_bq.pack_rows(rng.standard_normal((q, dim)).astype(np.float32), row_bytes)
    qwords = np.zeros((q, w8), np.uint32)
    qwords[:, :w] = t_bq.rows_to_planes(qrows).T
    return qwords, planes_p


def _t(a):
    return t_bq.words_to_tensor(a, "cpu")


def _jdt(dt):
    return j_types.DistanceType.from_json(dt)


def _tdt(dt):
    return DistanceType.from_json(dt)


def assert_ids_valid(gs, gi, scores, n_valid):
    """Every live id is a distinct row < n_valid whose score is its value."""
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert (gi[r][live] < n_valid).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_array_equal(scores[r, gi[r][live]], gs[r][live])


@pytest.mark.parametrize("dt,invert", [("Dot", False), ("Dot", True), ("L2", False),
                                       ("L1", True)])
@pytest.mark.parametrize("dim,n_valid,q", [(193, 900, 3), (64, 2500, 5)])
def test_scores_plain_equal_pallas(rng, dt, invert, dim, n_valid, q):
    qwords, planes = _setup(rng, n_valid, dim, q)
    kw = dict(distance_type=_jdt(dt), invert=invert, dim=dim, n_valid=n_valid,
              interpret=True)
    mxu = np.asarray(j_kernel.bq_scores_mxu(jnp.asarray(qwords), jnp.asarray(planes), **kw))
    xor = np.asarray(j_kernel.bq_scores_pallas(jnp.asarray(qwords), jnp.asarray(planes), **kw))
    got = bq_kernel.bq_scores(_t(qwords), _t(planes), distance_type=_tdt(dt),
                              invert=invert, dim=dim, n_valid=n_valid)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n_valid)
    np.testing.assert_array_equal(got.numpy(), mxu)
    np.testing.assert_array_equal(got.numpy(), xor)


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("dt,invert", [("Dot", False), ("L2", True)])
def test_exact_search_plain_equal_pallas(rng, k, dt, invert):
    dim, n_valid, q = 193, 900, 4
    qwords, planes = _setup(rng, n_valid, dim, q)
    ws, wi = j_kernel.bq_search_mxu(
        jnp.asarray(qwords), jnp.asarray(planes), distance_type=_jdt(dt), invert=invert,
        dim=dim, n_valid=n_valid, k=k, mode="exact", interpret=True)
    gs, gi = bq_kernel.bq_search(_t(qwords), _t(planes), distance_type=_tdt(dt),
                                 invert=invert, dim=dim, n_valid=n_valid, k=k)
    assert gi.dtype == torch.int32 and tuple(gs.shape) == (q, k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    scores = np.asarray(j_bq.score_batch_xla(
        jnp.asarray(qwords), jnp.asarray(planes[:, :n_valid]), distance_type=_jdt(dt),
        invert=invert, dim=dim))
    assert_ids_valid(gs.numpy(), gi.numpy(), scores, n_valid)
    assert_ids_valid(np.asarray(ws), np.asarray(wi), scores, n_valid)


def test_exact_search_k_beyond_n_valid(rng):
    """k > n_valid: every valid row, then -inf / -1 in both packages."""
    dim, n_valid, q, k = 100, 100, 2, 150
    qwords, planes = _setup(rng, n_valid, dim, q)
    ws, wi = j_kernel.bq_search_mxu(
        jnp.asarray(qwords), jnp.asarray(planes), distance_type=_jdt("Dot"),
        invert=False, dim=dim, n_valid=n_valid, k=k, interpret=True)
    gs, gi = bq_kernel.bq_search(_t(qwords), _t(planes), distance_type=DistanceType.DOT,
                                 invert=False, dim=dim, n_valid=n_valid, k=k)
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi[:, n_valid:], wi[:, n_valid:])
    assert np.isneginf(gs[:, n_valid:]).all() and (gi[:, n_valid:] == -1).all()
    assert (np.sort(gi[:, :n_valid], axis=1) == np.arange(n_valid)).all()


def _jax_approx_candidates(qwords, planes, **kw):
    """The JAX approx kernel's candidate slots before its merge: the merge is
    swapped for the identity around an unjitted call."""
    orig = j_kernel.merge_tile_topk_all
    j_kernel.merge_tile_topk_all = lambda v, i, k, recall_target: (v, i)
    try:
        v, i = j_kernel.bq_search_mxu.__wrapped__(
            jnp.asarray(qwords), jnp.asarray(planes), mode="approx", interpret=True,
            **kw)
    finally:
        j_kernel.merge_tile_topk_all = orig
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize(
    "dim,n_valid,tile_n",
    [
        (128, 3000, 2048),   # npad 4096: two 2048-row tiles, one partial span
        (1024, 5000, 1024),  # npad 6144: six 1024-row tiles, a partial span
        (2048, 4000, 512),   # npad 4096: eight 512-row tiles, two full spans
    ],
)
def test_approx_candidates_equal_pallas(rng, dim, n_valid, tile_n):
    q = 3
    qwords, planes = _setup(rng, n_valid, dim, q)
    assert bq_kernel.mxu_tile_n(planes.shape[0] * 32, planes.shape[1]) == tile_n
    assert j_kernel._mxu_tile_n(planes.shape[0] * 32, planes.shape[1]) == tile_n
    jv, ji = _jax_approx_candidates(qwords, planes, distance_type=_jdt("Dot"),
                                    invert=False, dim=dim, n_valid=n_valid, k=10)
    scores = t_bq.score_batch(_t(qwords), _t(planes), distance_type=DistanceType.DOT,
                              invert=False, dim=dim)
    scores[:, n_valid:] = ktile.NEG
    tv, ti = ktile.approx_candidates(scores, tile_n)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    # The final approx top-k against exact: overlap >= 0.8 (ROADMAP F6).
    k = 10
    gs, gi = bq_kernel.bq_search(_t(qwords), _t(planes), distance_type=DistanceType.DOT,
                                 invert=False, dim=dim, n_valid=n_valid, k=k, mode="approx")
    es, _ = bq_kernel.bq_search(_t(qwords), _t(planes), distance_type=DistanceType.DOT,
                                invert=False, dim=dim, n_valid=n_valid, k=k)
    sc = scores.numpy()
    assert_ids_valid(gs.numpy(), gi.numpy(), sc, n_valid)
    for r in range(q):
        # Ties make id overlap ill-defined: compare the sorted values, slot by
        # slot, with the exact top-k values.
        assert np.mean(gs.numpy()[r] == es.numpy()[r]) >= 0.8


def test_exact_search_values_match_score_then_topk(rng):
    """A bigger k over a corpus of several splits, against lax.top_k."""
    dim, n_valid, q, k = 256, 5000, 3, 700
    qwords, planes = _setup(rng, n_valid, dim, q, w_extra=8)
    scores = j_bq.score_batch_xla(jnp.asarray(qwords), jnp.asarray(planes[:, :n_valid]),
                                  distance_type=_jdt("L2"), invert=True, dim=dim)
    ws, _ = topk_exact(scores, k)
    gs, gi = bq_kernel.bq_search(_t(qwords), _t(planes), distance_type=DistanceType.L2,
                                 invert=True, dim=dim, n_valid=n_valid, k=k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert_ids_valid(gs.numpy(), gi.numpy(), np.asarray(scores), n_valid)


@pytest.mark.parametrize("npad", [2048, 4096, 6144, 1001472])
@pytest.mark.parametrize("dp", [256, 1024, 1536, 2048])
def test_mxu_tile_width_matches_pallas_rule(npad, dp):
    assert bq_kernel.mxu_tile_n(dp, npad) == j_kernel._mxu_tile_n(dp, npad)


def test_search_rejects_bad_arguments(rng):
    qwords, planes = _setup(rng, 100, 64, 2)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=64, n_valid=100)
    with pytest.raises(Exception, match="k <= 1024"):
        bq_kernel.bq_search(_t(qwords), _t(planes), k=1025, **kw)
    with pytest.raises(Exception, match="mode"):
        bq_kernel.bq_search(_t(qwords), _t(planes), k=5, mode="fast", **kw)
    before = dict(bq_kernel.LAUNCHES)
    bq_kernel.bq_search(_t(qwords), _t(planes), k=5, **kw)
    bq_kernel.bq_scores(_t(qwords), _t(planes), **kw)
    assert bq_kernel.LAUNCHES == before  # CPU tensors take the plain versions
