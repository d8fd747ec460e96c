"""The plain versions of the port's SQ kernels (K1 exact search, K2 approx
search, K3 scores) against the JAX package's Pallas kernels, run in interpret
mode on the CPU, at the shapes of tests/test_pallas_kernels.py.

Tolerances: scores rtol 1e-6 / atol 1e-4 (the JAX package's own, since XLA
may fuse the epilogue's multiply-add where PyTorch rounds twice); top-k ids
equal wherever the score is untied. The hand-written CUDA kernels are held to
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.sq as j_sq
from quantization_tpu.ops.pallas.sq_kernel import sq_scores_pallas, sq_search_pallas
from quantization_tpu.ops.topk import topk_exact
from quantization_tpu.utils.padding import round_up
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops.kernels import ktile, sq_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-4


def _setup(rng, n_valid, d, q, voff_values=None):
    npad = round_up(n_valid, sq_kernel.TILE_N)
    codes = np.zeros((npad, d), np.int8)
    codes[:n_valid] = rng.integers(0, 128, (n_valid, d), dtype=np.int8)
    voff = np.zeros((npad,), np.float32)
    voff[:n_valid] = rng.random(n_valid, dtype=np.float32) if voff_values is None else voff_values
    qcodes = rng.integers(0, 128, (q, d), dtype=np.int8)
    qoff = rng.random(q, dtype=np.float32)
    return qcodes, qoff, codes, voff


def _jax_args(qcodes, qoff, codes, voff):
    return tuple(jnp.asarray(a) for a in (qcodes, qoff, codes, voff))


def _torch_args(qcodes, qoff, codes, voff):
    return tuple(torch.from_numpy(a) for a in (qcodes, qoff, codes, voff))


def _jdt(dt: str):
    return j_types.DistanceType.from_json(dt)


def _tdt(dt: str):
    return DistanceType.from_json(dt)


def assert_topk_matches(gs, gi, ws, wi, scores, n_valid):
    """Values within tolerance; ids equal where the value is untied within
    the row's returned top-k; every id a distinct valid row whose score is
    the value claimed for its slot."""
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert (gi[r][live] < n_valid).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_allclose(scores[r, gi[r][live]], gs[r][live], rtol=RTOL, atol=ATOL)
        vals, counts = np.unique(ws[r], return_counts=True)
        untied = np.isin(ws[r], vals[counts == 1]) & (ws[r] != ws[r][-1])
        np.testing.assert_array_equal(gi[r][untied], wi[r][untied])


@pytest.mark.parametrize("dt", ["Dot", "L1", "L2"])
@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("per_query_mult", [False, True])
def test_scores_plain_matches_pallas(rng, dt, q, per_query_mult):
    n_valid, d = 700, 256
    arrs = _setup(rng, n_valid, d, q)
    mult = (rng.random(q, dtype=np.float32) + 0.1) if per_query_mult else np.float32(0.37)
    want = np.asarray(sq_scores_pallas(
        *_jax_args(*arrs), jnp.asarray(mult), distance_type=_jdt(dt),
        n_valid=n_valid, interpret=True,
    ))
    got = sq_kernel.sq_scores(
        *_torch_args(*arrs), torch.as_tensor(mult), distance_type=_tdt(dt), n_valid=n_valid,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "dt,n_valid,q,k",
    [
        ("Dot", 700, 5, 1),
        ("Dot", 700, 5, 10),
        ("L2", 700, 5, 1),
        ("L2", 700, 5, 10),
        ("Dot", 2000, 3, 100),
        ("Dot", 2000, 3, 256),
        ("Dot", 2000, 3, 600),
        ("Dot", 600, 2, 600),
    ],
)
def test_exact_search_plain_matches_pallas(rng, dt, n_valid, q, k):
    d = 256
    arrs = _setup(rng, n_valid, d, q)
    mult = np.float32(0.37)
    ws, wi = sq_search_pallas(
        *_jax_args(*arrs), jnp.asarray(mult), distance_type=_jdt(dt),
        n_valid=n_valid, k=k, interpret=True,
    )
    gs, gi = sq_kernel.sq_search(
        *_torch_args(*arrs), torch.as_tensor(mult), distance_type=_tdt(dt),
        n_valid=n_valid, k=k, mode="exact",
    )
    assert gi.dtype == torch.int32 and tuple(gs.shape) == (q, k)
    scores = np.asarray(j_sq.score_batch_xla(
        *_jax_args(arrs[0], arrs[1], arrs[2][:n_valid], arrs[3][:n_valid]),
        jnp.asarray(mult), distance_type=_jdt(dt),
    ))
    assert_topk_matches(gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi), scores, n_valid)


def test_exact_search_adversarial_class_collision(rng):
    """The 10 best rows all in one stride class (ids 0, 128, ..., 1152)."""
    n_valid, d, q, k = 3000, 256, 2, 10
    voff = rng.random(n_valid, dtype=np.float32)
    top = np.arange(10) * ktile.SLOT
    voff[top] = 1000.0 + np.arange(10)
    qcodes, qoff, codes, voff_p = _setup(rng, n_valid, d, q, voff_values=voff)
    codes[:] = 0
    qcodes[:] = 0
    arrs = (qcodes, qoff, codes, voff_p)
    ws, wi = sq_search_pallas(
        *_jax_args(*arrs), jnp.float32(1.0), distance_type=_jdt("Dot"),
        n_valid=n_valid, k=k, interpret=True,
    )
    gs, gi = sq_kernel.sq_search(
        *_torch_args(*arrs), torch.tensor(1.0), distance_type=DistanceType.DOT,
        n_valid=n_valid, k=k,
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi.numpy()[0], top[::-1])
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)


def test_exact_search_k_beyond_n_valid(rng):
    """k > n_valid: every valid row, then empty slots holding -inf / -1 —
    the JAX package's output (its blocked fallback pads so, ops/topk.py:49-57)
    and, since ROADMAP F11 was repaired, the port's fused search's too."""
    n_valid, d, q, k = 600, 256, 2, 700
    arrs = _setup(rng, n_valid, d, q)
    mult = np.float32(0.5)
    ws, wi = sq_search_pallas(
        *_jax_args(*arrs), jnp.asarray(mult), distance_type=_jdt("Dot"),
        n_valid=n_valid, k=k, interpret=True,
    )
    gs, gi = sq_kernel.sq_search(
        *_torch_args(*arrs), torch.as_tensor(mult), distance_type=DistanceType.DOT,
        n_valid=n_valid, k=k,
    )
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    scores = np.asarray(j_sq.score_batch_xla(
        *_jax_args(arrs[0], arrs[1], arrs[2][:n_valid], arrs[3][:n_valid]),
        jnp.asarray(mult), distance_type=_jdt("Dot"),
    ))
    assert_topk_matches(gs[:, :n_valid], gi[:, :n_valid], ws[:, :n_valid],
                        wi[:, :n_valid], scores, n_valid)
    np.testing.assert_array_equal(gs[:, n_valid:], ws[:, n_valid:])
    np.testing.assert_array_equal(gi[:, n_valid:], wi[:, n_valid:])
    assert np.isneginf(gs[:, n_valid:]).all() and (gi[:, n_valid:] == -1).all()


@pytest.mark.parametrize(
    "n_valid,d,k,min_overlap",
    [
        (2000, 256, 40, 0.8),  # npad 2048: one 2048-row tile
        (2100, 128, 10, 0.8),  # npad 2560: five 512-row tiles, a partial span
        (3000, 128, 10, 0.8),  # npad 3072: three 1024-row tiles
        (9000, 128, 10, 0.8),  # npad 9216: nine 1024-row tiles
        # k > SLOT from a pool of only 3 x 128 candidates: the geometry
        # itself loses entries, so this case checks parity with JAX only.
        (9000, 128, 150, None),
    ],
)
def test_approx_search_plain_matches_pallas(rng, n_valid, d, k, min_overlap):
    """Same candidate geometry as the Pallas kernel; JAX merges with
    approx_max_k, which on the CPU is an exact sort, so values match and
    ids match up to ties. Against exact top-k: every pair is a true
    (score[id], id) pair and the overlap is at least 0.8 per query."""
    q = 4
    arrs = _setup(rng, n_valid, d, q)
    mult = np.float32(0.37)
    ws, wi = sq_search_pallas(
        *_jax_args(*arrs), jnp.asarray(mult), distance_type=_jdt("Dot"),
        n_valid=n_valid, k=k, mode="approx", interpret=True,
    )
    gs, gi = sq_kernel.sq_search(
        *_torch_args(*arrs), torch.as_tensor(mult), distance_type=DistanceType.DOT,
        n_valid=n_valid, k=k, mode="approx",
    )
    scores = np.asarray(j_sq.score_batch_xla(
        *_jax_args(arrs[0], arrs[1], arrs[2][:n_valid], arrs[3][:n_valid]),
        jnp.asarray(mult), distance_type=_jdt("Dot"),
    ))
    gs, gi = gs.numpy(), gi.numpy()
    assert_topk_matches(gs, gi, np.asarray(ws), np.asarray(wi), scores, n_valid)
    if min_overlap is None:
        return
    _, ei = topk_exact(jnp.asarray(scores), k)
    for r in range(q):
        overlap = len(set(gi[r].tolist()) & set(np.asarray(ei)[r].tolist())) / k
        assert overlap >= min_overlap, overlap


def test_approx_search_k_beyond_live_candidates(rng):
    """Rows past n_valid score NEG but keep their padding ids as candidates,
    in both packages: a k larger than the live pool returns such ids."""
    n_valid, d, q, k = 100, 128, 2, 120
    arrs = _setup(rng, n_valid, d, q)
    mult = np.float32(0.37)
    ws, wi = sq_search_pallas(
        *_jax_args(*arrs), jnp.asarray(mult), distance_type=_jdt("Dot"),
        n_valid=n_valid, k=k, mode="approx", interpret=True,
    )
    gs, gi = sq_kernel.sq_search(
        *_torch_args(*arrs), torch.as_tensor(mult), distance_type=DistanceType.DOT,
        n_valid=n_valid, k=k, mode="approx",
    )
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    np.testing.assert_allclose(gs[:, :n_valid], ws[:, :n_valid], rtol=RTOL, atol=ATOL)
    for got_s, got_i in ((gs, gi), (ws, wi)):
        assert (got_s[:, n_valid:] == np.float32(ktile.NEG)).all()
        assert ((got_i[:, n_valid:] >= n_valid) & (got_i[:, n_valid:] < ktile.SLOT)).all()


def test_approx_candidates_geometry():
    """Slot l of block b is the first maximum over rows b*SPAN*tile_n +
    m*SLOT + l; rows beyond npad do not exist."""
    q, tile_n = 2, 512
    npad = 5 * tile_n  # two span blocks, the second holding one tile
    scores = torch.zeros((q, npad))
    scores[0, 3] = 5.0
    scores[0, 3 + 2 * ktile.SLOT] = 5.0  # tie in the same class: row 3 wins
    scores[1, 4 * tile_n + 7] = 9.0
    vals, ids = ktile.approx_candidates(scores, tile_n)
    assert tuple(vals.shape) == (q, 2 * ktile.SLOT)
    assert vals[0, 3] == 5.0 and ids[0, 3] == 3
    assert vals[1, ktile.SLOT + 7] == 9.0 and ids[1, ktile.SLOT + 7] == 4 * tile_n + 7
    assert ids[0, 1] == 1 and ids[0, ktile.SLOT + 1] == 4 * tile_n + 1


@pytest.mark.parametrize("npad", [512, 1024, 1536, 2048, 3072, 100352])
def test_approx_tile_width_matches_pallas_rule(npad):
    want = 512
    while want * 2 <= 2048 and npad % (want * 2) == 0:
        want *= 2
    assert sq_kernel.approx_tile_n(npad) == want


def test_search_rejects_bad_arguments(rng):
    arrs = _torch_args(*_setup(rng, 100, 128, 2))
    kw = dict(distance_type=DistanceType.DOT, n_valid=100)
    with pytest.raises(Exception, match="k <= 1024"):
        sq_kernel.sq_search(*arrs, torch.tensor(1.0), k=1025, **kw)
    with pytest.raises(Exception, match="mode"):
        sq_kernel.sq_search(*arrs, torch.tensor(1.0), k=5, mode="fast", **kw)
    before = dict(sq_kernel.LAUNCHES)
    sq_kernel.sq_search(*arrs, torch.tensor(1.0), k=5, **kw)
    assert sq_kernel.LAUNCHES == before  # CPU tensors take the plain version
