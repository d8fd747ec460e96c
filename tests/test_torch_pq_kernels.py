"""The plain versions of the port's PQ kernels (K8 scores, K7b exact search,
K7a approx search) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, for the int8, bf16 and bf16x2 LUTs and 8-bit and
4-bit codes.

Tolerances, with their causes:
  * bf16 and bf16x2 scores, 8-bit codes: none. Both packages sum the same
    bf16 entries in f32 in chunk order, with the same lo-word folds.
  * the same, 4-bit codes: 1 ulp. The JAX kernel sums each group of 8 chunks
    in one matmul, whose order is XLA's CPU dot's; the port sums the group in
    pairs, which matched every score probed on this CPU, but the order is not
    the algorithm's (ROADMAP Queue 3, F19).
  * int8 scores: 2 ulp of |score| + |bias|. Both take the same int8 LUT, the
    same integer sums and the epilogue rounded once (JAX's compiled code
    fuses scale * acc + bias into a multiply-add; the port computes it in f64
    and rounds once), but the bias, a sum of per-chunk mids, is summed in an
    order that matches XLA's only for m <= 32 or m a multiple of 32
    (ROADMAP Queue 3, F14).
  * exact top-k: values within the score tolerance; ids up to ties (each a
    distinct valid row whose plain score is its slot's value).
  * approx candidates: the same geometry and tie rule, so ids compare whole.

The hand-written CUDA kernels are held to these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.pq_kernel as j_kernel
from quantization_tpu_torch.ops.kernels import ktile, pq_kernel

torch.set_num_threads(1)

PRECISIONS = ("int8", "bf16", "bf16x2")
# (kc, m, n_valid, q): 8-bit and 4-bit codes; n_valid not a multiple of 1024,
# q not a multiple of 8.
SHAPES = [(256, 16, 2500, 5), (16, 32, 3100, 13)]
SHAPE_IDS = ["8bit", "4bit"]


def _setup(rng, kc, m, n_valid, q):
    """A seeded LUT f32 [Q, m, kc] at data scale and codes u8 [Mpad, Npad]
    (zero past m and n_valid)."""
    lut = (rng.standard_normal((q, m, kc)) * 2.0 + rng.standard_normal((q, m, 1))).astype(
        np.float32)
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = np.zeros((mpad, npad), np.uint8)
    codes_t[:m, :n_valid] = rng.integers(0, kc, (m, n_valid))
    return lut, codes_t


def _int8_tol(want, lut):
    _, _, bias = pq_kernel.quantize_lut(torch.from_numpy(lut))
    return 2 * np.spacing(np.abs(want) + np.abs(bias.numpy())[:, None])


def _assert_scores(got, want, lut, precision):
    if precision == "int8":
        assert (np.abs(got - want) <= _int8_tol(want, lut)).all()
    elif lut.shape[2] == pq_kernel.K4:
        assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    else:
        np.testing.assert_array_equal(got, want)


def _plain_scores(lut, codes_t, n, precision):
    """The port's plain scores over rows [0, n) (bf16x2 included, which
    pq_scores maps to bf16)."""
    return pq_kernel.lut_scores_plain(torch.from_numpy(lut), torch.from_numpy(codes_t),
                                      n_valid=n, precision=precision).numpy()


def assert_ids_valid(gs, gi, scores, n_valid):
    """Every live id is a distinct row < n_valid whose score is its value."""
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert (gi[r][live] < n_valid).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_array_equal(scores[r, gi[r][live]], gs[r][live])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kc,m,n_valid,q", SHAPES, ids=SHAPE_IDS)
def test_scores_plain_equal_pallas(rng, precision, kc, m, n_valid, q):
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    want = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut), jnp.asarray(codes_t), n_valid=n_valid, interpret=True,
        precision=precision))
    got = pq_kernel.pq_scores(torch.from_numpy(lut), torch.from_numpy(codes_t),
                              n_valid=n_valid, precision=precision)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n_valid)
    _assert_scores(got.numpy(), want, lut, precision)


@pytest.mark.parametrize("kc,m,n_valid,q", SHAPES, ids=SHAPE_IDS)
def test_int8_scores_within_quantization_bound(rng, kc, m, n_valid, q):
    """|int8 score - f32-LUT score| <= m * scale / 2 + 1e-5 against an f64
    oracle: each entry is off by at most half a step."""
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    got = pq_kernel.pq_scores(torch.from_numpy(lut), torch.from_numpy(codes_t),
                              n_valid=n_valid, precision="int8").numpy()
    idx = codes_t[:m, :n_valid].astype(np.int64)
    oracle = lut.astype(np.float64)[:, np.arange(m)[:, None], idx].sum(axis=1)
    _, scale, _ = pq_kernel.quantize_lut(torch.from_numpy(lut))
    bound = m * scale.double().numpy()[:, None] / 2 + 1e-5
    assert (np.abs(got - oracle) <= bound).all()


@pytest.mark.parametrize("precision,k", [("int8", 10), ("bf16", 10), ("bf16x2", 10),
                                         ("int8", 300)])
@pytest.mark.parametrize("kc,m,n_valid,q", SHAPES, ids=SHAPE_IDS)
def test_exact_search_plain_equal_pallas(rng, precision, kc, m, n_valid, q, k):
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    ws, wi = j_kernel.pq_search_pallas(
        jnp.asarray(lut), jnp.asarray(codes_t), n_valid=n_valid, k=k, mode="exact",
        interpret=True, precision=precision)
    gs, gi = pq_kernel.pq_search(torch.from_numpy(lut), torch.from_numpy(codes_t),
                                 n_valid=n_valid, k=k, precision=precision)
    assert gi.dtype == torch.int32 and tuple(gs.shape) == (q, k)
    ws, wi = np.asarray(ws), np.asarray(wi)
    _assert_scores(gs.numpy(), ws, lut, precision)
    scores = _plain_scores(lut, codes_t, n_valid, precision)
    assert_ids_valid(gs.numpy(), gi.numpy(), scores, n_valid)
    # The JAX ids, scored by the port, give the JAX values (ids up to ties).
    picked = np.take_along_axis(scores, wi.astype(np.int64), axis=1)
    _assert_scores(picked, ws, lut, precision)


@pytest.mark.parametrize("precision", ["bf16", "bf16x2"])
def test_exact_search_bf16_fallback_divergence(rng, precision):
    """Where the JAX exact kernel cannot hold k (k > r * width), its fallback
    scores with the f32 LUT, not the bf16 words (pq_kernel.py:827-830); the
    port always selects over the LUT scores of its precision, the values of
    the JAX kernel path (ROADMAP Queue 3, F17). Both are exact top-k of their
    own scores, which differ by the bf16 rounding of m entries."""
    kc, m, n_valid, q, k = 256, 16, 2500, 3, 300
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    ws, _ = j_kernel.pq_search_pallas(
        jnp.asarray(lut), jnp.asarray(codes_t), n_valid=n_valid, k=k, mode="exact",
        interpret=True, precision=precision)
    idx = codes_t[:m, :n_valid].astype(np.int64)
    f32 = lut[:, np.arange(m)[:, None], idx].astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(np.asarray(ws), -np.sort(-f32, axis=1)[:, :k], rtol=1e-6,
                               atol=1e-5)
    gs, _ = pq_kernel.pq_search(torch.from_numpy(lut), torch.from_numpy(codes_t),
                                n_valid=n_valid, k=k, precision=precision)
    own = _plain_scores(lut, codes_t, n_valid, precision)
    np.testing.assert_array_equal(gs.numpy(), -np.sort(-own, axis=1)[:, :k])
    bf16_step = 2.0 ** -8 if precision == "bf16" else 2.0 ** -16
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= m * bf16_step * np.abs(lut).max()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_exact_search_k_beyond_n_valid(rng, precision):
    """k > n_valid: every valid row, then -inf / -1 from the port. The JAX
    package agrees for the int8 LUT; its f32-keyed kernel (bf16, bf16x2)
    fills the slots with padding rows scored NEG (ROADMAP Queue 3, F18)."""
    kc, m, n_valid, q, k = 16, 16, 100, 3, 150
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    ws, wi = j_kernel.pq_search_pallas(
        jnp.asarray(lut), jnp.asarray(codes_t), n_valid=n_valid, k=k, mode="exact",
        interpret=True, precision=precision)
    gs, gi = pq_kernel.pq_search(torch.from_numpy(lut), torch.from_numpy(codes_t),
                                 n_valid=n_valid, k=k, precision=precision)
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    _assert_scores(gs[:, :n_valid], ws[:, :n_valid], lut, precision)
    assert np.isneginf(gs[:, n_valid:]).all() and (gi[:, n_valid:] == -1).all()
    assert (np.sort(gi[:, :n_valid], axis=1) == np.arange(n_valid)).all()
    if precision == "int8":
        np.testing.assert_array_equal(wi[:, n_valid:], gi[:, n_valid:])
    else:
        assert (ws[:, n_valid:] == np.float32(ktile.NEG)).all()
        assert (wi[:, n_valid:] >= n_valid).all()


def _jax_approx_candidates(lut, codes_t, **kw):
    """The JAX approx kernel's candidate slots before its merge: the merge is
    swapped for the identity around an unjitted call."""
    orig = j_kernel.merge_tile_topk_all
    j_kernel.merge_tile_topk_all = lambda v, i, k, recall_target: (v, i)
    try:
        v, i = j_kernel.pq_search_pallas.__wrapped__(
            jnp.asarray(lut), jnp.asarray(codes_t), mode="approx", interpret=True, **kw)
    finally:
        j_kernel.merge_tile_topk_all = orig
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kc,m,n_valid,q", [(256, 16, 5000, 3), (16, 32, 3100, 5)],
                         ids=SHAPE_IDS)
def test_approx_candidates_equal_pallas(rng, precision, kc, m, n_valid, q):
    lut, codes_t = _setup(rng, kc, m, n_valid, q)
    jv, ji = _jax_approx_candidates(lut, codes_t, n_valid=n_valid, k=10,
                                    precision=precision)
    scores = torch.from_numpy(_plain_scores(lut, codes_t, codes_t.shape[1], precision))
    scores[:, n_valid:] = ktile.NEG
    tv, ti = ktile.approx_candidates(scores, pq_kernel.TILE_N)
    np.testing.assert_array_equal(ti.numpy(), ji)
    live = tv.numpy() > ktile.NEG
    _assert_scores(np.where(live, tv.numpy(), 0), np.where(live, jv, 0), lut, precision)
    # The final approx top-k: the best candidates, all true scores.
    gs, gi = pq_kernel.pq_search(torch.from_numpy(lut), torch.from_numpy(codes_t),
                                 n_valid=n_valid, k=10, mode="approx", precision=precision)
    np.testing.assert_array_equal(gs.numpy(), torch.topk(tv, 10, dim=1).values.numpy())
    assert_ids_valid(gs.numpy(), gi.numpy(), scores.numpy(), n_valid)


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


@pytest.mark.parametrize("what", ["4bit_group_sum", "int8_bias_sum"])
def test_summation_order_is_needed(rng, what):
    """Why the plain versions (and the kernels) do not simply add in chunk
    order: the JAX package's sums, in XLA's CPU order, would then miss the
    stated tolerances. The 4-bit bf16 scores (m = 32) are summed per group
    of GRP4 chunks in pairs; the int8 bias (m = 96) in blocks of 32 chunks.
    Each meets its tolerance; a sum in chunk order misses it."""
    if what == "4bit_group_sum":
        lut, codes_t = _setup(rng, 16, 32, 3100, 13)
        want = np.asarray(j_kernel.pq_scores_pallas(
            jnp.asarray(lut), jnp.asarray(codes_t), n_valid=3100, interpret=True,
            precision="bf16"))
        port = _plain_scores(lut, codes_t, 3100, "bf16")
        words = torch.from_numpy(lut).to(torch.bfloat16).float().numpy()
        idx = codes_t[:32, :3100].astype(np.int64)
        in_order = np.zeros_like(want)
        for c in range(32):
            in_order += words[:, c, idx[c]]
        tol_ulps = 1
    else:
        q, m = 16, 96
        lut = (rng.standard_normal((q, m, 256)) * 3 + 1).astype(np.float32)
        _, _, jb = j_kernel._quantize_lut(jnp.asarray(lut), m, q)
        want = np.asarray(jb)[:, 0]
        port = pq_kernel.quantize_lut(torch.from_numpy(lut))[2].numpy()
        mid = 0.5 * (lut.max(axis=2) + lut.min(axis=2))
        in_order = np.zeros(q, np.float32)
        for c in range(m):
            in_order += mid[:, c]
        tol_ulps = 2
    assert _ulps(port, want).max() <= tol_ulps
    assert _ulps(in_order, want).max() > tol_ulps


@pytest.mark.parametrize("kc,m", [(256, 16), (16, 40), (256, 7)])
def test_quantize_and_split_equal_jax(rng, kc, m):
    """The int8 LUT and scale equal the JAX package's to the bit, the bias
    within 2 ulp (to the bit where m <= 32); the bf16x2 words equal
    ``_split_lut_bf16x2``'s, and lo is not zero."""
    q = 6
    lut = (rng.standard_normal((q, m, kc)) * 3 + 1).astype(np.float32)
    mpad = m + (-m) % pq_kernel.M_BLK
    jq, js, jb = (np.asarray(a) for a in j_kernel._quantize_lut(jnp.asarray(lut), mpad, q))
    tq, ts, tb = pq_kernel.quantize_lut(torch.from_numpy(lut))
    np.testing.assert_array_equal(tq.numpy(), jq.reshape(q, mpad, kc)[:, :m])
    np.testing.assert_array_equal(ts.numpy(), js[:, 0])
    if m <= 32:
        np.testing.assert_array_equal(tb.numpy(), jb[:, 0])
    assert (np.abs(tb.numpy() - jb[:, 0]) <= 2 * np.spacing(np.abs(jb[:, 0]))).all()
    flat = jnp.asarray(lut.reshape(q, m * kc))
    jhi, jlo = j_kernel._split_lut_bf16x2(flat)
    thi, tlo = pq_kernel.split_lut_bf16x2(torch.from_numpy(lut))
    np.testing.assert_array_equal(
        thi.view(torch.int16).numpy().reshape(q, -1), np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(
        tlo.view(torch.int16).numpy().reshape(q, -1), np.asarray(jlo).view(np.int16))
    assert bool((tlo != 0).any())
    recon = thi.float() + tlo.float() / pq_kernel.LO_SCALE
    assert float((recon - torch.from_numpy(lut)).abs().max()) < 2.0 ** -14 * np.abs(lut).max()


def test_lut_precision_follows_the_jax_contract(monkeypatch):
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)
    assert pq_kernel.lut_precision() == j_kernel._lut_precision() == "int8"
    assert pq_kernel.lut_precision(residual=True) == "bf16x2"
    monkeypatch.setenv("QTPU_PQ_LUT", "bf16")
    assert pq_kernel.lut_precision() == j_kernel._lut_precision() == "bf16"
    assert pq_kernel.scores_precision("bf16x2") == "bf16"


def test_search_rejects_bad_arguments(rng):
    lut, codes_t = _setup(rng, 256, 16, 100, 2)
    tl, tc = torch.from_numpy(lut), torch.from_numpy(codes_t)
    with pytest.raises(Exception, match="k <= 1024"):
        pq_kernel.pq_search(tl, tc, n_valid=100, k=1025)
    with pytest.raises(Exception, match="mode"):
        pq_kernel.pq_search(tl, tc, n_valid=100, k=5, mode="fast")
    with pytest.raises(Exception, match="precision"):
        pq_kernel.pq_search(tl, tc, n_valid=100, k=5, precision="fp8")
    with pytest.raises(Exception, match="precision"):
        pq_kernel.pq_scores(tl, tc, n_valid=100, precision="fp8")
    before = dict(pq_kernel.LAUNCHES)
    pq_kernel.pq_search(tl, tc, n_valid=100, k=5)
    pq_kernel.pq_scores(tl, tc, n_valid=100)
    assert pq_kernel.LAUNCHES == before  # CPU tensors take the plain versions
