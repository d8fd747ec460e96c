"""The plain versions of the port's residual-BQ kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU: K5b
(``bq_search`` exact with a value query), K5a (approx with a value query)
and K10 (``bq_search_indexed`` with a value query), with and without the
bucket additive ``corr``, with one multiplier for all queries and one per
query, and k beyond n_valid; and the per-row additive ``rowadd``, which the
JAX kernels do not take, against the compiled ``score_affine_xla``.

Tolerance: none. The JAX kernels' compiled epilogue fuses ``mult * acc +
qb`` into one multiply-add; the port computes it in f64 and rounds once
(ROADMAP F24), then adds ``corr`` in f32 as both do, so values are equal to
the bit. Ids: equal where the value is untied (the scores are integers
times a per-query multiplier, so they tie, and the final merges order tied
candidates their own way); every id a distinct valid row. The hand-written CUDA kernels
are held to these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.bq as j_bq
import quantization_tpu.ops.pallas.bq_kernel as j_kernel
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel

torch.set_num_threads(1)

Q = 5
KW = dict(distance_type=DistanceType.DOT, invert=False)
JKW = dict(distance_type=j_types.DistanceType.DOT, invert=False)


def _setup(rng, npad, dim, per_query):
    """Seeded planes [W8, npad] (uint32) and a residual value query (qs int8
    [Q, W8*32], 0 past dim; mult scalar or [Q, 1]; qb [Q, 1]) built as the
    JAX package's ``_residual_query_bq`` builds it."""
    w = -(-dim // 32)
    w8 = w + (-w) % 8
    planes = np.zeros((w8, npad), np.uint32)
    planes[:w] = rng.integers(0, 2**32, (w, npad), dtype=np.uint64).astype(np.uint32)
    if dim % 32:
        planes[w - 1] &= np.uint32((1 << (dim % 32)) - 1)
    qs = np.zeros((Q, w8 * 32), np.int8)
    qs[:, :dim] = rng.integers(-127, 128, (Q, dim))
    aq = (rng.random((Q, 1)) * 0.05 + 0.001).astype(np.float32)
    ab = (np.float32(0.37) * aq).astype(np.float32)
    if not per_query:
        ab = np.full((Q, 1), ab[0, 0], np.float32)
    mult = (2.0 * ab).astype(np.float32)
    qb = (-ab * qs.astype(np.float32).sum(1, keepdims=True)).astype(np.float32)
    if not per_query:
        mult = mult[:1, 0]  # (1,)
    return planes, (qs, mult, qb)


def _jax_aff(aff):
    return tuple(jnp.asarray(a) for a in aff)


def _torch_aff(aff):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in aff)


def _untied_ids_equal(gs, gi, ws, wi):
    for r in range(gs.shape[0]):
        vals, counts = np.unique(ws[r], return_counts=True)
        untied = np.isin(ws[r], vals[counts == 1]) & (ws[r] != ws[r][-1])
        np.testing.assert_array_equal(gi[r][untied], wi[r][untied])


def _ids_valid(gi, allowed):
    for r in range(gi.shape[0]):
        live = gi[r] >= 0
        assert np.isin(gi[r][live], allowed).all()
        assert len(set(gi[r][live].tolist())) == int(live.sum())


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("dim", [200, 128])
def test_k5_value_query_plain_matches_pallas(rng, dim, mode, with_corr, per_query):
    npad, n_valid, k = 4096, 3900, 20
    planes, aff = _setup(rng, npad, dim, per_query)
    corr = (rng.standard_normal((Q, npad // 512)) * 3).astype(np.float32) if with_corr \
        else None
    ws, wi = j_kernel.bq_search_mxu(
        None, jnp.asarray(planes), None if corr is None else jnp.asarray(corr), **JKW,
        dim=dim, n_valid=n_valid, k=k, mode=mode, interpret=True,
        query_affine=_jax_aff(aff))
    gs, gi = bq_kernel.bq_search(
        None, t_bq.words_to_tensor(planes, "cpu"),
        None if corr is None else torch.from_numpy(corr), **KW, dim=dim, n_valid=n_valid,
        k=k, mode=mode, query_affine=_torch_aff(aff))
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32 and tuple(gs.shape) == (Q, k)
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    np.testing.assert_array_equal(gs, ws)
    _ids_valid(gi, np.arange(n_valid))
    _untied_ids_equal(gs, gi, ws, wi)


def test_k5b_k_beyond_n_valid(rng):
    """k > n_valid: every valid row, then -inf / -1 (F11), as the JAX
    package's exact search returns them."""
    npad, n_valid, k = 2048, 700, 1000
    planes, aff = _setup(rng, npad, 96, True)
    corr = (rng.standard_normal((Q, npad // 512)) * 3).astype(np.float32)
    ws, wi = j_kernel.bq_search_mxu(
        None, jnp.asarray(planes), jnp.asarray(corr), **JKW, dim=96, n_valid=n_valid, k=k,
        mode="exact", interpret=True, query_affine=_jax_aff(aff))
    gs, gi = bq_kernel.bq_search(
        None, t_bq.words_to_tensor(planes, "cpu"), torch.from_numpy(corr), **KW, dim=96,
        n_valid=n_valid, k=k, mode="exact", query_affine=_torch_aff(aff))
    gs, gi, ws, wi = gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)
    np.testing.assert_array_equal(gs, ws)
    assert np.isneginf(gs[:, n_valid:]).all() and (gi[:, n_valid:] == -1).all()
    np.testing.assert_array_equal(wi[:, n_valid:], -1)
    for r in range(Q):
        assert sorted(gi[r, :n_valid].tolist()) == list(range(n_valid))


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("tile_n,dim,per_query", [(512, 200, True), (1024, 128, False),
                                                  (2048, 64, True)])
def test_k10_value_query_plain_matches_pallas(rng, tile_n, dim, per_query, with_corr):
    npad, k, t = 8192, 20, 3
    planes, aff = _setup(rng, npad, dim, per_query)
    sel = rng.permutation(npad // tile_n)[:t].astype(np.int32)
    if (np.diff(sel) == 1).all():
        sel = sel[::-1].copy()
    corr = (rng.standard_normal((t * tile_n // 512, Q)) * 3).astype(np.float32) \
        if with_corr else None
    ws, wi = j_kernel.bq_search_indexed(
        None, jnp.asarray(planes), jnp.asarray(sel),
        None if corr is None else jnp.asarray(corr), **JKW, dim=dim, k=k, tile_n=tile_n,
        interpret=True, query_affine=_jax_aff(aff))
    gs, gi = bq_kernel.bq_search_indexed(
        None, t_bq.words_to_tensor(planes, "cpu"), torch.from_numpy(sel),
        None if corr is None else torch.from_numpy(corr), **KW, dim=dim, k=k,
        tile_n=tile_n, query_affine=_torch_aff(aff))
    rows = (sel.astype(np.int64)[:, None] * tile_n + np.arange(tile_n)).reshape(-1)
    gs, gi = gs.numpy(), gi.numpy()
    np.testing.assert_array_equal(gs, np.asarray(ws))
    _untied_ids_equal(gs, gi, np.asarray(ws), np.asarray(wi))
    _ids_valid(gi, rows)


@pytest.mark.parametrize("per_query", [False, True])
def test_score_affine_matches_xla(rng, per_query):
    """The plain score matrix against ``score_affine_xla`` compiled (whose
    multiply-add is fused, F24), over more than one tile of the plain
    version."""
    import jax

    planes, aff = _setup(rng, 5000, 200, per_query)
    want = np.asarray(jax.jit(j_bq.score_affine_xla, static_argnames="tile")(
        *_jax_aff(aff), jnp.asarray(planes), tile=2048))
    got = t_bq.score_affine(*_torch_aff(aff), t_bq.words_to_tensor(planes, "cpu"), tile=1536)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_bits_order(rng):
    planes = rng.integers(0, 2**32, (3, 7), dtype=np.uint64).astype(np.uint32)
    got = t_bq.unpack_bits(t_bq.words_to_tensor(planes, "cpu")).numpy()
    want = ((planes[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1)
    np.testing.assert_array_equal(got, want.reshape(96, 7))


@pytest.mark.parametrize("operand", ["corr", "rowadd"])
def test_corr_needs_a_value_query(rng, operand):
    planes, aff = _setup(rng, 2048, 64, False)
    qwords = torch.zeros((Q, planes.shape[0]), dtype=torch.int32)
    extra = {"corr": torch.zeros((Q, 4))} if operand == "corr" else {
        "rowadd": torch.zeros(2048)}
    with pytest.raises(Exception, match="value query"):
        bq_kernel.bq_search(qwords, t_bq.words_to_tensor(planes, "cpu"), **extra, **KW,
                            dim=64, n_valid=2048, k=5)


@pytest.mark.parametrize("mode", ["exact", "approx", "indexed"])
def test_rowadd_poisons_rows(rng, mode):
    """``rowadd`` (residual IVF-BQ's NEG on pad slots, ROADMAP F25) is added
    per row after the affine and before ``corr``: zeros change nothing, a
    row given NEG is never returned, and exact values equal a top-k of the
    JAX package's compiled ``score_affine_xla`` + rowadd + corr."""
    import jax

    npad, dim, k, tile_n = 4096, 200, 20, 1024
    planes, aff = _setup(rng, npad, dim, True)
    tp, taff = t_bq.words_to_tensor(planes, "cpu"), _torch_aff(aff)
    sel = np.array([3, 0, 2], np.int32)
    rows = (sel.astype(np.int64)[:, None] * tile_n + np.arange(tile_n)).reshape(-1)
    if mode == "indexed":
        corr = (rng.standard_normal((rows.size // 512, Q)) * 3).astype(np.float32)

        def search(rowadd):
            return bq_kernel.bq_search_indexed(
                None, tp, torch.from_numpy(sel), torch.from_numpy(corr), **KW, dim=dim, k=k,
                tile_n=tile_n, query_affine=taff, rowadd=rowadd)
    else:
        corr = (rng.standard_normal((Q, npad // 512)) * 3).astype(np.float32)

        def search(rowadd):
            return bq_kernel.bq_search(
                None, tp, torch.from_numpy(corr), **KW, dim=dim, n_valid=npad, k=k,
                mode=mode, query_affine=taff, rowadd=rowadd)

    base = search(None)
    zero = search(torch.zeros(npad))
    assert torch.equal(base[0], zero[0]) and torch.equal(base[1], zero[1])
    rowadd = np.zeros(npad, np.float32)
    rowadd[base[1].numpy().reshape(-1)] = bq_kernel.NEG  # poison every row it found
    gs, gi = (t.numpy() for t in search(torch.from_numpy(rowadd)))
    assert not np.isin(gi, base[1].numpy()).any()
    _ids_valid(gi, rows if mode == "indexed" else np.arange(npad))
    if mode == "exact":
        scores = np.asarray(jax.jit(j_bq.score_affine_xla, static_argnames="tile")(
            *_jax_aff(aff), jnp.asarray(planes), tile=2048))
        want = (scores + rowadd[None, :]) + np.repeat(corr, 512, axis=1)
        np.testing.assert_array_equal(gs, -np.sort(-want, axis=1)[:, :k])
