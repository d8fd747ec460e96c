"""The plain versions of the port's IVF kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU: K9b / K9a
(``sq_search_indexed`` exact / approx), K10 (``bq_search_indexed``) and K11
(``pq_search_indexed``) on a permuted, non-contiguous tile list, with and
without the residual additives, and the additive forms of K1, K2 (``corr``)
and K7a, K7b (``rowadd`` and ``corr``).

The JAX approx merge (``approx_max_k``) is an exact sort on the CPU, so
approx results compare like exact ones. Tolerances, with their causes:
  * SQ: rtol 1e-6 / atol 1e-4, the JAX package's own (XLA may fuse the
    epilogue's multiply-add where torch rounds each step);
  * BQ: none — integer scores;
  * PQ: those of tests/test_torch_pq_kernels.py (ROADMAP Queue 3, F14 and
    F19: 2 ulp of |score| + |bias| for the int8 LUT, 1 ulp at 4 bits, none
    for bf16 words at 8 bits), taken of |score| + |rowadd| + |corr|, since
    both additives are added in f32 after the LUT score;
  * ids: equal where the value is untied; every id a distinct corpus row
    of the selected tiles.
The hand-written CUDA kernels are held to these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.pallas.bq_kernel as j_bq_kernel
import quantization_tpu.ops.pallas.pq_kernel as j_pq_kernel
import quantization_tpu.ops.pallas.sq_kernel as j_sq_kernel
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel, pq_kernel, sq_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-4
Q = 5


def _selection(rng, n_tiles, t):
    """t tile ids out of n_tiles, permuted and never one contiguous run."""
    sel = rng.permutation(n_tiles)[:t].astype(np.int32)
    if (np.diff(sel) == 1).all():
        sel = sel[::-1].copy()
    return sel


def _rows(sel, tile_n):
    return (sel.astype(np.int64)[:, None] * tile_n + np.arange(tile_n)).reshape(-1)


def _assert_matches(gs, gi, ws, wi, allowed, tol):
    """Values within ``tol`` (array or scalar) of the JAX values; ids equal
    where the JAX value is untied; every id a distinct allowed row."""
    assert (np.abs(gs - ws) <= tol).all(), np.abs(gs - ws).max()
    for r in range(gs.shape[0]):
        assert np.isin(gi[r], allowed).all()
        assert len(set(gi[r].tolist())) == gi.shape[1]
        vals, counts = np.unique(ws[r], return_counts=True)
        untied = np.isin(ws[r], vals[counts == 1]) & (ws[r] != ws[r][-1])
        np.testing.assert_array_equal(gi[r][untied], wi[r][untied])


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ------------------------------------------------------------ SQ: K9, K1, K2


def _sq_setup(rng, npad, d=128):
    codes = rng.integers(0, 128, (npad, d), dtype=np.int8)
    voff = rng.random(npad, dtype=np.float32) * 10
    qcodes = rng.integers(-127, 128, (Q, d), dtype=np.int8)  # residual queries are signed
    qoff = rng.random(Q, dtype=np.float32)
    mult = (rng.random(Q, dtype=np.float32) + 0.5) * 1e-3
    return qcodes, qoff, codes, voff, mult


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("tile_n,t", [(512, 5), (1024, 3), (2048, 3)])
def test_k9_sq_indexed_plain_matches_pallas(rng, tile_n, t, mode, with_corr):
    npad, k = 8192, 10
    arrs = _sq_setup(rng, npad)
    sel = _selection(rng, npad // tile_n, t)
    corr = (rng.standard_normal((t * tile_n // 512, Q)) * 3).astype(np.float32) \
        if with_corr else None
    ws, wi = j_sq_kernel.sq_search_indexed(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(sel),
        None if corr is None else jnp.asarray(corr),
        distance_type=j_types.DistanceType.DOT, k=k, mode=mode, tile_n=tile_n,
        interpret=True)
    gs, gi = sq_kernel.sq_search_indexed(
        *_t(*arrs), torch.from_numpy(sel), None if corr is None else torch.from_numpy(corr),
        distance_type=DistanceType.DOT, k=k, mode=mode, tile_n=tile_n)
    assert gi.dtype == torch.int32 and tuple(gs.shape) == (Q, k)
    ws = np.asarray(ws)
    _assert_matches(gs.numpy(), gi.numpy(), ws, np.asarray(wi), _rows(sel, tile_n),
                    RTOL * np.abs(ws) + ATOL)


@pytest.mark.parametrize("dt", ["Dot", "L2"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_k1_k2_corr_plain_matches_pallas(rng, mode, dt):
    n_valid, k = 3000, 10
    npad = n_valid + (-n_valid) % sq_kernel.TILE_N
    qcodes, qoff, codes, voff, mult = _sq_setup(rng, npad)
    codes[n_valid:], voff[n_valid:] = 0, 0
    corr = (rng.standard_normal((Q, npad // 512)) * 3).astype(np.float32)
    ws, wi = j_sq_kernel.sq_search_pallas(
        *(jnp.asarray(a) for a in (qcodes, qoff, codes, voff, mult, corr)),
        distance_type=j_types.DistanceType.from_json(dt), n_valid=n_valid, k=k, mode=mode,
        interpret=True)
    gs, gi = sq_kernel.sq_search(
        *_t(qcodes, qoff, codes, voff, mult, corr),
        distance_type=DistanceType.from_json(dt), n_valid=n_valid, k=k, mode=mode)
    ws = np.asarray(ws)
    _assert_matches(gs.numpy(), gi.numpy(), ws, np.asarray(wi), np.arange(n_valid),
                    RTOL * np.abs(ws) + ATOL)


# ------------------------------------------------------------------ BQ: K10


@pytest.mark.parametrize("tile_n,dim", [(512, 200), (1024, 128), (2048, 64)])
def test_k10_bq_indexed_plain_matches_pallas(rng, tile_n, dim):
    npad, k = 8192, 20
    row_bytes = t_bq.storage_bytes(dim, "u128")
    planes = t_bq.rows_to_planes(t_bq.pack_rows(
        rng.standard_normal((npad, dim)).astype(np.float32), row_bytes))
    w = planes.shape[0]
    w8 = w + (-w) % 8
    planes_p = np.zeros((w8, npad), np.uint32)
    planes_p[:w] = planes
    qwords = np.zeros((Q, w8), np.uint32)
    qwords[:, :w] = t_bq.rows_to_planes(t_bq.pack_rows(
        rng.standard_normal((Q, dim)).astype(np.float32), row_bytes)).T
    sel = _selection(rng, npad // tile_n, 3)
    ws, wi = j_bq_kernel.bq_search_indexed(
        jnp.asarray(qwords), jnp.asarray(planes_p), jnp.asarray(sel),
        distance_type=j_types.DistanceType.DOT, invert=False, dim=dim, k=k, tile_n=tile_n,
        interpret=True)
    tw, tp = t_bq.words_to_tensor(qwords, "cpu"), t_bq.words_to_tensor(planes_p, "cpu")
    gs, gi = bq_kernel.bq_search_indexed(tw, tp, torch.from_numpy(sel),
                                         distance_type=DistanceType.DOT, invert=False,
                                         dim=dim, k=k, tile_n=tile_n)
    gs, gi = gs.numpy(), gi.numpy()
    np.testing.assert_array_equal(gs, np.asarray(ws))
    # BQ scores tie in droves: each id is a distinct selected row scoring its
    # slot's value.
    scores = t_bq.score_batch(tw, tp, distance_type=DistanceType.DOT, invert=False,
                              dim=dim).numpy()
    for r in range(Q):
        assert np.isin(gi[r], _rows(sel, tile_n)).all() and len(set(gi[r].tolist())) == k
        np.testing.assert_array_equal(scores[r, gi[r]], gs[r])


def test_indexed_tile_n_matches_jax():
    for dp in (64, 768, 1536, 4096):
        for s in (256, 512, 1024, 2048, 3072):
            assert bq_kernel.indexed_tile_n(dp, s) == j_bq_kernel.indexed_tile_n(dp, s)


# ----------------------------------------------------------- PQ: K11, K7


def _pq_setup(rng, kc, m, npad):
    lut = (rng.standard_normal((Q, m, kc)) * 2.0 + rng.standard_normal((Q, m, 1))).astype(
        np.float32)
    mpad = m + (-m) % pq_kernel.M_BLK
    codes_t = np.zeros((mpad, npad), np.uint8)
    codes_t[:m] = rng.integers(0, kc, (m, npad))
    return lut, codes_t


def _pq_residual(rng, npad, corr_shape):
    rowadd = (rng.standard_normal(npad) * 5).astype(np.float32)
    rowadd[::97] = np.float32(-3.0e38)  # the pad mask rides rowadd
    corr = (rng.standard_normal(corr_shape) * 3).astype(np.float32)
    return rowadd, corr


def _pq_tol(ws, lut, precision, rowadd, corr):
    extra = 0.0
    if rowadd is not None:
        extra = np.abs(rowadd[rowadd > -1e38]).max() + np.abs(corr).max()
    mag = np.abs(ws) + extra
    if precision == "int8":
        bias = pq_kernel.quantize_lut(torch.from_numpy(lut))[2].numpy()
        return 2 * np.spacing(mag + np.abs(bias)[:, None])
    if lut.shape[2] == pq_kernel.K4 or rowadd is not None:
        return np.spacing(mag)
    return 0.0


PQ_CASES = [(256, 16), (16, 32)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("precision", ["int8", "bf16", "bf16x2"])
@pytest.mark.parametrize("kc,m", PQ_CASES, ids=["8bit", "4bit"])
def test_k11_pq_indexed_plain_matches_pallas(rng, kc, m, precision, residual):
    _pq_indexed_case(rng, kc, m, precision, residual, tile_n=1024, t=3)


@pytest.mark.parametrize("tile_n,residual,precision", [
    (512, True, "int8"), (512, True, "bf16x2"), (256, False, "int8"), (256, False, "bf16")])
def test_k11_pq_indexed_derated_tiles(rng, tile_n, residual, precision):
    """Tiles narrower than the full 1024 (bucket sizes of 512 and 256; five
    256-row tiles are not whole 512-row kernel tiles)."""
    _pq_indexed_case(rng, 256, 16, precision, residual, tile_n=tile_n, t=5)


def _pq_indexed_case(rng, kc, m, precision, residual, tile_n, t):
    npad, k = 4096, 10
    lut, codes_t = _pq_setup(rng, kc, m, npad)
    sel = _selection(rng, npad // tile_n, t)
    rowadd, corr = _pq_residual(rng, npad, (t * tile_n // 512, Q)) if residual \
        else (None, None)
    ws, wi = j_pq_kernel.pq_search_indexed(
        jnp.asarray(lut), jnp.asarray(codes_t), jnp.asarray(sel),
        None if rowadd is None else jnp.asarray(rowadd),
        None if corr is None else jnp.asarray(corr),
        k=k, precision=precision, tile_n=tile_n, interpret=True)
    gs, gi = pq_kernel.pq_search_indexed(
        *_t(lut, codes_t, sel), *(_t(rowadd, corr) if residual else (None, None)),
        k=k, precision=precision, tile_n=tile_n)
    ws = np.asarray(ws)
    _assert_matches(gs.numpy(), gi.numpy(), ws, np.asarray(wi), _rows(sel, tile_n),
                    _pq_tol(ws, lut, precision, rowadd, corr))


@pytest.mark.parametrize("mode,precision", [
    ("exact", "bf16"), ("exact", "bf16x2"),
    ("approx", "int8"), ("approx", "bf16"), ("approx", "bf16x2")])
@pytest.mark.parametrize("kc,m", PQ_CASES, ids=["8bit", "4bit"])
def test_k7_pq_residual_plain_matches_pallas(rng, kc, m, mode, precision):
    """K7b / K7a with (rowadd, corr): the JAX exact kernel takes the
    additives only with an f32-keyed extraction (bf16 / bf16x2 LUT)."""
    n_valid, k = 2500, 10
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    lut, codes_t = _pq_setup(rng, kc, m, npad)
    codes_t[:, n_valid:] = 0
    rowadd, corr = _pq_residual(rng, npad, (Q, npad // 512))
    ws, wi = j_pq_kernel.pq_search_pallas(
        *(jnp.asarray(a) for a in (lut, codes_t, rowadd, corr)),
        n_valid=n_valid, k=k, mode=mode, precision=precision, interpret=True)
    gs, gi = pq_kernel.pq_search(*_t(lut, codes_t, rowadd, corr), n_valid=n_valid, k=k,
                                 mode=mode, precision=precision)
    ws = np.asarray(ws)
    _assert_matches(gs.numpy(), gi.numpy(), ws, np.asarray(wi), np.arange(n_valid),
                    _pq_tol(ws, lut, precision, rowadd, corr))


def test_residual_pair_is_required(rng):
    lut, codes_t = _pq_setup(rng, 256, 16, 1024)
    rowadd, _ = _pq_residual(rng, 1024, (Q, 2))
    with pytest.raises(Exception, match="pair"):
        pq_kernel.pq_search(*_t(lut, codes_t, rowadd), n_valid=1024, k=5)
    with pytest.raises(Exception, match="pair"):
        pq_kernel.pq_search_indexed(*_t(lut, codes_t, np.arange(1, dtype=np.int32), rowadd),
                                    k=5)
