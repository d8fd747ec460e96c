"""The int8 approx body's candidate layout (csrc/dot_scan.cuh
approx_ws_kernel, and approx_parts_kernel where its query tile does not
fit; ops/kernels/ktile.py approx_geometry and approx_buffers): a block
takes a work item of ``part`` compact rows and
keeps, per query and stride class l (compact rows item_start + m*128 + l),
the first maximum with a strict ">" in segment order, rows past n_valid
scoring NEG; where an item is a whole span block its maxima are the
candidates, else approx_combine_kernel max-merges the items of each span
block in row order. Here on the CPU: a plain torch model of that walk (K2 /
K9a, the value-query K5a / K10 with corr and rowadd, the 4-bit int8 K7a /
K11 with rowadd and corr), merged, against the
port's plain approx search and the JAX package's (Pallas in interpret
mode); the shared memory each body claims, parsed from csrc/; the geometry
the wrappers pass. The
kernels themselves run only on the card (tests/test_torch_cuda.py -k
approx_body, chip_smoke.py).

Tolerances: the model against the port's plain search: none (the same f32
scores, selected). Against the JAX package: SQ within its scores' rtol 1e-6
/ atol 1e-4 (tests/test_torch_sq_kernels.py: XLA may fuse the epilogue's
multiply-add), residual BQ to the bit (tests/test_torch_rbq_kernels.py),
ids where the value is untied."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.pallas.bq_kernel as j_bq_kernel
from quantization_tpu.ops.pallas.sq_kernel import sq_search_indexed as j_sq_indexed
from quantization_tpu.ops.pallas.sq_kernel import sq_search_pallas
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel, ktile, pq_kernel, sq_kernel
from test_torch_rbq_kernels import _setup as _rbq_setup
from test_torch_rbq_kernels import _torch_aff, _jax_aff, _untied_ids_equal
from test_torch_sq_kernels import _setup, assert_topk_matches

torch.set_num_threads(1)

CSRC = pathlib.Path(sq_kernel.__file__).resolve().parent.parent.parent / "csrc"
SLOT = ktile.SLOT


def body_output(scores, n_valid, part):
    """The body's pass 1 as a plain loop: item p covers compact rows
    [p*part, (p+1)*part); per query and class, the running maximum from
    -inf with a strict ">" over the item's 128-row segments in order, NEG
    past n_valid, and its row (-1 where none). (vals, ids) [Q, items*128]."""
    q, ncomp = scores.shape
    lane = torch.arange(SLOT)
    vals, ids = [], []
    for p0 in range(0, ncomp, part):
        best = torch.full((q, SLOT), float("-inf"))
        seg = torch.full((q, SLOT), -1, dtype=torch.int64)
        for m, c0 in enumerate(range(p0, min(p0 + part, ncomp), SLOT)):
            sc = scores[:, c0:c0 + SLOT].clone()
            sc[:, c0 + lane >= n_valid] = ktile.NEG
            up = sc > best
            best = torch.where(up, sc, best)
            seg = torch.where(up, torch.full_like(seg, m), seg)
        vals.append(best)
        ids.append(torch.where(seg < 0, -1, p0 + seg * SLOT + lane))
    return torch.cat(vals, 1), torch.cat(ids, 1).to(torch.int32)


def combine(vals, ids, ppb):
    """approx_combine_kernel: slot (b, l) = the first maximum over items b*ppb
    .. b*ppb + ppb - 1, in order."""
    q, w = vals.shape
    nparts = w // SLOT
    pv, pi = vals.reshape(q, nparts, SLOT), ids.reshape(q, nparts, SLOT)
    out_v, out_i = [], []
    for b0 in range(0, nparts, ppb):
        best, arg = pv[:, b0].clone(), pi[:, b0].clone()
        for p in range(b0 + 1, min(b0 + ppb, nparts)):
            up = pv[:, p] > best
            best = torch.where(up, pv[:, p], best)
            arg = torch.where(up, pi[:, p], arg)
        out_v.append(best)
        out_i.append(arg)
    return torch.cat(out_v, 1), torch.cat(out_i, 1)


def candidates(scores, n_valid, part, span):
    """The body's candidates [Q, ceil(ncomp / span)*128]: in place where part
    is the span block, else combined."""
    vals, ids = body_output(scores, n_valid, part)
    return (vals, ids) if part == span else combine(vals, ids, span // part)


def model_search(scores, n_valid, part, span, k, rows=None):
    """The wrappers' result from the model: candidates merged exactly, ids
    compact rows, or corpus rows through ``rows``."""
    vals, ids = candidates(scores, n_valid, part, span)
    if rows is not None:
        ids = torch.where(ids >= 0, rows[ids.clamp(min=0).long()].to(torch.int32), ids)
    return ktile.merge_candidates(vals, ids, k)


def _sq(rng, n_valid, d, q, equal=False):
    arrs = _setup(rng, n_valid, d, q)
    if equal:
        arrs[2][:n_valid] = arrs[2][0]
        arrs[3][:n_valid] = 0.5
    mult = rng.random(q, dtype=np.float32) * 1e-3 + 1e-4
    return arrs, mult


def _sq_scores(arrs, mult, rows=None):
    t = tuple(torch.from_numpy(a) for a in arrs)
    codes, voff = (t[2], t[3]) if rows is None else (t[2][rows], t[3][rows])
    return sq_kernel.sq_scores_plain(t[0], t[1], codes, voff, torch.from_numpy(mult),
                                     distance_type=DistanceType.DOT, n_valid=codes.shape[0])


def _parts(span):
    return sorted({span} | {p for p in (512, 1024, 2048, 4096) if p < span and span % p == 0})


# ------------------------------------------------------- K2 and K9a (SQ)


@pytest.mark.parametrize("k", [10, 1280])
@pytest.mark.parametrize("q", [1, 63, 65, 257])
def test_k2_model_merged_equals_plain(q, k):
    """Dense K2 over 5,001 valid rows of 5,120 (n_valid not a multiple of
    128 or of an item), every part that divides the span and the one the
    geometry picks for a small and a full card: values and ids equal the
    port's plain approx to the bit."""
    rng = np.random.default_rng([q, k])
    n_valid = 5001
    arrs, mult = _sq(rng, n_valid, 128, q)
    npad = arrs[2].shape[0]
    span = ktile.SPAN * sq_kernel.approx_tile_n(npad)
    scores = _sq_scores(arrs, mult)
    t = tuple(torch.from_numpy(a) for a in arrs) + (torch.from_numpy(mult),)
    pv, pi = sq_kernel.sq_search_plain(*t, distance_type=DistanceType.DOT, n_valid=n_valid,
                                       k=k, mode="approx")
    parts = set(_parts(span)) | {ktile.approx_geometry(npad, q, span, s) for s in (4, 132)}
    for part in sorted(parts):
        v, i = model_search(scores, n_valid, part, span, k)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part


_JAX = {}


def test_k2_model_equals_jax():
    """The model's K2 search against the JAX package's approx search (values
    within its tolerance, ids where untied)."""
    rng = np.random.default_rng(2)
    n_valid, q, k = 3001, 65, 10
    arrs, mult = _sq(rng, n_valid, 128, q)
    ws, wi = sq_search_pallas(*(jnp.asarray(a) for a in arrs), jnp.asarray(mult),
                              distance_type=j_types.DistanceType.DOT, n_valid=n_valid, k=k,
                              mode="approx", interpret=True)
    npad = arrs[2].shape[0]
    span = ktile.SPAN * sq_kernel.approx_tile_n(npad)
    scores = _sq_scores(arrs, mult)
    for part in _parts(span):
        v, i = model_search(scores, n_valid, part, span, k)
        assert_topk_matches(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi),
                            scores[:, :n_valid].numpy(), n_valid)


@pytest.mark.parametrize("q", [1, 63, 65, 257])
def test_k9a_model_merged_equals_plain_and_jax(q):
    """K9a over 3 selected tiles of 1024 rows (fewer items than SMs; the
    last span block partial): the model at every part equals the port's
    plain indexed approx, and, at Q = 63, the JAX package's."""
    rng = np.random.default_rng(q)
    tile_n, k = 1024, 20
    arrs, mult = _sq(rng, 8192, 128, q)
    sel = np.array([5, 2, 6], np.int32)
    rows = ktile.tile_rows(torch.from_numpy(sel), tile_n)
    scores = _sq_scores(arrs, mult, rows)
    t = tuple(torch.from_numpy(a) for a in arrs) + (torch.from_numpy(mult),)
    pv, pi = sq_kernel.sq_search_indexed_plain(*t, torch.from_numpy(sel),
                                               distance_type=DistanceType.DOT, k=k,
                                               tile_n=tile_n)
    span = ktile.SPAN * tile_n
    ncomp = rows.shape[0]
    for part in _parts(span):
        v, i = model_search(scores, ncomp, part, span, k, rows)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part
    if q == 63:
        ws, wi = j_sq_indexed(*(jnp.asarray(a) for a in arrs), jnp.asarray(mult),
                              jnp.asarray(sel), distance_type=j_types.DistanceType.DOT, k=k,
                              tile_n=tile_n, interpret=True)
        v, i = model_search(scores, ncomp, ktile.approx_geometry(ncomp, q, span, 132), span,
                            k, rows)
        np.testing.assert_allclose(v.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-4)
        _untied_ids_equal(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))


@pytest.mark.parametrize("part", [512, 1024, 4096])
def test_equal_scores_keep_the_first_row_of_each_class(part):
    """Every score equal: each span block's slot l holds its first row of
    class l, whatever the items (strict ">" within an item and across the
    combine), as the plain approx keeps it."""
    rng = np.random.default_rng(part)
    n_valid, q = 9000, 3
    arrs, mult = _sq(rng, n_valid, 128, q, equal=True)
    npad = arrs[2].shape[0]
    span = 4096
    scores = _sq_scores(arrs, mult)
    assert bool((scores[:, :n_valid] == scores[:, :1]).all())
    vals, ids = candidates(scores, n_valid, part, span)
    nb = -(-npad // span)
    want = (torch.arange(nb)[:, None] * span + torch.arange(SLOT)[None, :]).reshape(-1)
    assert torch.equal(ids, want.to(torch.int32).expand(q, -1))
    pv, pi = ktile.approx_candidates(scores.clone().index_fill_(
        1, torch.arange(n_valid, npad), ktile.NEG), span // ktile.SPAN)
    assert torch.equal(vals, pv) and torch.equal(ids, pi)


# --------------------------------------- the value-query K5a / K10 (BQ)


def _res_scores(planes, aff, corr, rowadd, rows=None, selection=False):
    """Plain residual-BQ scores in compact order, rowadd and corr added."""
    w8 = planes.shape[0]
    pl = t_bq.words_to_tensor(planes, "cpu")
    if rows is not None:
        pl = pl[:, rows]
    bits = ((pl[:, None, :] >> torch.arange(32, dtype=torch.int32)[None, :, None]) & 1)
    bits = bits.reshape(w8 * 32, -1).T.to(torch.int8)
    qs, mult, qb = _torch_aff(aff)
    acc = (qs.to(torch.int64) @ bits.to(torch.int64).T).to(torch.int32)
    m = mult.reshape(-1, 1).to(torch.float64)
    s = (m * acc.to(torch.float64) + qb.reshape(-1, 1).to(torch.float64)).to(torch.float32)
    ra = torch.from_numpy(rowadd)
    s = s + (ra if rows is None else ra[rows])[None, :]
    if corr is not None:
        s = s + ktile.expand_corr(torch.from_numpy(corr), selection)
    return s


@pytest.mark.parametrize("q", [1, 63, 65])
def test_k5a_value_model_equals_plain_and_jax(q):
    """Dense value-query K5a over 3,900 valid rows of 4,096 with corr and a
    rowadd that poisons some rows: the model at every part equals the port's
    plain approx to the bit (values and ids), and, without rowadd, the JAX
    package's (which takes none)."""
    rng = np.random.default_rng(q + 100)
    npad, n_valid, dim, k = 4096, 3900, 200, 20
    planes, aff = _rbq_setup(rng, npad, dim, True)
    aff = (np.resize(aff[0], (q,) + aff[0].shape[1:]), np.resize(aff[1], (q, 1)),
           np.resize(aff[2], (q, 1)))
    corr = (rng.standard_normal((q, npad // 512)) * 3).astype(np.float32)
    rowadd = np.zeros(npad, np.float32)
    rowadd[rng.choice(n_valid, 40, replace=False)] = ktile.NEG
    span = ktile.SPAN * bq_kernel.mxu_tile_n(planes.shape[0] * 32, npad)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=k,
              mode="approx", query_affine=_torch_aff(aff))
    for ra in (rowadd, np.zeros_like(rowadd)):
        scores = _res_scores(planes, aff, corr, ra)
        pv, pi = bq_kernel.bq_search(None, t_bq.words_to_tensor(planes, "cpu"),
                                     torch.from_numpy(corr), rowadd=torch.from_numpy(ra), **kw)
        for part in _parts(span):
            v, i = model_search(scores, n_valid, part, span, k)
            assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
            assert torch.equal(i, pi), part
    if q == 65:
        ws, wi = j_bq_kernel.bq_search_mxu(
            None, jnp.asarray(planes), jnp.asarray(corr),
            distance_type=j_types.DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid,
            k=k, mode="approx", interpret=True, query_affine=_jax_aff(aff))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ws))
        _untied_ids_equal(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))


@pytest.mark.parametrize("k", [10, 1280])
def test_k10_value_model_equals_plain_and_jax(k):
    """Indexed value-query K10 over 5 of 16 tiles of 1024 rows with corr in
    selection order (fewer items than SMs; one partial span block): the
    model at every part equals the port's plain search, and at k = 10 the
    JAX package's."""
    rng = np.random.default_rng(k)
    npad, dim, tile_n, q = 16 * 1024, 128, 1024, 5
    planes, aff = _rbq_setup(rng, npad, dim, False)
    sel = np.array([9, 3, 14, 0, 7], np.int32)
    ncomp = sel.shape[0] * tile_n
    corr = (rng.standard_normal((ncomp // 512, q)) * 3).astype(np.float32)
    rowadd = np.zeros(npad, np.float32)
    rows = ktile.tile_rows(torch.from_numpy(sel), tile_n)
    scores = _res_scores(planes, aff, corr, rowadd, rows, selection=True)
    pv, pi = bq_kernel.bq_search_indexed(
        None, t_bq.words_to_tensor(planes, "cpu"), torch.from_numpy(sel),
        torch.from_numpy(corr), distance_type=DistanceType.DOT, invert=False, dim=dim, k=k,
        tile_n=tile_n, query_affine=_torch_aff(aff))
    span = ktile.SPAN * tile_n
    for part in _parts(span):
        v, i = model_search(scores, ncomp, part, span, k, rows)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part
    if k == 10:
        ws, wi = j_bq_kernel.bq_search_indexed(
            None, jnp.asarray(planes), jnp.asarray(sel), jnp.asarray(corr),
            distance_type=j_types.DistanceType.DOT, invert=False, dim=dim, k=k, tile_n=tile_n,
            interpret=True, query_affine=_jax_aff(aff))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ws))
        _untied_ids_equal(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))


# ---------------------------------------------- 4-bit int8 K7a / K11 (PQ)


def _pq4(rng, q, npad, m=24):
    lut = torch.from_numpy((rng.standard_normal((q, m, pq_kernel.K4)) * 2).astype(np.float32))
    codes_t = torch.from_numpy(rng.integers(0, 16, (m, npad), dtype=np.uint8))
    return lut, codes_t


def _pq_scores(lut, codes_t, rowadd, corr, selection=False):
    """The plain int8-LUT scores of every column of codes_t, the residual
    additives added as pq_kernel's plain versions add them."""
    words, scale, bias = pq_kernel._operands(lut, "int8")
    scores = pq_kernel._plain_scores(words, scale, bias, codes_t, codes_t.shape[1])
    return pq_kernel._add_residual(scores, rowadd, corr, selection=selection)


@pytest.mark.parametrize("q", [1, 65])
def test_k7a_4bit_model_equals_plain(q):
    """4-bit int8 K7a (the one-hot route, its span blocks in place, every
    part): with rowadd and corr, n_valid ragged, the model equals the
    port's plain approx (values and ids)."""
    rng = np.random.default_rng(q + 7)
    npad, n_valid, k = 6144, 6001, 30
    lut, codes_t = _pq4(rng, q, npad)
    rowadd = torch.from_numpy(rng.standard_normal(npad).astype(np.float32))
    corr = torch.from_numpy(rng.standard_normal((q, npad // 512)).astype(np.float32))
    scores = _pq_scores(lut, codes_t, rowadd, corr)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, n_valid=n_valid, k=k,
                                       mode="approx", precision="int8")
    span = ktile.SPAN * pq_kernel.TILE_N
    for part in _parts(span):
        v, i = model_search(scores, n_valid, part, span, k)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part


def test_k11_4bit_model_equals_plain():
    """4-bit int8 K11 over 5 of 12 tiles of 1024 rows with rowadd and corr in
    selection order: the model equals the port's plain indexed search."""
    rng = np.random.default_rng(11)
    q, tile_n, k = 19, 1024, 20
    lut, codes_t = _pq4(rng, q, 12 * tile_n)
    sel = torch.tensor([7, 1, 10, 4, 0], dtype=torch.int32)
    rows = ktile.tile_rows(sel, tile_n)
    rowadd = torch.from_numpy(rng.standard_normal(12 * tile_n).astype(np.float32))
    corr = torch.from_numpy(rng.standard_normal((rows.shape[0] // 512, q)).astype(np.float32))
    scores = _pq_scores(lut, codes_t[:, rows], rowadd[rows], corr, selection=True)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, k=k,
                                               precision="int8", tile_n=tile_n)
    span = ktile.SPAN * tile_n
    for part in _parts(span):
        v, i = model_search(scores, rows.shape[0], part, span, k, rows)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part


# -------------------------------------------------------------- geometry


@pytest.mark.parametrize("ncomp,q,span,nsm,want", [
    (262_144, 256, 4096, 132, 4096),     # K9a, scan_ab's shape: span blocks in place
    (1_255_424, 256, 4096, 132, 4096),   # K10-value at the serving width
    (100_352, 256, 8192, 132, 2048),     # K2 at 100k: 52 span blocks would idle 212 slots
    (100_352, 32, 8192, 132, 2048),
    (3072, 63, 4096, 132, 2048),         # a few tiles: the smallest items
    (2_883_584, 256, 4096, 132, 4096),   # K9a at the 10M anchor's nscan 2,816
    (1000 * 8192, 256, 32768, 132, 2048),  # tile_n 8192: 256 segments is past a byte
    (40 * 8192, 32, 32768, 132, 4096),
])
def test_geometry(ncomp, q, span, nsm, want):
    part = ktile.approx_geometry(ncomp, q, span, nsm)
    assert part == want
    assert span % part == 0 and part % SLOT == 0 and part // SLOT <= 255
    assert part == span or part >= ktile.APPROX_MIN_PART


@pytest.mark.parametrize("ncomp", [512, 5_120, 262_144, 1_255_424, 10_000_384])
@pytest.mark.parametrize("q", [1, 64, 65, 256, 9_000])
@pytest.mark.parametrize("span", [2048, 4096, 8192])
def test_geometry_never_slower_than_in_place(ncomp, q, span):
    """The picked part's walk ends no later than the span block's would, one
    block a SM and the grid a multiple of the query tiles, and a smaller
    part only where it saves more than the margin."""
    nqt = -(-q // (ktile.APPROX_TQ if q > 64 else 64))
    grid = max(1, 132 // nqt) * nqt

    def cost(p):
        items = -(-ncomp // p) * nqt
        return -(-items // min(grid, items)) * p

    part = ktile.approx_geometry(ncomp, q, span, 132)
    assert cost(part) <= cost(span)
    assert part == span or cost(part) < ktile.APPROX_INPLACE_MARGIN * cost(span)


def _define(src, name):
    """A constexpr int of csrc/, its expression evaluated (kSeg, kDK,
    ApproxTile::TQ as the header sets them)."""
    expr = re.search(rf"constexpr int (?:\w+ = [^,;]+, )*{name} = ([^;,]+)[;,]",
                     src).group(1).split("//")[0]
    expr = expr.replace("ApproxTile::TQ", "64").replace("kSeg", "128").replace("kDK", "128")
    return eval(expr, {}, {})


def approx_bytes(psize):
    """approx_parts_kernel's shared memory plus the 1,024-byte alignment pad:
    a 3-stage ring of 128 rows and 64 query rows of 128 bytes, voff / corr
    of a segment, mult and qoff; the same at every depth."""
    return 1024 + 3 * (128 + 64) * 128 + (128 + 64) * 4 + 2 * 64 * psize


@pytest.mark.parametrize("psize", [4, 8])
def test_shared_memory_fits_two_blocks_a_sm(psize):
    """approx_parts_kernel's claim (the body of the 4-bit int8 K7a / K11 and
    of depths where the warp-specialized body's query tile does not fit),
    from csrc/: two blocks a SM (233,472 bytes less 1,024 reserved a block),
    the queries in the ring at any depth."""
    src = (CSRC / "dot_scan.cuh").read_text()
    assert _define(src, "kApproxSide") == (128 + 64) * 4
    assert "ApproxTile = Tile<64, 3, 2>" in src
    assert approx_bytes(psize) <= 233472 // 2 - 1024


def ws_layout(src, tq, d, planes, psize):
    """dot_scan.cuh WsLayout(tq, d, planes, psize): (stages a warpgroup's
    ring, bytes past the 1,024-byte alignment pad), the constants parsed
    from csrc/: two rings of S stages of 64 rows x 128 bytes, the resident
    queries, PlaneRows' raw words (two segments a warpgroup), the side slots
    (voff of 64 rows and corr of the queries), mult and qoff, the segment
    bytes, the barriers."""
    smem, lo, hi = (_define(src, n) for n in ("kWsSmem", "kWsMinStages", "kWsMaxStages"))
    side, bars = _define(src, "kWsSide"), _define(src, "kWsBarBytes")
    nk = d // 128
    qbytes, raw_seg = nk * tq * 128, (nk * 4 * 64 * 4 if planes else 0)
    fixed = qbytes + 4 * raw_seg + 2 * side * (64 + tq) * 4 + 2 * tq * psize + 256 * tq // 2 + bars
    room = (smem - 1024 - fixed) // (2 * 64 * 128)
    s = 0 if room < lo else min(room, hi)
    return s, 2 * s * 64 * 128 + fixed


@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("planes,psize", [(False, 4), (True, 8)])
def test_ws_shared_memory_fits_one_block_a_sm(tq, planes, psize):
    """approx_ws_kernel's claim, from csrc/: one block a SM within the
    227 KB a block may take, at least kWsMinStages stages a warpgroup
    wherever it runs, and it runs at the depths the searches use: K9a's and
    K10's 768, K2's 1,024 (CodeRows); not PlaneRows at 2,048 bits or the
    4-bit LUT's 3,072 bytes (approx_parts_kernel keeps those)."""
    src = (CSRC / "dot_scan.cuh").read_text()
    assert _define(src, "kWsSmem") == 232448 and _define(src, "kWsThreads") == 384
    assert _define(src, "kWsTQ") == ktile.APPROX_TQ == 128
    for d in range(128, 4097, 128):
        s, nbytes = ws_layout(src, tq, d, planes, psize)
        if s:
            assert s >= _define(src, "kWsMinStages") and 1024 + nbytes <= 232448, d
    assert ws_layout(src, tq, 768, planes, psize)[0] > 0
    if not planes:
        assert ws_layout(src, tq, 1024, planes, psize)[0] > 0
        assert ws_layout(src, tq, 3072, planes, psize)[0] == 0
    else:
        assert ws_layout(src, tq, 2048, planes, psize)[0] == 0


def test_ws_registers_fit_the_sm():
    """approx_ws_kernel's register claim, from csrc/: one block of
    kWsThreads a SM on the launch's 168 registers a thread (65,536 / 384,
    rounded down to 8), and at 128 queries setmaxnreg moving the producer
    warpgroup's to the two consumer warpgroups within that file."""
    src = (CSRC / "dot_scan.cuh").read_text()
    threads = _define(src, "kWsThreads")
    assert "__launch_bounds__(kWsThreads, 1) approx_ws_kernel" in src
    launch = 65536 // threads // 8 * 8
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+)", src).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+)", src).group(1))
    assert dec % 8 == 0 and inc % 8 == 0 and 24 <= dec < launch < inc <= 256
    assert 128 * dec + (threads - 128) * inc <= threads * launch


def _wrapper_lib(captured):
    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                captured.append((name, args))
                return 0
            return launch
    return Lib()


@pytest.mark.parametrize("nsm", [4, 132])
@pytest.mark.parametrize("q", [1, 256])
def test_wrappers_pass_the_geometry(monkeypatch, nsm, q):
    """sq_search / sq_search_indexed (K2 / K9a) and bq_search /
    bq_search_indexed with a value query (K5a / K10) hand their kernel the
    geometry's part, the span block, and, where the part is the span block,
    the candidates' buffers as the parts' (in place); the merge sees
    [Q, blocks * 128]."""
    captured, widths = [], []
    for mod in (sq_kernel, bq_kernel):
        monkeypatch.setattr(mod, "use_kernels", lambda t: True)
        monkeypatch.setattr(mod, "load_library", lambda: _wrapper_lib(captured))
        monkeypatch.setattr(mod, "sm_count", lambda dev: nsm)
        monkeypatch.setattr(mod, "merge_candidates",
                            lambda v, i, kk: widths.append(tuple(v.shape)))
    monkeypatch.setattr(bq_kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    n, tile_n, k = 300_032, 1024, 20
    dot = DistanceType.DOT
    qcodes = torch.zeros((q, 128), dtype=torch.int8)
    codes = torch.zeros((n, 128), dtype=torch.int8)
    sq_kernel.sq_search(qcodes, torch.zeros(q), codes, torch.zeros(n), torch.ones(1),
                        distance_type=dot, n_valid=n - 5, k=k, mode="approx")
    npad = 293 * tile_n  # = n
    sel = torch.arange(0, 60, 2, dtype=torch.int32)
    sq_kernel.sq_search_indexed(qcodes, torch.zeros(q), codes[:npad], torch.zeros(npad),
                                torch.ones(1), sel, distance_type=dot, k=k, tile_n=tile_n)
    bq_npad = 147 * 2048  # the BQ planes' padding
    planes = torch.zeros((8, bq_npad), dtype=torch.int32)
    aff = (torch.zeros((q, 256), dtype=torch.int8), torch.ones(q), torch.zeros(q))
    kw = dict(distance_type=dot, invert=False, dim=256, k=k, query_affine=aff)
    bq_kernel.bq_search(None, planes, torch.zeros((q, bq_npad // 512)), n_valid=bq_npad - 9,
                        mode="approx", rowadd=torch.zeros(bq_npad), **kw)
    bq_kernel.bq_search_indexed(None, planes, sel, torch.zeros((30 * tile_n // 512, q)),
                                tile_n=tile_n, **kw)
    spans = [ktile.SPAN * sq_kernel.approx_tile_n(n), ktile.SPAN * tile_n,
             ktile.SPAN * bq_kernel.mxu_tile_n(256, bq_npad), ktile.SPAN * tile_n]
    ncomps = [n, 30 * tile_n, bq_npad, 30 * tile_n]
    names = ["qtt_sq_search_approx", "qtt_sq_search_approx", "qtt_bq_search_approx_res",
             "qtt_bq_search_approx_res"]
    assert [c[0] for c in captured] == names
    for (name, args), span, ncomp, shape in zip(captured, spans, ncomps, widths):
        if name == "qtt_sq_search_approx":
            bufs, (part, span_rows) = args[5:9], args[13:15]
        else:
            bufs, (part, span_rows) = args[5:9], args[14:16]
        assert span_rows == span
        assert part == ktile.approx_geometry(ncomp, q, span, nsm)
        assert (bufs[0] == bufs[2] and bufs[1] == bufs[3]) == (part == span)
        assert shape == (q, -(-ncomp // span) * SLOT)
