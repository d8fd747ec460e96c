"""The one-hot route of the port's exact and indexed PQ searches with 4-bit
codes and the int8 LUT (K7b and K11 on the tensor-core scan body,
csrc/pq4_mma_kernels.cu), emulated in torch on the CPU, with what the
wrappers hand the kernels; and the plain K7b / K11 at that width against
the JAX package's Pallas kernels in interpret mode. The kernels run only on
the card (tests/test_torch_cuda.py and chip_smoke.py hold them to the plain
versions there).

Tolerances, with their causes:
  * emulation vs the port's plain version: none. The product is the plain
    version's integer sum, the f64 epilogue rounds once on both sides, and
    the row of -0.0 the route adds without a rowadd is an exact identity.
    Exact top-k: values equal, ids up to ties; indexed: values and ids.
  * plain vs the JAX package: 2 ulp of |score| + |bias| (+ the additives'
    magnitudes with them), the int8 tolerance of
    tests/test_torch_pq_kernels.py and tests/test_torch_ivf_kernels.py
    (ROADMAP Queue 3, F14); ids up to ties."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.pq_kernel as j_kernel
from quantization_tpu_torch.ops.kernels import ktile, pq_kernel
from test_torch_pq_onehot import _setup, onehot_scores

torch.set_num_threads(1)

CPU = torch.device("cpu")


def keys(x):
    """ktile.cuh float_to_key: an order-preserving map f32 -> u32, as int64;
    -0.0 sorts below +0.0."""
    u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def split_select(scores, n_valid, kk, split=pq_kernel.EXACT_SPLIT):
    """The exact body's per-split selection: each split's top-min(kk, valid
    rows) by key, equal keys in row order, NEG / -1 in the slots after
    them. Returns (vals, ids) [Q, nsplit * kk]."""
    q, npad = scores.shape
    vals, ids = [], []
    for s0 in range(0, npad, split):
        cnt = max(0, min(split, n_valid - s0))
        v = torch.full((q, kk), ktile.NEG)
        i = torch.full((q, kk), -1, dtype=torch.int32)
        if cnt:
            order = torch.sort(keys(scores[:, s0:s0 + cnt]), dim=1, descending=True,
                               stable=True).indices[:, :min(kk, cnt)]
            take = order.shape[1]
            v[:, :take] = torch.gather(scores[:, s0:s0 + cnt], 1, order)
            i[:, :take] = (order + s0).to(torch.int32)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


def residual_pair(rng, q, npad, blocks, selection=False):
    rowadd = torch.from_numpy(rng.standard_normal(npad).astype(np.float32) * 5)
    rowadd[::97] = -3.0e38  # the pad mask rides rowadd
    shape = (blocks, q) if selection else (q, blocks)
    return rowadd, torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def emulate_exact(lut, codes_t, n_valid, k, rowadd=None, corr=None, scores=None):
    """The K7b route: the product's scores (or ``scores``), + voff, + corr,
    the per-split selection, the exact merge."""
    npad = codes_t.shape[1]
    if scores is None:
        scores = onehot_scores(lut, codes_t, npad)
    scores = scores + pq_kernel.onehot_voff(rowadd, npad, CPU)[None, :]
    if corr is not None:
        scores = scores + ktile.expand_corr(corr)[:, :npad]
    vals, ids = split_select(scores, n_valid, min(k, pq_kernel.EXACT_SPLIT))
    return ktile.merge_exact(vals, ids, k)


def check_exact(v, i, pv, scores, n_valid):
    """Values equal the plain top-k's to the bit; every live id is a
    distinct valid row whose score is its value."""
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    live = i >= 0
    assert bool((i[live] < n_valid).all())
    assert torch.equal(torch.gather(scores, 1, i.clamp(min=0).long())[live], v[live])
    for r in range(i.shape[0]):
        assert len(set(i[r][live[r]].tolist())) == int(live[r].sum())


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [1, 10, 512, 1024])
@pytest.mark.parametrize("m,n_valid,q", [(8, 1, 1), (24, 511, 37), (192, 513, 3),
                                         (24, 1153, 65)])
def test_onehot_exact_equals_plain(rng, m, n_valid, q, k, residual):
    """The K7b route's per-split selection and merge over the product's
    scores: n_valid on both sides of a 512-row split and a 128-row segment,
    k past the split and past n_valid, with and without the additives."""
    lut, codes_t = _setup(rng, m, n_valid, q)
    npad = codes_t.shape[1]
    rowadd, corr = residual_pair(rng, q, npad, npad // 512) if residual else (None, None)
    v, i = emulate_exact(lut, codes_t, n_valid, k, rowadd, corr)
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, n_valid=n_valid, k=k,
                                      precision="int8")
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision="int8")
    if residual:
        scores = (scores + rowadd[None, :]) + ktile.expand_corr(corr)[:, :npad]
    check_exact(v, i, pv, scores[:, :n_valid], n_valid)


def test_negative_zero_row_is_an_identity():
    """x + (-0.0) == x to the bit for every f32 x, -0.0 included; x + 0.0
    turns -0.0 into +0.0, a different key of the exact select. So the route
    adds a row of -0.0 where no rowadd is given."""
    x = torch.tensor([-0.0, 0.0, 1e-45, -1e-45, 1.5, -2.25, 3.4e38, -3.4e38,
                      float("inf"), float("-inf"), ktile.NEG])
    assert torch.equal((x + torch.tensor(-0.0)).view(torch.int32), x.view(torch.int32))
    assert not torch.equal((x + torch.tensor(0.0)).view(torch.int32), x.view(torch.int32))
    assert int(keys(torch.tensor([-0.0]))) < int(keys(torch.tensor([0.0])))
    voff = pq_kernel.onehot_voff(None, 2048, CPU)
    assert tuple(voff.shape) == (2048,) and bool(torch.signbit(voff).all())
    rowadd = torch.ones(2048)
    assert pq_kernel.onehot_voff(rowadd, 2048, CPU) is rowadd


@pytest.mark.parametrize("kk", [3, 512])
def test_onehot_exact_keeps_a_negative_zero_score(rng, kk):
    """Scores that are exactly -0.0 keep their bits and their places in each
    split's selection through the route's + voff: the selection equals the
    one over the scores themselves, to the bit; a +0.0 row would turn them
    into +0.0 and reorder them against the +0.0 scores. (The int8 epilogue
    itself gives +0.0 for a zero sum, so such scores are put in by hand.)"""
    lut, codes_t = _setup(rng, 8, 700, 3)
    npad = codes_t.shape[1]
    scores = onehot_scores(lut, codes_t, npad).clamp(max=-1.0)
    scores[:, 5] = -0.0
    scores[:, 6] = 0.0
    scores[:, 600:] = -0.0
    want = split_select(scores, 700, kk)
    got = split_select(scores + pq_kernel.onehot_voff(None, npad, CPU)[None, :], 700, kk)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool(torch.signbit(got[0][got[0] == 0]).any())
    plus = split_select(scores + 0.0, 700, kk)
    assert not torch.equal(plus[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("tile_n,t,residual", [(256, 5, False), (512, 3, False),
                                                (512, 3, True), (1024, 2, False),
                                                (1024, 2, True)])
def test_onehot_indexed_equals_plain(rng, tile_n, t, residual):
    """The K11 route: the product over the selected tiles' rows in selection
    order (a permuted list, padded to whole 512-row tiles where t * tile_n
    is not), + voff of each corpus row, + corr in selection order, the
    stride classes over spans of SPAN tiles: values and ids equal the plain
    K11. (The additives need tiles of whole 512-row corr blocks.)"""
    q, npad = 7, 4096
    lut, codes_t = _setup(rng, 24, npad, q)
    sel = torch.randperm(npad // tile_n, generator=torch.Generator().manual_seed(tile_n))[:t]
    sel = sel.to(torch.int32)
    rowadd, corr = (residual_pair(rng, q, npad, t * tile_n // 512, selection=True)
                    if residual else (None, None))
    rows = ktile.tile_rows(sel, tile_n)
    scores = onehot_scores(lut, codes_t[:, rows].contiguous(), rows.shape[0])
    scores = scores + pq_kernel.onehot_voff(rowadd, npad, CPU)[rows][None, :]
    if residual:
        scores = scores + ktile.expand_corr(corr, True)
    vals, loc = ktile.approx_candidates(scores, tile_n)
    v, i = ktile.merge_candidates(vals, rows.to(torch.int32)[loc.long()], 40)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, k=40,
                                               precision="int8", tile_n=tile_n)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def _recorder(monkeypatch):
    seen = []
    monkeypatch.setattr(pq_kernel, "use_kernels", lambda t: True)

    def onehot(name, lut, ct, n_valid, outs, voff, res, **kw):
        seen.append(dict(name=name, n_valid=n_valid, voff=voff, res=res, **kw))

    monkeypatch.setattr(pq_kernel, "_launch_onehot", onehot)
    return seen


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [5, 512, 1024])
def test_onehot_exact_passes_voff_kk_and_corr(rng, monkeypatch, k, residual):
    """The K7b route gets kk = min(k, 512); a row of -0.0 as voff and a null
    corr without the residual pair; with it rowadd itself and corr's pointer
    and its dense strides."""
    seen = _recorder(monkeypatch)
    q, n_valid = 2, 3000
    lut, codes_t = _setup(rng, 16, n_valid, q)
    npad = codes_t.shape[1]
    rowadd, corr = residual_pair(rng, q, npad, npad // 512) if residual else (None, None)
    pq_kernel.pq_search(lut, codes_t, rowadd, corr, n_valid=n_valid, k=k, precision="int8")
    (got,) = seen
    assert got["name"] == "pq_search_exact" and got["n_valid"] == n_valid
    assert got["kk"] == min(k, pq_kernel.EXACT_SPLIT)
    if residual:
        assert got["voff"] is rowadd
        assert list(got["res"]) == [corr.data_ptr(), *ktile.corr_strides(corr, q, False)]
    else:
        assert tuple(got["voff"].shape) == (npad,) and bool(torch.signbit(got["voff"]).all())
        assert list(got["res"]) == [0, 0, 0]


@pytest.mark.parametrize("tile_n,t,residual", [(256, 3, False), (512, 3, False),
                                                (512, 3, True), (1024, 2, False),
                                                (1024, 2, True)])
def test_onehot_indexed_passes_selection(rng, monkeypatch, tile_n, t, residual):
    """The K11 route gets the selection padded to whole 512-row tiles with
    its last entry, tile_n, ncomp, a part of SPAN * tile_n rows and n_valid
    = t * tile_n (the padded rows score NEG); voff and corr as K7b's, corr
    with its selection-order strides."""
    seen = _recorder(monkeypatch)
    q, npad = 3, 8192
    lut, codes_t = _setup(rng, 16, npad, q)
    sel = torch.tensor([5, 1, 3][:t], dtype=torch.int32)
    rowadd, corr = (residual_pair(rng, q, npad, t * tile_n // 512, selection=True)
                    if residual else (None, None))
    pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, k=5, precision="int8",
                                tile_n=tile_n)
    (got,) = seen
    per = max(1, pq_kernel.EXACT_SPLIT // tile_n)
    want_sel = sel.tolist() + [sel[-1].item()] * ((-t) % per)
    assert got["name"] == "pq_search_indexed" and got["n_valid"] == t * tile_n
    assert got["sel"].tolist() == want_sel and got["tile_n"] == tile_n
    assert got["ncomp"] == len(want_sel) * tile_n
    assert got["part"] == ktile.SPAN * tile_n
    if residual:
        assert got["voff"] is rowadd
        assert list(got["res"]) == [corr.data_ptr(), *ktile.corr_strides(corr, q, True)]
    else:
        assert bool(torch.signbit(got["voff"]).all()) and list(got["res"]) == [0, 0, 0]


def test_onehot_route_keeps_a_part_in_a_byte(rng, monkeypatch):
    """The one-hot approx body numbers a part's 128-row segments in a byte:
    K11 takes it while SPAN * tile_n <= ONEHOT_PART_MAX, else the gather
    body."""
    ok = pq_kernel.ONEHOT_PART_MAX // ktile.SPAN // 128 * 128
    assert pq_kernel.onehot_route(pq_kernel.K4, "int8", "indexed", ok)
    assert not pq_kernel.onehot_route(pq_kernel.K4, "int8", "indexed", ok + 128)
    assert pq_kernel.onehot_route(pq_kernel.K4, "int8", "approx", 1 << 20)
    calls = []
    monkeypatch.setattr(pq_kernel, "use_kernels", lambda t: True)
    monkeypatch.setattr(pq_kernel, "_launch",
                        lambda name, *a, **kw: calls.append(("gather", name)))
    monkeypatch.setattr(pq_kernel, "_launch_onehot",
                        lambda name, *a, **kw: calls.append(("onehot", name)))
    lut = torch.from_numpy(rng.standard_normal((2, 16, pq_kernel.K4)).astype(np.float32))
    sel = torch.tensor([0], dtype=torch.int32)
    for tile_n in (ok, ok + 128):
        npad = tile_n * pq_kernel.TILE_N // math.gcd(tile_n, pq_kernel.TILE_N)
        codes_t = torch.zeros((16, npad), dtype=torch.uint8)
        pq_kernel.pq_search_indexed(lut, codes_t, sel, k=5, precision="int8", tile_n=tile_n)
    assert calls == [("onehot", "pq_search_indexed"), ("gather", "pq_search_indexed")]


# ------------------------------------------- the plain versions vs the JAX package


def _extra(rowadd, corr):
    """The additives' largest magnitudes (the pad mask left out)."""
    r = rowadd.numpy()
    return float(np.abs(r[r > -1e38]).max() + np.abs(corr.numpy()).max())


def _int8_tol(want, lut, extra=0.0):
    _, _, bias = pq_kernel.quantize_lut(lut)
    return 2 * np.spacing(np.abs(want) + extra + np.abs(bias.numpy())[:, None])


def test_plain_k7b_4bit_int8_residual_equals_jax_scores(rng):
    """The plain K7b with 4-bit codes, the int8 LUT and (rowadd, corr). The
    JAX exact kernel refuses the additives with the int8 LUT
    (pq_kernel.py:728), so the reference is its int8 scores
    (pq_scores_pallas, interpret mode) plus the additives, then top-k; ids
    up to ties. Without the additives,
    tests/test_torch_pq_kernels.py::test_exact_search_plain_equal_pallas
    holds it to pq_search_pallas(mode="exact")."""
    q, m, n_valid, k = 5, 32, 2500, 10
    lut, codes_t = _setup(rng, m, n_valid, q)
    npad = codes_t.shape[1]
    rowadd, corr = residual_pair(rng, q, npad, npad // 512)
    js = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), n_valid=n_valid,
        interpret=True, precision="int8"))
    js = (js + rowadd.numpy()[None, :n_valid]) + ktile.expand_corr(corr).numpy()[:, :n_valid]
    order = np.argsort(-js, axis=1, kind="stable")[:, :k]
    ws = np.take_along_axis(js, order, axis=1)
    gs, gi = pq_kernel.pq_search(lut, codes_t, rowadd, corr, n_valid=n_valid, k=k,
                                 precision="int8")
    extra = _extra(rowadd, corr)
    assert (np.abs(gs.numpy() - ws) <= _int8_tol(ws, lut, extra)).all()
    picked = np.take_along_axis(js, gi.numpy().astype(np.int64), axis=1)
    assert (np.abs(picked - ws) <= _int8_tol(ws, lut, extra)).all()


@pytest.mark.parametrize("tile_n,residual", [(256, False), (512, False), (512, True)])
def test_plain_k11_4bit_int8_equals_pallas(rng, tile_n, residual):
    """The plain K11 with 4-bit codes and the int8 LUT against the JAX
    pq_search_indexed (interpret mode) at bucket-sized tiles below 1024 (the
    1024-row case is tests/test_torch_ivf_kernels.py's); five tiles, so the
    256-row list is not whole 512-row kernel tiles."""
    q, m, npad, t, k = 5, 32, 4096, 5, 10
    lut, codes_t = _setup(rng, m, npad, q)
    sel = torch.randperm(npad // tile_n, generator=torch.Generator().manual_seed(t))[:t]
    sel = sel.to(torch.int32)
    rowadd, corr = (residual_pair(rng, q, npad, t * tile_n // 512, selection=True)
                    if residual else (None, None))
    ws, wi = j_kernel.pq_search_indexed(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), jnp.asarray(sel.numpy()),
        None if rowadd is None else jnp.asarray(rowadd.numpy()),
        None if corr is None else jnp.asarray(corr.numpy()),
        k=k, precision="int8", tile_n=tile_n, interpret=True)
    gs, gi = pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, k=k,
                                         precision="int8", tile_n=tile_n)
    ws, wi = np.asarray(ws), np.asarray(wi)
    extra = 0.0 if rowadd is None else _extra(rowadd, corr)
    tol = _int8_tol(ws, lut, extra)
    assert (np.abs(gs.numpy() - ws) <= tol).all()
    rows = set(ktile.tile_rows(sel, tile_n).tolist())
    assert set(gi.numpy().ravel().tolist()) <= rows
    # The JAX ids, scored by the port's plain scores, give the JAX values.
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision="int8")
    if residual:
        col = torch.full((npad,), -1, dtype=torch.long)
        col[ktile.tile_rows(sel, tile_n).long()] = torch.arange(t * tile_n)
        scores = (scores + rowadd[None, :]) + ktile.expand_corr(corr, True)[:, col.clamp(min=0)]
    picked = np.take_along_axis(scores.numpy(), wi.astype(np.int64), axis=1)
    assert (np.abs(picked - ws) <= tol).all()
