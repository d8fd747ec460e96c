"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none. The kernels' epilogue rounds like the plain version (no
fused multiply-add) and the int8 dot is exact, so scores are equal to the
bit and exact top-k values are equal; ids may differ only among tied
scores. BQ scores (K5a, K5c, K6) are exact integers, so the same holds. The
PQ kernels (K7a, K7b, K8) sum their LUT entries in their plain version's
order, round each step alike, and compute the int8 epilogue in f64 rounded
once, as the plain version does; K12 and the residual-BQ forms (K5b and the
value-query K5a / K10) round their multiply-add once in f64, as theirs do."""

import tempfile

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qt
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops.kernels import bq_kernel, gather, ktile, pq_kernel, sq_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operands(dev, n_valid, d, q, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    npad = n_valid + (-n_valid) % sq_kernel.TILE_N
    codes = torch.randint(0, 128, (npad, d), generator=g, device=dev, dtype=torch.int8)
    codes[n_valid:] = 0
    voff = torch.rand(npad, generator=g, device=dev) * 10
    voff[n_valid:] = 0
    qcodes = torch.randint(0, 128, (q, d), generator=g, device=dev, dtype=torch.int8)
    qoff = torch.rand(q, generator=g, device=dev)
    mult = torch.rand(q, generator=g, device=dev) * 1e-3 + 1e-4
    return qcodes, qoff, codes, voff, mult


def _check_topk(v, i, pv, scores, n_valid):
    assert torch.equal(v, pv)
    live = i >= 0
    assert bool((i[live] < n_valid).all())
    assert torch.equal(torch.gather(scores, 1, i.clamp(min=0).long())[live], v[live])
    srt = torch.sort(i, dim=1).values
    assert not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any())


@pytest.mark.parametrize("dt", [qt.DistanceType.DOT, qt.DistanceType.L2])
@pytest.mark.parametrize("n_valid,d,q", [(5000, 256, 40), (1000, 1024, 1), (513, 128, 33)])
def test_k3_scores_equal_plain(dev, dt, n_valid, d, q):
    a = _operands(dev, n_valid, d, q, seed=n_valid + q)
    before = sq_kernel.LAUNCHES["sq_scores"]
    got = sq_kernel.sq_scores(*a, distance_type=dt, n_valid=n_valid)
    assert sq_kernel.LAUNCHES["sq_scores"] == before + 1
    want = sq_kernel.sq_scores_plain(*a, distance_type=dt, n_valid=n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 10, 100, 511, 512, 513, 1024])
@pytest.mark.parametrize("n_valid", [3000, 20000])
def test_k1_exact_equal_plain(dev, k, n_valid):
    a = _operands(dev, n_valid, 256, 37, seed=k)
    scores = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.DOT, n_valid=n_valid)
    pv, _ = sq_kernel.sq_search_plain(*a, distance_type=qt.DistanceType.DOT,
                                      n_valid=n_valid, k=k)
    v, i = sq_kernel.sq_search(*a, distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=k)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


def test_k1_k_beyond_n_valid_and_ties(dev):
    n_valid, k = 600, 1000
    qcodes, qoff, codes, voff, mult = _operands(dev, n_valid, 128, 3, seed=7)
    codes[:n_valid] = codes[0]  # every valid row ties
    voff[:n_valid] = 1.0
    scores = sq_kernel.sq_scores_plain(qcodes, qoff, codes, voff, mult,
                                       distance_type=qt.DistanceType.DOT, n_valid=n_valid)
    v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult,
                               distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=k)
    pv, _ = sq_kernel.sq_search_plain(qcodes, qoff, codes, voff, mult,
                                      distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=k)
    _check_topk(v, i, pv, scores, n_valid)
    assert bool((i[:, n_valid:] == -1).all())
    assert bool(torch.isneginf(v[:, n_valid:]).all())


@pytest.mark.parametrize("n_valid", [2000, 2100, 3000, 9000, 100_000])
def test_k2_approx_equal_plain(dev, n_valid):
    a = _operands(dev, n_valid, 128, 19, seed=n_valid)
    scores = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.L2, n_valid=n_valid)
    kw = dict(distance_type=qt.DistanceType.L2, n_valid=n_valid, k=10, mode="approx")
    pv, _ = sq_kernel.sq_search_plain(*a, **kw)
    v, i = sq_kernel.sq_search(*a, **kw)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


def test_kernels_refuse_l1_and_bad_layouts(dev):
    """The fused searches refuse L1 (its scores go through K12, then a
    selection); the kernels refuse layouts they do not take."""
    a = _operands(dev, 1000, 256, 4, seed=1)
    with pytest.raises(qt.ArgumentsError):
        sq_kernel.sq_search(*a, distance_type=qt.DistanceType.L1, n_valid=1000, k=5)
    qcodes, qoff, codes, voff, mult = a
    with pytest.raises(qt.ArgumentsError):
        sq_kernel.sq_search(qcodes[:, :200].contiguous(), qoff, codes[:, :200].contiguous(),
                            voff, mult, distance_type=qt.DistanceType.DOT, n_valid=1000, k=5)
    with pytest.raises(qt.ArgumentsError):
        sq_kernel.sq_search(qcodes.cpu(), qoff, codes, voff, mult,
                            distance_type=qt.DistanceType.DOT, n_valid=1000, k=5)


def test_model_path_runs_through_the_kernels(dev):
    rng = np.random.default_rng(0)
    n, dim = 5000, 200
    data = rng.random((n, dim), dtype=np.float32) * 2 - 1
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    enc = qt.ScalarQuantizerU8.encode(data, params, device=dev)
    cpu = qt.ScalarQuantizerU8.encode(data, params, device="cpu")
    assert torch.equal(enc.codes.cpu(), cpu.codes)
    assert torch.equal(enc.voffsets.cpu(), cpu.voffsets)
    sq_kernel.reset_launches()
    eq = enc.encode_query(data[:16])
    s, i = enc.top_k(eq, 10)
    sa, ia = enc.top_k(eq, 10, method="approx")
    scores = enc.score_batch(eq)
    dense = ("sq_scores", "sq_search_exact", "sq_search_approx")
    assert all(sq_kernel.LAUNCHES[n] > 0 for n in dense), sq_kernel.LAUNCHES
    cs, ci = cpu.top_k(cpu.encode_query(data[:16]), 10)
    np.testing.assert_allclose(s, cs, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(scores.cpu().numpy(), cpu.score_batch(cpu.encode_query(data[:16])).numpy(),
                               rtol=1e-6, atol=1e-4)
    assert sa.shape == (16, 10) and ia.max() < n


# ------------------------------------------------ BQ (K5a, K5c, K6) and K4


def _bq_operands(dev, n_valid, dim, q, seed, w8=None):
    """Random sign planes int32 [W8, Npad] (zero past dim and n_valid) and
    query words [Q, W8], as the BinaryQuantizer lays them out."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    wt = -(-dim // 32)
    w8 = w8 or wt + (-wt) % bq_kernel.W_ALIGN
    npad = n_valid + (-n_valid) % bq_kernel.TILE_N

    def words(rows):
        w = torch.randint(-2**31, 2**31, (rows, w8), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[:, wt:] = 0
        if dim % 32:
            w[:, wt - 1] &= (1 << (dim % 32)) - 1
        return w

    planes = words(npad).T.contiguous()
    planes[:, n_valid:] = 0
    return words(q), planes


BQ_CASES = [(DistanceType.DOT, False), (DistanceType.L2, True), (DistanceType.L1, False)]


def _half_mask(w8, bits):
    """int32 [W8] words with bits 0 .. bits-1 set."""
    m = np.zeros(w8, np.uint32)
    m[: bits // 32] = 0xFFFFFFFF
    if bits % 32:
        m[bits // 32] = (1 << (bits % 32)) - 1
    return torch.from_numpy(m.view(np.int32))


# K6 on the single-bit wgmma body: Q around the 128-query tile; n_valid a
# multiple of 4 (the bulk stores) or not (the warps' stores), off the
# 128-row segment; W8 past the true words; at even dims rows 0 .. 15 lie at
# Hamming distance dim / 2 from query 0, a zero score that must be +0.0.
@pytest.mark.parametrize("dt,invert", BQ_CASES)
@pytest.mark.parametrize("n_valid,dim,w8", [(5000, 1536, None), (4100, 100, 16),
                                            (2049, 100, 16), (7001, 1536, 56),
                                            (2501, 33, None)])
@pytest.mark.parametrize("q", [1, 127, 128, 129, 300])
def test_k6_bq_scores_equal_plain(dev, q, n_valid, dim, w8, dt, invert):
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=n_valid + q, w8=w8)
    if dim % 2 == 0:
        planes[:, :16] = (qw[0] ^ _half_mask(planes.shape[0], dim // 2).to(dev))[:, None]
    kw = dict(distance_type=dt, invert=invert, dim=dim, n_valid=n_valid)
    before = bq_kernel.LAUNCHES["bq_scores"]
    got = bq_kernel.bq_scores(qw, planes, **kw)
    assert bq_kernel.LAUNCHES["bq_scores"] == before + 1
    want = bq_kernel.bq_scores_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    if dim % 2 == 0:
        assert bool((got[0, :16] == 0).all()) and not bool(torch.signbit(got[0, :16]).any())


@pytest.mark.parametrize("k", [1, 10, 40, 512, 513, 1024])
def test_k5c_bq_exact_equal_plain(dev, k):
    n_valid, dim = 6000, 256
    qw, planes = _bq_operands(dev, n_valid, dim, 37, seed=k)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid)
    scores = bq_kernel.bq_scores_plain(qw, planes, **kw)
    pv, _ = bq_kernel.bq_search_plain(qw, planes, k=k, **kw)
    v, i = bq_kernel.bq_search(qw, planes, k=k, **kw)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


def test_k5c_k_beyond_n_valid_and_all_ties(dev):
    n_valid, k = 600, 1000
    qw, planes = _bq_operands(dev, n_valid, 64, 3, seed=5)
    planes[:, :n_valid] = planes[:, :1]  # every valid row ties
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=64, n_valid=n_valid)
    scores = bq_kernel.bq_scores_plain(qw, planes, **kw)
    pv, _ = bq_kernel.bq_search_plain(qw, planes, k=k, **kw)
    v, i = bq_kernel.bq_search(qw, planes, k=k, **kw)
    _check_topk(v, i, pv, scores, n_valid)
    assert bool((i[:, n_valid:] == -1).all())
    assert bool(torch.isneginf(v[:, n_valid:]).all())


@pytest.mark.parametrize("n_valid,dim", [(3000, 128), (5000, 1024), (4000, 2048),
                                         (100_000, 1536)])
def test_k5a_bq_approx_equal_plain(dev, n_valid, dim):
    qw, planes = _bq_operands(dev, n_valid, dim, 19, seed=n_valid)
    kw = dict(distance_type=DistanceType.L2, invert=True, dim=dim, n_valid=n_valid,
              k=40, mode="approx")
    scores = bq_kernel.bq_scores_plain(qw, planes, **{
        k: v for k, v in kw.items() if k not in ("k", "mode")})
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


# The sign-query searches on the single-bit wgmma body (K5c, K5a, K10):
# depths of a partial 256-bit step, a partial 128-byte chunk and several
# chunks; Q around the 64-query tile; n_valid off every segment and split.
SIGN_DIMS = [1, 100, 257, 1000, 1536, 2100]
SIGN_QS = [1, 37, 65, 300]


@pytest.mark.parametrize("dt,invert", BQ_CASES)
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("dim", SIGN_DIMS)
@pytest.mark.parametrize("q", SIGN_QS)
def test_b1_sign_search_equal_plain(dev, q, dim, mode, dt, invert):
    n_valid = 4100
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=q * 13 + dim)
    kw = dict(distance_type=dt, invert=invert, dim=dim, n_valid=n_valid, k=40, mode=mode)
    name = "bq_search_" + mode
    before = bq_kernel.LAUNCHES[name]
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    assert bq_kernel.LAUNCHES[name] == before + 1
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    scores = bq_kernel.bq_scores_plain(qw, planes, distance_type=dt, invert=invert, dim=dim,
                                       n_valid=n_valid)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)
    if mode == "approx":
        assert torch.equal(i, pi)


@pytest.mark.parametrize("k", [1, 40, 512, 513])
@pytest.mark.parametrize("n_valid", [1, 511, 3000, 9000])
def test_b1_sign_exact_k_and_ragged_n_valid(dev, k, n_valid):
    qw, planes = _bq_operands(dev, n_valid, 300, 65, seed=k + n_valid)
    kw = dict(distance_type=DistanceType.L2, invert=False, dim=300, n_valid=n_valid, k=k)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    pv, _ = bq_kernel.bq_search_plain(qw, planes, **kw)
    scores = bq_kernel.bq_scores_plain(qw, planes, distance_type=DistanceType.L2, invert=False,
                                       dim=300, n_valid=n_valid)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)
    if k > n_valid:
        assert bool((i[:, n_valid:] == -1).all()) and bool(torch.isneginf(v[:, n_valid:]).all())


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("q", [1, 65, 300])
def test_b1_sign_all_ties_first_row_wins(dev, q, mode):
    """Every valid row is the same: exact takes each 512-row split's first
    rows, approx the first row of each stride class, as the plain version."""
    n_valid = 4100
    qw, planes = _bq_operands(dev, n_valid, 1536, q, seed=q)
    planes[:, :n_valid] = planes[:, :1]
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=1536, n_valid=n_valid, k=20,
              mode=mode)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv)
    if mode == "approx":
        assert torch.equal(i, pi)
    else:
        assert _first_rows_of_splits(i, 20)


@pytest.mark.parametrize("dim", [100, 768, 2100])
@pytest.mark.parametrize("q", SIGN_QS)
def test_b1_sign_k10_permuted_tiles_equal_plain(dev, q, dim):
    npad, tile_n = 16384, 1024
    qw, planes = _bq_operands(dev, npad, dim, q, seed=q + dim)
    sel = _selection(dev, npad // tile_n, 6, seed=q)
    kw = dict(distance_type=DistanceType.L1, invert=True, dim=dim, k=40, tile_n=tile_n)
    before = bq_kernel.LAUNCHES["bq_search_indexed"]
    v, i = bq_kernel.bq_search_indexed(qw, planes, sel, **kw)
    assert bq_kernel.LAUNCHES["bq_search_indexed"] == before + 1
    pv, pi = bq_kernel.bq_search_indexed_plain(qw, planes, sel, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("per_query", [True, False])
@pytest.mark.parametrize("dt", [DistanceType.DOT, DistanceType.L2, DistanceType.L1])
@pytest.mark.parametrize("d,r", [(1536, 40), (128, 7), (256, 1000)])
def test_k4_rescore_equal_plain(dev, dt, d, r, per_query):
    qcodes, qoff, codes, voff, mult = _operands(dev, 3000, d, 17, seed=d + r)
    if not per_query:
        mult = mult[:1].clone()
    g = torch.Generator(device=dev)
    g.manual_seed(r)
    cand = torch.randint(0, 3000, (17, r), generator=g, device=dev, dtype=torch.int32)
    cand[0, 0] = -1
    cand[5, r - 1] = -1
    before = gather.LAUNCHES["sq_score_candidates"]
    got = gather.sq_score_candidates(qcodes, qoff, codes, voff, cand, mult,
                                     distance_type=dt, n_valid=3000)
    assert gather.LAUNCHES["sq_score_candidates"] == before + 1
    want = gather.sq_score_candidates_plain(qcodes, qoff, codes, voff, cand, mult,
                                            distance_type=dt, n_valid=3000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(torch.isneginf(got[cand < 0]).all())


def test_k4_out_of_range_ids_score_neg_inf(dev):
    """Ids in [n_valid, npad) and >= npad score -inf on the kernel, as on
    the plain version, and read nothing."""
    qcodes, qoff, codes, voff, mult = _operands(dev, 3000, 256, 4, seed=5)
    npad = codes.shape[0]
    cand = torch.randint(0, 3000, (4, 9), device=dev, dtype=torch.int32)
    cand[0, 1], cand[1, 2], cand[2, 3], cand[3, 8] = 3000, npad - 1, npad, 2**31 - 1
    kw = dict(distance_type=DistanceType.DOT, n_valid=3000)
    got = gather.sq_score_candidates(qcodes, qoff, codes, voff, cand, mult, **kw)
    want = gather.sq_score_candidates_plain(qcodes, qoff, codes, voff, cand, mult, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = cand >= 3000
    assert bool(torch.isneginf(got[out]).all()) and bool(torch.isfinite(got[~out]).all())


def test_two_stage_path_runs_through_the_kernels(dev):
    rng = np.random.default_rng(1)
    n, dim = 20000, 256
    data = rng.standard_normal((n, dim)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    bq = qt.BinaryQuantizer.encode(data, params)
    sq = qt.ScalarQuantizerU8.encode(data, params)
    assert bq.device.type == "cuda" and sq.device.type == "cuda"
    bq_cpu = qt.BinaryQuantizer.encode(data, params, device="cpu")
    assert torch.equal(bq.planes.cpu(), bq_cpu.planes)
    bq_kernel.reset_launches()
    gather.reset_launches()
    for method in ("approx", "exact"):
        idx = qt.TwoStageIndex(bq, sq, oversampling=4.0, coarse_method=method)
        s, i = idx.top_k(idx.encode_query(data[:16]), 10)
        assert (i[:, 0] == np.arange(16)).all()
        want = sq.score_candidates(sq.encode_query(data[:16]), i).cpu().numpy()
        np.testing.assert_array_equal(s, want)
    fine = qt.ExactRescorer(data, qt.DistanceType.DOT, False)
    s, i = qt.TwoStageIndex(bq, fine).top_k(qt.TwoStageIndex(bq, fine).encode_query(data[:4]), 5)
    assert (i[:, 0] == np.arange(4)).all()
    bq.score_batch(bq.encode_query(data[:4]))
    dense = ("bq_scores", "bq_search_exact", "bq_search_approx")
    assert all(bq_kernel.LAUNCHES[n] > 0 for n in dense), bq_kernel.LAUNCHES
    assert gather.LAUNCHES["sq_score_candidates"] > 0


# ------------------------------------------------------- PQ (K7a, K7b, K8)


def _pq_operands(dev, kc, m, n_valid, q, seed):
    """A LUT f32 [Q, m, kc] and codes u8 [Mpad, Npad] (zero past m and
    n_valid), in the ProductQuantizer's layout."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lut = torch.randn(q, m, kc, generator=g, device=dev) * 2 + torch.randn(
        q, m, 1, generator=g, device=dev)
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = torch.zeros((mpad, npad), dtype=torch.uint8, device=dev)
    codes_t[:m, :n_valid] = torch.randint(0, kc, (m, n_valid), generator=g, device=dev,
                                          dtype=torch.uint8)
    return lut, codes_t


# K8's shapes: n_valid around a 128-row segment, a 512-row tile, a 4096-row
# part and a run of 8 segments (the 4-bit bf16 route's block); Q around the
# 32- and 64-query tiles; m odd, below 8, not a multiple of 8.
PQ_SHAPES = [(256, 96, 5000, 40), (16, 192, 3000, 33), (256, 7, 2049, 1), (16, 13, 1500, 70),
             (16, 8, 1, 1), (16, 24, 1025, 65), (16, 96, 4097, 129), (256, 13, 513, 33),
             (16, 40, 9000, 300)]
PQ_PRECISIONS = ["int8", "bf16", "bf16x2"]


def _special_lut(lut, seed):
    """The LUT with its awkward values: each (query, chunk) scaled by 2^k,
    |k| <= 40; a tenth of the entries +-0.0, a twentieth bf16 subnormals (j *
    2^-133), every fifth chunk of query 0 all -0.0, and with Q > 2 the last
    query of subnormals only and the one before it of -0.0 only. If the
    tensor cores flushed subnormals, the bf16 one-hot route would score the
    last query 0.0 and fail."""
    g = torch.Generator(device=lut.device)
    g.manual_seed(seed)
    q, m, kc = lut.shape
    dev = lut.device
    lut = lut * torch.exp2(torch.randint(-40, 41, (q, m, 1), generator=g, device=dev).float())
    r = torch.rand(lut.shape, generator=g, device=dev)
    sign = torch.where(torch.rand(lut.shape, generator=g, device=dev) < 0.5, -1.0, 1.0)
    sub = torch.randint(1, 128, lut.shape, generator=g, device=dev).float() * 2.0 ** -133
    lut = torch.where(r < 0.1, sign * 0.0, lut)
    lut = torch.where((r >= 0.1) & (r < 0.15), sign * sub, lut)
    lut[0, ::5] = -0.0
    if q > 2:
        lut[-1] = sign[-1] * sub[-1]
        lut[-2] = -0.0
    return lut


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m,n_valid,q", PQ_SHAPES)
def test_k8_pq_scores_equal_plain(dev, kc, m, n_valid, q, precision, special):
    """K8 on each of its routes (8 bits: the ring, int8 and bf16 words; 4
    bits: the int8 and the bf16 one-hot products) equals plain to the bit,
    on a random LUT and on one with +-0.0, far binades and subnormals."""
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, q, seed=m + q)
    if special:
        lut = _special_lut(lut, seed=m + n_valid)
    before = pq_kernel.LAUNCHES["pq_scores"]
    got = pq_kernel.pq_scores(lut, codes_t, n_valid=n_valid, precision=precision)
    assert pq_kernel.LAUNCHES["pq_scores"] == before + 1
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if special and q > 2 and precision != "int8":
        assert bool(want[-1].any()), "the subnormal query scores nonzero"


@pytest.mark.parametrize("m", [8, 13, 192])
def test_k8_bf16_onehot_nonfinite_lut_is_nan_in_its_chunk(dev, m):
    """ROADMAP Queue 3, F28, pinned as it is: the 4-bit bf16 K8 (one-hot
    products) scores NaN in every row whose code misses an entry that is not
    finite in bf16 (0.0 times it in the product), and that entry's infinity
    in the rows whose code is it; +inf and -inf in one chunk make every row
    NaN. Query 0 holds +inf and an f32 entry that rounds to -inf in bf16 in
    one chunk, query 1 a +inf, query 2 a -inf; the finite queries equal
    plain to the bit. (The plain version gives the infinities to the rows
    with those codes only; tests/test_torch_pq_onehot_bf16.py holds the
    same pattern against the JAX package's one-hot matmul.)"""
    q, n_valid = 5, 1100
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=m)
    lut[0, 3, 5], lut[0, 3, 9] = float("inf"), -torch.finfo(torch.float32).max
    lut[1, m - 1, 2] = float("inf")
    lut[2, 0, 11] = -float("inf")
    code = codes_t[:, :n_valid].long() & 15
    before = pq_kernel.BF16_ONEHOT_LAUNCHES["pq_scores"]
    got = pq_kernel.pq_scores(lut, codes_t, n_valid=n_valid, precision="bf16")
    assert pq_kernel.BF16_ONEHOT_LAUNCHES["pq_scores"] == before + 1
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="bf16")
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0]).all())
    for j, hit, inf in ((1, code[m - 1] == 2, float("inf")), (2, code[0] == 11, -float("inf"))):
        assert bool(hit.any()) and not bool(hit.all())
        assert bool((got[j][hit] == inf).all()) and bool(torch.isnan(got[j][~hit]).all())
    assert torch.equal(got[3:].view(torch.int32), want[3:].view(torch.int32))


# m values that end a stage of the searches' LUT ring partway (a stage holds
# 1 / 2 / 4 chunks at 8 bits for bf16x2 / bf16 / int8, 8 or 16 at 4 bits).
RING_MS = [(256, 2), (256, 16), (256, 18), (256, 96), (16, 24)]


@pytest.mark.parametrize("k", [1, 10, 512, 513, 1024])
@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m", [(256, 32), (16, 48)] + RING_MS)
def test_k7b_pq_exact_equal_plain(dev, kc, m, precision, k):
    n_valid = 6000
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, 37, seed=k + m)
    kw = dict(n_valid=n_valid, precision=precision)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=n_valid, precision=precision)
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, k=k, **kw)
    before = pq_kernel.LAUNCHES["pq_search_exact"]
    v, i = pq_kernel.pq_search(lut, codes_t, k=k, **kw)
    assert pq_kernel.LAUNCHES["pq_search_exact"] == before + 1
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


def test_k7b_pq_k_beyond_n_valid_and_all_ties(dev):
    n_valid, k = 600, 1000
    lut, codes_t = _pq_operands(dev, 256, 16, n_valid, 3, seed=3)
    codes_t[:, :n_valid] = codes_t[:, :1]  # every valid row ties
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8")
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, n_valid=n_valid, k=k, precision="int8")
    v, i = pq_kernel.pq_search(lut, codes_t, n_valid=n_valid, k=k, precision="int8")
    _check_topk(v, i, pv, scores, n_valid)
    assert bool((i[:, n_valid:] == -1).all())
    assert bool(torch.isneginf(v[:, n_valid:]).all())


@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m,n_valid", [(256, 96, 3000), (16, 192, 9000), (256, 16, 100_000),
                                          (256, 2, 5000), (256, 18, 9000), (16, 24, 4097)])
def test_k7a_pq_approx_equal_plain(dev, kc, m, n_valid, precision):
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, 19, seed=n_valid)
    kw = dict(n_valid=n_valid, k=40, mode="approx", precision=precision)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=n_valid, precision=precision)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, **kw)
    before = pq_kernel.LAUNCHES["pq_search_approx"]
    v, i = pq_kernel.pq_search(lut, codes_t, **kw)
    assert pq_kernel.LAUNCHES["pq_search_approx"] == before + 1
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)
    assert torch.equal(i, pi)  # one tie rule: the first maximum in row order


# The LUT-gather lookup loop (csrc/pq_kernels.cuh Lanes): a lane's 8-byte
# load serves 8 int8 / 4 bf16 / 2 bf16x2 queries of the 32-query tile, int8
# sums packed two to a register and flushed every 256 chunks. Query counts
# that leave a tile's lanes partly past Q; 8-bit codes and the 4-bit bf16 /
# bf16x2 searches (the one-hot route takes the 4-bit int8 LUT).
GATHER_QS = [4, 33, 100]
GATHER_ROUTES = [(256, 96, "int8"), (256, 96, "bf16"), (256, 96, "bf16x2"),
                 (16, 192, "bf16"), (16, 192, "bf16x2")]


@pytest.mark.parametrize("q", GATHER_QS)
@pytest.mark.parametrize("kc,m,precision", GATHER_ROUTES)
def test_gather_ragged_queries_equal_plain(dev, kc, m, precision, q):
    """K8 (8 bits) to the bit, K7b values (ids up to ties), K7a and K11
    values and ids, at Q = 4, 33 and 100 on the gather body."""
    n_valid = 5000
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, q, seed=q + m)
    kw = dict(n_valid=n_valid, precision=precision)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, **kw)
    before, onehot = dict(pq_kernel.LAUNCHES), dict(pq_kernel.ONEHOT_LAUNCHES)
    if kc == 256 and precision != "bf16x2":
        got = pq_kernel.pq_scores(lut, codes_t, **kw)
        want = pq_kernel.pq_scores_plain(lut, codes_t, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    v, i = pq_kernel.pq_search(lut, codes_t, k=20, **kw)
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, k=20, **kw)
    _check_topk(v, i, pv, scores, n_valid)
    v, i = pq_kernel.pq_search(lut, codes_t, k=20, mode="approx", **kw)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, k=20, mode="approx", **kw)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    sel = _selection(dev, codes_t.shape[1] // 1024, 3, seed=q)
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, k=20, precision=precision)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, k=20, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert all(pq_kernel.LAUNCHES[n] == before[n] + 1
               for n in ("pq_search_exact", "pq_search_approx", "pq_search_indexed"))
    assert pq_kernel.ONEHOT_LAUNCHES == onehot  # every launch on the gather body


def _extreme_int8(dev, q, m, n_valid, kind):
    """A LUT whose int8 entries are +127 at code 0, -127 at code 1 and 0
    elsewhere for every (query, chunk), and codes that pick +127 in every
    chunk (all_plus), -127 (all_minus) or the two in turn (alternating): the
    packed 16-bit sums' extremes."""
    lut = torch.zeros((q, m, 256), device=dev)
    lut[:, :, 0], lut[:, :, 1] = 1.0, -1.0
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = torch.zeros((mpad, npad), dtype=torch.uint8, device=dev)
    c = torch.arange(m, device=dev)[:, None] + torch.arange(n_valid, device=dev)[None]
    codes_t[:m, :n_valid] = {"all_plus": 0 * c, "all_minus": 0 * c + 1,
                             "alternating": c % 2}[kind].to(torch.uint8)
    return lut, codes_t


@pytest.mark.parametrize("m", [96, 256, 272, 512])
@pytest.mark.parametrize("kind", ["all_plus", "all_minus", "alternating"])
def test_gather_int8_extreme_sums_and_the_flush(dev, kind, m):
    """The int8 gather kernels (K8, K7b, K7a, K11) on LUTs whose sums reach
    +-127 x m, at m below, at and past the 256-chunk flush of the packed
    sums: equal to plain as above."""
    n_valid, q = 2100, 33
    lut, codes_t = _extreme_int8(dev, q, m, n_valid, kind)
    kw = dict(n_valid=n_valid, precision="int8")
    lutq, _, _ = pq_kernel.quantize_lut(lut)
    assert int(lutq[:, :, 0].min()) == 127 and int(lutq[:, :, 1].max()) == -127
    got = pq_kernel.pq_scores(lut, codes_t, **kw)
    want = pq_kernel.pq_scores_plain(lut, codes_t, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    v, i = pq_kernel.pq_search(lut, codes_t, k=30, **kw)
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, k=30, **kw)
    _check_topk(v, i, pv, want, n_valid)
    v, i = pq_kernel.pq_search(lut, codes_t, k=30, mode="approx", **kw)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, k=30, mode="approx", **kw)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    sel = _selection(dev, codes_t.shape[1] // 512, 3, seed=m)
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, k=30, precision="int8", tile_n=512)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, k=30, precision="int8",
                                               tile_n=512)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("q", [1] + GATHER_QS)
@pytest.mark.parametrize("m", [272, 400])
def test_gather_int8_random_past_the_flush(dev, m, q):
    """Random LUTs and codes past the flush (mpad 272, 400): K8 to the bit,
    K7b, K7a and K11 with the residual additives as above."""
    n_valid = 3000
    lut, codes_t = _pq_operands(dev, 256, m, n_valid, q, seed=m + q)
    kw = dict(n_valid=n_valid, precision="int8")
    got = pq_kernel.pq_scores(lut, codes_t, **kw)
    want = pq_kernel.pq_scores_plain(lut, codes_t, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    npad = codes_t.shape[1]
    rowadd, corr = _pq_residual(dev, q, npad, npad // 512, False, seed=m)
    for mode in ("exact", "approx"):
        v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, k=25, mode=mode, **kw)
        pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, k=25, mode=mode, **kw)
        scores = ((want + rowadd[None, :n_valid])
                  + torch.repeat_interleave(corr, 512, dim=1)[:, :n_valid])
        _check_topk(v, i, pv, scores, n_valid)
        if mode == "approx":
            assert torch.equal(i, pi)
    sel = _selection(dev, npad // 1024, 2, seed=q)
    rowadd, corr = _pq_residual(dev, q, npad, 2 * 1024 // 512, True, seed=q)
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, k=25, precision="int8")
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, k=25,
                                               precision="int8")
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("m", [24, 272])
def test_gather_4bit_int8_k11_on_wide_tiles(dev, m):
    """K11 with 4-bit codes and the int8 LUT over tiles too wide for the
    one-hot route's parts (tile_n 8192) runs the gather body's KC = 16 int8
    loop (packed sums, past the flush at m = 272): values and ids equal the
    plain approx."""
    tile_n, q = 8192, 33
    lut, codes_t = _pq_operands(dev, 16, m, 3 * tile_n, q, seed=m)
    sel = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    assert not pq_kernel.onehot_route(16, "int8", "indexed", tile_n)
    onehot = dict(pq_kernel.ONEHOT_LAUNCHES)
    kw = dict(k=30, precision="int8", tile_n=tile_n)
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, **kw)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert pq_kernel.ONEHOT_LAUNCHES == onehot


# 4-bit codes with the int8 LUT: K8 and the dense K7a on the one-hot route
# (the tensor-core scan body, csrc/pq4_mma_kernels.cu). Query counts on both
# sides of the 64- and 128-query tiles, n_valid on both sides of a 128-row
# segment and a 4096-row part, m of 1, 3 and 24 depth chunks.
ONEHOT_QS = [1, 64, 65, 129, 300]
ONEHOT_NS = [1, 127, 128, 4097, 5000]
ONEHOT_MS = [8, 24, 192]


def _pq4_operands(dev, m, n_valid, q, seed):
    """_pq_operands with 4-bit codes whose valid entries carry a random high
    nibble (the kernels read ``& 15``)."""
    lut, codes_t = _pq_operands(dev, pq_kernel.K4, m, n_valid, q, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    codes_t[:m, :n_valid] |= torch.randint(0, 16, (m, n_valid), generator=g, device=dev,
                                           dtype=torch.uint8) << 4
    return lut, codes_t


# K8 (pq4_scores_ws_kernel): both geometries (Q <= 64: 64 queries and four
# m64 blocks a warpgroup, else 128 and two), the CLI's Q = 100, n_valid odd
# (the warps' stores) and a multiple of 4 but not of 128 (the bulk stores
# of a partial segment), blocks that walk several units (70,004 rows).
K8_QS = sorted({*ONEHOT_QS, 33, 100, 256})
K8_NS = [*ONEHOT_NS, 5003, 70_004]


@pytest.mark.parametrize("m", [*ONEHOT_MS, 13])
@pytest.mark.parametrize("n_valid", K8_NS)
@pytest.mark.parametrize("q", K8_QS)
def test_onehot_k8_equal_plain_to_the_bit(dev, q, n_valid, m):
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=q * 31 + n_valid + m)
    before = pq_kernel.ONEHOT_LAUNCHES["pq_scores"]
    got = pq_kernel.pq_scores(lut, codes_t, n_valid=n_valid, precision="int8")
    assert pq_kernel.ONEHOT_LAUNCHES["pq_scores"] == before + 1
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m,n_valid,q", [(8, 1, 1), (24, 5000, 65), (192, 9000, 19),
                                         (192, 70_000, 300), (24, 4097, 129)])
def test_onehot_k7a_equal_plain(dev, m, n_valid, q, residual):
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=n_valid + m)
    npad = codes_t.shape[1]
    rowadd, corr = (_pq_residual(dev, q, npad, npad // 512, False, seed=m) if residual
                    else (None, None))
    kw = dict(n_valid=n_valid, k=40, mode="approx", precision="int8")
    before = pq_kernel.ONEHOT_LAUNCHES["pq_search_approx"]
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    assert pq_kernel.ONEHOT_LAUNCHES["pq_search_approx"] == before + 1
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [1, 10, 512, 1024])
@pytest.mark.parametrize("m,n_valid,q", [(8, 1, 1), (24, 127, 65), (192, 511, 19),
                                         (192, 513, 300), (24, 5000, 129), (8, 70_000, 64)])
def test_onehot_k7b_equal_plain(dev, m, n_valid, q, k, residual):
    """K7b on the one-hot route (the exact scan body): values equal the
    plain top-k's to the bit, ids up to ties; n_valid around a 128-row
    segment and a 512-row split, codes with their high nibble set."""
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=n_valid + m + k)
    npad = codes_t.shape[1]
    rowadd, corr = (_pq_residual(dev, q, npad, npad // 512, False, seed=m) if residual
                    else (None, None))
    kw = dict(n_valid=n_valid, k=k, precision="int8")
    before = pq_kernel.ONEHOT_LAUNCHES["pq_search_exact"]
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    assert pq_kernel.ONEHOT_LAUNCHES["pq_search_exact"] == before + 1
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision="int8")
    if residual:
        scores = (scores + rowadd[None]) + torch.repeat_interleave(corr, 512, dim=1)
    torch.cuda.synchronize()
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    _check_topk(v, i, pv, scores[:, :n_valid], n_valid)


def test_onehot_k7b_zero_scores(dev):
    """A query whose LUT is all -0.0 scores every row exactly zero (the int8
    epilogue gives +0.0: a zero sum plus a bias of -0.0), and the route's
    row of -0.0 leaves every bit as the plain version has it."""
    n_valid, q, k = 3000, 33, 600
    lut, codes_t = _pq4_operands(dev, 32, n_valid, q, seed=9)
    lut[3] = -0.0
    kw = dict(n_valid=n_valid, k=k, precision="int8")
    v, i = pq_kernel.pq_search(lut, codes_t, **kw)
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, **kw)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8")
    torch.cuda.synchronize()
    assert not bool(scores[3].view(torch.int32).any())  # +0.0 to the bit
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    _check_topk(v, i, pv, scores, n_valid)


@pytest.mark.parametrize("tile_n,t,residual", [(256, 9, False), (512, 7, False),
                                                (512, 7, True), (1024, 5, False),
                                                (1024, 5, True), (1024, 1, True)])
@pytest.mark.parametrize("m,q", [(8, 1), (24, 65), (192, 300)])
def test_onehot_k11_equal_plain(dev, m, q, tile_n, t, residual):
    """K11 on the one-hot route (the approx scan body with the tile list in
    its ScanMap): values and ids equal the plain K11, over permuted tiles
    (nine 256-row tiles pad the list to whole 512-row tiles; the additives
    need tiles of whole 512-row corr blocks)."""
    n_valid = 24 * 1024
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=m + tile_n + t)
    sel = _selection(dev, n_valid // tile_n, t, seed=tile_n + t)
    rowadd, corr = (_pq_residual(dev, q, codes_t.shape[1], t * tile_n // 512, True, seed=m)
                    if residual else (None, None))
    kw = dict(k=40, precision="int8", tile_n=tile_n)
    before = pq_kernel.ONEHOT_LAUNCHES["pq_search_indexed"]
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, **kw)
    assert pq_kernel.ONEHOT_LAUNCHES["pq_search_indexed"] == before + 1
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_onehot_launch_counters(dev):
    """Only K8, K7b, K7a and K11 with 4-bit codes and the int8 LUT count on
    the one-hot route, and only K8 with 4-bit codes and the bf16 or bf16x2
    LUT on the bf16 one-hot route; every launch still counts under its
    wrapper's name."""
    pq_kernel.reset_launches()
    lut4, ct4 = _pq4_operands(dev, 24, 3000, 33, seed=5)
    lut8, ct8 = _pq_operands(dev, 256, 24, 3000, 33, seed=6)
    kw = dict(n_valid=3000)
    sel = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    pq_kernel.pq_scores(lut4, ct4, precision="int8", **kw)
    pq_kernel.pq_search(lut4, ct4, k=10, mode="approx", precision="int8", **kw)
    pq_kernel.pq_search(lut4, ct4, k=10, precision="int8", **kw)
    pq_kernel.pq_search_indexed(lut4, ct4, sel, k=10, precision="int8")
    onehot = {"pq_scores": 1, "pq_search_exact": 1, "pq_search_approx": 1,
              "pq_search_indexed": 1}
    assert pq_kernel.ONEHOT_LAUNCHES == onehot
    assert pq_kernel.BF16_ONEHOT_LAUNCHES == {"pq_scores": 0}
    pq_kernel.pq_scores(lut4, ct4, precision="bf16", **kw)
    pq_kernel.pq_scores(lut4, ct4, precision="bf16x2", **kw)
    assert pq_kernel.BF16_ONEHOT_LAUNCHES == {"pq_scores": 2}
    pq_kernel.pq_search(lut4, ct4, k=10, precision="bf16", **kw)
    pq_kernel.pq_search(lut4, ct4, k=10, mode="approx", precision="bf16x2", **kw)
    pq_kernel.pq_scores(lut8, ct8, precision="int8", **kw)
    pq_kernel.pq_search(lut8, ct8, k=10, mode="approx", precision="int8", **kw)
    pq_kernel.pq_search(lut8, ct8, k=10, precision="int8", **kw)
    pq_kernel.pq_search_indexed(lut8, ct8, sel, k=10, precision="int8")
    pq_kernel.pq_scores(lut8, ct8, precision="bf16", **kw)
    torch.cuda.synchronize()
    assert pq_kernel.ONEHOT_LAUNCHES == onehot
    assert pq_kernel.BF16_ONEHOT_LAUNCHES == {"pq_scores": 2}
    assert pq_kernel.LAUNCHES == {"pq_scores": 5, "pq_search_exact": 3,
                                  "pq_search_approx": 3, "pq_search_indexed": 2}


# The one-hot kernels with A built in registers (csrc/pq4_mma_kernels.cu:
# pq4_approx_ws_kernel for K7a / K11, pq4_queue_kernel for K7b up to
# ktile.QUEUE_K_MAX, the radix select on NibbleRows above it): query counts
# around the 64-query tile and the main path's 256, ragged n_valid, LUTs of
# four values (many tied scores), with and without the residual pair.
I8FRAG_QS = [4, 33, 100, 256]


def _pq4_case(dev, m, n_valid, q, ties, seed):
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed)
    if ties:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 2)
        lut = torch.randint(-2, 2, lut.shape, generator=g, device=dev).float()
    return lut, codes_t


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("q", I8FRAG_QS)
@pytest.mark.parametrize("m,n_valid", [(31, 9000), (192, 70_001)])
def test_onehot_i8frag_k7a_equal_plain(dev, m, n_valid, q, residual, ties):
    lut, codes_t = _pq4_case(dev, m, n_valid, q, ties, seed=m + q)
    npad = codes_t.shape[1]
    rowadd, corr = (_pq_residual(dev, q, npad, npad // 512, False, seed=q) if residual
                    else (None, None))
    kw = dict(n_valid=n_valid, k=40, mode="approx", precision="int8")
    before = pq_kernel.ONEHOT_LAUNCHES["pq_search_approx"]
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    assert pq_kernel.ONEHOT_LAUNCHES["pq_search_approx"] == before + 1
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("q", I8FRAG_QS)
@pytest.mark.parametrize("k", [10, 40, 64, 65])
def test_onehot_i8frag_k7b_equal_plain(dev, k, q, residual, ties):
    """Values equal the plain top-k's to the bit, ids up to ties; k = 65
    takes the radix select."""
    from quantization_tpu_torch.ops.kernels import ktile

    m, n_valid = 24, 20_001
    lut, codes_t = _pq4_case(dev, m, n_valid, q, ties, seed=k + q)
    npad = codes_t.shape[1]
    rowadd, corr = (_pq_residual(dev, q, npad, npad // 512, False, seed=k) if residual
                    else (None, None))
    kw = dict(n_valid=n_valid, k=k, precision="int8")
    before = dict(ktile.SELECT_LAUNCHES)
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    route = "queue" if k <= ktile.QUEUE_K_MAX else "radix"
    assert ktile.SELECT_LAUNCHES[route] == before[route] + 1
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision="int8")
    if residual:
        scores = (scores + rowadd[None]) + torch.repeat_interleave(corr, 512, dim=1)
    torch.cuda.synchronize()
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    _check_topk(v, i, pv, scores[:, :n_valid], n_valid)


@pytest.mark.parametrize("q", I8FRAG_QS)
@pytest.mark.parametrize("tile_n,t,residual", [(384, 5, False), (1024, 9, False),
                                                (512, 7, True), (1024, 9, True)])
def test_onehot_i8frag_k11_equal_plain(dev, q, tile_n, t, residual):
    """Over permuted tiles, 384-row ones leaving the last item a partial unit
    of segments: values and ids equal the plain K11."""
    n_valid = 24 * 1024 + (-(24 * 1024)) % tile_n
    lut, codes_t = _pq4_case(dev, 40, n_valid, q, False, seed=q + tile_n)
    sel = _selection(dev, n_valid // tile_n, t, seed=tile_n + t)
    rowadd, corr = (_pq_residual(dev, q, codes_t.shape[1], t * tile_n // 512, True, seed=q)
                    if residual else (None, None))
    kw = dict(k=40, precision="int8", tile_n=tile_n)
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, **kw)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_pq_kernels_refuse_bad_layouts(dev):
    lut, codes_t = _pq_operands(dev, 256, 16, 1000, 4, seed=1)
    with pytest.raises(qt.ArgumentsError):
        pq_kernel.pq_scores(lut, codes_t[:, :1000], n_valid=1000)
    with pytest.raises(qt.ArgumentsError):
        pq_kernel.pq_search(lut[:, :, :100].contiguous(), codes_t, n_valid=1000, k=5)
    with pytest.raises(qt.ArgumentsError):
        pq_kernel.pq_search(lut.cpu(), codes_t, n_valid=1000, k=5)


def test_pq_model_path_runs_through_the_kernels(dev):
    from quantization_tpu_torch.ops import pq as pq_ops

    rng = np.random.default_rng(2)
    n, dim = 6000, 64
    data = rng.standard_normal((n, dim)).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    for bits, chunk in ((8, 8), (4, 4)):
        enc = qt.ProductQuantizer.encode(data, params, chunk_size=chunk, bits=bits)
        assert enc.codes.device.type == "cuda"
        m = enc.num_chunks
        # The CPU encoder with the card's centroids: equal but for near-ties.
        cpu_codes = pq_ops.encode_batch(
            torch.from_numpy(pq_ops.chunk_tensor(data, enc.metadata.vector_division)),
            enc._c_chunks.cpu())
        assert float((enc.codes[:n, :m].cpu() != cpu_codes).float().mean()) < 1e-3
        pq_kernel.reset_launches()
        eq = enc.encode_query(data[:16])
        s, i = enc.top_k(eq, 10)
        sa, ia = enc.top_k(eq, 10, method="approx")
        scores = enc.score_batch(eq)
        dense = ("pq_scores", "pq_search_exact", "pq_search_approx")
        assert all(pq_kernel.LAUNCHES[n] > 0 for n in dense), pq_kernel.LAUNCHES
        np.testing.assert_array_equal(s, torch.topk(scores, 10, dim=1).values.cpu().numpy())
        assert sa.shape == (16, 10) and ia.max() < n
        # The same state on the CPU scores the same LUT to the bit.
        cpu = qt.pq_from_numpy(*qt.pq_to_numpy(enc), device="cpu")
        cq = qt.EncodedQueryPQ(eq.lut.cpu())
        assert torch.equal(cpu.score_batch(cq), scores.cpu())


# ---------------------------------- IVF: K9a, K9b, K10, K11, corr / rowadd


def _selection(dev, n_tiles, t, seed):
    """A permuted, non-contiguous list of t tile ids out of n_tiles."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return torch.randperm(n_tiles, generator=g)[:t].to(torch.int32).to(dev)


def _corr(dev, q, blocks, selection, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (blocks, q) if selection else (q, blocks)
    return torch.randn(shape, generator=g, device=dev) * 3


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("mode,k", [("exact", 10), ("exact", 600), ("approx", 20)])
@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
def test_k9_sq_indexed_equal_plain(dev, tile_n, mode, k, with_corr):
    n_valid = 20 * 2048
    a = _operands(dev, n_valid, 256, 37, seed=tile_n + k)
    sel = _selection(dev, n_valid // tile_n, 9, seed=tile_n)
    corr = _corr(dev, 37, 9 * tile_n // 512, True, seed=k) if with_corr else None
    kw = dict(distance_type=qt.DistanceType.DOT, k=k, mode=mode, tile_n=tile_n)
    name = "sq_search_indexed_" + mode
    before = sq_kernel.LAUNCHES[name]
    v, i = sq_kernel.sq_search_indexed(*a, sel, corr, **kw)
    assert sq_kernel.LAUNCHES[name] == before + 1
    pv, pi = sq_kernel.sq_search_indexed_plain(*a, sel, corr, **kw)
    torch.cuda.synchronize()
    from quantization_tpu_torch.ops.kernels.ktile import tile_rows

    rows = tile_rows(sel, tile_n)
    scores = torch.full((37, n_valid), float("-inf"), device=dev)
    scores[:, rows] = sq_kernel.sq_scores_plain(
        a[0], a[1], a[2][rows], a[3][rows], a[4], distance_type=qt.DistanceType.DOT,
        n_valid=rows.shape[0])
    if with_corr:
        scores[:, rows] += torch.repeat_interleave(corr.T, 512, dim=1)
    _check_topk(v, i, pv, scores, n_valid)
    if mode == "approx":
        assert torch.equal(i, pi)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_k1_k2_corr_equal_plain(dev, mode):
    n_valid = 9000
    a = _operands(dev, n_valid, 128, 19, seed=3)
    npad = a[2].shape[0]
    corr = _corr(dev, 19, npad // 512, False, seed=4)
    kw = dict(distance_type=qt.DistanceType.L2, n_valid=n_valid, k=30, mode=mode)
    v, i = sq_kernel.sq_search(*a, corr, **kw)
    pv, pi = sq_kernel.sq_search_plain(*a, corr, **kw)
    scores = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.L2, n_valid=npad)
    scores = (scores + torch.repeat_interleave(corr, 512, dim=1))[:, :n_valid]
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
@pytest.mark.parametrize("dim", [128, 1536])
def test_k10_bq_indexed_equal_plain(dev, tile_n, dim):
    n_valid = 16 * 2048
    qw, planes = _bq_operands(dev, n_valid, dim, 19, seed=tile_n + dim)
    sel = _selection(dev, n_valid // tile_n, 7, seed=dim)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=40, tile_n=tile_n)
    before = bq_kernel.LAUNCHES["bq_search_indexed"]
    v, i = bq_kernel.bq_search_indexed(qw, planes, sel, **kw)
    assert bq_kernel.LAUNCHES["bq_search_indexed"] == before + 1
    pv, pi = bq_kernel.bq_search_indexed_plain(qw, planes, sel, **kw)
    torch.cuda.synchronize()
    scores = bq_kernel.bq_scores_plain(qw, planes, distance_type=DistanceType.DOT,
                                       invert=False, dim=dim, n_valid=n_valid)
    _check_topk(v, i, pv, scores, n_valid)
    assert torch.equal(i, pi)


def _pq_residual(dev, q, npad, blocks, selection, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rowadd = torch.randn(npad, generator=g, device=dev) * 5
    rowadd[::97] = -3.0e38  # the pad mask rides rowadd
    return rowadd, _corr(dev, q, blocks, selection, seed + 1)


@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m,tile_n,residual", [
    (256, 96, 1024, False), (256, 96, 1024, True), (256, 32, 512, True),
    (16, 48, 1024, False), (16, 48, 1024, True), (256, 16, 256, False),
    (256, 2, 512, False), (256, 18, 1024, True), (256, 18, 128, False),
    (16, 24, 256, False)])
def test_k11_pq_indexed_equal_plain(dev, kc, m, tile_n, residual, precision):
    n_valid = 24 * 1024
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, 37, seed=m + tile_n)
    t = 7
    sel = _selection(dev, n_valid // tile_n, t, seed=m)
    rowadd, corr = (_pq_residual(dev, 37, codes_t.shape[1], t * tile_n // 512, True, seed=m)
                    if residual else (None, None))
    kw = dict(k=40, precision=precision, tile_n=tile_n)
    before = pq_kernel.LAUNCHES["pq_search_indexed"]
    v, i = pq_kernel.pq_search_indexed(lut, codes_t, sel, rowadd, corr, **kw)
    assert pq_kernel.LAUNCHES["pq_search_indexed"] == before + 1
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m", [(256, 32), (16, 48), (256, 2), (256, 18), (256, 96)])
def test_k7_pq_residual_equal_plain(dev, kc, m, precision, mode):
    n_valid = 6000
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, 37, seed=m + 1)
    npad = codes_t.shape[1]
    rowadd, corr = _pq_residual(dev, 37, npad, npad // 512, False, seed=m)
    kw = dict(n_valid=n_valid, k=30, mode=mode, precision=precision)
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision=precision)
    scores = ((scores + rowadd[None]) + torch.repeat_interleave(corr, 512, dim=1))[:, :n_valid]
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)
    if mode == "approx":
        assert torch.equal(i, pi)


@pytest.mark.parametrize("kind,residual", [("sq", False), ("sq", True), ("pq", True),
                                           ("bq", False), ("bq", True)])
def test_ivf_path_runs_through_the_kernels(dev, kind, residual):
    rng = np.random.default_rng(3)
    n, dim = 12000, 64
    centers = rng.standard_normal((24, dim)).astype(np.float32)
    data = (centers[rng.integers(0, 24, n)]
            + 0.2 * rng.standard_normal((n, dim))).astype(np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    kw = {"chunk_size": 8} if kind == "pq" else {}
    ivf = qt.IVFIndex.encode(data, params, quantizer=kind, nlist=12, bucket_size=1024,
                             nprobe=4, residual=residual, **kw)
    cpu = qt.ivf_from_numpy(*qt.ivf_to_numpy(ivf), device="cpu")
    mods = (sq_kernel, bq_kernel, pq_kernel)
    for m_ in mods:
        m_.reset_launches()
    eq, ceq = ivf.encode_query(data[:16]), cpu.encode_query(data[:16])
    for method in ("exact", "approx"):
        for scan in ("indexed", "compact"):
            if scan == "indexed" and kind != "sq" and method == "exact":
                continue
            s, i = ivf.top_k(eq, 10, method=method, scan=scan)
            assert s.shape == (16, 10) and ((i >= 0) & (i < n)).all()
            if method == "exact":
                # The same index on the CPU: the probe and the bucket term are
                # f32 products summed in another order, so values agree to
                # rounding; ids where scores are untied.
                cs, _ = cpu.top_k(ceq, 10, method=method, scan=scan)
                np.testing.assert_allclose(s, cs, rtol=1e-5, atol=1e-4)
    launched = {k: v for m_ in mods for k, v in m_.LAUNCHES.items() if v}
    want = {"sq": "sq_search_indexed_approx", "bq": "bq_search_indexed",
            "pq": "pq_search_indexed"}[kind]
    if kind == "bq" and residual:
        want = "bq_search_indexed_res"
        assert launched.get("bq_search_exact_res", 0) > 0, launched
        assert launched.get("bq_search_approx_res", 0) > 0, launched
    assert launched.get(want, 0) > 0, launched


# ------------------------------------------- K12 and the residual-BQ forms


@pytest.mark.parametrize("n_valid,d,q", [(5000, 256, 40), (1000, 1024, 1), (513, 128, 33)])
def test_k12_l1_scores_equal_plain(dev, n_valid, d, q):
    a = _operands(dev, n_valid, d, q, seed=n_valid + d)
    before = sq_kernel.LAUNCHES["sq_scores_l1"]
    got = sq_kernel.sq_scores(*a, distance_type=qt.DistanceType.L1, n_valid=n_valid)
    assert sq_kernel.LAUNCHES["sq_scores_l1"] == before + 1
    want = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.L1, n_valid=n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sq_l1_model_runs_through_k12(dev, monkeypatch):
    import quantization_tpu_torch.models.sq as sq_model

    rng = np.random.default_rng(5)
    n, dim = 5000, 200
    data = rng.random((n, dim), dtype=np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.L1, True)
    enc = qt.ScalarQuantizerU8.encode(data, params)
    cpu = qt.sq_from_numpy(*qt.sq_to_numpy(enc), device="cpu")
    queries = rng.random((9, dim), dtype=np.float32)
    eq, ceq = enc.encode_query(queries), cpu.encode_query(queries)
    sq_kernel.reset_launches()
    scores = enc.score_batch(eq)
    assert torch.equal(scores.cpu(), cpu.score_batch(ceq))
    s, _ = enc.top_k(eq, 10)
    monkeypatch.setattr(sq_model, "L1_BLOCK_ROWS", 1024)  # blocks at multiples of 512
    sb, ib = enc.top_k(eq, 10)
    np.testing.assert_array_equal(s, sb)
    np.testing.assert_array_equal(np.take_along_axis(scores.cpu().numpy(), ib, 1), sb)
    assert sq_kernel.LAUNCHES["sq_scores_l1"] == 2 + (n + 1023) // 1024
    assert sq_kernel.LAUNCHES["sq_search_exact"] == 0


def _rowadd(dev, n, g):
    """A per-row additive as residual IVF-BQ builds it: 0, and NEG on a
    random fifth of the rows (pad slots)."""
    return torch.where(torch.rand(n, generator=g, device=dev) < 0.2,
                       torch.tensor(bq_kernel.NEG, device=dev), torch.tensor(0.0, device=dev))


def _value_query(dev, npad, dim, q, per_query, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = -(-dim // 32)
    w8 = w + (-w) % 8
    planes = torch.randint(-2**31, 2**31 - 1, (w8, npad), generator=g, device=dev,
                           dtype=torch.int32)
    planes[w:] = 0
    qs = torch.randint(-127, 128, (q, w8 * 32), generator=g, device=dev, dtype=torch.int8)
    qs[:, dim:] = 0
    ab = torch.rand(q, 1, generator=g, device=dev) * 0.02 + 1e-3
    if not per_query:
        ab = ab[:1].expand(q, 1).contiguous()
    qb = -ab * qs.float().sum(1, keepdim=True)
    mult = 2.0 * (ab if per_query else ab[:1, 0])
    return planes, (qs, mult, qb), g


@pytest.mark.parametrize("per_query", [True, False])
@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("k", [1, 20, 513, 1024])
def test_k5b_value_exact_equal_plain(dev, k, with_corr, per_query):
    npad, n_valid, q, dim = 8192, 7900, 37, 200
    planes, aff, g = _value_query(dev, npad, dim, q, per_query, seed=k)
    corr = torch.randn(q, npad // 512, generator=g, device=dev) * 3 if with_corr else None
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=k,
              mode="exact", query_affine=aff,
              rowadd=_rowadd(dev, npad, g) if with_corr else None)
    before = bq_kernel.LAUNCHES["bq_search_exact_res"]
    v, i = bq_kernel.bq_search(None, planes, corr, **kw)
    assert bq_kernel.LAUNCHES["bq_search_exact_res"] == before + 1
    pv, _ = bq_kernel.bq_search_plain(None, planes, corr, **kw)
    scores = bq_kernel._plain_scores(None, planes, corr, aff, distance_type=DistanceType.DOT,
                                     invert=False, dim=dim, rowadd=kw["rowadd"])[:, :n_valid]
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("n_valid,dim", [(3000, 128), (10_000, 768), (4000, 1536)])
def test_k5a_value_approx_equal_plain(dev, n_valid, dim, with_corr):
    npad = n_valid + (-n_valid) % bq_kernel.TILE_N
    planes, aff, g = _value_query(dev, npad, dim, 33, True, seed=n_valid)
    corr = torch.randn(33, npad // 512, generator=g, device=dev) * 3 if with_corr else None
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=40,
              mode="approx", query_affine=aff,
              rowadd=_rowadd(dev, npad, g) if with_corr else None)
    v, i = bq_kernel.bq_search(None, planes, corr, **kw)
    pv, pi = bq_kernel.bq_search_plain(None, planes, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
def test_k10_value_indexed_equal_plain(dev, tile_n, with_corr):
    npad, q, dim = 16384, 37, 768
    planes, aff, g = _value_query(dev, npad, dim, q, True, seed=tile_n)
    t = 5
    sel = torch.randperm(npad // tile_n, generator=g, device=dev)[:t].to(torch.int32)
    corr = torch.randn(t * tile_n // 512, q, generator=g, device=dev) * 3 if with_corr \
        else None
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=20, tile_n=tile_n,
              query_affine=aff, rowadd=_rowadd(dev, npad, g) if with_corr else None)
    before = bq_kernel.LAUNCHES["bq_search_indexed_res"]
    v, i = bq_kernel.bq_search_indexed(None, planes, sel, corr, **kw)
    assert bq_kernel.LAUNCHES["bq_search_indexed_res"] == before + 1
    pv, pi = bq_kernel.bq_search_indexed_plain(None, planes, sel, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_pipelined_searcher_sync_is_a_barrier(dev):
    """PipelinedSearcher.sync() waits on every in-flight search's CUDA event
    (ROADMAP F3), drains nothing, and the pipelined results equal blocking
    ones in submission order."""
    rng = np.random.default_rng(11)
    n, dim = 20000, 256
    data = rng.random((n, dim), dtype=np.float32)
    enc = qt.ScalarQuantizerU8.encode(data, qt.VectorParameters(dim, n, qt.DistanceType.DOT,
                                                                False))
    batches = [rng.random((32, dim), dtype=np.float32) for _ in range(6)]
    searcher = qt.PipelinedSearcher(enc, k=10, depth=8)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for j, b in enumerate(batches):  # half on the default stream, half on a side one
        with torch.cuda.stream(side if j % 2 else torch.cuda.current_stream()):
            assert searcher.submit(b) is None
    assert searcher.in_flight == 6
    assert len({st.cuda_stream for _, _, st in searcher._pending}) == 2
    searcher.sync()
    assert searcher.in_flight == 6
    assert all(ev.query() for _, ev, _ in searcher._pending)
    for b, (s, i) in zip(batches, searcher.flush()):
        ws, wi = enc.top_k(enc.encode_query(b), 10)
        np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(i, wi)
    lazy = qt.PipelinedSearcher(enc, k=10, depth=1, materialize=False)
    s, i = lazy.search(batches[0])
    assert s.is_cuda and i.is_cuda


# ------------------------------------------- the tensor-core scan body
# The dot bodies run on wgmma tiles of 128 corpus rows x 64 (searches) or
# 128 (K3) queries. Ragged n_valid (not a multiple of 128 or 512), query
# counts on both sides of the tiles and depths of 1, 8 and 12 chunks.
MMA_QS = [1, 7, 33, 64, 65, 256, 300]
MMA_DS = [128, 1024, 1536]
MMA_N = 4100


@pytest.mark.parametrize("d", MMA_DS)
@pytest.mark.parametrize("q", MMA_QS)
def test_mma_k3_equal_plain(dev, q, d):
    a = _operands(dev, MMA_N, d, q, seed=q * 7 + d)
    got = sq_kernel.sq_scores(*a, distance_type=qt.DistanceType.DOT, n_valid=MMA_N)
    want = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.DOT, n_valid=MMA_N)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("d", MMA_DS)
@pytest.mark.parametrize("q", MMA_QS)
def test_mma_k1_k2_equal_plain(dev, q, d, mode):
    a = _operands(dev, MMA_N, d, q, seed=q * 11 + d)
    kw = dict(distance_type=qt.DistanceType.DOT, n_valid=MMA_N, k=10, mode=mode)
    v, i = sq_kernel.sq_search(*a, **kw)
    pv, pi = sq_kernel.sq_search_plain(*a, **kw)
    scores = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.DOT, n_valid=MMA_N)
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, MMA_N)
    if mode == "approx":
        assert torch.equal(i, pi)


def _first_rows_of_splits(i, k):
    """Where every score ties, each 512-row split of the exact body yields
    its first k rows (row order)."""
    live = i >= 0
    return bool(((i[live] % sq_kernel.EXACT_SPLIT) < k).all())


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("q", [1, 65, 300])
def test_mma_constant_corpus_first_row_wins(dev, q, mode):
    qcodes, qoff, codes, voff, mult = _operands(dev, MMA_N, 256, q, seed=q)
    codes[:] = codes[0]
    voff[:] = 0.5
    kw = dict(distance_type=qt.DistanceType.DOT, n_valid=MMA_N, k=20, mode=mode)
    v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, **kw)
    pv, pi = sq_kernel.sq_search_plain(qcodes, qoff, codes, voff, mult, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv)
    if mode == "approx":
        assert torch.equal(i, pi)
    else:
        assert _first_rows_of_splits(i, 20)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("dim", [128, 1000, 1536])
@pytest.mark.parametrize("q", MMA_QS)
def test_mma_value_query_with_corr_equal_plain(dev, q, dim, mode):
    npad = MMA_N + (-MMA_N) % bq_kernel.TILE_N
    planes, aff, g = _value_query(dev, npad, dim, q, True, seed=q + dim)
    corr = torch.randn(q, npad // 512, generator=g, device=dev) * 3
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=MMA_N, k=20,
              mode=mode, query_affine=aff, rowadd=_rowadd(dev, npad, g))
    v, i = bq_kernel.bq_search(None, planes, corr, **kw)
    pv, pi = bq_kernel.bq_search_plain(None, planes, corr, **kw)
    scores = bq_kernel._plain_scores(None, planes, corr, aff, distance_type=DistanceType.DOT,
                                     invert=False, dim=dim, rowadd=kw["rowadd"])[:, :MMA_N]
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, MMA_N)
    if mode == "approx":
        assert torch.equal(i, pi)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_mma_value_query_constant_planes_first_row_wins(dev, mode):
    npad = MMA_N + (-MMA_N) % bq_kernel.TILE_N
    planes, aff, g = _value_query(dev, npad, 768, 65, True, seed=5)
    planes[:] = planes[:, :1]
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=768, n_valid=MMA_N, k=20,
              mode=mode, query_affine=aff, rowadd=torch.zeros(npad, device=dev))
    v, i = bq_kernel.bq_search(None, planes, None, **kw)
    pv, pi = bq_kernel.bq_search_plain(None, planes, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv)
    if mode == "approx":
        assert torch.equal(i, pi)
    else:
        assert _first_rows_of_splits(i, 20)


@pytest.mark.parametrize("q", [1, 65, 300])
def test_mma_k10_value_indexed_equal_plain(dev, q):
    npad, dim, tile_n = 16384, 1536, 1024
    planes, aff, g = _value_query(dev, npad, dim, q, True, seed=q)
    sel = torch.randperm(npad // tile_n, generator=g, device=dev)[:6].to(torch.int32)
    corr = torch.randn(6 * tile_n // 512, q, generator=g, device=dev) * 3
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=40, tile_n=tile_n,
              query_affine=aff, rowadd=_rowadd(dev, npad, g))
    v, i = bq_kernel.bq_search_indexed(None, planes, sel, corr, **kw)
    pv, pi = bq_kernel.bq_search_indexed_plain(None, planes, sel, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


# ------------------------------------------------------------ the harness
@pytest.mark.parametrize("dt", [qt.DistanceType.DOT, qt.DistanceType.L1, qt.DistanceType.L2])
def test_native_encode_on_the_card_equals_the_device_encode(dev, dt):
    """use_native=True on an ordered pool: the host codes uploaded to the
    card equal the device encoder's, SQ within one code on under 1 % of the
    entries (ROADMAP F7), BQ planes byte-equal."""
    rng = np.random.default_rng(11)
    data = rng.random((20_000, 300), dtype=np.float32) * 3 - 1
    params = qt.VectorParameters(300, 20_000, dt, False)
    nat = qt.ScalarQuantizerU8.encode(data, params, None, None, 4096, 0, True, 4)
    ref = qt.ScalarQuantizerU8.encode(data, params)
    assert nat.codes.is_cuda and nat.codes.shape == ref.codes.shape
    diff = (nat.codes.to(torch.int16) - ref.codes.to(torch.int16)).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).double().mean()) < 0.01
    # a code one apart moves its row's offset by its term in the metric's sum
    m = ref.metadata
    a, b = nat.codes.double(), ref.codes.double()
    delta = {qt.DistanceType.DOT: (a.sum(1) - b.sum(1)) * (m.alpha * m.offset),
             qt.DistanceType.L1: torch.zeros_like(a[:, 0]),
             qt.DistanceType.L2: ((a * a).sum(1) - (b * b).sum(1)) * m.alpha * m.alpha}[dt]
    err = (nat.voffsets.double() - ref.voffsets.double() - delta).abs()
    assert bool((err <= 1e-2 + 1e-5 * ref.voffsets.double().abs()).all())
    bq_nat = qt.BinaryQuantizer.encode(data, params, batch_size=4096, use_native=True,
                                       max_threads=4)
    assert torch.equal(bq_nat.planes, qt.BinaryQuantizer.encode(data, params).planes)


@pytest.mark.parametrize("method", ["u8", "bq-u8"])
def test_cli_on_the_card_equals_its_cpu_run(dev, method):
    """The ann-benchmarks CLI at 20,000 rows: recall@10 on the card within
    0.02 of the port's CPU run on the same corpus."""
    from quantization_tpu_torch.bench import ann_benchmark

    argv = ["--dataset", "deep-image-96-angular", "--method", method, "--test-acc",
            "--synthetic-count", "20000", "--query-batch", "64"]
    card = ann_benchmark.main(argv)
    cpu = ann_benchmark.main(argv + ["--device", "cpu"])
    assert abs(card[0]["same_10"] - cpu[0]["same_10"]) <= 0.02, (card, cpu)
    assert np.isfinite(card[0]["avg_us"])


@pytest.mark.parametrize("method", ["u8", "bq-exact"])
def test_cli_sharded_on_the_card_equals_its_cpu_run(dev, method):
    """--sharded on every card (a one-shard CPU mesh with --device cpu):
    recall@10 within 0.02 of the CPU run on the same corpus."""
    from quantization_tpu_torch.bench import ann_benchmark

    argv = ["--dataset", "deep-image-96-angular", "--method", method, "--sharded",
            "--test-acc", "--synthetic-count", "20000", "--query-batch", "64"]
    card = ann_benchmark.main(argv)
    cpu = ann_benchmark.main(argv + ["--device", "cpu"])
    assert abs(card[0]["same_10"] - cpu[0]["same_10"]) <= 0.02, (card, cpu)


# --------------------------------------------------------- sharded engines
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("family", ["sq", "bq", "pq8", "pq4"])
def test_sharded_searches_equal_the_single_device_ones(dev, family, shards):
    """parallel/sharded.py on a mesh of the one card repeated: one launch
    per shard that holds rows (at 5,000 rows on 8 shards some hold none);
    exact values equal the single-device search to the bit, at k past the
    fused caps too (K3 / K6 / K8); approx values are their ids' true
    scores; ids no shard owns score -inf."""
    from quantization_tpu_torch.parallel import sharded

    g = torch.Generator(device=dev)
    g.manual_seed(shards)
    n, dim, q = 5000, 256, 33
    data = (torch.rand(n, dim, generator=g, device=dev) * 2 - 1).cpu().numpy()
    queries = (torch.rand(q, dim, generator=g, device=dev) * 2 - 1).cpu().numpy()
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    mesh = sharded.make_mesh(devices=[dev] * shards)
    if family == "sq":
        one = qt.ScalarQuantizerU8.encode(data, params)
        sh, arr, mod = sharded.ShardedScalarQuantizer.encode(data, params, mesh), "codes", sq_kernel
    elif family == "bq":
        one = qt.BinaryQuantizer.encode(data, params)
        sh, arr, mod = sharded.ShardedBinaryQuantizer.encode(data, params, mesh), "planes", bq_kernel
    else:
        one = qt.ProductQuantizer.encode(data, params, chunk_size=8 if family == "pq8" else 4,
                                         bits=8 if family == "pq8" else 4)
        sh, arr, mod = sharded.ShardedProductQuantizer(one, mesh), "codes_t", pq_kernel
    n_local = getattr(sh, arr).n_local
    live = min(shards, -(-n // n_local))
    eq = sh.encode_query(queries)
    for k in (10, 1100):  # past the fused cap a shard of > 1024 rows scores, then selects
        name = "search_exact" if min(k, n_local) <= 1024 else "scores"
        mod.reset_launches()
        got = sh.top_k_device(eq, k)
        assert mod.LAUNCHES[family[:2] + "_" + name] == live
        want = one.top_k_device(one.encode_query(queries), 10) if k == 10 else None
        if want is None:
            want = torch.topk(one.score_batch(one.encode_query(queries)), k, dim=1)
        assert torch.equal(got[0], want[0])
    v, i = sh.top_k_device(eq, 10, method="approx")
    scores = one.score_batch(one.encode_query(queries))
    assert torch.equal(torch.gather(scores, 1, i.long()), v)
    cand = torch.tensor([[0, n - 1, -1, n, live * n_local]] * q, device=dev)
    sc = sh.score_candidates(eq, cand)
    assert bool(torch.isfinite(sc[:, :2]).all()) and bool(torch.isneginf(sc[:, 2:]).all())


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("kind,residual", [("sq", False), ("sq", True), ("bq", False),
                                           ("bq", True), ("pq", False)])
def test_sharded_ivf_equals_the_single_device_index(dev, kind, residual, shards):
    """parallel/sharded_ivf.py on a mesh of the one card repeated: a probe-
    limited search launches its scan kernel once a shard; over every bucket
    the values equal the single-device search's (to the bit for a plain
    index, within rtol 1e-5 / atol 1e-4 for a residual one); the streamed
    build repeats its bucket means to the bit (one-hot sums, no atomic
    order), and its file loads into IVFIndex and searches alike."""
    from quantization_tpu_torch.parallel import sharded, sharded_ivf

    g = torch.Generator(device=dev)
    g.manual_seed(shards)
    n, dim, q, k = 6000, 128, 33, 10
    centers = torch.randn(12, dim, generator=g, device=dev) * 3
    pick = torch.randint(0, 12, (n,), generator=g, device=dev)
    data = (centers[pick] + 0.3 * torch.randn(n, dim, generator=g, device=dev)).cpu().numpy()
    queries = data[:q] + 0.01
    params = qt.VectorParameters(dim, n, qt.DistanceType.DOT, False)
    kw = dict(quantizer=kind, residual=residual, nlist=6, bucket_size=512,
              **({"chunk_size": 8, "bits": 4} if kind == "pq" else {}))
    one = qt.IVFIndex.encode(data, params, **kw)
    mesh = sharded.make_mesh(devices=[dev] * shards)
    sh = sharded_ivf.ShardedIVF(one, mesh)
    nb = one.metadata.nbuckets
    mods = (sq_kernel, bq_kernel, pq_kernel)
    for m in mods:
        m.reset_launches()
    sh.top_k_device(sh.encode_query(queries), k, nprobe=2, nscan=2)
    assert sum(v for m in mods for v in m.LAUNCHES.values()) == shards
    got = sh.top_k(sh.encode_query(queries), k, nprobe=nb, nscan=nb)
    want = one.top_k(one.encode_query(queries), k, nprobe=nb, nscan=nb)
    if residual:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got[0], want[0])
    streamed = sharded_ivf.ShardedIVF.encode(data, params, mesh=mesh, **kw)
    again = sharded_ivf.ShardedIVF.encode(data, params, mesh=mesh, **kw)
    np.testing.assert_array_equal(again.bucket_means, streamed.bucket_means)
    nb = streamed.metadata.nbuckets  # its own sample, so its own bucket count
    sv, _ = streamed.top_k(streamed.encode_query(queries), k, nprobe=nb, nscan=nb)
    with tempfile.TemporaryDirectory() as tmp:
        streamed.save(f"{tmp}/d.bin", f"{tmp}/m.json")
        back = qt.IVFIndex.load(f"{tmp}/d.bin", f"{tmp}/m.json", params)
        bv, _ = back.top_k(back.encode_query(queries), k, nprobe=nb, nscan=nb)
    np.testing.assert_allclose(bv, sv, rtol=1e-5, atol=1e-4)


def test_dryrun_takes_the_card_by_default(dev):
    """quantization_tpu_torch/dryrun.py names no device: its 8 shards lie on
    the card, and every sharded path runs there."""
    from quantization_tpu_torch import dryrun

    assert len(dryrun.dryrun_multichip(8)) == 9


def test_timed_takes_cuda_event_times(dev, monkeypatch):
    """profiling.timed times work on the card between CUDA events."""
    from quantization_tpu_torch.utils import profiling

    made = []

    class Event(torch.cuda.Event):
        def __new__(cls, *args, **kwargs):
            made.append(kwargs)
            return super().__new__(cls, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    x = torch.randn(2048, 2048, device=dev)
    dt = profiling.timed(torch.matmul, x, x, iters=5, warmup=1)
    assert made and all(kw.get("enable_timing") for kw in made)
    assert np.isfinite(dt) and 0 < dt < 1.0


@pytest.mark.parametrize("dist", ["realistic", "clustered"])
@pytest.mark.parametrize("first,n,d", [(0, 1000, 768), (10_000_000 - 300, 1200, 768),
                                       (2**24 - 7, 17, 100), (2**31 - 40, 40, 33)])
def test_row_kernel_equals_plain_threefry(dev, dist, first, n, d):
    """The 10M harness's row kernel (csrc/rowgen_kernels.cu) against its
    plain version on the card: clusters equal; rows equal but for the
    last-bit differences of the card's libm between the two (within 2 ulp);
    ragged row counts and widths. Its launches are counted."""
    from quantization_tpu_torch.bench import bench_10m, threefry

    args = bench_10m.parser().parse_args(["--d", str(d), "--dist", dist])
    rows = bench_10m.RowSource(args, dev)
    ids = torch.arange(first, first + n, device=dev)
    before = threefry.LAUNCHES["latent_rows"]
    got, gc = threefry.latent_rows(ids, rows.centers, rows.spectrum, rows.sigma, rows.base,
                                   return_clusters=True)
    assert threefry.LAUNCHES["latent_rows"] == before + 1
    want, wc = threefry.latent_rows_plain(ids, rows.centers, rows.spectrum, rows.sigma,
                                          rows.base, return_clusters=True)
    torch.cuda.synchronize()
    assert torch.equal(gc, wc)
    step = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    assert float(((got - want).abs() / step).max()) <= 2.0
    assert torch.equal(threefry.latent_rows(ids[:0], rows.centers, rows.spectrum, rows.sigma,
                                            rows.base), want[:0])


def test_row_kernel_takes_ids_past_2_31_as_their_int32_bits(dev):
    """The row kernel reads an id's low 32 bits, as its plain version does
    (the JAX harness's int32 id of the same bits); it checks no id, which
    would wait for the card."""
    from quantization_tpu_torch.bench import bench_10m, threefry

    rows = bench_10m.RowSource(bench_10m.parser().parse_args(["--d", "32"]), dev)
    ids = torch.tensor([2**31, 2**31 + 5, 2**32 - 1, 2**32 + 7], device=dev)
    got, gc = threefry.latent_rows(ids, rows.centers, None, 0.5, rows.base,
                                   return_clusters=True)
    want, wc = threefry.latent_rows_plain(ids, rows.centers, None, 0.5, rows.base,
                                          return_clusters=True)
    low, lc = threefry.latent_rows(ids[3:] - 2**32, rows.centers, None, 0.5, rows.base,
                                   return_clusters=True)
    torch.cuda.synchronize()
    assert torch.equal(gc, wc) and torch.equal(gc[3:], lc)
    step = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    assert float(((got - want).abs() / step).max()) <= 2.0
    assert torch.equal(got[3:], low)


def test_bench_10m_on_the_card_equals_its_cpu_run(dev):
    """The 10M harness at 20,000 rows on the card and on the CPU (the same
    corpus, the plain versions there): the same legs, recall@10 within
    0.02 each (ids differ only among ties and near-ties of the codecs)."""
    import contextlib
    import io
    import re

    from quantization_tpu_torch.bench import bench_10m

    flags = ["--n", "20000", "--d", "64", "--batch", "5000", "--clusters", "16", "--queries",
             "32", "--only", "sq", "--ivf", "--ivf-base", "sq", "--ivf-residual"]
    out = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert bench_10m.main(flags + ["--device", device]) == 0
        out[device] = re.findall(r"^(\S.*?)\s*: .* recall@10 vs exact = ([0-9.]+)",
                                 buf.getvalue(), re.M)
    assert [n for n, _ in out["cuda"]] == [n for n, _ in out["cpu"]]
    assert len(out["cuda"]) >= 12
    for (name, a), (_, b) in zip(out["cuda"], out["cpu"]):
        assert abs(float(a) - float(b)) <= 0.02, (name, a, b)


# ------------------------------------------ the exact select: queue and radix
# Every exact instantiation on both selects (ktile.exact_geometry: the queue
# for k <= QUEUE_K_MAX, the radix select above), on corpora that hold the
# queue's threshold to account: random scores; scores that rise with the
# row (every row beats the threshold, so buffers overflow on every segment);
# scores that fall with it (after the first segment nothing passes); rows
# repeated with a period of 700 (equal scores across every split and block
# boundary). n_valid is ragged and Q is not a multiple of the query tile;
# the shapes give the queue blocks ranges of several 512-row splits.
SELECT_KS = [1, 10, 40, 63, 64, 65, 100, 512, 513, 1024]
SELECT_KINDS = ["random", "rising", "falling", "dups"]
SELECT_STEP = 1.0e4  # row term of the monotone corpora, above every dot term


def _row_term(dev, npad, kind):
    """f32 [npad]: +-SELECT_STEP per row for the monotone corpora, else 0."""
    n = torch.arange(npad, device=dev, dtype=torch.float32) * SELECT_STEP
    return {"rising": n, "falling": -n}.get(kind, torch.zeros_like(n))


def _dup_rows(t, period=700, dim=0):
    """t with every row (along dim) a copy of row n % period."""
    idx = torch.arange(t.shape[dim], device=t.device) % period
    return t.index_select(dim, idx).contiguous()


def _select_check(v, i, pv, scores, n_valid, route_before, k):
    from quantization_tpu_torch.ops.kernels import ktile

    route = ktile.select_route(k)
    assert ktile.SELECT_LAUNCHES[route] == route_before[route] + 1
    torch.cuda.synchronize()
    _check_topk(v, i, pv, scores, n_valid)
    assert bool((i[:, :min(k, n_valid)] >= 0).all())


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", SELECT_KS)
def test_select_k1_both_routes(dev, k, kind):
    from quantization_tpu_torch.ops.kernels import ktile

    n_valid, q = 140_001, 100
    qcodes, qoff, codes, voff, mult = _operands(dev, n_valid, 128, q, seed=k)
    npad = codes.shape[0]
    if kind == "dups":
        codes, voff = _dup_rows(codes), _dup_rows(voff)
    else:
        voff = voff + _row_term(dev, npad, kind)
    a = (qcodes, qoff, codes, voff, mult)
    kw = dict(distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=k)
    _, split, _, _ = ktile.exact_geometry(k, npad, q, sq_kernel.EXACT_TQ)
    assert split > ktile.EXACT_SPLIT or k > ktile.QUEUE_K_MAX
    before = dict(ktile.SELECT_LAUNCHES)
    v, i = sq_kernel.sq_search(*a, **kw)
    pv, _ = sq_kernel.sq_search_plain(*a, **kw)
    scores = sq_kernel.sq_scores_plain(*a, distance_type=qt.DistanceType.DOT, n_valid=n_valid)
    _select_check(v, i, pv, scores, n_valid, before, k)
    if kind == "rising":
        assert torch.equal(i[:, 0], torch.full_like(i[:, 0], n_valid - 1))


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", SELECT_KS)
def test_select_k9b_with_corr_both_routes(dev, k, kind):
    from quantization_tpu_torch.ops.kernels import ktile

    tile_n, t, q = 1024, 60, 150
    n_valid = 80 * tile_n
    qcodes, qoff, codes, voff, mult = _operands(dev, n_valid, 256, q, seed=k + 1)
    if kind == "dups":
        codes, voff = _dup_rows(codes), _dup_rows(voff)
    else:
        voff = voff + _row_term(dev, n_valid, kind)
    sel = torch.arange(t, dtype=torch.int32, device=dev) + 7  # ascending: monotone compact rows
    if kind in ("random", "dups"):
        sel = _selection(dev, n_valid // tile_n, t, seed=k)
    corr = _corr(dev, q, t * tile_n // 512, True, seed=k)
    a = (qcodes, qoff, codes, voff, mult)
    kw = dict(distance_type=qt.DistanceType.DOT, k=k, mode="exact", tile_n=tile_n)
    _, split, _, _ = ktile.exact_geometry(k, t * tile_n, q, sq_kernel.EXACT_TQ)
    assert split > ktile.EXACT_SPLIT or k > ktile.QUEUE_K_MAX
    before = dict(ktile.SELECT_LAUNCHES)
    v, i = sq_kernel.sq_search_indexed(*a, sel, corr, **kw)
    pv, _ = sq_kernel.sq_search_indexed_plain(*a, sel, corr, **kw)
    rows = ktile.tile_rows(sel, tile_n)
    scores = torch.full((q, n_valid), float("-inf"), device=dev)
    scores[:, rows] = sq_kernel.sq_scores_plain(
        qcodes, qoff, codes[rows], voff[rows], mult, distance_type=qt.DistanceType.DOT,
        n_valid=rows.shape[0]) + torch.repeat_interleave(corr.T, 512, dim=1)
    _select_check(v, i, pv, scores, n_valid, before, k)


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", SELECT_KS)
def test_select_k5b_value_both_routes(dev, k, kind):
    from quantization_tpu_torch.ops.kernels import ktile

    npad, n_valid, q, dim = 40_960, 40_001, 300, 200
    planes, aff, g = _value_query(dev, npad, dim, q, True, seed=k + 2)
    if kind == "dups":
        planes = _dup_rows(planes, dim=1)
    rowadd = _row_term(dev, npad, kind)
    corr = torch.randn(q, npad // 512, generator=g, device=dev) * 3
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=k,
              mode="exact", query_affine=aff, rowadd=rowadd)
    _, split, _, _ = ktile.exact_geometry(k, npad, q, sq_kernel.EXACT_TQ)
    assert split > ktile.EXACT_SPLIT or k > ktile.QUEUE_K_MAX
    before = dict(ktile.SELECT_LAUNCHES)
    v, i = bq_kernel.bq_search(None, planes, corr, **kw)
    pv, _ = bq_kernel.bq_search_plain(None, planes, corr, **kw)
    scores = bq_kernel._plain_scores(None, planes, corr, aff, distance_type=DistanceType.DOT,
                                     invert=False, dim=dim, rowadd=rowadd)[:, :n_valid]
    _select_check(v, i, pv, scores, n_valid, before, k)


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", SELECT_KS)
def test_select_k7b_4bit_onehot_both_routes(dev, k, kind):
    from quantization_tpu_torch.ops.kernels import ktile

    m, n_valid, q = 24, 70_001, 130
    lut, codes_t = _pq4_operands(dev, m, n_valid, q, seed=k + 3)
    npad = codes_t.shape[1]
    if kind == "dups":
        codes_t = _dup_rows(codes_t, dim=1)
    rowadd = _row_term(dev, npad, kind)
    corr = _corr(dev, q, npad // 512, False, seed=k)
    kw = dict(n_valid=n_valid, k=k, precision="int8")
    _, split, _, _ = ktile.exact_geometry(k, npad, q, sq_kernel.EXACT_TQ)
    assert split > ktile.EXACT_SPLIT or k > ktile.QUEUE_K_MAX
    before = dict(ktile.SELECT_LAUNCHES)
    onehot = pq_kernel.ONEHOT_LAUNCHES["pq_search_exact"]
    v, i = pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    assert pq_kernel.ONEHOT_LAUNCHES["pq_search_exact"] == onehot + 1
    pv, _ = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, **kw)
    scores = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=npad, precision="int8")
    scores = ((scores + rowadd[None]) + torch.repeat_interleave(corr, 512, dim=1))[:, :n_valid]
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    _select_check(v, i, pv, scores, n_valid, before, k)


def _prefix_words(x, w8):
    """int32 [N, w8]: words whose first x[n] bits are set."""
    cnt = (x[:, None] - 32 * torch.arange(w8, device=x.device)[None, :]).clamp(0, 32)
    return torch.where(cnt == 32, torch.full_like(cnt, -1), (1 << cnt) - 1).to(torch.int32)


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("k", SELECT_KS)
def test_select_k5c_sign_both_routes(dev, k, kind):
    """K5c: query 0 meets a corpus whose Hamming distance to it falls
    (rising) or grows (falling) with the row, in steps of whole bits, so
    its scores are a staircase of ties; the other queries see the same rows
    at random distances."""
    from quantization_tpu_torch.ops.kernels import ktile

    n_valid, dim, q = 140_001, 256, 70
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=k + 4)
    w8 = planes.shape[0]
    if kind in ("rising", "falling"):
        n = torch.arange(n_valid, device=dev)
        x = dim - n * (dim + 1) // n_valid if kind == "rising" else n * (dim + 1) // n_valid
        planes[:, :n_valid] = (qw[0][None, :] ^ _prefix_words(x, w8)).T
    elif kind == "dups":
        planes[:, :n_valid] = _dup_rows(planes[:, :n_valid], dim=1)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid)
    _, split, _, _ = ktile.exact_geometry(k, planes.shape[1], q, bq_kernel.SIGN_QUEUE_TQ)
    assert split > ktile.EXACT_SPLIT or k > ktile.QUEUE_K_MAX
    before = dict(ktile.SELECT_LAUNCHES)
    v, i = bq_kernel.bq_search(qw, planes, k=k, **kw)
    pv, _ = bq_kernel.bq_search_plain(qw, planes, k=k, **kw)
    scores = bq_kernel.bq_scores_plain(qw, planes, **kw)
    _select_check(v, i, pv, scores, n_valid, before, k)


# ---------------------------------------------------- the int8 approx body
# approx_ws_kernel (csrc/dot_scan.cuh): K2 / K9a and the value-query K5a /
# K10, warp-specialized and persistent, 128 queries a block (64 where Q <=
# 64), span-block items in place or smaller items with the combine
# (ktile.approx_geometry); approx_parts_kernel where its query tile does not
# fit. Held to the plain approx's values and ids. The shapes of
# tests/test_torch_approx_body.py: k = 10 and 1,280, ragged n_valid, Q = 1,
# 63, 65, 257 (both query tiles), a few selected tiles, equal scores, every
# part a span allows, tiles of 8,192 rows (a span block past a byte of
# segments), and depths on both sides of the query tile's fit (CodeRows
# 128, 768, 2,048 and 4,096 bytes, PlaneRows 768 and 2,048 bits).
AB_QS = [1, 63, 65, 257]


@pytest.mark.parametrize("k", [10, 1280])
@pytest.mark.parametrize("q", AB_QS)
@pytest.mark.parametrize("n_valid,d", [(5001, 128), (100_000, 768), (9000, 2048), (3000, 4096)])
def test_approx_body_k2_equal_plain(dev, q, k, n_valid, d):
    a = _operands(dev, n_valid, d, q, seed=q + k + d)
    kw = dict(distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=k, mode="approx")
    before = sq_kernel.LAUNCHES["sq_search_approx"]
    v, i = sq_kernel.sq_search(*a, **kw)
    assert sq_kernel.LAUNCHES["sq_search_approx"] == before + 1
    pv, pi = sq_kernel.sq_search_plain(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("part", [512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("corpus", ["random", "equal"])
def test_approx_body_every_part_equal_plain(dev, monkeypatch, part, corpus):
    """Whatever part the geometry gives (8,192 is the span at 100,352 rows:
    in place), the candidates are the plain approx's; on a corpus of one
    repeated row each span block keeps its first row of every class."""
    n_valid, q = 100_000, 65
    a = _operands(dev, n_valid, 256, q, seed=part)
    if corpus == "equal":
        a[2][:n_valid] = a[2][0]
        a[3][:n_valid] = 0.5
    monkeypatch.setattr(sq_kernel, "approx_geometry", lambda *args: part)
    kw = dict(distance_type=qt.DistanceType.DOT, n_valid=n_valid, k=300, mode="approx")
    v, i = sq_kernel.sq_search(*a, **kw)
    pv, pi = sq_kernel.sq_search_plain(*a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("q", AB_QS)
@pytest.mark.parametrize("t,with_corr", [(3, False), (3, True), (301, True)])
def test_approx_body_k9a_equal_plain(dev, q, t, with_corr):
    """K9a over 3 tiles (fewer items than SMs) and 301 (a partial last span
    block), with and without corr."""
    tile_n, n_valid = 1024, 320 * 1024
    a = _operands(dev, n_valid, 768, q, seed=q + t)
    sel = _selection(dev, n_valid // tile_n, t, seed=t)
    corr = _corr(dev, q, t * tile_n // 512, True, seed=q) if with_corr else None
    kw = dict(distance_type=qt.DistanceType.DOT, k=20, mode="approx", tile_n=tile_n)
    v, i = sq_kernel.sq_search_indexed(*a, sel, corr, **kw)
    pv, pi = sq_kernel.sq_search_indexed_plain(*a, sel, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("q", [32, 256])
def test_approx_body_k9a_wide_tiles_equal_plain(dev, q):
    """K9a over 64 of 100 tiles of 8,192 rows: a span block of 32,768 rows
    would hold 256 segments, past a byte, so the geometry takes smaller
    items and the combine."""
    tile_n, n_valid = 8192, 100 * 8192
    a = _operands(dev, n_valid, 128, q, seed=q)
    sel = _selection(dev, n_valid // tile_n, 64, seed=q)
    part = ktile.approx_geometry(64 * tile_n, q, ktile.SPAN * tile_n, ktile.sm_count(dev))
    assert part < ktile.SPAN * tile_n and part // ktile.SLOT <= ktile.APPROX_MAX_SEGS
    kw = dict(distance_type=qt.DistanceType.DOT, k=50, mode="approx", tile_n=tile_n)
    v, i = sq_kernel.sq_search_indexed(*a, sel, None, **kw)
    pv, pi = sq_kernel.sq_search_indexed_plain(*a, sel, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("k", [10, 1280])
@pytest.mark.parametrize("q", AB_QS)
@pytest.mark.parametrize("dim", [768, 2048])
def test_approx_body_k10_value_equal_plain(dev, q, k, dim):
    """K10 with a value query over 40 of 64 tiles, corr in selection order
    and a rowadd that poisons a fifth of the rows."""
    npad, tile_n, t = 64 * 1024, 1024, 40
    planes, aff, g = _value_query(dev, npad, dim, q, True, seed=q + dim)
    sel = _selection(dev, npad // tile_n, t, seed=dim)
    corr = torch.randn(t * tile_n // 512, q, generator=g, device=dev) * 3
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=k, tile_n=tile_n,
              query_affine=aff, rowadd=_rowadd(dev, npad, g))
    v, i = bq_kernel.bq_search_indexed(None, planes, sel, corr, **kw)
    pv, pi = bq_kernel.bq_search_indexed_plain(None, planes, sel, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("q", AB_QS)
@pytest.mark.parametrize("dim", [768, 2048])
def test_approx_body_k5a_value_equal_plain(dev, q, dim, with_corr):
    n_valid = 30_001
    npad = n_valid + (-n_valid) % bq_kernel.TILE_N
    planes, aff, g = _value_query(dev, npad, dim, q, False, seed=q + dim)
    corr = torch.randn(q, npad // 512, generator=g, device=dev) * 3 if with_corr else None
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=40,
              mode="approx", query_affine=aff,
              rowadd=_rowadd(dev, npad, g) if with_corr else None)
    v, i = bq_kernel.bq_search(None, planes, corr, **kw)
    pv, pi = bq_kernel.bq_search_plain(None, planes, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


# ------------------------------------------------ the sign-query approx body
# bq_sign_approx_ws_kernel (csrc/bq_kernels.cu): K5a / K10 with sign queries
# on the warp-specialized walk wherever its query tile fits (the route of
# bq_kernel._sign_route), bq_sign_approx_kernel past it. Held to the plain
# approx's values and ids. The shapes of
# tests/test_torch_bq_sign_approx_body.py: dims 64, 200 and 1536 (1.5
# chunks: a partial last chunk), Q = 1, 63, 65, 129 (both query tiles), a
# ragged n_valid, both signs; 1M x 1536 at Q = 256; every part the geometry
# may give; a depth past the fit; both bodies and both query tiles on the
# same operands.
SIGN_WS_QS = [1, 63, 65, 129]
SIGN_WS_CASES = [(DistanceType.DOT, False), (DistanceType.L1, False)]  # sign +1, -1


def _sign_route(q, w8):
    return bq_kernel._sign_route(bq_kernel.load_library(), q, w8)


@pytest.mark.parametrize("dt,invert", SIGN_WS_CASES)
@pytest.mark.parametrize("dim", [64, 200, 1536])
@pytest.mark.parametrize("q", SIGN_WS_QS)
def test_sign_ws_k5a_equal_plain(dev, q, dim, dt, invert):
    n_valid = 9001
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=q * 7 + dim)
    assert _sign_route(q, planes.shape[0]) == (128 if q > 64 else 64)
    kw = dict(distance_type=dt, invert=invert, dim=dim, n_valid=n_valid, k=40, mode="approx")
    before = dict(bq_kernel.SIGN_WS_LAUNCHES)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    assert bq_kernel.SIGN_WS_LAUNCHES["bq_search_approx"] == before["bq_search_approx"] + 1
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
@pytest.mark.parametrize("dim", [200, 768])
@pytest.mark.parametrize("q", SIGN_WS_QS)
def test_sign_ws_k10_equal_plain(dev, q, dim, tile_n):
    npad = 16 * 2048
    qw, planes = _bq_operands(dev, npad, dim, q, seed=q + dim + tile_n)
    sel = _selection(dev, npad // tile_n, 7, seed=q + tile_n)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=40, tile_n=tile_n)
    before = dict(bq_kernel.SIGN_WS_LAUNCHES)
    v, i = bq_kernel.bq_search_indexed(qw, planes, sel, **kw)
    assert bq_kernel.SIGN_WS_LAUNCHES["bq_search_indexed"] == before["bq_search_indexed"] + 1
    pv, pi = bq_kernel.bq_search_indexed_plain(qw, planes, sel, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_sign_ws_k5a_at_path_2_shape_equal_plain(dev):
    """1,000,000 x 1536, Q = 256, k = 40: 245 span blocks of 4,096 rows in
    place, two query tiles."""
    n_valid, dim, q = 1_000_000, 1536, 256
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=3)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, n_valid=n_valid, k=40,
              mode="approx")
    before = dict(bq_kernel.SIGN_WS_LAUNCHES)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    assert bq_kernel.SIGN_WS_LAUNCHES["bq_search_approx"] == before["bq_search_approx"] + 1
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("part", [2048, 4096])
@pytest.mark.parametrize("corpus", ["random", "equal"])
def test_sign_ws_every_part_equal_plain(dev, monkeypatch, part, corpus):
    """Whatever part the geometry gives at 1536 dims (span blocks of 4,096
    rows in place, or 2,048-row items and the combine), the candidates are
    the plain approx's; on a corpus of one repeated row each span block
    keeps its first row of every class, and the rows past n_valid score
    NEG."""
    n_valid, q = 100_000, 65
    qw, planes = _bq_operands(dev, n_valid, 1536, q, seed=part)
    if corpus == "equal":
        planes[:, :n_valid] = planes[:, :1]
    monkeypatch.setattr(bq_kernel, "approx_geometry", lambda *args: part)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=1536, n_valid=n_valid, k=300,
              mode="approx")
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("q", [1, 65])
def test_sign_ws_past_the_fit_runs_the_two_block_body(dev, q):
    """At 4,096 bits the resident tile does not fit: bq_sign_approx_kernel
    serves (not counted on the warp-specialized body), equal to plain."""
    n_valid, dim = 7001, 4096
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=q)
    assert _sign_route(q, planes.shape[0]) == 0
    kw = dict(distance_type=DistanceType.L2, invert=True, dim=dim, n_valid=n_valid, k=40,
              mode="approx")
    before, ws = bq_kernel.LAUNCHES["bq_search_approx"], dict(bq_kernel.SIGN_WS_LAUNCHES)
    v, i = bq_kernel.bq_search(qw, planes, **kw)
    assert bq_kernel.LAUNCHES["bq_search_approx"] == before + 1
    assert bq_kernel.SIGN_WS_LAUNCHES == ws
    pv, pi = bq_kernel.bq_search_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("dim,indexed", [(200, False), (1536, False), (768, True)])
def test_sign_ws_both_bodies_give_the_same_candidates(dev, monkeypatch, dim, indexed):
    """Where both fit, the two-block body (2,048-row parts and the combine)
    and the warp-specialized one at either query tile give the same
    candidates, bit for bit."""
    n_valid, q = 20_001, 129
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=dim)
    if indexed:
        sel = _selection(dev, planes.shape[1] // 1024, 9, seed=dim)
        kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=1000, tile_n=1024)

        def run():
            return bq_kernel.bq_search_indexed(qw, planes, sel, **kw)
    else:
        kw = dict(distance_type=DistanceType.L1, invert=True, dim=dim, n_valid=n_valid,
                  k=1000, mode="approx")

        def run():
            return bq_kernel.bq_search(qw, planes, **kw)
    got = []
    for tq in (0, 64, 128):
        monkeypatch.setattr(bq_kernel, "_sign_route", lambda lib, q_, w8, tq=tq: tq)
        got.append(run())
    torch.cuda.synchronize()
    for v, i in got[1:]:
        assert torch.equal(v, got[0][0]) and torch.equal(i, got[0][1])
