"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none. The kernels' epilogue rounds like the plain version (no
fused multiply-add) and the int8 dot is exact, so scores are equal to the
bit and exact top-k values are equal; ids may differ only among tied
scores. BQ scores (K5a, K5c, K6) are exact integers, so the same holds. The PQ kernels (K7a, K7b, K8) sum their
LUT entries in their plain version's order, round each step alike, and
compute the int8 epilogue in f64 rounded once, as the plain version does."""

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qt
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops.kernels import bq_kernel, gather, pq_kernel, sq_kernel

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
    a = _operands(dev, 1000, 256, 4, seed=1)
    with pytest.raises(qt.ArgumentsError):
        sq_kernel.sq_scores(*a, distance_type=qt.DistanceType.L1, n_valid=1000)
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
    assert all(n > 0 for n in sq_kernel.LAUNCHES.values()), sq_kernel.LAUNCHES
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


@pytest.mark.parametrize("dt,invert", BQ_CASES)
@pytest.mark.parametrize("n_valid,dim,q", [(5000, 1536, 40), (2049, 100, 1), (7000, 33, 33)])
def test_k6_bq_scores_equal_plain(dev, dt, invert, n_valid, dim, q):
    qw, planes = _bq_operands(dev, n_valid, dim, q, seed=n_valid + q)
    kw = dict(distance_type=dt, invert=invert, dim=dim, n_valid=n_valid)
    before = bq_kernel.LAUNCHES["bq_scores"]
    got = bq_kernel.bq_scores(qw, planes, **kw)
    assert bq_kernel.LAUNCHES["bq_scores"] == before + 1
    want = bq_kernel.bq_scores_plain(qw, planes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    assert all(v > 0 for v in bq_kernel.LAUNCHES.values()), bq_kernel.LAUNCHES
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


PQ_SHAPES = [(256, 96, 5000, 40), (16, 192, 3000, 33), (256, 7, 2049, 1), (16, 13, 1500, 70)]
PQ_PRECISIONS = ["int8", "bf16", "bf16x2"]


@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m,n_valid,q", PQ_SHAPES)
def test_k8_pq_scores_equal_plain(dev, kc, m, n_valid, q, precision):
    lut, codes_t = _pq_operands(dev, kc, m, n_valid, q, seed=m + q)
    before = pq_kernel.LAUNCHES["pq_scores"]
    got = pq_kernel.pq_scores(lut, codes_t, n_valid=n_valid, precision=precision)
    assert pq_kernel.LAUNCHES["pq_scores"] == before + 1
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 10, 512, 513, 1024])
@pytest.mark.parametrize("precision", PQ_PRECISIONS)
@pytest.mark.parametrize("kc,m", [(256, 32), (16, 48)])
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
@pytest.mark.parametrize("kc,m,n_valid", [(256, 96, 3000), (16, 192, 9000), (256, 16, 100_000)])
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
        assert all(v > 0 for v in pq_kernel.LAUNCHES.values()), pq_kernel.LAUNCHES
        np.testing.assert_array_equal(s, torch.topk(scores, 10, dim=1).values.cpu().numpy())
        assert sa.shape == (16, 10) and ia.max() < n
        # The same state on the CPU scores the same LUT to the bit.
        cpu = qt.pq_from_numpy(*qt.pq_to_numpy(enc), device="cpu")
        cq = qt.EncodedQueryPQ(eq.lut.cpu())
        assert torch.equal(cpu.score_batch(cq), scores.cpu())
