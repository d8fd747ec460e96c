"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none. The kernels' epilogue rounds like the plain version (no
fused multiply-add) and the int8 dot is exact, so scores are equal to the
bit and exact top-k values are equal; ids may differ only among tied
scores."""

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qt
from quantization_tpu_torch.ops.kernels import ktile, sq_kernel

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
    assert bool((v[:, n_valid:] == ktile.NEG).all())


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
    cpu = qt.ScalarQuantizerU8.encode(data, params)
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
