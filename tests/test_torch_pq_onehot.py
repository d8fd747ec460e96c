"""The one-hot route of the port's 4-bit, int8-LUT PQ kernels (K8, K7a, K7b
and K11 on the tensor-core scan body, csrc/pq4_mma_kernels.cu), emulated
in torch on the CPU: the LUT operand the wrapper builds, the one-hot bytes
the NibbleRows row source writes, their integer product and the f64 epilogue
rounded once. The kernel itself runs only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold it to the plain version there).

Tolerances, with their causes:
  * emulation vs the port's plain version: none, to the bit. Both sum the
    same int8 entries exactly and round scale * acc + bias once, in f64.
  * emulation vs the JAX package's Pallas kernel (interpret mode): 2 ulp of
    |score| + |bias|, the int8 tolerance of tests/test_torch_pq_kernels.py:
    the bias is summed in an order that matches XLA's only for m <= 32 or m
    a multiple of 32 (ROADMAP Queue 3, F14).
  * approx search: values and ids equal; one geometry and one tie rule.
The exact and indexed searches' emulation is in
tests/test_torch_pq_exact_onehot.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.pq_kernel as j_kernel
from quantization_tpu_torch.ops.kernels import ktile, pq_kernel

torch.set_num_threads(1)

KC = pq_kernel.K4


def _setup(rng, m, n_valid, q):
    """A seeded LUT f32 [Q, m, 16] and codes u8 [Mpad, Npad] whose valid
    codes carry a random high nibble (the kernels read ``& 15``), zero past m
    and n_valid."""
    lut = (rng.standard_normal((q, m, KC)) * 2.0 + rng.standard_normal((q, m, 1))).astype(
        np.float32)
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = np.zeros((mpad, npad), np.uint8)
    codes_t[:m, :n_valid] = rng.integers(0, 256, (m, n_valid))
    return torch.from_numpy(lut), torch.from_numpy(codes_t)


def nibble_rows(codes_t):
    """[Npad, Mpad * 16] u8: the A tile rows NibbleRows writes. Word w of the
    piece of chunk c, row n is 1 << 8 * (code & 3) where w == code >> 2
    (code = codes_t[c, n] & 15), stored little-endian."""
    code = codes_t.T.long() & 15  # [Npad, Mpad]
    words = torch.where((code >> 2)[..., None] == torch.arange(4),
                        (1 << (8 * (code & 3)))[..., None], 0)
    pieces = torch.stack([(words >> (8 * b)) & 0xFF for b in range(4)], dim=-1)
    return pieces.reshape(code.shape[0], -1).to(torch.uint8)


def onehot_scores(lut, codes_t, n_valid):
    """[Q, n_valid] f32: the route's product, the int8 LUT operand against
    the one-hot rows as an int64 matmul, then f32(f64(scale) * acc +
    f64(bias))."""
    lutq, scale, bias = pq_kernel.onehot_operands(lut, codes_t.shape[0])
    acc = lutq.long() @ nibble_rows(codes_t)[:n_valid].long().T
    return (scale.double()[:, None] * acc.double() + bias.double()[:, None]).float()


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("n_valid", [1, 1100, 2049])
@pytest.mark.parametrize("q", [1, 37, 300])
@pytest.mark.parametrize("m", [8, 24, 192])
def test_onehot_product_equals_plain_to_the_bit(rng, m, q, n_valid):
    lut, codes_t = _setup(rng, m, n_valid, q)
    got = onehot_scores(lut, codes_t, n_valid)
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8")
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m", [8, 24, 192])
def test_onehot_product_equals_pallas(rng, m):
    q, n_valid = 37, 1100
    lut, codes_t = _setup(rng, m, n_valid, q)
    want = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), n_valid=n_valid,
        interpret=True, precision="int8"))
    got = onehot_scores(lut, codes_t, n_valid).numpy()
    _, _, bias = pq_kernel.quantize_lut(lut)
    tol = 2 * np.spacing(np.abs(want) + np.abs(bias.numpy())[:, None])
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("m", [8, 40, 192])
def test_onehot_lut_operand_is_the_jax_lut_flat(rng, m):
    """[Q, Mpad * 16] int8, zero past m: the JAX package's int8 operand
    (``_quantize_lut``'s lut_flat) to the bit, with its scale."""
    q = 5
    lut, codes_t = _setup(rng, m, 10, q)
    mpad = codes_t.shape[0]
    lutq, scale, _ = pq_kernel.onehot_operands(lut, mpad)
    jq, js, _ = (np.asarray(a) for a in j_kernel._quantize_lut(jnp.asarray(lut.numpy()),
                                                                 mpad, q))
    assert lutq.dtype == torch.int8 and tuple(lutq.shape) == (q, mpad * KC)
    assert lutq.is_contiguous()
    np.testing.assert_array_equal(lutq.numpy(), jq)
    np.testing.assert_array_equal(scale.numpy(), js[:, 0])
    assert not bool(lutq[:, m * KC:].any())


@pytest.mark.parametrize("skew", [True, False])
def test_nibble_rows_thread_map(skew):
    """NibbleRows' map: warp w moves chunk piece w, lane l rows 4l .. 4l+3,
    row 4l + (b + l/2) % 4 at step b. Every (row, piece) of a depth chunk is
    written once, and with the skew the 8 lanes of every quarter-warp store
    to 8 distinct swizzle columns (piece ^ row % 8); in row order they would
    share two."""
    seen = set()
    for b in range(4):
        cols = {}
        for t in range(256):
            j, lane = t >> 5, t & 31
            r = 4 * lane + (((b + (lane >> 1)) & 3) if skew else b)
            seen.add((r, j))
            cols.setdefault(t >> 3, set()).add(j ^ (r & 7))
        widths = {len(c) for c in cols.values()}
        assert widths == ({8} if skew else {2})
    assert seen == {(r, j) for r in range(128) for j in range(8)}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m,n_valid,q", [(8, 1, 1), (24, 5000, 37), (192, 2049, 300)])
def test_onehot_approx_equals_plain(rng, m, n_valid, q, residual):
    """The K7a route's scores (the product, then + voff: rowadd or the zero
    row, then + corr; NEG past n_valid) in the JAX approx geometry over
    parts of SPAN * TILE_N rows: values and ids equal the plain approx."""
    lut, codes_t = _setup(rng, m, n_valid, q)
    npad = codes_t.shape[1]
    rowadd = corr = None
    if residual:
        rowadd = torch.from_numpy(rng.standard_normal(npad).astype(np.float32) * 5)
        rowadd[::97] = -3.0e38  # the pad mask rides rowadd
        corr = torch.from_numpy(rng.standard_normal((q, npad // 512)).astype(np.float32))
    voff = pq_kernel.onehot_voff(rowadd, npad, torch.device("cpu"))
    scores = onehot_scores(lut, codes_t, npad) + voff[None, :]
    if residual:
        scores = scores + ktile.expand_corr(corr, False)[:, :npad]
    scores[:, n_valid:] = ktile.NEG
    vals, ids = ktile.approx_candidates(scores, pq_kernel.TILE_N)
    assert vals.shape[1] == -(-npad // (ktile.SPAN * pq_kernel.TILE_N)) * 128
    v, i = ktile.merge_candidates(vals, ids, 40)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, n_valid=n_valid, k=40,
                                       mode="approx", precision="int8")
    assert torch.equal(v, pv) and torch.equal(i, pi)


ROUTE_CASES = [(kc, p, mode) for kc in (pq_kernel.K4, pq_kernel.K)
               for p in pq_kernel.PRECISIONS for mode in ("scores", "exact", "approx",
                                                         "indexed")]


@pytest.mark.parametrize("kc,precision,mode", ROUTE_CASES)
def test_wrappers_route_through_onehot_route(rng, monkeypatch, kc, precision, mode):
    """Which launches reach the one-hot entry points: K8, K7b, K7a and K11
    with 4-bit codes and the int8 LUT; K8 with 4-bit codes and the bf16 /
    bf16x2 LUT reaches the bf16 one-hot entry point instead; the rest the
    gather body. The wrappers run their kernel path on CPU tensors with the
    launches recorded, not run."""
    calls = []

    def gather(name, lut, codes_t, prec, n_valid, outs, *extra, fn=None):
        calls.append(("gather", name, prec))
        for o in outs:
            o.zero_()

    def onehot(name, lut, codes_t, n_valid, outs, *extra, **kw):
        calls.append(("onehot", name, extra))
        for o in outs:
            o.zero_()

    monkeypatch.setattr(pq_kernel, "use_kernels", lambda t: True)
    monkeypatch.setattr(pq_kernel, "_launch", gather)
    monkeypatch.setattr(pq_kernel, "_launch_onehot", onehot)
    monkeypatch.setattr(pq_kernel, "_launch_bf16_onehot",
                        lambda lut, codes_t, n_valid, out: calls.append(("bf16",)))
    m, n_valid, q = 24, 2000, 3
    lut = torch.from_numpy(rng.standard_normal((q, m, kc)).astype(np.float32))
    mpad, npad = m + (-m) % pq_kernel.M_BLK, n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = torch.zeros((mpad, npad), dtype=torch.uint8)
    kw = dict(precision=precision)
    if mode == "scores":
        pq_kernel.pq_scores(lut, codes_t, n_valid=n_valid, **kw)
    elif mode == "indexed":
        sel = torch.tensor([1, 0], dtype=torch.int32)
        pq_kernel.pq_search_indexed(lut, codes_t, sel, k=5, **kw)
    else:
        pq_kernel.pq_search(lut, codes_t, n_valid=n_valid, k=5, mode=mode, **kw)
    want = kc == pq_kernel.K4 and precision == "int8"
    bf16 = kc == pq_kernel.K4 and precision != "int8" and mode == "scores"
    assert len(calls) == 1 and (calls[0][0] == "onehot") == want
    assert (calls[0][0] == "bf16") == bf16
    assert pq_kernel.onehot_route(kc, precision, mode) == want


def test_onehot_approx_passes_voff_and_corr(rng, monkeypatch):
    """Without the residual pair the K7a route gets a row of -0.0 as voff
    and a null corr; with it, rowadd itself and corr's pointer and strides;
    dense, with parts of SPAN * TILE_N rows."""
    seen = []
    monkeypatch.setattr(pq_kernel, "use_kernels", lambda t: True)

    def onehot(name, lut, ct, n, outs, voff, res, **kw):
        assert kw == dict(part=ktile.SPAN * pq_kernel.TILE_N)
        seen.append((voff, *res))

    monkeypatch.setattr(pq_kernel, "_launch_onehot", onehot)
    lut, codes_t = _setup(rng, 16, 3000, 2)
    npad = codes_t.shape[1]
    kw = dict(n_valid=3000, k=5, mode="approx", precision="int8")
    pq_kernel.pq_search(lut, codes_t, **kw)
    rowadd = torch.ones(npad)
    corr = torch.ones((2, npad // 512))
    pq_kernel.pq_search(lut, codes_t, rowadd, corr, **kw)
    (voff0, *c0), (voff1, *c1) = seen
    assert tuple(voff0.shape) == (npad,) and not bool(voff0.any()) and c0 == [0, 0, 0]
    assert bool(torch.signbit(voff0).all())
    assert voff1 is rowadd
    assert c1 == [corr.data_ptr(), *ktile.corr_strides(corr, 2, False)]
