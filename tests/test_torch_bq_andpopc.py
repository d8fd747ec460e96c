"""The single-bit tensor-core route of the port's BQ sign-query kernels
(K6, K5c, K5a, K10: csrc/bq_kernels.cu on the wgmma body of csrc/dot_scan.cuh),
emulated in torch on the CPU: the AND counts of
``wgmma m64n64k256 b1.b1.and.popc``, one 256-bit (8-word) depth step at a
time over the padded planes, in 128-byte chunks with no step past the
depth; the query popcount pq; the row popcount pc as BitRows counts it, in
two halves (even and odd 16-byte pieces of a chunk); and the integer
epilogue sign * (dim - 2 * (pq + pc - 2 * acc)). The kernels run only on the
card (tests/test_torch_cuda.py and chip_smoke.py hold them to the plain
versions there).

Tolerance: none. Every count is an integer and every score an integer below
2^24, exact in f32: the emulation equals the port's plain XOR + popcount
version and the JAX package's kernels (interpret mode) to the bit, and the
searches built on it equal theirs in values (exact) and in values and ids
(the approx candidates, which break ties by row order in both packages)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.bq_kernel as j_kernel
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel, ktile
from test_torch_bq_kernels import _jax_approx_candidates, _jdt, _setup, _t

torch.set_num_threads(1)

STEP_WORDS = 8     # one k256 step: 256 bits, 32 bytes
CHUNK_WORDS = 32   # one 128-byte chunk of the ring
PIECE_WORDS = 4    # one 16-byte swizzle piece
DIMS = [1, 31, 33, 100, 255, 256, 257, 768, 1536, 2048]
CONVENTIONS = [("Dot", False), ("L2", True), ("L1", False)]


def and_counts(qwords, planes):
    """int64 [Q, N]: the products' AND counts, chunk by chunk, each chunk's
    four 256-bit steps while they lie inside the W8 words."""
    w8 = planes.shape[0]
    acc = torch.zeros((qwords.shape[0], planes.shape[1]), dtype=torch.int64)
    for c0 in range(0, w8, CHUNK_WORDS):
        for s0 in range(c0, min(c0 + CHUNK_WORDS, w8), STEP_WORDS):
            for w in range(s0, s0 + STEP_WORDS):
                acc += t_bq.popcount32(qwords[:, w, None] & planes[None, w, :])
    return acc


def row_popcounts(planes):
    """int64 [N]: pc as BitRows sums it, thread half h = piece % 2 of each
    chunk, the halves added in the epilogue."""
    w = torch.arange(planes.shape[0])
    half = (w % CHUNK_WORDS) // PIECE_WORDS % 2
    counts = t_bq.popcount32(planes)
    return counts[half == 0].sum(0) + counts[half == 1].sum(0)


def emulate_scores(qwords, planes, *, distance_type, invert, dim):
    """f32 [Q, N]: the route's scores, in integers until the last step."""
    sign = bq_kernel.metric_sign(distance_type, invert)
    qo = sign * (dim - 2 * t_bq.popcount32(qwords).sum(1))
    acc = and_counts(qwords, planes)
    return (qo[:, None] + sign * (4 * acc - 2 * row_popcounts(planes)[None, :])).to(
        torch.float32)


def _case(rng, dim, n_valid=300, q=5, w_extra=0):
    qwords, planes = _setup(rng, n_valid, dim, q, w_extra)
    return _t(qwords), _t(planes), qwords, planes


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", DIMS)
def test_andpopc_scores_equal_plain_to_the_bit(rng, dim, dt, invert):
    tq, tp, _, _ = _case(rng, dim, w_extra=8 if dim == 100 else 0)
    kw = dict(distance_type=DistanceType.from_json(dt), invert=invert, dim=dim)
    got = emulate_scores(tq, tp, **kw)
    want = t_bq.score_batch(tq, tp, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", DIMS)
def test_andpopc_scores_equal_pallas(rng, dim, dt, invert):
    """Against the JAX package's bq_scores_mxu (the +-1 int8 identity on the
    MXU, interpret mode)."""
    n_valid = 300
    tq, tp, qwords, planes = _case(rng, dim, n_valid)
    want = np.asarray(j_kernel.bq_scores_mxu(
        jnp.asarray(qwords), jnp.asarray(planes), distance_type=_jdt(dt), invert=invert,
        dim=dim, n_valid=n_valid, interpret=True))
    got = emulate_scores(tq, tp, distance_type=DistanceType.from_json(dt), invert=invert,
                         dim=dim)[:, :n_valid]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", DIMS)
def test_andpopc_scores_equal_bq_scores_pallas(rng, dim, dt, invert):
    """Against the JAX package's other K6 entry point, bq_scores_pallas
    (XOR + popcount on the VPU, interpret mode), with more plane words than
    the query's true words."""
    n_valid = 300
    tq, tp, qwords, planes = _case(rng, dim, n_valid, w_extra=8)
    want = np.asarray(j_kernel.bq_scores_pallas(
        jnp.asarray(qwords), jnp.asarray(planes), distance_type=_jdt(dt), invert=invert,
        dim=dim, n_valid=n_valid, interpret=True))
    got = emulate_scores(tq, tp, distance_type=DistanceType.from_json(dt), invert=invert,
                         dim=dim)[:, :n_valid]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", [33, 257, 1536])
def test_andpopc_searches_equal_pallas(rng, dim, dt, invert):
    """The exact top-k of the route's scores has bq_search_mxu's exact
    values; their approx candidates (stride-class maxima over SPAN tiles,
    rows >= n_valid NEG) are the JAX approx kernel's, values and ids."""
    n_valid, k = 2500, 20
    tq, tp, qwords, planes = _case(rng, dim, n_valid)
    kw = dict(distance_type=_jdt(dt), invert=invert, dim=dim, n_valid=n_valid, k=k)
    scores = emulate_scores(tq, tp, distance_type=DistanceType.from_json(dt), invert=invert,
                            dim=dim)
    ws, _ = j_kernel.bq_search_mxu(jnp.asarray(qwords), jnp.asarray(planes), mode="exact",
                                   interpret=True, **kw)
    np.testing.assert_array_equal(torch.topk(scores[:, :n_valid], k).values.numpy(),
                                  np.asarray(ws))
    scores[:, n_valid:] = ktile.NEG
    tile_n = bq_kernel.mxu_tile_n(tp.shape[0] * 32, tp.shape[1])
    tv, ti = ktile.approx_candidates(scores, tile_n)
    jv, ji = _jax_approx_candidates(qwords, planes, **kw)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_bitrows_pieces_cover_each_word_of_a_chunk_once():
    """BitRows: thread t moves pieces t // 128 + 2i, i < 4, of row t % 128,
    four words each; over 256 threads that is every (row, word) of a
    128-row, 32-word chunk once, and the two halves of a row's pc are the
    even and the odd pieces."""
    seen = {}
    for t in range(256):
        r, h = t % 128, t // 128
        for i in range(4):
            c = h + 2 * i
            for j in range(PIECE_WORDS):
                seen.setdefault((r, PIECE_WORDS * c + j), []).append(h)
    assert sorted(seen) == [(r, w) for r in range(128) for w in range(CHUNK_WORDS)]
    assert all(len(hs) == 1 and hs[0] == (w // PIECE_WORDS) % 2 for (_, w), hs in seen.items())


# ------------------------------------------------- the wrappers' launches


def _buf(ptr, n, ctype, dtype):
    return torch.frombuffer((ctype * n).from_address(ptr), dtype=dtype)


class _EmulatedLib:
    """The C entry points of the sign-query kernels, computing what the
    kernels compute (emulate_scores; for the searches then each split's
    exact top-kk with the equal keys in row order, or the approx candidates
    per span block) into the wrapper's buffers, from the arguments the
    wrapper passes."""

    def __init__(self, qwords, planes, distance_type, invert):
        self.qwords, self.planes = qwords, planes
        self.kw = dict(distance_type=distance_type, invert=invert)
        self.calls = []

    def _scores(self, q, w8, rows, dim, sign):
        assert (q, w8) == tuple(self.qwords.shape)
        assert sign == bq_kernel.metric_sign(**self.kw)
        return emulate_scores(self.qwords, self.planes[:, rows], dim=dim, **self.kw)

    def qtt_bq_scores(self, qw, pl, out, q, w8, npad, n_valid, dim, sign, stream):
        self.calls.append("scores")
        assert (qw, pl) == (self.qwords.data_ptr(), self.planes.data_ptr())
        assert npad == self.planes.shape[1] and 0 < n_valid <= npad
        scores = self._scores(q, w8, torch.arange(n_valid), dim, sign)
        _buf(out, q * n_valid, ctypes.c_float, torch.float32).copy_(scores.reshape(-1))
        return 0

    def qtt_bq_search_exact(self, qw, pl, cv, ci, q, w8, npad, n_valid, dim, sign, split, kk,
                            stream):
        self.calls.append("exact")
        assert (qw, pl) == (self.qwords.data_ptr(), self.planes.data_ptr())
        assert npad == self.planes.shape[1] and npad % split == 0
        scores = self._scores(q, w8, torch.arange(npad), dim, sign)
        width = npad // split * kk
        v, i = _buf(cv, q * width, ctypes.c_float, torch.float32), _buf(
            ci, q * width, ctypes.c_int32, torch.int32)
        v, i = v.view(q, width), i.view(q, width)
        for s in range(npad // split):
            cnt = max(0, min(split, n_valid - s * split))
            take = min(kk, cnt)
            blk = scores[:, s * split: s * split + cnt]
            order = torch.sort(blk, dim=1, descending=True, stable=True).indices[:, :take]
            v[:, s * kk: s * kk + take] = torch.gather(blk, 1, order)
            i[:, s * kk: s * kk + take] = (order + s * split).to(torch.int32)
            v[:, s * kk + take: (s + 1) * kk] = ktile.NEG
            i[:, s * kk + take: (s + 1) * kk] = -1
        return 0

    def qtt_bq_sign_approx_ws_tq(self, q, w8):
        # The warp-specialized body's tile: every depth here fits it
        # (tests/test_torch_bq_sign_approx_body.py holds its layout).
        return 128 if q > 64 else 64

    def qtt_bq_search_approx(self, qw, pl, pv, pi, ov, oi, q, w8, npad, n_valid, dim, sign,
                             part, span_rows, sel, tile_n, ncomp, tq, stream):
        self.calls.append("approx" if sel is None or sel == 0 else "indexed")
        assert npad == self.planes.shape[1] and span_rows % part == 0
        if sel:
            tiles = _buf(sel, ncomp // tile_n, ctypes.c_int32, torch.int32)
            rows = ktile.tile_rows(tiles.clone(), tile_n)
        else:
            rows = torch.arange(ncomp)
        scores = self._scores(q, w8, rows, dim, sign)
        scores[:, n_valid:] = ktile.NEG
        vals, loc = ktile.approx_candidates(scores, span_rows // ktile.SPAN)
        width = vals.shape[1]
        _buf(ov, q * width, ctypes.c_float, torch.float32).copy_(vals.reshape(-1))
        _buf(oi, q * width, ctypes.c_int32, torch.int32).copy_(
            rows.to(torch.int32)[loc.long()].reshape(-1))
        return 0


@pytest.fixture
def kernel_path(monkeypatch):
    """The wrappers' kernel path on CPU tensors, their launches going to an
    _EmulatedLib (set as ``kernel_path.lib``)."""
    holder = type("Holder", (), {})()
    monkeypatch.setattr(bq_kernel, "use_kernels", lambda t: True)
    monkeypatch.setattr(bq_kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(bq_kernel, "load_library", lambda: holder.lib)
    monkeypatch.setattr(bq_kernel, "sm_count", lambda dev: 132)
    return holder


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("mode,k", [("exact", 1), ("exact", 40), ("exact", 513),
                                    ("approx", 40)])
@pytest.mark.parametrize("dim,n_valid", [(100, 3000), (1536, 5000)])
def test_search_wrappers_launch_the_route(rng, kernel_path, dim, n_valid, mode, k, dt, invert):
    """bq_search with sign queries hands the kernels Q, W8, Npad, n_valid,
    dim, the sign and the geometry that make the route's result the plain
    version's: exact values equal and ids up to ties, approx values and
    ids equal. Counted under bq_search_exact / bq_search_approx."""
    tq, tp, _, _ = _case(rng, dim, n_valid, q=7)
    dtype = DistanceType.from_json(dt)
    kernel_path.lib = _EmulatedLib(tq, tp, dtype, invert)
    kw = dict(distance_type=dtype, invert=invert, dim=dim, n_valid=n_valid, k=k, mode=mode)
    before = dict(bq_kernel.LAUNCHES)
    v, i = bq_kernel.bq_search(tq, tp, **kw)
    assert kernel_path.lib.calls == [mode]
    assert bq_kernel.LAUNCHES["bq_search_" + mode] == before["bq_search_" + mode] + 1
    pv, pi = bq_kernel.bq_search_plain(tq, tp, **kw)
    assert torch.equal(v, pv)
    if mode == "approx":
        assert torch.equal(i, pi)
    scores = t_bq.score_batch(tq, tp, distance_type=dtype, invert=invert, dim=dim)
    live = i >= 0
    assert bool((i[live] < n_valid).all())
    assert torch.equal(torch.gather(scores, 1, i.clamp(min=0).long())[live], v[live])


@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
def test_indexed_wrapper_launches_the_route(rng, kernel_path, tile_n):
    """K10 with sign queries over a permuted tile list: values and ids equal
    the plain version's, counted under bq_search_indexed."""
    tq, tp, _, _ = _case(rng, 768, 8 * 2048, q=9)
    sel = torch.from_numpy(rng.permutation(tp.shape[1] // tile_n)[:5].astype(np.int32))
    kernel_path.lib = _EmulatedLib(tq, tp, DistanceType.DOT, False)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=768, k=40, tile_n=tile_n)
    before = bq_kernel.LAUNCHES["bq_search_indexed"]
    v, i = bq_kernel.bq_search_indexed(tq, tp, sel, **kw)
    assert kernel_path.lib.calls == ["indexed"]
    assert bq_kernel.LAUNCHES["bq_search_indexed"] == before + 1
    pv, pi = bq_kernel.bq_search_indexed_plain(tq, tp, sel, **kw)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_search_wrappers_refuse_unaligned_query_words(rng, kernel_path):
    """The products copy query words in 16-byte pieces: a view that starts
    off a 16-byte boundary is refused, not read."""
    tq, tp, _, _ = _case(rng, 256, 3000, q=4)
    kernel_path.lib = _EmulatedLib(tq, tp, DistanceType.DOT, False)
    flat = torch.zeros(tq.numel() + 1, dtype=torch.int32)
    odd = flat[1:].view(tq.shape)
    odd.copy_(tq)
    with pytest.raises(Exception, match="aligned"):
        bq_kernel.bq_search(odd, tp, distance_type=DistanceType.DOT, invert=False, dim=256,
                            n_valid=3000, k=5)


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", [33, 100, 1536])
def test_scores_wrapper_launches_the_route(rng, kernel_path, dim, dt, invert):
    """bq_scores hands K6 Q, W8 (here 8 words more than the true ones),
    Npad, a ragged n_valid (neither a multiple of 4 nor of a 128-row
    segment), dim and the sign that make the route's scores the plain
    version's to the bit, the sign of a zero score included (+0.0, as
    plain's; torch.equal would take -0.0 for it). Counted once under
    bq_scores."""
    n_valid = 2501
    tq, tp, _, _ = _case(rng, dim, n_valid, q=7, w_extra=8)
    dtype = DistanceType.from_json(dt)
    kernel_path.lib = _EmulatedLib(tq, tp, dtype, invert)
    kw = dict(distance_type=dtype, invert=invert, dim=dim, n_valid=n_valid)
    before = bq_kernel.LAUNCHES["bq_scores"]
    got = bq_kernel.bq_scores(tq, tp, **kw)
    assert kernel_path.lib.calls == ["scores"]
    assert bq_kernel.LAUNCHES["bq_scores"] == before + 1
    want = bq_kernel.bq_scores_plain(tq, tp, **kw)
    assert got.shape == (7, n_valid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    if dim % 2 == 0:
        assert bool((want == 0).any()), "a zero score to hold the sign of"


def test_scores_wrapper_refuses_unaligned_query_words(rng, kernel_path):
    """K6's products copy query words in 16-byte pieces, as the searches'
    do: a view that starts off a 16-byte boundary is refused, not read."""
    tq, tp, _, _ = _case(rng, 256, 3000, q=4)
    kernel_path.lib = _EmulatedLib(tq, tp, DistanceType.DOT, False)
    flat = torch.zeros(tq.numel() + 1, dtype=torch.int32)
    odd = flat[1:].view(tq.shape)
    odd.copy_(tq)
    with pytest.raises(Exception, match="aligned"):
        bq_kernel.bq_scores(odd, tp, distance_type=DistanceType.DOT, invert=False, dim=256,
                            n_valid=3000)
    assert kernel_path.lib.calls == []
