"""The sign-query BQ approx body (csrc/bq_kernels.cu bq_sign_approx_ws_kernel:
K5a and K10 with packed sign queries on the warp-specialized walk of
csrc/dot_scan.cuh) on the CPU. A block walks work items of ``part`` compact
rows (ops/kernels/ktile.py approx_geometry) and keeps, per query and stride
class l (compact rows item_start + m*128 + l), one integer key
256 t + (255 - m), t = sign * (2 acc - pc) the row's term (acc the AND
count, pc the row's popcount) or PAD_T past n_valid, as a running maximum
from NONE; the score qo + 2 t, qo = sign * (dim - 2 pq), is formed once an
item ends. Here: a plain torch model of that walk, merged, against the
port's plain approx search and the JAX package's (Pallas in interpret
mode); the layout's shared memory and registers, parsed from csrc/; the
route and the part the wrapper hands the library. The kernel runs only on
the card (tests/test_torch_cuda.py -k sign_ws, chip_smoke.py).

Tolerance: none. Keys, terms and scores are integers (scores below 2^24,
exact in f32): the model equals the port's plain approx to the bit, values
and ids, and the JAX package's in values, ids where untied (its final merge
is approx_max_k)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.pallas.bq_kernel as j_bq_kernel
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops import bq as t_bq
from quantization_tpu_torch.ops.kernels import bq_kernel, ktile
from test_torch_approx_body import combine
from test_torch_bq_kernels import _setup, _t
from test_torch_rbq_kernels import _untied_ids_equal

torch.set_num_threads(1)

CSRC = pathlib.Path(bq_kernel.__file__).resolve().parent.parent.parent / "csrc"
SLOT = ktile.SLOT
NONE = -2**31        # bq_kernels.cu kWsNone: no row yet
PAD_T = -(1 << 22)   # kWsPadT: the term of a row >= n_valid
CONVENTIONS = [(DistanceType.DOT, False), (DistanceType.L1, False)]  # sign +1, -1


def terms(qwords, planes, distance_type, invert, dim):
    """(qo [Q], t [Q, N]) in int64 as the body forms them: qo = sign (dim -
    2 pq) once a query, t = sign (2 acc - pc) a row."""
    sign = bq_kernel.metric_sign(distance_type, invert)
    acc = sum(t_bq.popcount32(qwords[:, w, None] & planes[None, w, :]).to(torch.int64)
              for w in range(planes.shape[0]))
    pc = t_bq.popcount32(planes).to(torch.int64).sum(0)
    pq = t_bq.popcount32(qwords).to(torch.int64).sum(1)
    return sign * (dim - 2 * pq), sign * (2 * acc - pc[None, :])


def body_output(qo, t, n_valid, part):
    """The body's pass 1 as a plain loop: item p covers compact rows
    [p*part, (p+1)*part); per query and class, the running maximum of the
    keys 256 t + (255 - m) from NONE (t = PAD_T past n_valid), then the
    value qo + 2 t (NEG for PAD_T, -inf for NONE) and the row p*part + m*128
    + l (-1 for NONE). (vals, ids) [Q, items*128]."""
    q, ncomp = t.shape
    lane = torch.arange(SLOT)
    vals, ids = [], []
    for p0 in range(0, ncomp, part):
        best = torch.full((q, SLOT), NONE, dtype=torch.int64)
        for m, c0 in enumerate(range(p0, min(p0 + part, ncomp), SLOT)):
            tt = t[:, c0:c0 + SLOT].clone()
            tt[:, c0 + lane >= n_valid] = PAD_T
            key = 256 * tt + (255 - m)
            assert int(key.min()) > NONE and int(key.max()) < 2**31  # int32 keys
            best = torch.maximum(best, key)
        tb, mb = best >> 8, 255 - (best & 255)
        score = (qo[:, None] + 2 * tb).to(torch.float32)
        vals.append(torch.where(best == NONE, float("-inf"),
                                torch.where(tb == PAD_T, ktile.NEG, score)))
        ids.append(torch.where(best == NONE, -1, p0 + mb * SLOT + lane))
    return torch.cat(vals, 1), torch.cat(ids, 1).to(torch.int32)


def model_search(qo, t, n_valid, part, span, k, rows=None):
    """The wrapper's result from the model: span blocks in place where part
    is the span block, else the combine; merged exactly; ids compact rows,
    or corpus rows through ``rows``."""
    vals, ids = body_output(qo, t, n_valid, part)
    if part != span:
        vals, ids = combine(vals, ids, span // part)
    if rows is not None:
        ids = torch.where(ids >= 0, rows[ids.clamp(min=0).long()].to(torch.int32), ids)
    return ktile.merge_candidates(vals, ids, k)


def geometry_parts(span):
    """Every part approx_geometry may choose for a span block (the span
    block, and halvings down to APPROX_MIN_PART rows), and the two-block
    body's APPROX_PART."""
    parts, p = {span, bq_kernel.APPROX_PART}, span
    while p % 2 == 0 and p // 2 >= ktile.APPROX_MIN_PART and (p // 2) % SLOT == 0:
        p //= 2
        parts.add(p)
    return sorted(parts)


def test_terms_make_the_plain_scores():
    """qo + 2 t is the plain XOR + popcount score, both signs."""
    rng = np.random.default_rng(0)
    qwords, planes = _setup(rng, 300, 200, 5)
    for dt, invert in CONVENTIONS:
        qo, t = terms(_t(qwords), _t(planes), dt, invert, 200)
        want = t_bq.score_batch(_t(qwords), _t(planes), distance_type=dt, invert=invert,
                                dim=200)
        assert torch.equal((qo[:, None] + 2 * t).to(torch.float32), want)


@pytest.mark.parametrize("dt,invert", CONVENTIONS)
@pytest.mark.parametrize("dim", [64, 200, 1536])
@pytest.mark.parametrize("q", [1, 63, 65, 129])
def test_k5a_model_equals_plain(q, dim, dt, invert):
    """Dense K5a over 5,001 valid rows of 6,144 (n_valid off every segment
    and item), every part the geometry may choose, k = 10 and 300: values
    and ids equal the port's plain approx to the bit."""
    rng = np.random.default_rng([q, dim])
    n_valid = 5001
    qwords, planes = _setup(rng, n_valid, dim, q)
    tq, tp = _t(qwords), _t(planes)
    npad = tp.shape[1]
    span = ktile.SPAN * bq_kernel.mxu_tile_n(tp.shape[0] * 32, npad)
    qo, t = terms(tq, tp, dt, invert, dim)
    parts = set(geometry_parts(span))
    assert {ktile.approx_geometry(npad, q, span, s) for s in (4, 132)} <= parts
    for k in (10, 300):
        pv, pi = bq_kernel.bq_search_plain(tq, tp, distance_type=dt, invert=invert, dim=dim,
                                           n_valid=n_valid, k=k, mode="approx")
        for part in sorted(parts):
            v, i = model_search(qo, t, n_valid, part, span, k)
            assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), (part, k)
            assert torch.equal(i, pi), (part, k)


@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
@pytest.mark.parametrize("dim,q", [(200, 65), (768, 1), (1536, 129)])
def test_k10_model_equals_plain(tile_n, dim, q):
    """K10 over 5 of 8 permuted tiles (the last span block partial), every
    part: values and ids equal the port's plain indexed approx."""
    rng = np.random.default_rng([tile_n, dim])
    qwords, planes = _setup(rng, 8 * 2048, dim, q)
    tq, tp = _t(qwords), _t(planes)
    sel = torch.from_numpy(rng.permutation(tp.shape[1] // tile_n)[:5].astype(np.int32))
    rows = ktile.tile_rows(sel, tile_n)
    dt = DistanceType.L1
    qo, t = terms(tq, tp[:, rows], dt, True, dim)
    span, ncomp = ktile.SPAN * tile_n, rows.shape[0]
    pv, pi = bq_kernel.bq_search_indexed_plain(tq, tp, sel, distance_type=dt, invert=True,
                                               dim=dim, k=40, tile_n=tile_n)
    for part in geometry_parts(span):
        v, i = model_search(qo, t, ncomp, part, span, 40, rows)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), part
        assert torch.equal(i, pi), part


def test_k5a_model_equals_jax():
    """The model's dense K5a against the JAX package's bq_search_mxu(mode=
    "approx") at the geometry's part for a full card: values equal, ids
    where untied."""
    rng = np.random.default_rng(5)
    n_valid, dim, q, k = 3001, 200, 65, 20
    qwords, planes = _setup(rng, n_valid, dim, q)
    tq, tp = _t(qwords), _t(planes)
    span = ktile.SPAN * bq_kernel.mxu_tile_n(tp.shape[0] * 32, tp.shape[1])
    qo, t = terms(tq, tp, DistanceType.DOT, False, dim)
    v, i = model_search(qo, t, n_valid, ktile.approx_geometry(tp.shape[1], q, span, 132), span,
                        k)
    ws, wi = j_bq_kernel.bq_search_mxu(
        jnp.asarray(qwords), jnp.asarray(planes), distance_type=j_types.DistanceType.DOT,
        invert=False, dim=dim, n_valid=n_valid, k=k, mode="approx", interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ws))
    _untied_ids_equal(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))


def test_k10_model_equals_jax():
    """The model's K10 over 3 of 8 tiles against the JAX package's
    bq_search_indexed: values equal, ids where untied."""
    rng = np.random.default_rng(10)
    dim, q, k, tile_n = 768, 63, 20, 1024
    qwords, planes = _setup(rng, 8 * 1024, dim, q)
    tq, tp = _t(qwords), _t(planes)
    sel = np.array([6, 1, 3], np.int32)
    rows = ktile.tile_rows(torch.from_numpy(sel), tile_n)
    qo, t = terms(tq, tp[:, rows], DistanceType.DOT, False, dim)
    span = ktile.SPAN * tile_n
    v, i = model_search(qo, t, rows.shape[0],
                        ktile.approx_geometry(rows.shape[0], q, span, 132), span, k, rows)
    ws, wi = j_bq_kernel.bq_search_indexed(
        jnp.asarray(qwords), jnp.asarray(planes), jnp.asarray(sel),
        distance_type=j_types.DistanceType.DOT, invert=False, dim=dim, k=k, tile_n=tile_n,
        interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ws))
    _untied_ids_equal(v.numpy(), i.numpy(), np.asarray(ws), np.asarray(wi))


@pytest.mark.parametrize("part", [2048, 4096])
def test_equal_rows_keep_the_first_row_of_each_class(part):
    """Every valid row the same: each span block's slot l holds its first
    row of class l (the key's segment byte breaks the tie), pad rows score
    NEG from their first row, as the plain approx keeps them."""
    rng = np.random.default_rng(part)
    n_valid, dim, q = 9000, 1536, 3
    qwords, planes = _setup(rng, n_valid, dim, q)
    planes[:, :n_valid] = planes[:, :1]
    tq, tp = _t(qwords), _t(planes)
    npad, span = tp.shape[1], 4096
    qo, t = terms(tq, tp, DistanceType.DOT, False, dim)
    vals, ids = body_output(qo, t, n_valid, part)
    if part != span:
        vals, ids = combine(vals, ids, span // part)
    nb = -(-npad // span)
    want = (torch.arange(nb)[:, None] * span + torch.arange(SLOT)[None, :]).reshape(-1)
    assert torch.equal(ids, want.to(torch.int32).expand(q, -1))
    scores = t_bq.score_batch(tq, tp, distance_type=DistanceType.DOT, invert=False, dim=dim)
    scores[:, n_valid:] = ktile.NEG
    pv, pi = ktile.approx_candidates(scores, span // ktile.SPAN)
    assert torch.equal(vals, pv) and torch.equal(ids, pi)


# -------------------------------------------------------- layout and route


def _define(src, name):
    """A constexpr int of csrc/, its expression evaluated."""
    expr = re.search(rf"constexpr int (?:\w+ = [^,;]+, )*{name} = ([^;,]+)[;,]",
                     src).group(1).split("//")[0]
    return eval(expr.replace("kDK", "128"), {}, {})


DEPTHS = (1, 2, 3, 4, 6, 8)  # sign_ws_depth: the 256-bit steps a row it is built for


def sign_layout(tq, w):
    """bq_kernels.cu SignLayout(tq, w): (box slots a consumer warpgroup,
    bytes past the 1,024-byte alignment pad), the constants parsed from
    csrc/: the resident query tile of ceil(w / 32) chunks of [tq][128 B],
    R slots a warpgroup of one box (w words x kBoxRows rows of u32; as many
    as fit, to kSignRaw; none where fewer than two), qo, the barriers."""
    ds = (CSRC / "dot_scan.cuh").read_text()
    bq = (CSRC / "bq_kernels.cu").read_text()
    assert "raw = (W / 8 + 3) / 4 * TQ * kDK;" in bq and "raw_seg = W * kBoxRows * 4;" in bq
    smem, bars = _define(ds, "kWsSmem"), _define(ds, "kWsBarBytes")
    rows, rmax = _define(bq, "kBoxRows"), _define(bq, "kSignRaw")
    qbytes, box = -(-w // 32) * tq * 128, w * rows * 4
    r = min(rmax, (smem - 1024 - qbytes - tq * 4 - bars) // (2 * box))
    r = r if r >= 2 else 0
    return r, qbytes + 2 * r * box + tq * 4 + bars


def test_sign_ws_depths_and_boxes():
    """The depths the body is built for (one instantiation each, its
    fragment in registers: 1536 bits is six steps) and the box: 64 rows and
    8 more, so the 32 lanes' fragment loads (word l%4 + 8k and + 4 of rows
    l/4 and + 8) fall on 32 banks."""
    bq = (CSRC / "bq_kernels.cu").read_text()
    assert "return n == 1 || n == 2 || n == 3 || n == 4 || n == 6 || n == 8;" in bq
    rows = _define(bq, "kBoxRows")
    assert rows >= 64 + 8 and rows * 4 % 16 == 0
    for k in range(8):
        for half in (0, 4):
            for eight in (0, 8):
                assert len({(rows * (8 * k + lane % 4 + half) + lane // 4 + eight) % 32
                            for lane in range(32)}) == 32


@pytest.mark.parametrize("tq", [64, 128])
def test_sign_ws_shared_memory_fits_one_block_a_sm(tq):
    """bq_sign_approx_ws_kernel's claim, from csrc/: one block a SM within
    the 227 KB a block may take and at least two box slots a warpgroup at
    every depth it is built for (768 bits: kSignRaw; 1536: six too)."""
    ds = (CSRC / "dot_scan.cuh").read_text()
    bq = (CSRC / "bq_kernels.cu").read_text()
    assert _define(ds, "kWsSmem") == 232448
    rmax = _define(bq, "kSignRaw")
    assert rmax <= _define(ds, "kWsMaxStages") and rmax <= _define(ds, "kWsMaxRaw")
    for n in DEPTHS:
        r, nbytes = sign_layout(tq, 8 * n)
        assert r >= 2 and 1024 + nbytes <= 232448, n
    assert sign_layout(tq, 24)[0] == rmax and sign_layout(tq, 48)[0] == rmax


def test_sign_ws_keys_and_registers_fit():
    """The packed keys fit an int: every dim the body takes is below 2^22
    (|t| <= dim > PAD_T) with 512 * dim below 2^31; one block of kWsThreads
    a SM on 168 registers a thread, setmaxnreg moving the producer's to the
    consumers within that."""
    bq = (CSRC / "bq_kernels.cu").read_text()
    ds = (CSRC / "dot_scan.cuh").read_text()
    assert "constexpr int kWsPadT = -(1 << 22);" in bq and "kWsNone = INT_MIN" in bq
    widest = 8 * max(DEPTHS) * 32
    assert widest < 2**22 and 512 * widest < 2**31
    assert "__launch_bounds__(kWsThreads, 1) bq_sign_approx_ws_kernel" in bq
    threads = _define(ds, "kWsThreads")
    launch = 65536 // threads // 8 * 8
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+)", bq).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+)", bq).group(1))
    assert dec % 8 == 0 and inc % 8 == 0 and 24 <= dec < launch < inc <= 256
    assert 128 * dec + (threads - 128) * inc <= threads * launch


@pytest.mark.parametrize("nsm", [4, 132])
@pytest.mark.parametrize("q", [1, 65, 256])
@pytest.mark.parametrize("fits", [True, False])
def test_wrapper_passes_the_route_and_the_geometry(monkeypatch, nsm, q, fits):
    """bq_search (K5a) and bq_search_indexed (K10) with sign queries hand
    the library the route's query tile and, on the warp-specialized body,
    approx_geometry's part (the candidates' buffers as the parts' where it
    is the span block), else APPROX_PART and the combine's buffers; the
    merge sees [Q, blocks * 128]; SIGN_WS_LAUNCHES counts the body."""
    captured, widths = [], []

    class Lib:
        def qtt_bq_sign_approx_ws_tq(self, q_, w8):
            return (128 if q_ > 64 else 64) if fits else 0

        def qtt_bq_search_approx(self, *args):
            captured.append(args)
            return 0

    monkeypatch.setattr(bq_kernel, "use_kernels", lambda t: True)
    monkeypatch.setattr(bq_kernel, "load_library", lambda: Lib())
    monkeypatch.setattr(bq_kernel, "sm_count", lambda dev: nsm)
    monkeypatch.setattr(bq_kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(bq_kernel, "merge_candidates",
                        lambda v, i, kk: widths.append(tuple(v.shape)))
    npad, tile_n, dim = 489 * 2048, 1024, 1536  # K5a at 1M x 1536 has 489 tiles of 2048
    qwords = torch.zeros((q, 48), dtype=torch.int32)
    planes = torch.zeros((48, npad), dtype=torch.int32)
    sel = torch.arange(0, 512, 2, dtype=torch.int32)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=dim, k=40)
    before = dict(bq_kernel.SIGN_WS_LAUNCHES)
    bq_kernel.bq_search(qwords, planes, n_valid=npad - 1472, mode="approx", **kw)
    bq_kernel.bq_search_indexed(qwords, planes, sel, tile_n=tile_n, **kw)
    spans = [ktile.SPAN * bq_kernel.mxu_tile_n(dim, npad), ktile.SPAN * tile_n]
    ncomps = [npad, sel.shape[0] * tile_n]
    assert spans == [4096, 4096] and len(captured) == 2
    for args, span, ncomp, shape in zip(captured, spans, ncomps, widths):
        bufs, (part, span_rows), tq = args[2:6], args[12:14], args[17]
        assert span_rows == span and args[16] == ncomp
        assert tq == ((128 if q > 64 else 64) if fits else 0)
        want = ktile.approx_geometry(ncomp, q, span, nsm) if fits else bq_kernel.APPROX_PART
        assert part == want
        assert (bufs[0] == bufs[2] and bufs[1] == bufs[3]) == (part == span)
        assert shape == (q, -(-ncomp // span) * SLOT)
    moved = {n: bq_kernel.SIGN_WS_LAUNCHES[n] - before[n] for n in before}
    assert moved == {"bq_search_approx": int(fits), "bq_search_indexed": int(fits)}
