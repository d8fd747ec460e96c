"""The 4-bit int8 one-hot searches with A built in registers
(csrc/pq4_mma_kernels.cu: ``OneHotI8Frag``, ``pq4_approx_ws_kernel`` for
K7a / K11, ``pq4_queue_kernel`` for K7b), emulated on the CPU: each
thread's four A registers of a k32 step from its rows' codes by the shift
rule, the 64 x 32 tiles they assemble, the rows each thread holds
(``pair_row``), and the approx kernel's walk, units of four segments shared
by two warpgroups that each keep their own classes' maxima. The kernels run
only on the card (tests/test_torch_cuda.py -k onehot, chip_smoke.py).

Tolerances: none. The fragments are exact bytes, their product with the
int8 LUT is an exact integer sum, and the walk selects the plain version's
f32 scores, so values and ids must equal the port's plain approx search,
which tests/test_torch_pq_onehot.py and tests/test_torch_pq_exact_onehot.py
hold to the JAX package."""

import pathlib
import re

import numpy as np
import pytest
import torch

from quantization_tpu_torch.ops.kernels import ktile, pq_kernel

torch.set_num_threads(1)

KC = pq_kernel.K4
SLOT = ktile.SLOT
CSRC = pathlib.Path(pq_kernel.__file__).resolve().parent.parent.parent / "csrc"
SRC = (CSRC / "pq4_mma_kernels.cu").read_text()
HEADERS = SRC + "".join((CSRC / f).read_text() for f in ("dot_scan.cuh", "ktile.cuh"))


def _define(name):
    """A constexpr int of pq4_mma_kernels.cu, dot_scan.cuh or ktile.cuh, its
    expression evaluated, the constants it names in turn."""
    expr = re.search(rf"constexpr int (?:\w+ = [^,;]+, )*{name} = ([^;,]+)[;,]",
                     HEADERS).group(1)
    for dep in set(re.findall(r"\bk[A-Z]\w*", expr)):
        expr = re.sub(rf"\b{dep}\b", str(_define(dep)), expr)
    return eval(expr, {}, {})


# The approx kernel's geometries as the launch picks them, (queries a
# block, m64 blocks a consumer warpgroup): 128 and 2 where Q > 64, else 64
# and 4; the exact kernel's queries a block and segments a pass.
GEOMS = {big: tuple(int(x) for x in re.search(
    rf"Q > 64 \?.*?launch_onehot_approx_g<kScan, (\d+), (\d+)>.*?"
    rf"launch_onehot_approx_g<kScan, (\d+), (\d+)>", SRC, re.S).groups()[0 if big else 2:
                                                                        2 if big else 4])
         for big in (True, False)}
TQ, XSEGS, KS = (_define(n) for n in ("kOhTQ", "kOxSegs", "kOhKS"))


def geometry(q):
    """(queries a block, blocks a warpgroup) of the approx launch at Q = q."""
    return GEOMS[q > 64]


def fragment(cw, t):
    """OneHotI8Frag::build for the threads of lane % 4 == t: their four
    registers (uint64 arrays, values below 2^32) from load's words cw, whose
    bytes are the codes of (row R, chunk c), (row R + 8, chunk c), (row R,
    chunk c + 1), (row R + 8, chunk c + 1). Each byte of v is (8 x - 32 t)
    mod 256, then a register is 1 << that byte, 0 from 32 on (shl.b32)."""
    cw = np.asarray(cw, np.uint64)
    bias = np.uint64(((0x80 - 32 * t) * 0x01010101) & 0xFFFFFFFF)
    v = (((cw & np.uint64(0x0F0F0F0F)) * np.uint64(8) + bias) & np.uint64(0xFFFFFFFF)) \
        ^ np.uint64(0x80808080)
    regs = []
    for i in range(4):
        n = (v >> np.uint64(8 * i)) & np.uint64(0xFF)
        regs.append(np.where(n < 32, np.uint64(1) << np.minimum(n, np.uint64(31)), 0)
                    .astype(np.uint64))
    return regs


def _bytes(reg):
    """[..., 4] u8: a register's bytes, the lower column first."""
    return np.stack([(reg >> np.uint64(8 * b)) & np.uint64(0xFF) for b in range(4)],
                    -1).astype(np.uint8)


def onehot(codes):
    """[..., 16] u8: the one-hot bytes of codes (read & 15)."""
    return (np.arange(KC) == (np.asarray(codes)[..., None] & 15)).astype(np.uint8)


def test_fragment_bytes_never_carry():
    """8 x + 128 - 32 (lane % 4) lies in [32, 248] for every code and lane,
    so the four codes' shift amounts form in one word with no carry between
    bytes, and a code outside the thread's four columns gives an amount of
    at least 32: 0 under shl.b32."""
    for t in range(4):
        for x in range(16):
            assert 32 <= 8 * x + 128 - 32 * t <= 248
            amount = (8 * x - 32 * t) % 256
            assert (amount < 32) == (x >> 2 == t)


def test_onehot_i8_fragment_values(rng):
    """The 4 threads of a quad together hold their two rows' 32 columns of a
    k32 step (registers 0 and 2 the first row's columns 4t .. 4t + 3 of
    chunks c and c + 1, registers 1 and 3 the second row's), and each row's
    16 columns of a chunk are the one-hot of its code, whatever the code's
    high nibble (every combination of four codes)."""
    low = np.arange(1 << 16, dtype=np.uint64)
    x = [(low >> np.uint64(4 * i)) & np.uint64(15) for i in range(4)]
    high = rng.integers(0, 16, (4, low.size)).astype(np.uint64) << np.uint64(4)
    cw = sum((x[i] | high[i]) << np.uint64(8 * i) for i in range(4))
    rows = [np.zeros((low.size, 2 * KC), np.uint8) for _ in range(2)]  # rows R, R + 8
    for t in range(4):
        regs = fragment(cw, t)
        for reg, row, col in ((regs[0], 0, 4 * t), (regs[1], 1, 4 * t),
                              (regs[2], 0, KC + 4 * t), (regs[3], 1, KC + 4 * t)):
            rows[row][:, col:col + 4] = _bytes(reg)
    np.testing.assert_array_equal(rows[0][:, :KC], onehot(x[0]))
    np.testing.assert_array_equal(rows[1][:, :KC], onehot(x[1]))
    np.testing.assert_array_equal(rows[0][:, KC:], onehot(x[2]))
    np.testing.assert_array_equal(rows[1][:, KC:], onehot(x[3]))


def pair_row(t, e):
    """dot_scan.cuh pair_row: the segment row of accumulator element e of
    consumer thread t (warpgroup t // 128)."""
    return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + 2 * ((t & 31) >> 2) + ((e >> 1) & 1)


def assemble(codes, chunk, cstride):
    """The A tiles of the k32 step at chunk (even) of a stage's codes
    ([chunks][rows of a warpgroup's block, cstride apart] as bytes, the
    warpgroup's 64 rows of a block at offset 0) that one warpgroup's 128
    threads build: [64 rows in pair_row order][32] u8, each thread loading
    its 16-bit pairs at src = 16 w + 2 (lane / 4) of chunks c and c + 1."""
    flat = codes.reshape(-1)
    tile = np.zeros((64, 2 * KC), np.uint8)
    for t in range(128):
        w, lane = t >> 5, t & 31
        src = 16 * w + 2 * (lane >> 2)
        lo = flat[chunk * cstride + src: chunk * cstride + src + 2]
        hi = flat[(chunk + 1) * cstride + src: (chunk + 1) * cstride + src + 2]
        cw = int(lo[0]) | int(lo[1]) << 8 | int(hi[0]) << 16 | int(hi[1]) << 24
        regs = [int(r[0]) for r in fragment([cw], lane & 3)]
        for i, reg in enumerate(regs):
            row = src + (i & 1)  # tile rows R and R + 8 are pair rows 2R and 2R + 1
            col = KC * (i >> 1) + 4 * (lane & 3)
            tile[row, col:col + 4] = _bytes(np.uint64(reg))
    return tile


@pytest.mark.parametrize("kernel", ["approx", "exact"])
def test_onehot_i8_tile_is_the_one_hot_rows(rng, kernel):
    """Every block's tile, as the threads of a warpgroup build it from a
    stage's codes (the approx kernel's code boxes [16 chunks][64 rows], the
    exact kernel's [16 chunks][2 segments][128 rows]), is the one-hot of its
    64 rows' codes in row order, for each of a stage's eight k32 steps."""
    chunks = KS // 16
    if kernel == "approx":
        nb = max(nb for _, nb in GEOMS.values())
        codes = rng.integers(0, 256, (nb, chunks, 64), dtype=np.uint8)
        blocks = [(codes[h], 64) for h in range(nb)]
        want = [codes[h].T for h in range(nb)]
    else:
        stage = rng.integers(0, 256, (chunks, XSEGS, 128), dtype=np.uint8)
        blocks, want = [], []
        for g in range(2):
            for h in range(XSEGS):
                # the warpgroup's codes start 64 g into each segment's 128
                view = stage.reshape(-1)[h * 128 + 64 * g:]
                blocks.append((view, XSEGS * 128))
                want.append(stage[:, h, 64 * g:64 * g + 64].T)
    for (codes, cstride), rows in zip(blocks, want):
        for k in range(KS // 32):
            tile = assemble(codes, 2 * k, cstride)
            expect = np.concatenate([onehot(rows[:, 2 * k]), onehot(rows[:, 2 * k + 1])], 1)
            np.testing.assert_array_equal(tile, expect)


@pytest.mark.parametrize("tq,segs", [*GEOMS.values(), (TQ, XSEGS)])
def test_onehot_i8_rows_cover_the_unit(tq, segs):
    """Consumer thread t holds, in each of a unit's segments, rows pair_row(t,
    e) against queries frag_col(e) of its tq / 2 accumulators: the 256
    threads hold every row of every segment, each row by the 4 threads of one
    quad, and every (query, class) by exactly one thread, the same thread in
    every segment, so its maxima need no other thread."""
    holder = {}
    for seg in range(segs):
        rows = {}
        for t in range(256):
            for e in range(tq // 2):
                row = pair_row(t, e)
                rows.setdefault(row, set()).add(t)
                query = (e >> 2) * 8 + (t & 3) * 2 + (e & 1)
                assert holder.setdefault((query, row), t) == t
        assert sorted(rows) == list(range(128))
        assert all(len(ts) == 4 for ts in rows.values())
    assert len(holder) == tq * 128


def _setup(rng, m, n_valid, q, ties=False):
    """A seeded LUT f32 [Q, m, 16] and codes u8 [Mpad, Npad] with random high
    nibbles past the code (the kernels read & 15), zero past m and n_valid.
    ``ties``: entries drawn from four values, so many rows score alike."""
    if ties:
        lut = rng.integers(-2, 2, (q, m, KC)).astype(np.float32)
    else:
        lut = (rng.standard_normal((q, m, KC)) * 2.0
               + rng.standard_normal((q, m, 1))).astype(np.float32)
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = np.zeros((mpad, npad), np.uint8)
    codes_t[:m, :n_valid] = rng.integers(0, 256, (m, n_valid))
    return torch.from_numpy(lut), torch.from_numpy(codes_t)


def fragment_rows(codes_t):
    """[Npad, Mpad * 16] u8: every row's A bytes as the fragments build them
    (OneHotI8Frag's rule, each row's code words of two chunks at a time)."""
    ct = codes_t.numpy().astype(np.uint64)  # [Mpad, Npad]
    mpad, npad = ct.shape
    out = np.zeros((npad, mpad * KC), np.uint8)
    for c in range(0, mpad, 2):
        # one thread's word for rows n and n (the pair's other row is any
        # row: the rule treats the four bytes alike)
        cw = ct[c] | ct[c] << np.uint64(8) | ct[c + 1] << np.uint64(16) | \
            ct[c + 1] << np.uint64(24)
        for t in range(4):
            regs = fragment(cw, t)
            out[:, KC * c + 4 * t:KC * c + 4 * t + 4] = _bytes(regs[0])
            out[:, KC * (c + 1) + 4 * t:KC * (c + 1) + 4 * t + 4] = _bytes(regs[2])
    return out


def route_scores(lut, codes_t, rows, rowadd=None, corr=None, selection=False):
    """[Q, len(rows)] f32: the route at corpus rows ``rows`` in compact
    order: the int8 LUT operand against the fragments' bytes, an exact
    integer sum, f32(f64(scale) * acc + f64(bias)), + voff (rowadd or the
    -0.0 row), + corr of the row's 512-row compact block."""
    lutq, scale, bias = pq_kernel.onehot_operands(lut, codes_t.shape[0])
    a = torch.from_numpy(fragment_rows(codes_t))[rows]
    acc = lutq.long() @ a.long().T
    s = (scale.double()[:, None] * acc.double() + bias.double()[:, None]).float()
    voff = pq_kernel.onehot_voff(rowadd, codes_t.shape[1], torch.device("cpu"))
    s = s + voff[rows][None, :]
    if corr is not None:
        s = s + ktile.expand_corr(corr, selection)[:, :len(rows)]
    return s


def approx_walk(scores, n_valid, part):
    """pq4_approx_ws_kernel's pass 1 over compact scores [Q, ncomp], in the
    launch's geometry for Q (``geometry``): items of ``part`` rows; an item's
    units of NB segments, a partial last one holding the item's remaining
    segments; warpgroup g keeps the maxima of classes 64 g .. 64 g + 63 from
    -inf, a strict ">" over the unit's segments in order, the units in
    order, rows >= n_valid scoring NEG. (vals, ids) [Q, items * 128], ids
    compact rows."""
    q, ncomp = scores.shape
    _, segs = geometry(q)
    assert part % (segs * 128) == 0
    vals, ids = [], []
    for start in range(0, ncomp, part):
        ns = -(-min(part, ncomp - start) // 128)
        best = torch.full((q, SLOT), float("-inf"))
        seg = torch.full((q, SLOT), 255, dtype=torch.int64)
        for u in range(-(-ns // segs)):
            for g in range(2):
                cls = slice(64 * g, 64 * g + 64)
                for h in range(segs):
                    m = u * segs + h
                    if m >= ns:
                        break
                    c0 = start + m * 128 + 64 * g
                    sc = scores[:, c0:c0 + 64].clone()
                    sc[:, torch.arange(c0, c0 + 64) >= n_valid] = ktile.NEG
                    up = sc > best[:, cls]
                    best[:, cls] = torch.where(up, sc, best[:, cls])
                    seg[:, cls] = torch.where(up, m, seg[:, cls])
        vals.append(best)
        ids.append(torch.where(seg == 255, -1, start + seg * 128 + torch.arange(SLOT)))
    return torch.cat(vals, 1), torch.cat(ids, 1).to(torch.int32)


@pytest.mark.parametrize("m,n_valid,q,residual,ties", [
    (8, 1, 4, False, False), (13, 4097, 33, True, False), (24, 5000, 100, False, True),
    (31, 9000, 33, True, True), (192, 2049, 4, True, False), (7, 127, 100, False, False)])
def test_approx_walk_equals_plain(rng, m, n_valid, q, residual, ties):
    """K7a: the fragments' scores walked as pq4_approx_ws_kernel walks them
    (parts of SPAN * TILE_N rows in place), merged: values and ids equal the
    port's plain approx search, ties, odd m and ragged n_valid included."""
    lut, codes_t = _setup(rng, m, n_valid, q, ties)
    npad = codes_t.shape[1]
    rowadd = corr = None
    if residual:
        rowadd = torch.from_numpy(rng.standard_normal(npad).astype(np.float32) * 5)
        rowadd[::97] = -3.0e38  # the pad mask rides rowadd
        corr = torch.from_numpy(rng.standard_normal((q, npad // 512)).astype(np.float32))
    scores = route_scores(lut, codes_t, torch.arange(npad), rowadd, corr)
    vals, ids = approx_walk(scores, n_valid, ktile.SPAN * pq_kernel.TILE_N)
    v, i = ktile.merge_candidates(vals, ids, 40)
    pv, pi = pq_kernel.pq_search_plain(lut, codes_t, rowadd, corr, n_valid=n_valid, k=40,
                                       mode="approx", precision="int8")
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("tile_n,t,residual", [(128, 13, False), (256, 9, False),
                                                (384, 5, False), (512, 7, True),
                                                (1024, 3, True)])
def test_indexed_walk_equals_plain(rng, tile_n, t, residual):
    """K11: the walk over a tile selection in compact order (the wrapper's
    list padded to whole 512-row splits; 384-row tiles leave a partial last
    unit), ids mapped to corpus rows: values and ids equal the plain K11."""
    m, q = 24, 33
    n = 24 * 1024 + (-(24 * 1024)) % tile_n
    lut, codes_t = _setup(rng, m, n, q)
    sel = torch.from_numpy(rng.permutation(n // tile_n)[:t].astype(np.int32))
    per = max(1, pq_kernel.EXACT_SPLIT // tile_n)
    padded = torch.cat([sel, sel[-1:].expand((-t) % per)])
    rows = ktile.tile_rows(padded, tile_n)
    rowadd = corr = None
    if residual:
        rowadd = torch.from_numpy(rng.standard_normal(codes_t.shape[1]).astype(np.float32))
        corr = torch.from_numpy(rng.standard_normal((t * tile_n // 512, q)).astype(np.float32))
    scores = route_scores(lut, codes_t, rows, rowadd, corr, selection=True)
    vals, loc = approx_walk(scores, t * tile_n, ktile.SPAN * tile_n)
    ids = torch.where(loc < 0, -1, rows.to(torch.int32)[loc.long().clamp(min=0)])
    v, i = ktile.merge_candidates(vals, ids, 40)
    pv, pi = pq_kernel.pq_search_indexed_plain(lut, codes_t, sel, rowadd, corr, k=40,
                                               precision="int8", tile_n=tile_n)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_fragment_rows_are_the_nibble_rows(rng):
    """The fragments' bytes of every row equal NibbleRows' one-hot bytes, the
    A operand the radix K7b still reads."""
    from test_torch_pq_onehot import nibble_rows
    _, codes_t = _setup(rng, 40, 3000, 1)
    np.testing.assert_array_equal(fragment_rows(codes_t), nibble_rows(codes_t).numpy())


@pytest.mark.parametrize("q", [1, 4, 33, 100, 256])
@pytest.mark.parametrize("n", [1024, 100_352, 1_000_448])
def test_wrapper_geometry_fits_the_kernels(q, n):
    """The geometry the wrappers hand the kernels: the dense approx part
    (SPAN * TILE_N) and K11's (SPAN * tile_n) hold whole units of either
    geometry and a segment number in a byte; the queue route's ranges (exact_geometry) hold
    whole 256-row passes of pq4_queue_kernel; every padded depth (16 chunks
    a multiple) is whole 256-byte stages."""
    for _, segs in GEOMS.values():
        assert (ktile.SPAN * pq_kernel.TILE_N) % (segs * 128) == 0
        for tile_n in range(128, 1025, 128):
            part = ktile.SPAN * tile_n
            assert part % (segs * 128) == 0 and part // 128 <= 255
    for k in (1, 10, 40, 64):
        kk, split, _, route = ktile.exact_geometry(k, n, q, TQ)
        assert route == "queue" and split % (XSEGS * 128) == 0 and kk <= 64
    for mpad in range(16, 513, 16):
        assert (mpad * KC) % KS == 0


def oh_geom(tq, nb):
    """pq4_mma_kernels.cu OhGeom<tq, nb>: (ring stages, shared memory past
    the alignment pad), the constants parsed from csrc/: stages of the LUT
    block (tq x 256 bytes) and 2 nb code boxes of [16][64], as many as fit
    beside the maxima f32 and their segment bytes [tq / 2][256 threads],
    qm / qo f64 and corr f32 of the queries, the barriers."""
    ks, box, thr = _define("kOhKS"), _define("kOhBox"), _define("kThreads")
    stage = tq * ks + 2 * nb * box
    fixed = tq // 2 * thr * 5 + 2 * tq * 8 + 2 * tq * 4 + _define("kWsBarBytes")
    s = min((_define("kWsSmem") - _define("kAlign") - fixed) // stage, _define("kWsMaxStages"))
    return s, s * stage + fixed


def test_kernels_claims_fit_the_sm():
    """From csrc/: pq4_approx_ws_kernel's shared memory within the 227 KB a
    block may take with at least three stages in either geometry, one block
    of kWsThreads a SM on the launch's 168 registers a thread, setmaxnreg
    moving the producer warpgroup's to the two consumer warpgroups within
    that file; pq4_queue_kernel two blocks a SM at kk = 64 (232,448 bytes
    less 1,024 reserved a block), its ring of three stages holding the
    select's key tile between passes."""
    for tq, nb in GEOMS.values():
        stages, nbytes = oh_geom(tq, nb)
        assert stages >= 3 and 1024 + nbytes <= 232448
        # at most 232 registers a consumer thread: nb blocks of tq / 2 accumulators
        assert nb * tq // 2 == 128
    threads = _define("kWsThreads")
    assert "__launch_bounds__(kWsThreads, 1) pq4_approx_ws_kernel" in SRC
    launch = 65536 // threads // 8 * 8
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+)", SRC).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+)", SRC).group(1))
    assert dec % 8 == 0 and inc % 8 == 0 and 24 <= dec < launch < inc <= 256
    assert 128 * dec + (threads - 128) * inc <= threads * launch
    ring = _define("kOxRing")
    assert ring == 3 * _define("kOxStage") >= TQ * (128 + 4) * 4
    queue = TQ * (8 * 64 + 4)  # QueueSelect<64>::bytes(64)
    assert 2 * (1024 + ring + 2 * TQ * 8 + queue) <= 233472 - 2 * 1024
