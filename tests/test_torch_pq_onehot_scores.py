"""K8 with 4-bit codes and the int8 LUT (csrc/pq4_mma_kernels.cu
``pq4_scores_ws_kernel``), emulated on the CPU: the launch's geometry by Q,
the persistent walk over units of NB segments of a query tile (``ws_grid``),
the accumulators each consumer thread holds (``frag_col``, ``pair_row``),
their f64 epilogue into the warpgroup's two staging tiles (two boxes of
[64 queries][32 rows] f32 in the 128-byte swizzle, float2 stores), and the
tiles leaving by TMA tensor stores clipped at Q and n_valid (n_valid % 4 ==
0) or by the warps' stores, with tails in queries and rows. The kernel runs
only on the card (tests/test_torch_cuda.py -k onehot, chip_smoke.py).

Tolerances: none between the emulation and the port's plain version
(``pq_scores_plain``): the fragments are exact bytes, the products exact
integer sums, and the epilogue the plain version's f64 rounding; every
output element is written once, none past n_valid. The plain version
against the JAX package's ``pq_scores_pallas`` (int8, interpret mode): the
int8 tolerance of tests/test_torch_pq_kernels.py, 2 ulp of |score| + |bias|
(ROADMAP Queue 3, F14: the JAX epilogue rounds a fused f32 multiply-add,
the port an f64 one; the bias sums in XLA's order only for m <= 32 or a
multiple of 32)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.pq_kernel as j_kernel
from quantization_tpu_torch.ops.kernels import pq_kernel

from test_torch_pq_onehot_i8frag import SRC, _define, _setup, fragment_rows, pair_row

torch.set_num_threads(1)

# The launch's geometries (queries a block, m64 blocks a consumer
# warpgroup): 128 and 2 where Q > 64, else 64 and 4.
GEOMS = {big: tuple(int(x) for x in re.search(
    r"Q > 64 \? launch_onehot_scores_g<kForm, (\d+), (\d+)>.*?"
    r"launch_onehot_scores_g<kForm, (\d+), (\d+)>", SRC, re.S).groups()[0 if big else 2:
                                                                        2 if big else 4])
         for big in (True, False)}
BOX = _define("kOsBox")
NSM = 132  # H100 SXM


def geometry(q):
    return GEOMS[q > 64]


def frag_col(t, e):
    """dot_scan.cuh frag_col: the query (within the block's TQ) of
    accumulator element e of consumer thread t."""
    return (e >> 2) * 8 + (t & 3) * 2 + (e & 1)


def ws_grid(q, tq, n_valid, part, nsm):
    """dot_scan.cuh ws_grid: one block a SM, a multiple of the query tiles,
    at most the items."""
    nqt = -(-q // tq)
    return min(max(nsm // nqt, 1) * nqt, -(-n_valid // part) * nqt)


def thread_map(tq):
    """(query j [128, tq / 2], row r [128, tq / 2]) of a warpgroup's threads'
    accumulators: query within the block, row within the warpgroup's 64."""
    t = np.arange(128)[:, None]
    e = np.arange(tq // 2)[None, :]
    return frag_col(t, e), pair_row(t, e)


def os_at(i, r):
    """pq4_mma_kernels.cu os_at: the byte offset of (query i, row r) in a
    staging tile: box r // 32, 16-byte piece (r % 32) // 4 of the box's row
    i at piece ^ (i % 8) (the tensor map's 128-byte swizzle)."""
    return (r >> 5) * BOX + i * 128 + ((((r & 31) >> 2) ^ (i & 7)) << 4) + (r & 3) * 4


def tile_writes(tq, x):
    """The float2 stores of 64-query half x (elements 32 x .. 32 x + 31) into
    a staging tile, in the kernel's order: [(thread, i, query of the tile,
    first row, byte offset, (e, e')), ...], i < 8, two a thread and i."""
    out = []
    for t in range(128):
        r0 = pair_row(t, 0)
        for i in range(8):
            e = 32 * x + 4 * i
            jj = frag_col(t, e) - 64 * x
            out.append((t, i, jj, r0, os_at(jj, r0), (e, e + 2)))
            out.append((t, i, jj + 1, r0, os_at(jj + 1, r0), (e + 1, e + 3)))
    return out


def tensor_store(tile, row, hq0, q, n_valid):
    """The two tensor stores of a tile: box b's [64 queries][32 rows] in the
    swizzle, to out rows row + 32 b .., queries hq0 ..; elements past Q or
    n_valid are not written. {(query, first row): 32 values}."""
    words = tile.view(np.float32)
    out = {}
    for b in range(2):
        if row + 32 * b >= n_valid:
            continue
        for i in range(min(64, q - hq0)):
            vals = np.array([words[os_at(i, 32 * b + c) // 4] for c in range(32)])
            keep = min(32, n_valid - row - 32 * b)
            out[hq0 + i, row + 32 * b] = vals[:keep]
    return out


def scores_walk(lut, codes_t, n_valid, nsm=NSM):
    """[Q, n_valid] f32 as pq4_scores_ws_kernel writes it, and the number of
    writes of each element: the route's integer sums (the fragments' bytes
    against the int8 LUT, zero past Q), each block's units, each warpgroup's
    m64 blocks in order, their 64-query halves through the two staging tiles
    in turn, then out by the tile's store rule."""
    q = lut.shape[0]
    tq, nb = geometry(q)
    part = nb * 128
    lutq, scale, bias = pq_kernel.onehot_operands(lut, codes_t.shape[0])
    a = torch.from_numpy(fragment_rows(codes_t)).double()
    nqt = -(-q // tq)
    acc = np.zeros((nqt * tq, codes_t.shape[1]), np.int64)
    acc[:q] = (lutq.double() @ a.T).numpy().astype(np.int64)  # exact: |sum| < 2^53
    qi = np.minimum(np.arange(nqt * tq), q - 1)
    scale64, bias64 = scale.double().numpy()[qi], bias.double().numpy()[qi]
    out = np.zeros((q, n_valid), np.float32)
    writes = np.zeros((q, n_valid), np.int64)
    J, R = thread_map(tq)
    tma = n_valid % 4 == 0
    nitems = -(-n_valid // part) * nqt
    grid = ws_grid(q, tq, n_valid, part, nsm)
    for b in range(grid):
        q0 = (b % nqt) * tq
        tiles = np.zeros((2, 2, 2 * BOX), np.uint8)  # [warpgroup][tile] bytes
        tb = [0, 0]
        for item in range(b, nitems, grid):
            start = (item // nqt) * part
            ns = -(-min(part, n_valid - start) // 128)
            for g in range(2):
                for h in range(nb):
                    row = start + 128 * h + 64 * g
                    if h >= ns or row >= n_valid:
                        break
                    cnt = min(64, n_valid - row)
                    blk = acc[q0 + J, row + R]  # [128 threads, tq / 2]
                    sc = (scale64[q0 + J] * blk + bias64[q0 + J]).astype(np.float32)
                    for x in range(tq // 64):
                        hq0 = q0 + 64 * x
                        if hq0 >= q:
                            break
                        tile = tiles[g, tb[g]]
                        words = tile.view(np.float32)
                        mark = np.zeros(2 * BOX // 4, np.int64)
                        for t, _, _, _, off, (e0, e1) in tile_writes(tq, x):
                            words[off // 4:off // 4 + 2] = sc[t, e0], sc[t, e1]
                            mark[off // 4:off // 4 + 2] += 1
                        assert (mark == 1).all()
                        if tma:
                            for (qq, r), vals in tensor_store(tile, row, hq0, q,
                                                              n_valid).items():
                                out[qq, r:r + len(vals)] = vals
                                writes[qq, r:r + len(vals)] += 1
                        else:  # warp i % 4 stores query row i, its lanes up to cnt
                            for i in range(min(64, q - hq0)):
                                vals = [words[os_at(i, c) // 4] for c in range(cnt)]
                                out[hq0 + i, row:row + cnt] = vals
                                writes[hq0 + i, row:row + cnt] += 1
                        tb[g] ^= 1
    return out, writes


@pytest.mark.parametrize("m,n_valid,q,nsm", [
    (8, 1, 1, NSM), (13, 4097, 33, NSM), (24, 5003, 65, NSM), (13, 5000, 100, 3),
    (32, 2049, 257, 7), (192, 1100, 100, NSM), (7, 10_240, 33, 5), (16, 3000, 64, 2)])
def test_scores_walk_equals_plain(rng, m, n_valid, q, nsm):
    """The emulated kernel equals the plain version to the bit: queries past
    a 64- and 128-query tile, n_valid ragged (odd: the warps' stores; a
    multiple of 4: the tensor stores, clipped) and whole, a few SMs so that
    blocks walk several units, every element written once."""
    lut, codes_t = _setup(rng, m, n_valid, q)
    got, writes = scores_walk(lut, codes_t, n_valid, nsm)
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8").numpy()
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m,n_valid,q", [(8, 1, 1), (13, 4097, 33), (24, 5003, 65),
                                         (32, 1100, 100), (192, 2049, 257)])
def test_plain_equals_pallas(rng, m, n_valid, q):
    """The plain version against the JAX package's int8 K8 (interpret mode),
    within F14's 2 ulp of |score| + |bias|."""
    lut, codes_t = _setup(rng, m, n_valid, q)
    want = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), n_valid=n_valid,
        interpret=True, precision="int8"))
    got = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="int8").numpy()
    _, _, bias = pq_kernel.quantize_lut(lut)
    tol = 2 * np.spacing(np.abs(want) + np.abs(bias.numpy())[:, None])
    assert got.shape == want.shape and (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("tq", sorted({tq for tq, _ in GEOMS.values()}))
def test_staging_tile_stores_fill_it_without_bank_conflicts(tq):
    """Each 64-query half's float2 stores write every (query, row) of the
    tile once, 8-byte aligned, and the 16 stores of a half-warp fall on 16
    distinct 8-byte slots of the 128-byte banks (the swizzle spreads the
    lanes' four queries over pieces 2 apart, their row pairs within a
    piece and its neighbour); the warps' stores of a query row read 32
    distinct banks."""
    for x in range(tq // 64):
        seen = set()
        by_instr = {}
        for t, i, jj, r0, off, _ in tile_writes(tq, x):
            assert off % 8 == 0 and (jj, r0) not in seen
            seen.add((jj, r0))
            by_instr.setdefault((t >> 5, i, jj - frag_col(t, 32 * x + 4 * i) + 64 * x,
                                 (t & 31) >> 4), []).append(off % 128 // 8)
        assert len(seen) == 64 * 32
        assert all(len(v) == 16 and len(set(v)) == 16 for v in by_instr.values())
    for i in range(64):
        for c0 in (0, 32):
            assert len({os_at(i, c0 + lane) % 128 // 4 for lane in range(32)}) == 32


def test_kernel_claims_fit_the_sm():
    """From csrc/: OsGeom's shared memory within the 227 KB a block may take
    with at least three ring stages in either geometry; the staging tiles'
    boxes (the tensor stores' source, [64][128 B]) on 1024 bytes, as the
    128-byte swizzle needs; at most 232 registers a consumer thread hold the
    nb blocks' tq / 2 accumulators; one block of kWsThreads a SM."""
    ks, box = _define("kOhKS"), _define("kOhBox")
    tile = _define("kOsTileBytes")
    assert BOX == 64 * 32 * 4 and tile == 2 * BOX and BOX % 1024 == 0
    for tq, nb in GEOMS.values():
        stage = tq * ks + 2 * nb * box
        fixed = 4 * tile + 2 * tq * 8 + _define("kWsBarBytes")
        s = min((_define("kWsSmem") - _define("kAlign") - fixed) // stage,
                _define("kWsMaxStages"))
        assert s >= 3 and _define("kAlign") + s * stage + fixed <= 232448
        assert stage % 1024 == 0 and (s * stage) % 1024 == 0
        assert nb * tq // 2 == 128
    assert "__launch_bounds__(kWsThreads, 1) pq4_scores_ws_kernel" in SRC
    route = re.search(r"int qtt_pq4_mma_scores\(.*?\n}\n", SRC, re.S).group(0)
    assert "launch_onehot_scores<kOsFull>" in route and "NibbleRows" not in route
