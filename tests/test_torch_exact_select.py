"""The exact searches' candidate layout (ops/kernels/ktile.py exact_geometry
and csrc/ktile.cuh): each kernel block returns the exact top-min(kk, rows)
of the compact rows it covers, the lower row first among equal scores,
NEG / -1 past n_valid, and merge_exact over the blocks' candidates is the
exact top-k. Here on the CPU: a plain torch model of the blocks' output,
merged, against the port's plain search and the JAX package's exact search
(Pallas in interpret mode); an emulation of the queue select's protocol
(threshold, buffer, merges) against a sort; the route and
output width the wrappers choose. The kernels themselves run only on the
card (tests/test_torch_cuda.py -k select, chip_smoke.py).

Tolerances: the model and the emulation against the port's plain search
and a sort: none (the same f32 scores, selected). Against the JAX package:
its scores' rtol 1e-6 / atol 1e-4 (tests/test_torch_sq_kernels.py: XLA may
fuse the epilogue's multiply-add), ids where the value is untied."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
from quantization_tpu.ops.pallas.sq_kernel import sq_search_pallas
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops.kernels import bq_kernel, ktile, pq_kernel, sq_kernel
from test_torch_sq_kernels import _setup, assert_topk_matches

torch.set_num_threads(1)

CSRC = pathlib.Path(sq_kernel.__file__).resolve().parent.parent.parent / "csrc"


def keys(x):
    """csrc/ktile.cuh float_to_key as int64: an order-preserving map of f32."""
    u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def blocks_output(scores, n_valid, kk, split):
    """The plain model of an exact launch's candidates: block b covers rows
    [b*split, (b+1)*split) and yields the exact top-min(kk, valid rows) by
    key, equal keys in row order, then NEG / -1. (vals, ids) [Q, nblk*kk]."""
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


def _corpus(rng, kind, n_valid, d, q):
    """SQ operands whose scores are random, rise or fall with the row, or
    repeat with a period of 700 rows (ties across split boundaries)."""
    qcodes, qoff, codes, voff = _setup(rng, n_valid, d, q)
    if kind in ("rising", "falling"):
        step = 1.0e4 if kind == "rising" else -1.0e4
        voff[:n_valid] += np.arange(n_valid, dtype=np.float32) * step
    elif kind == "dups":
        codes[:n_valid] = codes[np.arange(n_valid) % 700]
        voff[:n_valid] = voff[np.arange(n_valid) % 700]
    return qcodes, qoff, codes, voff


KINDS = ["random", "rising", "falling", "dups"]
N_VALID, DIM, NQ = 5001, 128, 3
_JAX = {}


def _case(k, kind):
    """The operands of (k, kind), made from a seed of their own, and the JAX
    package's exact search of them (once per case: the Pallas kernel runs in
    interpret mode)."""
    rng = np.random.default_rng([k, KINDS.index(kind)])
    arrs = _corpus(rng, kind, N_VALID, DIM, NQ)
    mult = rng.random(NQ, dtype=np.float32) * 1e-3 + 1e-4
    if (k, kind) not in _JAX:
        ws, wi = sq_search_pallas(
            *(jnp.asarray(a) for a in arrs), jnp.asarray(mult),
            distance_type=j_types.DistanceType.DOT, n_valid=N_VALID, k=k, interpret=True)
        _JAX[k, kind] = np.asarray(ws), np.asarray(wi)
    return arrs, mult, _JAX[k, kind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,split", [(k, s) for k in (1, 10, 64) for s in (512, 1536, 2048)]
                         + [(65, 512), (600, 512)])
def test_blocks_output_merged_equals_plain_and_jax(k, split, kind):
    """Blocks over ranges of one or several splits (the queue select's,
    where kk = k) or of one split (the radix select's, kk = min(k, 512)),
    merged: values equal the port's plain exact search to the bit (ids up
    to ties), and the JAX package's exact search within its tolerance."""
    n_valid, q = N_VALID, NQ
    arrs, mult, (ws, wi) = _case(k, kind)
    t = tuple(torch.from_numpy(a) for a in arrs) + (torch.from_numpy(mult),)
    kw = dict(distance_type=DistanceType.DOT, n_valid=n_valid, k=k)
    scores = sq_kernel.sq_scores_plain(*t, distance_type=DistanceType.DOT,
                                       n_valid=arrs[2].shape[0])
    scores[:, n_valid:] = ktile.NEG
    v, i = ktile.merge_exact(*blocks_output(scores, n_valid, min(k, 512), split), k)
    pv, pi = sq_kernel.sq_search_plain(*t, **kw)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    live = i >= 0
    assert bool((i[live] < n_valid).all())
    assert torch.equal(torch.gather(scores, 1, i.clamp(min=0).long())[live], v[live])
    assert torch.equal(live, pi >= 0)
    assert_topk_matches(v.numpy(), i.numpy(), ws, wi, scores[:, :n_valid].numpy(), n_valid)
    if kind == "rising":
        assert int(i[0, 0]) == n_valid - 1
    if kind == "falling":
        assert i[0, :min(k, n_valid)].tolist() == list(range(min(k, n_valid)))


def test_all_ties_keep_the_first_rows_of_each_block():
    """Every valid row ties: each block yields its first kk rows, so the
    merged ids lie in the first kk rows of 512-row splits (block ranges
    start on whole splits)."""
    scores = torch.full((2, 4096), 1.5)
    for split in (512, 1536):
        vals, ids = blocks_output(scores, 4000, 20, split)
        live = ids >= 0
        assert bool(((ids[live] - (ids[live] // split) * split) < 20).all())
        assert bool((ids[live] % ktile.EXACT_SPLIT < 20).all())


# ------------------------------------------------- the queue select's protocol


def emulate_queue(scores, n_valid, kk, seg=128):
    """csrc/ktile.cuh QueueSelect over one block's rows of one query: in
    each segment the rows whose key is above thr (as it stood when the
    segment began) go into the queue, each kept only while it beats the
    queue's kk-th entry as the queue then stands; thr becomes the queue's
    kk-th key once it holds kk. Returns the queue's kk (key, row) pairs,
    sorted, (0, -1) where empty."""
    k = keys(scores[:n_valid]).tolist()
    queue, thr = [], 0
    for s0 in range(0, n_valid, seg):
        for c in [(k[r], r) for r in range(s0, min(s0 + seg, n_valid)) if k[r] > thr]:
            queue = sorted(queue + [c], key=lambda x: (-x[0], x[1]))[:kk]
        thr = queue[-1][0] if len(queue) == kk else 0
    return queue + [(0, -1)] * (kk - len(queue))


@pytest.mark.parametrize("kind", ["random", "rising", "falling", "ties", "dups"])
@pytest.mark.parametrize("kk", [1, 10, 40, 63, 64])
def test_queue_protocol_equals_a_sort(kk, kind):
    """The queue's output is the block's exact top-min(kk, rows) by key,
    lower rows first among equal keys: on random scores, scores that rise
    with the row (every row passes, and thr within a segment comes from the
    segment itself), fall with it, all tie, or repeat every 700 rows."""
    gen = torch.Generator().manual_seed(kk * 7)
    n_valid = 1500
    x = torch.randn(n_valid, generator=gen)
    scores = {"random": x, "rising": torch.arange(n_valid, dtype=torch.float32),
              "falling": -torch.arange(n_valid, dtype=torch.float32),
              "ties": torch.full((n_valid,), -0.5),
              "dups": x[torch.arange(n_valid) % 700]}[kind]
    got = emulate_queue(scores, n_valid, kk)
    order = torch.sort(keys(scores), descending=True, stable=True).indices[:kk].tolist()
    want = [(int(keys(scores[r:r + 1])[0]), r) for r in order]
    assert got == want + [(0, -1)] * (kk - len(want))


def test_queue_fits_two_blocks_a_sm():
    """The queue kernels' shared memory at the largest kk leaves two blocks
    a SM (233,472 bytes less 1,024 a block): the int8 tile's ring (3 x 192 x
    128 bytes), f64 epilogue parameters and a 1,024-byte alignment pad, or
    K5c's ring (2 x 160 x 128) and popcounts, beside 64-bit queues and a
    threshold a query (QueueSelect::bytes); the segment's key tile
    [TQ][132] u32 fits each ring."""
    budget = 233472 // 2 - 1024
    int8 = 1024 + 3 * 192 * 128 + 8 * 2 * 64 + 64 * (8 * ktile.QUEUE_K_MAX + 4)
    sign = 1024 + 2 * 160 * 128 + 4 * (32 + 256) + 32 * (8 * ktile.QUEUE_K_MAX + 4)
    assert int8 <= budget and sign <= budget
    assert 64 * 132 * 4 <= 3 * 192 * 128 and 32 * 132 * 4 <= 2 * 160 * 128


# -------------------------------------------------------- route and width


def test_constants_match_the_kernels():
    """The wrappers' boundary and wave are the kernels' (ktile.cuh kQueueK;
    the probe's kRangeWave)."""
    src = (CSRC / "ktile.cuh").read_text()
    assert int(re.search(r"constexpr int kQueueK = (\d+);", src).group(1)) == ktile.QUEUE_K_MAX
    probe = (CSRC / "probe" / "select_split.cu").read_text()
    assert int(re.search(r"constexpr int kRangeWave = (\d+);", probe).group(1)) == \
        ktile.QUEUE_WAVE


@pytest.mark.parametrize("k", [1, 10, 40, 63, 64, 65, 100, 512, 513, 1024])
@pytest.mark.parametrize("ncomp,q,tq", [(100_352, 256, 64), (1_001_472, 256, 32),
                                        (10_000_384, 256, 64), (262_144, 256, 64),
                                        (5_120, 37, 64), (71_680, 1, 32)])
def test_route_and_width(k, ncomp, q, tq):
    """kk = min(k, 512); the queue up to QUEUE_K_MAX over ranges of whole
    splits that give at most QUEUE_WAVE blocks (and at least half of them
    where the splits allow), the radix select of one split above; width =
    blocks * kk."""
    kk, split, width, route = ktile.exact_geometry(k, ncomp, q, tq)
    nsplit = -(-ncomp // 512)
    nqt = -(-q // tq)
    assert kk == min(k, 512) and split % 512 == 0
    assert route == ("queue" if kk <= 64 else "radix") == ktile.select_route(k)
    assert width == -(-ncomp // split) * kk
    if route == "radix":
        assert split == 512
    else:
        blocks = -(-ncomp // split) * nqt
        assert blocks <= max(ktile.QUEUE_WAVE, nqt)
        assert split == 512 or 2 * blocks > ktile.QUEUE_WAVE
        assert blocks >= min(nsplit * nqt, ktile.QUEUE_WAVE // 2)


def _wrapper_lib(captured):
    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                captured.append((name, args))
                return 0
            return launch
    return Lib()


@pytest.mark.parametrize("k", [10, 64, 65, 600])
def test_wrappers_pass_the_geometry(monkeypatch, k):
    """sq_search / bq_search (sign and value queries) / pq_search (4-bit,
    int8 LUT) hand their kernels the geometry's rows a block and kk, size
    the candidates [Q, width], and count the launch under its select."""
    captured = []
    for mod in (sq_kernel, bq_kernel, pq_kernel):
        monkeypatch.setattr(mod, "use_kernels", lambda t: True)
        monkeypatch.setattr(mod, "load_library", lambda: _wrapper_lib(captured))
    monkeypatch.setattr(bq_kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    widths = []
    for mod in (sq_kernel, bq_kernel, pq_kernel):
        monkeypatch.setattr(mod, "merge_exact", lambda v, i, kk: widths.append(v.shape))
    rng = np.random.default_rng(k)
    n, q = 300_032, 70
    route = ktile.select_route(k)
    before = dict(ktile.SELECT_LAUNCHES)

    qcodes = torch.zeros((q, 128), dtype=torch.int8)
    sq_kernel.sq_search(qcodes, torch.zeros(q), torch.zeros((n, 128), dtype=torch.int8),
                        torch.zeros(n), torch.ones(1), distance_type=DistanceType.DOT,
                        n_valid=n - 5, k=k)
    planes = torch.zeros((8, 301_056), dtype=torch.int32)
    bq_kernel.bq_search(torch.zeros((q, 8), dtype=torch.int32), planes,
                        distance_type=DistanceType.DOT, invert=False, dim=256,
                        n_valid=n, k=k)
    aff = (torch.zeros((q, 256), dtype=torch.int8), torch.ones(q), torch.zeros(q))
    bq_kernel.bq_search(None, planes, torch.zeros((q, 301_056 // 512)),
                        distance_type=DistanceType.DOT, invert=False, dim=256, n_valid=n,
                        k=k, query_affine=aff, rowadd=torch.zeros(301_056))
    lut = torch.from_numpy(rng.standard_normal((q, 16, pq_kernel.K4)).astype(np.float32))
    pq_kernel.pq_search(lut, torch.zeros((16, n), dtype=torch.uint8), n_valid=n,
                        k=k, precision="int8")

    (sq_name, sq_args), (bq_name, bq_args), (res_name, res_args), (pq_name, pq_args) = captured
    cases = [(sq_name, "qtt_sq_search_exact", sq_args[11:13], n, sq_kernel.EXACT_TQ),
             (bq_name, "qtt_bq_search_exact", bq_args[10:12], 301_056,
              bq_kernel.SIGN_QUEUE_TQ),
             (res_name, "qtt_bq_search_exact_res", res_args[12:14], 301_056,
              sq_kernel.EXACT_TQ),
             (pq_name, "qtt_pq4_mma_search_exact", pq_args[11:13], n,
              sq_kernel.EXACT_TQ)]
    for (name, want_name, (split, kk), ncomp, tq), shape in zip(cases, widths):
        want = ktile.exact_geometry(k, ncomp, q, tq)
        assert name == want_name and (kk, split) == want[:2]
        assert tuple(shape) == (q, want[2])
    assert ktile.SELECT_LAUNCHES[route] == before[route] + 4
