"""The LUT-gather kernels' packed LUT layout and packed int8 sums
(``csrc/pq_kernels.cuh``: ``Lanes``, ``add_group``, ``end_stage``,
``finish``), emulated in numpy on the CPU, where the kernels cannot run:

  * ``_kernel_lut``'s layout, unpacked word by word as the kernel reads it,
    equals ``_operands``' words, zero past m and past Q;
  * the biased 16-bit pair sums of int8 entries, flushed every 256 chunks,
    equal the int32 sums on the extreme LUTs, at the flush's edge;
  * the kernel's whole lookup arithmetic, read from the packed layout, equals
    the plain version (``_plain_scores``) to the bit.

Tolerance: none. The int8 sums are integers, and the float sums are taken
in the plain version's order with f32 rounding at each step. The card holds
the kernels themselves to the plain version (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from quantization_tpu_torch.ops.kernels import pq_kernel

torch.set_num_threads(1)

TQ = pq_kernel.TQ
FLUSH = 256  # csrc/pq_kernels.cuh kFlush
PRECISIONS = ("int8", "bf16", "bf16x2")


def _lut(rng, q, m, kc):
    return torch.from_numpy(
        (rng.standard_normal((q, m, kc)) * 2.0 + rng.standard_normal((q, m, 1))).astype(
            np.float32))


def _tiled(w, mpad, qt):
    """[Q, m, kc] -> [qt, mpad, kc, 32], zero past m and Q."""
    q, m, kc = w.shape
    out = np.zeros((qt * TQ, mpad, kc), w.dtype)
    out[:q, :m] = w
    return out.reshape(qt, TQ, mpad, kc).transpose(0, 2, 3, 1)


def _unpack(klut, precision, qt, mpad, kc):
    """The entries the kernel reads from the packed layout, [qt, mpad, kc,
    32] int8 or bf16 bits (u16; bf16x2 as hi, lo), one 32-bit word at a
    time: int8 4 queries a word, each biased by 128; bf16 2 queries a word;
    bf16x2 a pair's hi halves in one word, its lo halves in the next."""
    k = (klut.view(torch.int16) if klut.dtype == torch.bfloat16 else klut).numpy()
    if precision == "int8":
        assert k.dtype == np.uint8 and k.shape == (qt, mpad, kc, TQ)
        words = k.reshape(qt, mpad, kc, TQ // 4, 4).view(np.uint32)[..., 0]
        byte = (words[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
        return (byte.reshape(qt, mpad, kc, TQ).astype(np.int16) - 128).astype(np.int8)
    if precision == "bf16":
        words = k.view(np.uint16).reshape(qt, mpad, kc, TQ // 2, 2).view(np.uint32)[..., 0]
        halves = np.stack([words & 0xFFFF, words >> 16], axis=-1)
        return halves.reshape(qt, mpad, kc, TQ).astype(np.uint16)
    assert k.dtype == np.int32 and k.shape == (qt, mpad, kc, TQ // 2, 2)
    w = k.view(np.uint32)
    hi = np.stack([w[..., 0] & 0xFFFF, w[..., 0] >> 16], axis=-1).reshape(qt, mpad, kc, TQ)
    lo = np.stack([w[..., 1] & 0xFFFF, w[..., 1] >> 16], axis=-1).reshape(qt, mpad, kc, TQ)
    return hi.astype(np.uint16), lo.astype(np.uint16)


@pytest.mark.parametrize("m", [8, 96, 192])
@pytest.mark.parametrize("q", [1, 4, 33, 100, 256])
@pytest.mark.parametrize("kc", [16, 256])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_packed_layout_unpacks_to_the_operands(precision, kc, q, m):
    rng = np.random.default_rng(q * 1000 + m + kc)
    lut = _lut(rng, q, m, kc)
    words, _, _ = pq_kernel._operands(lut, precision)
    mpad = m + (-m) % pq_kernel.M_BLK
    qt = -(-q // TQ)
    got = _unpack(pq_kernel._kernel_lut(words, mpad), precision, qt, mpad, kc)
    if precision == "int8":
        np.testing.assert_array_equal(got, _tiled(words[0].numpy(), mpad, qt))
        return
    want = [_tiled(w.view(torch.int16).numpy().view(np.uint16), mpad, qt) for w in words]
    for g, w in zip(got if precision == "bf16x2" else (got,), want):
        np.testing.assert_array_equal(g, w)


def _packed_sums(entries, mpad, flush=FLUSH):
    """The kernel's int8 sums of one lane's 8 queries over mpad chunks
    (entries int8 [mpad, 8]): the 8 bytes biased by 128 as one 8-byte load
    (x: queries 0-3, y: 4-7), each word's even bytes by a mask and odd ones
    by a byte permute into 4 registers of two 16-bit sums, flushed into
    int32 every ``flush`` chunks while chunks remain (None: never), 128 a
    chunk taken off at the end (add_group, end_stage, finish)."""
    biased = (entries.astype(np.int16) + 128).astype(np.uint32)
    x = biased[:, 0] | biased[:, 1] << 8 | biased[:, 2] << 16 | biased[:, 3] << 24
    y = biased[:, 4] | biased[:, 5] << 8 | biased[:, 6] << 16 | biased[:, 7] << 24
    v = np.zeros(4, np.uint32)
    wide = np.zeros(8, np.int64)

    def packed(i):
        w = int(v[2 * (i >> 2) + (i & 1)])
        return w >> 16 if i & 2 else w & 0xFFFF

    for c in range(mpad):
        for j, w in enumerate((x[c], y[c])):
            v[2 * j] = np.uint32((int(v[2 * j]) + (int(w) & 0x00FF00FF)) & 0xFFFFFFFF)
            odd = (int(w) >> 8 & 0xFF) | (int(w) >> 24 & 0xFF) << 16
            v[2 * j + 1] = np.uint32((int(v[2 * j + 1]) + odd) & 0xFFFFFFFF)
        if flush and (c + 1) % flush == 0 and c + 1 < mpad:
            wide += [packed(i) for i in range(8)]
            v[:] = 0
    return np.array([packed(i) for i in range(8)], np.int64) - 128 * mpad + wide


def _extreme(kind, mpad):
    if kind == "all_plus":
        return np.full((mpad, 8), 127, np.int8)
    if kind == "all_minus":
        return np.full((mpad, 8), -127, np.int8)
    e = np.where((np.arange(mpad)[:, None] + np.arange(8)[None]) % 2 == 0, 127, -127)
    return e.astype(np.int8)


@pytest.mark.parametrize("mpad", [96, 192, 256, 257, 272, 512])
@pytest.mark.parametrize("kind", ["all_plus", "all_minus", "alternating"])
def test_packed_int8_sums_equal_int32_sums(kind, mpad):
    entries = _extreme(kind, mpad)
    np.testing.assert_array_equal(_packed_sums(entries, mpad),
                                  entries.astype(np.int32).sum(0))


@pytest.mark.parametrize("mpad,exact", [(257, True), (272, False)])
def test_packed_sums_without_the_flush(mpad, exact):
    """Unflushed, the 16-bit sums of biased +127 entries hold 257 chunks
    (255 * 257 = 65,535) and carry into their neighbours past it: the flush
    every 256 chunks is what keeps mpad = 272 exact."""
    entries = _extreme("all_plus", mpad)
    want = entries.astype(np.int32).sum(0)
    assert np.array_equal(_packed_sums(entries, mpad, flush=None), want) == exact
    np.testing.assert_array_equal(_packed_sums(entries, mpad), want)


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _emulate(lut, codes_t, n, precision):
    """[Q, n] f32: the kernels' lookup arithmetic on the packed layout: the
    entries each chunk's code selects, int8 through the packed sums and the
    f64 epilogue, bf16 / bf16x2 summed in f32 in chunk order (4-bit: each
    group of 8 in pairs first), bf16x2's lo sum folded in every 16 chunks."""
    words, scale, bias = pq_kernel._operands(lut, precision)
    q, _, kc = lut.shape
    mpad = codes_t.shape[0]
    qt = -(-q // TQ)
    ent = _unpack(pq_kernel._kernel_lut(words, mpad), precision, qt, mpad, kc)
    code = codes_t[:, :n].numpy().astype(np.int64) & (kc - 1)

    def pick(table, c):  # [qt, mpad, kc, 32] -> [qt * 32, n]
        return table[:, c, code[c], :].transpose(0, 2, 1).reshape(qt * TQ, n)

    if precision == "int8":
        biased = [pick(ent, c).astype(np.int64) + 128 for c in range(mpad)]
        pair = np.zeros((qt * TQ, n), np.int64)  # one 16-bit lane
        wide = np.zeros_like(pair)
        for c in range(mpad):
            pair += biased[c]
            assert int(pair.max(initial=0)) < 1 << 16
            if (c + 1) % FLUSH == 0 and c + 1 < mpad:
                wide += pair
                pair[:] = 0
        acc = (pair - 128 * mpad + wide)[:q]
        return (scale.double().numpy()[:, None] * acc
                + bias.double().numpy()[:, None]).astype(np.float32)
    grp = 8 if kc == 16 else 1
    hi, lo = ent if precision == "bf16x2" else (ent, None)
    acc = np.zeros((qt * TQ, n), np.float32)
    lo_acc = np.zeros_like(acc)

    def group(table, g0):
        if grp == 1:
            return _f32(pick(table, g0))
        s = None
        for c in range(g0, g0 + grp, 2):
            p = _f32(pick(table, c)) + _f32(pick(table, c + 1))
            s = p if s is None else s + p
        return s

    for g0 in range(0, mpad, grp):
        acc = acc + group(hi, g0)
        if lo is not None:
            lo_acc = lo_acc + group(lo, g0)
            if (g0 + grp) % pq_kernel.M_BLK == 0:
                acc = acc + lo_acc * np.float32(1.0 / 256.0)
                lo_acc[:] = 0
    return acc[:q]


@pytest.mark.parametrize("kc,m,q,n", [(256, 96, 33, 300), (256, 8, 4, 70), (16, 24, 37, 200),
                                      (16, 192, 5, 64)])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_lookup_arithmetic_on_the_packed_layout_equals_plain(precision, kc, m, q, n):
    rng = np.random.default_rng(kc + m + q)
    lut = _lut(rng, q, m, kc)
    mpad = m + (-m) % pq_kernel.M_BLK
    codes = np.zeros((mpad, n + (-n) % pq_kernel.TILE_N), np.uint8)
    # codes with their high bits set: the kernels mask them to kc - 1
    codes[:m, :n] = rng.integers(0, 256, (m, n))
    codes_t = torch.from_numpy(codes)
    want = pq_kernel.lut_scores_plain(lut, codes_t, n_valid=n, precision=precision).numpy()
    np.testing.assert_array_equal(_emulate(lut, codes_t, n, precision).view(np.int32),
                                  want.view(np.int32))
