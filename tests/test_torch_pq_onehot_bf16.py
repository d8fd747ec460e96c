"""The bf16 one-hot route of the port's K8 with 4-bit codes
(csrc/pq4_mma_kernels.cu ``qtt_pq4_mma_scores_bf16``), emulated in torch on
the CPU: the B operand the wrapper builds (``bf16_onehot_operand``), the
one-hot bf16 A operand whose fragments OneHotBf16Frag builds in registers,
one chunk's product at a time from a zero accumulator, then the adds in the
plain version's
order (pairs of chunks, the pairs in order, each group of 8 added to a sum
that starts at +0.0; ROADMAP Queue 3, F19). The kernel itself runs only on
the card (tests/test_torch_cuda.py and chip_smoke.py hold it to the plain
version there).

Tolerances, with their causes:
  * emulation vs the port's plain version: none, to the bit. A chunk's
    product has one nonzero term, the LUT entry times 1.0, so it is the
    entry exactly; the adds are the plain version's, in its order. A zero
    entry may come back with either sign, and the route adds zeros for the
    chunks past m and an odd m's unpaired chunk; none of that changes a bit
    of the result, since the running sum starts at +0.0 and never becomes
    -0.0. The LUTs here hold +-0.0 entries, whole chunks of -0.0, a query of
    -0.0 only, entries 2^-40 .. 2^40 apart and bf16 subnormals.
  * emulation vs the JAX package's Pallas kernel (interpret mode): each
    within the f32 error bound of an m-term sum of the f64 oracle of the
    bf16-rounded LUT (0 where the sum is exact in f32 in every order), and
    1 ulp apart wherever that bound allows no more
    (tests/torch_bf16_sums.py): the JAX kernel sums a group of 8 chunks in
    one matmul, in the order of the host's XLA CPU dot (F19, F36)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.ops.pallas.pq_kernel as j_kernel
from quantization_tpu_torch.ops.kernels import pq_kernel

from torch_bf16_sums import assert_bf16_scores

torch.set_num_threads(1)

KC = pq_kernel.K4
BF16_ONE = 0x3F80  # 1.0 in bf16


def _setup(rng, m, n_valid, q, special=False):
    """A seeded LUT f32 [Q, m, 16] and codes u8 [Mpad, Npad] whose valid
    codes carry a random high nibble (the kernels read ``& 15``), zero past m
    and n_valid. ``special``: each (query, chunk) scaled by 2^k, |k| <= 40;
    a tenth of the entries +-0.0, a twentieth bf16 subnormals (j * 2^-133),
    every fifth chunk of query 0 all -0.0, and with Q > 2 the last query of
    subnormals only and the one before it of -0.0 only."""
    lut = (rng.standard_normal((q, m, KC)) * 2.0 + rng.standard_normal((q, m, 1))).astype(
        np.float32)
    if special:
        lut *= np.exp2(rng.integers(-40, 41, (q, m, 1))).astype(np.float32)
        r = rng.random(lut.shape)
        sub = (rng.integers(1, 128, lut.shape) * 2.0 ** -133).astype(np.float32)
        sign = np.where(rng.random(lut.shape) < 0.5, -1.0, 1.0).astype(np.float32)
        lut = np.where(r < 0.1, sign * np.float32(0.0), lut)
        lut = np.where((r >= 0.1) & (r < 0.15), sign * sub, lut)
        lut[0, ::5] = -0.0
        if q > 2:
            lut[-1] = sign[-1] * sub[-1]
            lut[-2] = -0.0
    mpad = m + (-m) % pq_kernel.M_BLK
    npad = n_valid + (-n_valid) % pq_kernel.TILE_N
    codes_t = np.zeros((mpad, npad), np.uint8)
    codes_t[:m, :n_valid] = rng.integers(0, 256, (m, n_valid))
    return torch.from_numpy(lut), torch.from_numpy(codes_t)


def onehot_rows(codes_t):
    """[Npad, Mpad * 16] bf16: the A operand's rows, 1.0 at element 16c +
    (code & 15) of chunk c, 0 elsewhere."""
    code = codes_t.T.long() & 15  # [Npad, Mpad]
    rows = torch.zeros((*code.shape, KC), dtype=torch.bfloat16)
    rows.scatter_(2, code[..., None], 1.0)
    return rows.reshape(code.shape[0], -1)


def emulate(lut, codes_t, n_valid):
    """[Q, n_valid] f32: the route's arithmetic. Chunk c's product is the
    B operand's 16 columns of c against the A rows' 16, from zero; then
    pair sums, group sums in order, and acc = acc + group every 8 chunks,
    over all Mpad chunks as the kernel runs them."""
    mpad = codes_t.shape[0]
    b = pq_kernel.bf16_onehot_operand(lut, mpad).float()
    a = onehot_rows(codes_t)[:n_valid].float()

    def chunk(c):
        return b[:, KC * c: KC * (c + 1)] @ a[:, KC * c: KC * (c + 1)].T

    acc = torch.zeros((b.shape[0], n_valid))
    for g0 in range(0, mpad, pq_kernel.GRP4):
        gs = None
        for c in range(g0, g0 + pq_kernel.GRP4, 2):
            pr = chunk(c) + chunk(c + 1)
            gs = pr if gs is None else gs + pr
        acc = acc + gs
    return acc


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("q,n_valid", [(1, 1), (37, 1100), (65, 1025), (70, 2049)])
@pytest.mark.parametrize("m", [8, 13, 32, 96])
def test_bf16_onehot_product_equals_plain_to_the_bit(rng, m, q, n_valid, special):
    lut, codes_t = _setup(rng, m, n_valid, q, special)
    got = emulate(lut, codes_t, n_valid)
    want = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="bf16")
    assert torch.equal(_bits(got), _bits(want))
    if special and q > 2:
        assert not bool(_bits(got[-2]).any())  # a -0.0 query scores +0.0, to the bit
        # the subnormal query: sums of subnormals, nonzero, far below 2^-100
        assert bool(got[-1].any()) and float(got[-1].abs().max()) < 2.0 ** -100


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("m", [8, 13, 32, 96])
def test_bf16_onehot_product_equals_pallas(rng, m, zeros):
    """The route and the JAX package's bf16 K8 (interpret mode) each within
    the f32 bound of the f64 oracle, 1 ulp apart where the bound allows no
    more (F19, F36), on LUTs with and without +-0.0 entries and -0.0
    chunks."""
    q, n_valid = 37, 1100
    lut, codes_t = _setup(rng, m, n_valid, q)
    if zeros:
        lut[rng.random(lut.shape) < 0.1] = 0.0
        lut[rng.random(lut.shape) < 0.1] = -0.0
        lut[3, ::3] = -0.0
    want = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), n_valid=n_valid,
        interpret=True, precision="bf16"))
    got = emulate(lut, codes_t, n_valid).numpy()
    assert_bf16_scores(got, want, lut, codes_t.numpy(), np.arange(n_valid))


def _nonfinite_lut(rng, m, n_valid, q):
    """``_setup``'s LUT and codes with entries that are not finite in bf16:
    query 0 +inf and an f32 entry below bf16's range (it rounds to -inf) in
    one chunk, query 1 one +inf, query 2 one -inf; the rest finite. Returns
    (lut, codes_t, hits): hits[j] bool [n_valid], the rows whose code meets
    query j's single infinite entry (1, 2)."""
    lut, codes_t = _setup(rng, m, n_valid, q)
    lut[0, 3, 5], lut[0, 3, 9] = float("inf"), -torch.finfo(torch.float32).max
    lut[1, m - 1, 2] = float("inf")
    lut[2, 0, 11] = -float("inf")
    code = codes_t[:, :n_valid].long() & 15
    return lut, codes_t, {1: code[m - 1] == 2, 2: code[0] == 11}


@pytest.mark.parametrize("m", [8, 13])
def test_bf16_onehot_product_of_a_nonfinite_lut_is_nan_in_its_chunk(rng, m):
    """ROADMAP Queue 3, F28, pinned as it is: an entry that is not finite
    in bf16 meets 0.0 in the one-hot product of every row whose code is
    another, so those rows score NaN, as in the JAX package's one-hot matmul
    (interpret mode: the same NaN rows, the same infinities). A row whose
    code is the infinite entry scores that infinity; with +inf and -inf in
    one chunk every row meets one of them times 0.0 and scores NaN. The
    plain version gives the infinity to the rows with that code only and
    stays finite elsewhere. Finite queries are untouched, to the bit."""
    q, n_valid = 5, 1100
    lut, codes_t, hits = _nonfinite_lut(rng, m, n_valid, q)
    got = emulate(lut, codes_t, n_valid)
    assert bool(torch.isnan(got[0]).all())
    for j, inf in ((1, float("inf")), (2, -float("inf"))):
        assert bool(hits[j].any()) and not bool(hits[j].all())
        assert bool((got[j][hits[j]] == inf).all())
        assert bool(torch.isnan(got[j][~hits[j]]).all())
    plain = pq_kernel.pq_scores_plain(lut, codes_t, n_valid=n_valid, precision="bf16")
    assert torch.equal(_bits(got[3:]), _bits(plain[3:]))
    assert bool(torch.isfinite(plain[1][~hits[1]]).all())
    assert bool((plain[1][hits[1]] == float("inf")).all())

    want = np.asarray(j_kernel.pq_scores_pallas(
        jnp.asarray(lut.numpy()), jnp.asarray(codes_t.numpy()), n_valid=n_valid,
        interpret=True, precision="bf16"))
    g = got.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(want))
    fin = np.isfinite(want)
    assert (np.abs(g[fin] - want[fin]) <= np.spacing(np.abs(want[fin]))).all()
    np.testing.assert_array_equal(g[np.isinf(want)], want[np.isinf(want)])


@pytest.mark.parametrize("m", [8, 13, 96])
def test_bf16_onehot_operand_is_the_jax_lut_flat(rng, m):
    """[Q, Mpad * 16] bf16, zero past m: the JAX package's bf16 operand
    (pq_scores_pallas's lut_flat) to the bit."""
    q = 5
    lut, codes_t = _setup(rng, m, 10, q, special=True)
    mpad = codes_t.shape[0]
    b = pq_kernel.bf16_onehot_operand(lut, mpad)
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == (q, mpad * KC)
    assert b.is_contiguous()
    jl = jnp.asarray(lut.numpy())
    want = np.asarray(j_kernel.pad_dim_to(jl, 1, mpad).reshape(q, mpad * KC)
                      .astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(b.view(torch.int16).numpy().view(np.uint16), want)
    assert not bool(b[:, m * KC:].view(torch.int16).any())


def _fragment(x, y, col):
    """The four registers OneHotBf16Frag::build gives the thread of column
    pair ``col`` holding rows with codes x and y."""
    ox, oy = BF16_ONE << (16 * (x & 1)), BF16_ONE << (16 * (y & 1))
    return [ox if x >> 1 == col else 0, oy if y >> 1 == col else 0,
            ox if x >> 1 == col + 4 else 0, oy if y >> 1 == col + 4 else 0]


def test_onehot_bf16_fragment_values():
    """The 4 threads of a quad together hold their two rows' 16 columns
    (registers 0 and 2 the first row's columns 2 col, + 1 and + 8, + 9;
    registers 1 and 3 the second row's; the lower column in the low half),
    and each row is the one-hot of its code: 1.0 at the code, 0 elsewhere."""
    for x in range(16):
        for y in range(16):
            first, second = [0] * 16, [0] * 16
            for col in range(4):
                regs = _fragment(x, y, col)
                for reg, row, base in ((regs[0], first, 2 * col), (regs[1], second, 2 * col),
                                       (regs[2], first, 2 * col + 8),
                                       (regs[3], second, 2 * col + 8)):
                    row[base], row[base + 1] = reg & 0xFFFF, reg >> 16
            assert first == [BF16_ONE if i == x else 0 for i in range(16)]
            assert second == [BF16_ONE if i == y else 0 for i in range(16)]


def test_onehot_bf16_fragment_rows_cover_the_segment():
    """Tile rows R and R + 8 of warp w of warpgroup g (lane 4R .. 4R + 3)
    are segment rows 64g + 16w + 2R and + 1: the 256 threads' 16-bit code
    loads cover the 128 rows of a segment, each row by the 4 threads of one
    quad, and the accumulator's rows (bf_row) are those rows."""
    seen = {}
    for t in range(256):
        g, w, lane = t >> 7, (t >> 5) & 3, t & 31
        src = 64 * g + 16 * w + 2 * (lane >> 2)
        for e in range(32):
            row = src + ((e >> 1) & 1)
            seen.setdefault(row, set()).add(t)
    assert sorted(seen) == list(range(128))
    assert all(len(ts) == 4 for ts in seen.values())


ROUTE_CASES = [(kc, p, mode) for kc in (pq_kernel.K4, pq_kernel.K)
               for p in pq_kernel.PRECISIONS for mode in ("scores", "exact", "approx",
                                                         "indexed")]


@pytest.mark.parametrize("kc,precision,mode", ROUTE_CASES)
def test_bf16_route_takes_4bit_bf16_scores_only(rng, monkeypatch, kc, precision, mode):
    """4-bit bf16 and bf16x2 pq_scores reach the bf16 one-hot entry point,
    with the launch's LUT, codes and output; the 4-bit searches and every
    8-bit launch do not. The wrappers run their kernel path on CPU tensors
    with the launches recorded, not run."""
    calls = []

    def bf16(lut, codes_t, n_valid, out):
        calls.append(("bf16", tuple(lut.shape), n_valid, tuple(out.shape)))

    monkeypatch.setattr(pq_kernel, "use_kernels", lambda t: True)
    monkeypatch.setattr(pq_kernel, "_launch", lambda name, lut, ct, p, n, outs, *e, **k:
                        (calls.append("gather"), [o.zero_() for o in outs]))
    monkeypatch.setattr(pq_kernel, "_launch_onehot", lambda name, lut, ct, n, outs, *e, **k:
                        (calls.append("onehot"), [o.zero_() for o in outs]))
    monkeypatch.setattr(pq_kernel, "_launch_bf16_onehot", bf16)
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
    want = kc == pq_kernel.K4 and precision != "int8" and mode == "scores"
    assert len(calls) == 1
    assert (calls[0] == ("bf16", (q, m, kc), n_valid, (q, n_valid))) == want
    assert (mode == "scores" and pq_kernel.bf16_onehot_route(kc, precision)) == want
