"""The f64 oracle of 4-bit PQ scores with the bf16 LUT, and its f32 error
bound, shared by the CPU tests that hold the port's plain scores and the JAX
package's interpret-mode scores to it (ROADMAP Queue 3, F19 and F36).

Both packages sum the same m bf16 entries of a row in f32, in orders of
their own: the port in pairs within groups of 8 chunks, the JAX kernel in
XLA's CPU dot order, which depends on the host's code. A fixed 1-ulp gap
between them holds on one host only. What holds on every host:

  * every term is a bf16 value, so a multiple of 2^L, L = (exponent of the
    term's leading bit) - 7 at the smallest nonzero term; every partial sum,
    in any order, is then a multiple of 2^L no larger than sum |x|. Where
    sum |x| < 2^(L + 24) each partial sum is an f32 value, so the f32 sum is
    exact in every order: the bound is 0;
  * elsewhere the f32 sum of m terms in any order lies within gamma_{m-1}
    sum |x| of the exact sum, gamma_n = n u / (1 - n u), u = 2^-24.

The oracle itself, an f64 sum, is exact where sum |x| < 2^(L + 53), which
``bf16_sum_oracle`` asserts."""

import numpy as np
import torch

U32 = 2.0 ** -24


def bf16_sum_oracle(lut, codes_t, rows):
    """(exact f64 [Q, R], bound f64 [Q, R]) of the scores of rows ``rows``
    (i64 [R], or [Q, R] per query) under the bf16-rounded LUT f32 [Q, m, 16]
    and the codes u8 [Mpad, Npad] (read & 15)."""
    lut = torch.as_tensor(lut)
    q, m, kc = lut.shape
    lb = lut.to(torch.bfloat16).float().numpy().astype(np.float64)
    codes = np.asarray(codes_t)[:m].astype(np.int64) & (kc - 1)  # [m, Npad]
    rows = np.asarray(rows, np.int64)
    if rows.ndim == 1:
        rows = np.broadcast_to(rows, (q, rows.shape[0]))
    code = codes[:, rows]  # [m, Q, R]
    terms = lb[np.arange(q)[None, :, None], np.arange(m)[:, None, None], code]
    exact = terms.sum(axis=0)
    total = np.abs(terms).sum(axis=0)
    _, e = np.frexp(terms)  # |x| = f 2^e, f in [0.5, 1): 8 bits from 2^(e-1) down
    low = np.where(terms != 0, e - 8, np.iinfo(np.int64).max).min(axis=0)
    quantum = np.exp2(np.minimum(low, 1023).astype(np.float64))
    assert (total < quantum * 2.0 ** 53).all(), "the f64 oracle is exact"
    gamma = (m - 1) * U32 / (1 - (m - 1) * U32)
    bound = np.where(total < quantum * 2.0 ** 24, 0.0, gamma * total)
    return exact, bound


def assert_within_bound(got, exact, bound):
    """Each score within its f32 bound of the exact sum (equal where 0)."""
    assert (np.abs(got.astype(np.float64) - exact) <= bound).all()


def assert_bf16_scores(got, want, lut, codes_t, rows):
    """The port's scores ``got`` and the JAX package's ``want`` of the same
    rows each within the bound of the oracle; and F19's 1 ulp between them
    wherever the bound allows no more (at most half an ulp of the exact sum,
    so both are its faithful roundings)."""
    exact, bound = bf16_sum_oracle(lut, codes_t, rows)
    assert_within_bound(got, exact, bound)
    assert_within_bound(want, exact, bound)
    tight = bound <= 0.5 * np.spacing(np.abs(exact).astype(np.float32))
    assert (np.abs(got - want) <= np.spacing(np.abs(want)))[tight].all()
