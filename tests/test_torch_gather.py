"""The plain version of the port's K4 rescoring kernel (SQ ``score_candidates``)
against what the JAX package computes for it: the Pallas DMA row gather
(``gather_rows_pallas``, interpret mode) followed by ``_score_gathered``.

Tolerance: rtol 1e-6 / atol 1e-4, the SQ tolerance of
tests/test_torch_sq_kernels.py (XLA may fuse the epilogue's multiply-add,
where PyTorch rounds twice). An id outside [0, n_valid) — a coarse stage's
padding -1, a padding row, a row past the matrix — scores -inf in the port
and reads nothing, where the JAX gather reads a row for -1 (ROADMAP F4/F5):
that difference is pinned here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.sq as j_sq
from quantization_tpu.ops.pallas.gather import gather_rows_pallas
from quantization_tpu_torch.core.types import DistanceType
from quantization_tpu_torch.ops.kernels import gather

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-4


def _setup(rng, n, d, q, r):
    npad = n + (-n) % 512
    codes = np.zeros((npad, d), np.int8)
    codes[:n] = rng.integers(0, 128, (n, d), dtype=np.int8)
    voff = np.zeros(npad, np.float32)
    voff[:n] = rng.random(n, dtype=np.float32) * 10
    qcodes = rng.integers(0, 128, (q, d), dtype=np.int8)
    qoff = rng.random(q, dtype=np.float32)
    cand = rng.integers(0, n, (q, r)).astype(np.int32)
    return qcodes, qoff, codes, voff, cand


def _jax_rescore(qcodes, qoff, codes, voff, cand, mult, dt):
    """models/sq.py:453-467 of the JAX package: DMA gather, then score."""
    q, r = cand.shape
    flat = jnp.asarray(cand.reshape(-1))
    g = gather_rows_pallas(jnp.asarray(codes), flat, interpret=True).reshape(q, r, -1)
    goff = jnp.take(jnp.asarray(voff), flat).reshape(q, r)
    return np.asarray(j_sq._score_gathered(
        jnp.asarray(qcodes), jnp.asarray(qoff), g, goff, jnp.asarray(mult),
        distance_type=j_types.DistanceType.from_json(dt)))


@pytest.mark.parametrize("dt", ["Dot", "L2", "L1"])
@pytest.mark.parametrize("n,d,q,r", [(700, 256, 3, 11), (1500, 128, 2, 40)])
def test_plain_rescore_matches_pallas_gather(rng, dt, n, d, q, r):
    qcodes, qoff, codes, voff, cand = _setup(rng, n, d, q, r)
    mult = np.float32(0.37)
    want = _jax_rescore(qcodes, qoff, codes, voff, cand, mult, dt)
    got = gather.sq_score_candidates(
        *(torch.from_numpy(a) for a in (qcodes, qoff, codes, voff, cand)),
        torch.tensor([mult]), distance_type=DistanceType.from_json(dt), n_valid=n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, r)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_padding_id_scores_neg_inf(rng):
    """F4/F5 pinned: -1 scores -inf in the port; the JAX package's Pallas
    gather reads a real row for it (a finite score), so only the other
    slots agree."""
    qcodes, qoff, codes, voff, cand = _setup(rng, 600, 128, 2, 6)
    cand[0, 2] = -1
    cand[1, 0] = -1
    got = gather.sq_score_candidates(
        *(torch.from_numpy(a) for a in (qcodes, qoff, codes, voff, cand)),
        torch.tensor([0.5]), distance_type=DistanceType.DOT, n_valid=600).numpy()
    want = _jax_rescore(qcodes, qoff, codes, voff, cand, np.float32(0.5), "Dot")
    pad = cand < 0
    assert np.isneginf(got[pad]).all()
    assert np.isfinite(want[pad]).all()
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=RTOL, atol=ATOL)


def test_per_query_multiplier_and_launch_count(rng):
    """A per-query multiplier [Q]; CPU tensors never count a launch."""
    qcodes, qoff, codes, voff, cand = _setup(rng, 800, 128, 4, 9)
    mult = rng.random(4, dtype=np.float32) + 0.1
    before = dict(gather.LAUNCHES)
    got = gather.sq_score_candidates(
        *(torch.from_numpy(a) for a in (qcodes, qoff, codes, voff, cand)),
        torch.from_numpy(mult), distance_type=DistanceType.L2, n_valid=800)
    assert gather.LAUNCHES == before
    want = _jax_rescore(qcodes, qoff, codes, voff, cand, mult[:, None], "L2")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_out_of_range_ids_score_neg_inf(rng):
    """The contract the K4 kernel shares with its plain version: ids in
    [n_valid, npad) (padding rows) and ids >= npad score -inf like -1; the
    other slots keep the JAX package's scores."""
    qcodes, qoff, codes, voff, cand = _setup(rng, 600, 128, 2, 8)
    npad = codes.shape[0]
    cand[0, 1] = 600
    cand[0, 5] = npad - 1
    cand[1, 3] = npad
    cand[1, 7] = 2**31 - 1
    got = gather.sq_score_candidates(
        *(torch.from_numpy(a) for a in (qcodes, qoff, codes, voff, cand)),
        torch.tensor([0.5]), distance_type=DistanceType.DOT, n_valid=600).numpy()
    out = cand >= 600
    assert np.isneginf(got[out]).all() and np.isfinite(got[~out]).all()
    keep = np.where(out, 0, cand)
    want = _jax_rescore(qcodes, qoff, codes, voff, keep, np.float32(0.5), "Dot")
    np.testing.assert_allclose(got[~out], want[~out], rtol=RTOL, atol=ATOL)
