"""The port's BQ codec (``quantization_tpu_torch/ops/bq.py``) against the JAX
package's: storage sizes, packed rows and bit planes byte-equal for both
storage tiers across the word boundaries, the plain XOR + popcount scores
equal, and the Hamming->metric truth table.

Tolerance: none. Every score is an integer below 2^24, exact in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.ops.bq as j_bq
import quantization_tpu_torch.ops.bq as t_bq
from quantization_tpu_torch.core.types import DistanceType

torch.set_num_threads(1)

DIMS = [1, 31, 32, 33, 64, 65, 127, 128, 129, 1536]
TIERS = ["u8", "u128"]


def _data(rng, n, dim):
    """Signed values with exact zeros (a zero packs as 0, like a negative)."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x[rng.random((n, dim)) < 0.05] = 0.0
    return x


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("tier", TIERS)
def test_codec_bytes_equal(rng, tier, dim):
    assert t_bq.storage_bytes(dim, tier) == j_bq.storage_bytes(dim, tier)
    row_bytes = t_bq.storage_bytes(dim, tier)
    x = _data(rng, 37, dim)
    rows = t_bq.pack_rows(x, row_bytes)
    np.testing.assert_array_equal(rows, j_bq.pack_rows(x, row_bytes))
    planes = t_bq.rows_to_planes(rows)
    assert planes.dtype == np.uint32
    np.testing.assert_array_equal(planes, j_bq.rows_to_planes(rows))
    np.testing.assert_array_equal(t_bq.planes_to_rows(planes, row_bytes), rows)
    np.testing.assert_array_equal(
        t_bq.planes_to_rows(planes, row_bytes), j_bq.planes_to_rows(planes, row_bytes)
    )


def test_storage_bytes_word_tiers():
    """u8 escalates 1/4/8/16-byte words with dim; u128 is always 16 bytes."""
    assert [t_bq.storage_bytes(d, "u8") for d in (8, 32, 33, 64, 65, 128, 129)] == [
        1, 4, 8, 8, 16, 16, 32]
    assert [t_bq.storage_bytes(d, "u128") for d in (1, 128, 129)] == [16, 16, 32]
    with pytest.raises(Exception, match="store type"):
        t_bq.storage_bytes(8, "u16")


def test_words_round_trip_through_int32_tensors(rng):
    """uint32 words with the top bit set survive the int32 device view."""
    words = rng.integers(0, 2**32, (5, 7), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0xFFFFFFFF
    t = t_bq.words_to_tensor(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t_bq.tensor_to_words(t), words)


def test_popcount32_matches_numpy(rng):
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    got = t_bq.popcount32(t_bq.words_to_tensor(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["Dot", "L1", "L2"])
@pytest.mark.parametrize("invert", [False, True])
def test_metric_from_xor_truth_table(dt, invert):
    dim = 100
    x = np.array([0, 1, 37, 50, 99, 100], np.int32)
    got = t_bq.metric_from_xor(
        torch.from_numpy(x), distance_type=DistanceType.from_json(dt),
        invert=invert, dim=dim,
    ).numpy()
    want = np.asarray(j_bq.metric_from_xor(
        jnp.asarray(x), distance_type=j_types.DistanceType.from_json(dt),
        invert=invert, dim=dim,
    ))
    np.testing.assert_array_equal(got, want)
    base = dim - 2 * x if dt == "Dot" else 2 * x - dim
    np.testing.assert_array_equal(got, -base if invert else base)


@pytest.mark.parametrize("dim", [33, 129, 1536])
@pytest.mark.parametrize("dt", ["Dot", "L2"])
def test_plain_scores_and_candidates_equal_jax(rng, dim, dt):
    row_bytes = t_bq.storage_bytes(dim, "u128")
    planes = t_bq.rows_to_planes(t_bq.pack_rows(_data(rng, 300, dim), row_bytes))
    qplanes = t_bq.rows_to_planes(t_bq.pack_rows(_data(rng, 5, dim), row_bytes)).T.copy()
    jdt, tdt = j_types.DistanceType.from_json(dt), DistanceType.from_json(dt)
    want = np.asarray(j_bq.score_batch_xla(
        jnp.asarray(qplanes), jnp.asarray(planes), distance_type=jdt, invert=True, dim=dim))
    tq, tp = t_bq.words_to_tensor(qplanes, "cpu"), t_bq.words_to_tensor(planes, "cpu")
    got = t_bq.score_batch(tq, tp, distance_type=tdt, invert=True, dim=dim)
    np.testing.assert_array_equal(got.numpy(), want)
    cand = rng.integers(0, 300, (5, 9)).astype(np.int32)
    cand[0, 0] = -1  # wraps to the last row, as jnp.take does
    want_c = np.asarray(j_bq.score_candidates_xla(
        jnp.asarray(qplanes), jnp.asarray(planes), jnp.asarray(cand),
        distance_type=jdt, invert=True, dim=dim))
    got_c = t_bq.score_candidates(tq, tp, torch.from_numpy(cand), distance_type=tdt,
                                  invert=True, dim=dim)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
