"""Parity of the port's SQ codec (ops/sq.py, calibration) with the JAX package.

Codes must be byte-equal: both quantize as (x - offset) * f32(1/alpha), clamp,
NaN -> 0, floor. Offsets are integer code sums (exact in f32) times constants
that round to f32 as scalars in both packages; they are held to rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.models.sq as j_model
import quantization_tpu.ops.sq as j_sq
import quantization_tpu_torch.core.types as t_types
import quantization_tpu_torch.models.sq as t_model
import quantization_tpu_torch.ops.sq as t_sq

torch.set_num_threads(1)

DTS = ["Dot", "L1", "L2"]
OFF_RTOL, OFF_ATOL = 1e-6, 1e-6


def _enc_args(data, dt, invert, dim):
    mn, mx = float(data.min()), float(data.max())
    alpha, offset = t_sq.alpha_offset_from_min_max(mn, mx)
    assert (alpha, offset) == j_sq.alpha_offset_from_min_max(mn, mx)
    common = dict(alpha=alpha, offset=offset, invert=invert,
                  dpad=t_sq.actual_dim(dim), lane=t_sq.lane_dim(dim))
    return (
        dict(common, distance_type=j_types.DistanceType.from_json(dt)),
        dict(common, distance_type=t_types.DistanceType.from_json(dt)),
    )


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("dim", [33, 100, 256])
@pytest.mark.parametrize("side", ["data", "query"])
def test_quantize_matches_jax(rng, dt, invert, dim, side):
    data = rng.standard_normal((200, dim)).astype(np.float32)
    jkw, tkw = _enc_args(data, dt, invert, dim)
    x = data
    if side == "query":
        # Queries fall outside the calibrated range (clamp) and hold NaNs.
        x = rng.standard_normal((17, dim)).astype(np.float32) * 1.5
        x[3, 5] = np.nan
    j_fn, t_fn = (
        (j_sq.quantize_batch, t_sq.quantize_batch) if side == "data"
        else (j_sq.encode_query_batch, t_sq.encode_query_batch)
    )
    jc, jo = j_fn(jnp.asarray(x), **jkw)
    tc, to = t_fn(torch.from_numpy(x), **tkw)
    assert tc.dtype == torch.int8 and to.dtype == torch.float32
    assert tuple(tc.shape) == (x.shape[0], t_sq.lane_dim(dim))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=OFF_RTOL, atol=OFF_ATOL)


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("invert", [False, True])
def test_scalar_helpers_match_jax(dt, invert):
    jdt = j_types.DistanceType.from_json(dt)
    tdt = t_types.DistanceType.from_json(dt)
    for dim in (1, 15, 16, 17, 100, 127, 128, 129, 1024):
        assert t_sq.actual_dim(dim) == j_sq.actual_dim(dim)
        assert t_sq.lane_dim(dim) == t_sq.actual_dim(dim) + (-t_sq.actual_dim(dim)) % 128
    for alpha, offset in ((0.013, -1.0), (0.5, 0.25), (1.0, 0.0), (0.02, -0.3)):
        assert t_sq.multiplier_for(tdt, invert, alpha) == j_sq.multiplier_for(
            jdt, invert, alpha)
        assert t_sq.pad_code(tdt, alpha, offset) == j_sq.pad_code(jdt, alpha, offset)
        assert t_sq._inv_alpha(alpha) == j_sq._inv_alpha(alpha)
    assert t_sq.alpha_offset_from_min_max(2.0, 2.0) == j_sq.alpha_offset_from_min_max(2.0, 2.0)


@pytest.mark.parametrize("quantile", [None, 0.99, 0.9])
@pytest.mark.parametrize("stream", [False, True])
def test_calibration_and_encode_match_jax(rng, quantile, stream):
    n, dim = 1000, 40
    data = (rng.standard_normal((n, dim)) ** 3).astype(np.float32)
    jparams = j_types.VectorParameters(dim, n, j_types.DistanceType.L2, True)
    tparams = t_types.VectorParameters.from_json(jparams.to_json())
    src = (lambda: (data[i : i + 300] for i in range(0, n, 300))) if stream else data
    jenc = j_model.ScalarQuantizerU8.encode(src, jparams, quantile=quantile, seed=3)
    tenc = t_model.ScalarQuantizerU8.encode(src, tparams, quantile=quantile, seed=3,
                                            batch_size=256, device="cpu")
    assert tenc.metadata.to_json() == jenc.metadata.to_json()
    if quantile is not None:
        full = t_sq.alpha_offset_from_min_max(float(data.min()), float(data.max()))
        assert (tenc.metadata.alpha, tenc.metadata.offset) != full
    np.testing.assert_array_equal(tenc.codes.numpy(), np.asarray(jenc.codes))
    np.testing.assert_allclose(tenc.voffsets.numpy(), np.asarray(jenc.voffsets),
                               rtol=OFF_RTOL, atol=OFF_ATOL)


def test_encode_count_zero_matches_jax():
    jparams = j_types.VectorParameters(20, 0, j_types.DistanceType.DOT, False)
    tparams = t_types.VectorParameters.from_json(jparams.to_json())
    jenc = j_model.ScalarQuantizerU8.encode(np.zeros((0, 20), np.float32), jparams)
    tenc = t_model.ScalarQuantizerU8.encode(np.zeros((0, 20), np.float32), tparams,
                                            device="cpu")
    assert tenc.metadata.to_json() == jenc.metadata.to_json()
    assert tuple(tenc.codes.shape) == tuple(jenc.codes.shape)
    assert tuple(tenc.voffsets.shape) == tuple(jenc.voffsets.shape)
    with np.errstate(divide="ignore", invalid="ignore"):  # alpha is 0 here
        eq = tenc.encode_query(np.ones((2, 20), np.float32))
    s, i = tenc.top_k(eq, 3)
    assert s.shape == (2, 3) and (i == -1).all()


def test_encode_rejects_bad_input(rng):
    params = t_types.VectorParameters(8, 10, t_types.DistanceType.DOT, False)
    with pytest.raises(t_types.ArgumentsError):
        t_model.ScalarQuantizerU8.encode(rng.random((9, 8), dtype=np.float32), params,
                                         device="cpu")
    with pytest.raises(t_types.ArgumentsError):
        t_model.ScalarQuantizerU8.encode(
            lambda: iter([rng.random((11, 8), dtype=np.float32)]), params, device="cpu")
    with pytest.raises(t_types.StoppedError):
        t_model.ScalarQuantizerU8.encode(
            rng.random((10, 8), dtype=np.float32), params, stop_condition=lambda: True,
            device="cpu")
