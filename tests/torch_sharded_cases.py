"""Shared pieces of the sharded-engine parity tests
(tests/test_torch_sharded*.py): the shard counts, the two packages' meshes,
parameters and quantizers built from one seeded input, and the comparisons
with their tolerances.

S runs over 1, 3 and 8 shards: the JAX classes on ``make_mesh(S)`` over the
8 virtual CPU devices of tests/conftest.py, the port's on
``make_mesh(devices=[cpu] * S)``. At the tests' counts S = 3 and 8 leave a
ragged last shard, and S = 8 whole shards with no row. The JAX state is
carried across by ``interop.*_from_numpy`` and wrapped by each package's
sharded class, so both search the same codes."""

import jax
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
import quantization_tpu.parallel.sharded as j_sharded
import quantization_tpu_torch as qt
from quantization_tpu_torch.interop import bq_from_numpy, pq_from_numpy, sq_from_numpy
from quantization_tpu_torch.ops.kernels import pq_kernel
from quantization_tpu_torch.parallel import sharded as t_sharded

SHARDS = [1, 3, 8]
CPU = torch.device("cpu")
# SQ scores: the single-device SQ parity test's tolerance.
RTOL, ATOL = 1e-6, 1e-4


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX side in Pallas interpret mode (QTPU_FORCE_PALLAS=1) for one
    test, and its compiled programs dropped after it: the JAX package's
    sharded searches read that switch while they trace, so a cached Pallas
    program would serve a later test of the same shapes that runs without
    it (tests/test_sharded.py's PQ case, scored with the f32 LUT there)."""
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    yield
    jax.clear_caches()


def meshes(s):
    """(JAX mesh over the first s virtual devices, the port's mesh of s CPU
    shards)."""
    return j_sharded.make_mesh(s), t_sharded.make_mesh(devices=[CPU] * s)


def params(dim, n, dt="Dot", invert=False):
    """(JAX VectorParameters, the port's) for one configuration."""
    jp = j_types.VectorParameters(dim, n, j_types.DistanceType.from_json(dt), invert)
    return jp, qt.VectorParameters.from_json(jp.to_json())


def carried(jenc):
    """The port's single-device quantizer holding a JAX quantizer's state."""
    meta = jenc.metadata.to_json()
    if hasattr(jenc, "voffsets"):
        return sq_from_numpy(np.asarray(jenc.codes), np.asarray(jenc.voffsets), meta,
                             device="cpu")
    if hasattr(jenc, "planes"):
        return bq_from_numpy(np.asarray(jenc.planes), meta, jenc.store_type, device="cpu")
    return pq_from_numpy(np.asarray(jenc.codes), meta, device="cpu")


def wrapped(jenc, s):
    """(JAX sharded, port single-device, port sharded) over s shards, all
    three holding jenc's state."""
    jm, tm = meshes(s)
    tenc = carried(jenc)
    jcls = getattr(j_sharded, "Sharded" + _family(jenc))
    tcls = getattr(t_sharded, "Sharded" + _family(jenc))
    return jcls(jenc, jm), tenc, tcls(tenc, tm)


def _family(enc):
    if hasattr(enc, "voffsets"):
        return "ScalarQuantizer"
    return "BinaryQuantizer" if hasattr(enc, "planes") else "ProductQuantizer"


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want):
    np.testing.assert_allclose(host(got), host(want), rtol=RTOL, atol=ATOL)


def untied(row):
    """Positions of a sorted top-k row whose value occurs once in it and is
    not the k-th value (which may tie with rows beyond k)."""
    vals, counts = np.unique(row, return_counts=True)
    return np.isin(row, vals[counts == 1]) & (row != row[-1])


def ids_up_to_ties(gs, gi, ws, wi):
    """Ids equal wherever the reference's values are untied."""
    gs, gi, ws, wi = host(gs), host(gi), host(ws), host(wi)
    for r in range(ws.shape[0]):
        keep = untied(ws[r])
        np.testing.assert_array_equal(gi[r][keep], wi[r][keep])


def bit_equal(got, want):
    np.testing.assert_array_equal(host(got), host(want))


def lut_close(got, want, lut):
    """PQ scores of the int8 LUT (the port's default, the JAX package's in
    Pallas): within 2 ulp of |score| + |bias| (ROADMAP F14)."""
    _, _, bias = pq_kernel.quantize_lut(lut)
    got, want = host(got), host(want)
    assert (np.abs(got - want) <= 2 * np.spacing(
        np.abs(want) + np.abs(bias.numpy())[:, None])).all()
