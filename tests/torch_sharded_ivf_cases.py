"""Shared pieces of the sharded IVF parity tests
(tests/test_torch_sharded_ivf*.py): the corpora of tests/test_sharded_ivf.py,
the JAX package's index of one configuration wrapped by both packages'
``ShardedIVF``, and the comparisons with their tolerances.

S runs over 1, 3 and 8 shards (tests/torch_sharded_cases.py): the JAX class
on ``make_mesh(S)`` over the 8 virtual CPU devices, the port's on ``[cpu] *
S``. The JAX index's state is carried across by ``ivf_from_numpy``, so both
packages' sharded classes wrap the same codes. The JAX side runs its fused
kernels in Pallas interpret mode (QTPU_FORCE_PALLAS=1, as tests/test_ivf.py
does), so both search PQ with the int8 LUT.

Tolerances, with their causes (tests/test_torch_ivf_model.py's, and for
residual indexes tests/test_sharded_ivf.py's):
  * against the JAX package: values rtol 1e-5 / atol 1e-4 (the SQ and
    int8-LUT epilogues, ROADMAP F14); ids equal where the JAX value is
    untied; BQ ties in droves, so there the ids need only be distinct rows;
  * against the port's own single-device search: a plain index to the bit
    (each row's score is computed as on one device; only the selection and
    the merge differ), ids where untied;
  * a residual index, against either: rtol 1e-4 / atol 1e-3 (RES_RTOL /
    RES_ATOL), the JAX package's own sharded-against-single tolerance
    (tests/test_sharded_ivf.py:337). The L2 expansion cancels data-scale
    terms (|q|^2 up to ~300-600 here) down to scores near 0, so one f32 ulp
    of a term is 3e-5 to 6e-5 of the score, and any other summation order
    moves it by a few. Readings (CPU): against the JAX package, the
    single-device indexes already differ by up to 2.4e-4 at S = 1, where
    nothing is sharded (two libraries' f32 products), and up to 4.9e-4
    after the files cross on S = 8; against its own single-device search,
    the port's sharded search differs by up to 9.2e-5 when it wraps the
    index (its bucket term an f32 product over a shard's [U_loc, D]) and
    by up to 4.9e-4 when it loads the files (the residual row terms then
    derived per shard)."""

import numpy as np

import quantization_tpu.core.types as j_types
import quantization_tpu.parallel.sharded_ivf as j_sivf
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded_ivf as t_sivf
from torch_ivf_cases import assert_search_matches
from torch_sharded_cases import meshes

DIM, K = 32, 10
RES_RTOL, RES_ATOL = 1e-4, 1e-3
FULL = 10**9  # nprobe / nscan past the bucket count: every bucket


def clustered(rng, count, dim=DIM, clusters=16, sigma=0.15):
    """tests/test_sharded_ivf.py's corpus."""
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (centers[assign] + sigma * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)


def res_corpus(rng, count=3000, dim=DIM):
    """tests/test_sharded_ivf.py's residual-regime corpus (6 centres x 3,
    sigma 0.3) and 8 queries drawn from it."""
    centers = rng.standard_normal((6, dim)).astype(np.float32) * 3
    assign = rng.integers(0, 6, count)
    data = (centers[assign] + 0.3 * rng.standard_normal((count, dim)).astype(np.float32)
            ).astype(np.float32)
    return data, data[rng.choice(count, 8, replace=False)].astype(np.float32)


def jparams(n, dt="Dot", invert=False, dim=DIM):
    return j_types.VectorParameters(dim, n, j_types.DistanceType.from_json(dt), invert)


def tparams(jp):
    return qt.VectorParameters.from_json(jp.to_json())


def carry(jivf):
    """The port's single-device IVFIndex holding a JAX index's state."""
    qz, kind = jivf.quantizer, jivf.metadata.kind
    if kind == "sq":
        state = (np.asarray(qz.codes), np.asarray(qz.voffsets), qz.metadata.to_json())
    elif kind == "pq":
        state = (np.asarray(qz.codes), qz.metadata.to_json())
    else:
        state = (np.asarray(qz.planes), qz.metadata.to_json(), qz.store_type)
    return qt.ivf_from_numpy(state, jivf.bucket_ids, jivf.bucket_means,
                             jivf.metadata.to_json(), device="cpu")


def wrapped_ivf(jivf, s):
    """(JAX ShardedIVF, the port's single-device copy, the port's
    ShardedIVF) over s shards, all three holding jivf's state."""
    jm, tm = meshes(s)
    tivf = carry(jivf)
    return j_sivf.ShardedIVF(jivf, jm), tivf, t_sivf.ShardedIVF(tivf, tm)


def same_as_single(got, want, n, residual=False):
    """The port's sharded search against its single-device search over an
    ``n``-row corpus: values to the bit (residual: within RES_RTOL /
    RES_ATOL), ids equal where untied, each live id once and a row of the
    corpus."""
    _matches(got, want, n, exact=not residual, ties=False)


def same_as_jax(got, want, n, kind, residual=False):
    """The port's search against the JAX package's (module docstring)."""
    _matches(got, want, n, exact=False, ties=kind == "bq", residual=residual)


def _matches(got, want, n, *, exact, ties, residual=True):
    gs, gi = got
    ws, wi = (np.asarray(x) for x in want)
    if exact:
        np.testing.assert_array_equal(gs, ws)
    elif residual:
        np.testing.assert_allclose(gs, ws, rtol=RES_RTOL, atol=RES_ATOL)
        gs = ws  # values held above; ids as below
    assert_search_matches(gs, gi, ws, wi, n, ties=ties)
