"""Shared cases of the IVF parity tests (tests/test_torch_ivf_model.py and
tests/test_torch_ivf_search.py): seeded clustered data, the JAX package's
indexes of each configuration, and the port's copy of each, carried across
by ``ivf_from_numpy``."""

import zlib

import numpy as np

import quantization_tpu.core.types as j_types
import quantization_tpu.models.ivf as j_ivf
import quantization_tpu_torch as qt

DIM, N, K = 32, 3000, 10


def clustered(rng, count, dim=DIM, clusters=8, sigma=0.08):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, count)
    return (centers[assign] + sigma * rng.standard_normal((count, dim))).astype(np.float32)


def jparams(dt, invert, n=N):
    return j_types.VectorParameters(DIM, n, j_types.DistanceType.from_json(dt), invert)


def inner_state(jivf):
    qz, kind = jivf.quantizer, jivf.metadata.kind
    if kind == "sq":
        return np.asarray(qz.codes), np.asarray(qz.voffsets), qz.metadata.to_json()
    if kind == "pq":
        return np.asarray(qz.codes), qz.metadata.to_json()
    return np.asarray(qz.planes), qz.metadata.to_json(), qz.store_type


def carry(jivf):
    return qt.ivf_from_numpy(inner_state(jivf), jivf.bucket_ids, jivf.bucket_means,
                             jivf.metadata.to_json(), device="cpu")


# name -> (kind, residual, metric, invert, bucket_size, quantizer kwargs)
CONFIGS = {
    "sq": ("sq", False, "Dot", False, 512, {}),
    "sq_l2_inv": ("sq", False, "L2", True, 1024, {}),
    "sq_res_l2": ("sq", True, "L2", False, 512, {}),
    "pq": ("pq", False, "Dot", False, 1024, {"chunk_size": 4}),
    "pq_res": ("pq", True, "Dot", False, 512, {"chunk_size": 4}),
    "opq_res_l2": ("pq", True, "L2", False, 1024, {"chunk_size": 4, "rotation": "opq"}),
    "pq4_res": ("pq", True, "Dot", False, 1024, {"chunk_size": 2, "bits": 4}),
    "bq": ("bq", False, "Dot", False, 512, {}),
    "bq_res": ("bq", True, "Dot", False, 512, {}),
}


def index(built, name):
    """(JAX index, the port's copy of it, queries), built once per module."""
    if name not in built:
        kind, residual, dt, invert, bucket, kw = CONFIGS[name]
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        data, queries = clustered(rng, N), clustered(rng, 8)
        jivf = j_ivf.IVFIndex.encode(data, jparams(dt, invert), quantizer=kind, nlist=8,
                                     bucket_size=bucket, nprobe=3, residual=residual,
                                     seed=1, **kw)
        built[name] = (jivf, carry(jivf), queries, data)
    return built[name]


def assert_search_matches(gs, gi, ws, wi, n, ties):
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)
    for r in range(gs.shape[0]):
        live = gi[r] >= 0
        assert ((gi[r][live] < n)).all() and len(set(gi[r][live].tolist())) == int(live.sum())
        np.testing.assert_array_equal(live, wi[r] >= 0)
        if not ties:
            vals, counts = np.unique(ws[r], return_counts=True)
            untied = np.isin(ws[r], vals[counts == 1]) & (ws[r] != ws[r][-1])
            np.testing.assert_array_equal(gi[r][untied], wi[r][untied])
