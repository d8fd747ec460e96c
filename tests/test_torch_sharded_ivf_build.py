"""The port's sharded-native IVF build and its four-file checkpoints against
the JAX package's, on the CPU: ``ShardedIVF.encode`` of one stream in both
packages (SQ, PQ, BQ; plain and residual), the files in every direction
between the two packages' sharded and single-device classes, the
round-robin layout, and ``DeviceScatter`` across shard boundaries.

Build parity is held on well-separated clusters whose first rows are one
per cluster, with the whole corpus as the training sample, so k-means
starts from a centre per cluster and no row lies near two centres (ROADMAP
F21): the bucket ids are equal; the bucket means agree to 1e-6 (both f32
scatter-add sums, in each library's order); plain SQ codes and offsets and
plain BQ planes are byte-equal; a residual code may differ where a mean's
last ulp moves its residual across a code step, and then by one step (SQ)
or one sign bit (BQ), on at most RESIDUAL_FLIPS of the entries; PQ codes
agree but for k-means near-ties of the two packages' centroids (under 1 %,
ROADMAP F16). Searches over the files compare as
tests/torch_sharded_ivf_cases.py says."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.ivf as j_ivf
import quantization_tpu.parallel.sharded_ivf as j_sivf
import quantization_tpu.utils.device_store as j_store
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded_ivf as t_sivf
from quantization_tpu_torch.utils.device_store import DeviceScatter
from torch_sharded_cases import SHARDS, CPU, meshes
from torch_sharded_ivf_cases import (
    DIM, FULL, K, jparams, same_as_jax, same_as_single, tparams, wrapped_ivf,
)

torch.set_num_threads(1)

# Share of residual code entries a mean's last ulp may move by one step.
RESIDUAL_FLIPS = 1e-3


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


def separated(rng, n=500, clusters=8):
    centers = rng.standard_normal((clusters, DIM)).astype(np.float32) * 4
    assign = rng.integers(0, clusters, n)
    assign[:clusters] = np.arange(clusters)
    data = (centers[assign] + 0.05 * rng.standard_normal((n, DIM))).astype(np.float32)
    return data, (centers[rng.integers(0, clusters, 8)]
                  + 0.05 * rng.standard_normal((8, DIM))).astype(np.float32)


def stream_of(data, batch=128):
    def stream():
        for b0 in range(0, data.shape[0], batch):
            yield data[b0:b0 + batch]
    return stream


def global_inner(arr, nsl, dim):
    """A ShardedArray's live slots, shard after shard: the JAX layout."""
    return np.concatenate([t.narrow(dim, 0, nsl).numpy() for t in arr.shards], axis=dim)


BUILDS = [  # (kind, residual, metric, invert, S)
    ("sq", False, "Dot", False, 1), ("sq", False, "L2", True, 3), ("sq", True, "L2", True, 8),
    ("pq", False, "Dot", False, 8), ("pq", True, "L2", False, 3),
    ("bq", False, "Dot", False, 8), ("bq", True, "Dot", False, 3), ("bq", False, "Dot", False, 1),
]


@pytest.mark.parametrize("kind,residual,dt,invert,s", BUILDS)
def test_streaming_build_equals_jax(rng, kind, residual, dt, invert, s):
    data, queries = separated(rng)
    n = data.shape[0]
    jp = jparams(n, dt, invert)
    jm, tm = meshes(s)
    kw = dict(quantizer=kind, nlist=8, bucket_size=512 if residual else 64, residual=residual,
              nprobe=8, **({"chunk_size": 8} if kind == "pq" else {}))
    jsh = j_sivf.ShardedIVF.encode(stream_of(data), jp, mesh=jm, **kw)
    tsh = t_sivf.ShardedIVF.encode(stream_of(data), tparams(jp), mesh=tm, **kw)
    np.testing.assert_array_equal(tsh.bucket_ids, jsh.bucket_ids)
    np.testing.assert_allclose(tsh.bucket_means, jsh.bucket_means, rtol=1e-6, atol=1e-6)
    got_meta, want_meta = tsh.metadata.to_json(), jsh.metadata.to_json()
    if residual and kind == "bq":
        assert got_meta.pop("residual_scale") == pytest.approx(want_meta.pop("residual_scale"),
                                                               rel=1e-6)
    assert got_meta == want_meta
    assert tsh.inner_meta.to_json().keys() == jsh.inner_meta.to_json().keys()
    # Each shard holds its b_loc buckets' slots (BQ's planes padded to the
    # kernels' 2048-column tile), never the corpus.
    b_loc, ss = tsh._b_loc, tsh.metadata.bucket_size
    nsl = b_loc * ss
    dim = 1 if kind == "bq" else 0
    for t in tsh._inner[0].shards:
        assert t.shape[dim] == (nsl if kind != "bq" else nsl + (-nsl) % 2048)
    got = global_inner(tsh._inner[0], nsl, dim)
    want = np.asarray(jsh._inner[0])
    if kind == "pq":
        m = len(tsh.inner_meta.vector_division)
        assert (got[:, :m] != want[:, :m]).mean() < 0.01
        return
    got = got.view(want.dtype)
    if not residual:
        np.testing.assert_array_equal(got, want)
        if kind == "sq":
            np.testing.assert_array_equal(global_inner(tsh._inner[1], nsl, 0),
                                          np.asarray(jsh._inner[1]))
        return
    diff = got.astype(np.int64) - want.astype(np.int64)
    if kind == "bq":  # one sign bit per differing word
        flips = np.unpackbits((got ^ want).view(np.uint8)).sum()
        assert flips <= RESIDUAL_FLIPS * got.size * 32
    else:
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= RESIDUAL_FLIPS
        np.testing.assert_allclose(global_inner(tsh._voff_inner, nsl, 0),
                                   np.asarray(jsh._voff_inner), rtol=1e-5, atol=1e-3)


FILES = [("sq", False, 3), ("pq", False, 8), ("bq", False, 1), ("sq", True, 8), ("pq", True, 3),
         ("bq", True, 8)]


@pytest.mark.parametrize("kind,residual,s", FILES)
def test_files_cross_packages_and_classes(rng, tmp_path, kind, residual, s):
    """The four files in every direction: the port's sharded save loads into
    the port's IVFIndex (the full union equal to the sharded one) and into
    the JAX package's; the JAX package's sharded and single-device saves
    load into the port's ShardedIVF, which then searches as the JAX index
    it was saved from."""
    data, queries = separated(rng)
    n = data.shape[0]
    dt, invert = ("Dot", False) if kind == "bq" or not residual else ("L2", True)
    jp = jparams(n, dt, invert)
    tp = tparams(jp)
    kw = dict(quantizer=kind, nlist=8, bucket_size=512 if residual else 64, residual=residual,
              nprobe=8, **({"chunk_size": 4} if kind == "pq" else {}))
    jivf = j_ivf.IVFIndex.encode(data, jp, **kw)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    _, tm = meshes(s)
    full = dict(nprobe=FULL, nscan=FULL)
    got = tsh.top_k(tsh.encode_query(queries), K, **full)

    def paths(tag):
        return tmp_path / f"{tag}.data", tmp_path / f"{tag}.meta"

    tsh.save(*paths("port_sharded"))
    single = qt.IVFIndex.load(*paths("port_sharded"), tp, device="cpu")
    same_as_single(got, single.top_k(single.encode_query(queries), K, **full), n,
                   residual=residual)
    jback = j_ivf.IVFIndex.load(*paths("port_sharded"), jp)
    np.testing.assert_array_equal(jback.bucket_ids, jivf.bucket_ids)
    same_as_jax(got, jback.top_k(jback.encode_query(queries), K, **full), n, kind, residual)
    tivf.save(*paths("port_single"))
    assert paths("port_single")[0].read_bytes() == paths("port_sharded")[0].read_bytes()
    for tag, jidx in (("jax_sharded", jsh), ("jax_single", jivf)):
        jidx.save(*paths(tag))
        back = t_sivf.ShardedIVF.load(*paths(tag), tp, mesh=tm)
        res = back.top_k(back.encode_query(queries), K, **full)
        same_as_single(res, got, n, residual=residual)
        same_as_jax(res, jidx.top_k(jidx.encode_query(queries), K, **full), n, kind, residual)


def test_round_robin_layout_equals_jax():
    for b in range(1, 41):
        for ns in range(1, 10):
            got = t_sivf._round_robin_layout(b, ns)
            want = j_sivf._round_robin_layout(b, ns)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            old, prim, b_loc, b_pad = got
            assert b_pad == b_loc * ns >= b and sorted(old[prim].tolist()) == list(range(b))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("axis", [0, 1])
def test_device_scatter_across_shard_boundaries(rng, s, axis):
    """scatter, add (repeated positions sum), fill_from (sources and
    destinations on other shards) and finish, against numpy and the JAX
    package's DeviceScatter; each shard is one tensor on its device."""
    mesh = meshes(s)[1]
    n, w = 6 * s, 3
    shape = (n, w) if axis == 0 else (w, n)
    want = np.zeros(shape, np.float32)
    st = DeviceScatter(shape, torch.float32, mesh=mesh, axis=axis)
    jst = j_store.DeviceScatter(shape, np.float32, axis=axis)
    ref = np.moveaxis(want, axis, 0)  # a view: rows along the scatter axis

    def rows(k):
        r = rng.standard_normal((k, w)).astype(np.float32)
        return r, torch.from_numpy(np.ascontiguousarray(np.moveaxis(r, 0, axis)))

    idx = rng.permutation(n)[: n - 1]
    r, t = rows(idx.size)
    st.scatter(t, idx)
    jst.scatter(t.numpy(), idx)
    ref[idx] = r
    idx = rng.integers(0, n, 2 * n)  # repeats
    r, t = rows(idx.size)
    st.add(t, idx)
    jst.add(t.numpy(), idx)
    np.add.at(ref, idx, r)
    dst = rng.permutation(n)[:s]
    src = np.setdiff1d(np.arange(n), dst)[rng.integers(0, n - s, s)]
    st.fill_from(dst, src)
    jst.fill_from(dst, src)
    ref[dst] = ref[src]
    out = st.finish()
    assert out.n_shards == s and all(t.device == CPU for t in out.shards)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jst.finish()), rtol=1e-6, atol=1e-6)
    one = DeviceScatter(shape, torch.float32, mesh=meshes(1)[1], axis=axis)
    one.scatter(torch.ones(shape), np.arange(n))
    out = one.finish()
    assert out.n_shards == 1 and (out.numpy() == 1).all()
    with pytest.raises(ValueError):
        DeviceScatter((5, 3), torch.float32, mesh=mesh, axis=2)
    if s > 1:
        with pytest.raises(ValueError, match="shards"):
            DeviceScatter((n + 1, w), torch.float32, mesh=mesh)


def test_streamed_index_matches_the_carried_jax_build(rng):
    """The port's streamed sharded IVF-SQ searches as the JAX package's
    streamed one: same buckets and codes, so the full-union values agree."""
    data, queries = separated(rng)
    n = data.shape[0]
    jp = jparams(n)
    jm, tm = meshes(3)
    kw = dict(quantizer="sq", nlist=8, bucket_size=64, nprobe=8)
    jsh = j_sivf.ShardedIVF.encode(data, jp, mesh=jm, **kw)
    tsh = t_sivf.ShardedIVF.encode(data, tparams(jp), mesh=tm, **kw)
    got = tsh.top_k(tsh.encode_query(queries), K, nprobe=FULL, nscan=FULL)
    same_as_jax(got, jsh.top_k(jsh.encode_query(queries), K, nprobe=FULL, nscan=FULL), n, "sq")
