"""The port's ShardedIVF full-union searches against the JAX package's and
against its own single-device IVFIndex, on the CPU, on S = 1, 3 and 8
shards (tests/torch_sharded_ivf_cases.py has the meshes, the carried state
and the tolerances): the full-union cases of tests/test_sharded_ivf.py per
family and their residual twins, fewer buckets than shards (some shards
hold only pad buckets) and the residual-BQ pad mask on every shard (ROADMAP
F33). The probe-limited cases are tests/test_torch_sharded_ivf_search.py.

A full union (nscan >= the bucket count) scans every bucket, so the port's
sharded result equals its single-device full probe: to the bit for a plain
index, each row's score being computed as on one device; within RES_RTOL /
RES_ATOL for a residual one, whose bucket term is a product of another
shape on each shard (tests/torch_sharded_ivf_cases.py states the readings)."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.ivf as j_ivf
from quantization_tpu_torch.models.ivf import NEG
from torch_sharded_cases import SHARDS
from torch_sharded_ivf_cases import (
    FULL, K, clustered, jparams, res_corpus, same_as_jax, same_as_single, wrapped_ivf,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


def searches(jsh, tivf, tsh, queries, **kw):
    """(JAX sharded, port single-device, port sharded) results of one search."""
    return (jsh.top_k(jsh.encode_query(queries), K, **kw),
            tivf.top_k(tivf.encode_query(queries), K, **kw),
            tsh.top_k(tsh.encode_query(queries), K, **kw))


def distinct(ids):
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_full_union_equals_single_device_and_jax(rng, kind, s):
    count = 700
    data, queries = clustered(rng, count), clustered(rng, 8)
    kw = {"chunk_size": 2} if kind == "pq" else {}
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer=kind, nlist=10, bucket_size=64,
                                 nprobe=10, **kw)
    want, single, got = searches(*wrapped_ivf(jivf, s), queries, nprobe=FULL, nscan=FULL)
    same_as_single(got, single, count)
    same_as_jax(got, want, count, kind)
    distinct(got[1])


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("kind", ["sq", "pq", "bq"])
def test_residual_full_union_equals_single_device_and_jax(rng, kind, s):
    """Residual indexes (SQ / PQ L2-inverted, BQ DOT; 6 buckets, so S = 8
    adds two pad buckets): the corr of each shard's union and the row terms
    re-laid per shard give the single-device values (module docstring);
    near-duplicate queries find live rows on a probe-limited search."""
    data, queries = res_corpus(rng)
    count = data.shape[0]
    jp = jparams(count, "Dot" if kind == "bq" else "L2", kind != "bq")
    kw = {"chunk_size": 2} if kind == "pq" else {}
    jivf = j_ivf.IVFIndex.encode(data, jp, quantizer=kind, nlist=6, bucket_size=512, nprobe=6,
                                 residual=True, **kw)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    want, single, got = searches(jsh, tivf, tsh, queries, nprobe=FULL, nscan=FULL)
    same_as_single(got, single, count, residual=True)
    same_as_jax(got, want, count, kind, residual=True)
    distinct(got[1])
    _, ids = tsh.top_k(tsh.encode_query(queries), K, nprobe=2)
    assert np.all(ids >= 0)


@pytest.mark.parametrize("kind", ["sq", "bq"])
def test_fewer_buckets_than_shards(rng, kind):
    """nlist 2 and buckets of 128 give 4 buckets over 8 shards: four shards
    hold only pad buckets, copies of real ones. Every search still equals
    the single-device one at the full union, with no id twice."""
    count, s = 500, 8
    data, queries = clustered(rng, count, clusters=2), clustered(rng, 8, clusters=2)
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer=kind, nlist=2,
                                 bucket_size=128, nprobe=2)
    jsh, tivf, tsh = wrapped_ivf(jivf, s)
    nb = tsh.metadata.nbuckets
    assert nb < s and tsh._b_loc == 1 and int(tsh._is_primary.sum()) == nb
    for method in ("exact", "approx"):
        want, single, got = searches(jsh, tivf, tsh, queries, method=method, nprobe=FULL,
                                     nscan=FULL)
        if method == "exact":
            same_as_single(got, single, count)
        same_as_jax(got, want, count, kind)
        distinct(got[1])


@pytest.mark.parametrize("s", SHARDS)
def test_residual_bq_pad_slots_score_neg_on_every_shard(rng, s):
    """ROADMAP F33: the port's sharded residual BQ scores a bucket's pad
    slots NEG through a per-slot rowadd on every shard, as its single-device
    index does (F25), so pads never crowd real rows out of a shard's kk2
    candidates; the JAX package's sharded class masks only their ids."""
    data, queries = res_corpus(rng)
    count = data.shape[0]
    jivf = j_ivf.IVFIndex.encode(data, jparams(count), quantizer="bq", nlist=6,
                                 bucket_size=512, nprobe=6, residual=True)
    _, tivf, tsh = wrapped_ivf(jivf, s)
    pad = (tsh.bucket_ids[tsh._old] < 0).reshape(s, -1)
    assert pad.any()
    for sh, ra in enumerate(tsh._rowadd.shards):
        nsl = pad.shape[1]
        want = np.where(pad[sh], np.float32(NEG), np.float32(0.0))
        np.testing.assert_array_equal(ra[:nsl].numpy(), want)
        assert (ra[nsl:].numpy() == np.float32(NEG)).all()
        assert (tsh._slot_ids.shards[sh].numpy().reshape(-1)[pad[sh]] == -1).all()
    for method in ("exact", "approx"):
        got = tsh.top_k(tsh.encode_query(queries), K, method=method, nscan=FULL, nprobe=FULL)
        single = tivf.top_k(tivf.encode_query(queries), K, method=method, nscan=FULL,
                            nprobe=FULL)
        if method == "exact":
            same_as_single(got, single, count, residual=True)
        distinct(got[1])
