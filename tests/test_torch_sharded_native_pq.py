"""The port's sharded-native PQ ingestion and per-shard PQ checkpoints
against the JAX package's, on the CPU: the PQ encode and checkpoint cases of
tests/test_sharded_native.py (8- and 4-bit) and tests/test_opq.py:208, on
S = 1, 3 and 8 shards (tests/torch_sharded_cases.py), with files crossing
the packages both ways. A file of its own, since k-means on one CPU thread
makes it the slowest of the sharded tests.

The streaming encode's centroids, rotation and codes equal the port's
single-device encode's to the bit; the PQ centroids of the two packages
agree to 1e-4 of their scale (k-means sums round in another order), so
searches cross on carried state. The JAX side runs Pallas in interpret
mode (QTPU_FORCE_PALLAS=1), searching with the int8 LUT as the port does."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.pq as j_pq
import quantization_tpu.parallel.sharded as j_sharded
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from test_opq import lowrank_data
from torch_sharded_cases import (
    SHARDS, bit_equal, host, ids_up_to_ties, jax_pallas, meshes, params, wrapped,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_pq_encode_matches_single_device(rng, s, bits, jax_pallas):
    n, dim, k = 300, 32, 7
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n, "L2", True)
    jm, tm = meshes(s)
    tsh = t_sharded.ShardedProductQuantizer.encode(data, tp, chunk_size=4, mesh=tm, bits=bits)
    single = qt.ProductQuantizer.encode(data, tp, chunk_size=4, bits=bits, device="cpu")
    bit_equal(tsh.metadata.centroids, single.metadata.centroids)
    bit_equal(tsh.codes_t.numpy()[:, :n], single.codes_t.numpy()[:, :n])
    teq = tsh.encode_query(queries)
    gs, gi = tsh.top_k(teq, k)
    bit_equal(gs, single.top_k(single.encode_query(queries), k)[0])
    assert gi.max() < n
    jsh = j_sharded.ShardedProductQuantizer.encode(data, jp, chunk_size=4, mesh=jm, bits=bits)
    jc = np.asarray(jsh.metadata.centroids)
    np.testing.assert_allclose(tsh.metadata.centroids, jc, rtol=0,
                               atol=1e-4 * np.abs(jc).max())


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_pq_save_load_roundtrip(rng, s, bits, tmp_path, jax_pallas):
    """8-bit and 4-bit (two codes per byte on disk, the single-device
    format) files across packages and layouts."""
    n, dim, k = 160, 16, 5
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n, "L2", True)
    jenc = j_pq.ProductQuantizer.encode(data, jp, chunk_size=2, bits=bits)
    jsh, tenc, tsh = wrapped(jenc, s)
    jm, tm = meshes(s)
    jsh.save(tmp_path / "j.bin", tmp_path / "j.json")
    tsh.save(tmp_path / "t.bin", tmp_path / "t.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_size == n * (tsh.num_chunks if bits == 8
                                                       else (tsh.num_chunks + 1) // 2)
    teq = tsh.encode_query(queries)
    s0, i0 = tsh.top_k(teq, k)
    back = t_sharded.ShardedProductQuantizer.load(tmp_path / "j.bin", tmp_path / "j.json", tp,
                                                  tm)
    bit_equal(back.codes_t.numpy(), tsh.codes_t.numpy())
    bit_equal(back.top_k(back.encode_query(queries), k)[0], s0)
    single = qt.ProductQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json", tp, device="cpu")
    bit_equal(single.top_k(single.encode_query(queries), k)[0], s0)
    # The JAX package's sharded load of the port's file searches as the JAX
    # quantizer it was carried from (bit for bit; the two packages' 4-bit
    # int8 scores differ by ulps, which tests/test_torch_pq_model.py holds).
    jback = j_sharded.ShardedProductQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json", jp,
                                                   jm)
    ws, wi = jsh.top_k(jsh.encode_query(queries), k)
    gs, gi = jback.top_k(jback.encode_query(queries), k)
    bit_equal(gs, ws)
    bit_equal(gi, wi)
    tenc.save(tmp_path / "one.bin", tmp_path / "one.json")
    again = t_sharded.ShardedProductQuantizer.load(tmp_path / "one.bin",
                                                   tmp_path / "one.json", tp, tm)
    bit_equal(again.codes_t.numpy(), tsh.codes_t.numpy())


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_opq_matches_single_device(rng, s, tmp_path):
    """tests/test_opq.py:208 in the port: same data + seed give the same
    rotation, centroids and codes on the sharded-native path, and the
    sharded blob loads into the single-device classes of both packages
    with the rotation intact."""
    dim, count = 32, 1200
    data = lowrank_data(rng, count, dim)
    queries = lowrank_data(rng, 16, dim)
    jp, tp = params(dim, count)
    _, tm = meshes(s)
    single = qt.ProductQuantizer.encode(data, tp, chunk_size=4, rotation="opq", seed=3,
                                        device="cpu")
    shard = t_sharded.ShardedProductQuantizer.encode(data, tp, chunk_size=4, rotation="opq",
                                                     seed=3, mesh=tm)
    bit_equal(shard.metadata.rotation, single.metadata.rotation)
    k = 10
    sv, si = single.top_k(single.encode_query(queries), k)
    hv, hi = shard.top_k(shard.encode_query(queries), k)
    bit_equal(hv, sv)
    ids_up_to_ties(hv, hi, sv, si)
    shard.save(tmp_path / "d.bin", tmp_path / "m.json")
    back = qt.ProductQuantizer.load(tmp_path / "d.bin", tmp_path / "m.json", tp, device="cpu")
    assert back.metadata.rotation is not None
    bv, bi = back.top_k(back.encode_query(queries), k)
    bit_equal(bv, sv)
    jback = j_pq.ProductQuantizer.load(tmp_path / "d.bin", tmp_path / "m.json", jp)
    bit_equal(np.asarray(jback.metadata.rotation), shard.metadata.rotation)
    assert host(hi).max() < count
