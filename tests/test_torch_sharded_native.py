"""The port's sharded-native ingestion and per-shard checkpoints against the
JAX package's, on the CPU: the encode and checkpoint cases of
tests/test_sharded_native.py on S = 1, 3 and 8 shards
(tests/torch_sharded_cases.py), with files crossing the packages both ways;
the PQ encode and checkpoint cases, whose k-means takes longer on one CPU
thread, are tests/test_torch_sharded_native_pq.py.

Tie-free fixtures (the JAX tests' ``tie_free_data``) let the index-exact
cases assert ids, pinning the global-id arithmetic (an off-by-shard bug hides
behind score-only assertions). Codes of the streaming encoders are
byte-equal to the JAX package's and to the port's single-device encode.
Score tolerances as in tests/test_torch_sharded.py."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.bq as j_bq
import quantization_tpu.models.pq as j_pq
import quantization_tpu.models.sq as j_sq
import quantization_tpu.parallel.sharded as j_sharded
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from test_sharded_native import stream_of, tie_free_data
from torch_sharded_cases import (
    SHARDS,
    bit_equal,
    close,
    ids_up_to_ties,
    jax_pallas,
    meshes,
    params,
    wrapped,
)

torch.set_num_threads(1)


# ------------------------------------------------------------ index-exact


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n", [8 * 40 - 1, 8 * 40, 8 * 40 + 1])
def test_sharded_sq_index_exact_across_boundaries(rng, s, n):
    dim, q, k = 24, 3, 7
    data = tie_free_data(n, dim, rng)
    queries = 0.5 + 0.5 * rng.random((q, dim), dtype=np.float32)
    jp, _ = params(dim, n)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    _, wi = js.top_k(jenc.encode_query(queries), k)
    gs, gi = ts.top_k(ts.encode_query(queries), k)
    bit_equal(gi, wi)
    bit_equal(gs, tenc.top_k(tenc.encode_query(queries), k)[0])


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bq_index_exact(rng, s):
    n, dim, k = 65, 64, 5
    data = np.full((n, dim), -1.0, np.float32)
    for i in range(n):
        data[i, : min(i, dim)] = 1.0
    queries = np.full((2, dim), 1.0, np.float32)
    jp, _ = params(dim, n)
    jenc = j_bq.BinaryQuantizer.encode(data, jp)
    js, _, ts = wrapped(jenc, s)
    _, wi = js.top_k(jenc.encode_query(queries), k)
    bit_equal(ts.top_k(ts.encode_query(queries), k)[1], wi)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_pq_index_exact(rng, s, jax_pallas):
    n, dim, k = 80, 16, 6
    data = tie_free_data(n, dim, rng)
    queries = 0.5 + 0.5 * rng.random((2, dim), dtype=np.float32)
    jp, _ = params(dim, n)
    jenc = j_pq.ProductQuantizer.encode(data, jp, chunk_size=4)
    js, _, ts = wrapped(jenc, s)
    _, wi = js.top_k(jenc.encode_query(queries), k)
    bit_equal(ts.top_k(ts.encode_query(queries), k)[1], wi)


# ----------------------------------------------------- sharded-native encode


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_sq_encode_matches_single_device(rng, s):
    n, dim, q, k = 333, 40, 3, 7
    data = tie_free_data(n, dim, rng)
    queries = 0.5 + 0.5 * rng.random((q, dim), dtype=np.float32)
    jp, tp = params(dim, n)
    jm, tm = meshes(s)
    # Encode from a stream, never materializing the corpus on one device.
    jsh = j_sharded.ShardedScalarQuantizer.encode(stream_of(data, 50), jp, jm, batch_size=50)
    tsh = t_sharded.ShardedScalarQuantizer.encode(stream_of(data, 50), tp, tm, batch_size=50)
    single = qt.ScalarQuantizerU8.encode(data, tp, device="cpu")
    assert tsh.metadata.to_json() == jsh.metadata.to_json() == single.metadata.to_json()
    bit_equal(tsh.codes.numpy()[:n], np.asarray(jsh.codes)[:n])
    bit_equal(tsh.voffsets.numpy()[:n], np.asarray(jsh.voffsets)[:n])
    bit_equal(tsh.codes.numpy()[:n], single.codes.numpy()[:n])
    assert not tsh.codes.numpy()[n:].any()
    _, wi = jsh.top_k(jsh.encode_query(queries), k)
    gs, gi = tsh.top_k(tsh.encode_query(queries), k)
    bit_equal(gi, wi)
    bit_equal(gs, single.top_k(single.encode_query(queries), k)[0])
    # The code buffer really is sharded over the mesh.
    assert tsh.codes.n_shards == s and tsh.codes.n_local * s == tsh.codes.shape[0]
    assert all(t.shape[0] == tsh.codes.n_local for t in tsh.codes.shards)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_sq_encode_quantile_and_l2(rng, s):
    n, dim = 170, 33
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n, "L2", True)
    jm, tm = meshes(s)
    jsh = j_sharded.ShardedScalarQuantizer.encode(data, jp, jm, quantile=0.99)
    tsh = t_sharded.ShardedScalarQuantizer.encode(data, tp, tm, quantile=0.99)
    assert tsh.metadata.to_json() == jsh.metadata.to_json()
    bit_equal(tsh.codes.numpy()[:n], np.asarray(jsh.codes)[:n])
    ws, wi = jsh.top_k(jsh.encode_query(queries), 5)
    gs, gi = tsh.top_k(tsh.encode_query(queries), 5)
    close(gs, ws)
    ids_up_to_ties(gs, gi, ws, wi)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_encode_cancellation_and_count_checks(rng, s):
    n, dim = 200, 16
    data = rng.random((n, dim), dtype=np.float32)
    _, tp = params(dim, n)
    _, tm = meshes(s)
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] > 3

    with pytest.raises(qt.StoppedError):
        t_sharded.ShardedScalarQuantizer.encode(data, tp, tm, stop_condition=stop,
                                                batch_size=10)
    _, short = params(8, 30)
    for cls in (t_sharded.ShardedScalarQuantizer, t_sharded.ShardedBinaryQuantizer):
        with pytest.raises(qt.ArgumentsError, match="count"):
            cls.encode(data[:20, :8], short, tm)
        with pytest.raises(qt.ArgumentsError, match="dim"):
            cls.encode(data[:30], short, tm)
    with pytest.raises(qt.ArgumentsError, match="count"):
        t_sharded.ShardedProductQuantizer.encode(data[:20, :8], short, 4, tm)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bq_encode_matches_single_device(rng, s):
    n, dim, k = 260, 70, 9
    data = np.sign(rng.random((n, dim), dtype=np.float32) - 0.5)
    queries = np.sign(rng.random((3, dim), dtype=np.float32) - 0.5)
    jp, tp = params(dim, n, "L2", True)
    jm, tm = meshes(s)
    jsh = j_sharded.ShardedBinaryQuantizer.encode(stream_of(data, 37), jp, jm)
    tsh = t_sharded.ShardedBinaryQuantizer.encode(stream_of(data, 37), tp, tm)
    single = qt.BinaryQuantizer.encode(data, tp, device="cpu")
    words = tsh.planes.numpy().view(np.uint32)
    bit_equal(words[:, :n], np.asarray(jsh.planes)[:, :n])
    bit_equal(words[:, :n], single.planes.numpy().view(np.uint32)[:, :n])
    ws, wi = jsh.top_k(jsh.encode_query(queries), k)
    gs, gi = tsh.top_k(tsh.encode_query(queries), k)
    bit_equal(gs, ws)
    ids_up_to_ties(gs, gi, ws, wi)
    assert gi.max() < n


# ------------------------------------------------------- sharded checkpoint


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_sq_save_load_roundtrip(rng, s, tmp_path):
    """Files cross both packages and both layouts: the port's sharded save
    is the JAX sharded save byte for byte, and each side loads the other's."""
    n, dim, k = 137, 40, 5
    data = tie_free_data(n, dim, rng)
    queries = 0.5 + 0.5 * rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n)
    jm, tm = meshes(s)
    jsh = j_sharded.ShardedScalarQuantizer.encode(data, jp, jm)
    tsh = t_sharded.ShardedScalarQuantizer.encode(data, tp, tm)
    jsh.save(tmp_path / "j.bin", tmp_path / "j.json")
    tsh.save(tmp_path / "t.bin", tmp_path / "t.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    s0, i0 = tsh.top_k(tsh.encode_query(queries), k)
    # JAX sharded save -> the port's sharded and single-device loads
    back = t_sharded.ShardedScalarQuantizer.load(tmp_path / "j.bin", tmp_path / "j.json", tp,
                                                 tm)
    s1, i1 = back.top_k(back.encode_query(queries), k)
    bit_equal(i1, i0)
    bit_equal(s1, s0)
    single = qt.ScalarQuantizerU8.load(tmp_path / "j.bin", tmp_path / "j.json", tp,
                                       device="cpu")
    bit_equal(single.top_k(single.encode_query(queries), k)[1], i0)
    # the port's sharded save -> the JAX package's sharded and single loads
    jback = j_sharded.ShardedScalarQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json",
                                                  jp, jm)
    bit_equal(jback.top_k(jback.encode_query(queries), k)[1], i0)
    jone = j_sq.ScalarQuantizerU8.load(tmp_path / "t.bin", tmp_path / "t.json", jp)
    bit_equal(jone.top_k(jone.encode_query(queries), k)[1], i0)
    # single-device save -> sharded load
    single.save(tmp_path / "one.bin", tmp_path / "one.json")
    again = t_sharded.ShardedScalarQuantizer.load(tmp_path / "one.bin", tmp_path / "one.json",
                                                  tp, tm)
    bit_equal(again.codes.numpy(), tsh.codes.numpy())
    with pytest.raises(qt.StorageIOError):
        t_sharded.ShardedScalarQuantizer.load(tmp_path / "one.bin", tmp_path / "one.json",
                                              params(dim, n + 1)[1], tm)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bq_save_load_roundtrip(rng, s, tmp_path):
    n, dim, k = 90, 70, 5
    data = np.sign(rng.random((n, dim), dtype=np.float32) - 0.5)
    queries = np.sign(rng.random((2, dim), dtype=np.float32) - 0.5)
    jp, tp = params(dim, n, "L2", True)
    jm, tm = meshes(s)
    jsh = j_sharded.ShardedBinaryQuantizer.encode(data, jp, jm)
    tsh = t_sharded.ShardedBinaryQuantizer.encode(data, tp, tm)
    jsh.save(tmp_path / "j.bin", tmp_path / "j.json")
    tsh.save(tmp_path / "t.bin", tmp_path / "t.json")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    s0, _ = tsh.top_k(tsh.encode_query(queries), k)
    back = t_sharded.ShardedBinaryQuantizer.load(tmp_path / "j.bin", tmp_path / "j.json", tp,
                                                 tm)
    bit_equal(back.top_k(back.encode_query(queries), k)[0], s0)
    single = qt.BinaryQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json", tp, device="cpu")
    bit_equal(single.top_k(single.encode_query(queries), k)[0], s0)
    jback = j_sharded.ShardedBinaryQuantizer.load(tmp_path / "t.bin", tmp_path / "t.json", jp,
                                                  jm)
    bit_equal(jback.top_k(jback.encode_query(queries), k)[0], s0)
