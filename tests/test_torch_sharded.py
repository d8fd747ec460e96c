"""The port's sharded engines (quantization_tpu_torch/parallel/sharded.py)
against the JAX package's on the CPU: the cases of tests/test_sharded.py on
S = 1, 3 and 8 shards (tests/torch_sharded_cases.py), from the same seeded
numpy inputs, each package's sharded class wrapping the same state. Then the
mesh itself: make_mesh's devices and errors, and a ("shard", "qdp") grid.

Tolerances: SQ scores rtol 1e-6 / atol 1e-4, as the single-device SQ parity
test; BQ scores equal; PQ scores within the int8 LUT's 2 ulp of |score| +
|bias| (F14), the JAX side in Pallas interpret mode (QTPU_FORCE_PALLAS=1) so
both search with the int8 LUT; ids equal where untied. On every S the port's
sharded search equals its single-device search to the bit."""

import numpy as np
import pytest
import torch

import quantization_tpu.models.bq as j_bq
import quantization_tpu.models.pq as j_pq
import quantization_tpu.models.sq as j_sq
import quantization_tpu.parallel.sharded as j_sharded
import quantization_tpu_torch as qt
from quantization_tpu_torch.parallel import sharded as t_sharded
from torch_sharded_cases import (
    CPU,
    SHARDS,
    bit_equal,
    close,
    host,
    ids_up_to_ties,
    jax_pallas,
    lut_close,
    meshes,
    params,
    wrapped,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dt,invert", [("Dot", False), ("L1", True), ("L2", True)])
def test_sharded_topk_matches_single_device(rng, s, dt, invert):
    n, dim, q, k = 333, 40, 3, 7  # n deliberately not a multiple of any shard count
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((q, dim), dtype=np.float32)
    jp, _ = params(dim, n, dt, invert)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    ws, wi = js.top_k(jenc.encode_query(queries), k)
    teq = ts.encode_query(queries)
    gs, gi = ts.top_k(teq, k)
    close(gs, ws)
    ids_up_to_ties(gs, gi, ws, wi)
    ss, si = tenc.top_k(teq, k)
    bit_equal(gs, ss)
    ids_up_to_ties(gs, gi, ss, si)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bq_matches_single_device(rng, s):
    n, dim, k = 333, 70, 9
    data = np.sign(rng.random((n, dim), dtype=np.float32) - 0.5)
    queries = np.sign(rng.random((3, dim), dtype=np.float32) - 0.5)
    jp, _ = params(dim, n, "L2", True)
    jenc = j_bq.BinaryQuantizer.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    ws, wi = js.top_k(jenc.encode_query(queries), k)
    teq = ts.encode_query(queries)
    gs, gi = ts.top_k(teq, k)
    bit_equal(gs, ws)
    ids_up_to_ties(gs, gi, ws, wi)
    assert gi.max() < n
    bit_equal(gs, tenc.top_k(teq, k)[0])


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_pq_matches_single_device(rng, s, jax_pallas):
    n, dim, k = 300, 32, 7
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, _ = params(dim, n, "L2", True)
    jenc = j_pq.ProductQuantizer.encode(data, jp, chunk_size=4)
    js, tenc, ts = wrapped(jenc, s)
    ws, wi = js.top_k(jenc.encode_query(queries), k)
    teq = ts.encode_query(queries)
    gs, gi = ts.top_k(teq, k)
    lut_close(gs, ws, teq.lut)
    assert gi.max() < n
    ss, si = tenc.top_k(teq, k)
    bit_equal(gs, ss)
    ids_up_to_ties(gs, gi, ss, si)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_topk_quality(rng, s):
    n, dim = 1000, 64
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n, "L2", True)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    js, _, ts = wrapped(jenc, s)
    _, i = ts.top_k(ts.encode_query(queries), 10)
    want = host(qt.pairwise_score(torch.from_numpy(queries), torch.from_numpy(data),
                                  qt.DistanceType.L2, True))
    exact = np.argsort(-want, axis=1)[:, :10]
    for row in range(2):
        assert len(set(i[row]) & set(exact[row])) >= 8
    # No padded (out-of-range) indices may leak out.
    assert i.max() < n
    _, wi = js.top_k(jenc.encode_query(queries), 10)
    for row in range(2):
        assert len(set(i[row]) & set(np.asarray(wi)[row])) >= 9


# ------------------------------------------------------------------ the mesh


def test_make_mesh_takes_every_card_and_never_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(qt.NoDeviceError, match="devices="):
        t_sharded.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = t_sharded.make_mesh()
    assert mesh.shape == {"shard": 2}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert mesh.first_device == torch.device("cuda", 0)


def test_make_mesh_devices_and_errors():
    mesh = t_sharded.make_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"shard": 3} and mesh.size == 3
    assert mesh.shard_devices("shard") == [CPU] * 3
    assert t_sharded.make_mesh(2, devices=[CPU] * 3).shape == {"shard": 2}
    grid = t_sharded.make_mesh(axis_names=("shard", "qdp"), shape=(2, 3), devices=[CPU] * 6)
    assert grid.shape == {"shard": 2, "qdp": 3}
    assert grid.shard_devices("shard") == [CPU] * 2
    for kw in (dict(n_devices=4, devices=[CPU] * 3),
               dict(axis_names=("shard", "qdp"), devices=[CPU] * 4),
               dict(axis_names=("shard", "qdp"), shape=(3, 2), devices=[CPU] * 4)):
        with pytest.raises(qt.ArgumentsError):
            t_sharded.make_mesh(**kw)
    with pytest.raises(qt.ArgumentsError, match="no axis"):
        t_sharded.ShardedExactRescorer(np.zeros((4, 2), np.float32), qt.DistanceType.DOT,
                                       False, mesh, axis="qdp")


def test_make_mesh_gives_a_bare_cuda_device_its_index(monkeypatch):
    """A tensor on the card reports its index, so the mesh names the card
    the same way: per-device copies (a residual ShardedIVF's means) are
    looked up by a shard tensor's device."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = t_sharded.make_mesh(devices=["cuda"] * 2 + ["cuda:1", "cpu"])
    assert list(mesh.devices.flat) == [torch.device("cuda", 0)] * 2 + [
        torch.device("cuda", 1), CPU]


@pytest.mark.parametrize("s", SHARDS)
def test_grid_mesh_shards_along_its_axis_and_replicates(rng, s, tmp_path):
    """A ("shard", "qdp") grid (as __graft_entry__.py builds) shards the
    corpus along "shard", each shard once, on the first device of its row
    (no search reads a copy along "qdp" yet); searches and files equal the
    JAX package's grid, which replicates along "qdp", and the 1-D mesh."""
    n, dim, k = 500, 24, 6
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((4, dim), dtype=np.float32)
    jp, tp = params(dim, n)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    _, tenc, flat = wrapped(jenc, s)
    qdp = 2 if 2 * s <= 8 else 1  # the JAX grid lives on the 8 virtual devices
    jgrid = j_sharded.make_mesh(qdp * s, ("shard", "qdp"), (s, qdp))
    tgrid = t_sharded.make_mesh(axis_names=("shard", "qdp"), shape=(s, qdp),
                                devices=[CPU] * (qdp * s))
    ts = t_sharded.ShardedScalarQuantizer(tenc, tgrid)
    assert ts.n_shards == s and len(ts.codes.shards) == s
    teq = ts.encode_query(queries)
    gs, gi = ts.top_k(teq, k)
    bit_equal(gs, flat.top_k(teq, k)[0])
    ws, wi = j_sharded.ShardedScalarQuantizer(jenc, jgrid).top_k(jenc.encode_query(queries), k)
    close(gs, ws)
    ids_up_to_ties(gs, gi, ws, wi)
    ts.save(tmp_path / "grid.bin", tmp_path / "grid.json")
    tenc.save(tmp_path / "one.bin", tmp_path / "one.json")
    assert (tmp_path / "grid.bin").read_bytes() == (tmp_path / "one.bin").read_bytes()


# ----------------------------------------------- candidates, internal, approx


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_score_candidates_matches_single(rng, s):
    n, dim = 333, 40
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((3, dim), dtype=np.float32)
    jp, _ = params(dim, n)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    cand = rng.integers(0, n, (3, 16)).astype(np.int32)
    teq = ts.encode_query(queries)
    got = ts.score_candidates(teq, cand)
    close(got, js.score_candidates(jenc.encode_query(queries), cand))
    bit_equal(got, tenc.score_candidates(teq, cand))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("family", ["sq", "bq", "pq", "f32"])
def test_sharded_score_candidates_invalid_ids_neg_inf(rng, s, family):
    """Candidate ids owned by no shard (-1 padding / >= count) come back as
    -inf, not 0.0 — with invert metrics a 0.0 would outrank every real
    (negative) score. The owned ones equal the JAX package's sharded scores
    and, to the bit, the port's single-device ones (for BQ on the ids it
    owns: its single-device class wraps -1, ROADMAP F13)."""
    n, dim = 100, 16
    data = rng.random((n, dim), dtype=np.float32)
    queries = rng.random((2, dim), dtype=np.float32)
    jp, tp = params(dim, n, "L2", True)
    cand = np.array([[0, -1, 5, n, 7], [-1, -1, 2, 3, n + 10]], np.int32)
    valid = (cand >= 0) & (cand < n)
    if family == "f32":
        jm, tm = meshes(s)
        js = j_sharded.ShardedExactRescorer(data, j_sharded.DistanceType.L2, True, jm)
        ts = t_sharded.ShardedExactRescorer(data, qt.DistanceType.L2, True, tm)
        one = qt.ExactRescorer(data, qt.DistanceType.L2, True, device="cpu")
        jeq, teq = js.encode_query(queries), ts.encode_query(queries)
        want_one = one.score_candidates(teq, np.where(valid, cand, -1))
    else:
        jcls = {"sq": j_sq.ScalarQuantizerU8, "bq": j_bq.BinaryQuantizer,
                "pq": j_pq.ProductQuantizer}[family]
        jenc = jcls.encode(data, jp, chunk_size=4) if family == "pq" else jcls.encode(data, jp)
        js, tenc, ts = wrapped(jenc, s)
        jeq, teq = jenc.encode_query(queries), ts.encode_query(queries)
        want_one = tenc.score_candidates(teq, np.clip(cand, 0, n - 1))
    got = host(ts.score_candidates(teq, cand))
    assert np.all(np.isneginf(got[~valid]))
    np.testing.assert_array_equal(got[valid], host(want_one)[valid])
    want = host(js.score_candidates(jeq, cand))
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-4)
    assert np.all(np.isneginf(want[~valid]))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dt,invert", [("Dot", False), ("L2", True)])
def test_sharded_sq_score_internal_matches_single(rng, s, dt, invert):
    n, dim, p = 8 * 30 + 3, 32, 17
    data = rng.random((n, dim), dtype=np.float32)
    jp, _ = params(dim, n, dt, invert)
    jenc = j_sq.ScalarQuantizerU8.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    ia, ib = rng.integers(0, n, p), rng.integers(0, n, p)
    got = ts.score_internal_batch(ia, ib)
    close(got, js.score_internal_batch(ia, ib))
    bit_equal(got, tenc.score_internal_batch(ia, ib))
    assert ts.score_internal(int(ia[0]), int(ib[0])) == float(host(got)[0])


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_bq_score_internal_matches_single(rng, s):
    n, dim, p = 8 * 20 - 5, 64, 13
    data = rng.random((n, dim), dtype=np.float32) - 0.5
    jp, _ = params(dim, n)
    jenc = j_bq.BinaryQuantizer.encode(data, jp)
    js, tenc, ts = wrapped(jenc, s)
    ia, ib = rng.integers(0, n, p), rng.integers(0, n, p)
    got = ts.score_internal_batch(ia, ib)
    bit_equal(got, js.score_internal_batch(ia, ib))
    bit_equal(got, tenc.score_internal_batch(ia, ib))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_pq_score_internal_matches_single(rng, s, bits):
    n, dim, p = 8 * 25 + 1, 16, 11
    data = rng.random((n, dim), dtype=np.float32)
    jp, _ = params(dim, n)
    jenc = j_pq.ProductQuantizer.encode(data, jp, chunk_size=4, bits=bits)
    js, tenc, ts = wrapped(jenc, s)
    ia, ib = rng.integers(0, n, p), rng.integers(0, n, p)
    got = ts.score_internal_batch(ia, ib)
    close(got, js.score_internal_batch(ia, ib))
    bit_equal(got, tenc.score_internal_batch(ia, ib))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("family", ["sq", "bq", "pq"])
def test_sharded_topk_approx_method(rng, s, family):
    """Approx searches are the port's stride-class approx per shard with an
    exact merge: ids overlap the exact top-k by >= 0.8 (F6), and every
    value is the true score of its id."""
    n, dim, k = 3000, 32, 10
    data = rng.random((n, dim), dtype=np.float32) - 0.5
    queries = rng.random((4, dim), dtype=np.float32) - 0.5
    jp, _ = params(dim, n)
    jcls = {"sq": j_sq.ScalarQuantizerU8, "bq": j_bq.BinaryQuantizer,
            "pq": j_pq.ProductQuantizer}[family]
    jenc = jcls.encode(data, jp, chunk_size=4) if family == "pq" else jcls.encode(data, jp)
    _, tenc, ts = wrapped(jenc, s)
    teq = ts.encode_query(queries)
    es, _ = ts.top_k(teq, k)
    gs, gi = ts.top_k(teq, k, method="approx", recall_target=0.9)
    assert np.mean(gs >= es[:, -1:]) >= 0.8
    assert (gi >= 0).all() and (gi < n).all()
    assert all(len(set(r)) == k for r in gi)
    scores = host(tenc.score_batch(teq))
    np.testing.assert_array_equal(np.take_along_axis(scores, gi, axis=1), gs)
    with pytest.raises(qt.ArgumentsError):
        ts.top_k(teq, k, recall_target=1.5)


@pytest.mark.parametrize("s", SHARDS)
def test_merges_equal_one_top_k_over_every_row(rng, s):
    """The cross-shard tails: local_topk_merge over per-shard score matrices
    (the last one short, shards past count empty) and gathered_topk_merge of
    per-shard candidates equal torch.topk over the valid rows, ids equal
    where untied, -inf / -1 past the live rows; a tie resolves to the
    earlier shard, as jax.lax.top_k resolves it over the gathered columns."""
    n_local, count, k = 40, 37 * s, 12
    scores = torch.from_numpy(rng.standard_normal((5, n_local * s)).astype(np.float32))
    parts = [scores[:, i * n_local: min((i + 1) * n_local, count)] for i in range(s)]
    gs, gi = t_sharded.local_topk_merge(parts, "shard", k, count, n_local=n_local)
    ws, wi = torch.topk(scores[:, :count], min(k, count), dim=1)
    bit_equal(gs[:, : ws.shape[1]], ws)
    ids_up_to_ties(gs[:, : ws.shape[1]], gi[:, : ws.shape[1]], ws, wi)
    gs, gi = t_sharded.local_topk_merge(parts, "shard", count + 3, count, n_local=n_local)
    assert bool(torch.isneginf(gs[:, count:]).all()) and bool((gi[:, count:] == -1).all())
    tied = [torch.zeros((2, 3)) for _ in range(s)]
    ids = [torch.arange(3, dtype=torch.int32).expand(2, 3) + i * n_local for i in range(s)]
    _, ti = t_sharded.gathered_topk_merge(tied, ids, "shard", 4)
    bit_equal(ti, torch.tensor([[0, 1, 2, n_local]] * 2 if s > 1 else [[0, 1, 2, -1]] * 2))
