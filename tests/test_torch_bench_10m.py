"""The 10M harness's passes (bench/bench_10m.py) against the JAX package on
one small corpus made by the port's RowSource, each encoder fed the same
rows on both sides:

  * pass B's streamed SQ codes equal the JAX package's ``quantize_batch``
    byte for byte (offsets within 1e-6), pass A's BQ planes the JAX
    harness's ``pack_bq`` to the bit;
  * PQ codes equal the JAX package's ``encode_batch`` but for near-ties
    (ROADMAP F16: the two argmins meet centroids at equal distance);
  * the streamed exact top-K equals an f64 oracle: values within 1e-5
    (f32 scores), ids where the oracle's scores stand apart;
  * on well-separated clusters (ROADMAP F21: elsewhere a row near two
    centres may be assigned differently) the assignment, the buckets, the
    bucket means over rows made again by id (rtol 1e-6: the sums run in
    another order) and the permuted encodes equal the JAX package's
    ``ivf_ops``;
  * without a card and without ``--device`` the harness raises
    ``NoDeviceError``, and a failing leg makes ``main`` return 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu.core.types as j_types
from quantization_tpu.ops import ivf as j_ivf
from quantization_tpu.ops import pq as j_pq
from quantization_tpu.ops import sq as j_sq
import quantization_tpu_torch as qt
from quantization_tpu_torch.bench import bench_10m
from quantization_tpu_torch.ops import ivf as t_ivf
from quantization_tpu_torch.ops import pq as t_pq
from quantization_tpu_torch.ops import sq as t_sq
from quantization_tpu_torch.utils.device_store import DeviceAppender

from test_torch_pq_codec import assert_codes_equal_but_near_ties

torch.set_num_threads(1)
CPU = torch.device("cpu")


def harness(argv):
    args = bench_10m.parser().parse_args(argv + ["--device", "cpu"])
    return bench_10m.Harness(args, CPU)


@pytest.fixture(scope="module")
def corpus():
    """The realistic normalized corpus at 4,000 x 64 in 4 batches, 24
    queries: (harness, all rows f32 [N, D])."""
    h = harness(["--n", "4000", "--d", "64", "--batch", "1000", "--clusters", "16",
                 "--queries", "24", "--chunk-size", "4", "--dist", "realistic", "--normalize"])
    return h, torch.cat([h.rows.batch(i) for i in range(h.nb)])


def test_calibration_is_the_corpus_range_and_first_rows(corpus):
    h, x = corpus
    mn, mx, sample = bench_10m.calibrate(h)
    assert (mn, mx) == (float(x.min()), float(x.max()))
    assert np.array_equal(sample, x[: min(h.B, bench_10m.PQ_SAMPLE)].numpy())


def test_streamed_sq_codes_equal_jax_quantize_batch(corpus):
    h, x = corpus
    alpha, offset = t_sq.alpha_offset_from_min_max(float(x.min()), float(x.max()))
    actual, lane = t_sq.actual_dim(h.D), t_sq.lane_dim(h.D)
    codes = DeviceAppender((h.N, lane), torch.int8, CPU)
    voff = DeviceAppender((h.N,), torch.float32, CPU)
    bench_10m.stream_codes(h, (codes, voff), lambda b: t_sq.quantize_batch(
        b, alpha=alpha, offset=offset, distance_type=qt.DistanceType.DOT, invert=False,
        dpad=actual, lane=lane))
    jc, jv = j_sq.quantize_batch(jnp.asarray(x.numpy()), alpha=alpha, offset=offset,
                                 distance_type=j_types.DistanceType.DOT, invert=False,
                                 dpad=actual, lane=lane)
    assert np.array_equal(codes.finish().numpy(), np.asarray(jc))
    np.testing.assert_allclose(voff.finish().numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


def jax_pack_bq(x, w8):
    """The JAX harness's pack_bq (tools/bench_10m.py:289-295)."""
    d = x.shape[1]
    pow2 = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    bits = (x > 0).astype(jnp.uint32)
    bits = jnp.pad(bits, ((0, 0), (0, w8 * 32 - d)))
    return jnp.sum(bits.reshape(-1, w8, 32) * pow2[None, None, :], axis=2, dtype=jnp.uint32)


@pytest.mark.parametrize("d", [64, 50])
def test_streamed_bq_planes_equal_the_jax_harness(corpus, d):
    h, x = corpus
    x = x[:, :d].contiguous()
    w = -(-d // 32)
    w8 = w + (-w) % 8
    planes = DeviceAppender((w8, h.N), torch.int32, CPU, axis=1)
    for i in range(h.nb):
        planes.append(bench_10m.pack_bq(x[i * h.B : (i + 1) * h.B], w8).T)
    want = np.asarray(jax_pack_bq(jnp.asarray(x.numpy()), w8)).T
    assert np.array_equal(planes.finish().numpy().view(np.uint32), want)


def test_streamed_pq_codes_equal_jax_but_near_ties(corpus):
    h, x = corpus
    _, _, sample = bench_10m.calibrate(h)
    division = t_pq.get_vector_division(h.D, 4)
    cents = bench_10m.train_pq(h, sample, division, t_pq.CENTROIDS_COUNT4)
    c_chunks = t_pq.centroids_to_chunks(cents, division)
    codes = DeviceAppender((len(division), h.N), torch.uint8, CPU, axis=1)
    bench_10m.stream_codes(h, (codes,), lambda b: bench_10m.chunk_codes(
        b, division, torch.from_numpy(c_chunks)))
    got = codes.finish().numpy().T
    xc = t_pq.chunk_tensor(x.numpy(), division)
    want = np.asarray(j_pq.encode_batch(jnp.asarray(xc), jnp.asarray(c_chunks)))
    assert assert_codes_equal_but_near_ties(got, want, xc, c_chunks) <= got.size // 1000


def test_streamed_top_k_equals_an_f64_oracle(corpus):
    h, x = corpus
    q = h.rows.gen_rows(torch.arange(h.N, h.N + h.Q))
    best = (torch.full((h.Q, h.K), float("-inf")), torch.full((h.Q, h.K), -1,
                                                               dtype=torch.int64))
    for i in range(h.nb):
        best = bench_10m.gt_update(best, q, h.rows.batch(i), i * h.B)
    s64 = q.double() @ x.double().T
    want_s, want_i = torch.topk(s64, h.K, dim=1)
    np.testing.assert_allclose(best[0].numpy(), want_s.numpy(), rtol=0, atol=1e-5)
    kth = want_s[:, -1:]
    # ids agree wherever the oracle's K-th score stands apart from the next
    apart = (torch.topk(s64, h.K + 1, dim=1).values[:, -1:] < kth - 1e-5).squeeze(1)
    for r in torch.nonzero(apart).reshape(-1).tolist():
        assert set(best[1][r].tolist()) == set(want_i[r].tolist())
    assert int(apart.sum()) >= h.Q - 2


@pytest.fixture(scope="module")
def separated():
    """Well-separated clusters (sigma 0.02 around 8 centres in [-1, 1]^32):
    the harness's IVF build at S = 64, nlist 8."""
    h = harness(["--n", "4000", "--d", "32", "--batch", "1000", "--clusters", "8",
                 "--sigma", "0.02", "--queries", "8"])
    x = torch.cat([h.rows.batch(i) for i in range(h.nb)]).numpy()
    centers = t_ivf.train_centers(x[:1000], 8)
    return h, x, centers


def test_ivf_assignment_buckets_and_means_equal_jax(separated):
    h, x, centers = separated
    assign = bench_10m.assign_rows(h, centers)
    j_assign = j_ivf.assign_clusters(x, centers)
    assert np.array_equal(assign, j_assign)
    perm, bucket_ids = t_ivf.build_buckets(assign, 64)
    jperm, jids = j_ivf.build_buckets(j_assign, 64)
    assert np.array_equal(perm, jperm) and np.array_equal(bucket_ids, jids)
    assert (bucket_ids < 0).any()  # pad slots are masked out of the means
    means = bench_10m.bucket_means_by_id(h.rows, perm, bucket_ids, block_rows=640)
    np.testing.assert_allclose(means, j_ivf.bucket_means(x, perm, bucket_ids), rtol=1e-6,
                               atol=1e-7)


def test_ivf_permuted_encodes_equal_jax(separated):
    h, x, centers = separated
    perm, bucket_ids = t_ivf.build_buckets(bench_10m.assign_rows(h, centers), 64)
    total = perm.shape[0]
    alpha, offset = t_sq.alpha_offset_from_min_max(float(x.min()), float(x.max()))
    actual, lane = t_sq.actual_dim(h.D), t_sq.lane_dim(h.D)
    codes = DeviceAppender((total, lane), torch.int8, CPU)
    voff = DeviceAppender((total,), torch.float32, CPU)
    planes = DeviceAppender((8, total), torch.int32, CPU, axis=1)

    def enc(b, _s0):
        c, v = t_sq.quantize_batch(b, alpha=alpha, offset=offset,
                                   distance_type=qt.DistanceType.DOT, invert=False,
                                   dpad=actual, lane=lane)
        return c, v, bench_10m.pack_bq(b, 8).T

    bench_10m.encode_by_id(h.rows, perm, (codes, voff, planes), enc)
    jc, jv = j_sq.quantize_batch(jnp.asarray(x[perm]), alpha=alpha, offset=offset,
                                 distance_type=j_types.DistanceType.DOT, invert=False,
                                 dpad=actual, lane=lane)
    assert np.array_equal(codes.finish().numpy(), np.asarray(jc))
    np.testing.assert_allclose(voff.finish().numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert np.array_equal(planes.finish().numpy().view(np.uint32),
                          np.asarray(jax_pack_bq(jnp.asarray(x[perm]), 8)).T)


def test_ladder_follows_the_jax_rule():
    assert bench_10m.ladder((0.0119, 0.0475, 0.1186, 0.2372), 21_587) == [256, 1024, 2560,
                                                                          5120]
    assert bench_10m.ladder((0.0119, 0.0475, 0.1186, 0.2372), 11_384) == [256, 512, 1280,
                                                                          2816]
    assert bench_10m.ladder((0.0475, 0.1186), 45) == [256]


def test_main_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(qt.NoDeviceError, match="device='cpu'"):
        bench_10m.main(["--n", "2000", "--batch", "1000"])


def test_a_failing_leg_prints_failed_and_main_returns_1(monkeypatch, capsys):
    """A leg that raises prints the JAX harness's FAILED line; the run goes
    on to its other legs, and main returns 1 (no failure ends in 0)."""
    real = qt.BinaryQuantizer.top_k_device

    def broken(self, equery, k, method="exact", recall_target=None):
        if method == "approx":
            raise RuntimeError("injected")
        return real(self, equery, k, method=method)

    monkeypatch.setattr(qt.BinaryQuantizer, "top_k_device", broken)
    rc = bench_10m.main(["--n", "2000", "--d", "32", "--batch", "1000", "--queries", "8",
                         "--only", "bq", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "BQ fused approx   : FAILED RuntimeError: injected" in out
    assert "BQ fused exact    : " in out and "recall@10 vs exact = " in out
    assert "1 leg(s) FAILED: BQ fused approx" in out


def test_bad_batch_is_refused():
    with pytest.raises(SystemExit):
        bench_10m.main(["--n", "1000", "--batch", "300", "--device", "cpu"])


def test_f35_from_transposed_pads_each_axis_on_its_own():
    """ROADMAP F35: with m = 8 chunks (below M_BLK = 16) and a code matrix
    whose columns (the permuted rows rounded to 2048) outnumber the row
    padding (count rounded to TILE_N = 1024), the JAX package's
    ``from_transposed`` pads both axes by the short one's deficit and raises
    on the negative pad; the port's pads each axis on its own."""
    import quantization_tpu.models.pq as j_pq_model

    count, m, d = 2112, 8, 64
    rng = np.random.default_rng(0)
    codes_t = rng.integers(0, 256, (m, count + (-count) % 2048), dtype=np.uint8)
    division = t_pq.get_vector_division(d, d // m)
    cents = rng.standard_normal((256, d)).astype(np.float32)
    jp = j_types.VectorParameters(d, count, j_types.DistanceType.DOT, False)
    with pytest.raises(ValueError, match="negative"):
        j_pq_model.ProductQuantizer.from_transposed(
            jnp.asarray(codes_t), j_pq_model.PQMetadata(cents, division, jp))
    tp = qt.VectorParameters(d, count, qt.DistanceType.DOT, False)
    pq = qt.ProductQuantizer.from_transposed(torch.from_numpy(codes_t),
                                             qt.PQMetadata(cents, division, tp))
    assert tuple(pq.codes_t.shape) == (16, 4096)
    assert torch.equal(pq.codes_t[:m, :], torch.from_numpy(codes_t))
    assert int(pq.codes_t[m:].abs().sum()) == 0
