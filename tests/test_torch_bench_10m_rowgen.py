"""The port's threefry (bench/threefry.py) against jax.random, and the 10M
harness's corpus rows (bench/bench_10m.RowSource) against the JAX
harness's row function, recomputed here as tools/bench_10m.py:164-222
computes it (it lives inside that script's main).

Integer draws (keys, bits, randint) are equal to the bit; uniforms too.
Normals within 1e-6: XLA's f32 log1p and torch's differ in the last bit
(ErfInv's input), so about 1 % of normals are 1-3 ulp apart. Rows within
rtol 1e-5 / atol 2e-6: the normals' ulps, the realistic corpus's rotation
(a matrix product summed in another order) and the normalisation."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu_torch.bench import bench_10m, threefry

torch.set_num_threads(1)


def t_key(k):
    """The port's key of a JAX key (its two uint32 words)."""
    k0, k1 = (int(v) for v in np.asarray(jax.random.key_data(k)))
    return threefry._u32(k0), threefry._u32(k1)


def words(k):
    return [int(v) for v in np.asarray(jax.random.key_data(k)).reshape(-1)]


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_key_fold_in_and_split_equal_jax(seed):
    k = jax.random.key(seed)
    tk = threefry.key(seed)
    assert [int(tk[0]), int(tk[1])] == words(k)
    for d in (0, 1, 12345, 10_000_000, 2**24 + 7, 2**31 - 1):
        fj = jax.random.fold_in(k, d)
        ft = threefry.fold_in(tk, d)
        assert [int(ft[0]), int(ft[1])] == words(fj)
        for num in (2, 3, 5):
            sj = np.asarray(jax.random.key_data(jax.random.split(fj, num)))
            st = threefry.split(ft, num)
            assert [[int(a), int(b)] for a, b in st] == sj.tolist()


def test_fold_in_over_a_vector_of_ids():
    ids = np.array([0, 5, 99_999, 10_000_000, 2**24 - 1], np.int64)
    k = jax.random.key(42)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(k, int(i))))
                     for i in ids])
    got = threefry.fold_in(threefry.key(42), torch.from_numpy(ids))
    assert np.array_equal(np.stack([got[0].numpy(), got[1].numpy()], 1), want)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (768,), (3, 5)])
def test_random_bits_uniform_and_normal(shape):
    k = jax.random.fold_in(jax.random.key(42), 77)
    tk = t_key(k)
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(threefry.random_bits(tk, shape).numpy(), bits)
    u = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    assert np.array_equal(threefry.uniform(tk, shape).numpy(), u)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u2 = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, 1.0))
    assert np.array_equal(threefry.uniform(tk, shape, float(lo), 1.0).numpy(), u2)
    n = np.asarray(jax.random.normal(k, shape, jnp.float32))
    np.testing.assert_allclose(threefry.normal(tk, shape).numpy(), n, rtol=0, atol=1e-6)


def test_normal_over_many_draws():
    """200,000 normals: within 1e-6, and nearly all equal to the bit."""
    k = jax.random.key(3)
    n = np.asarray(jax.random.normal(k, (200_000,), jnp.float32))
    got = threefry.normal(t_key(k), (200_000,)).numpy()
    np.testing.assert_allclose(got, n, rtol=0, atol=1e-6)
    assert (got == n).mean() > 0.98


@pytest.mark.parametrize("span", [1, 2, 7, 16, 1000, 3255, 65_536, 70_000, 2**31 - 1])
def test_randint_equals_jax(span):
    for seed in range(20):
        k = jax.random.fold_in(jax.random.key(seed), span)
        want = int(jax.random.randint(k, (), 0, span))
        assert int(threefry.randint(t_key(k), 0, span)) == want
    k = jax.random.key(9)
    lo = min(5, 2**31 - 1 - span)
    want = np.asarray(jax.random.randint(k, (64,), lo, lo + span))
    assert np.array_equal(threefry.randint(t_key(k), lo, lo + span, (64,)).numpy(), want)


def harness_args(dist, normalize, d=48, clusters=16, batch=500):
    argv = ["--d", str(d), "--clusters", str(clusters), "--dist", dist, "--batch", str(batch),
            "--n", str(4 * batch), "--device", "cpu"]
    return bench_10m.parser().parse_args(argv + (["--normalize"] if normalize else []))


def jax_gen_rows(args):
    """The JAX harness's gen_rows (tools/bench_10m.py:164-217), verbatim but
    for its argument object."""
    D = args.d
    host_rng = np.random.default_rng(7)
    base_key = jax.random.key(42)
    if args.dist == "realistic":
        spectrum = jnp.asarray(((1.0 + np.arange(D)) ** -0.7).astype(np.float32))
        rot = jnp.asarray(np.linalg.qr(host_rng.standard_normal((D, D)))[0].astype(np.float32))
        centers = jnp.asarray(
            host_rng.standard_normal((args.clusters, D)).astype(np.float32)
        ) * spectrum[None, :]

        def _lat_rows(ids):
            def row(i):
                k1, k2, k3 = jax.random.split(jax.random.fold_in(base_key, i), 3)
                assign = jax.random.randint(k1, (), 0, args.clusters)
                noise = jax.random.normal(k2, (D,), jnp.float32) * args.sigma * spectrum
                radial = jnp.exp(0.25 * jax.random.normal(k3, (), jnp.float32))
                return (centers[assign] + noise) * radial

            return jax.vmap(row)(ids) @ rot
    else:
        centers = jnp.asarray(host_rng.random((args.clusters, D), np.float32) * 2 - 1)

        def _lat_rows(ids):
            def row(i):
                k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
                assign = jax.random.randint(k1, (), 0, args.clusters)
                noise = jax.random.normal(k2, (D,), jnp.float32) * args.sigma
                return centers[assign] + noise

            return jax.vmap(row)(ids)

    def gen_rows(ids):
        x = _lat_rows(jnp.asarray(ids, jnp.int32))
        if args.normalize:
            x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        return x

    return lambda ids: np.asarray(gen_rows(ids))


@pytest.mark.parametrize("dist", ["clustered", "realistic"])
@pytest.mark.parametrize("normalize", [False, True])
def test_gen_rows_equal_the_jax_harness(dist, normalize):
    args = harness_args(dist, normalize)
    rows = bench_10m.RowSource(args, torch.device("cpu"))
    want_fn = jax_gen_rows(args)
    for ids in (np.arange(0, 1000), np.arange(10_000_000, 10_000_300),
                np.array([2**24 - 1, 2**24, 7, 123_456_789])):
        got = rows.gen_rows(ids).numpy()
        np.testing.assert_allclose(got, want_fn(ids), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("dist", ["clustered", "realistic"])
def test_rows_made_again_by_id_equal_the_batch(dist):
    """A subset of a batch made again from its ids (the two-stage rescorer,
    the bucket means, the permuted encodes) equals the batch's rows: the
    row kernel is per row, and the rotation's product is taken here on
    another number of rows, each row's dot in the same order."""
    args = harness_args(dist, True)
    rows = bench_10m.RowSource(args, torch.device("cpu"))
    batch = rows.batch(2)
    ids = np.array([1000, 1499, 1003, 1250, 1250, 1001])
    np.testing.assert_allclose(rows.gen_rows(ids).numpy(), batch[ids - 1000].numpy(),
                               rtol=1e-6, atol=1e-7)
    lat, clusters = threefry.latent_rows(torch.from_numpy(ids), rows.centers, rows.spectrum,
                                         rows.sigma, rows.base, return_clusters=True)
    lat_b, clusters_b = threefry.latent_rows_plain(
        torch.arange(1000, 1500), rows.centers, rows.spectrum, rows.sigma, rows.base,
        return_clusters=True)
    assert torch.equal(lat, lat_b[ids - 1000])
    assert torch.equal(clusters, clusters_b[ids - 1000])


def test_host_draws_follow_the_jax_order():
    """The realistic corpus draws its rotation before its centres from
    default_rng(7); the clustered one its centres only."""
    for dist in ("realistic", "clustered"):
        args = harness_args(dist, False)
        rows = bench_10m.RowSource(args, torch.device("cpu"))
        rng = np.random.default_rng(7)
        if dist == "realistic":
            rot = np.linalg.qr(rng.standard_normal((args.d, args.d)))[0].astype(np.float32)
            assert np.array_equal(rows.rot.numpy(), rot)
            spec = ((1.0 + np.arange(args.d)) ** -0.7).astype(np.float32)
            want = rng.standard_normal((args.clusters, args.d)).astype(np.float32) * spec
        else:
            want = rng.random((args.clusters, args.d), np.float32) * 2 - 1
        assert np.array_equal(rows.centers.numpy(), want)


def test_ids_past_2_31_are_the_jax_harness_negative_int32():
    """The kernel takes the JAX harness's int32 ids; the plain version any
    id below 2^32, and an id past 2^31 is the JAX harness's negative int32
    of the same bits."""
    args = harness_args("clustered", False)
    rows = bench_10m.RowSource(args, torch.device("cpu"))
    a = threefry.latent_rows_plain(torch.tensor([2**31 + 5]), rows.centers, None, 0.5,
                                   rows.base)
    k = jax.random.fold_in(jax.random.key(42), jnp.int32(-(2**31) + 5))
    assert [int(v) for v in threefry.fold_in(rows.base, 2**31 + 5)] == words(k)
    assert a.shape == (1, args.d)


def test_row_source_keeps_its_ids_below_2_31():
    """Row ids are the JAX harness's int32 ids, so the corpus and its
    queries must fit below 2^31; the rows themselves take an id's low 32
    bits (an id and the same id plus 2^32 make one row)."""
    from quantization_tpu_torch.core.types import ArgumentsError

    args = harness_args("clustered", False)
    args.n, args.queries = 2**31 - 255, 256
    with pytest.raises(ArgumentsError, match="2\\^31"):
        bench_10m.RowSource(args, torch.device("cpu"))
    args.n = 2**31 - 256
    rows = bench_10m.RowSource(args, torch.device("cpu"))
    a = threefry.latent_rows(torch.tensor([7, 2**32 + 7]), rows.centers, None, 0.5, rows.base)
    assert torch.equal(a[0], a[1])


def test_parser_takes_every_jax_flag_and_device():
    args = bench_10m.parser().parse_args([])
    assert isinstance(args, argparse.Namespace)
    for flag in ("n", "d", "batch", "queries", "k", "chunk_size", "clusters", "sigma",
                 "normalize", "dist", "only", "k_sweep", "opq", "ivf", "nlist", "ivf_bucket",
                 "ivf_base", "sync_latency", "ivf_residual", "device"):
        assert hasattr(args, flag), flag
    assert (args.n, args.d, args.batch, args.queries, args.k) == (10_000_000, 768, 250_000,
                                                                   256, 10)
