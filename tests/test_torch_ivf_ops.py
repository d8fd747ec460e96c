"""The port's IVF build operations (``ops/ivf.py``) against the JAX
package's, from the same seeded numpy inputs, on the CPU.

Tolerances, with their causes:
  * ``build_buckets``: none — the same host bookkeeping, byte for byte;
  * ``bucket_means``, ``residualize_inplace``: none — the same numpy code;
  * the decoded row terms: rtol 1e-6 of the row term's scale — f32 sums over
    dims and chunks in another order (XLA's reductions against torch's);
  * ``assign_clusters``: equal ids on well-separated clusters (near-ties of
    two centres may flip: the |c|^2 - 2x.c products sum in another order,
    ROADMAP Queue 3, F21);
  * ``train_centers``: 1e-4 of the data scale — Lloyd's sums round in
    another order over up to 25 iterations, from the same init and reseeds.
"""

import numpy as np
import pytest
import torch

import quantization_tpu.ops.ivf as j_ivf
from quantization_tpu_torch.ops import ivf as t_ivf
from quantization_tpu_torch.ops import pq as t_pq

torch.set_num_threads(1)


def _separated(rng, n, dim, clusters, sigma=0.05):
    """Rows around ``clusters`` centres far apart (no assignment near-ties);
    the first ``clusters`` rows lie one in each, so k-means' first-k init
    starts with a centre per cluster and never splits one."""
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4
    assign = rng.integers(0, clusters, n)
    assign[:clusters] = np.arange(clusters)
    return (centers[assign] + sigma * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.mark.parametrize("n,clusters,s", [(500, 7, 64), (300, 40, 32), (50, 3, 64),
                                          (2000, 5, 512)])
def test_build_buckets_byte_equal(rng, n, clusters, s):
    """Uneven clusters, runts smaller than a bucket, and more pads than rows
    (the cyclic cursor wraps)."""
    assign = (rng.integers(0, clusters, n) ** 2 % clusters).astype(np.int32)
    jp, jb = j_ivf.build_buckets(assign, s)
    tp, tb = t_ivf.build_buckets(assign, s)
    assert tp.dtype == jp.dtype and tb.dtype == jb.dtype
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)


def test_bucket_means_and_residuals_equal(rng):
    data = rng.standard_normal((900, 24)).astype(np.float32)
    perm, ids = t_ivf.build_buckets(rng.integers(0, 6, 900).astype(np.int32), 64)
    jm = j_ivf.bucket_means(data, perm, ids, block_buckets=5)
    tm = t_ivf.bucket_means(data, perm, ids, block_buckets=5)
    np.testing.assert_array_equal(tm, jm)
    jr, tr = data[perm], data[perm]
    j_ivf.residualize_inplace(jr, jm, ids, block_buckets=3)
    t_ivf.residualize_inplace(tr, tm, ids, block_buckets=3)
    np.testing.assert_array_equal(tr, jr)
    assert (tr[ids.reshape(-1) < 0] == 0).all()


def test_sq_decoded_rowterm_matches_jax(rng):
    import jax.numpy as jnp

    nb, s, dim, lane = 5, 64, 40, 128
    codes = np.zeros((nb * s + 64, lane), np.int8)
    codes[:, :dim] = rng.integers(0, 128, (nb * s + 64, dim))
    means = rng.standard_normal((nb, dim)).astype(np.float32) * 3
    want = np.asarray(j_ivf.sq_decoded_rowterm(
        jnp.asarray(codes), 0.013, -0.8, jnp.asarray(means), s, dim, block_buckets=2))
    got = t_ivf.sq_decoded_rowterm(torch.from_numpy(codes), 0.013, -0.8,
                                   torch.from_numpy(means), s, dim, block_buckets=2).numpy()
    assert got.shape == (nb * s,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("layout", ["rows", "transposed"])
def test_pq_decoded_rowterm_matches_jax(rng, rotated, layout):
    import jax.numpy as jnp

    nb, s, dim, chunk, k = 4, 32, 30, 4, 16
    division = t_pq.get_vector_division(dim, chunk)
    m = len(division)
    mpad = m + (-m) % 16
    codes = np.zeros((nb * s + 32, mpad), np.uint8)
    codes[:, :m] = rng.integers(0, k, (nb * s + 32, m))
    c_chunks = t_pq.centroids_to_chunks(rng.standard_normal((k, dim)).astype(np.float32),
                                        division)
    rot = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32) if rotated \
        else None
    means = rng.standard_normal((nb, dim)).astype(np.float32) * 2
    t = layout == "transposed"
    want = np.asarray(j_ivf.pq_decoded_rowterm(
        None if t else jnp.asarray(codes), jnp.asarray(c_chunks),
        None if rot is None else jnp.asarray(rot), jnp.asarray(means), s, division,
        block_buckets=3, codes_t=jnp.asarray(codes.T) if t else None))
    got = t_ivf.pq_decoded_rowterm(
        None if t else torch.from_numpy(codes), torch.from_numpy(c_chunks),
        None if rot is None else torch.from_numpy(rot), torch.from_numpy(means), s,
        division, block_buckets=3,
        codes_t=torch.from_numpy(np.ascontiguousarray(codes.T)) if t else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_assign_clusters_matches_jax(rng):
    data = _separated(rng, 3000, 16, 12)
    centers = data[:: 250][:12]
    got = t_ivf.assign_clusters(data, centers)
    np.testing.assert_array_equal(got, j_ivf.assign_clusters(data, centers))
    assert got.dtype == np.int32


def test_assign_clusters_row_and_center_blocked(rng, monkeypatch):
    """Row blocks of 64 and center blocks of 128 (a 300-center list in three
    blocks, the last padded with +inf norms) give the unblocked answer."""
    data = _separated(rng, 700, 8, 300, sigma=0.01)
    centers = _separated(rng, 300, 8, 300, sigma=0.0)
    want = t_ivf.assign_clusters(data, centers)
    monkeypatch.setattr(t_ivf, "ASSIGN_BLOCK", 64)
    monkeypatch.setattr(t_ivf, "_SCORES_BYTES_CAP", 64 * 128 * 4)
    assert t_ivf._center_blocks(300) == (3, 128)
    np.testing.assert_array_equal(t_ivf.assign_clusters(data, centers), want)
    d2 = ((data[:, None, :] - centers[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(want, d2.argmin(1))


def test_train_centers_incore_matches_jax(rng):
    data = _separated(rng, 2000, 16, 10)
    want = j_ivf.train_centers(data, 10, seed=3)
    got = t_ivf.train_centers(data, 10, seed=3)
    assert got.shape == (10, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(data).max())


def test_train_centers_streamed_matches_jax(rng, monkeypatch):
    """The blocked-Lloyd trainer, forced by small caps, from the same init
    and host reseed stream (n a multiple of the row block, so the JAX
    trainer drops no tail)."""
    data = _separated(rng, 1024, 16, 24)
    for mod in (j_ivf, t_ivf):
        monkeypatch.setattr(mod, "_SCORES_BYTES_CAP", 1 << 16)
        monkeypatch.setattr(mod, "ASSIGN_BLOCK", 512)
    want = j_ivf.train_centers(data, 24, seed=5, max_iterations=10)
    got = t_ivf.train_centers(data, 24, seed=5, max_iterations=10)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(data).max())


def test_streamed_trainer_keeps_the_tail(rng, monkeypatch):
    """ROADMAP Queue 3, F1, repaired: with a row block of 64, 600 sample rows
    and 590 centers, the JAX trainer drops the 24-row tail, starts from 576
    centers and fails; the port trains on all 600 rows and returns 590
    finite centers."""
    data = rng.standard_normal((600, 8)).astype(np.float32)
    for mod in (j_ivf, t_ivf):
        monkeypatch.setattr(mod, "_SCORES_BYTES_CAP", 1 << 16)
        monkeypatch.setattr(mod, "ASSIGN_BLOCK", 512)
    with pytest.raises(Exception):
        j_ivf.train_centers(data, 590, seed=0, max_iterations=2)
    got = t_ivf.train_centers(data, 590, seed=0, max_iterations=2)
    assert got.shape == (590, 8) and np.isfinite(got).all()
    # nlist above the sample clamps to it, as in the in-core trainer.
    assert t_ivf.train_centers(data[:100], 150, max_iterations=1).shape == (100, 8)


def test_streamed_trainer_cancels(rng, monkeypatch):
    from quantization_tpu_torch.core.types import StoppedError

    monkeypatch.setattr(t_ivf, "_SCORES_BYTES_CAP", 1 << 10)
    calls = []

    def stop():
        calls.append(1)
        return len(calls) > 2

    with pytest.raises(StoppedError):
        t_ivf.train_centers(rng.standard_normal((300, 4)).astype(np.float32), 50,
                            stop_condition=stop)


@pytest.mark.parametrize("nlist", [1, 100, 4096, 4097, 70_000])
def test_sample_cap_matches_jax(nlist):
    assert t_ivf.sample_cap(nlist) == j_ivf.sample_cap(nlist)
    assert t_ivf._center_blocks(nlist) == j_ivf._center_blocks(nlist)
