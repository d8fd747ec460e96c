"""Files in the reference's layouts, loaded by the port on the CPU.

The SQ and BQ files come from the numpy writers of
tests/test_golden_interop.py (``ref_sq_write``, ``ref_bq_write``), which
follow the reference's Rust encoders and depend on neither package. The PQ
file is the reference's layout as the same module's PQ case builds it: u8
codes, one byte per chunk, and a JSON of 256 centroids (the count <= 256
fallback of encoded_vectors_pq.rs:290-297: the centroids are the points
themselves, so each code decodes to its own row and the f32 scores are the
exact dots).

PQ scores (ROADMAP Queue 3, F29): the port's ``score_batch`` scores with
the LUT that ``lut_precision()`` names, int8 by default, on every device:
the JAX package's behaviour on the TPU. The JAX package off the TPU scores
with the f32 LUT (quantization_tpu/models/pq.py:379-388), so the two
packages differ on the CPU by one LUT quantization step. Pinned here: the
default is int8, the port's scores equal its plain int8-LUT K8 to the bit,
and they lie within ``dim * 0.05`` of the f32 scores, the JAX package's own
bound for its int8 path (quantization_tpu/models/pq.py:397-401), where the
JAX package on the CPU is within 1e-5 of them."""

import json

import numpy as np
import pytest
import torch

import quantization_tpu as jqt
import quantization_tpu_torch as qt
from quantization_tpu.core.distances import pairwise_score
from quantization_tpu_torch.ops.kernels import pq_kernel
from test_golden_interop import ref_bq_write, ref_sq_write

torch.set_num_threads(1)


def _params(pkg, dim, count, dt, invert=False):
    return pkg.VectorParameters(dim, count, getattr(pkg.DistanceType, dt.name), invert)


def _write_pq(path, data, chunk):
    """The reference-layout PQ pair for ``data`` [count <= 256, dim]: each
    row is its own centroid, so its code in every chunk is its row index."""
    count, dim = data.shape
    centroids = np.zeros((256, dim), np.float32)
    centroids[:count] = data
    meta = {
        "centroids": [[float(v) for v in row] for row in centroids],
        "vector_division": [{"start": s, "end": min(s + chunk, dim)}
                            for s in range(0, dim, chunk)],
        "vector_parameters": {"dim": dim, "count": count, "distance_type": "Dot",
                              "invert": False},
    }
    m = len(meta["vector_division"])
    codes = np.tile(np.arange(count, dtype=np.uint8)[:, None], (1, m))
    (path / "g.bin").write_bytes(codes.tobytes())
    (path / "g.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("dim,count,chunk", [(8, 5, 2), (64, 200, 4), (100, 256, 5)])
def test_pq_reference_file_scores_with_the_int8_lut(tmp_path, rng, monkeypatch, dim, count,
                                                    chunk):
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)
    data = rng.random((count, dim), dtype=np.float32)
    _write_pq(tmp_path, data, chunk)
    q = rng.random((3, dim), dtype=np.float32)
    exact = np.asarray(pairwise_score(q, data, jqt.DistanceType.DOT, False))

    assert pq_kernel.lut_precision() == "int8"
    enc = qt.ProductQuantizer.load(tmp_path / "g.bin", tmp_path / "g.json",
                                   _params(qt, dim, count, qt.DistanceType.DOT), device="cpu")
    eq = enc.encode_query(q)
    got = enc.score_batch(eq)
    want = pq_kernel.pq_scores_plain(eq.lut, enc.codes_t, n_valid=count, precision="int8")
    assert torch.equal(got, want)
    assert np.abs(got.numpy() - exact).max() <= dim * 0.05

    jenc = jqt.ProductQuantizer.load(tmp_path / "g.bin", tmp_path / "g.json",
                                     _params(jqt, dim, count, jqt.DistanceType.DOT))
    jgot = np.asarray(jenc.score_batch(jenc.encode_query(q)))
    np.testing.assert_allclose(jgot, exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [jqt.DistanceType.DOT, jqt.DistanceType.L2])
@pytest.mark.parametrize("dim", [10, 65, 128])
def test_sq_reference_file_loads_and_round_trips(tmp_path, rng, dt, dim):
    """A reference-written SQ file scores as the JAX package scores it, to
    f32 tolerance (both run the plain affine epilogue on the CPU), and
    ``save`` writes it back byte for byte."""
    count = 33
    data = rng.random((count, dim), dtype=np.float32) - 0.25
    blob, meta = ref_sq_write(data, dt, invert=False)
    (tmp_path / "g.bin").write_bytes(blob)
    (tmp_path / "g.json").write_text(json.dumps(meta))
    q = rng.random((4, dim), dtype=np.float32)

    enc = qt.ScalarQuantizerU8.load(tmp_path / "g.bin", tmp_path / "g.json",
                                    _params(qt, dim, count, dt), device="cpu")
    got = enc.score_batch(enc.encode_query(q)).numpy()
    jenc = jqt.ScalarQuantizerU8.load(tmp_path / "g.bin", tmp_path / "g.json",
                                      _params(jqt, dim, count, dt))
    want = np.asarray(jenc.score_batch(jenc.encode_query(q)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    enc.save(tmp_path / "rt.bin", tmp_path / "rt.json")
    assert (tmp_path / "rt.bin").read_bytes() == blob


@pytest.mark.parametrize("store_type", ["u8", "u128"])
@pytest.mark.parametrize("dim", [10, 33, 65, 140])
def test_bq_reference_file_loads_and_round_trips(tmp_path, rng, dim, store_type):
    """A reference-written BQ file scores d - 2 * xor exactly, and the
    port's encoder writes the reference's bytes."""
    count = 21
    data = (rng.random((count, dim), dtype=np.float32) - 0.5) * 2.0
    golden = ref_bq_write(data, store_type)
    (tmp_path / "g.bin").write_bytes(golden)
    (tmp_path / "g.json").write_text(json.dumps({"vector_parameters": {
        "dim": dim, "count": count, "distance_type": "Dot", "invert": False}}))
    params = _params(qt, dim, count, qt.DistanceType.DOT)

    enc = qt.BinaryQuantizer.load(tmp_path / "g.bin", tmp_path / "g.json", params,
                                  store_type=store_type, device="cpu")
    q = (rng.random((3, dim), dtype=np.float32) - 0.5) * 2.0
    xor = ((q[:, None, :] > 0) != (data[None, :, :] > 0)).sum(axis=2)
    np.testing.assert_array_equal(enc.score_batch(enc.encode_query(q)).numpy(),
                                  (dim - 2 * xor).astype(np.float32))

    fresh = qt.BinaryQuantizer.encode(data, params, store_type=store_type, device="cpu")
    fresh.save(tmp_path / "b.bin", tmp_path / "b.json")
    assert (tmp_path / "b.bin").read_bytes() == golden
