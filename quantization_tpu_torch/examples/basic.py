"""Basic smoke demo of the PyTorch port (demos/src/basic.rs:11-50).

Twin of ``examples/basic.py``: encode 128 random 64-d vectors with the
scalar u8 quantizer and check that every quantized dot score is within
dim*0.1 of the exact value, for both the query path and the internal
(stored-vs-stored) path.

    python -m quantization_tpu_torch.examples.basic [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from quantization_tpu_torch import (
        DistanceType,
        ScalarQuantizerU8,
        VectorParameters,
    )

    count, dim = 128, 64
    rng = np.random.default_rng(42)
    data = rng.random((count, dim), dtype=np.float32)
    query = rng.random((dim,), dtype=np.float32)

    params = VectorParameters(dim, count, DistanceType.DOT, invert=False)
    encoded = ScalarQuantizerU8.encode(data, params, device=args.device)

    eq = encoded.encode_query(query)
    scores = encoded.score_batch(eq)[0].cpu().numpy()
    exact = data @ query
    if not np.all(np.abs(scores - exact) < dim * 0.1):
        raise RuntimeError("query path out of bounds")

    ids = np.arange(count)
    internal = encoded.score_internal_batch(np.zeros(count, np.int64), ids).cpu().numpy()
    exact0 = data @ data[0]
    if not np.all(np.abs(internal - exact0) < dim * 0.1):
        raise RuntimeError("internal path out of bounds")

    print(f"ok: {count}x{dim} u8 dot scores within {dim * 0.1}")
    print(f"   max query error    = {np.abs(scores - exact).max():.4f}")
    print(f"   max internal error = {np.abs(internal - exact0).max():.4f}")


if __name__ == "__main__":
    main()
