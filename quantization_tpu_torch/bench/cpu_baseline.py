"""CPU reference baseline measurement.

Twin of ``quantization_tpu/bench/cpu_baseline.py``. Rust is not available,
so the reference crate cannot be built; instead the port's native C++ scan
loops (``native/qtpu_native.cpp``, g++ -O3 -march=native: the same
autovectorized loops the reference's cc-built C kernels compile to) measure
single-core CPU scoring q/s, the CPU side of the card-against-CPU ratio.
The corpus is encoded by the native encoder (``use_native=True``) onto
``device`` and its codes read back, so the scan scores the codes the card
holds.

    python -m quantization_tpu_torch.bench.cpu_baseline [N] [D] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure(n: int = 100_000, d: int = 1024, iters: int = 5, device=None) -> dict:
    """q/s of one query's full scan over ``n`` x ``d`` codes (SQ u8 DOT) and
    f32 rows, single-threaded native loops; the codes are encoded on
    ``device`` (default: the CUDA card)."""
    from ..core.types import DistanceType, VectorParameters
    from ..models.sq import ScalarQuantizerU8
    from ..native import loader

    rng = np.random.default_rng(42)
    data = rng.random((n, d), dtype=np.float32) * 2 - 1
    query = rng.random((d,), dtype=np.float32) * 2 - 1

    params = VectorParameters(d, n, DistanceType.DOT, False)
    enc = ScalarQuantizerU8.encode(data, params, use_native=True, device=device)
    m = enc.metadata
    codes = enc.codes[: enc.count, : m.actual_dim].cpu().numpy().view(np.uint8)
    voff = enc.voffsets[: enc.count].cpu().numpy()
    eq = enc.encode_query(query)
    qcodes = eq.codes[0, : m.actual_dim].cpu().numpy().view(np.uint8)
    qoff = float(eq.offsets[0])

    def timeit(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    t_u8 = timeit(lambda: loader.cpu_scan_dot_u8(qcodes, codes, m.multiplier, qoff, voff))
    t_f32 = timeit(lambda: loader.cpu_scan_dot_f32(query, data))
    return {
        "cpu_sq_u8_scan_qps": 1.0 / t_u8,
        "cpu_f32_scan_qps": 1.0 / t_f32,
        "cpu_u8_vs_f32": t_f32 / t_u8,
        "n": n,
        "dim": d,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("d", type=int, nargs="?", default=1024)
    ap.add_argument("--device", default=None,
                    help="where the codes are encoded (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = measure(args.n, args.d, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
