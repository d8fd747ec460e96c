"""Multi-device dry run of the port: every sharded path once, at toy sizes.

Twin of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``): on
a mesh of ``n_devices`` shards it runs the SQ calibrate-and-encode passes
over a sharded corpus, a k-means step of the PQ trainer, the three sharded
quantizers' searches, the sharded-native streaming encode, a distributed
two-stage search and the sharded-native IVF build with a probe-limited
search; beyond those, a residual ``ShardedIVF``, a ``recommend``-built
serving plan over a sharded IVF index and a ``PipelinedSearcher`` over a
sharded engine. With an even count the mesh is 2-D, ``("shard", "qdp")``,
and the corpus is sharded along ``shard`` (the port holds each shard once,
on the first device of its slice, ``Mesh.shard_devices``).

    python -m quantization_tpu_torch.dryrun [N_DEVICES] [--device cuda|cpu]

The N shards lie on the first CUDA card unless ``--device`` names another
device (``NoDeviceError`` without a card); ``--device cpu`` gives the CPU
mesh the tests use.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.types import DistanceType, VectorParameters
from .models import sq as sq_model
from .models.bq import BinaryQuantizer
from .models.pipeline import TwoStageIndex
from .models.pq import ProductQuantizer
from .models.sq import ScalarQuantizerU8
from .ops.dispatch import resolve_device
from .ops.kmeans import lloyd_iteration
from .parallel.sharded import (
    ShardedBinaryQuantizer,
    ShardedProductQuantizer,
    ShardedScalarQuantizer,
    make_mesh,
)
from .parallel.sharded_ivf import ShardedIVF
from .policy import recommend
from .serving import PipelinedSearcher


def _check(result, q: int, k: int, n: int) -> None:
    s, i = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in result)
    assert s.shape == (q, k) and i.shape == (q, k), (s.shape, i.shape)
    assert int(np.max(i)) < n and np.isfinite(s[i >= 0]).all()


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """Run every sharded path of the port once on a mesh of ``n_devices``
    shards of ``device`` (default: the CUDA card). Returns {path: True} for
    each path that ran; any failure raises."""
    dev = resolve_device(device)
    if n_devices % 2 == 0 and n_devices > 1:
        mesh = make_mesh(n_devices, axis_names=("shard", "qdp"), shape=(n_devices // 2, 2),
                         devices=[dev] * n_devices)
    else:
        mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    devices = mesh.shard_devices("shard")
    ns = len(devices)
    n, d, q, k = 64 * n_devices, 256, 8, 5
    rng = np.random.default_rng(0)
    data = rng.random((n, d), dtype=np.float32)
    queries = rng.random((q, d), dtype=np.float32)
    params = VectorParameters(d, n, DistanceType.DOT, False)
    ran = {}

    # --- calibrate and encode over the sharded corpus: the SQ calibration
    # (a global min / max over every shard's rows), then each shard's rows
    # quantized on its device; the codes are the single-device encoder's ---
    parts = np.split(data, ns)
    meta = sq_model.sq_metadata(lambda: iter(parts), params, None, None, 0)
    codes = []
    for part, dv in zip(parts, devices):
        local = dataclasses.replace(
            meta, vector_parameters=dataclasses.replace(params, count=part.shape[0]))
        ((c, voff),) = sq_model.quantized_batches([part], local, None, dv)
        assert bool(voff.isfinite().all())
        codes.append(c.cpu())
    enc = ScalarQuantizerU8.encode(data, params, device=dev)
    assert torch.equal(torch.cat(codes), enc.codes[:n].cpu())
    ran["calibrate_encode"] = True

    # --- a k-means step of the PQ trainer (one Lloyd iteration of every
    # chunk). The port trains on the mesh's first device, as its sharded
    # encoders train their codebooks on a sample there ---
    m, kc, dc = 4, 16, 8
    chunks = torch.from_numpy(rng.random((m, n, dc), dtype=np.float32)).to(dev)
    cents = torch.from_numpy(rng.random((m, kc, dc), dtype=np.float32)).to(dev)
    reseed = torch.from_numpy(rng.integers(0, n, (m, kc))).to(dev)
    new, diff = lloyd_iteration(cents, chunks, reseed, torch.zeros(m, dtype=torch.bool,
                                                                   device=dev))
    assert new.shape == cents.shape and bool(new.isfinite().all() & diff.isfinite().all())
    ran["kmeans_step"] = True

    # --- the three sharded quantizers, wrapped ---
    ssq = ShardedScalarQuantizer(enc, mesh, axis="shard")
    _check(ssq.top_k(ssq.encode_query(queries), k), q, k, n)
    bq = BinaryQuantizer.encode(data, params, device=dev)
    sbq = ShardedBinaryQuantizer(bq, mesh, axis="shard")
    _check(sbq.top_k(sbq.encode_query(queries), k), q, k, n)
    pq = ProductQuantizer.encode(data, params, chunk_size=32, device=dev)
    spq = ShardedProductQuantizer(pq, mesh, axis="shard")
    _check(spq.top_k(spq.encode_query(queries), k), q, k, n)
    ran["sharded_quantizers"] = True

    # --- sharded-native streaming encode (the corpus never on one device) ---
    def stream():
        for s0 in range(0, n, 64):
            yield data[s0:s0 + 64]

    snative = ShardedScalarQuantizer.encode(stream, params, mesh, axis="shard")
    _check(snative.top_k(snative.encode_query(queries), k), q, k, n)
    ran["streaming_encode"] = True

    # --- distributed two-stage: sharded BQ coarse -> sharded SQ rescore ---
    two = TwoStageIndex(sbq, ssq, oversampling=4.0, coarse_method="exact")
    _check(two.top_k(two.encode_query(queries), k), q, k, n)
    ran["two_stage"] = True

    # --- sharded IVF: the sharded-native streaming build, a probe-limited
    # search over the mesh, and its residual twin ---
    sivf = ShardedIVF.encode(stream, params, mesh=mesh, quantizer="sq",
                             nlist=max(4, n_devices), bucket_size=32, nprobe=4)
    _check(sivf.top_k(sivf.encode_query(queries), k), q, k, n)
    ran["sharded_ivf"] = True
    rparams = VectorParameters(d, n, DistanceType.L2, True)
    rivf = ShardedIVF.encode(stream, rparams, mesh=mesh, quantizer="sq", nlist=2,
                             bucket_size=512, nprobe=2, residual=True)
    _check(rivf.top_k(rivf.encode_query(queries), k), q, k, n)
    ran["residual_sharded_ivf"] = True

    # --- serving: a recommend-built plan over the sharded IVF index, and a
    # pipelined searcher over a sharded engine ---
    plan = recommend(sivf, 0.9, k=k, queries=queries, data=data, q_batch=q)
    served = plan.serve(sivf, data, k=k, depth=2)
    _check(served.search(queries), q, k, n)
    ran["recommend_plan"] = True
    searcher = PipelinedSearcher(ssq, k=k, depth=2)
    batches = [rng.random((q, d), dtype=np.float32) for _ in range(3)]
    for b, res in zip(batches, searcher.search_stream(batches)):
        want = ssq.top_k(ssq.encode_query(b), k)
        assert all(np.array_equal(g, w) for g, w in zip(res, want))
    ran["pipelined_searcher"] = True
    return ran


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    ran = dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun on {args.n_devices} shards of {resolve_device(args.device)}: "
          + ", ".join(ran))
    return ran


if __name__ == "__main__":
    main()
