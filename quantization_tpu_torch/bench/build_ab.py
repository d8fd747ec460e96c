"""A / B of two host-side choices in the 100M x 768 IVF build of
``bench_10m.py`` (``--ivf`` at the automatic geometry, 32,552 centres), on
one card and its host, in one process:

  * the assignment's ids: copied to the host one sub-block at a time (A,
    15,625 rows a copy at --batch 250000) against gathered on the card and
    copied once (B, ``bench_10m.assign_rows``), over the first --batches
    batches of the corpus made by id;
  * the bucket sort: numpy's stable argsort of --n assignment ids as int32
    keys (A) against 16-bit keys (B, a radix sort), the ids drawn uniformly
    over the centres from a seed; then ``ops/ivf.build_buckets`` whole.

Each pair runs A, B, B, A; A's and B's ids, and their orders, must be equal.

    python -m quantization_tpu_torch.bench.build_ab [--batches 16] [--n 100000000]

Prints one line a run and, last, one JSON object of the times in seconds.
"""

import argparse
import json
import subprocess
import time
import types

import numpy as np
import torch

from quantization_tpu_torch.bench import bench_10m
from quantization_tpu_torch.ops import ivf as ivf_ops

CAPACITY_ARGV = ["--n", "100000000", "--d", "768", "--dist", "realistic", "--normalize"]


def assign_host_copies(h, centers: np.ndarray) -> np.ndarray:
    """``bench_10m.assign_rows`` with each sub-block's ids copied to the
    host as it is done (the form before the ids were gathered on the card)."""
    cblk, ccblk = ivf_ops._pad_centers(torch.from_numpy(centers).to(h.device), centers.shape[0])
    rb = h.B // (-(-h.B // 16_384))
    parts = []
    for i in range(h.nb):
        x = h.rows.batch(i)
        parts += [ivf_ops._assign_blocked(x[r0 : r0 + rb], cblk, ccblk).to(torch.int32).cpu()
                  for r0 in range(0, h.B, rb)]
        del x
    return torch.cat(parts).numpy()[: h.N]


def timed(fn, *args):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=16, help="corpus batches to assign")
    ap.add_argument("--batch", type=int, default=250_000, help="the corpus batch's rows")
    ap.add_argument("--nlist", type=int, default=32_552, help="centres (auto_geometry(100M)'s)")
    ap.add_argument("--n", type=int, default=100_000_000, help="assignment ids to sort")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    print(f"on {smi}", flush=True)

    rargs = bench_10m.parser().parse_args(CAPACITY_ARGV + ["--batch", str(args.batch)])
    rows = bench_10m.RowSource(rargs, dev)
    nb = args.batches
    h = types.SimpleNamespace(B=rargs.batch, N=nb * rargs.batch, nb=nb, rows=rows, device=dev)
    nlist = args.nlist
    centers = rows.batch(0)[:nlist].cpu().numpy()
    runs = {"assign_host_copies": [], "assign_rows": []}
    ids = {}
    bench_10m.assign_rows(h, centers)  # warm: the row kernel's build and the first products
    for name in ("assign_host_copies", "assign_rows", "assign_rows", "assign_host_copies"):
        fn = assign_host_copies if name == "assign_host_copies" else bench_10m.assign_rows
        ids[name], s = timed(fn, h, centers)
        runs[name].append(s)
        print(f"{name}: {h.N:,} rows x {nlist:,} centres in {s:.4f} s", flush=True)
    assert np.array_equal(ids["assign_host_copies"], ids["assign_rows"])

    a = np.random.default_rng(0).integers(0, nlist, size=args.n).astype(np.int32)
    sorts = {"argsort_int32": [], "argsort_uint16": []}
    order = {}
    for name in ("argsort_int32", "argsort_uint16", "argsort_uint16", "argsort_int32"):
        keys = (lambda: a) if name == "argsort_int32" else (lambda: a.astype(np.uint16))
        order[name], s = timed(lambda: np.argsort(keys(), kind="stable"))
        sorts[name].append(s)
        print(f"{name}: {args.n:,} ids in {s:.4f} s", flush=True)
    assert np.array_equal(order["argsort_int32"], order["argsort_uint16"])
    del order
    _, s = timed(ivf_ops.build_buckets, a, 1024)
    print(f"build_buckets: {args.n:,} ids in buckets of 1,024 in {s:.4f} s", flush=True)
    print(json.dumps({"device": smi, "rows": h.N, "ids": args.n, **runs, **sorts,
                      "build_buckets": s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
