"""A / B of the f32 products in ``bench_10m.py``'s PQ / OPQ legs: the port's
(full f32, TF32 off) against those of the JAX harness on a TPU, where an
f32 dot without a precision runs at XLA's default there, one bf16 pass:
each input rounded to bf16, the products summed in f32.

Run B wraps ``bench_10m.main`` in a ``torch`` function mode that rounds the
f32 inputs of every matrix product to bf16 (``OneBf16Pass``): the corpus's
dense rotation, the ground truth, the k-means distances and sums, the OPQ
rotation and its Procrustes step, the encode's distances, the f32 rescore
and the IVF build's products. It leaves out what the JAX package computes
at HIGHEST precision (``pq_model.encode_queries``: the query's rotation and
its LUT; the residual bucket term) and the hand-written kernels, which are
not ``torch`` functions. Each run prints the harness's lines; then one line
a leg with both recalls beside the TPU's (BASELINE.md), and last one JSON
object of them.

    python -m quantization_tpu_torch.bench.precision_ab [bench_10m flags]

The flags default to the 10M anchor's PQ / OPQ legs (``--n 10000000
--dist realistic --normalize --only pq --opq``).
"""

import contextlib
import io
import json
import sys

import torch
from torch.overrides import TorchFunctionMode

from quantization_tpu_torch.bench import bench_10m
from quantization_tpu_torch.models import ivf as ivf_model
from quantization_tpu_torch.models import pq as pq_model
from quantization_tpu_torch.ops.pq import full_f32

ANCHOR_ARGV = ["--n", "10000000", "--dist", "realistic", "--normalize", "--only", "pq",
               "--opq"]
# The JAX run on one TPU v5e chip: recall@10 of the 10M anchor's PQ / OPQ
# legs (BASELINE.md:268-301) and of the 100M IVF-OPQ legs (:624-627).
TPU_RECALL = {"PQ fused approx": 0.004, "OPQ fused approx": 0.188, "PQ4 fused approx": 0.002,
              "2s OPQ->f32 ov=4": 0.393, "2s OPQ->f32 ov=16": 0.634,
              "2s OPQ->f32 ov=64": 0.833, "IVF-OPQ p=64 nscan=5376": 0.105,
              "2s IVF-OPQ->f32 R=640 p=64 nscan=13568": 0.554}
PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.Tensor.__matmul__,
            torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm}


def _bf16(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, (list, tuple)):
        return type(x)(_bf16(v) for v in x)
    return x


class OneBf16Pass(TorchFunctionMode):
    """Every f32 matrix product with its inputs rounded to bf16 and summed
    in f32, a TPU's default f32 dot; ``exact()`` suspends it."""

    def __init__(self):
        super().__init__()
        self.depth = 0

    @contextlib.contextmanager
    def exact(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth or func not in PRODUCTS:
            return func(*args, **kwargs)
        with full_f32():
            return func(*_bf16(args), **kwargs)


@contextlib.contextmanager
def tpu_products():
    """``OneBf16Pass`` over the harness, but for the products the JAX
    package computes at HIGHEST precision."""
    mode = OneBf16Pass()
    saved = pq_model.encode_queries, ivf_model._bucket_term

    def exact(fn):
        def run(*a, **kw):
            with mode.exact():
                return fn(*a, **kw)
        return run

    pq_model.encode_queries, ivf_model._bucket_term = map(exact, saved)
    try:
        with mode:
            yield
    finally:
        pq_model.encode_queries, ivf_model._bucket_term = saved


def run(argv, products):
    """(exit code, {leg: recall@10}) of ``bench_10m.main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), products():
        rc = bench_10m.main(argv)
    printed = out.getvalue()
    print(printed, end="", flush=True)
    rec = {}
    for line in printed.splitlines():
        name, sep, rest = line.partition(": ")
        if sep and "recall@" in rest:
            rec[name.strip()] = float(rest.split("vs exact = ")[1].split()[0])
    return rc, rec


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv) or ANCHOR_ARGV
    torch.backends.cuda.matmul.allow_tf32 = False
    rc_a, a = run(argv, contextlib.nullcontext)
    rc_b, b = run(argv, tpu_products)
    rows = {}
    for leg in a:
        rows[leg] = {"f32": a[leg], "one_bf16_pass": b.get(leg), "tpu": TPU_RECALL.get(leg)}
        print(f"[precision] {leg}: f32 {a[leg]:.3f}, one bf16 pass {b.get(leg, float('nan')):.3f}"
              + (f", TPU v5e (BASELINE.md) {TPU_RECALL[leg]:.3f}" if leg in TPU_RECALL else ""),
              flush=True)
    print(json.dumps({"argv": argv, "exit": [rc_a, rc_b], "recall_at_10": rows}))
    return rc_a or rc_b


if __name__ == "__main__":
    sys.exit(main())
