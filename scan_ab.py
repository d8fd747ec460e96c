#!/usr/bin/env python3
"""Times the port's int8 scan kernels and PQ kernels on one CUDA card, for
comparing two checkouts in turns on the same card.

    python3 scan_ab.py                  # this checkout's quantization_tpu_torch
    python3 scan_ab.py --root DIR       # the package under DIR (another checkout)
    python3 scan_ab.py --only pq,api    # some sections: sq, bq, bqsign, pq, api, rate, split,
                                        # lut, approx, asplit, ssplit

Every kernel of the shared int8 scan body (csrc/dot_scan.cuh and the K3 /
K12 bodies of sq_kernels.cu) runs through its public wrapper at the shapes
chip_smoke.py times it, on random operands made on the card from a fixed
seed: K3, K1, K2 at 100,000 x 1024 (Q = 256 and Q = 32), K12 there too;
K9a / K9b over 256 tiles of 1024 rows of a 1,179,648 x 768 corpus and K1 / K2
with corr over the 262,144-row compact union; residual BQ at 768 dims — K5b
and the value-query K5a over 262,144 rows with rowadd and corr, K10 over 256
of 1,226 tiles of 1024 rows, and K10 over all 1,226 tiles at the serving
plan's scan width. Then sign-query BQ (bqsign): K5a, K5c and K6 at
chip_smoke.py's path 2 shape (1,000,000 x 1536, Q = 256, k = 40) and
the same searches on the +-1 int8 route (the residual forms), K10 over
256 of 1,152 tiles of 1024 rows of 768 dims and K5c over their
262,144-row union (k = 20, path 4's IVF-BQ). Then the PQ kernels at
chip_smoke.py's path 3 shape (1,000,000 rows of 768 dims, Q = 256, k = 10)
on random codes and a LUT
made on the card: K8a, K7a and K7b with 4-bit codes and the int8 LUT (the
one-hot route; K8a also at Q = 100 and 32), K8b 4-bit (bf16 LUT: the bf16
one-hot route), at 8 bits K8a, K8b, K7b and K7a (int8 LUT, the LUT-gather body's
ring), and K7b / K7a at both widths with the bf16 and bf16x2 LUTs (the
gather body), every gather-body route and the 4-bit int8 searches again at
Q = 32 and Q = 4 (the first queries of the same LUT); then path 4's PQ scans
at m = 96 with the residual bf16x2 LUT (rowadd and corr): K11 over 256 of
1,152 tiles of 1024 rows and the compact K7b / K7a over the README
geometry's 131,072-row union (k = 20), the three also at Q = 32 and 4,
and K11 of 4-bit IVF-PQ (m = 192, int8 LUT) over 256 tiles; then the
4-bit width through the public API (ProductQuantizer trained on random
vectors, the default int8 LUT): host walls of score_batch and of approx and exact top_k, and of residual
IVF-OPQ's approx top_k (nprobe 32 over 256 buckets), medians of 7 calls.
Kernel times are CUDA-event medians of 7 runs of 10 calls, in ms per
batch. The rate section builds and runs this checkout's probes,
quantization_tpu_torch/csrc/probe/wgmma_rate.cu (the issue rate of the
single-bit wgmma product against the int8 one, in turns) and
absdiff_rate.cu (K12's __vabsdiffu4 + __dp4a pair rate); the split
section select_split.cu (the scans of K1 and K5c without their select, in
each select's geometry, 4-bit int8 K7b's in its kernel's, and the exact
kernels' blocks a SM); the lut
section lut_gather_rate.cu (the PQ lookup loop's lookups a clock per SM
for the old loop and both lane maps, and the L2 rate of re-staging a LUT). K1 and K5c
are also timed at k = 600, on the radix select. The approx section times
every user of the int8 approx body through its public wrapper (K2 at Q = 256
and 32 and over the IVF union with corr, K9a, the value-query K5a and K10 at
both widths, 4-bit int8 K7a and K11) and, apart, each one's merge
(ktile.merge_candidates: torch.topk and the gather over its candidates'
width), the sign-query K5a's and K10's merges too; the asplit section builds
and runs csrc/probe/approx_split.cu (pass 1, its scan alone and the combine
of K9a, of dense K2 at Q = 256 and 32, of K10-value at the serving width and
of the sign-query K5a at 1M x 1536 and K10 over 256 tiles of 768 dims: the
warp-specialized bodies at span-block items and 2048-row items, their other
query tile, and the two-block bodies' 2048-row items; and of 4-bit int8 K7a
at 1M x 192 chunks on pq4_approx_ws_kernel against approx_parts_kernel
<NibbleRows>, whose scan it splits into the one-hot expansion and the
products; and csrc/probe/scores_split.cu, 4-bit int8 K8 at Q = 256, 100
and 32 on pq4_scores_ws_kernel (its products alone, its products and
epilogue) against the replaced scores_kernel<NibbleRows> (its scan,
products, expansion and stores alone); with the warp-specialized bodies'
ptxas registers and spills);
ssplit runs its
sign-query searches alone. Prints one JSON object:
the card (nvidia-smi name and power limit), the package's directory, the
times, the rates and the split. Needs a CUDA card; the kernels are
built from the checkout's sources on first use.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 6
Q, QS, K = 256, 32, 10
N, D = 100_000, 1024  # the SQ main path (bench.py)
IVF_D, TILE, IVF_TILES, UNION_TILES = 768, 1024, 1152, 256  # IVF-SQ at S = 1024
RES_TILES = 1226  # residual IVF-BQ at auto_geometry, 1M x 768
KK2 = 2 * K  # the IVF searches' candidate width
SERVE_K = 1280  # the calibrated plan's scan width: kk2 for 640 rescored candidates
PN, PM8, PM4 = 1_000_000, 96, 192  # PQ 8-bit and 4-bit chunks at 1M x 768 (path 3)
README_ROWS = 256 * 512  # residual OPQ's compact union at the README geometry (path 4)


def timed_ms(fn, warmup=3, iters=10, reps=7):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return statistics.median(runs)


def warm_card(dev, seconds=1.0):
    """Keeps the card busy for a while (f32 products), so the first section
    is not timed while its clocks come up from idle (the library's build)."""
    x = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x @ x
        torch.cuda.synchronize()


def wall_ms(fn, warmup=2, reps=7):
    """Median host wall of fn() with the card synchronised after it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="directory holding the quantization_tpu_torch package to time")
    ap.add_argument("--only", default="sq,bq,bqsign,pq,api,rate,split,lut,approx,asplit",
                    help="comma-separated sections to time: sq, bq, bqsign, pq, api, rate, "
                         "split, lut, approx, asplit, ssplit (default all but ssplit, "
                         "which asplit holds)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("scan_ab.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from quantization_tpu_torch import IVFIndex, ProductQuantizer, VectorParameters
    from quantization_tpu_torch.core.types import DistanceType
    from quantization_tpu_torch.ops.kernels import bq_kernel, build, pq_kernel, sq_kernel

    dev = torch.device("cuda", 0)
    build.load_library()
    warm_card(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    dot = DistanceType.DOT

    def sq_operands(n, d, q):
        codes = torch.randint(0, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
        voff = torch.rand(n, generator=g, device=dev)
        qcodes = torch.randint(0, 128, (q, d), generator=g, device=dev, dtype=torch.int8)
        qoff = torch.rand(q, generator=g, device=dev)
        return qcodes, qoff, codes, voff, torch.full((1,), 1e-3, device=dev)

    ms = {}
    if "sq" in only:
        sq_rows(ms, sq_kernel, sq_operands, dot, g, dev)
    if "bq" in only:
        bq_rows(ms, bq_kernel, dot, g, dev)
    if "bqsign" in only:
        bqsign_rows(ms, bq_kernel, dot, g, dev)
    if "pq" in only:
        pq_rows(ms, pq_kernel, g, dev)
    if "approx" in only:
        approx_rows(ms, sq_kernel, bq_kernel, pq_kernel, sq_operands, dot, g, dev)
    if "api" in only:
        api_rows(ms, ProductQuantizer, IVFIndex, VectorParameters, dot, g, dev)
    rate = probe_rates(build.find_nvcc()) if "rate" in only else None
    split = run_probe(build.find_nvcc(), "select_split") if "split" in only else None
    lut = run_probe(build.find_nvcc(), "lut_gather_rate") if "lut" in only else None
    asplit = (approx_probe(build.find_nvcc()) if "asplit" in only else
              approx_probe(build.find_nvcc(), "sign") if "ssplit" in only else None)
    print(json.dumps({"card": smi, "root": os.path.abspath(args.root), "ms": ms, "rate": rate,
                      "select_split": split, "lut_gather": lut, "approx_split": asplit}),
          flush=True)
    return 0


def sq_rows(ms, sq_kernel, sq_operands, dot, g, dev):
    """K3, K1, K2 at 100k x 1024 (Q = 256 and 32), K12; K9a / K9b and the
    compact IVF scans with corr."""
    from quantization_tpu_torch.core.types import DistanceType

    npad = N + (-N) % sq_kernel.TILE_N
    a = sq_operands(npad, D, Q)
    small = (a[0][:QS].contiguous(), a[1][:QS].contiguous(), *a[2:])
    for tag, ops in (("", a), (f"_q{QS}", small)):
        ms["sq_scores" + tag] = timed_ms(
            lambda: sq_kernel.sq_scores(*ops, distance_type=dot, n_valid=N))
        for mode in ("exact", "approx"):
            ms[f"sq_search_{mode}" + tag] = timed_ms(lambda: sq_kernel.sq_search(
                *ops, distance_type=dot, n_valid=N, k=K, mode=mode))
    ms["sq_scores_l1"] = timed_ms(
        lambda: sq_kernel.sq_scores(*a, distance_type=DistanceType.L1, n_valid=N))
    # K1 past the queue select: k = 600 (the sharded paths' k), the radix select.
    ms["sq_search_exact_k600"] = timed_ms(lambda: sq_kernel.sq_search(
        *a, distance_type=dot, n_valid=N, k=600))
    del a, small

    # IVF-SQ: the indexed scans over 256 tiles, the compact ones with corr.
    b = sq_operands(IVF_TILES * TILE, IVF_D, Q)
    sel = torch.randperm(IVF_TILES, generator=g, device=dev)[:UNION_TILES].to(torch.int32)
    for mode in ("exact", "approx"):
        ms[f"sq_search_indexed_{mode}"] = timed_ms(lambda: sq_kernel.sq_search_indexed(
            *b, sel, None, distance_type=dot, k=KK2, mode=mode, tile_n=TILE))
    rows = UNION_TILES * TILE
    comp = (b[0], b[1], b[2][:rows].contiguous(), b[3][:rows].contiguous(), b[4])
    corr = torch.randn(Q, rows // 512, generator=g, device=dev)
    for mode in ("exact", "approx"):
        ms[f"sq_search_{mode}_ivf"] = timed_ms(lambda: sq_kernel.sq_search(
            *comp, corr, distance_type=dot, n_valid=rows, k=KK2, mode=mode))
    del b, comp


def bq_rows(ms, bq_kernel, dot, g, dev):
    """Residual BQ: value queries against sign planes, rowadd and corr."""
    rows = UNION_TILES * TILE
    corr = torch.randn(Q, rows // 512, generator=g, device=dev)
    w8 = IVF_D // 32
    planes = torch.randint(-2**31, 2**31 - 1, (w8, RES_TILES * TILE), generator=g, device=dev,
                           dtype=torch.int32)
    qs = torch.randint(-127, 128, (Q, IVF_D), generator=g, device=dev, dtype=torch.int8)
    ab = torch.rand(Q, 1, generator=g, device=dev) * 0.02 + 1e-3
    aff = (qs, 2.0 * ab, -ab * qs.float().sum(1, keepdim=True))
    rowadd = torch.zeros(planes.shape[1], device=dev)
    kw = dict(distance_type=dot, invert=False, dim=IVF_D, query_affine=aff)
    cplanes, crow = planes[:, :rows].contiguous(), rowadd[:rows].contiguous()
    for mode, name in (("exact", "bq_search_exact_res"), ("approx", "bq_search_approx_res")):
        ms[name] = timed_ms(lambda: bq_kernel.bq_search(
            None, cplanes, corr, n_valid=rows, k=KK2, mode=mode, rowadd=crow, **kw))
    for name, ntiles, k in (("bq_search_indexed_res", UNION_TILES, KK2),
                            ("bq_search_indexed_res_serve", RES_TILES, SERVE_K)):
        tiles = torch.randperm(RES_TILES, generator=g, device=dev)[:ntiles].to(torch.int32)
        tcorr = torch.randn(ntiles * TILE // 512, Q, generator=g, device=dev)
        ms[name] = timed_ms(lambda: bq_kernel.bq_search_indexed(
            None, planes, tiles, tcorr, k=k, tile_n=TILE, rowadd=rowadd, **kw))
    del planes, rowadd, cplanes, crow


def bqsign_rows(ms, bq_kernel, dot, g, dev):
    """Sign-query BQ: K5a, K5c and K6 at path 2's 1M x 1536, k = 40; K10
    over 256 tiles and the compact K5c over their union at 768 dims, k = 20."""
    from quantization_tpu_torch.ops.kernels.ktile import SPAN, tile_rows

    def operands(dim, n, npad):
        w8 = dim // 32
        planes = torch.randint(-2**31, 2**31 - 1, (w8, npad), generator=g, device=dev,
                               dtype=torch.int32)
        planes[:, n:] = 0
        return torch.randint(-2**31, 2**31 - 1, (Q, w8), generator=g, device=dev,
                             dtype=torch.int32), planes

    n, dim, r = 1_000_000, 1536, 40
    qw, planes = operands(dim, n, n + (-n) % bq_kernel.TILE_N)
    kw = dict(distance_type=dot, invert=False, dim=dim, n_valid=n)
    for mode in ("exact", "approx"):
        ms[f"bq_sign_search_{mode}"] = timed_ms(
            lambda md=mode: bq_kernel.bq_search(qw, planes, k=r, mode=md, **kw))
    ms["bq_sign_scores"] = timed_ms(lambda: bq_kernel.bq_scores(qw, planes, **kw))
    ms["bq_sign_search_exact_k600"] = timed_ms(
        lambda: bq_kernel.bq_search(qw, planes, k=600, **kw))
    # The same searches on the +-1 int8 route of the JAX design (the value-
    # query bodies, PlaneRows): qs = 2 * bit - 1, hamming = pq - qs . bits,
    # score = 2 (qs . bits) + dim - 2 pq (bq_kernel.py:367-402 of the JAX
    # package).
    bits = (qw[:, :, None] >> torch.arange(32, device=dev, dtype=torch.int32)) & 1
    qs = (2 * bits - 1).reshape(Q, dim).to(torch.int8)
    pq = bits.reshape(Q, dim).sum(1)
    aff = (qs, torch.full((1,), 2.0, device=dev), (dim - 2 * pq).float().reshape(Q, 1))
    zeros = torch.zeros(planes.shape[1], device=dev)
    span = SPAN * bq_kernel.mxu_tile_n(dim, planes.shape[1])
    for mode in ("exact", "approx"):
        ms[f"bq_pm1_search_{mode}"] = timed_ms(lambda md=mode: bq_kernel._launch_res(
            aff, planes, None, zeros, None, 0, planes.shape[1], n, r, md, span,
            f"bq_search_{md}_res"))
    del planes
    qw, planes = operands(IVF_D, IVF_TILES * TILE, IVF_TILES * TILE)
    sel = torch.randperm(IVF_TILES, generator=g, device=dev)[:UNION_TILES].to(torch.int32)
    ms["bq_sign_search_indexed"] = timed_ms(lambda: bq_kernel.bq_search_indexed(
        qw, planes, sel, distance_type=dot, invert=False, dim=IVF_D, k=KK2, tile_n=TILE))
    union = planes[:, tile_rows(sel, TILE)].contiguous()
    ms["bq_sign_search_exact_ivf"] = timed_ms(lambda: bq_kernel.bq_search(
        qw, union, distance_type=dot, invert=False, dim=IVF_D, n_valid=union.shape[1], k=KK2))
    del planes, union


def run_probe(nvcc, probe):
    """Builds this checkout's csrc/probe/<probe>.cu into its _build/ and runs
    it: one dict a JSON line it prints."""
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quantization_tpu_torch")
    os.makedirs(os.path.join(pkg, "_build"), exist_ok=True)
    exe = os.path.join(pkg, "_build", probe)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-o", exe, os.path.join(pkg, "csrc", "probe", probe + ".cu")],
                   check=True, timeout=600)
    out = subprocess.run([exe], capture_output=True, text=True, check=True,
                         timeout=600).stdout
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def approx_probe(nvcc, *args):
    """Builds (in parallel) and runs csrc/probe/approx_split.cu and, unless
    args name one of its modes, scores_split.cu (4-bit int8 K8) of this
    checkout with the library's flags (-fmad=false) and ptxas -v: their JSON
    lines, and the warp-specialized bodies', bq_sign_approx_kernel's and
    the K8 kernel's ptxas lines ({"ptxas": [...]})."""
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quantization_tpu_torch")
    os.makedirs(os.path.join(pkg, "_build"), exist_ok=True)
    probes = [("approx_split", args)] + ([] if args else [("scores_split", ())])
    builds = [subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "-Xptxas", "-v", "-o", os.path.join(pkg, "_build", name),
         os.path.join(pkg, "csrc", "probe", name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, _ in probes]
    lines, log = [], ""
    for (name, margs), proc in zip(probes, builds):
        out, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"{name} does not build: {out[-2000:]}")
        log += out
        run = subprocess.run([os.path.join(pkg, "_build", name), *margs], capture_output=True,
                             text=True, check=True, timeout=600).stdout
        lines += [json.loads(line) for line in run.splitlines() if line.startswith("{")]
    return lines + [{"ptxas": ptxas_lines(log, "approx_ws_kernel")
                     + ptxas_lines(log, "approx_kernel") + ptxas_lines(log, "scores_ws_kernel")}]


def ptxas_lines(log, kernel):
    """The ptxas -v lines (registers, stack, spills, and any warning that
    ptxas serialized their wgmma) of the entry functions whose mangled name
    holds ``kernel``, one string each."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if kernel in line else None
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
        elif "Performance Loss" in line and kernel in line:
            out.append(line.strip())
    return out


def approx_rows(ms, sq_kernel, bq_kernel, pq_kernel, sq_operands, dot, g, dev):
    """Every user of the int8 approx body through its public wrapper, and
    each one's merge (torch.topk + gather over its candidates) apart."""
    from quantization_tpu_torch.ops.kernels.ktile import SLOT, SPAN, merge_candidates

    def merge(name, width, k):
        vals = torch.randn(Q, width, generator=g, device=dev)
        ids = torch.randint(0, 2**30, (Q, width), generator=g, device=dev, dtype=torch.int32)
        ms["merge_" + name] = timed_ms(lambda: merge_candidates(vals, ids, k))

    npad = N + (-N) % sq_kernel.TILE_N
    a = sq_operands(npad, D, Q)
    small = (a[0][:QS].contiguous(), a[1][:QS].contiguous(), *a[2:])
    for tag, ops in (("", a), (f"_q{QS}", small)):
        ms["sq_search_approx" + tag] = timed_ms(lambda: sq_kernel.sq_search(
            *ops, distance_type=dot, n_valid=N, k=K, mode="approx"))
    merge("sq_search_approx", -(-npad // (SPAN * sq_kernel.approx_tile_n(npad))) * SLOT, K)
    del a, small
    b = sq_operands(IVF_TILES * TILE, IVF_D, Q)
    sel = torch.randperm(IVF_TILES, generator=g, device=dev)[:UNION_TILES].to(torch.int32)
    ms["sq_search_indexed_approx"] = timed_ms(lambda: sq_kernel.sq_search_indexed(
        *b, sel, None, distance_type=dot, k=KK2, mode="approx", tile_n=TILE))
    rows = UNION_TILES * TILE
    comp = (b[0], b[1], b[2][:rows].contiguous(), b[3][:rows].contiguous(), b[4])
    corr = torch.randn(Q, rows // 512, generator=g, device=dev)
    ms["sq_search_approx_ivf"] = timed_ms(lambda: sq_kernel.sq_search(
        *comp, corr, distance_type=dot, n_valid=rows, k=KK2, mode="approx"))
    merge("sq_search_indexed_approx", rows // (SPAN * TILE) * SLOT, KK2)
    del b, comp

    # Residual BQ with value queries: K5a over the union, K10 at both widths.
    w8 = IVF_D // 32
    planes = torch.randint(-2**31, 2**31 - 1, (w8, RES_TILES * TILE), generator=g, device=dev,
                           dtype=torch.int32)
    qs = torch.randint(-127, 128, (Q, IVF_D), generator=g, device=dev, dtype=torch.int8)
    ab = torch.rand(Q, 1, generator=g, device=dev) * 0.02 + 1e-3
    kw = dict(distance_type=dot, invert=False, dim=IVF_D,
              query_affine=(qs, 2.0 * ab, -ab * qs.float().sum(1, keepdim=True)))
    rowadd = torch.zeros(planes.shape[1], device=dev)
    cplanes, crow = planes[:, :rows].contiguous(), rowadd[:rows].contiguous()
    ms["bq_search_approx_res"] = timed_ms(lambda: bq_kernel.bq_search(
        None, cplanes, corr, n_valid=rows, k=KK2, mode="approx", rowadd=crow, **kw))
    for name, ntiles, k in (("bq_search_indexed_res", UNION_TILES, KK2),
                            ("bq_search_indexed_res_serve", RES_TILES, SERVE_K)):
        tiles = torch.randperm(RES_TILES, generator=g, device=dev)[:ntiles].to(torch.int32)
        tcorr = torch.randn(ntiles * TILE // 512, Q, generator=g, device=dev)
        ms[name] = timed_ms(lambda: bq_kernel.bq_search_indexed(
            None, planes, tiles, tcorr, k=k, tile_n=TILE, rowadd=rowadd, **kw))
        merge(name, -(-ntiles * TILE // (SPAN * TILE)) * SLOT, k)
    del planes, rowadd, cplanes, crow

    # Sign-query BQ: the merges of K5a at path 2's 1M x 1536 (k = 40) and of
    # K10 over 256 tiles of 768 dims (kk2), whose kernels bqsign times.
    merge("bq_sign_search_approx", -(-1_001_472 // (SPAN * 1024)) * SLOT, 40)
    merge("bq_sign_search_indexed", UNION_TILES * TILE // (SPAN * TILE) * SLOT, KK2)

    # 4-bit PQ, int8 LUT: K7a at path 3's shape, K11 over 256 tiles.
    for name, n, npad_, sel_ in (("pq_search_approx_4bit_int8", PN, PN + (-PN) % 512, None),
                                 ("pq_search_indexed_4bit_int8", None, IVF_TILES * TILE, sel)):
        lut = (torch.randn(Q, PM4, pq_kernel.K4, generator=g, device=dev) * 2
               + torch.randn(Q, PM4, 1, generator=g, device=dev))
        codes_t = torch.randint(0, pq_kernel.K4, (PM4, npad_), generator=g, device=dev,
                                dtype=torch.uint8)
        if sel_ is None:
            codes_t[:, n:] = 0
            ms[name] = timed_ms(lambda: pq_kernel.pq_search(
                lut, codes_t, n_valid=n, k=K, mode="approx", precision="int8"))
        else:
            ms[name] = timed_ms(lambda: pq_kernel.pq_search_indexed(
                lut, codes_t, sel_, k=KK2, precision="int8", tile_n=TILE))
        del lut, codes_t


def probe_rates(nvcc):
    """The probes of csrc/probe/ of this checkout, built into its _build/:
    wgmma_rate.cu (b1 and s8 wgmma products a second per SM) and
    absdiff_rate.cu (K12's __vabsdiffu4 + __dp4a pairs a second per SM,
    with the SASS VABSDIFF4 and IDP4A counts of its kernel). One dict a
    line each prints, by probe."""
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quantization_tpu_torch")
    rates = {probe: run_probe(nvcc, probe) for probe in ("wgmma_rate", "absdiff_rate")}
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                           os.path.join(pkg, "_build", "absdiff_rate")],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    rates["absdiff_rate_sass"] = {op: sass.count(op) for op in ("VABSDIFF4", "IDP.4A")}
    return rates


def pq_rows(ms, pq_kernel, g, dev):
    """PQ at path 3's shape: the one-hot routes (4-bit: the int8 LUT's
    K8a / K7a / K7b, the bf16 LUT's K8b) and the LUT-gather body (8-bit K8
    and searches, the 4-bit bf16 / bf16x2 searches); path 4's scans."""
    pnpad = PN + (-PN) % pq_kernel.TILE_N

    def pq_operands(m, kc, npad, n=None):
        lut = (torch.randn(Q, m, kc, generator=g, device=dev) * 2
               + torch.randn(Q, m, 1, generator=g, device=dev))
        codes_t = torch.randint(0, kc, (m, npad), generator=g, device=dev,
                                dtype=torch.uint8)  # m is a multiple of 16: Mpad = m
        codes_t[:, n or npad:] = 0
        return lut, codes_t

    searches = tuple((mode, p) for p in ("bf16", "bf16x2") for mode in ("exact", "approx"))
    gather8 = (("scores", "int8"), ("scores", "bf16"), ("exact", "int8"), ("approx", "int8"))
    for bits, m, kc, rows in (
            (4, PM4, pq_kernel.K4, (("scores", "int8"), ("approx", "int8"),
                                    ("scores", "bf16"), ("exact", "int8")) + searches),
            (8, PM8, pq_kernel.K, gather8 + searches)):
        lut, codes_t = pq_operands(m, kc, pnpad, PN)
        # Q = 256, then the gather body's routes and the 4-bit int8 searches
        # at Q = 32 and 4; the 4-bit int8 K8 also at Q = 100 (the CLI's
        # batch) and 32.
        small = (("approx", "int8"), ("exact", "int8")) + searches if bits == 4 else \
            gather8 + searches
        k8 = (("scores", "int8"),) if bits == 4 else ()
        for q, tag, todo in ((Q, "", rows), (100, "_q100", k8), (QS, f"_q{QS}", k8 + small),
                             (4, "_q4", small)):
            ql = lut[:q].contiguous()
            for mode, prec in todo:
                if mode == "scores":
                    fn = lambda p=prec: pq_kernel.pq_scores(ql, codes_t, n_valid=PN,
                                                            precision=p)
                    name = f"pq_scores_{bits}bit_{prec}{tag}"
                else:
                    fn = lambda p=prec, md=mode: pq_kernel.pq_search(
                        ql, codes_t, n_valid=PN, k=K, mode=md, precision=p)
                    name = f"pq_search_{mode}_{bits}bit_{prec}{tag}"
                ms[name] = timed_ms(fn)
        del lut, codes_t

    # Path 4's PQ scans: residual OPQ (bf16x2 LUT, rowadd and corr), indexed
    # over 256 tiles and compact over the README geometry's union; 4-bit
    # IVF-PQ's K11 (int8 LUT).
    ivf_npad = IVF_TILES * TILE
    sel = torch.randperm(IVF_TILES, generator=g, device=dev)[:UNION_TILES].to(torch.int32)
    lut, codes_t = pq_operands(PM8, pq_kernel.K, ivf_npad)
    rowadd = torch.randn(ivf_npad, generator=g, device=dev)
    tcorr = torch.randn(UNION_TILES * TILE // 512, Q, generator=g, device=dev)
    cct, crow = codes_t[:, :README_ROWS].contiguous(), rowadd[:README_ROWS].contiguous()
    for q, tag in ((Q, ""), (QS, f"_q{QS}"), (4, "_q4")):
        ql, qcorr = lut[:q].contiguous(), tcorr[:, :q].contiguous()
        ms["pq_search_indexed_res_bf16x2" + tag] = timed_ms(lambda: pq_kernel.pq_search_indexed(
            ql, codes_t, sel, rowadd, qcorr, k=KK2, precision="bf16x2", tile_n=TILE))
        ccorr = torch.randn(q, README_ROWS // 512, generator=g, device=dev)
        for mode in ("exact", "approx"):
            ms[f"pq_search_{mode}_res_bf16x2" + tag] = timed_ms(
                lambda md=mode: pq_kernel.pq_search(ql, cct, crow, ccorr, n_valid=README_ROWS,
                                                    k=KK2, mode=md, precision="bf16x2"))
    del lut, codes_t, cct
    lut, codes_t = pq_operands(PM4, pq_kernel.K4, ivf_npad)
    ms["pq_search_indexed_4bit_int8"] = timed_ms(lambda: pq_kernel.pq_search_indexed(
        lut, codes_t, sel, k=KK2, precision="int8", tile_n=TILE))
    del lut, codes_t


def api_rows(ms, ProductQuantizer, IVFIndex, VectorParameters, dot, g, dev):
    """The 4-bit width through the public API, with the default int8 LUT, and
    residual IVF-OPQ's approx top_k."""
    os.environ.pop("QTPU_PQ_LUT", None)
    data = torch.randn(PN, IVF_D, generator=g, device=dev).cpu().numpy()
    queries = torch.randn(Q, IVF_D, generator=g, device=dev).cpu().numpy()
    enc = ProductQuantizer.encode(data, VectorParameters(IVF_D, PN, dot, False), chunk_size=4,
                                  bits=4, device=dev)
    eq = enc.encode_query(queries)
    ms["api_pq4_score_batch"] = wall_ms(lambda: enc.score_batch(eq))
    ms["api_pq4_top_k_approx"] = wall_ms(lambda: enc.top_k(eq, K, method="approx"))
    ms["api_pq4_top_k_exact"] = wall_ms(lambda: enc.top_k(eq, K))
    del enc, eq
    # Residual IVF-OPQ at the automatic geometry (K11 with the bf16x2 LUT).
    ivf = IVFIndex.encode(data, VectorParameters(IVF_D, PN, dot, False), quantizer="pq",
                          chunk_size=8, rotation="opq", residual=True)
    eq = ivf.encode_query(queries)
    ms["api_ivf_opq_res_top_k_approx"] = wall_ms(lambda: ivf.top_k(
        eq, K, method="approx", nprobe=32, nscan=UNION_TILES))


if __name__ == "__main__":
    sys.exit(main())
