#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py             # the checks and times, about 2 minutes
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown per path

Builds the hand-written kernels from ``quantization_tpu_torch/csrc`` with
nvcc (one process per source, all at once), and drives the port's two main
paths through the public API, each with the kernel launch counts set to 0
just before it and read just after:

  1. SQ-u8: DOT over 100,000 x 1024 random vectors, a 256-query batch,
     top-10 exact (K1) and approx (K2), score_batch (K3), save/load.
  2. BQ + two-stage retrieval at the shape of dbpedia-entities-openai-1M
     (1,000,000 x 1536, DOT on cosine-normalised rows; synthetic, clustered
     data made on the card from the seed), Q = 256, k = 10, oversampling 4:
     BQ coarse search approx (K5a) and exact (K5c), rescored by SQ-u8 (K4)
     or by the f32 vectors; BQ score_batch (K6); a BQ save/load round trip.

The two-stage indexes then run again on a second synthetic corpus of the
same shape whose sign bits rank neighbours (small neighbourhoods), where
recall@10 is held to a floor; the BQ searches and the batches are timed on
both corpora, since the clustered one ties far more.

It holds every kernel against its plain PyTorch version on the card at the
shapes of its path, checks the results against an f32 oracle, and times the
kernels, their plain versions, the PyTorch library call that computes the
same function where there is one, an f32 matmul + top-k baseline and the
two-stage batches with CUDA events.

Every phase prints one line; any failed check raises and the exit code is
not 0. The last lines are a JSON object of the kernels, the nvidia-smi name
and power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script fails
before it prints a result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 42
# Path 1 (SQ-u8): bench.py's configuration.
N, D, Q, K = 100_000, 1024, 256, 10
# Path 2 (BQ + two-stage): dbpedia-entities-openai-1M's shape.
BN, BD, OVERSAMPLING = 1_000_000, 1536, 4.0
R = int(K * OVERSAMPLING)

SRC = "quantization_tpu_torch/csrc/"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "sq_scores": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:748"),
    "sq_search_exact": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:433"),
    "sq_search_approx": ("sq_kernels.cu", "quantization_tpu/ops/pallas/sq_kernel.py:353"),
    "sq_score_candidates": ("gather_kernels.cu",
                            "quantization_tpu/ops/pallas/gather.py:135"),
    "bq_search_approx": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:509"),
    "bq_search_exact": ("bq_kernels.cu", "quantization_tpu/ops/pallas/bq_kernel.py:605"),
    "bq_scores": ("bq_kernels.cu",
                  "quantization_tpu/ops/pallas/bq_kernel.py:671 and :716"),
}

# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# __popc issue: 16 per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), times SMs and max clock:
# the floor of the BQ kernels' own design, printed beside their bound. The
# bound itself counts the binary dot as +-1 int8 multiply-adds on the
# tensor cores, the fastest unit the card has for it.
POPC_PER_CLOCK_PER_SM = 16
# Recall@10 floor of the two-stage indexes on the neighbourhood corpus.
TWO_STAGE_RECALL_MIN = 0.8


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, warmup=3, iters=10, reps=7):
    """Median over ``reps`` runs of the mean time per call of ``iters``
    back-to-back calls, between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return statistics.median(runs)


def graph_ms(fn, iters=20, reps=7):
    """Device time per call of ``fn``, for kernels shorter than their
    wrapper's host work: ``iters`` calls captured in one CUDA graph, whose
    replays are timed between CUDA events (median of ``reps``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return timed_ms(graph.replay, warmup=2, iters=1, reps=reps) / iters


def plain_ms(fn):
    """Few reps for the plain versions, which take up to a second a call."""
    return timed_ms(fn, warmup=1, iters=1, reps=3)


def wall_ms(fn, reps=7):
    """Median host wall per call, each ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their unit's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_operands(n_valid, d, q, gen, dev):
    npad = n_valid + (-n_valid) % 512
    codes = torch.randint(0, 128, (npad, d), generator=gen, device=dev, dtype=torch.int8)
    codes[n_valid:] = 0
    voff = torch.rand(npad, generator=gen, device=dev) * 50.0
    voff[n_valid:] = 0.0
    qcodes = torch.randint(0, 128, (q, d), generator=gen, device=dev, dtype=torch.int8)
    qoff = torch.rand(q, generator=gen, device=dev) * 50.0
    mult = torch.tensor([(2.0 / 127.0) ** 2], device=dev)
    return qcodes, qoff, codes, voff, mult


def clustered(n, q, dim, gen, dev, chunk=100_000):
    """The JAX package's synthetic ANN corpus (bench/ann_data.py:95-131),
    made on the card: 64 gaussian centres with anisotropic spread, rows and
    queries cosine-normalised. Returns (data [n, dim], queries [q, dim])."""
    centers = torch.randn(64, dim, generator=gen, device=dev)
    scales = 0.3 + torch.rand(64, generator=gen, device=dev)

    def rows(count):
        out = torch.empty((count, dim), device=dev)
        for r0 in range(0, count, chunk):
            r1 = min(r0 + chunk, count)
            a = torch.randint(0, 64, (r1 - r0,), generator=gen, device=dev)
            x = torch.randn(r1 - r0, dim, generator=gen, device=dev)
            x.mul_(scales[a, None] * 0.5).add_(centers[a])
            out[r0:r1] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return out

    return rows(n), rows(q)


def neighbourhoods(n, q, dim, gen, dev, size=64, chunk=100_000):
    """A corpus whose sign bits rank neighbours, made on the card: n / size
    gaussian centres on the unit sphere; each row and query is a random
    centre plus isotropic noise of the same norm, normalised. A query's
    true top-10 lie among the ~64 rows of its centre (cosine ~0.5, against
    0 +- 0.03 for the rest), and ranking those takes more than their sign
    bits. Returns (data [n, dim], queries [q, dim])."""
    nc = n // size
    centers = torch.randn(nc, dim, generator=gen, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)

    def rows(count):
        out = torch.empty((count, dim), device=dev)
        for r0 in range(0, count, chunk):
            r1 = min(r0 + chunk, count)
            a = torch.randint(0, nc, (r1 - r0,), generator=gen, device=dev)
            x = torch.randn(r1 - r0, dim, generator=gen, device=dev)
            x.mul_(dim ** -0.5).add_(centers[a])
            out[r0:r1] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return out

    return rows(n), rows(q)


def ties_at(scores, r):
    """Mean over queries of the rows whose score equals the r-th best."""
    kth = torch.topk(scores, r, dim=1).values[:, -1:]
    return float((scores == kth).sum(1).float().mean())


def check_topk(vals, ids, want_vals, scores, n_valid, what):
    """Values equal the plain top-k exactly; every id is a distinct valid row
    whose plain score is the value claimed for its slot (so ids differ from
    the plain ones only among tied scores); an empty slot (id -1) holds
    -inf. Returns max |error| over the live slots."""
    require(torch.equal(vals, want_vals), f"{what}: values equal plain top-k")
    live = ids >= 0
    require(bool((ids[live] < n_valid).all()), f"{what}: ids < n_valid")
    require(bool(torch.isneginf(vals[~live]).all()), f"{what}: empty slots hold -inf")
    got = torch.gather(scores, 1, ids.clamp(min=0).long())
    require(torch.equal(got[live], vals[live]), f"{what}: score[id] == value")
    srt = torch.sort(ids, dim=1).values  # the -1 of empty slots come first
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    require(not bool(dup.any()), f"{what}: distinct ids")
    return float((got[live] - vals[live]).abs().max()) if bool(live.any()) else 0.0


def reset_all(*modules):
    for m in modules:
        m.reset_launches()


def counts(*modules):
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def recall(ids, oracle, k):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, oracle)]))


def profile(label, fn, reps=5):
    """One call path, three ways: the host wall per call (each call ending in
    a sync), the device span per call of back-to-back calls between CUDA
    events (host gaps excluded), and torch.profiler's device time per kernel
    (the profiler's sum can fall short of the events' span: it is printed,
    not used for the idle share)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wall = wall_ms(fn)
    span = timed_ms(fn, warmup=1, iters=5, reps=3)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    say("profile", f"{label}: host wall {wall:.4f} ms per call, device span "
        f"{span:.4f} ms back to back (idle share of the wall "
        f"{100 * max(0.0, 1 - span / wall):.1f} %), profiler kernel sum {busy:.4f} ms")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        say("profile", f"  {e.key[:70]}: {e.self_device_time_total / 1e3 / reps:.4f} ms")


class ClockSampler:
    """nvidia-smi's SM clock and power draw every 100 ms while the block
    runs; the process is stopped when it ends."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((clock, power))
        return False

    def summary(self):
        if not self.samples:
            return "no nvidia-smi samples"
        clocks = sorted(c for c, _ in self.samples)
        return (f"SM clock min {clocks[0]:.0f} / median {statistics.median(clocks):.0f} "
                f"MHz, power draw max {max(p for _, p in self.samples):.0f} W "
                f"({len(self.samples)} samples)")


def sq_path(dev, smi, do_profile):
    """Path 1: the SQ-u8 kernels against plain, then the SQ main path."""
    from quantization_tpu_torch import (
        DistanceType, ScalarQuantizerU8, VectorParameters, pairwise,
    )
    from quantization_tpu_torch.ops.kernels import sq_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    dt = DistanceType.DOT
    qcodes, qoff, codes, voff, mult = random_operands(N, D, Q, gen, dev)
    kw = dict(distance_type=dt, n_valid=N)
    plain = sq_kernel.sq_scores_plain(qcodes, qoff, codes, voff, mult, **kw)
    got = sq_kernel.sq_scores(qcodes, qoff, codes, voff, mult, **kw)
    torch.cuda.synchronize()
    err = {"sq_scores": float((got - plain).abs().max())}
    if not torch.equal(got, plain):
        ulp = (got.view(torch.int32).long() - plain.view(torch.int32).long()).abs().max()
        say("K3", f"FAIL: differs from plain by up to {int(ulp)} ulp "
            "(the epilogue must round like plain torch: no FMA contraction)")
        require(False, "K3 equals plain to the bit")
    say("K3", f"sq_scores [{Q}, {N}] x D={D}: equal to plain to the bit")

    err["sq_search_exact"] = 0.0
    for k in (10, 100, 1024):
        want_v, _ = sq_kernel.merge_exact(
            plain, torch.arange(N, device=dev, dtype=torch.int32).expand(Q, N), k
        )
        v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=k, mode="exact", **kw)
        e = check_topk(v, i, want_v, plain, N, f"K1 k={k}")
        err["sq_search_exact"] = max(err["sq_search_exact"], e)
        say("K1", f"exact k={k}: values equal plain top-k, ids equal up to ties")

    # The adversarial class-collision case (tests/test_pallas_kernels.py:388):
    # the 10 best rows all in one stride class, ids 0, 128, ..., 1152.
    n_adv = 3000
    aq, aqo, ac, av, _ = random_operands(n_adv, 256, 2, gen, dev)
    ac.zero_()
    aq.zero_()
    av[:n_adv] = torch.rand(n_adv, generator=gen, device=dev)
    top = torch.arange(10, device=dev) * 128
    av[top] = 1000.0 + torch.arange(10, device=dev, dtype=torch.float32)
    one = torch.ones(1, device=dev)
    v, i = sq_kernel.sq_search(aq, aqo, ac, av, one, distance_type=dt,
                               n_valid=n_adv, k=10, mode="exact")
    want = top.flip(0).to(torch.int32).expand(2, 10)
    require(torch.equal(i, want), "K1 adversarial: ids of the 10 planted rows")
    say("K1", "adversarial class collision: the 10 planted rows, in order")

    # k > n_valid: every valid row, then -inf / -1 (ROADMAP F11, repaired).
    n_small, k_big = 600, 1000
    sq_, so_, sc_, sv_, sm_ = random_operands(n_small, 256, 2, gen, dev)
    splain = sq_kernel.sq_scores_plain(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                                       n_valid=n_small)
    want_v, _ = sq_kernel.merge_exact(
        splain, torch.arange(n_small, device=dev, dtype=torch.int32).expand(2, n_small),
        k_big,
    )
    v, i = sq_kernel.sq_search(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                               n_valid=n_small, k=k_big, mode="exact")
    check_topk(v, i, want_v, splain, n_small, "K1 k>n_valid")
    require(int((i >= 0).sum(1).min()) == n_small, "K1 k>n_valid: every row returned")
    say("K1", f"k={k_big} > n_valid={n_small}: all rows, then -inf / -1")

    pv, _ = sq_kernel.sq_search_plain(qcodes, qoff, codes, voff, mult, k=K,
                                       mode="approx", **kw)
    v, i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=K, mode="approx", **kw)
    e = check_topk(v, i, pv, plain, N, "K2")
    ex_v, ex_i = sq_kernel.sq_search(qcodes, qoff, codes, voff, mult, k=K, mode="exact", **kw)
    overlap = torch.tensor([
        len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(i.cpu(), ex_i.cpu())
    ])
    require(float(overlap.min()) >= 0.8, f"K2 overlap with exact >= 0.8 per query "
            f"(min {float(overlap.min())})")
    err["sq_search_approx"] = e
    say("K2", f"approx k={K}: pairs equal plain scores, values equal plain approx, "
        f"overlap with exact min {float(overlap.min()):.2f} mean {float(overlap.mean()):.3f}")
    del plain, got

    # ---------------------------------------------- SQ main path, public API
    rng = np.random.default_rng(SEED)
    data = rng.random((N, D), dtype=np.float32) * 2.0 - 1.0
    queries = rng.random((Q, D), dtype=np.float32) * 2.0 - 1.0
    params = VectorParameters(D, N, DistanceType.DOT, False)
    sq_kernel.reset_launches()
    t0 = time.perf_counter()
    enc = ScalarQuantizerU8.encode(data, params)  # on the card by default
    eq = enc.encode_query(queries)
    s_ex, i_ex = enc.top_k(eq, K)
    s_ap, i_ap = enc.top_k(eq, K, method="approx")
    scores = enc.score_batch(eq)
    with tempfile.TemporaryDirectory() as tmp:
        enc.save(os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"))
        enc2 = ScalarQuantizerU8.load(
            os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"), params)
    s_re, i_re = enc2.top_k(enc2.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sq_kernel.LAUNCHES)
    say("sq-main", f"encode + queries + exact/approx top-{K} + score_batch + save/load "
        f"+ search in {wall:.2f} s; launches {launches}")
    for kname, n in launches.items():
        require(n > 0, f"SQ main path launched {kname}")

    require(enc.device.type == "cuda", "encode places the codes on the card by default")
    require(s_ex.shape == (Q, K) and i_ex.shape == (Q, K), "top_k shapes")
    require(tuple(scores.shape) == (Q, N), "score_batch shape")
    require(bool(np.isfinite(s_ex).all() and np.isfinite(s_ap).all()), "finite scores")
    require(bool(torch.isfinite(scores).all()), "finite score_batch")
    require(np.array_equal(s_re, s_ex) and np.array_equal(i_re, i_ex),
            "search after save/load equals search before")
    ref_v, _ = torch.topk(scores, K, dim=1)
    require(np.array_equal(s_ex, ref_v.cpu().numpy()), "exact top-k == topk(score_batch)")
    cpu = ScalarQuantizerU8.encode(data, params, device="cpu")
    require(torch.equal(cpu.codes, enc.codes.cpu()), "card codes == CPU codes")
    require(torch.equal(cpu.voffsets, enc.voffsets.cpu()), "card offsets == CPU offsets")
    data_dev = torch.from_numpy(data).to(dev)
    queries_dev = torch.from_numpy(queries).to(dev)
    _, oracle = torch.topk(pairwise(queries_dev, data_dev, DistanceType.DOT), K, dim=1)
    oracle = oracle.cpu().numpy()
    r_ex, r_ap = recall(i_ex, oracle, K), recall(i_ap, oracle, K)
    say("sq-main", f"codes equal the CPU encoder's; recall@{K} vs f32 oracle: "
        f"exact {r_ex:.4f} approx {r_ap:.4f}")
    require(r_ex >= 0.8 and r_ap >= 0.8, "recall@10 >= 0.8")

    # ----------------------------------------------------------------- times
    args = (eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult)
    ms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores(*args, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search(*args, k=K, **kw)),
        "sq_search_approx": timed_ms(
            lambda: sq_kernel.sq_search(*args, k=K, mode="approx", **kw)),
    }
    pms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores_plain(*args, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search_plain(*args, k=K, **kw)),
        "sq_search_approx": timed_ms(
            lambda: sq_kernel.sq_search_plain(*args, k=K, mode="approx", **kw)),
    }
    # The library yardstick of K3: cuBLAS int8 GEMM (torch._int_mm) and the
    # same affine epilogue, timed together. K1/K2 have none: no PyTorch call
    # fuses a score matrix with its top-k.
    npad = enc.codes.shape[0]

    def int_mm_scores():
        acc = torch._int_mm(eq.codes, enc.codes.t())
        return enc._mult * acc.to(torch.float32) + eq.offsets[:, None] + enc.voffsets[None, :]

    lib_ms = {"sq_scores": None, "sq_search_exact": None, "sq_search_approx": None}
    try:
        same = torch.equal(int_mm_scores(),
                           sq_kernel.sq_scores(*args, distance_type=dt, n_valid=npad))
        lib_ms["sq_scores"] = timed_ms(int_mm_scores)
        say("library", f"torch._int_mm + epilogue {'equals' if same else 'differs from'} "
            "K3's scores")
    except RuntimeError as e:  # a yardstick only: the port never calls it
        say("library", f"torch._int_mm not timed: {e}")
    f32_ms = timed_ms(lambda: torch.topk(queries_dev @ data_dev.T, K, dim=1))
    for kname in ms:
        extra = f", library {lib_ms[kname]:.4f} ms" if lib_ms[kname] else ""
        say("time", f"{kname}: kernel {ms[kname]:.4f} ms, plain {pms[kname]:.4f} ms{extra} "
            f"per {Q}-query batch at N={N} D={D} on {smi}")
    say("time", f"f32 matmul + topk baseline: {f32_ms:.4f} ms per batch at N={N} D={D} "
        f"on {smi}")
    if do_profile:
        profile("SQ top_k exact", lambda: enc.top_k(eq, K))
        profile("SQ top_k approx", lambda: enc.top_k(eq, K, method="approx"))

    # Bounds at the timed shapes: codes, offsets and queries read once, the
    # output written once; Q * N * D int8 multiply-adds (2 ops each).
    in_bytes = N * D + N * 4 + Q * D + Q * 4
    ops = 2 * Q * N * D
    bounds = {
        "sq_scores": bound(in_bytes + Q * N * 4, ops, INT8_OPS_PER_S),
        "sq_search_exact": bound(in_bytes + Q * K * 8, ops, INT8_OPS_PER_S),
        "sq_search_approx": bound(in_bytes + Q * K * 8, ops, INT8_OPS_PER_S),
    }
    recs = [dict(name=n, launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=pms[n], bound=bounds[n], library_ms=lib_ms[n]) for n in ms]
    return recs, {"f32_ms": f32_ms, "recall_exact": r_ex, "recall_approx": r_ap}


def bq_path(dev, smi, do_profile):
    """Path 2: BQ + two-stage retrieval at 1M x 1536, then every new kernel
    against its plain version at the path's shapes."""
    from quantization_tpu_torch import (
        BinaryQuantizer, DistanceType, ExactRescorer, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel, gather, ktile, sq_kernel

    mods = (sq_kernel, gather, bq_kernel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    t0 = time.perf_counter()
    data_dev, queries_dev = clustered(BN, Q, BD, gen, dev)
    data = data_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    say("bq-data", f"{BN} x {BD} clustered, normalised rows made on the card and copied "
        f"to the host in {time.perf_counter() - t0:.1f} s")
    params = VectorParameters(BD, BN, DistanceType.DOT, False)

    # ------------------------------------------------ BQ main path, public API
    reset_all(*mods)
    t0 = time.perf_counter()
    bq = BinaryQuantizer.encode(data, params)  # on the card by default
    t_bq = time.perf_counter() - t0
    sq = ScalarQuantizerU8.encode(data, params)
    t_sq = time.perf_counter() - t0 - t_bq
    two = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING)  # coarse approx: K5a
    s_a, i_a = two.top_k(two.encode_query(queries), K)
    two_e = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING, coarse_method="exact")
    s_e, i_e = two_e.top_k(two_e.encode_query(queries), K)
    two_x = TwoStageIndex(bq, ExactRescorer(data_dev, DistanceType.DOT, False),
                          oversampling=OVERSAMPLING)
    s_x, i_x = two_x.top_k(two_x.encode_query(queries), K)
    beq = bq.encode_query(queries)
    s_b, i_b = bq.top_k(beq, K)  # exact coarse alone: K5c
    scores = bq.score_batch(beq)  # K6
    with tempfile.TemporaryDirectory() as tmp:
        bq.save(os.path.join(tmp, "bq.bin"), os.path.join(tmp, "bq.json"))
        bq2 = BinaryQuantizer.load(os.path.join(tmp, "bq.bin"),
                                   os.path.join(tmp, "bq.json"), params)
    s_re, i_re = TwoStageIndex(bq2, sq, oversampling=OVERSAMPLING).top_k(
        two.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(*mods)
    say("bq-main", f"BQ encode {t_bq:.2f} s + SQ encode {t_sq:.2f} s + two-stage "
        f"approx/exact/f32 + BQ top-{K} + score_batch + save/load + search in {wall:.2f} s; "
        f"launches {launches}")
    for kname in ("sq_score_candidates", "bq_search_approx", "bq_search_exact", "bq_scores"):
        require(launches[kname] > 0, f"two-stage main path launched {kname}")

    require(bq.device.type == "cuda" and sq.device.type == "cuda",
            "encode places the codes on the card by default")
    require(tuple(bq.planes.shape) == (48, 1_001_472), "BQ planes [48, 1001472]")
    for name, s, i in (("BQ->SQ approx", s_a, i_a), ("BQ->SQ exact", s_e, i_e),
                       ("BQ->f32", s_x, i_x), ("BQ", s_b, i_b)):
        require(s.shape == (Q, K) and i.shape == (Q, K), f"{name}: shapes")
        require(bool(np.isfinite(s).all()) and bool(((i >= 0) & (i < BN)).all()),
                f"{name}: finite scores, valid ids")
    require(tuple(scores.shape) == (Q, BN) and bool(torch.isfinite(scores).all()),
            "BQ score_batch shape and values")
    require(np.array_equal(s_re, s_a) and np.array_equal(i_re, i_a),
            "two-stage search after BQ save/load equals search before")
    seq = sq.encode_query(queries)
    for name, s, i in (("approx", s_a, i_a), ("exact", s_e, i_e)):
        want = gather.sq_score_candidates_plain(
            seq.codes, seq.offsets, sq.codes, sq.voffsets, torch.from_numpy(i).to(dev),
            sq._mult, distance_type=DistanceType.DOT, n_valid=BN)
        require(np.array_equal(s, want.cpu().numpy()),
                f"BQ->SQ {name}: final scores == plain SQ score_candidates of the ids")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    rec = {"bq": recall(i_b, oracle, K), "bq_sq_approx": recall(i_a, oracle, K),
           "bq_sq_exact": recall(i_e, oracle, K), "bq_f32": recall(i_x, oracle, K)}
    say("bq-main", "recall@10 vs the f32 oracle (TF32 off): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    require(rec["bq_sq_approx"] >= rec["bq"] and rec["bq_sq_exact"] >= rec["bq"],
            "BQ->SQ recall >= BQ alone")

    # ------------------------------- the new kernels against plain, on the card
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=BD, n_valid=BN)
    qw, planes = beq.planes, bq.planes
    err = {}
    plain = bq_kernel.bq_scores_plain(qw, planes, **kw)
    got = bq_kernel.bq_scores(qw, planes, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, plain), "K6 equals plain to the bit")
    err["bq_scores"] = float((got - plain).abs().max())
    say("K6", f"bq_scores [{Q}, {BN}] x dim={BD}: equal to plain to the bit")
    del got
    tied = ties_at(plain, R)
    err["bq_search_exact"] = 0.0
    ids_all = torch.arange(BN, device=dev, dtype=torch.int32).expand(Q, BN)
    for k in (10, 40, 1024):
        want_v, _ = ktile.merge_exact(plain, ids_all, k)
        v, i = bq_kernel.bq_search(qw, planes, k=k, **kw)
        e = check_topk(v, i, want_v, plain, BN, f"K5c k={k}")
        err["bq_search_exact"] = max(err["bq_search_exact"], e)
        say("K5c", f"exact k={k}: values equal plain top-k, ids equal up to ties")
    sw, sp = qw[:2], planes[:, : bq_kernel.TILE_N].clone()
    sp[:, 700:] = 0
    skw = dict(kw, n_valid=700)
    splain = bq_kernel.bq_scores_plain(sw, sp, **skw)
    want_v, _ = ktile.merge_exact(splain, ids_all[:2, :700], 1000)
    v, i = bq_kernel.bq_search(sw, sp, k=1000, **skw)
    check_topk(v, i, want_v, splain, 700, "K5c k>n_valid")
    require(int((i >= 0).sum(1).min()) == 700, "K5c k>n_valid: every row returned")
    say("K5c", "k=1000 > n_valid=700: all rows, then -inf / -1")
    pv, _ = bq_kernel.bq_search_plain(qw, planes, k=R, mode="approx", **kw)
    v, i = bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)
    err["bq_search_approx"] = check_topk(v, i, pv, plain, BN, f"K5a k={R}")
    say("K5a", f"approx k={R}: values equal the plain approx, pairs are true scores")
    del plain
    _, cand = bq.top_k_device(beq, R, method="approx")
    cand = cand.clone()
    cand[::7, 3] = -1
    cand[::11, 5] = BN  # a padding row of the SQ codes
    cand[::13, 6] = 2**31 - 1  # past the matrix
    sargs = (seq.codes, seq.offsets, sq.codes, sq.voffsets, cand, sq._mult)
    dk = dict(distance_type=DistanceType.DOT, n_valid=BN)
    want = gather.sq_score_candidates_plain(*sargs, **dk)
    got = gather.sq_score_candidates(*sargs, **dk)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K4 equals plain to the bit")
    live = (cand >= 0) & (cand < BN)
    require(bool(torch.isneginf(got[~live]).all()), "K4: an id outside [0, n) scores -inf")
    err["sq_score_candidates"] = float((got[live] - want[live]).abs().max())
    say("K4", f"sq_score_candidates [{Q}, {R}] x D={sq.codes.shape[1]} of the coarse "
        "candidates: equal to plain to the bit, ids -1, n and 2^31-1 give -inf")

    # ----------------------------------------------------------------- times
    cand = cand.clamp(0, BN - 1)
    sargs = (seq.codes, seq.offsets, sq.codes, sq.voffsets, cand, sq._mult)
    k4_wrapper_ms = timed_ms(lambda: gather.sq_score_candidates(*sargs, **dk))
    with ClockSampler() as clocks:
        ms = {
            "sq_score_candidates": graph_ms(
                lambda: gather.sq_score_candidates(*sargs, **dk)),
            "bq_search_approx": timed_ms(
                lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)),
            "bq_search_exact": timed_ms(
                lambda: bq_kernel.bq_search(qw, planes, k=R, **kw)),
            "bq_scores": timed_ms(lambda: bq_kernel.bq_scores(qw, planes, **kw)),
        }
    say("clocks", f"during the K4/K5/K6 timings: {clocks.summary()}")
    pms = {
        "sq_score_candidates": timed_ms(
            lambda: gather.sq_score_candidates_plain(*sargs, **dk)),
        "bq_search_approx": plain_ms(
            lambda: bq_kernel.bq_search_plain(qw, planes, k=R, mode="approx", **kw)),
        "bq_search_exact": plain_ms(lambda: bq_kernel.bq_search_plain(qw, planes, k=R, **kw)),
        "bq_scores": plain_ms(lambda: bq_kernel.bq_scores_plain(qw, planes, **kw)),
    }
    f32_ms = timed_ms(lambda: torch.topk(queries_dev @ data_dev.T, K, dim=1), iters=3)
    batch_ms = batch_walls(two, two_e, two_x, queries)
    for kname in ms:
        say("time", f"{kname}: kernel {ms[kname]:.4f} ms, plain {pms[kname]:.4f} ms per "
            f"{Q}-query batch at N={BN} dim={BD} (k={R} for the searches) on {smi}")
    say("time", f"sq_score_candidates: {ms['sq_score_candidates']:.4f} ms is the device "
        f"time (CUDA graph); the wrapper called back to back takes {k4_wrapper_ms:.4f} ms")
    say("time", f"f32 matmul + topk baseline: {f32_ms:.4f} ms per batch at N={BN} "
        f"D={BD} on {smi}")
    say_batches("clustered", batch_ms, rec, smi)
    say("ties", f"clustered: {tied:.1f} rows per query score the {R}-th best BQ score")
    if do_profile:
        eqs = two.encode_query(queries)
        profile("two-stage BQ->SQ approx top_k_device", lambda: two.top_k_device(eqs, K))
        eqe = two_e.encode_query(queries)
        profile("two-stage BQ->SQ exact top_k_device", lambda: two_e.top_k_device(eqe, K))
        eqx = two_x.encode_query(queries)
        profile("two-stage BQ->f32 top_k_device", lambda: two_x.top_k_device(eqx, K))
        profile(f"K5a bq_search approx k={R} alone",
                lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw))
        pool = torch.randn(Q, -(-BN // 4096) * 128, device=dev)
        profile(f"torch.topk of a [{Q}, {pool.shape[1]}] pool, k={R}",
                lambda: torch.topk(pool, R, dim=1))

    # Bounds at the timed shapes. BQ: the planes' true words read once,
    # the output written once; the binary dot as Q * N * dim +-1 int8
    # multiply-adds (2 ops each) at the int8 tensor-core peak. The popc
    # issue time of the kernels' own design is printed beside it. K4: the
    # Q*R gathered rows (what this run's ids need), their offsets and ids,
    # the queries; Q*R*D int8 multiply-adds.
    props = torch.cuda.get_device_properties(0)
    popc_per_s = POPC_PER_CLOCK_PER_SM * props.multi_processor_count * max_sm_clock_hz()
    wt = bq_kernel.true_words(BD)
    pl_bytes = wt * 4 * BN + Q * wt * 4
    bq_ops = 2 * Q * BN * BD
    popc_ms = Q * BN * wt / popc_per_s * 1e3
    dl = sq.codes.shape[1]
    bounds = {
        "sq_score_candidates": bound(Q * R * (dl + 8) + Q * (dl + 4) + Q * R * 4,
                                     2 * Q * R * dl, INT8_OPS_PER_S),
        "bq_search_approx": bound(pl_bytes + Q * R * 8, bq_ops, INT8_OPS_PER_S),
        "bq_search_exact": bound(pl_bytes + Q * R * 8, bq_ops, INT8_OPS_PER_S),
        "bq_scores": bound(pl_bytes + Q * BN * 4, bq_ops, INT8_OPS_PER_S),
    }
    for kname in ("bq_search_approx", "bq_search_exact", "bq_scores"):
        say("bound", f"{kname}: {ms[kname]:.4f} ms against the __popc issue floor of its "
            f"design, {popc_ms:.4f} ms ({Q * BN * wt:.3e} popc at {popc_per_s:.3e}/s), "
            f"{100 * popc_ms / ms[kname]:.1f} % of it")
    recs = [dict(name=n, launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=pms[n], bound=bounds[n], library_ms=None) for n in ms]
    return recs, {"f32_ms": f32_ms, "recall": rec, "batch_ms": batch_ms,
                  "popc_ms": popc_ms, "ties_at_r": tied,
                  "k4_wrapper_ms": k4_wrapper_ms}


def batch_walls(two, two_e, two_x, queries):
    """Host wall per batch of the three two-stage indexes (encode_query +
    top_k + copy to the host), median of 21: the host's clock on a shared
    machine varies by tens of percent between runs of 7."""
    return {
        name: wall_ms(lambda idx=idx: idx.top_k(idx.encode_query(queries), K), reps=21)
        for name, idx in (("bq_sq_approx", two), ("bq_sq_exact", two_e), ("bq_f32", two_x))
    }


def say_batches(corpus, batch_ms, rec, smi):
    for name, t in batch_ms.items():
        say("time", f"two-stage {name} on the {corpus} corpus: {t:.4f} ms host wall per "
            f"{Q}-query batch (encode_query + top_k + copy to host) at recall@{K} "
            f"{rec[name]:.4f}, on {smi}")


def bq_neighbour_path(dev, smi):
    """The two-stage indexes again at 1M x 1536, on the neighbourhood
    corpus, where the sign bits rank neighbours: recall@10 is held to a
    floor, and the BQ searches and the batches are timed on a corpus that
    ties far less than the clustered one."""
    from quantization_tpu_torch import (
        BinaryQuantizer, DistanceType, ExactRescorer, ScalarQuantizerU8, TwoStageIndex,
        VectorParameters,
    )
    from quantization_tpu_torch.ops.kernels import bq_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    t0 = time.perf_counter()
    data_dev, queries_dev = neighbourhoods(BN, Q, BD, gen, dev)
    data = data_dev.cpu().numpy()
    queries = queries_dev.cpu().numpy()
    params = VectorParameters(BD, BN, DistanceType.DOT, False)
    bq = BinaryQuantizer.encode(data, params)
    sq = ScalarQuantizerU8.encode(data, params)
    two = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING)
    two_e = TwoStageIndex(bq, sq, oversampling=OVERSAMPLING, coarse_method="exact")
    two_x = TwoStageIndex(bq, ExactRescorer(data_dev, DistanceType.DOT, False),
                          oversampling=OVERSAMPLING)
    beq = bq.encode_query(queries)
    _, oracle = torch.topk(queries_dev @ data_dev.T, K, dim=1)
    oracle = oracle.cpu().numpy()
    rec = {"bq": recall(bq.top_k(beq, K)[1], oracle, K)}
    for name, idx in (("bq_sq_approx", two), ("bq_sq_exact", two_e), ("bq_f32", two_x)):
        s, i = idx.top_k(idx.encode_query(queries), K)
        require(bool(np.isfinite(s).all()) and bool(((i >= 0) & (i < BN)).all()),
                f"neighbourhoods {name}: finite scores, valid ids")
        rec[name] = recall(i, oracle, K)
    say("bq-neigh", f"{BN} x {BD} neighbourhood corpus made, encoded and searched in "
        f"{time.perf_counter() - t0:.1f} s; recall@{K} vs the f32 oracle (TF32 off): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    for name in ("bq_sq_approx", "bq_sq_exact", "bq_f32"):
        require(rec[name] >= TWO_STAGE_RECALL_MIN and rec[name] > rec["bq"],
                f"neighbourhoods {name}: recall@{K} >= {TWO_STAGE_RECALL_MIN} and above "
                "BQ alone")
    tied = ties_at(bq.score_batch(beq), R)
    kw = dict(distance_type=DistanceType.DOT, invert=False, dim=BD, n_valid=BN)
    qw, planes = beq.planes, bq.planes
    ms = {
        "bq_search_approx": timed_ms(
            lambda: bq_kernel.bq_search(qw, planes, k=R, mode="approx", **kw)),
        "bq_search_exact": timed_ms(lambda: bq_kernel.bq_search(qw, planes, k=R, **kw)),
        "bq_scores": timed_ms(lambda: bq_kernel.bq_scores(qw, planes, **kw)),
    }
    batch_ms = batch_walls(two, two_e, two_x, queries)
    for kname, t in ms.items():
        say("time", f"{kname} on the neighbourhood corpus: kernel {t:.4f} ms per "
            f"{Q}-query batch (k={R} for the searches) on {smi}")
    say_batches("neighbourhood", batch_ms, rec, smi)
    say("ties", f"neighbourhoods: {tied:.1f} rows per query score the {R}-th best BQ score")
    return {"recall_at_10": rec, "two_stage_batch_ms": batch_ms, "kernel_ms": ms,
            "ties_at_r": tied}


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def main():
    t_start = time.perf_counter()
    do_profile = "--profile" in sys.argv[1:]
    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", f"{name} capability {cap[0]}.{cap[1]}; nvidia-smi: {smi}; "
        f"max SM clock {max_sm_clock_hz() / 1e6:.0f} MHz; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    require(cap[0] == 9, "compute capability 9.x (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False

    from quantization_tpu_torch.ops.kernels import build

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    build.load_library()
    info = build.BUILD_INFO or {"seconds": 0.0, "log": "(already built)"}
    say("build", f"ok in {time.perf_counter() - t0:.1f} s (nvcc, one process per source: "
        f"{info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            say("build", "ptxas " + line.strip())

    # ------------------------------------------------------- 3. the paths
    sq_recs, sq_info = sq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    bq_recs, bq_info = bq_path(dev, smi, do_profile)
    torch.cuda.empty_cache()
    neigh = bq_neighbour_path(dev, smi)

    kernels = []
    for r in sq_recs + bq_recs:
        src, replaces = KERNELS[r["name"]]
        bound_ms, bound_by = r.pop("bound")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SRC + src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
    for kr in kernels:
        say("bound", f"{kr['name']}: {kr['ms']:.4f} ms against a bound of "
            f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), "
            f"{100 * kr['bound_ms'] / kr['ms']:.1f} % of it, on {smi}")
    say("wall", f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "kernels": kernels,
        "f32_baseline_ms": {"sq_100k_x_1024": sq_info["f32_ms"],
                            "bq_1m_x_1536": bq_info["f32_ms"]},
        "recall_at_10": {"sq_exact": sq_info["recall_exact"],
                         "sq_approx": sq_info["recall_approx"], **bq_info["recall"]},
        "two_stage_batch_ms": bq_info["batch_ms"],
        "bq_popc_floor_ms": bq_info["popc_ms"],
        "k4_wrapper_ms": bq_info["k4_wrapper_ms"],
        "ties_at_r": bq_info["ties_at_r"],
        "neighbourhoods": neigh,
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
