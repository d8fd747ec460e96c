#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the hand-written kernels from ``quantization_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the main path's
shapes, drives the main path once through the public API (SQ-u8 DOT over
100,000 x 1024 random vectors, a 256-query batch, top-10 exact and approx),
checks that the path went through every kernel, and times the kernels, their
plain versions and an f32 matmul + top-k baseline with CUDA events.

Every phase prints one line; any failure raises and the exit code is not 0.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script fails before it
prints a result.
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

N, D, Q, K = 100_000, 1024, 256, 10  # bench.py's configuration
SEED = 42
SOURCE = "quantization_tpu_torch/csrc/sq_kernels.cu"
NEG = -3.4e38  # ktile.NEG: the score of an empty candidate slot
REPLACES = {
    "sq_scores": "quantization_tpu/ops/pallas/sq_kernel.py:748",
    "sq_search_exact": "quantization_tpu/ops/pallas/sq_kernel.py:433",
    "sq_search_approx": "quantization_tpu/ops/pallas/sq_kernel.py:353",
}


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


def check_topk(vals, ids, want_vals, scores, n_valid, what):
    """Values equal the plain top-k exactly; every id is a distinct valid row
    whose plain score is the value claimed for its slot (so ids differ from
    the plain ones only among tied scores). Returns max |error|."""
    require(torch.equal(vals, want_vals), f"{what}: values equal plain top-k")
    live = ids >= 0
    require(bool((ids[live] < n_valid).all()), f"{what}: ids < n_valid")
    require(bool((vals[~live] == NEG).all()), f"{what}: empty slots hold NEG")
    got = torch.gather(scores, 1, ids.clamp(min=0).long())
    require(torch.equal(got[live], vals[live]), f"{what}: score[id] == value")
    srt = torch.sort(ids, dim=1).values  # the -1 of empty slots come first
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    require(not bool(dup.any()), f"{what}: distinct ids")
    return float((got[live] - vals[live]).abs().max()) if bool(live.any()) else 0.0


def main():
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
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    require(cap[0] == 9, "compute capability 9.x (Hopper)")

    from quantization_tpu_torch import (
        DistanceType, ScalarQuantizerU8, VectorParameters, pairwise,
    )
    from quantization_tpu_torch.ops.kernels import build, sq_kernel

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    build.load_library()
    info = build.BUILD_INFO or {"seconds": 0.0, "log": "(already built)"}
    say("build", f"ok in {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say("build", "ptxas " + line.strip())

    # ------------------------------------ 3. kernels vs plain, on the card
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
        want_v, _ = sq_kernel.merge_candidates(
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

    # k > n_valid: every valid row, then NEG / -1.
    n_small, k_big = 600, 1000
    sq_, so_, sc_, sv_, sm_ = random_operands(n_small, 256, 2, gen, dev)
    splain = sq_kernel.sq_scores_plain(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                                       n_valid=n_small)
    want_v, _ = sq_kernel.merge_candidates(
        splain, torch.arange(n_small, device=dev, dtype=torch.int32).expand(2, n_small),
        k_big,
    )
    v, i = sq_kernel.sq_search(sq_, so_, sc_, sv_, sm_, distance_type=dt,
                               n_valid=n_small, k=k_big, mode="exact")
    check_topk(v, i, want_v, splain, n_small, "K1 k>n_valid")
    require(int((i >= 0).sum(1).min()) == n_small, "K1 k>n_valid: every row returned")
    say("K1", f"k={k_big} > n_valid={n_small}: all rows, then NEG / -1")

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

    # ---------------------------------------------- 4. main path, public API
    rng = np.random.default_rng(SEED)
    data = rng.random((N, D), dtype=np.float32) * 2.0 - 1.0
    queries = rng.random((Q, D), dtype=np.float32) * 2.0 - 1.0
    params = VectorParameters(D, N, DistanceType.DOT, False)
    sq_kernel.reset_launches()
    t0 = time.perf_counter()
    enc = ScalarQuantizerU8.encode(data, params, device=dev)
    eq = enc.encode_query(queries)
    s_ex, i_ex = enc.top_k(eq, K)
    s_ap, i_ap = enc.top_k(eq, K, method="approx")
    scores = enc.score_batch(eq)
    with tempfile.TemporaryDirectory() as tmp:
        enc.save(os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"))
        enc2 = ScalarQuantizerU8.load(
            os.path.join(tmp, "codes.bin"), os.path.join(tmp, "meta.json"), params,
            device=dev,
        )
    s_re, i_re = enc2.top_k(enc2.encode_query(queries), K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sq_kernel.LAUNCHES)
    say("main", f"encode + queries + exact/approx top-{K} + score_batch + save/load "
        f"+ search in {wall:.2f} s; launches {launches}")
    for kname, n in launches.items():
        require(n > 0, f"main path launched {kname}")

    require(s_ex.shape == (Q, K) and i_ex.shape == (Q, K), "top_k shapes")
    require(tuple(scores.shape) == (Q, N), "score_batch shape")
    require(bool(np.isfinite(s_ex).all() and np.isfinite(s_ap).all()), "finite scores")
    require(bool(torch.isfinite(scores).all()), "finite score_batch")
    require(np.array_equal(s_re, s_ex) and np.array_equal(i_re, i_ex),
            "search after save/load equals search before")
    ref_v, _ = torch.topk(scores, K, dim=1)
    require(np.array_equal(s_ex, ref_v.cpu().numpy()), "exact top-k == topk(score_batch)")
    # The codes equal the CPU encoder's byte for byte.
    cpu = ScalarQuantizerU8.encode(data, params)
    require(torch.equal(cpu.codes, enc.codes.cpu()), "card codes == CPU codes")
    require(torch.equal(cpu.voffsets, enc.voffsets.cpu()), "card offsets == CPU offsets")
    data_dev = torch.from_numpy(data).to(dev)
    queries_dev = torch.from_numpy(queries).to(dev)
    _, oracle = torch.topk(pairwise(queries_dev, data_dev, DistanceType.DOT), K, dim=1)
    oracle = oracle.cpu().numpy()

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, oracle)]))

    r_ex, r_ap = recall(i_ex), recall(i_ap)
    say("main", f"codes equal the CPU encoder's; recall@{K} vs f32 oracle: "
        f"exact {r_ex:.4f} approx {r_ap:.4f}")
    require(r_ex >= 0.8 and r_ap >= 0.8, "recall@10 >= 0.8")

    # -------------------------------------------------------------- 5. times
    ms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, k=K, **kw)),
        "sq_search_approx": timed_ms(lambda: sq_kernel.sq_search(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, k=K,
            mode="approx", **kw)),
    }
    plain_ms = {
        "sq_scores": timed_ms(lambda: sq_kernel.sq_scores_plain(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, **kw)),
        "sq_search_exact": timed_ms(lambda: sq_kernel.sq_search_plain(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, k=K, **kw)),
        "sq_search_approx": timed_ms(lambda: sq_kernel.sq_search_plain(
            eq.codes, eq.offsets, enc.codes, enc.voffsets, enc._mult, k=K,
            mode="approx", **kw)),
    }
    f32_ms = timed_ms(lambda: torch.topk(queries_dev @ data_dev.T, K, dim=1))
    for kname in ms:
        say("time", f"{kname}: kernel {ms[kname]:.4f} ms, plain {plain_ms[kname]:.4f} ms "
            f"per {Q}-query batch at N={N} D={D} on {smi}")
    say("time", f"f32 matmul + topk baseline: {f32_ms:.4f} ms per batch on {smi}")

    kernels = [
        {"name": kname, "route": "cuda", "source": SOURCE, "replaces": REPLACES[kname],
         "launches": launches[kname], "max_abs_err": err[kname],
         "ms": ms[kname], "plain_ms": plain_ms[kname]}
        for kname in ms
    ]
    print(json.dumps({"kernels": kernels, "f32_baseline_ms": f32_ms,
                      "recall_at_10": {"exact": r_ex, "approx": r_ap}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
