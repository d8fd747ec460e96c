"""10M x 768 serve benchmark of the port, with the corpus made on the device.

Twin of ``tools/bench_10m.py``, the JAX package's 10M anchor harness, on
the same corpus: every row is drawn from ``fold_in(key(42), row_id)`` by
the port's copy of JAX's threefry (``bench/threefry.py``; on the card the
``qtt_rowgen`` kernel writes whole rows from their ids), and the host draws
(centres, spectrum, rotation) come from ``np.random.default_rng(7)`` in
the JAX harness's order. So any subset of rows can be made again from its
ids: the two-stage legs rescore with the original f32 vectors
(``GenRescorer``) although the 30 GB corpus never exists, and the CPU
tests hold this harness to the JAX one leg by leg.

The passes stream batches of ``--batch`` rows through the encoders into
preallocated buffers (``utils/device_store.DeviceAppender``): pass 0
calibrates (min / max) and keeps a 10,000-row training sample; pass A keeps
the exact top-K ground truth (f32, TF32 off) and the BQ and PQ codes; PQ4
and OPQ have a pass each; pass B the SQ codes. Then the IVF build (centres
on a device-assembled sample, assignment per batch, buckets on the host,
bucket means over rows made again by id), its ladders through the public
serving stack (``ServingPlan``, ``PipelinedSearcher``), and the residual
legs. Each leg prints the JAX harness's line, ``name: qps (ms/batch)
recall@K vs exact = r``, with the card's time from CUDA events in brackets
after it; a leg that raises prints its ``FAILED`` line and ``main`` returns
1.

    python -m quantization_tpu_torch.bench.bench_10m --n 10000000 --d 768 \\
        --dist realistic --normalize --opq --ivf --ivf-residual

Runs on the CUDA card unless ``--device`` names another (without a card
``main`` raises ``NoDeviceError``). ``QTPU_HBM_PROBE=1`` prints
``torch.cuda.mem_get_info()`` at the JAX harness's probe points.

``main(argv, keep)`` with a dict ``keep`` stores what the run builds
before its legs (``Build``: pass 0, the ground truth and the IVF build, all
on the host) there, and a later run whose ``build_key`` is equal takes it
instead of building it again: two runs over one 100M corpus build it once.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.types import ArgumentsError, DistanceType, VectorParameters
from ..models.bq import BinaryQuantizer, BQMetadata
from ..models.ivf import IVFIndex, IVFMetadata, auto_geometry
from ..models.pipeline import TwoStageIndex
from ..models.pq import PQMetadata, ProductQuantizer
from ..models.sq import ScalarQuantizerU8, SQMetadata
from ..ops import ivf as ivf_ops
from ..ops import pq as pq_ops
from ..ops import sq as sq_ops
from ..ops.dispatch import resolve_device, upload
from ..ops.kernels import bq_kernel
from ..ops.kernels.ktile import CORR_BLK
from ..ops.kernels.sq_kernel import TILE_N as SQ_TILE
from ..ops.kmeans import kmeans_batched
from ..ops.opq import train_opq
from ..ops.quantile import find_quantile_interval
from ..policy import ServingPlan
from ..serving import PipelinedSearcher
from ..utils.device_store import DeviceAppender
from . import threefry

BASE_SEED = 42  # jax.random.key(42)
HOST_SEED = 7  # np.random.default_rng(7)
PQ_SAMPLE = 10_000  # pass 0's training sample (one batch's first rows)
IVF_SAMPLE_BATCH = 131_072  # the IVF sample's cap within batch 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batch", type=int, default=250_000, help="must divide --n")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=1024)
    ap.add_argument("--sigma", type=float, default=0.5,
                    help="within-cluster noise scale (0.5: noise ~ signal)")
    ap.add_argument("--normalize", action="store_true", help="L2-normalize the rows")
    ap.add_argument("--dist", choices=("clustered", "realistic"), default="clustered",
                    help="isotropic gaussian clusters, or the power-law spectrum, "
                    "anisotropic clusters, lognormal radius and dense rotation of "
                    "'realistic'")
    ap.add_argument("--only", choices=("all", "sq", "bq", "pq", "none"), default="all",
                    help="one quantizer family's full-scan legs ('none': none)")
    ap.add_argument("--k-sweep", action="store_true",
                    help="also SQ fused exact at k = 64 and 256")
    ap.add_argument("--opq", action="store_true", help="also OPQ at the PQ geometry")
    ap.add_argument("--ivf", action="store_true", help="also the IVF indexes and ladders")
    ap.add_argument("--nlist", type=int, default=0,
                    help="IVF cluster count (0: nlist * S ~ N / 3)")
    ap.add_argument("--ivf-bucket", type=int, default=0,
                    help="IVF bucket size S (0: auto_geometry)")
    ap.add_argument("--ivf-base", choices=("all", "sq", "bq", "opq", "none"), default="all",
                    help="which non-residual IVF inner codes to run")
    ap.add_argument("--sync-latency", action="store_true",
                    help="also the per-call blocking latency")
    ap.add_argument("--ivf-residual", action="store_true",
                    help="also residual IVF-BQ / SQ / OPQ (implies --ivf)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                    "versions)")
    return ap


class RowSource:
    """The JAX harness's corpus (``_lat_rows`` / ``gen_rows`` / ``gen_dev``,
    tools/bench_10m.py:164-222) on ``device``, addressable by global row id:
    corpus rows are 0..n-1, queries ids >= n (the same distribution,
    disjoint randomness)."""

    def __init__(self, args, device):
        if args.n + args.queries > 2**31:
            raise ArgumentsError("--n + --queries must be at most 2^31: row ids are the JAX "
                                 "harness's int32 ids")
        d = args.d
        host_rng = np.random.default_rng(HOST_SEED)
        self.device = device
        self.batch_rows = args.batch
        self.sigma = float(args.sigma)
        self.normalize = bool(args.normalize)
        self.base = threefry.key(BASE_SEED, device)
        self.rot = self.spectrum = None
        if args.dist == "realistic":
            # The JAX order: the rotation's draw first, then the centres'.
            spectrum = ((1.0 + np.arange(d)) ** -0.7).astype(np.float32)
            rot = np.linalg.qr(host_rng.standard_normal((d, d)))[0].astype(np.float32)
            centers = host_rng.standard_normal((args.clusters, d)).astype(np.float32)
            centers = centers * spectrum[None, :]
            self.spectrum = torch.from_numpy(spectrum).to(device)
            self.rot = torch.from_numpy(rot).to(device)
        else:
            centers = host_rng.random((args.clusters, d), np.float32) * 2 - 1
        self.centers = torch.from_numpy(np.ascontiguousarray(centers)).to(device)

    def gen_rows(self, ids) -> torch.Tensor:
        """f32 [len(ids), D] rows of global ids (a tensor or array)."""
        ids = torch.as_tensor(ids, dtype=torch.int64).to(self.device)
        x = threefry.latent_rows(ids, self.centers, self.spectrum, self.sigma, self.base)
        if self.rot is not None:
            with pq_ops.full_f32():
                x = x @ self.rot
        if self.normalize:
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x

    def batch(self, b: int) -> torch.Tensor:
        """Corpus batch ``b``: rows [b * batch, (b + 1) * batch)."""
        b0 = b * self.batch_rows
        return self.gen_rows(torch.arange(b0, b0 + self.batch_rows, device=self.device))


class GenRescorer:
    """f32 rescoring stage whose original vectors are made again from their
    ids (``RowSource.gen_rows``): the harness twin of ``ExactRescorer``."""

    def __init__(self, rows: RowSource):
        self.rows = rows

    def encode_query(self, q):
        if isinstance(q, torch.Tensor):
            return q.to(self.rows.device, torch.float32)
        return upload(np.asarray(q, np.float32), self.rows.device)

    def score_candidates(self, eqf, cand):
        q, r = cand.shape
        rows = self.rows.gen_rows(cand.clamp(min=0).reshape(-1)).reshape(q, r, -1)
        with pq_ops.full_f32():
            return torch.einsum("qd,qrd->qr", eqf, rows)


def pack_bq(x: torch.Tensor, w8: int) -> torch.Tensor:
    """Sign bits of f32 [B, D] rows as int32 words [B, w8] (bit j of word w
    is dim 32 w + j > 0, zero past D): the JAX harness's ``pack_bq``."""
    b, d = x.shape
    bits = torch.nn.functional.pad((x > 0).to(torch.int64), (0, w8 * 32 - d))
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (bits.reshape(b, w8, 32) << shifts).sum(dim=2).to(torch.int32)


class Harness:
    """One run: the arguments, the corpus, the queries and their ground
    truth, and the legs' timing and reporting."""

    def __init__(self, args, device):
        self.args = args
        self.device = device
        self.cuda = device.type == "cuda"
        self.rows = RowSource(args, device)
        self.failed = []
        self.N, self.D, self.B, self.Q, self.K = (args.n, args.d, args.batch, args.queries,
                                                  args.k)
        self.nb = self.N // self.B
        self.queries_dev = None  # f32 [Q, D]: rows N .. N + Q - 1

    def say(self, msg: str) -> None:
        print(msg, flush=True)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        """Return a family's freed buffers to the card between families."""
        if self.cuda:
            torch.cuda.empty_cache()

    def hbm_probe(self, tag: str) -> None:
        """Free and total device memory (QTPU_HBM_PROBE=1)."""
        if os.environ.get("QTPU_HBM_PROBE") and self.cuda:
            free, total = torch.cuda.mem_get_info(self.device)
            self.say(f"[hbm] {tag}: {free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB")

    # ------------------------------------------------------------ timing
    def _events(self):
        if not self.cuda:
            return None
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timeit(self, fn, iters: int = 10):
        """(seconds per call, device ms per call or None): ``iters`` chained
        calls ended by one synchronize; the device time from CUDA events
        around them."""
        fn()
        self.sync()
        ev = self._events()
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        for _ in range(iters):
            fn()
        if ev:
            ev[1].record()
        self.sync()
        t = (time.perf_counter() - t0) / iters
        return t, (ev[0].elapsed_time(ev[1]) / iters if ev else None)

    def timeit_sync(self, fn, iters: int = 10) -> float:
        """Per-call blocking latency: a synchronize after every call."""
        fn()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            self.sync()
        return (time.perf_counter() - t0) / iters

    def recall(self, ids, gt) -> float:
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        k = self.K
        return float(np.mean([len(set(ids[r].tolist()) & set(gt[r].tolist())) / k
                              for r in range(ids.shape[0])]))

    def _line(self, name, t, dev_ms, rec, ts=None, tail=""):
        q = self.Q
        extra = ""
        if ts is not None:
            extra = f"  [sync {ts * 1e6 / q:,.0f} us/q, chained {t * 1e6 / q:,.0f} us/q]"
        device = f"  [device {dev_ms:.3f} ms/batch]" if dev_ms is not None else ""
        self.say(f"{name:18s}: {q / t:10.0f} qps  ({t * 1e3:7.2f} ms/batch)  "
                 f"recall@{self.K} vs exact = {rec:.3f}{extra}{tail}{device}")

    def _failed(self, name, e) -> None:
        self.failed.append(name)
        self.say(f"{name:18s}: FAILED {type(e).__name__}: {e}")

    def report(self, name, fn, gt) -> None:
        try:
            t, dev_ms = self.timeit(fn)
            ts = self.timeit_sync(fn) if self.args.sync_latency else None
            _, ids = fn()
            self._line(name, t, dev_ms, self.recall(ids, gt), ts)
        except Exception as e:  # noqa: BLE001 -- the leg's FAILED line; main exits 1
            self._failed(name, e)

    def report_serve(self, name, index, eq, gt, iters: int = 10, **knobs) -> None:
        """``report`` through the public PipelinedSearcher (depth 8, results
        copied to the host): the chained window of ``iters`` searches after
        eight that fill the pipe; ``--sync-latency`` adds the blocking
        ``search``."""
        try:
            k = self.K
            s = PipelinedSearcher(index, k=k, depth=8, **knobs)
            s.warmup(eq, encoded=True)
            for _ in range(8):
                s.submit(eq, encoded=True)
            s.sync()
            ev = self._events()
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            for _ in range(iters):
                s.submit(eq, encoded=True)
            if ev:
                ev[1].record()
            s.sync()
            t = (time.perf_counter() - t0) / iters
            dev_ms = ev[0].elapsed_time(ev[1]) / iters if ev else None
            ids = None
            for _, ids in s.flush():
                pass
            ts = None
            if self.args.sync_latency:
                s.search(eq, encoded=True)
                t0 = time.perf_counter()
                for _ in range(iters):
                    s.search(eq, encoded=True)
                ts = (time.perf_counter() - t0) / iters
            self._line(name, t, dev_ms, self.recall(ids, gt), ts, "  [serve-api]")
        except Exception as e:  # noqa: BLE001 -- the leg's FAILED line; main exits 1
            self._failed(name, e)

    def rescore_f32(self, ids: torch.Tensor, rr: int):
        """Top-K of the coarse ids ``ids`` [Q, rr] rescored with the rows
        made again by id; -1 ids score -inf."""
        q = ids.shape[0]
        rows = self.rows.gen_rows(ids.clamp(min=0).reshape(-1)).reshape(q, rr, -1)
        with pq_ops.full_f32():
            fs = torch.einsum("qd,qrd->qr", self.queries_dev, rows)
        fs = torch.where(ids >= 0, fs, fs.new_full((), float("-inf")))
        ts, tp = torch.topk(fs, self.K, dim=1)
        return ts, torch.gather(ids, 1, tp)

    def timed(self, label: str, t0: float, tail: str = "") -> None:
        """``label`` and the seconds since ``t0`` (after a synchronize)."""
        self.sync()
        self.say(f"{label} {time.perf_counter() - t0:.0f}s{tail}")

    def resident(self, tag: str, index: IVFIndex) -> None:
        """An IVF-BQ or IVF-PQ index's serving state in bytes (the planes or
        the transposed PQ codes, the bucket means, the slot ids and any
        per-slot row additive on the device; the bucket tables on the host),
        then, on a card, the start of the serving-peak window
        (``serving_peak``)."""
        qz = index.quantizer
        name, codes = ("planes", qz.planes) if index.metadata.kind == "bq" else ("codes",
                                                                                qz.codes_t)
        dev = {name: codes, "bucket means": index._means_dev,
               "slot ids": index._slot_ids_dev}
        rowadd = index._resid_bq if index.metadata.kind == "bq" else index._resid_pq
        if rowadd is not None:
            dev["rowadd"] = rowadd
        nbytes = {k: t.numel() * t.element_size() for k, t in dev.items()}
        host = index.bucket_ids.nbytes + index.bucket_means.nbytes
        self.say(f"{tag} resident: " + ", ".join(f"{k} {v:,} B" for k, v in nbytes.items())
                 + f" ({sum(nbytes.values()):,} B on the device; {name} "
                 f"{nbytes[name] // codes.shape[1]} B a slot x {codes.shape[1]:,} slots); "
                 f"bucket tables {host:,} B on the host")
        if self.cuda:
            self.sync()
            torch.cuda.reset_peak_memory_stats(self.device)

    def serving_peak(self, tag: str) -> None:
        """torch.cuda.max_memory_allocated since ``resident`` (a card only)."""
        if self.cuda:
            self.say(f"{tag} serving peak: {torch.cuda.max_memory_allocated(self.device):,} B "
                     "allocated")


@dataclass
class IVFBuild:
    """The IVF build over the corpus, on the host: the coarse centres f32
    [nlist, D], the residual calibration sample (batch 0's first rows, f32),
    the permutation (bucket b's slot s holds row ``perm[b * S + s]``), the
    bucket tables and the bucket means f32 [buckets, D]."""

    centers: np.ndarray
    smp: np.ndarray
    perm: np.ndarray
    bucket_ids: np.ndarray
    means: np.ndarray


@dataclass
class Build:
    """What a run makes before its legs, all on the host, so that a kept one
    pins nothing on the card: pass 0's range and training sample, pass A's
    exact top-K ids and, with --ivf, the IVF build."""

    mn: float
    mx: float
    sample: np.ndarray
    gt: np.ndarray
    ivf: Optional[IVFBuild] = None


def ivf_geometry(args):
    """(nlist, S): the flags', else ``auto_geometry``'s bucket size and
    nlist * S ~ N / 3."""
    s = args.ivf_bucket or auto_geometry(args.n, args.ivf_residual)[1]
    return args.nlist or max(1, args.n // (3 * s)), s


def build_key(args, device) -> tuple:
    """Every input of a run's ``Build``: the corpus (rows, width, batch,
    distribution, normalization, clusters, noise), the queries and K of the
    ground truth, the device it is computed on and the resolved IVF
    geometry."""
    return (args.n, args.d, args.batch, args.dist, args.normalize, args.clusters, args.sigma,
            args.queries, args.k, str(device), ivf_geometry(args) if args.ivf else None)


# ------------------------------------------------------------ the passes
def calibrate(h: Harness):
    """Pass 0: min / max over every batch (one host sync at the end) and
    the training sample, batch 0's first PQ_SAMPLE rows (host)."""
    t0 = time.perf_counter()
    mn = torch.tensor(float("inf"), device=h.device)
    mx = torch.tensor(float("-inf"), device=h.device)
    for i in range(h.nb):
        x = h.rows.batch(i)
        mn = torch.minimum(mn, x.min())
        mx = torch.maximum(mx, x.max())
        del x
    mn, mx = float(mn), float(mx)
    sample = h.rows.batch(0)[:PQ_SAMPLE].cpu().numpy()
    h.timed("pass0 (device calibration):", t0)
    h.hbm_probe("after pass0")
    return mn, mx, sample


def train_pq(h: Harness, sample, division, k):
    """Per-chunk k-means centroids f32 [k, D] of the sample, on the device."""
    chunks = torch.from_numpy(pq_ops.chunk_tensor(sample, division)).to(h.device)
    cents = kmeans_batched(chunks, k)
    return pq_ops.chunks_to_centroids(cents.cpu().numpy(), division, h.D)


def gt_update(best, queries: torch.Tensor, x: torch.Tensor, b0: int):
    """The running exact top-K (scores, ids) [Q, K] after the batch ``x`` of
    rows b0.. (f32 scores, TF32 off; among equal scores the earlier id
    first, lax.top_k's order)."""
    best_s, best_i = best
    k = best_s.shape[1]
    with pq_ops.full_f32():
        s = queries @ x.T
    ids = torch.arange(b0, b0 + x.shape[0], device=x.device).expand(s.shape[0], -1)
    vals, pos = torch.sort(torch.cat([best_s, s], dim=1), dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(torch.cat([best_i, ids], dim=1), 1, pos[:, :k])


def chunk_codes(x: torch.Tensor, division, c_chunks: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes u8 [m, B] (chunk-major) of f32 rows [B, D]."""
    return pq_ops.encode_batch(pq_ops.chunk_rows_device(x, division), c_chunks).T


def stream_codes(h: Harness, appenders, enc) -> None:
    """One pass over the corpus batches: ``enc(x)`` -> one output per
    appender, committed in order."""
    for i in range(h.nb):
        outs = enc(h.rows.batch(i))
        outs = outs if isinstance(outs, tuple) else (outs,)
        for app, o in zip(appenders, outs):
            app.append(o)


def run(args, keep=None) -> int:
    """The harness; 1 if any leg failed, else 0. ``keep``: see ``main``."""
    dev = resolve_device(args.device)
    h = Harness(args, dev)
    N, D, B, Q, K = h.N, h.D, h.B, h.Q, h.K
    cs = args.chunk_size
    m = D // cs
    dot = DistanceType.DOT

    key = build_key(args, dev)
    kept = (keep or {}).get("build")
    build = kept[1] if kept is not None and kept[0] == key else None
    if build is None:
        mn, mx, sample = calibrate(h)
    else:
        mn, mx, sample = build.mn, build.mx, build.sample
        tail = ""
        if build.ivf is not None:
            nbk, s = build.ivf.bucket_ids.shape
            tail = f" ({nbk} buckets x {s}, pad {nbk * s - N} rows)"
        h.say("kept build: pass 0, the ground truth and the IVF build of an earlier run "
              f"with the same key{tail}")
    division = pq_ops.get_vector_division(D, cs)
    want_bq = args.only in ("all", "bq")
    want_pq = args.only in ("all", "pq")
    want_sq = args.only in ("all", "sq")
    centroids = None
    if want_pq:
        t0 = time.perf_counter()
        centroids = train_pq(h, sample, division, pq_ops.CENTROIDS_COUNT)
        h.timed(f"PQ k-means ({m} chunks x 256):", t0)

    # ------------------------------------------- pass A: GT + BQ + PQ codes
    params_dot = VectorParameters(D, N, dot, False)
    alpha, offset = sq_ops.alpha_offset_from_min_max(mn, mx)
    actual, lane = sq_ops.actual_dim(D), sq_ops.lane_dim(D)
    npad = N + (-N) % SQ_TILE
    w = -(-D // 32)
    w8 = w + (-w) % 8
    h.queries_dev = h.rows.gen_rows(torch.arange(N, N + Q))
    queries = h.queries_dev.cpu().numpy()
    mult = sq_ops.multiplier_for(dot, False, alpha)

    def quantize_sq(x, a=alpha, o=offset):
        return sq_ops.quantize_batch(x, alpha=a, offset=o, distance_type=dot, invert=False,
                                     dpad=actual, lane=lane)

    best = (torch.full((Q, K), float("-inf"), device=dev),
            torch.full((Q, K), -1, dtype=torch.int64, device=dev))
    bq_planes = DeviceAppender((w8, npad), torch.int32, dev, axis=1) if want_bq else None
    pq_codes = DeviceAppender((m, npad), torch.uint8, dev, axis=1) if want_pq else None
    cents_dev = (torch.from_numpy(pq_ops.centroids_to_chunks(centroids, division)).to(dev)
                 if want_pq else None)
    gt = None if build is None else build.gt
    if gt is None or want_bq or want_pq:
        t0 = time.perf_counter()
        for i in range(h.nb):
            x = h.rows.batch(i)
            if gt is None:
                best = gt_update(best, h.queries_dev, x, i * B)
            if want_bq:
                bq_planes.append(pack_bq(x, w8).T)
            if want_pq:
                pq_codes.append(chunk_codes(x, division, cents_dev))
            del x
        if gt is None:
            gt = best[1].cpu().numpy()
        h.timed("pass A (GT + BQ + PQ encode):", t0)
        h.hbm_probe("after passA")
    if build is None:
        build = Build(mn, mx, sample, gt)
        if keep is not None:
            keep["build"] = (key, build)

    bq = eq_bq = None
    if want_bq:
        bq = BinaryQuantizer(bq_planes.finish(), BQMetadata(params_dot))
        eq_bq = bq.encode_query(queries)
        h.report("BQ fused exact", lambda: bq.top_k_device(eq_bq, K), gt)
        h.report("BQ fused approx", lambda: bq.top_k_device(eq_bq, K, method="approx"), gt)
    if want_pq:
        pq = ProductQuantizer.from_transposed(pq_codes.finish(),
                                              PQMetadata(centroids, division, params_dot))
        eq_pq = pq.encode_query(queries)
        h.report("PQ fused exact", lambda: pq.top_k_device(eq_pq, K), gt)
        h.report("PQ fused approx", lambda: pq.top_k_device(eq_pq, K, method="approx"), gt)
        del pq, eq_pq
        pq4_legs(h, sample, params_dot, gt, queries)
        if args.opq:
            opq_legs(h, sample, division, params_dot, gt, queries)
    if not want_sq and not args.ivf:
        return finish(h)

    if want_sq:
        # ------------------------------------------------ pass B: SQ codes
        sq_codes = DeviceAppender((npad, lane), torch.int8, dev)
        sq_voff = DeviceAppender((npad,), torch.float32, dev)
        t0 = time.perf_counter()
        stream_codes(h, (sq_codes, sq_voff), quantize_sq)
        h.sync()
        el = time.perf_counter() - t0
        h.say(f"pass B (SQ encode): {el:.0f}s ({N / el:,.0f} vec/s)")
        sq = ScalarQuantizerU8(sq_codes.finish(), sq_voff.finish(),
                               SQMetadata(actual, alpha, offset, mult, params_dot))
        eq_sq = sq.encode_query(queries)
        h.report_serve("SQ fused exact", sq, eq_sq, gt)
        h.report_serve("SQ fused approx", sq, eq_sq, gt, method="approx")
        if args.k_sweep:
            for kk in (64, 256):
                h.report(f"SQ fused exact k={kk}", lambda kk=kk: sq.top_k_device(eq_sq, kk), gt)
        gen_rescorer = GenRescorer(h.rows)
        for ov in (4, 8, 16):
            ts2 = TwoStageIndex(sq, gen_rescorer, oversampling=float(ov),
                                coarse_method="approx")
            h.report_serve(f"2s SQ->f32 ov={ov:g}", ts2, (eq_sq, h.queries_dev), gt)
        del ts2  # the loop variable would pin sq's codes past `del sq` below
        if want_bq:
            for ov in (8.0, 32.0, 128.0):
                two = TwoStageIndex(bq, sq, oversampling=ov)
                eq2 = (eq_bq, eq_sq)
                h.report(f"two-stage ov={ov:g}", lambda: two.top_k_device(eq2, K), gt)
            del two

            def bq_f32(rr):
                def go():
                    _, ids = bq_kernel.bq_search(
                        eq_bq.planes, bq.planes, distance_type=dot, invert=False, dim=D,
                        n_valid=bq.count, k=rr, mode="approx")
                    return h.rescore_f32(ids, rr)
                return go

            for ov in (16, 64):
                h.report(f"2s BQ->f32 ov={ov:g}", bq_f32(ov * K), gt)
        del sq, eq_sq
    del bq, eq_bq
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if args.ivf:
        ivf_legs(h, build, division, params_dot, queries, alpha, offset, mult, quantize_sq)
    return finish(h)


def pq4_legs(h, sample, params_dot, gt, queries):
    """4-bit PQ at equal code bytes: chunks of half the width, 16 centroids."""
    cs4 = max(1, h.args.chunk_size // 2)
    division4 = pq_ops.get_vector_division(h.D, cs4)
    centroids4 = train_pq(h, sample, division4, pq_ops.CENTROIDS_COUNT4)
    cents4 = torch.from_numpy(pq_ops.centroids_to_chunks(centroids4, division4)).to(h.device)
    codes = DeviceAppender((len(division4), h.N + (-h.N) % SQ_TILE), torch.uint8, h.device,
                           axis=1)
    stream_codes(h, (codes,), lambda x: chunk_codes(x, division4, cents4))
    pq4 = ProductQuantizer.from_transposed(
        codes.finish(), PQMetadata(centroids4, division4, params_dot, bits=4))
    eq = pq4.encode_query(queries)
    h.report("PQ4 fused exact", lambda: pq4.top_k_device(eq, h.K), gt)
    h.report("PQ4 fused approx", lambda: pq4.top_k_device(eq, h.K, method="approx"), gt)


def opq_legs(h, sample, division, params_dot, gt, queries):
    """OPQ at the PQ geometry, fused and rescored by the original vectors."""
    m = len(division)
    t0 = time.perf_counter()
    rot, cents = train_opq(sample, division, pq_ops.CENTROIDS_COUNT, device=h.device)
    h.timed(f"OPQ train (rotation + {m} chunks x 256):", t0)
    c_dev = torch.from_numpy(pq_ops.centroids_to_chunks(cents, division)).to(h.device)
    rot_dev = torch.from_numpy(rot).to(h.device)

    def enc(x):
        with pq_ops.full_f32():
            x = x @ rot_dev
        return chunk_codes(x, division, c_dev)

    codes = DeviceAppender((m, h.N + (-h.N) % SQ_TILE), torch.uint8, h.device, axis=1)
    stream_codes(h, (codes,), enc)
    opq = ProductQuantizer.from_transposed(
        codes.finish(), PQMetadata(cents, division, params_dot, rotation=rot))
    eq = opq.encode_query(queries)
    k = h.K
    h.report("OPQ fused exact", lambda: opq.top_k_device(eq, k), gt)
    h.report("OPQ fused approx", lambda: opq.top_k_device(eq, k, method="approx"), gt)

    def two_stage(rr):
        def go():
            _, ids = opq.top_k_device(eq, rr, method="approx")
            return h.rescore_f32(ids, rr)
        return go

    for ov in (4, 16, 64):
        h.report(f"2s OPQ->f32 ov={ov:g}", two_stage(ov * k), gt)


def ladder(fracs, nbk):
    """nscan at the scanned-bucket fractions ``fracs`` of ``nbk`` buckets,
    rounded to multiples of 256 buckets (the JAX harness's rule)."""
    return sorted({max(64, 256 * max(1, round(f * nbk / 256))) for f in fracs})


def ivf_bq_legs(n: int, nbk: int):
    """The JAX harness's IVF-BQ legs (tools/bench_10m.py:926-941) at ``n``
    rows in ``nbk`` buckets: the coarse nscans (nprobe 64) at 4.75 / 11.86
    / 23.72 % of the buckets, and the rescored (R, nprobe, nscan) at R 160
    and 320 over the two wider scans, plus R 640 and 1280 over the widest
    at capacity scale (n >= 50M), where the 1-bit coarse stage leaves most
    of the work to the rescore."""
    coarse = ladder((0.0475, 0.1186, 0.2372), nbk)
    rows = [(rr, 64, u) for u in ladder((0.1186, 0.2372), nbk) for rr in (160, 320)]
    if n >= 50_000_000:
        rows += [(rr, 64, ladder((0.2372,), nbk)[0]) for rr in (640, 1280)]
    return coarse, rows


def ivf_opq_legs(n: int, nbk: int):
    """The JAX harness's IVF-OPQ legs (tools/bench_10m.py:988-1010) at ``n``
    rows in ``nbk`` buckets: the coarse nscans (nprobe 64) at 4.75 / 11.86
    / 23.72 % of the buckets, and the rescored (R, nprobe, nscan) at R 80
    and 160 over 11.86 % and R 160 over the deepest scan. At capacity scale
    (n >= 50M) the scans stop at 11.86 %, so the deepest is that one and R
    160 over it appears twice, and R 320 and 640 follow over it."""
    cap = n >= 50_000_000
    coarse = ladder((0.0475, 0.1186) if cap else (0.0475, 0.1186, 0.2372), nbk)
    mid = ladder((0.1186,), nbk)[0]
    deep = ladder((0.1186,) if cap else (0.2372,), nbk)[0]
    rows = [(80, 64, mid), (160, 64, mid), (160, 64, deep)]
    if cap:
        rows += [(320, 64, deep), (640, 64, deep)]
    return coarse, rows


def ivf_opqr_legs(n: int, nbk: int):
    """The JAX harness's residual IVF-OPQ legs (tools/bench_10m.py:1203-1232):
    the coarse nscans as ``ivf_opq_legs``', and the rescored (R, nprobe,
    nscan) at R 40 over 11.86 % and R 40 and 160 over the deepest scan; at
    capacity scale, where coarse recall saturates by the 4.75 % scan, R 40,
    160 and 320 over 4.75 % and R 160 and 320 over 11.86 %."""
    coarse, _ = ivf_opq_legs(n, nbk)
    mid = ladder((0.1186,), nbk)[0]
    if n >= 50_000_000:
        lo = ladder((0.0475,), nbk)[0]
        return coarse, [(40, 64, lo), (160, 64, lo), (320, 64, lo), (160, 64, mid),
                        (320, 64, mid)]
    deep = ladder((0.2372,), nbk)[0]
    return coarse, [(40, 64, mid), (40, 64, deep), (160, 64, deep)]


def ivf_build(h: Harness, nlist: int, S: int) -> IVFBuild:
    """The IVF build over the corpus made again by id: the coarse centres,
    the assignment, the buckets and their means."""
    N, B = h.N, h.B
    t0 = time.perf_counter()
    smp = h.rows.batch(0)[: min(B, IVF_SAMPLE_BATCH)]
    sample_n = ivf_ops.training_rows(N, nlist)
    if sample_n <= min(B, IVF_SAMPLE_BATCH):
        train_smp = smp
    else:
        train_smp = torch.cat([h.rows.batch(i) for i in range(-(-sample_n // B))])[:sample_n]
    ivf_centers = ivf_ops.train_centers(train_smp, nlist)
    del train_smp
    # The residual calibration sample goes to the host: on the card its
    # view would pin all of batch 0 (768 MB at 250,000 x 768) through the
    # legs.
    smp = smp.cpu().numpy()
    h.timed(f"IVF coarse training ({nlist} centres, {sample_n} rows):", t0)
    t1 = time.perf_counter()
    assign = assign_rows(h, ivf_centers)
    h.timed("IVF assignment:", t1)
    t1 = time.perf_counter()
    perm, bucket_ids = ivf_ops.build_buckets(assign, S)
    del assign
    nbk = bucket_ids.shape[0]
    h.timed("IVF buckets:", t1)
    h.timed("IVF build: centers+assign+buckets", t0,
            f" ({nbk} buckets x {S}, pad {nbk * S - N} rows)")

    t0 = time.perf_counter()
    means = bucket_means_by_id(h.rows, perm, bucket_ids)
    h.timed("IVF bucket means:", t0)
    h.hbm_probe("after means")
    return IVFBuild(ivf_centers, smp, perm, bucket_ids, means)


def ivf_legs(h, build: Build, division, params_dot, queries, alpha, offset, mult,
             quantize_sq):
    """The IVF build (``build.ivf``, made here unless kept), then the
    IVF-SQ, IVF-BQ and IVF-OPQ ladders and, with --ivf-residual, the
    residual legs."""
    args, dev = h.args, h.device
    N, D, K = h.N, h.D, h.K
    dot = DistanceType.DOT
    m = len(division)
    actual, lane = sq_ops.actual_dim(D), sq_ops.lane_dim(D)
    w = -(-D // 32)
    w8 = w + (-w) % 8
    sample, gt = build.sample, build.gt

    nlist, S = ivf_geometry(args)
    h.say(f"IVF geometry: nlist={nlist} S={S}"
          f"{' (auto)' if not (args.nlist and args.ivf_bucket) else ''}")
    if build.ivf is None:
        build.ivf = ivf_build(h, nlist, S)
    ivf_centers, smp, perm, bucket_ids, means = (
        build.ivf.centers, build.ivf.smp, build.ivf.perm, build.ivf.bucket_ids,
        build.ivf.means)
    nbk = bucket_ids.shape[0]
    total_rows = nbk * S

    params_inner = VectorParameters(D, total_rows, dot, False)
    # The permuted corpus axis padded to every family's tile (SQ 512, PQ
    # 1024, BQ 2048), so no model re-pads (a re-pad copies the codes).
    npad_i = total_rows + (-total_rows) % 2048

    def meta(kind, **kw):
        return IVFMetadata(nlist=nlist, bucket_size=S, nprobe=64, kind=kind, nbuckets=nbk,
                           vector_parameters=params_dot, **kw)

    def ivf_f32(index, eq, rr, p, u):
        def go():
            _, ids = index.top_k_device(eq, rr, method="approx", nprobe=p, nscan=u)
            return h.rescore_f32(ids, rr)
        return go

    gen_rescorer = GenRescorer(h.rows)

    def serve_rescored(index, rr, u):
        """The rescored ladder as the product stack: a ServingPlan over the
        id-backed f32 rescorer (nprobe rides the index metadata, 64)."""
        plan = ServingPlan(method="approx", nscan=int(u), oversampling=rr / K)
        return plan.build(index, rescorer=gen_rescorer, k=K)

    if h.Q <= 32:
        # The latency regime: the batch union narrows with the query mix.
        sq_coarse = [(64, u) for u in (64, 256, 1024)]
        sq_rescore = [(40, 64, 256), (40, 64, 1024)]
    else:
        sq_coarse = [(64, u) for u in ladder((0.0119, 0.0475, 0.1186, 0.2372), nbk)]
        fr = ladder((0.0475, 0.1186, 0.2372), nbk)
        sq_rescore = [(rr, 64, u) for u in fr for rr in ((40,) if u == fr[0] else (40, 80))]

    qd = h.queries_dev
    if args.ivf_base in ("all", "sq"):
        t0 = time.perf_counter()
        codes = DeviceAppender((npad_i, lane), torch.int8, dev)
        voff = DeviceAppender((npad_i,), torch.float32, dev)
        encode_by_id(h.rows, perm, (codes, voff), lambda x, _s0: quantize_sq(x))
        inner = ScalarQuantizerU8(codes.finish(), voff.finish(),
                                  SQMetadata(actual, alpha, offset, mult, params_inner))
        h.timed("IVF-SQ permuted encode:", t0)
        ivf = IVFIndex(inner, bucket_ids, means, meta("sq"))
        eq = ivf.encode_query(queries)
        for p, u in sq_coarse:
            h.report_serve(f"IVF-SQ p={p} nscan={u}", ivf, eq, gt, method="approx", nprobe=p,
                           nscan=u)
        for rr, p, u in sq_rescore:
            h.report_serve(f"2s IVF-SQ->f32 R={rr} p={p} nscan={u}",
                           serve_rescored(ivf, rr, u), (eq, qd), gt)
        del ivf, inner, eq, codes, voff
        h.free()

    if args.ivf_base in ("all", "bq"):
        t0 = time.perf_counter()
        planes = DeviceAppender((w8, npad_i), torch.int32, dev, axis=1)
        encode_by_id(h.rows, perm, (planes,), lambda x, _s0: pack_bq(x, w8).T)
        inner = BinaryQuantizer(planes.finish(), BQMetadata(params_inner))
        h.timed("IVF-BQ permuted encode:", t0)
        h.hbm_probe("after bq encode")
        ivf = IVFIndex(inner, bucket_ids, means, meta("bq"))
        h.resident("IVF-BQ", ivf)
        eq = ivf.encode_query(queries)
        coarse, rows = ivf_bq_legs(N, nbk)
        for u in coarse:
            h.report_serve(f"IVF-BQ p=64 nscan={u}", ivf, eq, gt, method="approx", nprobe=64,
                           nscan=u)
        for rr, p, u in rows:
            h.report_serve(f"2s IVF-BQ->f32 R={rr} p={p} nscan={u}",
                           serve_rescored(ivf, rr, u), (eq, qd), gt)
        h.serving_peak("IVF-BQ")
        del ivf, inner, eq, planes
        h.free()

    if args.ivf_base in ("all", "opq"):
        t0 = time.perf_counter()
        rot, cents = train_opq(sample, division, pq_ops.CENTROIDS_COUNT, device=dev)
        rot_dev = torch.from_numpy(rot).to(dev)
        c_dev = torch.from_numpy(pq_ops.centroids_to_chunks(cents, division)).to(dev)

        def enc_opq(x, _s0):
            with pq_ops.full_f32():
                x = x @ rot_dev
            return chunk_codes(x, division, c_dev)

        codes = DeviceAppender((m, npad_i), torch.uint8, dev, axis=1)
        encode_by_id(h.rows, perm, (codes,), enc_opq)
        inner = ProductQuantizer.from_transposed(
            codes.finish(), PQMetadata(cents, division, params_inner, rotation=rot))
        h.timed("IVF-OPQ train+permuted encode:", t0)
        ivf = IVFIndex(inner, bucket_ids, means, meta("pq"))
        h.resident("IVF-OPQ", ivf)
        eq = ivf.encode_query(queries)
        coarse, rows = ivf_opq_legs(N, nbk)
        for u in coarse:
            h.report(f"IVF-OPQ p=64 nscan={u}", lambda u=u: ivf.top_k_device(
                eq, K, method="approx", nprobe=64, nscan=u), gt)
        for rr, p, u in rows:
            h.report(f"2s IVF-OPQ->f32 R={rr} p={p} nscan={u}", ivf_f32(ivf, eq, rr, p, u), gt)
        h.serving_peak("IVF-OPQ")
        del ivf, inner, eq, codes
        h.free()

    if not args.ivf_residual:
        return
    if S % CORR_BLK:
        h.say(f"--ivf-residual needs --ivf-bucket % {CORR_BLK} == 0; skip")
        return

    # Residual calibration sample: each sample row less its cluster's centre.
    smp_assign = ivf_ops.assign_clusters(smp, ivf_centers, device=dev)
    r_smp = smp - ivf_centers[smp_assign]
    mtab = torch.from_numpy(means).to(dev)

    def residual(x, slot0):
        b = (slot0 + torch.arange(x.shape[0], device=dev)) // S
        return x - mtab[b]

    if args.ivf_base in ("all", "bq"):
        beta = max(float(np.mean(np.abs(r_smp))), 1e-30)
        t0 = time.perf_counter()
        planes = DeviceAppender((w8, npad_i), torch.int32, dev, axis=1)
        encode_by_id(h.rows, perm, (planes,), lambda x, s0: pack_bq(residual(x, s0), w8).T)
        inner = BinaryQuantizer(planes.finish(), BQMetadata(params_inner))
        h.timed("IVF-BQ residual encode:", t0, f" (beta={beta:.4f})")
        ivf = IVFIndex(inner, bucket_ids, means,
                       meta("bq", residual=True, residual_scale=beta))
        eq = ivf.encode_query(queries)
        for u in ladder((0.0475, 0.1186, 0.2372), nbk):
            h.report(f"IVF-BQr p=64 nscan={u}", lambda u=u: ivf.top_k_device(
                eq, K, method="approx", nprobe=64, nscan=u), gt)
        for u in ladder((0.1186, 0.2372), nbk):
            for rr in (160, 320):
                h.report(f"2s IVF-BQr->f32 R={rr} p=64 nscan={u}",
                         ivf_f32(ivf, eq, rr, 64, u), gt)
        del ivf, inner, eq, planes
        h.free()

    if args.ivf_base == "bq":
        return  # the capacity-scale residual run: no SQ / OPQ legs

    if args.ivf_base in ("all", "sq"):
        # Quantile calibration: residuals are concentrated with heavy tails.
        qi = find_quantile_interval(r_smp, N, 0.99)
        mn_r, mx_r = qi if qi is not None else (float(r_smp.min()), float(r_smp.max()))
        alpha_r, offset_r = sq_ops.alpha_offset_from_min_max(mn_r, mx_r)
        mult_r = sq_ops.multiplier_for(dot, False, alpha_r)
        h.say(f"residual SQ affine (q=0.99): alpha {alpha_r:.2e} vs data {alpha:.2e} "
              f"({alpha / alpha_r:.1f}x finer)")
        t0 = time.perf_counter()
        codes = DeviceAppender((npad_i, lane), torch.int8, dev)
        voff = DeviceAppender((npad_i,), torch.float32, dev)
        encode_by_id(h.rows, perm, (codes, voff),
                        lambda x, s0: quantize_sq(residual(x, s0), alpha_r, offset_r))
        inner = ScalarQuantizerU8(codes.finish(), voff.finish(),
                                  SQMetadata(actual, alpha_r, offset_r, mult_r, params_inner))
        h.timed("IVF-SQ residual encode:", t0)
        ivf = IVFIndex(inner, bucket_ids, means, meta("sq", residual=True))
        eq = ivf.encode_query(queries)
        for u in ladder((0.0475, 0.1186, 0.2372), nbk):
            h.report(f"IVF-SQr p=64 nscan={u}", lambda u=u: ivf.top_k_device(
                eq, K, method="approx", nprobe=64, nscan=u), gt)
        for u in ladder((0.1186, 0.2372), nbk):
            h.report(f"2s IVF-SQr->f32 R=40 p=64 nscan={u}", ivf_f32(ivf, eq, 40, 64, u), gt)
        del ivf, inner, eq, codes, voff
        h.free()

    if args.ivf_base in ("all", "opq"):
        t0 = time.perf_counter()
        rot, cents = train_opq(r_smp[:20_000], division, pq_ops.CENTROIDS_COUNT, device=dev)
        rot_dev = torch.from_numpy(rot).to(dev)
        c_dev = torch.from_numpy(pq_ops.centroids_to_chunks(cents, division)).to(dev)

        def enc_opq_res(x, s0):
            with pq_ops.full_f32():
                x = residual(x, s0) @ rot_dev
            return chunk_codes(x, division, c_dev)

        codes = DeviceAppender((m, npad_i), torch.uint8, dev, axis=1)
        encode_by_id(h.rows, perm, (codes,), enc_opq_res)
        inner = ProductQuantizer.from_transposed(
            codes.finish(), PQMetadata(cents, division, params_inner, rotation=rot))
        h.timed("IVF-OPQ residual train+encode:", t0)
        ivf = IVFIndex(inner, bucket_ids, means, meta("pq", residual=True))
        h.resident("IVF-OPQr", ivf)
        eq = ivf.encode_query(queries)
        coarse, rows = ivf_opqr_legs(N, nbk)
        for u in coarse:
            h.report(f"IVF-OPQr p=64 nscan={u}", lambda u=u: ivf.top_k_device(
                eq, K, method="approx", nprobe=64, nscan=u), gt)
        for rr, p, u in rows:
            h.report(f"2s IVF-OPQr->f32 R={rr} p={p} nscan={u}", ivf_f32(ivf, eq, rr, p, u),
                     gt)
        h.serving_peak("IVF-OPQr")
        del ivf, inner, eq, codes
        h.free()


def assign_rows(h: Harness, centers: np.ndarray) -> np.ndarray:
    """Nearest-centre ids i32 [N] of every corpus row, batch by batch, in
    row sub-blocks that bound the [rows, nlist] score transient. The ids
    gather on the device and come to the host once: a copy per sub-block
    would wait for the card 6,400 times at 100M rows."""
    cblk, ccblk = ivf_ops._pad_centers(torch.from_numpy(centers).to(h.device),
                                       centers.shape[0])
    rb = h.B // (-(-h.B // 16_384))
    out = torch.empty((h.N,), dtype=torch.int32, device=h.device)
    for i in range(h.nb):
        x = h.rows.batch(i)
        for r0 in range(0, h.B, rb):
            r1 = min(r0 + rb, h.B)  # the last sub-block may be short
            out[i * h.B + r0 : i * h.B + r1] = ivf_ops._assign_blocked(x[r0:r1], cblk, ccblk)
        del x
    return out.cpu().numpy()


def bucket_means_by_id(rows: RowSource, perm: np.ndarray, bucket_ids: np.ndarray,
                       block_rows: int = 262_144) -> np.ndarray:
    """f32 [B, D] mean of each bucket's real rows, made again by id: a
    bucket's rows are contiguous in the permuted order, so each block of
    buckets is a plain sum over its [G, S, D] rows (no atomics), pad slots
    (id -1) masked out."""
    nbk, s = bucket_ids.shape
    g = max(1, block_rows // s)
    out = []
    for g0 in range(0, nbk, g):
        g1 = min(g0 + g, nbk)
        x = rows.gen_rows(perm[g0 * s : g1 * s]).reshape(g1 - g0, s, -1)
        valid = torch.from_numpy(bucket_ids[g0:g1] >= 0).to(x.device)
        valid = valid.to(torch.float32)[:, :, None]
        out.append(((x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)).cpu())
        del x
    return torch.cat(out).numpy() if out else np.zeros((0, 0), np.float32)


def encode_by_id(rows: RowSource, perm: np.ndarray, appenders, enc) -> None:
    """The permuted corpus, rows ``perm`` made again by id in blocks of a
    batch, through ``enc(x, slot0)`` into ``appenders`` (slot0 the block's
    first permuted slot: residual encoders map slot // S to the bucket)."""
    b = rows.batch_rows
    for s0 in range(0, perm.shape[0], b):
        outs = enc(rows.gen_rows(perm[s0 : s0 + b]), s0)
        for app, o in zip(appenders, outs if isinstance(outs, tuple) else (outs,)):
            app.append(o)


def finish(h: Harness) -> int:
    if h.failed:
        h.say(f"{len(h.failed)} leg(s) FAILED: {', '.join(h.failed)}")
        return 1
    return 0


def main(argv=None, keep=None) -> int:
    """The harness at the flags ``argv``; 1 if any leg failed, else 0.
    ``keep``, a dict, holds a run's ``Build`` under its ``build_key``: a run
    with an equal key takes it and prints one line saying so, any other run
    builds afresh and leaves its own there."""
    args = parser().parse_args(argv)
    args.ivf = args.ivf or args.ivf_residual
    if args.n % args.batch:
        parser().error("--batch must divide --n (fixed-shape batches)")
    if args.d % args.chunk_size:
        parser().error("--chunk-size must divide --d")
    resolve_device(args.device)  # NoDeviceError before any work
    return run(args, keep)


if __name__ == "__main__":
    sys.exit(main())
