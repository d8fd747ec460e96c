"""Serving auto-configuration: the JAX package's measured frontier as an API.

Twin of ``quantization_tpu/policy.py``, with the same rules and constants:

* ``recommend(index, target_recall, ...)`` — a :class:`ServingPlan` seeded
  from the JAX package's measured frontier (its BASELINE tables), with an
  optional calibration sweep that walks the plan's knobs on a query sample
  against the exact f32 oracle until the target recall is met. The tables
  pick the regime; only a measurement lands within +-0.02 of a target on
  the caller's data.
* ``ServingPlan.build(index, data)`` — the plan as a searchable object: a
  ``_MethodPinned`` wrapper (or a ``TwoStageIndex`` over one) that pins
  method / scan / nscan in the returned object only; the index and its
  metadata are never mutated. ``ServingPlan.serve`` wraps it in a
  :class:`~quantization_tpu_torch.serving.PipelinedSearcher`.
* ``exact_topk(queries, data, ...)`` — the blocked f32 oracle on the
  device, TF32 off, O(Q x block) memory.

The seed tables are the JAX package's TPU measurements of recall against
scanned fraction; they are recall numbers, which hold for the port, whose
searches equal the JAX package's. A sharded index (one that carries a
device mesh) gets the sharded f32 rescorer over its own mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .core.distances import pairwise_score
from .core.types import ArgumentsError, DistanceType
from .models.pipeline import ExactRescorer, TwoStageIndex
from .ops.dispatch import resolve_device, upload
from .ops.topk import blocked_topk


def exact_topk(queries, data, distance_type, invert, k, block_rows=1 << 18, device=None):
    """(scores, ids) tensors of the exact f32 top-k, blocked on the device.

    A tensor corpus is scored on its own device and sliced in place; a
    numpy array or memmap goes up one block at a time to ``device``
    (default: the CUDA card), never whole. Products run in full f32."""
    if isinstance(data, torch.Tensor):
        dev = data.device
    else:
        dev = resolve_device(device)
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=dev, dtype=torch.float32)
    else:
        q = upload(np.asarray(queries, np.float32), dev)

    def score_block(b0, b1):
        blk = data[b0:b1]
        if isinstance(blk, torch.Tensor):
            blk = blk.to(torch.float32)
        else:
            blk = upload(np.asarray(blk, np.float32), dev)
        return pairwise_score(q, blk, distance_type, invert)

    return blocked_topk(score_block, int(data.shape[0]), k, block_rows=block_rows)


def recall_at_k(ids, gt_ids) -> float:
    """Mean over queries of |ids ∩ gt_ids| / k, k = gt_ids' width."""
    ids, gt_ids = _host(ids), _host(gt_ids)
    k = gt_ids.shape[1]
    return float(np.mean([
        len(set(ids[r].tolist()) & set(gt_ids[r].tolist())) / k
        for r in range(gt_ids.shape[0])
    ]))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class ServingPlan:
    """One point on the serving frontier, buildable and replayable.

    ``oversampling`` <= 1 means coarse-only (no rescore stage); ``nscan`` is
    the IVF scanned-bucket budget (None for full-scan indexes).
    ``expected_recall`` is the measured recall when the plan came out of a
    calibration sweep, else None."""

    method: str = "approx"
    scan: str = "auto"
    nscan: Optional[int] = None
    oversampling: float = 1.0
    expected_recall: Optional[float] = None
    calibrated: bool = False
    notes: str = ""
    history: list = field(default_factory=list)  # (knobs, recall) pairs

    def build(self, index, data=None, *, rescorer=None, k: int = 10):
        """A searchable object implementing encode_query / top_k /
        top_k_device. ``data`` (the original f32 vectors: a tensor, array
        or memmap) backs the f32 rescore stage when the plan has one; pass
        ``rescorer`` to reuse one instead. The knobs are pinned in the
        returned object only."""
        if self.nscan is not None and not _is_ivf(index):
            raise ArgumentsError("nscan plan needs an IVF index")
        pinned = _MethodPinned(index, self.method, self.scan, self.nscan)
        if self.oversampling <= 1.0:
            return pinned
        if rescorer is None:
            if data is None:
                raise ArgumentsError(
                    "a rescored plan needs `data` (original vectors) or an explicit "
                    "`rescorer`")
            p = index.params if hasattr(index, "params") else index.metadata.vector_parameters
            rescorer = _make_rescorer(index, data, p.distance_type, p.invert)
        return TwoStageIndex(pinned, rescorer, oversampling=self.oversampling,
                             coarse_method=self.method)

    def serve(self, index, data=None, *, rescorer=None, k: int = 10, depth: int = 8):
        """``build`` wrapped in a ``PipelinedSearcher`` keeping ``depth``
        searches in flight."""
        from .serving import PipelinedSearcher

        return PipelinedSearcher(self.build(index, data, rescorer=rescorer, k=k), k=k,
                                 depth=depth)


def _make_rescorer(index, data, dt, invert):
    """The f32 rescorer of a plan, matched to the index's engine: an index
    that carries a device mesh (the sharded quantizers) gets a
    ``ShardedExactRescorer`` over the same mesh and axis, so a rescored plan
    never funnels the whole f32 corpus through one device when the coarse
    stage is sharded. Otherwise ``ExactRescorer`` on the index's device,
    host-resident for a memmap corpus (a card tensor is used in place)."""
    mesh = getattr(index, "mesh", None)
    if mesh is not None:
        from .parallel.sharded import ShardedExactRescorer

        return ShardedExactRescorer(data, dt, invert, mesh=mesh,
                                    axis=getattr(index, "axis", "shard"))
    device = getattr(index, "device", None)
    if device is None and isinstance(data, torch.Tensor):
        device = data.device
    return ExactRescorer(data, dt, invert, host_resident=isinstance(data, np.memmap),
                         device=device)


def _is_ivf(index) -> bool:
    """Only the IVF families take scan= / nscan= knobs; every full-scan
    quantizer also has ``.metadata``, so test for the IVF-only field."""
    return hasattr(getattr(index, "metadata", None), "nbuckets")


class _MethodPinned:
    """Coarse-only searchable pinning the plan's method / scan / nscan, so
    ``top_k(eq, k)`` replays the plan with no extra arguments; also the
    coarse stage of a rescored plan's ``TwoStageIndex``."""

    def __init__(self, index, method, scan, nscan=None):
        self._ix, self._method, self._scan = index, method, scan
        self._nscan = nscan

    @property
    def count(self):
        return self._ix.count

    def encode_query(self, queries):
        return self._ix.encode_query(queries)

    def _pin(self, kw):
        kw.setdefault("method", self._method)
        if _is_ivf(self._ix):
            kw.setdefault("scan", self._scan)
            if self._nscan is not None:
                kw.setdefault("nscan", int(self._nscan))
        return kw

    def top_k(self, eq, k, **kw):
        return self._ix.top_k(eq, k, **self._pin(kw))

    def top_k_device(self, eq, k, **kw):
        return self._ix.top_k_device(eq, k, **self._pin(kw))


# The JAX package's measured IVF-SQ coarse recall against scanned fraction at
# Q=256 (its BASELINE "IVF probe-limited serving", 10M realistic). Seeds the
# sweep's first probe; calibration owns the final word.
_IVF_FRACTION_CURVE = [
    (0.012, 0.162), (0.049, 0.525), (0.122, 0.814), (0.244, 0.868),
]
# Coarse saturation per family (realistic anchor): above this, add the f32
# rescore rather than more scanning.
_COARSE_CEILING = {"sq": 0.86, "bq": 0.33, "pq": 0.18}
# Batch-diversity exponent: the union fraction scales sublinearly in Q (query
# probe sets overlap); Q=32 needed ~1/5 the fraction of Q=256 at equal recall,
# so f ~ Q^a with a = ln(5)/ln(8).
_Q_DIVERSITY_EXP = 0.774
# Uncalibrated floor: Q=1 measured full coarse recall at ~0.3% of the
# buckets; never seed below 1%.
_SEED_FRACTION_FLOOR = 0.01


def _seed_fraction(target: float, q_batch: int) -> float:
    """Scanned fraction whose measured Q=256 coarse recall first meets
    ``target``, scaled by batch diversity. Within the measured span the seed
    lands within two calibration rungs (nscan doublings) of the calibrated
    plan; above the coarse ceiling it saturates at the table's last row and
    the rescore stage closes the gap."""
    f = _IVF_FRACTION_CURVE[-1][0]
    for fi, r in _IVF_FRACTION_CURVE:
        if r >= target:
            f = fi
            break
    scale = (max(q_batch, 1) / 256.0) ** _Q_DIVERSITY_EXP
    return min(1.0, f * scale + _SEED_FRACTION_FLOOR)


def recommend(index, target_recall: float, *, k: int = 10, q_batch: int = 256, queries=None,
              data=None, tolerance: float = 0.02, max_evals: int = 12) -> ServingPlan:
    """A serving plan meeting ``target_recall`` at minimal scan cost.

    With ``queries`` + ``data``: the calibration sweep — walk the knob ladder
    (IVF: nscan doubling until coarse recall saturates, then rescore depth
    doubling; full-scan: rescore depth), measuring recall@k on the sample
    against the exact f32 oracle, and return the first (cheapest)
    configuration whose recall is >= ``target_recall - tolerance``, or the
    best one measured, labelled unreachable. Without them: the static
    table-seeded plan. ``index`` is a built quantizer (SQ / BQ / PQ) or an
    IVF index."""
    if not (0.0 < target_recall <= 1.0):
        raise ArgumentsError("target_recall must be in (0, 1]")
    is_ivf = _is_ivf(index)
    kind = index.metadata.kind if is_ivf else _family_of(index)
    ceiling = _COARSE_CEILING.get(kind, 0.8)

    plan = ServingPlan()
    if is_ivf:
        nb = index.metadata.nbuckets
        f = _seed_fraction(min(target_recall, ceiling), q_batch)
        # Per-query floor: each query's top-k lives in its nearest k-means
        # cell(s), whose rows span ~nb/nlist buckets.
        depth = max(1, -(-nb // max(index.metadata.nlist, 1)))
        plan.nscan = max(1, min(nb, max(int(round(f * nb)), min(nb, q_batch * depth))))
        if target_recall > ceiling - 0.05:
            plan.oversampling = 4.0
        plan.notes = f"seeded from BASELINE IVF tables (f={f:.3f} of {nb} buckets)"
    else:
        if kind == "sq":
            plan.oversampling = 1.0 if target_recall <= 0.85 else 4.0
        elif kind == "bq":
            plan.oversampling = max(4.0, 16.0 * target_recall)
        else:  # pq family: a coarse / compression code, always rescored
            plan.oversampling = 16.0
        plan.notes = "seeded from BASELINE full-scan tables"

    if queries is None or data is None:
        return plan

    # ---- calibration sweep -------------------------------------------
    p = index.params if hasattr(index, "params") else None
    dt = p.distance_type if p else DistanceType.DOT
    invert = p.invert if p else False
    _, gt = exact_topk(queries, data, dt, invert, k, device=getattr(index, "device", None))
    gt = _host(gt)
    eq = index.encode_query(queries)
    rescorer = _make_rescorer(index, data, dt, invert)

    def measure(nscan, ov):
        trial = ServingPlan(method=plan.method, scan=plan.scan, nscan=nscan, oversampling=ov)
        obj = trial.build(index, data, rescorer=rescorer, k=k)
        teq = eq if ov <= 1.0 else obj.encode_query(queries)
        _, ids = obj.top_k(teq, k)
        r = recall_at_k(ids, gt)
        plan.history.append(({"nscan": nscan, "oversampling": ov}, r))
        return r

    bar = target_recall - tolerance
    evals = 0
    best = None
    nscan = plan.nscan
    ov = plan.oversampling if not is_ivf else 1.0
    prev = -1.0
    nb = index.metadata.nbuckets if is_ivf else None
    while evals < max_evals:
        r = measure(nscan, ov)
        evals += 1
        if r >= bar:
            best = (nscan, ov, r)
            break
        saturated = r - prev < 0.01 and prev >= 0.0
        prev = r
        if is_ivf and nscan < nb and not saturated:
            nscan = min(nb, nscan * 2)  # more scanning first
        elif ov <= 1.0:
            ov, prev = 4.0, -1.0  # add the f32 rescore stage
        elif ov < 64.0:
            ov *= 2.0  # deepen the rescore
        elif is_ivf and nscan < nb:
            nscan, prev = min(nb, nscan * 2), -1.0
        else:
            break  # ladder exhausted
    if best is None:
        knobs, r = max(plan.history, key=lambda h: h[1])
        plan.nscan, plan.oversampling = knobs["nscan"], knobs["oversampling"]
        plan.expected_recall = r
        plan.calibrated = True
        plan.notes += (f"; target {target_recall} unreachable on this ladder "
                       f"(best measured {r:.3f})")
        return plan
    plan.nscan, plan.oversampling, plan.expected_recall = best
    plan.calibrated = True
    plan.notes += f"; calibrated on {_host(queries).shape[0]} queries"
    return plan


def _family_of(index) -> str:
    name = type(index).__name__.lower()
    for kind in ("sq", "scalarquantizer"), ("bq", "binary"), ("pq", "product"):
        if kind[1] in name or name.startswith(kind[0]):
            return kind[0]
    return "sq"
