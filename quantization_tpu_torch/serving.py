"""Pipelined serving loop: keep several searches in flight on the card.

Twin of ``quantization_tpu/serving.py``. Every searchable of the port
exposes ``top_k_device``, which enqueues its kernels and returns device
tensors without waiting; the throughput of the card is only reached when
the host keeps enqueuing the next batch while earlier ones run, and fetches
each result when it is done. :class:`PipelinedSearcher` does that:

  * each submitted search records a CUDA event on the stream it ran on,
    right after its result has been queued for copying into pinned host
    memory, so draining the oldest result waits for that search alone and
    never for the newer ones enqueued behind it;
  * ``sync()`` waits on the newest event of every stream in use: a real
    barrier for all in-flight work (the JAX package fetched one element of
    the newest result, a barrier only on one in-order stream; ROADMAP F3);
  * the queries go up through pinned memory without blocking
    (``ops.dispatch.upload``): a copy from pageable memory synchronises
    the stream, which would hold each batch behind every search in flight.

Works over anything with ``encode_query`` + ``top_k_device``: the
quantizers (SQ / PQ / BQ), ``IVFIndex``, ``TwoStageIndex`` and
``ServingPlan.build(...)`` results. On the CPU (``device="cpu"``) the
searches run as they are submitted and no event is recorded.

Usage — request loop (one batch in, one batch out, pipelined)::

    searcher = PipelinedSearcher(index, k=10, depth=8)
    for queries in request_stream:          # each [Q, D] float32
        done = searcher.submit(queries)     # returns an OLDER result
        if done is not None:                #   once the pipe is full
            emit(done)
    for done in searcher.flush():
        emit(done)

or the generator form ``searcher.search_stream(request_stream)``.
``search(queries)`` is the deliberately blocking one-shot.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Tuple

import torch

from .core.types import ArgumentsError

__all__ = ["PipelinedSearcher"]


class PipelinedSearcher:
    """Keep ``depth`` independent searches in flight on the card.

    ``index``: any searchable with ``encode_query`` and ``top_k_device``.
    ``knobs`` pass through to every ``top_k_device`` call (e.g.
    ``method="approx"``, ``nscan=...`` for IVF); leave them empty for
    plan-built objects, which pin their own.

    ``depth`` trades result latency for throughput: a submitted batch's
    result returns ``depth`` submissions later (or at ``flush``). Results
    are FIFO, in submission order. ``materialize`` (default True) returns
    numpy arrays, copied through pinned host memory; ``materialize=False``
    returns the result tensors on the card, in stream order, without
    waiting."""

    def __init__(self, index, *, k: int = 10, depth: int = 8, materialize: bool = True,
                 **knobs):
        if depth < 1:
            raise ArgumentsError("depth must be >= 1")
        if not hasattr(index, "top_k_device") or not hasattr(index, "encode_query"):
            raise ArgumentsError(
                "index must expose encode_query and top_k_device "
                f"(got {type(index).__name__})"
            )
        self._ix = index
        self._k = int(k)
        self._depth = int(depth)
        self._materialize = bool(materialize)
        self._knobs = knobs
        # (result tensors, event or None, stream or None), oldest first
        self._pending: deque = deque()

    # ------------------------------------------------------------ core
    @property
    def depth(self) -> int:
        return self._depth

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def submit(self, queries, *, encoded: bool = False) -> Optional[Tuple]:
        """Enqueue one search; return the OLDEST result once more than
        ``depth`` are in flight, else None. Never waits for the search just
        submitted. ``encoded=True`` submits the result of
        ``index.encode_query``."""
        eq = queries if encoded else self._ix.encode_query(queries)
        out = tuple(self._ix.top_k_device(eq, self._k, **self._knobs))
        event = stream = None
        if out[0].is_cuda:
            stream = torch.cuda.current_stream(out[0].device)
            if self._materialize:
                host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
                for h, t in zip(host, out):
                    h.copy_(t, non_blocking=True)
                out = host
            event = torch.cuda.Event()
            event.record(stream)
        self._pending.append((out, event, stream))
        if len(self._pending) > self._depth:
            return self._drain_one()
        return None

    def flush(self) -> Iterator[Tuple]:
        """Drain every in-flight search, oldest first."""
        while self._pending:
            yield self._drain_one()

    def sync(self) -> None:
        """Block until every in-flight search has completed on its device
        (results stay queued: nothing is drained). Waits on the newest event
        of each stream a search ran on; a stream runs in order, so that
        covers every search before it."""
        newest = {}
        for _, event, stream in self._pending:
            if event is not None:
                newest[(stream.device, stream.cuda_stream)] = event
        for event in newest.values():
            event.synchronize()

    def search_stream(self, query_batches: Iterable) -> Iterator[Tuple]:
        """Pipelined map over a stream of query batches: one (scores, ids)
        per batch, in order, with ``depth`` in flight."""
        for q in query_batches:
            done = self.submit(q)
            if done is not None:
                yield done
        yield from self.flush()

    def search(self, queries, *, encoded: bool = False) -> Tuple:
        """One-shot BLOCKING search: drains the whole pipe first (in-flight
        results are discarded by design: use submit / flush to keep them).
        Per-call latency, not throughput."""
        for _ in self.flush():
            pass
        self.submit(queries, encoded=encoded)
        return next(self.flush())

    def warmup(self, queries, *, encoded: bool = False) -> None:
        """Run one search of this batch shape and discard it (the kernel
        library builds at its first use); the pipe is left empty."""
        self.submit(queries, encoded=encoded)
        for _ in self.flush():
            pass

    # ------------------------------------------------------------ impl
    def _drain_one(self) -> Tuple:
        out, event, _ = self._pending.popleft()
        if not self._materialize:
            return out
        if event is not None:
            event.synchronize()  # this search and its copy, nothing newer
        return tuple(t.numpy() for t in out)
