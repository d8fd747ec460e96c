"""Ordered parallel host-side encoding.

Twin of ``quantization_tpu/utils/parallel_encode.py``. The reference encodes
PQ on a ring of worker threads whose commits to the append-only storage are
serialized by a chain of condition variables (``ConditionalVariable``,
lib.rs:41-75; ring at encoded_vectors_pq.rs:168-226), with two safety
properties pinned by tests:
  * cooperative cancellation mid-stream (tests/stop_condition.rs)
  * no leaked or blocked threads when a worker panics (test_pq.rs:275-331)

The native host encoders (``native/loader.py``) release the interpreter
lock inside their ctypes calls, so a thread pool runs them in parallel.
``ordered_parallel_map`` gives that pool the same contract: results are
committed strictly in input order (futures are consumed in submission
order), a worker exception cancels the remaining work and propagates, and
``stop_condition`` aborts between items.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from ..core.types import StoppedError

T = TypeVar("T")
R = TypeVar("R")


def ordered_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    max_threads: int = 4,
    stop_condition: Optional[Callable[[], bool]] = None,
    prefetch: Optional[int] = None,
) -> Iterator[R]:
    """Yield ``fn(item)`` for each item, in order, computed by a worker pool
    of ``max_threads`` threads with at most ``prefetch`` (default twice the
    threads) items in flight.

    Guarantees:
      * commit order == input order (the reference's condvar-ring invariant)
      * ``StoppedError`` raised promptly when stop_condition fires
      * a worker's or the iterator's exception propagates and cancels the
        outstanding work; no thread is leaked (the pool's teardown joins
        its workers)
    """
    max_threads = max(1, int(max_threads))
    if prefetch is None:
        prefetch = 2 * max_threads
    cancelled = threading.Event()

    def stopped() -> bool:
        return stop_condition is not None and bool(stop_condition())

    def guarded(item):
        if cancelled.is_set():
            raise StoppedError("cancelled")
        if stopped():
            raise StoppedError("encoding stopped by stop_condition")
        return fn(item)

    with cf.ThreadPoolExecutor(max_workers=max_threads,
                               thread_name_prefix="qtpu-torch-encode") as pool:
        pending: deque = deque()
        it = iter(items)
        exhausted = False
        try:
            while True:
                while not exhausted and len(pending) < prefetch:
                    if stopped():
                        raise StoppedError("encoding stopped by stop_condition")
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(guarded, item))
                if not pending:
                    break
                yield pending.popleft().result()  # in-order commit; re-raises
        except BaseException:
            cancelled.set()
            for fut in pending:
                fut.cancel()
            raise
