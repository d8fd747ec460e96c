"""Timing and tracing helpers: the observability layer.

Twin of ``quantization_tpu/utils/profiling.py``. The reference's profiling
story is criterion benches and wall-clock prints (SURVEY.md §5); here the
same wall-clock harness is a context manager, ``device_trace`` records a
``torch.profiler`` trace that TensorBoard and Chrome read, and ``timed``
measures steady-state time per call: between CUDA events for work on the
card, on the host clock with one final synchronise otherwise.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch


class Timer:
    """Accumulating named wall-clock timer.

    >>> t = Timer()
    >>> with t("encode"): ...
    >>> t.report()
    """

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.times.get(name, []))

    def report(self) -> str:
        lines = []
        for name, vals in self.times.items():
            lines.append(
                f"{name}: total={sum(vals):.4f}s n={len(vals)} "
                f"avg={sum(vals) / len(vals):.4f}s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card; on exit the trace is written into ``log_dir`` by
    ``tensorboard_trace_handler`` (a ``*.pt.trace.json`` file, which
    TensorBoard's profiler plugin and chrome://tracing read). A no-op when
    ``log_dir`` is None. Yields the profiler (None when off), whose
    ``key_averages()`` sum time by kernel."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _first_tensor(r):
    if isinstance(r, torch.Tensor):
        return r
    if isinstance(r, (tuple, list)):
        for x in r:
            t = _first_tensor(x)
            if t is not None:
                return t
    if isinstance(r, dict):
        return _first_tensor(list(r.values()))
    return None


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Average seconds per call of ``fn(*args)``, steady state.

    Where the result holds a CUDA tensor, the ``iters`` back-to-back calls
    run between two CUDA events on the current stream (device time, host
    gaps included only where the device waited for the host); otherwise on
    the host clock, ending in one synchronise of the card if there is one.
    """
    r = None
    for _ in range(max(warmup, 1)):
        r = fn(*args)
    t = _first_tensor(r)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters
