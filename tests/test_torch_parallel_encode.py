"""The port's ordered parallel ingestion: the five cases of
tests/test_parallel_encode.py, the behavioural contract of the reference's
condvar ring: strict commit order, prompt cancellation (stop_condition.rs),
no leaked threads on a worker's panic (test_pq.rs:275-331), and the
threaded native SQ encode equal to the single-threaded one."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qt
from quantization_tpu_torch.utils.parallel_encode import ordered_parallel_map

torch.set_num_threads(1)


def test_ordered_output():
    def work(i):
        time.sleep(random.random() * 0.01)
        return i * i

    out = list(ordered_parallel_map(work, range(50), max_threads=8))
    assert out == [i * i for i in range(50)]


def test_stop_condition_cancels():
    seen = []

    def work(i):
        seen.append(i)
        return i

    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 5

    with pytest.raises(qt.StoppedError):
        list(ordered_parallel_map(work, range(1000), 4, stop))
    assert len(seen) < 1000


def test_worker_exception_propagates_no_leaked_threads():
    before = threading.active_count()

    def work(i):
        if i == 13:
            raise ValueError("boom")
        time.sleep(0.001)
        return i

    with pytest.raises(ValueError, match="boom"):
        list(ordered_parallel_map(work, range(100), max_threads=4))
    # the pool's teardown joins its workers (the reference asserts
    # num_threads returns to baseline after the panicking encode,
    # test_pq.rs:288,327)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_exception_mid_iterator():
    # the reference injects a panic inside the data iterator itself
    def gen():
        for i in range(10):
            if i == 7:
                raise RuntimeError("iterator exploded")
            yield i

    with pytest.raises(RuntimeError, match="iterator exploded"):
        list(ordered_parallel_map(lambda x: x, gen(), max_threads=3))


def test_sq_native_threaded_matches_single(rng):
    n, dim = 1000, 33
    data = rng.random((n, dim), dtype=np.float32)
    params = qt.VectorParameters(dim, n, qt.DistanceType.L2, False)
    a = qt.ScalarQuantizerU8.encode(data, params, use_native=True, max_threads=1,
                                    batch_size=100, device="cpu")
    b = qt.ScalarQuantizerU8.encode(data, params, use_native=True, max_threads=4,
                                    batch_size=100, device="cpu")
    assert torch.equal(a.codes, b.codes)
    assert torch.equal(a.voffsets, b.voffsets)
