"""The port's IVFIndex search against the JAX package's, on the JAX
package's index carried across by ``ivf_from_numpy``: SQ, PQ, OPQ, 4-bit PQ
and BQ, plain and residual SQ / PQ, exact and approx, the compact and
indexed scans. The cases and tolerances are those of
tests/test_torch_ivf_model.py (tests/torch_ivf_cases.py); the JAX side runs
its fused kernels in Pallas interpret mode (QTPU_FORCE_PALLAS=1)."""

import numpy as np
import pytest
import torch

from torch_ivf_cases import CONFIGS, K, N, assert_search_matches, index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("QTPU_PQ_LUT", raising=False)


SEARCHES = [
    (name, method, scan)
    for name, (kind, _, _, _, bucket, _) in CONFIGS.items()
    for method in ("exact", "approx")
    for scan in ("compact", "indexed")
    if not (scan == "indexed" and kind != "sq" and method == "exact")
]


@pytest.mark.parametrize("name,method,scan", SEARCHES)
def test_search_matches_jax(built, force_pallas, name, method, scan):
    jivf, tivf, queries, _ = index(built, name)
    ws, wi = jivf.top_k(jivf.encode_query(queries), K, method=method, scan=scan)
    gs, gi = tivf.top_k(tivf.encode_query(queries), K, method=method, scan=scan)
    assert gs.dtype == np.float32 and gi.dtype == np.int32 and gs.shape == (8, K)
    assert_search_matches(gs, gi, np.asarray(ws), np.asarray(wi), N,
                           ties=CONFIGS[name][0] == "bq" or name == "pq")
