"""The port's ann_benchmark CLI against the JAX package's on the
``pq_opq_rotation`` case of tests/test_ann_cli.py (full-scan PQ behind an OPQ rotation, chunk size 4), on
the CPU: recall@10 within 0.02 (tests/test_torch_ann_cli.py). A file of
its own: the port's k-means on one CPU thread takes about a minute at this
size."""

import torch

from test_torch_ann_cli import check_case

torch.set_num_threads(1)


def test_cli_pq_opq_rotation_equals_the_jax_cli(monkeypatch):
    check_case("pq_opq_rotation", monkeypatch)
