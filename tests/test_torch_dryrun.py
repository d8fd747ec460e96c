"""The port's multi-device dry run (quantization_tpu_torch/dryrun.py), the
twin of __graft_entry__.py's ``dryrun_multichip``, on the CPU: at n = 8 (a
("shard", "qdp") mesh of 4 x 2, as the JAX package's on its 8 virtual
devices) and n = 3 (a 1-D mesh), every sharded path runs to its end. The
CPU is named: without it the dry run takes the card
(tests/test_torch_imports.py holds that it then raises here)."""

import pytest
import torch

from quantization_tpu_torch import dryrun

torch.set_num_threads(1)

PATHS = {"calibrate_encode", "kmeans_step", "sharded_quantizers", "streaming_encode",
         "two_stage", "sharded_ivf", "residual_sharded_ivf", "recommend_plan",
         "pipelined_searcher"}


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_runs_every_sharded_path(n):
    assert set(dryrun.dryrun_multichip(n, device="cpu")) == PATHS


def test_dryrun_main(capsys):
    assert set(dryrun.main(["2", "--device", "cpu"])) == PATHS
    assert "dryrun on 2 shards of cpu" in capsys.readouterr().out
