"""The port's ann_benchmark CLI on the CPU (``--device cpu``), against the
JAX package's CLI: the 11 non-sharded cases of tests/test_ann_cli.py at
their 3,000-row size (2,000 / 4,000 where they set it), each also run
through the JAX CLI with the same flags. Both CLIs make byte-equal
synthetic corpora, so recall@10 must agree within 0.02: ids may differ
among ties, and PQ / IVF training sums in another order. Full-scan PQ
searches with the JAX package's int8 LUT (QTPU_FORCE_PALLAS=1, in
interpret mode), the port's default everywhere and the JAX package's on
the TPU: off the TPU the JAX package searches with the f32 LUT (ROADMAP
F29), 0.735 against the int8 LUT's 0.71 on the pq case. The two PQ cases,
whose k-means takes about a minute each on one CPU thread, have files of
their own (test_torch_ann_cli_pq.py, test_torch_ann_cli_ivfpq.py) so that
``--dist loadfile`` runs them on workers of their own.

The ``--sharded`` cases of tests/test_ann_cli.py run the port on a
one-shard CPU mesh (``--device cpu``) against the JAX CLI on its 8 virtual
devices, recall@10 within the same 0.02; the IVF methods' per-shard union
quota depends on the shard count, so their cases (ivf-sq-f32, the JAX
test's, and ivf-bq-f32) give the port's CLI a mesh of 8 CPU shards too.
Then the JSON lines carry the JAX CLI's keys, and without a card and
without ``--device`` the CLI raises ``NoDeviceError``."""

import json

import numpy as np
import pytest
import torch

from quantization_tpu.bench import ann_benchmark as j_cli
import quantization_tpu_torch as qt
from quantization_tpu_torch.bench import ann_benchmark as t_cli
from quantization_tpu_torch.parallel import sharded as t_sharded

torch.set_num_threads(1)

RECALL_SLACK = 0.02

# case -> (argv, the floor of tests/test_ann_cli.py)
CASES = {
    "u8_synthetic_acc": (["--dataset", "sift", "--method", "u8", "--test-acc",
                          "--synthetic-count", "3000", "--query-batch", "64"], 0.5),
    "u8_f32_two_stage": (["--dataset", "sift", "--method", "u8-f32", "--test-acc",
                          "--synthetic-count", "3000", "--query-batch", "64",
                          "--oversampling", "4"], 0.8),
    "pq_opq_rotation": (["--dataset", "sift", "--method", "pq", "--opq", "--test-acc",
                         "--synthetic-count", "2000", "--query-batch", "64",
                         "--chunk-size", "4"], 0.3),
    "ivf_sq": (["--dataset", "sift", "--method", "ivf-sq", "--test-acc",
                "--synthetic-count", "3000", "--query-batch", "64",
                "--nlist", "16", "--bucket-size", "64", "--nprobe", "8"], 0.4),
    "ivf_pq_f32_two_stage": (["--dataset", "sift", "--method", "ivf-pq-f32", "--test-acc",
                              "--synthetic-count", "3000", "--query-batch", "64",
                              "--nlist", "16", "--bucket-size", "64", "--nprobe", "16",
                              "--chunk-size", "2", "--oversampling", "8"], 0.6),
    "ivf_residual": (["--dataset", "sift", "--method", "ivf-sq", "--residual",
                      "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
                      "--nlist", "4", "--bucket-size", "512", "--nprobe", "4"], 0.4),
    "ivf_residual_bq": (["--dataset", "lastfm-64-dot", "--method", "ivf-bq", "--residual",
                         "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
                         "--nlist", "4", "--bucket-size", "512", "--nprobe", "4"], 0.0),
    "ivf_bq": (["--dataset", "sift", "--method", "ivf-bq", "--test-acc",
                "--synthetic-count", "3000", "--query-batch", "64",
                "--nlist", "16", "--bucket-size", "64", "--nprobe", "16"], 0.2),
    "recall_target_knob": (["--dataset", "sift", "--method", "u8", "--test-acc",
                            "--synthetic-count", "3000", "--query-batch", "64",
                            "--topk-method", "approx", "--recall-target", "0.8"], 0.4),
    "auto_config": (["--dataset", "sift", "--method", "ivf-sq", "--test-acc",
                     "--synthetic-count", "4000", "--query-batch", "32",
                     "--auto-config", "0.85"], 0.7),
    "ivf_default_geometry": (["--dataset", "sift", "--method", "ivf-sq", "--test-acc",
                              "--synthetic-count", "4000", "--query-batch", "32",
                              "--nprobe", "8"], 0.3),
}


def check_case(case, monkeypatch):
    argv, floor = CASES[case] if case in CASES else SHARDED_CASES[case]
    if "--sharded" in argv and argv[argv.index("--method") + 1].startswith("ivf-"):
        # The JAX CLI's mesh: the 8 virtual devices of tests/conftest.py.
        make_mesh = t_sharded.make_mesh
        monkeypatch.setattr(t_sharded, "make_mesh",
                            lambda *a, **kw: make_mesh(devices=[torch.device("cpu")] * 8))
    got = t_cli.main(argv + ["--device", "cpu"])
    if argv[argv.index("--method") + 1] == "pq":
        monkeypatch.setenv("QTPU_FORCE_PALLAS", "1")
    want = j_cli.main(argv)
    assert len(got) == len(want) == 1
    assert got[0]["dataset"] == want[0]["dataset"]
    assert got[0]["same_10"] >= floor
    assert abs(got[0]["same_10"] - want[0]["same_10"]) <= RECALL_SLACK, (got, want)
    assert np.isfinite(got[0]["avg_us"])


SLOW = ("pq_opq_rotation", "ivf_pq_f32_two_stage")  # their own files

# The --sharded cases of tests/test_ann_cli.py: case -> (argv, floor).
SHARDED_CASES = {
    "sharded_two_stage": (["--dataset", "sift", "--method", "bq-u8", "--sharded",
                           "--test-acc", "--synthetic-count", "3000", "--query-batch", "64"],
                          0.5),
    "sharded_exact_rescorer": (["--dataset", "sift", "--method", "bq-exact", "--sharded",
                                "--test-acc", "--synthetic-count", "3000", "--query-batch",
                                "64"], 0.6),
    "recall_target_sharded": (["--dataset", "sift", "--method", "u8", "--sharded",
                               "--test-acc", "--synthetic-count", "3000", "--query-batch",
                               "64", "--topk-method", "approx", "--recall-target", "0.8"],
                              0.4),
    "ivf_sq_f32_sharded": (["--dataset", "sift", "--method", "ivf-sq-f32", "--sharded",
                            "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
                            "--nlist", "16", "--bucket-size", "64", "--nprobe", "8",
                            "--oversampling", "8"], 0.6),
    "ivf_bq_f32_sharded": (["--dataset", "sift", "--method", "ivf-bq-f32", "--sharded",
                            "--test-acc", "--synthetic-count", "3000", "--query-batch", "64",
                            "--nlist", "16", "--bucket-size", "64", "--nprobe", "16",
                            "--oversampling", "8"], 0.9),
}


@pytest.mark.filterwarnings("ignore:residual=True with quantizer='bq'")
@pytest.mark.parametrize("case", [c for c in CASES if c not in SLOW])
def test_cli_recall_equals_the_jax_cli(case, monkeypatch):
    check_case(case, monkeypatch)


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_cli_sharded_recall_equals_the_jax_cli(case, monkeypatch):
    check_case(case, monkeypatch)


def test_cli_json_keys_equal_the_jax_cli(capsys):
    argv = ["--dataset", "sift", "--method", "u8", "--test-acc", "--bench", "--bench-f32",
            "--synthetic-count", "3000", "--query-batch", "64", "--iters", "2", "--json"]
    t_cli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j_cli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    assert got[0]["qps"] > 0 and got[0]["f32_qps"] > 0


def test_cli_bench_search_path():
    """--bench on an index without a dense score_batch (a two-stage
    pipeline) measures the search path through PipelinedSearcher."""
    res = t_cli.main(["--dataset", "sift", "--method", "bq-u8", "--bench",
                      "--synthetic-count", "3000", "--query-batch", "64", "--iters", "2",
                      "--device", "cpu"])
    assert res[0]["qps"] > 0


def test_cli_sharded_bench_search_path():
    """--bench on a sharded index (no dense score_batch) measures the
    search path, as tests/test_ann_cli.py's case does; the index is the
    sharded engine on a one-shard CPU mesh."""
    from quantization_tpu_torch.parallel.sharded import ShardedScalarQuantizer

    argv = ["--dataset", "sift", "--method", "u8", "--sharded", "--bench",
            "--synthetic-count", "3000", "--query-batch", "64", "--iters", "2",
            "--device", "cpu"]
    res = t_cli.main(argv)
    assert res[0]["qps"] > 0
    data = t_cli.AnnBenchmarkData.load(t_cli.DATASETS["sift-128-euclidean"],
                                       synthetic_count=500, device="cpu")
    index = t_cli.build_index("u8", data, t_cli.parser().parse_args(argv))
    assert isinstance(index, ShardedScalarQuantizer)
    assert index.mesh.shape == {"shard": 1} and index.device == torch.device("cpu")


def test_cli_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI runs there by default")
    with pytest.raises(qt.NoDeviceError):
        t_cli.main(["--dataset", "sift", "--method", "u8", "--test-acc",
                    "--synthetic-count", "3000"])
