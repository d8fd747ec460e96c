"""The port's examples, micro and CPU baselines and profiling helpers, on the
CPU at tiny sizes: each example's ``main`` runs to its end and prints its
recall lines; ``micro`` prints one JSON line per configuration of the
reference's criterion benches, with finite positive times;
``cpu_baseline`` measures its native scans; ``Timer``, ``timed`` and
``device_trace`` (a Chrome trace of torch.profiler) work without a card.
Every entry point raises ``NoDeviceError`` without a card unless it is
given ``--device cpu``."""

import glob
import json
import math
import os

import pytest
import torch

import quantization_tpu_torch as qt
from quantization_tpu_torch.bench import cpu_baseline, micro
from quantization_tpu_torch.examples import (
    basic,
    ivf_serving,
    pipelined_serving,
    serving_two_stage,
    streaming_ingest,
)
from quantization_tpu_torch.utils.profiling import Timer, device_trace, timed

torch.set_num_threads(1)

EXAMPLES = {
    "basic": (basic, [], "u8 dot scores within"),
    "serving_two_stage": (serving_two_stage, ["--n", "3000", "--d", "64", "--queries", "16"],
                          "recall@10 vs exact f32"),
    "pipelined_serving": (pipelined_serving, ["--n", "4000", "--d", "64", "--queries", "16",
                                              "--batches", "4", "--target", "0.9"],
                          "recall@10 on the last batch"),
    "ivf_serving": (ivf_serving, ["--n", "4000", "--d", "64", "--queries", "16",
                                  "--clusters", "16", "--nlist", "16", "--bucket-size", "64",
                                  "--nprobe", "8", "--nscan", "32"], "recall@10 vs exact f32"),
    "streaming_ingest": (streaming_ingest, ["--n", "5000", "--d", "64", "--batch", "2048",
                                            "--queries", "16", "--clusters", "32"],
                         "two-stage BQ->SQ"),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    mod, argv, line = EXAMPLES[name]
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert line in out
    if name == "streaming_ingest":
        recalls = {row.split(":")[0].strip(): float(row.rsplit("=", 1)[1])
                   for row in out.splitlines() if "recall@10 vs exact =" in row}
        assert len(recalls) == 6
        assert recalls["SQ fused full-scan"] >= 0.8
        assert recalls["two-stage BQ->SQ"] >= recalls["BQ fused full-scan"]


def test_micro_prints_every_configuration(capsys):
    rows = micro.main(["--n", "2000", "--d", "64", "--q", "8", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    assert [r["bench"] for r in rows] == ["f32_dot", "sq_u8_dot", "sq_u8_l1", "pq_chunk2",
                                          "bq_u8", "bq_u128"]
    for r in rows:
        assert math.isfinite(r["ms_per_batch"]) and r["ms_per_batch"] > 0
        assert r["qps"] > 0 and (r["n"], r["d"], r["q"]) == (2000, 64, 8)
    assert rows[3]["chunks"] == 32


def test_cpu_baseline_measures_the_native_scans():
    out = cpu_baseline.measure(3000, 64, iters=2, device="cpu")
    assert out["cpu_sq_u8_scan_qps"] > 0 and out["cpu_f32_scan_qps"] > 0
    assert (out["n"], out["dim"]) == (3000, 64)


@pytest.mark.parametrize("entry", ["basic", "micro", "cpu_baseline", "streaming_ingest"])
def test_entry_points_need_a_card_or_device_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run there by default")
    mod = {"basic": basic, "micro": micro, "cpu_baseline": cpu_baseline,
           "streaming_ingest": streaming_ingest}[entry]
    argv = {"micro": ["--n", "600", "--d", "16"], "cpu_baseline": ["600", "16"],
            "streaming_ingest": ["--n", "600", "--d", "16", "--batch", "256"]}.get(entry, [])
    with pytest.raises(qt.NoDeviceError):
        mod.main(argv)


def test_timer_accumulates():
    t = Timer()
    for _ in range(3):
        with t("encode"):
            pass
    assert len(t.times["encode"]) == 3
    assert t.total("encode") >= 0.0
    assert "encode: total=" in t.report() and "n=3" in t.report()


def test_timed_on_the_cpu():
    x = torch.randn(64, 64)
    dt = timed(torch.matmul, x, x, iters=3, warmup=1)
    assert math.isfinite(dt) and dt > 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.matmul(torch.randn(32, 32), torch.randn(32, 32))
    assert prof is not None
    (trace,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    with device_trace(None) as off:
        assert off is None
