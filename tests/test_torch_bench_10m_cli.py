"""The port's 10M harness (python -m quantization_tpu_torch.bench.bench_10m
--device cpu) against the JAX package's (tools/bench_10m.py, run as a
subprocess) at the same small flags: the IVF and residual legs only
(--only none --ivf --ivf-residual) at 10,000 x 64 in batches of 2,500, 16
clusters, 32 queries, chunks of 4. Both make the same corpus (the JAX
harness's threefry rows; bench/threefry.py), so they must print the same
legs in the same order, the same geometry and bucket lines, and recall@10
within 0.02 per leg, 0.05 on the OPQ-trained legs: OPQ alternates k-means
and an SVD ten times on a 2,500-row sample whose rows differ from the JAX
harness's in the last bit (XLA's log1p, the rotation's sums), and the two
packages' k-means sum in another order, so the learned rotations and
codebooks part (0.022 apart on the coarse IVF-OPQ leg at these flags).

The JAX side runs its kernels in Pallas interpret mode
(QTPU_FORCE_PALLAS=1), as on the TPU: off it, the JAX package's CPU
searches select exactly where its kernels (and the port's) keep one
candidate per stride class. QTPU_NO_COMPILE_CACHE=1 keeps its compile
cache out of the repository. The port runs in this process on one thread
while the JAX harness runs beside it."""

import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from quantization_tpu_torch.bench import bench_10m

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLAGS = ["--n", "10000", "--d", "64", "--batch", "2500", "--clusters", "16", "--queries", "32",
         "--chunk-size", "4", "--only", "none", "--ivf", "--ivf-residual"]
RECALL_SLACK = 0.02
OPQ_RECALL_SLACK = 0.05
# The legs those flags define, in order (Q = 32: the latency-regime ladders).
LEGS = [
    "IVF-SQ p=64 nscan=64", "IVF-SQ p=64 nscan=256", "IVF-SQ p=64 nscan=1024",
    "2s IVF-SQ->f32 R=40 p=64 nscan=256", "2s IVF-SQ->f32 R=40 p=64 nscan=1024",
    "IVF-BQ p=64 nscan=256", "2s IVF-BQ->f32 R=160 p=64 nscan=256",
    "2s IVF-BQ->f32 R=320 p=64 nscan=256", "IVF-OPQ p=64 nscan=256",
    "2s IVF-OPQ->f32 R=80 p=64 nscan=256", "2s IVF-OPQ->f32 R=160 p=64 nscan=256",
    "2s IVF-OPQ->f32 R=160 p=64 nscan=256", "IVF-BQr p=64 nscan=256",
    "2s IVF-BQr->f32 R=160 p=64 nscan=256", "2s IVF-BQr->f32 R=320 p=64 nscan=256",
    "IVF-SQr p=64 nscan=256", "2s IVF-SQr->f32 R=40 p=64 nscan=256",
    "IVF-OPQr p=64 nscan=256", "2s IVF-OPQr->f32 R=40 p=64 nscan=256",
    "2s IVF-OPQr->f32 R=40 p=64 nscan=256", "2s IVF-OPQr->f32 R=160 p=64 nscan=256",
]
LEG = re.compile(r"^(\S.*?)\s*: .* recall@10 vs exact = ([0-9.]+)", re.M)


def legs(out):
    return [(m.group(1), float(m.group(2))) for m in LEG.finditer(out)]


@pytest.fixture(scope="module")
def runs():
    """(JAX harness's output, its exit code, the port's output, its exit
    code), the two run side by side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", QTPU_NO_COMPILE_CACHE="1",
               QTPU_FORCE_PALLAS="1")
    jax_proc = subprocess.Popen([sys.executable, str(ROOT / "tools" / "bench_10m.py"), *FLAGS],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=ROOT)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port_rc = bench_10m.main(FLAGS + ["--device", "cpu"])
        jax_out, _ = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    return jax_out, jax_proc.returncode, buf.getvalue(), port_rc


def test_both_exit_0_with_no_failed_leg(runs):
    jax_out, jax_rc, port_out, port_rc = runs
    assert jax_rc == 0, jax_out[-2000:]
    assert port_rc == 0, port_out[-2000:]
    assert "FAILED" not in jax_out and "FAILED" not in port_out


def test_same_legs_in_the_same_order(runs):
    jax_out, _, port_out, _ = runs
    assert [n for n, _ in legs(jax_out)] == LEGS
    assert [n for n, _ in legs(port_out)] == LEGS


def test_same_geometry_and_bucket_lines(runs):
    jax_out, _, port_out, _ = runs
    for pattern in (r"^IVF geometry: .*$", r"\(\d+ buckets x \d+, pad \d+ rows\)",
                    r"\(beta=[0-9.]+\)", r"^residual SQ affine .*$"):
        want = re.findall(pattern, jax_out, re.M)
        assert want and re.findall(pattern, port_out, re.M) == want, pattern


@pytest.mark.parametrize("i", range(len(LEGS)), ids=lambda i: f"{i:02d}")
def test_leg_recall_within_the_jax_harness(runs, i):
    jax_out, _, port_out, _ = runs
    (name, want), (got_name, got) = legs(jax_out)[i], legs(port_out)[i]
    assert got_name == name == LEGS[i]
    slack = OPQ_RECALL_SLACK if "OPQ" in name else RECALL_SLACK
    assert abs(got - want) <= slack, (name, got, want)


def test_port_runs_the_default_chunk_size_with_opq_and_ivf(capsys):
    """ROADMAP F35: at the default --chunk-size 8 with --opq --ivf, m = 8 is
    below the PQ kernels' M_BLK (16) and the permuted codes' columns
    (rounded to 2048) outnumber the PQ quantizer's row padding (1024); the
    JAX harness raises at its IVF-OPQ build there, the port's runs."""
    rc = bench_10m.main(["--n", "2048", "--d", "64", "--batch", "1024", "--queries", "8",
                         "--clusters", "8", "--only", "pq", "--opq", "--ivf", "--ivf-base",
                         "opq", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    assert re.search(r"^IVF-OPQ p=64 nscan=\d+\s*: .* recall@10", out, re.M)
    assert re.search(r"^2s IVF-OPQ->f32 R=160 ", out, re.M)
    total = int(re.search(r"\((\d+) buckets x (\d+)", out).group(1)) * 64
    assert total % 2048 and -(-total // 1024) * 1024 < -(-total // 2048) * 2048
