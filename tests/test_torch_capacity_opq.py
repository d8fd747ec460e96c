"""The 100M x 768 quality-first configuration of the port's harness
(bench/bench_10m.py at BASELINE.md:612-622's flags: path 10's with
--ivf-base opq --ivf-residual), held to the JAX package where it has the
rule, without building 100M rows:

  * the IVF-OPQ and residual IVF-OPQ leg lists equal the ones
    tools/bench_10m.py builds, read from that file's own source; at
    capacity they scan 5,376 and 13,568 buckets and keep plain OPQ's R = 160
    leg twice, as the JAX list does;
  * a transposed-first quantizer keeps the appended codes as they are (at
    100M a copy is another 11.2 GB);
  * the flags run end to end on the CPU at 20,000 rows, each leg searched
    once: exactly those legs, both PQ resident lines (codes at the padded
    chunk count's bytes a slot: 8 chunks of d = 64 pad to 16), and no leg
    builds the row-major code copy;
  * a run on a kept build prints the fresh run's geometry, legs and
    recalls, and the kept build holds no tensor; a build kept under another
    key is not used, one kept under the same key with other legs is;
  * F40's A / B (bench/precision_ab.py) rounds the inputs of f32 products
    as a TPU's default dot does, and leaves the query side exact.

The OPQ trainings run one outer and two Lloyd iterations here (at the
harness's budget the plain k-means takes minutes on one CPU thread): these
tests hold the plumbing, not the codes' quality."""

import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

from quantization_tpu_torch.bench import bench_10m, precision_ab
from quantization_tpu_torch.core.types import DistanceType, VectorParameters
from quantization_tpu_torch.models import pq as pq_model
from quantization_tpu_torch.models.pq import PQMetadata, ProductQuantizer
from quantization_tpu_torch.ops import pq as pq_ops
from quantization_tpu_torch.ops.opq import train_opq
from quantization_tpu_torch.utils.device_store import DeviceAppender
from torch_capacity_cases import CAPACITY_OPQ_ARGV, N_CAP, NBK_CAP, jax_block_legs

torch.set_num_threads(1)

SMALL = ["--n", "20000", "--batch", "10000", "--d", "64", "--queries", "64", "--device", "cpu"]
LEG = re.compile(r"^(\S.*?)\s*: .* recall@10 vs exact = ([0-9.]+)$", re.M)
BUILD_PHASES = ("pass0 (device calibration)", "pass A (GT + BQ + PQ encode)",
                "IVF coarse training", "IVF assignment", "IVF buckets", "IVF bucket means")
LEG_LISTS = {"opq": (bench_10m.ivf_opq_legs, "opq_fracs"),
             "opqr": (bench_10m.ivf_opqr_legs, "opqr_fracs")}


@pytest.mark.parametrize("kind", sorted(LEG_LISTS))
@pytest.mark.parametrize("n, nbk", [(N_CAP, NBK_CAP), (N_CAP, NBK_CAP + 300),
                                    (50_000_000, 57_013), (49_999_999, 57_013),
                                    (10_000_000, 11_384), (20_000, 46)])
def test_ivf_opq_legs_equal_the_jax_harness(kind, n, nbk):
    legs, first = LEG_LISTS[kind]
    coarse, rows = legs(n, nbk)
    j_coarse, j_rows = jax_block_legs(n, nbk, first)
    assert [(64, u) for u in coarse] == j_coarse
    assert rows == j_rows


def test_ivf_opq_legs_at_capacity():
    coarse, rows = bench_10m.ivf_opq_legs(N_CAP, NBK_CAP)
    assert coarse == [5376, 13568]
    assert rows == [(80, 64, 13568), (160, 64, 13568), (160, 64, 13568), (320, 64, 13568),
                    (640, 64, 13568)]
    coarse_r, rows_r = bench_10m.ivf_opqr_legs(N_CAP, NBK_CAP)
    assert coarse_r == coarse
    assert rows_r == [(40, 64, 5376), (160, 64, 5376), (320, 64, 5376), (160, 64, 13568),
                      (320, 64, 13568)]


def test_from_transposed_keeps_the_appended_codes():
    """Codes appended chunk-major at a 2048-multiple width and 16 chunks
    need no pad, so the quantizer holds the appender's buffer itself and
    builds no row-major copy."""
    app = DeviceAppender((16, 4096), torch.uint8, torch.device("cpu"), axis=1)
    for b in range(2):
        app.append(torch.full((16, 2048), b + 1, dtype=torch.uint8))
    codes_t = app.finish()
    d = 128
    division = pq_ops.get_vector_division(d, 8)
    cents = np.zeros((256, d), np.float32)
    pq = ProductQuantizer.from_transposed(
        codes_t, PQMetadata(cents, division, VectorParameters(d, 4096, DistanceType.DOT, False)))
    assert pq.codes_t.data_ptr() == codes_t.data_ptr() and pq.codes_t.shape == (16, 4096)
    assert pq.resident_codes[1] and pq._codes is None


def _one_call(self, name, fn, gt):
    """``Harness.report`` with the leg's search run once (no timing)."""
    _, ids = fn()
    self._line(name, 1.0, None, self.recall(ids, gt))


def _codes_t_only(self):
    if self._codes is None:
        raise AssertionError("a leg built the row-major PQ codes")
    return self._codes


def run_main(argv, keep):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_10m.main(argv, keep)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs():
    """Path 11's flags at 20,000 rows: a fresh run that keeps its build,
    then a run on the kept build; (fresh, kept run, the holder)."""
    keep = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_10m.Harness, "report", _one_call)
        mp.setattr(bench_10m, "train_opq", functools.partial(
            train_opq, outer_iterations=1, inner_iterations=2, final_iterations=2))
        mp.setattr(ProductQuantizer, "codes", property(_codes_t_only))
        fresh = run_main(CAPACITY_OPQ_ARGV + SMALL, keep)
        again = run_main(CAPACITY_OPQ_ARGV + SMALL, keep)
    return fresh, again, keep


def _nbk(out):
    return int(re.search(r"\((\d+) buckets x 512, pad \d+ rows\)", out).group(1))


def test_the_opq_capacity_flags_run_on_the_cpu(runs):
    """Exit 0, the build's phase lines, the two trainings' lines, exactly
    the IVF-OPQ then IVF-OPQr legs of ``ivf_opq_legs`` / ``ivf_opqr_legs``
    (the duplicates kept), and each index's resident line: the transposed
    codes at 16 B a slot (m = 8 padded to 16), the residual one with its
    per-slot row additive."""
    (rc, out), _, _ = runs
    assert rc == 0, out[-2000:]
    for phase in BUILD_PHASES + ("IVF-OPQ train+permuted encode",
                                 "IVF-OPQ residual train+encode"):
        assert re.search(rf"^{re.escape(phase)}.*: \d+s", out, re.M), phase
    nbk = _nbk(out)
    want = []
    for tag, legs in (("IVF-OPQ", bench_10m.ivf_opq_legs), ("IVF-OPQr", bench_10m.ivf_opqr_legs)):
        coarse, rows = legs(20_000, nbk)
        want += [f"{tag} p=64 nscan={u}" for u in coarse]
        want += [f"2s {tag}->f32 R={rr} p={p} nscan={u}" for rr, p, u in rows]
    assert [m.group(1) for m in LEG.finditer(out)] == want
    slots = nbk * 512 + (-nbk * 512) % 2048
    head = rf"codes {16 * slots:,} B, bucket means {nbk * 64 * 4:,} B, slot ids {4 * nbk * 512:,} B"
    tail = (rf" \([\d,]+ B on the device; codes 16 B a slot x {slots:,} slots\); bucket tables "
            r"[\d,]+ B on the host$")
    assert re.search(rf"^IVF-OPQ resident: {head}{tail}", out, re.M)
    assert re.search(rf"^IVF-OPQr resident: {head}, rowadd {4 * slots:,} B{tail}", out, re.M)


def test_a_kept_build_gives_the_fresh_runs_results(runs):
    """The second run takes the first one's build: one line says so, no
    build phase runs, and the geometry, the legs with their recalls and the
    resident lines are the fresh run's. The kept build is host arrays
    only."""
    (_, fresh), (rc, again), keep = runs
    assert rc == 0, again[-2000:]
    nbk = _nbk(fresh)
    assert re.search(rf"^kept build: .*\({nbk} buckets x 512, pad \d+ rows\)$", again, re.M)
    assert "kept build" not in fresh
    for phase in BUILD_PHASES:
        assert phase in fresh and phase not in again, phase

    def same(pattern, text):
        return re.findall(pattern, text, re.M)

    for pattern in (r"^IVF geometry: .*$", r"^IVF-OPQr? resident: .*$"):
        assert same(pattern, again) == same(pattern, fresh) != []
    assert LEG.findall(again) == LEG.findall(fresh) != []
    build = keep["build"][1]
    arrays = [build.mn, build.mx, build.sample, build.gt, *vars(build.ivf).values()]
    assert not any(isinstance(a, torch.Tensor) for a in arrays)
    assert all(isinstance(a, np.ndarray) for a in arrays[2:])


@pytest.mark.parametrize("change, reused", [
    (["--n", "10000"], False), (["--sigma", "0.4"], False), (["--queries", "100"], False),
    (["--ivf-bucket", "256"], False), ([], True)])
def test_a_build_kept_under_another_key_is_not_used(runs, change, reused):
    """A run whose key differs (rows, noise, queries, geometry) builds
    afresh and keeps its own build in place of the earlier one; one with
    the same key and other legs (--ivf-base none) takes the kept build."""
    _, _, keep = runs
    holder = dict(keep)
    rc, out = run_main(CAPACITY_OPQ_ARGV + SMALL + ["--ivf-base", "none"] + change, holder)
    assert rc == 0, out[-2000:]
    assert ("kept build" in out) == reused
    assert ("pass0 (device calibration)" in out) != reused
    assert (holder["build"] is keep["build"]) == reused


@pytest.mark.parametrize("product", ["matmul", "bmm", "einsum"])
def test_one_bf16_pass_rounds_the_inputs_of_products(product):
    """F40's A / B (bench/precision_ab.py): under ``OneBf16Pass`` an f32
    product takes its inputs rounded to bf16 and sums in f32, a TPU's
    default f32 dot; other functions and non-f32 inputs are untouched."""
    g = torch.Generator().manual_seed(40)
    a = torch.randn(3, 5, 64, generator=g)
    b = torch.randn(3, 64, 7, generator=g)
    run = {"matmul": lambda x, y: x @ y, "bmm": torch.bmm,
           "einsum": lambda x, y: torch.einsum("bik,bkj->bij", x, y)}[product]
    want = run(a.bfloat16().float(), b.bfloat16().float())
    with precision_ab.OneBf16Pass():
        got = run(a, b)
        added = a + 1e-3
        ints = torch.ones(2, 3, dtype=torch.int64) @ torch.ones(3, 2, dtype=torch.int64)
    assert torch.equal(got, want) and not torch.equal(got, run(a, b))
    assert torch.equal(added, a + 1e-3) and bool((ints == 3).all())


def test_tpu_products_leave_the_query_side_exact():
    """``tpu_products`` keeps what the JAX package computes at HIGHEST: the
    PQ query's rotation and LUT equal the f32 ones inside it, while the
    corpus side's products are rounded."""
    rng = np.random.default_rng(40)
    d, division = 32, pq_ops.get_vector_division(32, 8)
    meta = PQMetadata(rng.standard_normal((256, d)).astype(np.float32), division,
                      VectorParameters(d, 1024, DistanceType.DOT, False),
                      rotation=np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32))
    c_chunks = torch.from_numpy(pq_ops.centroids_to_chunks(meta.centroids, division))
    rot = torch.from_numpy(meta.rotation)
    q = rng.standard_normal((4, d)).astype(np.float32)
    cpu = torch.device("cpu")
    want = pq_model.encode_queries(q, meta, c_chunks, rot, cpu).lut
    x = torch.from_numpy(q)
    with precision_ab.tpu_products():
        got = pq_model.encode_queries(q, meta, c_chunks, rot, cpu).lut
        rotated = x @ rot
    assert torch.equal(got, want)
    assert torch.equal(rotated, x.bfloat16().float() @ rot.bfloat16().float())
