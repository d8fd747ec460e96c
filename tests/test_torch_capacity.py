"""The 100M x 768 capacity configuration of the port's harness
(bench/bench_10m.py at BASELINE.md:520-521's flags: --n 100000000 --batch
250000 --dist realistic --normalize --only none --ivf --ivf-base bq), held
to the JAX package where it has the rule, without building 100M rows:

  * the automatic geometry (32,552 centres, S = 1,024), the sample cap and
    the 2,083,328 training rows equal the JAX package's, and both packages
    take the streamed blocked-Lloyd trainer there;
  * the ladder at 114,026 buckets gives the JAX run's nscans (5,376 /
    13,568 / 27,136), and the port's IVF-BQ leg list equals the one
    tools/bench_10m.py builds, both read from that file's own source;
  * the build's capacity repairs: the in-place distance expansion of the
    assignment and the 16-bit keys of the bucket sort change no result,
    the assignment's ids gathered on the device are right where its
    sub-block does not divide the batch, and the trainer's segment sums
    add each centre's rows in row order;
  * the flags run end to end on the CPU at 20,000 rows, each leg searched
    once, and print exactly the IVF-BQ legs."""

import ast
import re
import types

import numpy as np
import pytest
import torch

from quantization_tpu.models import ivf as j_ivf_model
from quantization_tpu.ops import ivf as j_ivf
from quantization_tpu_torch.bench import bench_10m
from quantization_tpu_torch.models import ivf as t_ivf_model
from quantization_tpu_torch.ops import ivf as t_ivf
from torch_capacity_cases import (CAPACITY_ARGV, JAX_HARNESS, N_CAP, NBK_CAP, NLIST_CAP, S_CAP,
                                  jax_ladder, jax_main, run_stmts)

torch.set_num_threads(1)


def jax_ivf_bq_legs(n, nbk):
    """(coarse (nprobe, nscan), rescored (R, nprobe, nscan)) of the JAX
    harness's IVF-BQ block: the coarse loop's list, then the
    ``bq_rescore_rows`` statements that follow it, run from its source."""
    for node in ast.walk(jax_main()):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for i, st in enumerate(body):
            if (isinstance(st, ast.Assign) and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id == "bq_rescore_rows"):
                ns = {"ladder": jax_ladder(nbk), "N": n}
                coarse_loop = body[i - 1]
                assert isinstance(coarse_loop, ast.For)
                coarse = eval(compile(ast.Expression(coarse_loop.iter), str(JAX_HARNESS),
                                      "eval"), ns)
                rows = run_stmts(body[i : i + 2], ns)["bq_rescore_rows"]
                return list(coarse), list(rows)
    raise AssertionError("no bq_rescore_rows in tools/bench_10m.py")


def test_auto_geometry_at_100m_equals_jax():
    assert t_ivf_model.auto_geometry(N_CAP) == j_ivf_model.auto_geometry(N_CAP) == (NLIST_CAP,
                                                                                    S_CAP)


def test_sample_cap_and_training_rows_equal_jax():
    assert t_ivf.sample_cap(NLIST_CAP) == j_ivf.sample_cap(NLIST_CAP) == 4_194_304
    jax_rows = min(N_CAP, max(NLIST_CAP, j_ivf.IVF_SAMPLE_PER_CENTER * NLIST_CAP),
                   j_ivf.sample_cap(NLIST_CAP))
    assert t_ivf.training_rows(N_CAP, NLIST_CAP) == jax_rows == 2_083_328


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_streamed_trainer_is_the_branch_taken(monkeypatch, side):
    """At 2,083,328 rows x 32,552 centres the [n, nlist] f32 distances
    (271 GB) pass the in-core cap, so train_centers streams (the trainer is
    stubbed: only the branch is under test, on a one-column sample)."""
    mod = j_ivf if side == "jax" else t_ivf
    taken = []

    def streamed(sample, nlist, **kw):
        taken.append((int(sample.shape[0]), nlist))
        return np.zeros((nlist, 1), np.float32)

    def in_core(*a, **kw):
        raise AssertionError("the in-core trainer at capacity scale")

    monkeypatch.setattr(mod, "_train_centers_streamed", streamed)
    monkeypatch.setattr(mod, "kmeans_batched", in_core)
    rows = t_ivf.training_rows(N_CAP, NLIST_CAP)
    sample = np.zeros((rows, 1), np.float32)
    mod.train_centers(sample if side == "jax" else torch.from_numpy(sample), NLIST_CAP)
    assert taken == [(rows, NLIST_CAP)]


def test_ladder_at_the_capacity_bucket_count_gives_the_jax_nscans():
    fracs = (0.0475, 0.1186, 0.2372)
    want = [5376, 13568, 27136]  # BASELINE.md:585-594
    assert bench_10m.ladder(fracs, NBK_CAP) == want
    assert jax_ladder(NBK_CAP)(fracs) == want


@pytest.mark.parametrize("n, nbk", [(N_CAP, NBK_CAP), (N_CAP, NBK_CAP + 300),
                                    (50_000_000, 57_013), (49_999_999, 57_013),
                                    (10_000_000, 11_384), (20_000, 46)])
def test_ivf_bq_legs_equal_the_jax_harness(n, nbk):
    coarse, rows = bench_10m.ivf_bq_legs(n, nbk)
    j_coarse, j_rows = jax_ivf_bq_legs(n, nbk)
    assert [(64, u) for u in coarse] == j_coarse
    assert rows == j_rows


def test_ivf_bq_legs_at_capacity():
    coarse, rows = bench_10m.ivf_bq_legs(N_CAP, NBK_CAP)
    assert coarse == [5376, 13568, 27136]
    assert rows == [(160, 64, 13568), (320, 64, 13568), (160, 64, 27136), (320, 64, 27136),
                    (640, 64, 27136), (1280, 64, 27136)]


@pytest.mark.parametrize("nlist", [7, 300, 8_300])
def test_in_place_assignment_equals_the_expansion(nlist):
    """_assign_blocked's in-place |c|^2 + (-2 x.c) picks, to the bit, what
    the out-of-place |c|^2 - 2 x.c (ROADMAP F21's order) picks, over one
    centre block and several (8,300 centres: two blocks of 8,192)."""
    rng = np.random.default_rng(nlist)
    x = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((nlist, 16)).astype(np.float32))
    cblk, ccblk = t_ivf._pad_centers(c, nlist)
    got = t_ivf._assign_blocked(x, cblk, ccblk)
    best = torch.full((300,), float("inf"))
    arg = torch.zeros((300,), dtype=torch.int64)
    for i in range(cblk.shape[0]):
        s = ccblk[i][None, :] - 2.0 * (x @ cblk[i].T)
        m, a = torch.min(s, dim=1)
        take = m < best
        best, arg = torch.where(take, m, best), torch.where(take, a + i * cblk.shape[1], arg)
    assert torch.equal(got, arg)


def test_segment_sums_add_each_segment_in_row_order():
    """The streamed trainer's sums (ops/ivf.segment_sums): each segment's
    rows added one after another in row order, to the bit, with its count;
    empty segments sum to 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((500, 24)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, size=500)).clamp(max=37)  # 38, 39 empty
    sums, counts = t_ivf.segment_sums(x, idx, 40)
    for j in range(40):
        acc = torch.zeros(24)
        for r in torch.nonzero(idx == j).reshape(-1).tolist():
            acc = acc + x[r]
        assert torch.equal(sums[j], acc), j
    assert torch.equal(counts, torch.bincount(idx, minlength=40))


@pytest.mark.parametrize("batch, nb", [(100_000, 2), (32_771, 3), (16_385, 2), (10_000, 3)])
def test_assign_rows_when_the_sub_block_does_not_divide_the_batch(batch, nb):
    """assign_rows cuts each batch into sub-blocks of B // ceil(B / 16,384)
    rows. Where that does not divide B (100,000: a 5-row tail; 32,771: 2;
    16,385: 1), every row still gets its own nearest centre. Rows lie close
    to a known centre, far from the others, so the ids are known."""
    rng = np.random.default_rng(batch)
    n, d, nlist = batch * nb, 8, 37
    centers = (10 * rng.standard_normal((nlist, d))).astype(np.float32)
    label = rng.integers(0, nlist, size=n)
    data = torch.from_numpy(centers[label] + 0.01 * rng.standard_normal((n, d)).astype(np.float32))
    rows = types.SimpleNamespace(batch=lambda i: data[i * batch : (i + 1) * batch])
    h = types.SimpleNamespace(B=batch, N=n, nb=nb, rows=rows, device=torch.device("cpu"))
    got = bench_10m.assign_rows(h, centers)
    assert got.dtype == np.int32 and np.array_equal(got, label)


@pytest.mark.parametrize("nlist", [40, 70_000])
def test_build_buckets_equal_jax_on_either_key_width(nlist):
    """The bucket sort keys assignments below 2^16 as 16 bits (numpy's radix
    sort) and wider ones as they are; both give the JAX package's buckets."""
    a = np.random.default_rng(nlist).integers(0, nlist, size=200_000).astype(np.int32)
    perm, ids = t_ivf.build_buckets(a, 64)
    jperm, jids = j_ivf.build_buckets(a, 64)
    assert np.array_equal(perm, jperm) and np.array_equal(ids, jids)


def test_the_capacity_flags_run_on_the_cpu(monkeypatch, capsys):
    """Path 10's flags at 20,000 rows in batches of 10,000 on the CPU, each
    leg's search run once (the plain versions take seconds a call here):
    exit 0, the build's phase lines, the resident line at 96 B a slot, and
    exactly the IVF-BQ legs of ``ivf_bq_legs``, no other."""

    def one_search(self, name, index, eq, gt, iters=10, **knobs):
        _, ids = index.top_k_device(eq, self.K, **knobs)
        self._line(name, 1.0, None, self.recall(ids, gt))

    monkeypatch.setattr(bench_10m.Harness, "report_serve", one_search)
    rc = bench_10m.main(CAPACITY_ARGV + ["--n", "20000", "--batch", "10000", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    for phase in ("pass0 (device calibration)", "pass A (GT + BQ + PQ encode)",
                  "IVF coarse training (13 centres, 832 rows)", "IVF assignment",
                  "IVF buckets", "IVF bucket means", "IVF-BQ permuted encode"):
        assert re.search(rf"^{re.escape(phase)}: \d+s$", out, re.M), phase
    nbk = int(re.search(r"\((\d+) buckets x 512, pad \d+ rows\)", out).group(1))
    coarse, rows = bench_10m.ivf_bq_legs(20_000, nbk)
    want = [f"IVF-BQ p=64 nscan={u}" for u in coarse]
    want += [f"2s IVF-BQ->f32 R={rr} p={p} nscan={u}" for rr, p, u in rows]
    got = re.findall(r"^(\S.*?)\s*: .* recall@10 vs exact = [0-9.]+$", out, re.M)
    assert got == want
    slots = nbk * 512 + (-nbk * 512) % 2048
    assert re.search(rf"^IVF-BQ resident: planes {96 * slots:,} B, .*planes 96 B a slot x "
                     rf"{slots:,} slots\); bucket tables [\d,]+ B on the host$", out, re.M)
