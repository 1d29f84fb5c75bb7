"""The PQ cell ``deep-pq-batch`` on the CPU, shrunk: the driver and the plain
PQ reference judge a sound run correct, and a run with the PQ path broken
underneath (``benchmark/pq_faults.py``: in training, quantizing or the scan)
not correct, through ``codebook_gap``, ``code_disagree`` or
``pq_top10_miss`` (``dist_gap``, ``bad_rows`` and ``unanswered`` pass these
faults: every id returned is a row with its true distance).  Also the PQ
reference against a NumPy brute force and against the draws of the index's
training rule, its control, and the three per-layer readers on canned spans
and traces."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.test_bench_support import ROOT  # puts the checkout on the path
from benchmark import control_pq, harness, judge_pq, peaks, pq_faults, profiling, reference_pq  # noqa: E402
from parallel_hnsw_tpu_torch.pq import per_subspace_centroids  # noqa: E402
from parallel_hnsw_tpu_torch.utils.trace import TRACER, PhaseEvent  # noqa: E402

CELL = "deep-pq-batch"
#: 80,000 rows: two code blocks of the pairwise route (65,536 codes each)
TINY = {"rows": 80_000, "dim": 16, "queries": 100,
        "pq": {"per_subspace": True, "use_kmeans": True, "centroids": 256, "dsub": 4,
               "kmeans_sample": 20_000, "iters": 5, "fast_quantize": True, "codes": "uint16",
               "chunk_size": 40_000, "seed": 0}}
TINY_TRAFFIC = {"batch": 50}
#: the compared numbers that only the PQ cell has
PQ_NUMBERS = {"codebook_gap", "code_disagree", "pq_top10_miss"}


def tiny_pq_run(seed: int = 2**31 + 11, trace: bool = False) -> dict:
    return harness.run_cell(CELL, seed, 0.3, trace, device="cpu",
                            config_overrides=TINY, traffic_overrides=TINY_TRAFFIC)


# -- the cell, sound and broken -------------------------------------------------


def test_sound_run_is_correct():
    result = tiny_pq_run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert PQ_NUMBERS <= set(result["checks"])
    assert set(result["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_traced_run_judges_alike():
    """On the CPU there is no device trace and no host span: the three
    per-layer metrics read nothing and are left out."""
    result = tiny_pq_run(trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"] == {}


@pytest.mark.parametrize("fault", sorted(pq_faults.FAULTS))
def test_broken_pq_path_is_not_correct(fault):
    with pq_faults.planted(fault):
        checks = tiny_pq_run()["checks"]
    failed = {name for name, c in checks.items() if c["value"] > c["limit"]}
    assert failed and failed <= PQ_NUMBERS, checks


# -- the plain PQ reference -----------------------------------------------------


def _numpy_distances(q, x, metric):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "normalized_cosine":
        return (1.0 - q64 @ x64.T) / 2.0
    return np.sqrt(((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1))


def _draw(seed=0, n=500, nsub=3, k=16):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, nsub * 4)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    books = rng.standard_normal((nsub, k, 4)).astype(np.float32) * 0.3
    queries = rng.standard_normal((7, nsub * 4)).astype(np.float32)
    return rows, books, queries / np.linalg.norm(queries, axis=1, keepdims=True)


def test_encode_is_the_nearest_centroid():
    rows, books, _ = _draw()
    got = reference_pq.encode(torch.from_numpy(rows), torch.from_numpy(books), block_bytes=1 << 12)
    subs = rows.reshape(len(rows), books.shape[0], 4).astype(np.float64)
    want = ((subs[:, :, None, :] - books[None].astype(np.float64)) ** 2).sum(-1).argmin(-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_breaks_ties_to_the_lowest_centroid():
    books = torch.tensor([[[1.0, 0, 0, 0], [0, 1.0, 0, 0], [1.0, 0, 0, 0]]])
    rows = torch.tensor([[0.5, 0.5, 0, 0], [1.0, 0, 0, 0]])
    assert reference_pq.encode(rows, books).tolist() == [[0], [0]]


def test_uint16_codes_widen_past_32767():
    codes = torch.tensor([[0, 40_000, 65_535]], dtype=torch.int32).to(torch.int16).view(torch.uint16)
    assert reference_pq.widen(codes).tolist() == [[0, 40_000, 65_535]]


@pytest.mark.parametrize("metric", ["normalized_cosine", "euclidean"])
def test_pq_flat_search_matches_numpy(metric):
    rows, books, queries = _draw(seed=1)
    codes = reference_pq.encode(torch.from_numpy(rows), torch.from_numpy(books))
    decoded = np.concatenate([books[j][codes[:, j].numpy()] for j in range(books.shape[0])], 1)
    k, oversample = 5, 4
    pq_d = _numpy_distances(queries, decoded, metric)
    short = np.argsort(pq_d, axis=1, kind="stable")[:, : k * oversample]
    exact = np.take_along_axis(_numpy_distances(queries, rows, metric), short, 1)
    order = np.lexsort((short, exact), axis=1)[:, :k]
    want_i = np.take_along_axis(short, order, 1)
    ids, dists = reference_pq.pq_flat_search(
        torch.from_numpy(rows), torch.from_numpy(books), codes, torch.from_numpy(queries),
        metric, k, oversample, block_bytes=3 * 4 * len(rows))
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_allclose(dists.numpy(), np.take_along_axis(exact, order, 1), rtol=1e-5, atol=1e-6)


def test_the_cut_keeps_the_lowest_ids_of_a_tie():
    d = torch.tensor([[3.0, 1.0, 2.0, 2.0, 2.0, 0.5]])
    assert reference_pq.smallest(d, 3).tolist() == [[5, 1, 2]]
    assert reference_pq.smallest(d, 4).tolist() == [[5, 1, 2, 3]]


def test_train_without_iterations_is_the_training_rules_draw():
    """Sample and initial centroids restated: numpy's ``default_rng(seed + j)``
    permutation of the rows, then a fresh one of the sample."""
    rows, _, _ = _draw(seed=2, n=300, nsub=3)
    books, radius = reference_pq.train(torch.from_numpy(rows), 16, 4, iters=0, sample=100, seed=7)
    for j in range(3):
        sample = rows[np.random.default_rng(7 + j).permutation(300)[:100], 4 * j : 4 * j + 4]
        want = sample[np.random.default_rng(7 + j).permutation(100)[:16]]
        np.testing.assert_array_equal(books[j].numpy(), want)
        nearest = ((sample[:, None, :] - want[None]) ** 2).sum(-1).min(1)
        assert float(radius[j]) == pytest.approx(float(np.sqrt(nearest.mean())), rel=1e-5)


def test_train_is_lloyds_kmeans():
    rows, _, _ = _draw(seed=3, n=400, nsub=2)
    books, _ = reference_pq.train(torch.from_numpy(rows), 8, 4, iters=3, sample=400, seed=0,
                                  block_rows=64)
    for j in range(2):
        x = rows[:, 4 * j : 4 * j + 4].astype(np.float64)
        c = x[np.random.default_rng(j).permutation(400)[:8]]
        for _ in range(3):
            assign = ((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
            c = np.stack([x[assign == i].mean(0) if (assign == i).any() else c[i] for i in range(8)])
        np.testing.assert_allclose(books[j].numpy(), c, rtol=1e-5, atol=1e-6)


def test_the_programs_codebooks_sit_on_the_references():
    """The port's per-subspace k-means from the same draws, against the
    reference's: the gap is rounding, and a skipped iteration is not."""
    rows = torch.from_numpy(_draw(seed=4, n=20_000, nsub=4)[0])
    pq = {"centroids": 64, "dsub": 4, "iters": 5, "kmeans_sample": 8_000, "seed": 3}
    books = per_subspace_centroids(rows, 64, 4, seed=3, iters=5, sample=8_000)
    assert judge_pq.codebook_gap(rows, books, pq) < 1e-4
    skipped = per_subspace_centroids(rows, 64, 4, seed=3, iters=0, sample=8_000)
    assert judge_pq.codebook_gap(rows, skipped, pq) > 0.1


def test_control_fails_on_the_cpu():
    """The PQ reference in the program's place, one precision below (TF32
    emulated by rounding the operands)."""
    size = {**TINY, "rows": 20_000, "queries": 500, "dim": 96,
            "pq": {**TINY["pq"], "kmeans_sample": 5_000}}
    out = control_pq.control_numbers(CELL, 1, "cpu", size)
    assert not out["correct"], out
    assert out["checks"]["dist_gap"]["value"] > out["checks"]["dist_gap"]["limit"], out


def test_the_pq_reference_loads_nothing_of_the_program():
    script = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
              "from benchmark import control_pq, judge_pq, reference_pq; "
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "parallel_hnsw_tpu", "parallel_hnsw_tpu_torch"}


# -- the per-layer readers --------------------------------------------------------


def _read(name, ctx):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


def _cell_ctx(calls=2, kernel_s=0.3, scan_spans=(), program_spans=None):
    bench = harness.manifest()
    _, config, traffic, _ = harness.cell_files(bench, CELL)
    spans = profiling.HostSpans()
    spans.spans = list(scan_spans)
    cell = SimpleNamespace(config=config, traffic=traffic, k=config["k"], spans=spans,
                           corpus=torch.empty((config["rows"], config["dim"]), device="meta"))
    trace = profiling.Trace(window_s=1.0, busy_s=0.9, kernel_s=kernel_s, calls=calls)
    return SimpleNamespace(cell=cell, driver=None, trace=trace, spans=program_spans or {})


def test_roofline_arithmetic_at_the_cell():
    roofline = harness.load_module(harness.HERE / "metrics" / "kernel.pq_scan_roofline.py")
    q, n, d, k, oversample = 10_000, 9_990_000, 96, 10, 32
    assert roofline.flops(q, n, d) == pytest.approx(1.918080e13)
    # the codes, the codebooks, the queries, the rerank's rows, the answers, each once
    want = 479_520_000 + 1_572_864 + 3_840_000 + 1_228_800_000 + 800_000
    assert roofline.nbytes(q, n, d, k, oversample, 24, 4096, 4, 2) == want
    least = roofline.least_seconds(q, n, d, k, oversample, 24, 4096, 4, 2)
    assert least == pytest.approx(1.918080e13 / peaks.BF16_FLOPS)  # bound by operations
    assert least == pytest.approx(19.39e-3, rel=1e-3)
    assert _read("kernel.pq_scan_roofline", _cell_ctx(calls=2, kernel_s=2 * 0.1939)) == pytest.approx(10.0, rel=1e-3)


def test_roofline_reads_nothing_without_a_trace():
    ctx = _cell_ctx()
    ctx.trace = None
    assert _read("kernel.pq_scan_roofline", ctx) is None


def _scan(decoded_rows, queries=4096):
    return PhaseEvent("pq_scan", 1, 0.05, {"queries": queries, "code_blocks": 20,
                                           "decoded_rows": decoded_rows, "survivors": queries * 320})


def test_decodes_per_code(monkeypatch):
    n = 9_990_000
    events = [_scan(n), _scan(n), _scan(n, 1808)] * 2 + [PhaseEvent("pq_rerank", 1, 0.003, {"rows": 1})]
    monkeypatch.setattr(TRACER, "events", events)
    assert _read("pq.decodes_per_code", _cell_ctx(calls=2)) == pytest.approx(3.0)
    assert _read("pq.decodes_per_code", _cell_ctx(calls=0)) is None
    monkeypatch.setattr(TRACER, "events", [])  # a program without the span
    assert _read("pq.decodes_per_code", _cell_ctx(calls=2)) is None


def test_rerank_share():
    ms = 1_000_000
    calls = [(0, 170 * ms, "scan_call"), (200 * ms, 370 * ms, "scan_call"), (10, 20, "ids_to_host")]
    ctx = _cell_ctx(scan_spans=calls, program_spans={"pq_rerank": {"seconds": 0.0068, "calls": 2.0}})
    assert _read("pq.rerank_share", ctx) == pytest.approx(2.0)
    assert _read("pq.rerank_share", _cell_ctx(scan_spans=calls)) is None  # no such span
    assert _read("pq.rerank_share", _cell_ctx(program_spans={"pq_rerank": {"seconds": 1.0}})) is None
