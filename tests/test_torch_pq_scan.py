"""A scan-only ``QuantizedHnsw`` (``new(build_graph=False)``: codebooks and
codes, no code graph) against the plain PQ reference
(``benchmark/reference_pq.py``), at both ``search_exact`` routes: the
pairwise scan below 200,000 codes and the binned scan from there.  Also: the
graph methods refuse such an index, ``build_graph=True`` builds what it
always built, and the ``pq_scan`` / ``pq_rerank`` spans."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric, PqBuildParams, QuantizedHnsw
from parallel_hnsw_tpu_torch.graph import MemmapSource, widen_codes
from parallel_hnsw_tpu_torch.pq import kmeans_centroids, per_subspace_centroids
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams
from parallel_hnsw_tpu_torch.utils.trace import TRACER

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference_pq  # noqa: E402

torch.set_num_threads(2)

METRIC_NAMES = {Metric.NORMALIZED_COSINE: "normalized_cosine", Metric.EUCLIDEAN: "euclidean"}
K, OVERSAMPLE = 10, 8


def _unit_rows(n, d, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _scan_only(corpus, centroids, metric, fast, **kwargs):
    return QuantizedHnsw.new(centroids, DenseSource(vectors=corpus), 4, metric, per_subspace=True,
                             fast_quantize=fast, build_graph=False, **kwargs)


@pytest.fixture(scope="module")
def corpus():
    return _unit_rows(10_000, 16, seed=1)


@pytest.fixture(scope="module")
def queries():
    return _unit_rows(64, 16, seed=2)


@pytest.fixture(scope="module")
def fast_index(corpus):
    """4096 random centroids a subspace: the binned quantize route."""
    return _scan_only(corpus, 4096, Metric.NORMALIZED_COSINE, fast=True)


def _coded_rows(n, nsub, clusters, seed):
    """Rows near a PQ code each: per subspace one of ``clusters`` random
    4-d points, plus a little noise, so that the order of the codes'
    distances follows the rows'."""
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((nsub, clusters, 4)).astype(np.float32) * 0.25
    codes = rng.integers(0, clusters, (n, nsub))
    x = np.concatenate([points[j][codes[:, j]] for j in range(nsub)], axis=1)
    return torch.from_numpy(x + 0.005 * rng.standard_normal(x.shape).astype(np.float32))


@pytest.fixture(scope="module")
def binned_index():
    """200,000 codes of 16 dims (4 subspaces of 256 centroids), exact
    quantize: ``search_exact``'s binned route."""
    rows = _coded_rows(200_000, 4, 64, seed=3)
    return rows, _scan_only(rows, 256, Metric.NORMALIZED_COSINE, fast=False)


def _codes(index):
    return widen_codes(index.hnsw.source.codes).long()


def test_scan_only_index_holds_codes_and_no_graph(fast_index, corpus):
    src = fast_index.hnsw.source
    assert fast_index.hnsw.layers == []
    assert src.codes.dtype == torch.uint16 and tuple(src.codes.shape) == (10_000, 4)
    assert tuple(src.codebook.shape) == (4, 4096, 4)
    assert fast_index.vector_count == 10_000


def test_fast_quantize_agrees_with_the_reference(fast_index, corpus):
    want = reference_pq.encode(corpus, fast_index.hnsw.source.codebook)
    agree = float((_codes(fast_index) == want).float().mean())
    assert agree >= 0.999, agree


@pytest.mark.parametrize("metric", sorted(METRIC_NAMES, key=str))
def test_exact_quantize_equals_the_reference(corpus, metric):
    index = _scan_only(corpus[:4000], 64, metric, fast=False)
    want = reference_pq.encode(corpus[:4000], index.hnsw.source.codebook)
    assert torch.equal(_codes(index), want)


def _hold_to_reference(index, corpus, queries, metric):
    ids, dists = index.search_exact(queries, k=K, rerank=True, oversample=OVERSAMPLE)
    src = index.hnsw.source
    want_i, want_d = reference_pq.pq_flat_search(corpus, src.codebook, src.codes, queries,
                                                 METRIC_NAMES[metric], K, OVERSAMPLE)
    same = (ids.long() == want_i).all(1).float().mean()
    assert float(same) >= 0.99, float(same)
    rows = (ids.long() == want_i).all(1)
    torch.testing.assert_close(dists[rows], want_d[rows], rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric", sorted(METRIC_NAMES, key=str))
def test_pairwise_route_matches_the_reference(fast_index, corpus, queries, metric):
    if metric is not Metric.NORMALIZED_COSINE:
        fast_index = _scan_only(corpus, 4096, metric, fast=True)
    _hold_to_reference(fast_index, corpus, queries, metric)


def test_binned_route_matches_the_reference(binned_index):
    rows, index = binned_index
    assert index.vector_count >= 200_000  # search_exact's binned route
    # centroids a few thousandths apart: the program's squared distances by
    # |x|^2 + |c|^2 - 2 x.c round where the reference's differences do not
    want = reference_pq.encode(rows, index.hnsw.source.codebook)
    assert float((_codes(index) == want).float().mean()) >= 0.999
    _hold_to_reference(index, rows, _unit_rows(200, 16, seed=4), Metric.NORMALIZED_COSINE)


GRAPH_CALLS = {
    "search": lambda ix, q: ix.search(q),
    "improve_index": lambda ix, q: ix.improve_index(),
    "improve_neighbors": lambda ix, q: ix.improve_neighbors(),
    "promote_at_layer": lambda ix, q: ix.promote_at_layer(0),
    "stochastic_recall": lambda ix, q: ix.stochastic_recall(),
    "threshold_nn": lambda ix, q: ix.threshold_nn(0.1),
}


@pytest.mark.parametrize("call", sorted(GRAPH_CALLS))
def test_graph_methods_refuse_a_scan_only_index(fast_index, queries, call):
    with pytest.raises(ValueError, match="build_graph"):
        GRAPH_CALLS[call](fast_index, queries)


BP = BuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                 optimization=OptimizationParams(recall_proportion=1.0))


def _same_layers(a, b):
    return len(a.layers) == len(b.layers) and all(
        torch.equal(x.nodes, y.nodes) and torch.equal(x.neighbors, y.neighbors)
        for x, y in zip(a.layers, b.layers))


def test_build_graph_true_builds_what_new_always_built():
    rows = _unit_rows(120, 8, seed=5)
    pqp = PqBuildParams(centroids=BP, hnsw=BP)
    args = (16, DenseSource(vectors=rows), 4, Metric.NORMALIZED_COSINE)
    default = QuantizedHnsw.new(*args, pqp=pqp, per_subspace=True, seed=3)
    built = QuantizedHnsw.new(*args, pqp=pqp, per_subspace=True, seed=3, build_graph=True)
    scan_only = QuantizedHnsw.new(*args, pqp=pqp, per_subspace=True, seed=3, build_graph=False)
    # the graph new() has always built: Hnsw.generate over the codes, seeded alike
    by_hand = Hnsw.generate(default.hnsw.source, None, pqp.hnsw, Metric.NORMALIZED_COSINE, seed=3)
    assert _same_layers(default.hnsw, built.hnsw) and _same_layers(default.hnsw, by_hand)
    for other in (built, scan_only):
        assert torch.equal(other.hnsw.source.codes.view(torch.int16), default.hnsw.source.codes.view(torch.int16))
        assert torch.equal(other.hnsw.source.codebook, default.hnsw.source.codebook)
    assert default.hnsw.layers and scan_only.hnsw.layers == []
    assert default.vector_count == scan_only.vector_count == 120


@pytest.mark.parametrize("per_subspace", [True, False])
def test_kmeans_iters_reaches_the_training(per_subspace):
    rows = _unit_rows(3_000, 8, seed=6)
    pqp = PqBuildParams(centroids=BP, hnsw=BP)

    def books(**kwargs):
        index = QuantizedHnsw.new(32, DenseSource(vectors=rows), 4, Metric.NORMALIZED_COSINE, pqp=pqp,
                                  per_subspace=per_subspace, use_kmeans=True, kmeans_sample=1_000,
                                  seed=2, build_graph=False, **kwargs)
        return index.hnsw.source.codebook

    if per_subspace:
        trained = lambda iters: per_subspace_centroids(rows, 32, 4, seed=2, iters=iters, sample=1_000)
    else:
        trained = lambda iters: kmeans_centroids(rows, 32, 4, iters=iters, seed=2, sample=1_000)
    assert torch.equal(books(), trained(5))  # the default: the JAX package's 5
    for iters in (0, 2):
        assert torch.equal(books(kmeans_iters=iters), trained(iters))
    assert not torch.equal(trained(0), trained(5))


@pytest.fixture
def tracer():
    saved = (TRACER.enabled, TRACER.log, list(TRACER.events))
    TRACER.events.clear()
    yield TRACER
    TRACER.enabled, TRACER.log = saved[:2]
    TRACER.events[:] = saved[2]


def test_spans_and_counters_with_the_tracer_on(fast_index, queries, tracer):
    tracer.enabled = True
    fast_index.search_exact(queries, k=K, oversample=OVERSAMPLE, code_block=4096, query_block=40)
    scans = [e for e in tracer.events if e.name == "pq_scan"]
    assert [e.counters["queries"] for e in scans] == [40, 24]
    for e in scans:
        assert e.counters["code_blocks"] == 3 and e.counters["decoded_rows"] == 10_000
        assert e.counters["survivors"] == e.counters["queries"] * K * OVERSAMPLE
        assert e.t1_ns >= e.t0_ns
    (rerank,) = [e for e in tracer.events if e.name == "pq_rerank"]
    assert rerank.counters == {"rows": 64 * K * OVERSAMPLE, "host": 0}


def test_rerank_span_counts_a_host_source(fast_index, corpus, queries, tracer):
    index = QuantizedHnsw(fast_index.quantizer, fast_index.hnsw, MemmapSource(vectors=corpus.numpy()))
    tracer.enabled = True
    ids, _ = index.search_exact(queries, k=K, oversample=OVERSAMPLE)
    (rerank,) = [e for e in tracer.events if e.name == "pq_rerank"]
    assert rerank.counters["host"] == 1
    assert torch.equal(ids, fast_index.search_exact(queries, k=K, oversample=OVERSAMPLE)[0])


def test_no_spans_with_the_tracer_off(fast_index, queries, tracer):
    tracer.enabled = False
    fast_index.search_exact(queries, k=K, oversample=OVERSAMPLE)
    assert tracer.events == []
