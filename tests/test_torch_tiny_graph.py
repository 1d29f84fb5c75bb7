"""End-to-end search of the port over the reference's golden 9-vector graph
(mirrors tests/test_tiny_graph.py), and its recall against the executable
model of the reference's search, ``tests/ref_model.py``, on a graph the port
built (mirrors tests/test_recall_parity.py).

The golden graph matches the expected neighbors slab of the reference's
``test_generation`` (src/lib.rs:2070-2152); search results are checked
against ``test_nearness_search`` (src/lib.rs:2046-2068), distances included.
"""

import math
import os

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch.analysis import brute_force_knn
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import DenseSource, make_layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw_tpu_torch.search import search
from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus

from tests.ref_model import search_layers as ref_search_layers

R = 1.0 / math.sqrt(2.0)
SILLY_DATA = np.array(
    [
        [1.0, 0.0, 0.0],  # 0
        [0.0, 1.0, 0.0],  # 1
        [0.0, 0.0, 1.0],  # 2
        [R, R, 0.0],  # 3
        [0.5773, 0.5773, 0.5773],  # 4
        [-1.0, 0.0, 0.0],  # 5
        [0.0, -1.0, 0.0],  # 6
        [0.0, 0.0, -1.0],  # 7
        [0.0, R, R],  # 8
    ],
    dtype=np.float32,
)

# Golden bottom-layer slab from reference test_generation (src/lib.rs:2090-2151),
# 9 rows x 6 neighbors.
GOLDEN_NEIGHBORS = np.array(
    [
        [3, 4, 1, 2, 6, 7],
        [3, 8, 4, 0, 2, 5],
        [8, 4, 0, 1, 3, 5],
        [4, 0, 1, 8, 2, 7],
        [3, 8, 0, 1, 2, 5],
        [1, 2, 6, 8, 4, 3],
        [0, 2, 5, 7, 4, 3],
        [0, 1, 3, 6, 4, 8],
        [4, 1, 2, 3, 0, 5],
    ],
    dtype=np.int32,
)


def golden_layers():
    top = make_layer([0], [[EMPTY_ID, EMPTY_ID, EMPTY_ID]])
    bottom = make_layer(np.arange(9, dtype=np.int32), GOLDEN_NEIGHBORS)
    return [top, bottom]


@pytest.fixture(scope="module")
def setup():
    return golden_layers(), DenseSource(torch.from_numpy(SILLY_DATA)), SearchParams()


def test_nearness_search_parity(setup):
    layers, source, sp = setup
    query = torch.tensor([[0.0, R, R]], dtype=torch.float32)
    ids, dists = search(layers, source, Metric.COSINE, query, sp)
    want = [
        (8, 5.9604645e-8),
        (4, 0.1835745),
        (1, 0.29289323),
        (2, 0.29289323),
        (3, 0.5),
        (0, 1.0),
        (5, 1.0),
        (6, 1.7071068),
        (7, 1.7071068),
    ]
    got_ids = ids[0][: len(want)].numpy()
    got_dists = dists[0][: len(want)].numpy()
    np.testing.assert_array_equal(got_ids, [w[0] for w in want])
    np.testing.assert_allclose(got_dists, [w[1] for w in want], atol=1e-6)
    # everything after is empty
    assert np.all(ids[0][len(want) :].numpy() == EMPTY_ID)


def test_every_vector_finds_itself(setup):
    # reference: test_search (src/lib.rs:2154-2164)
    layers, source, sp = setup
    queries = torch.from_numpy(SILLY_DATA)
    ids, dists = search(layers, source, Metric.COSINE, queries, sp)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(9))
    # vector 4 ([0.5773]*3) is not exactly unit-norm, so its self-distance is
    # ~1.7e-4, the same value the reference's fp32 arithmetic produces.
    assert np.all(dists[:, 0].numpy() < 1e-3)


def test_exclude_self(setup):
    layers, source, sp = setup
    queries = torch.from_numpy(SILLY_DATA)
    exclude = torch.arange(9, dtype=torch.int32)
    ids, dists = search(layers, source, Metric.COSINE, queries, sp, exclude=exclude)
    got = ids.numpy()
    for i in range(9):
        assert i not in got[i], f"query {i} still returned itself"


def test_beam_width_one_matches_wide(setup):
    layers, source, sp = setup
    queries = torch.from_numpy(SILLY_DATA)
    ids1, _ = search(layers, source, Metric.COSINE, queries, sp.replace(beam_width=1))
    ids4, _ = search(layers, source, Metric.COSINE, queries, sp.replace(beam_width=4))
    # on this tiny graph with ef=300, both must find the full sorted set
    np.testing.assert_array_equal(ids1.numpy(), ids4.numpy())


def test_query_chunking(setup):
    layers, source, sp = setup
    queries = torch.from_numpy(SILLY_DATA)
    ids_a, _ = search(layers, source, Metric.COSINE, queries, sp)
    ids_b, _ = search(layers, source, Metric.COSINE, queries, sp, query_block=4)
    np.testing.assert_array_equal(ids_a.numpy(), ids_b.numpy())


def test_adaptive_host_path_matches_lockstep(setup):
    """The host-driven convergence-tail path (search_host) runs the same hop
    math in retiring chunks; results must equal the lockstep search."""
    layers, source, sp = setup
    queries = torch.from_numpy(SILLY_DATA)
    ids_a, d_a = search(layers, source, Metric.COSINE, queries, sp)
    ids_b, d_b = search(layers, source, Metric.COSINE, queries, sp, adaptive=True)
    np.testing.assert_array_equal(ids_a.numpy(), ids_b.numpy())
    np.testing.assert_allclose(d_a.numpy(), d_b.numpy(), atol=1e-6)


def test_adaptive_host_path_larger_graph():
    """Adaptive vs lockstep on a built graph with stragglers (mixed
    convergence times), which exercises the compaction / retire logic."""
    src = random_unit_corpus(600, 16, seed=3, device="cpu")
    hnsw = Hnsw.generate(
        src, None, BuildParams(optimization=OptimizationParams(recall_proportion=0.5)),
        Metric.COSINE, seed=0,
    )
    sp = SearchParams(number_of_candidates=24, upper_layer_candidate_count=24)
    q = src.vectors[:128]
    ids_a, _ = search(hnsw.layers, src, Metric.COSINE, q, sp)
    ids_b, _ = search(hnsw.layers, src, Metric.COSINE, q, sp, adaptive=True)
    np.testing.assert_array_equal(ids_a[:, :10].numpy(), ids_b[:, :10].numpy())


# -- recall against the model of the reference's search ---------------------


def _np_layers(layers):
    return [(l.nodes.numpy(), l.neighbors.numpy()) for l in layers]


def _cosine_dist_to(data):
    def make(q):
        def dist_to(vec_id: int) -> float:
            return float(1.0 - np.dot(q, data[vec_id]))

        return dist_to

    return make


def test_model_reproduces_reference_golden_search():
    """The numpy model reproduces test_nearness_search (src/lib.rs:2046-2068)
    on the golden graph the port's search walks above."""
    data = SILLY_DATA.astype(np.float64)
    got = ref_search_layers(
        _np_layers(golden_layers()),
        _cosine_dist_to(data)(np.array([0.0, R, R])),
        number_of_candidates=300,
        upper_layer_candidate_count=100,
        probe_depth=2,
    )
    assert [i for i, _ in got] == [8, 4, 1, 2, 3, 0, 5, 6, 7]
    want_d = [0.0, 0.1835745, 0.29289323, 0.29289323, 0.5, 1.0, 1.0, 1.7071068, 1.7071068]
    np.testing.assert_allclose([d for _, d in got], want_d, atol=1e-6)


def _recall_sweep(index, data, queries, q_rows, gt, efs, upper, query_block=0):
    """Recall@10 of the port's search and of the reference model at each ef,
    on the index's own graph."""
    np_layers = _np_layers(index.layers)
    make = _cosine_dist_to(data)
    out = []
    for ef in efs:
        sp = SearchParams(number_of_candidates=ef, upper_layer_candidate_count=min(ef, upper),
                          probe_depth=2)
        ours = index.search(queries, sp, query_block=query_block)[0][:, :10].numpy()
        ref_hits = port_hits = 0
        for qi, row in enumerate(q_rows):
            ref = ref_search_layers(np_layers, make(data[row]), number_of_candidates=ef,
                                    upper_layer_candidate_count=min(ef, upper), probe_depth=2)
            ref_hits += len(np.intersect1d([i for i, _ in ref][:10], gt[qi]))
            port_hits += len(np.intersect1d(ours[qi], gt[qi]))
        out.append((ef, port_hits / (len(q_rows) * 10), ref_hits / (len(q_rows) * 10)))
    return out


def test_recall_parity_on_identical_graph():
    """ef sweep on one graph the port built: the port's recall@10 >= the
    reference semantics' recall@10 at every operating point (same M, ef and
    probe_depth), with 2% for traversal-order ties."""
    source = random_unit_corpus(600, 16, seed=13, device="cpu")
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.2))
    index = Hnsw.generate(source, None, bp, Metric.COSINE, seed=1)
    data = source.vectors.numpy().astype(np.float64)
    queries = source.vectors[:64]
    gt = brute_force_knn(source, queries, Metric.COSINE, 10)[0].numpy()
    for ef, port_recall, ref_recall in _recall_sweep(index, data, queries, range(64), gt,
                                                     (12, 24, 48), 24):
        assert port_recall >= ref_recall - 0.02, (ef, port_recall, ref_recall)


@pytest.mark.skipif(
    not os.environ.get("PHNSW_SLOW"),
    reason="slow (~10+ min on the CPU): set PHNSW_SLOW=1",
)
def test_recall_parity_at_scale():
    """The engine's queue-bounded lockstep exploration matches or beats the
    reference's unbounded visit-list semantics on one large graph (100k)."""
    count, dim, n_q = 100_000, 32, 96
    source = random_unit_corpus(count, dim, seed=17, device="cpu")
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.01))
    index = Hnsw.generate(source, None, bp, Metric.COSINE, seed=1, improve=False)
    data = source.vectors.numpy().astype(np.float64)
    q_idx = np.random.default_rng(5).permutation(count)[:n_q]
    queries = source.vectors[torch.from_numpy(q_idx)]
    gt = brute_force_knn(source, queries, Metric.COSINE, 10)[0].numpy()
    for ef, port_recall, ref_recall in _recall_sweep(index, data, queries, q_idx, gt,
                                                     (24, 100), 100, query_block=96):
        assert port_recall >= ref_recall - 0.02, (ef, port_recall, ref_recall)
