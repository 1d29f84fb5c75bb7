"""The port's Hnsw end to end against the JAX package: generate + improve_index
in both packages on the same numpy corpora, exact search, the numpy round
trip, relink tiers and repair on identical graphs, self-repair on the
reference's broken-graph fixture, the tracer, and an import without jax."""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import promote as jax_promote
from parallel_hnsw_tpu.analysis import brute_force_knn as jax_brute_force_knn
from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.graph import Layer as JaxLayer
from parallel_hnsw_tpu.index import Hnsw as JaxHnsw
from parallel_hnsw_tpu.params import SearchParams as JaxSearchParams
from parallel_hnsw_tpu.params import params_to_dict
from parallel_hnsw_tpu.promote import extend_layer as jax_extend_layer
from parallel_hnsw_tpu_torch import promote
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_from_numpy, hnsw_to_numpy
from parallel_hnsw_tpu_torch.graph import DenseSource, Layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw_tpu_torch.utils.trace import TRACER, Tracer, torch_profile

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)

# (count, dim, metric, unit vectors).  One shape for both, so the second JAX
# build reuses the first one's compiled shape-only functions.
CONFIGS = {
    "cosine_1500x16": (1500, 16, Metric.COSINE, True),
    "euclidean_1500x16": (1500, 16, Metric.EUCLIDEAN, False),
}
N_QUERIES = 100


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def built(request):
    count, dim, metric, unit = CONFIGS[request.param]
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (count + N_QUERIES, dim)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    corpus, queries = x[:count], x[count:]
    jh = JaxHnsw.generate(JaxSource(jnp.asarray(corpus)), metric=metric.value, seed=5)
    j_recall = jh.improve_index()
    th = Hnsw.generate(DenseSource(torch.from_numpy(corpus)), metric=metric, seed=5)
    t_recall = th.improve_index()
    return jh, th, corpus, queries, j_recall, t_recall


def _recall_at_10(ids, gt):
    return float(np.mean([len(set(a[:10]) & set(b)) / 10 for a, b in zip(ids, gt)]))


def test_generate_and_improve_match_jax(built):
    jh, th, corpus, queries, j_recall, t_recall = built
    th.assert_invariants()
    assert th.layer_count == jh.layer_count and len(th) == len(corpus)
    assert abs(t_recall - j_recall) <= 0.02, (t_recall, j_recall)
    gt = th.search_exact(torch.from_numpy(queries), k=10)[0].numpy()
    j_ids = np.asarray(jh.search(jnp.asarray(queries))[0])
    t_ids, t_d = th.search(torch.from_numpy(queries))
    assert t_ids.dtype == torch.int32 and bool(torch.all(t_d[:, 1:] >= t_d[:, :-1]))
    j_rec, t_rec = _recall_at_10(j_ids, gt), _recall_at_10(t_ids.numpy(), gt)
    assert abs(t_rec - j_rec) <= 0.02, (t_rec, j_rec)
    assert t_rec >= 0.9


def test_search_exact_matches_jax_brute_force(built):
    jh, th, corpus, queries, _, _ = built
    j_ids, j_d = jax_brute_force_knn(jh.source, jnp.asarray(queries), jh.metric, 10)
    t_ids, t_d = th.search_exact(torch.from_numpy(queries), k=10)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-5)
    for t_row, j_row in zip(t_ids.numpy(), np.asarray(j_ids)):
        assert set(t_row) == set(j_row)
    # self-exclusion through the fast (oversampled + reranked) tier
    from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise

    feats = th.source.vectors
    e_ids, e_d = blocked_topk_pairwise(feats, feats, th.metric, 5, exclude_diag_offset=0)
    f_ids, f_d = blocked_topk_pairwise(feats, feats, th.metric, 5, exclude_diag_offset=0, fast=True)
    assert not bool((e_ids == torch.arange(len(feats))[:, None]).any())
    assert torch.equal(e_ids, f_ids)
    torch.testing.assert_close(e_d, f_d, atol=1e-5, rtol=0)


def test_numpy_round_trip(built):
    _, th, _, queries, _, _ = built
    back = hnsw_from_numpy(*hnsw_to_numpy(th))
    assert back.metric is th.metric and back.build_parameters == th.build_parameters
    for a, b in zip(back.layers, th.layers):
        assert torch.equal(a.nodes, b.nodes) and torch.equal(a.neighbors, b.neighbors)
    q = torch.from_numpy(queries)
    for a, b in zip(back.search(q), th.search(q)):
        assert torch.equal(a, b)


def test_repair_plumbing_matches_jax_on_identical_graph(built):
    jh, _, corpus, _, _, _ = built
    layers = [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in jh.layers]
    th = hnsw_from_numpy(layers, corpus, jh.metric.value, params_to_dict(jh.build_parameters))
    bottom = th.layer_count - 1
    sp = SearchParams(number_of_candidates=6, upper_layer_candidate_count=6, probe_depth=1)
    want = np.asarray(jh.discover_unreachable_vectors(bottom, JaxSearchParams(**vars(sp))))
    assert set(th.discover_unreachable_vectors(bottom, sp)) == set(want)
    # extend the layer above the bottom with bottom-layer vectors it lacks
    above = np.asarray(jh.layers[-2].nodes)
    new = np.setdiff1d(np.asarray(jh.layers[-1].nodes), above)[:7]
    want = jax_extend_layer(list(jh.layers), 1, new)[-2]
    th.extend_layer(1, new)
    np.testing.assert_array_equal(th.layers[-2].nodes.numpy(), np.asarray(want.nodes))
    np.testing.assert_array_equal(th.layers[-2].neighbors.numpy(), np.asarray(want.neighbors))
    th.assert_invariants()
    ids, _ = th.search_ids(np.arange(20), exclude_self=True)
    assert not bool((ids == torch.arange(20, dtype=torch.int32)[:, None]).any())
    assert th.get_layer(0) is th.layers[bottom] and th.supers_for_layer(bottom).shape == (1,)


@pytest.fixture(scope="module")
def small_graph():
    """A raw 600 x 16 graph built by the port, and the same arrays for JAX."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (600, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    th = Hnsw.generate(DenseSource(torch.from_numpy(x)), metric=Metric.COSINE, seed=3, improve=False)
    j_layers = [JaxLayer(jnp.asarray(l.nodes.numpy()), jnp.asarray(l.neighbors.numpy())) for l in th.layers]
    return th, j_layers, JaxSource(jnp.asarray(x))


@pytest.mark.parametrize(
    "tier, exact_threshold, fast_threshold, node_block",
    [("exact", 131072, 0, 0), ("fast", 0, 2_000_000, 0), ("jit", 0, 0, 0), ("blocked", 0, 0, 256)],
)
def test_relink_tiers_match_jax(small_graph, tier, exact_threshold, fast_threshold, node_block):
    from parallel_hnsw_tpu.optimize import link_layer_to_better_neighbors as jax_link
    from parallel_hnsw_tpu_torch.optimize import link_layer_to_better_neighbors

    th, j_layers, j_source = small_graph
    sp = SearchParams(number_of_candidates=16, upper_layer_candidate_count=16)
    lft = th.layer_count - 1
    kw = dict(node_block=node_block, exact_threshold=exact_threshold, fast_threshold=fast_threshold)
    j_out, j_changed, j_tier = jax_link(list(j_layers), lft, j_source, "cosine", JaxSearchParams(**vars(sp)), **kw)
    t_out, t_changed, t_tier = link_layer_to_better_neighbors(th.layers, lft, th.source, th.metric, sp, **kw)
    assert t_tier == j_tier == tier
    got, want = t_out[lft].neighbors.numpy(), np.asarray(j_out[lft].neighbors)
    same = np.mean([set(g) == set(w) for g, w in zip(got, want)])
    assert same >= 0.99, same
    assert t_changed > 0 and abs(t_changed - j_changed) <= 0.01 * len(got)


def test_promotion_candidates_match_jax(small_graph):
    """Cut every edge into a cluster of bottom-layer nodes from outside it:
    the cluster turns unreachable, its rows still point into it, so the
    neighbor histogram and the hypersphere cover both have work to do."""
    graph, _, j_source = small_graph
    layers = list(graph.layers)
    bottom = layers[-1]
    nb = bottom.neighbors.numpy().copy()
    upper = layers[-2].nodes.numpy()
    cluster = [n for n in [0, *nb[0][:12]] if n != EMPTY_ID and bottom.nodes[n].item() not in upper]
    outside = ~np.isin(np.arange(len(nb)), cluster)
    nb[outside] = np.where(np.isin(nb[outside], cluster), EMPTY_ID, nb[outside])
    layers[-1] = Layer(bottom.nodes, torch.from_numpy(nb))

    sp = SearchParams(number_of_candidates=24, upper_layer_candidate_count=24)
    lft = len(layers) - 1
    j_layers = [JaxLayer(jnp.asarray(l.nodes.numpy()), jnp.asarray(l.neighbors.numpy())) for l in layers]
    vecs = promote.discover_unreachable_vectors(layers, lft, graph.source, graph.metric, sp)
    j_vecs = jax_promote.discover_unreachable_vectors(j_layers, lft, j_source, "cosine", sp)
    np.testing.assert_array_equal(vecs, np.asarray(j_vecs))
    got = promote.filter_promotion_candidates(layers, lft, vecs, graph.source, graph.metric, sp)
    want = jax_promote.filter_promotion_candidates(j_layers, lft, j_vecs, j_source, "cosine", sp)
    assert sum(len(v) for _, v in got) > 0
    assert [(o, list(v)) for o, v in got] == [(o, list(v)) for o, v in want]


# The reference's broken-graph fixture (tests/test_repair.py; reference
# make_broken_hnsw, src/lib.rs:2017-2044).
R = 1.0 / math.sqrt(2.0)
DATA10 = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [R, R, 0.0],
        [0.5773, 0.5773, 0.5773],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, R, R],
        [R, 0.0, R],  # the extra vector the broken fixture disconnects
    ],
    dtype=np.float32,
)

BP = BuildParams(
    order=6,
    neighborhood_size=3,
    zero_layer_neighborhood_size=6,
    optimization=OptimizationParams(recall_proportion=1.0),
)


def build_simple():
    return Hnsw.generate(
        DenseSource(torch.from_numpy(DATA10)), np.arange(9), BP, Metric.COSINE, seed=1
    )


def broken():
    """The simple index with vector 9 appended to the bottom layer, unlinked."""
    hnsw = build_simple()
    bottom = hnsw.layers[-1]
    hnsw.layers[-1] = Layer(
        nodes=torch.cat([bottom.nodes, torch.tensor([9], dtype=torch.int32)]),
        neighbors=torch.cat(
            [bottom.neighbors, torch.full((1, bottom.neighborhood_size), EMPTY_ID, dtype=torch.int32)]
        ),
    )
    return hnsw


def test_tiny_generate_full_recall():
    hnsw = build_simple()
    hnsw.assert_invariants()
    assert hnsw.vector_count == 9 and hnsw.entry_vector in range(9)
    assert hnsw.stochastic_recall() == 1.0


def test_broken_graph_repair():
    hnsw = broken()
    assert 9 in hnsw.discover_unreachable_vectors(hnsw.layer_count - 1).tolist()
    assert hnsw.improve_index() == 1.0
    hnsw.assert_invariants()
    ids, dists = hnsw.search(torch.from_numpy(DATA10[9:10]))
    assert int(ids[0, 0]) == 9 and float(dists[0, 0]) < 1e-5


def test_promote_at_layer_keeps_invariants():
    hnsw = broken()
    hnsw.promote_at_layer(hnsw.layer_count - 1)
    hnsw.assert_invariants()
    assert hnsw.vector_count == 10


def test_extend_layer_remap():
    hnsw = build_simple()
    target = hnsw.get_layer(1)
    missing = sorted(set(range(9)) - set(target.nodes.tolist()))[:2]
    hnsw.extend_layer(1, np.asarray(missing))
    hnsw.assert_invariants()
    assert hnsw.get_layer(1).node_count == target.node_count + len(missing)


# The tracer (counterpart of tests/test_trace.py) and the profiler hook.


def test_tracer_nesting_summary_and_sync():
    t = Tracer(enabled=True)
    with t.span("outer", sync=(torch.ones(2), {"a": torch.zeros(1)}), n=2):
        with t.span("inner"):
            pass
        with t.span("inner"):
            pass
    assert [e.name for e in t.events] == ["inner", "inner", "outer"]
    assert t.events[0].depth == 1 and t.events[2].depth == 0
    assert t.summary()["inner"]["calls"] == 2
    assert t.events[2].counters == {"n": 2}
    assert "outer" in t.format_summary()


def test_tracer_disabled_records_nothing():
    t = Tracer(enabled=False)
    with t.span("x"):
        pass
    t.count("y")
    assert t.events == []


def test_build_emits_phase_events_and_profile(tmp_path):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    src = DenseSource(vectors=torch.from_numpy(vecs))
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.5))
    TRACER.enabled = True
    TRACER.events.clear()
    try:
        with torch_profile(str(tmp_path)):
            index = Hnsw.generate(src, None, bp, Metric.COSINE, seed=0)
            index.improve_neighbors()  # force at least one relink sweep
        names = {e.name for e in TRACER.events}
    finally:
        TRACER.enabled = False
        TRACER.events.clear()
    assert {"generate_layer", "improve_index", "relink_layer", "stochastic_recall"} <= names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_import_leaves_jax_out():
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "import parallel_hnsw_tpu_torch, parallel_hnsw_tpu_torch.convert\n"
        "import parallel_hnsw_tpu_torch.utils.data, parallel_hnsw_tpu_torch.utils.trace\n"
        "import parallel_hnsw_tpu_torch.ops.cuda_distance\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'parallel_hnsw_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
