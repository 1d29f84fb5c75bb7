"""The port's graph diagnostics (BFS distance maps, reachability, argmin
partitioning, promotion discovery) against the JAX package, bit for bit, and
against scipy's shortest paths.

Mirrors the diagnostic cases of tests/test_selfsim.py on the nine-vector
index, then holds every function of ``analysis``'s diagnostics to the JAX
package's on two graphs that the port builds and ``convert`` hands over: that
index, and a 600 x 16 graph over small integers under squared euclidean
(every f32 distance exact in both packages) whose bottom layer is cut so it
has ``EMPTY_ID`` slots, a duplicate neighbor in a row and nodes no edge
reaches, with supers that include a vector the layer does not hold."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import analysis as janalysis
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource, Layer as JLayer
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import build_params_from_dict as j_build_params_from_dict
from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric, OptimizationParams
from parallel_hnsw_tpu_torch import analysis
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_to_numpy
from parallel_hnsw_tpu_torch.graph import Layer, make_layer

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

INF = np.iinfo(np.int32).max
R = 1.0 / math.sqrt(2.0)
DATA = np.array(
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
    ],
    dtype=np.float32,
)

BP = BuildParams(
    order=6,
    neighborhood_size=3,
    zero_layer_neighborhood_size=6,
    optimization=OptimizationParams(recall_proportion=1.0),
)


@pytest.fixture(scope="module")
def hnsw():
    source = DenseSource(torch.from_numpy(DATA))
    return Hnsw.generate(source, np.arange(9), BP, Metric.COSINE, seed=1)


def _to_jax(hnsw):
    layers, vectors, metric, bp_dict = hnsw_to_numpy(hnsw)
    return JHnsw(
        [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in layers],
        JDenseSource(vectors=jnp.asarray(vectors)), metric, j_build_params_from_dict(bp_dict),
    )


# -- the diagnostic cases of tests/test_selfsim.py -------------------------------


def test_node_distances_reachability(hnsw):
    bottom = hnsw.layers[-1]
    supers = hnsw.supers_for_layer(0)
    hops, isum = analysis.node_distances(bottom, torch.as_tensor(supers, dtype=torch.int32))
    assert hops.dtype == np.int32 and isum.dtype == np.int32
    # graph achieved full recall → everything reachable from the supers
    assert np.all(hops < INF)
    assert np.all(isum < INF)
    # deterministic across runs (reference: test_supers, src/lib.rs:2194-2215)
    hops2, isum2 = analysis.node_distances(bottom, torch.as_tensor(supers, dtype=torch.int32))
    np.testing.assert_array_equal(hops, hops2)
    np.testing.assert_array_equal(isum, isum2)


def test_unreachable_bfs_detects_disconnected():
    # a node with no incoming edges is BFS-unreachable
    nb = np.array([[1, EMPTY_ID], [0, EMPTY_ID], [EMPTY_ID, EMPTY_ID]], dtype=np.int32)
    layer = make_layer([10, 20, 30], nb)
    hops, _ = analysis.node_distances(layer, torch.tensor([10], dtype=torch.int32))
    assert hops[2] == INF
    promote = analysis.discover_nodes_to_promote(layer, torch.tensor([10], dtype=torch.int32))
    assert promote.tolist() == [2]


def test_reachables_and_reverse(hnsw):
    bottom = hnsw.layers[-1]
    res = analysis.reachables_from(bottom, 0, list(range(9)))
    reached = {n for n, _ in res}
    assert len(reached) >= 5  # dense little graph
    rev = analysis.reverse_get_neighbors(bottom, 4)
    nb = bottom.neighbors.numpy()
    for r in rev:
        assert 4 in nb[r]


def test_group_nodes_by_vectors(hnsw):
    bottom = hnsw.layers[-1]
    part = analysis.group_nodes_by_vectors(
        bottom, hnsw.source, Metric.COSINE, torch.tensor([0, 1], dtype=torch.int32)
    )
    # vector 0 belongs to super 0's group; vector 1 to super 1's
    assert part[0] == 0 and part[1] == 1


def test_multi_node_distances(hnsw):
    bottom = hnsw.layers[-1]
    supers = torch.as_tensor(hnsw.supers_for_layer(0), dtype=torch.int32)
    sup_idx, hops, isum = analysis.multi_node_distances(bottom, supers, k=2)
    n = bottom.node_count
    assert sup_idx.shape == (n, min(2, len(supers)))
    # the closest (by hops) super of a reachable node has finite distances
    assert (hops[:, 0] < INF).all()


def test_node_distances_from_closest_super(hnsw):
    bottom = hnsw.layers[-1]
    supers = torch.as_tensor(hnsw.supers_for_layer(0), dtype=torch.int32)
    hops, isum = analysis.node_distances_from_closest_super(
        bottom, hnsw.source, Metric.COSINE, supers
    )
    # super nodes are distance 0 from themselves
    nodes = bottom.nodes.numpy()
    for s in supers.numpy():
        pos = int(np.searchsorted(nodes, s))
        assert hops[pos] == 0
    not_conn = analysis.nodes_not_connected_to_super(bottom, hnsw.source, Metric.COSINE, supers)
    assert len(not_conn) == 0  # fully-repaired tiny graph


# -- parity with the JAX package, bit for bit --------------------------------


@pytest.fixture(scope="module")
def cut_graph():
    """A 600 x 16 integer-grid index whose bottom layer is cut: the last two
    slots of every tenth row emptied, row 7 holding its first neighbor twice,
    and every edge into nodes 10-12 removed (no super holds them)."""
    grid = np.random.default_rng(23).integers(-4, 5, size=(600, 16)).astype(np.float32)
    h = Hnsw.generate(DenseSource(torch.from_numpy(grid)), metric="squared_euclidean", seed=2,
                      improve=False)
    nb = h.layers[-1].neighbors.clone()
    nb[::10, -2:] = EMPTY_ID
    nb[7, 1] = nb[7, 0]
    nb[torch.isin(nb, torch.tensor([10, 11, 12], dtype=torch.int32))] = EMPTY_ID
    h.layers[-1] = Layer(nodes=h.layers[-1].nodes, neighbors=nb)
    return h


@pytest.fixture(scope="module", params=["nine", "cut"])
def pair(request, hnsw, cut_graph):
    """``(port index, JAX index, layer id from the bottom, supers)`` for each
    graph and each of its two lower layers; the supers are the layer above's
    nodes, with 10-12 dropped and a vector outside the layer added (the
    nine-vector index's bottom layer holds every vector, so it takes 9)."""
    h = hnsw if request.param == "nine" else cut_graph
    j = _to_jax(h)
    out = []
    for layer_id in (0, 1):
        supers = h.supers_for_layer(layer_id)
        supers = supers[~np.isin(supers, [10, 11, 12])]
        outside = np.setdiff1d(np.arange(h.source.count + 1), h.get_layer(layer_id).nodes.numpy())
        out.append((layer_id, np.append(supers, outside[0]).astype(np.int32)))
    return h, j, out


def _both(pair, fn, args):
    """``fn`` of the port and of the JAX package on each lower layer, with
    the arguments ``args(index, supers, package)`` gives."""
    h, j, cases = pair
    for layer_id, supers in cases:
        t_layer, j_layer = h.get_layer(layer_id), j.get_layer(layer_id)
        yield (getattr(analysis, fn)(t_layer, *args(h, supers, "torch")),
               getattr(janalysis, fn)(j_layer, *args(j, supers, "jax")))


def _supers(index, supers, pkg):
    return (torch.from_numpy(supers) if pkg == "torch" else jnp.asarray(supers),)


def _with_source(index, supers, pkg):
    return (index.source, index.metric) + _supers(index, supers, pkg)


def _assert_same(got, want):
    if isinstance(want, (tuple, list)) and want and isinstance(want[0], tuple):
        assert got == want  # reachables_from: [(node, cost)] in discovery order
        return
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


CASES = {
    "node_distances": _supers,
    "nodes_unreachable_from_all_supers": _supers,
    "per_super_node_distances": _supers,
    "multi_node_distances": _supers,
    "node_distances_from_closest_super": _with_source,
    "nodes_not_connected_to_super": _with_source,
    "discover_nodes_to_promote": _supers,
    "group_nodes_by_vectors": _with_source,
}


@pytest.mark.parametrize("fn", sorted(CASES))
def test_matches_jax(pair, fn):
    for got, want in _both(pair, fn, CASES[fn]):
        _assert_same(got, want)


def test_cut_graph_has_what_it_should(cut_graph):
    """The cut graph exercises each branch the parity cases must cover."""
    bottom = cut_graph.layers[-1]
    nb = bottom.neighbors.numpy()
    assert (nb == EMPTY_ID).any() and nb[7, 0] == nb[7, 1]
    supers = cut_graph.supers_for_layer(0)
    supers = supers[~np.isin(supers, [10, 11, 12])]
    hops, _ = analysis.node_distances(bottom, supers)
    assert set(np.nonzero(hops == INF)[0]) >= {10, 11, 12}
    sup_idx, top_h, _ = analysis.multi_node_distances(bottom, supers, k=5)
    assert (sup_idx == -1).any() and (top_h[sup_idx == -1] == INF).all()


@pytest.mark.parametrize("k", [1, 5])
def test_multi_node_distances_k_matches_jax(pair, k):
    for got, want in _both(pair, "multi_node_distances", lambda i, s, p: _supers(i, s, p) + (k,)):
        _assert_same(got, want)


def test_reachables_and_reverse_match_jax(pair):
    h, j, _ = pair
    for lft in range(h.layer_count):
        t_layer, j_layer = h.layers[lft], j.layers[lft]
        n = t_layer.node_count
        for node in sorted({0, n // 2, n - 1}):
            check = list(range(0, n, 2)) + [node]
            assert analysis.reachables_from(t_layer, node, check) == janalysis.reachables_from(
                j_layer, node, check)
            _assert_same(analysis.reverse_get_neighbors(t_layer, node),
                         janalysis.reverse_get_neighbors(j_layer, node))


def test_hnsw_methods_match_jax(pair):
    h, j, _ = pair
    for layer_id in range(h.layer_count):
        _assert_same(h.node_distances_for_layer(layer_id), j.node_distances_for_layer(layer_id))
        _assert_same(h.discover_nodes_to_promote(layer_id), j.discover_nodes_to_promote(layer_id))
    top = h.layer_count - 1
    check = list(range(h.layers[top].node_count))
    assert h.reachables_from_node_for_layer(top, 0, check) == j.reachables_from_node_for_layer(
        top, 0, check)


def test_chunks_do_not_change_per_super_distances(cut_graph):
    bottom = cut_graph.layers[-1]
    supers = cut_graph.supers_for_layer(0)
    whole = analysis.per_super_node_distances(bottom, supers, chunk=64)
    for chunk in (1, 7):
        _assert_same(analysis.per_super_node_distances(bottom, supers, chunk=chunk), whole)


# -- an independent reference: scipy's shortest paths ---------------------------


@pytest.mark.parametrize("layer_id", [0, 1])
def test_node_distances_match_dijkstra(cut_graph, layer_id):
    """``chip_smoke.py``'s reference (scipy's Dijkstra, unit weights and then
    slot + 1, repeated edges kept at their smallest slot) on the cut graph."""
    from chip_smoke import dijkstra_reference

    layer = cut_graph.get_layer(layer_id)
    supers = cut_graph.supers_for_layer(layer_id)
    supers = supers[~np.isin(supers, [10, 11, 12])]
    hops, isum = analysis.node_distances(layer, supers)
    (want_h, want_s), _, repeated = dijkstra_reference(layer, supers)
    np.testing.assert_array_equal(hops, want_h)
    np.testing.assert_array_equal(isum, want_s)
    assert (repeated > 0) == (layer_id == 0)  # row 7's repeated neighbor
    if layer_id == 0:
        assert (hops == INF).sum() >= 3
