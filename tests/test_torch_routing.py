"""The port's routing cache and hop slabs against the JAX package (mirrors
tests/test_routing.py and the dense cases of tests/test_hop_slabs.py).

The port builds 600 x 16 indexes (the shape of tests/test_hop_slabs.py) and
``convert`` hands JAX the stacks, so JAX compiles searches only.  JAX's
projection is handed to the port, so both packages hold the same cache.  Two
corpora: unit vectors under cosine, and small integers under squared
euclidean, where every f32 product and sum is exact, so the two packages
compute bit-identical distances and must walk the graph alike.  (On unit
vectors one ulp between einsum and matmul can flip a near-tie, or re-open a
node whose re-computed distance came out an ulp smaller, and the walks part
in the tail of the queue.)  The recall contracts on the low-rank corpus run
in the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import routing as jr
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource, Layer as JLayer
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import build_params_from_dict as j_build_params_from_dict
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    SearchParams,
    brute_force_knn,
)
from parallel_hnsw_tpu_torch import routing as tr
from parallel_hnsw_tpu_torch import search as tsearch
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_to_numpy, routing_from_numpy, routing_to_numpy
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance
from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)
N, DIM, Q = 600, 16, 64


def _both_packages(th):
    layers, vectors, metric, bp_dict = hnsw_to_numpy(th)
    jh = JHnsw(
        [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in layers],
        JDenseSource(vectors=jnp.asarray(vectors)), metric, j_build_params_from_dict(bp_dict),
    )
    return th, jh, vectors[:Q]


@pytest.fixture(scope="module")
def pair():
    """One cosine index over unit vectors as both packages' objects, and 64
    corpus rows as queries."""
    source = random_unit_corpus(N, DIM, seed=5, device="cpu")
    return _both_packages(Hnsw.generate(source, None, BP, Metric.COSINE, seed=0))


@pytest.fixture(scope="module")
def exact_pair():
    """The same for integer coordinates in [-4, 4] under squared euclidean:
    every distance is an exact f32 integer in both packages (and in bf16
    rows), so ids, distances and counters must agree exactly."""
    grid = np.random.default_rng(6).integers(-4, 5, size=(N, DIM)).astype(np.float32)
    source = DenseSource(vectors=torch.from_numpy(grid))
    return _both_packages(
        Hnsw.generate(source, None, BP, Metric.SQUARED_EUCLIDEAN, seed=0, improve=False))


def _share_cache(th, jh, dr, seed=1):
    """JAX builds a cache; the port gets the same one through ``convert``."""
    jh.enable_routing(dr=dr, seed=seed)
    c = jh._routing
    th._routing = routing_from_numpy(
        None if c.projection is None else np.asarray(c.projection),
        np.asarray(c.rows).view(np.uint16), c.metric.value, "cpu",
    )


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _recall_at(ids, gt, k):
    return float((ids[:, :k, None] == gt[:, None, :k]).any(-1).float().mean())


# -- mirrors of tests/test_routing.py -------------------------------------------


def test_random_orthonormal_is_orthonormal():
    p = tr.random_orthonormal(64, 16, seed=3).numpy()
    np.testing.assert_allclose(p.T @ p, np.eye(16), atol=1e-5)
    assert torch.equal(tr.random_orthonormal(64, 16, seed=3), torch.from_numpy(p))
    assert not torch.equal(tr.random_orthonormal(64, 16, seed=4), torch.from_numpy(p))
    with pytest.raises(ValueError):
        tr.random_orthonormal(8, 16)


def test_route_metric_mapping():
    assert tr.route_metric(Metric.EUCLIDEAN) is Metric.SQUARED_EUCLIDEAN
    assert tr.route_metric(Metric.COSINE) is Metric.COSINE
    assert tr.route_metric(Metric.DOT) is Metric.DOT
    for m in Metric:
        assert tr.route_metric(m).value == jr.route_metric(m.value).value


def test_build_routing_shapes_and_norms():
    src = random_unit_corpus(300, 64, seed=0, device="cpu")
    cache = tr.build_routing(src, Metric.COSINE, dr=16, seed=1, block=128)
    assert cache.rows.shape == (300, 16) and cache.rows.dtype == torch.bfloat16
    assert cache.projection.shape == (64, 16) and cache.metric is Metric.COSINE
    # cosine-family rows are re-normalized after projection
    norms = torch.linalg.vector_norm(cache.rows.float(), dim=-1).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=0.05)
    # the row blocks leave no seam
    whole = tr.build_routing(src, Metric.COSINE, dr=16, seed=1)
    assert torch.equal(whole.rows, cache.rows)
    # dr=None: cast-only cache at full width
    cast = tr.build_routing(src, Metric.COSINE, dr=None)
    assert cast.projection is None and cast.rows.shape == (300, 64)
    assert torch.equal(cast.rows, src.vectors.to(torch.bfloat16))


def test_exact_rerank_sorts_and_masks_empty():
    src = random_unit_corpus(100, 32, seed=9, device="cpu")
    queries = src.vectors[:4]
    ids = torch.tensor([[5, 17, EMPTY_ID, 3]] * 4, dtype=torch.int32)
    r_ids, r_d = tr.exact_rerank(src, Metric.COSINE, queries, ids)
    d = r_d.numpy()
    assert np.all(np.diff(d, axis=-1) >= -1e-7)  # ascending
    assert np.all(r_ids.numpy()[:, -1] == EMPTY_ID)  # EMPTY sinks to tail
    want = pairwise_distance(queries, src.vectors[[3, 5, 17]], Metric.COSINE).numpy()
    np.testing.assert_allclose(np.sort(d[:, :3], axis=-1), np.sort(want, axis=-1), atol=1e-5)
    # query blocks give the same answer; a source of no known kind raises
    # (a host source is taken: tests/test_torch_outofcore.py)
    b_ids, b_d = tr.exact_rerank(src, Metric.COSINE, queries, ids, block_budget=1)
    assert torch.equal(b_ids, r_ids) and torch.equal(b_d, r_d)
    with pytest.raises(TypeError, match="unknown source type"):
        tr.exact_rerank(object(), Metric.COSINE, queries, ids)


def test_route_queries_matches_row_transform():
    src = random_unit_corpus(200, 64, seed=1, device="cpu")
    cache = tr.build_routing(src, Metric.COSINE, dr=16, seed=4)
    rq = tr.route_queries(cache, src.vectors[:8], Metric.COSINE).numpy()
    # same transform applied to identical inputs (up to bf16 row rounding)
    np.testing.assert_allclose(rq, cache.rows[:8].float().numpy(), atol=0.01)


def lowrank_unit_corpus(count, dim, rank=48, centers=24, seed=0, noise=0.02):
    """Clustered vectors on a low-rank subspace of a high ambient dimension,
    as in tests/test_routing.py."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(dim, rank)))
    c = rng.normal(size=(centers, rank))
    z = c[rng.integers(0, centers, count)] + 0.25 * rng.normal(size=(count, rank))
    pts = z @ basis.T + noise * rng.normal(size=(count, dim))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    return DenseSource(vectors=torch.from_numpy(pts.astype(np.float32)))


def test_routed_search_recall_with_exact_rerank():
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.5))
    sp = SearchParams(number_of_candidates=48, upper_layer_candidate_count=48)
    src = lowrank_unit_corpus(1200, 256, rank=32, seed=5)
    hnsw = Hnsw.generate(src, None, bp, Metric.COSINE, seed=0)
    queries = src.vectors[:128]
    gt, _ = brute_force_knn(src, queries, Metric.COSINE, 10)

    base_ids, _ = hnsw.search(queries, sp)
    base_recall = _recall_at(base_ids, gt, 10)
    assert base_recall >= 0.95

    hnsw.enable_routing(dr=64, seed=0)
    r_ids, r_d = hnsw.search(queries, sp)
    # exact rerank restores full-precision distances for returned ids
    cand = src.vectors[torch.clamp(r_ids[:, :10], 0, 1199).long()]
    want = 1.0 - torch.einsum("qd,qkd->qk", queries, cand)
    np.testing.assert_allclose(r_d[:, :10].numpy(), want.numpy(), atol=1e-4)
    assert _recall_at(r_ids, gt, 10) >= 0.5
    wide = sp.replace(number_of_candidates=192, upper_layer_candidate_count=100)
    w_ids, _ = hnsw.search(queries, wide)
    assert _recall_at(w_ids, gt, 10) >= base_recall - 0.05
    # without the rerank the distances are the routed (approximate) ones
    a_ids, a_d = hnsw.search(queries, sp, rerank_routed=False)
    assert a_ids.shape == r_ids.shape and not torch.equal(a_d, r_d)
    # self-queries: the zero-distance match survives any projection
    s_ids, _ = hnsw.search(src.vectors[:64], sp)
    assert float((s_ids[:, 0] == torch.arange(64)).float().mean()) == 1.0

    # cast-only (bf16, no projection) routing should match unrouted closely
    hnsw.enable_routing(dr=None)
    c_ids, _ = hnsw.search(queries, sp)
    assert _recall_at(c_ids, gt, 10) >= base_recall - 0.02

    # routed=False forces the exact traversal path even with a cache built
    f_ids, _ = hnsw.search(queries, sp, routed=False)
    assert torch.equal(f_ids, base_ids)
    hnsw.disable_routing()
    assert hnsw._routing is None and torch.equal(hnsw.search(queries, sp)[0], base_ids)


def test_routed_search_euclidean():
    rng = np.random.default_rng(11)
    basis, _ = np.linalg.qr(rng.normal(size=(48, 12)))
    c = rng.normal(size=(20, 12)) * 3.0
    z = c[rng.integers(0, 20, 1000)] + rng.normal(size=(1000, 12))
    vecs = torch.from_numpy((z @ basis.T).astype(np.float32))
    src = DenseSource(vectors=vecs)
    bp = BuildParams(optimization=OptimizationParams(recall_proportion=0.5))
    sp = SearchParams(number_of_candidates=48, upper_layer_candidate_count=48)
    hnsw = Hnsw.generate(src, None, bp, Metric.EUCLIDEAN, seed=0)
    queries = vecs[:96]
    gt, _ = brute_force_knn(src, queries, Metric.EUCLIDEAN, 10)
    hnsw.enable_routing(dr=24, seed=2)
    assert hnsw._routing.metric is Metric.SQUARED_EUCLIDEAN
    ids, dists = hnsw.search(queries, sp)
    assert _recall_at(ids, gt, 10) >= 0.9
    # reranked distances are true euclidean (not the routed squared form)
    top = vecs[torch.clamp(ids[:, 0], 0, 999).long()]
    want = torch.linalg.vector_norm(queries - top, dim=-1)
    np.testing.assert_allclose(dists[:, 0].numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# -- the port against JAX on one graph ------------------------------------------


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dr", [8, None], ids=["dr8", "cast"])
def test_build_routing_rows_match_jax(pair, metric, dr):
    """With JAX's projection handed in, the rows are the same bf16 values
    except where the two f32 matmuls (another summation order) land on
    opposite sides of a rounding boundary: within one bf16 ulp, and at least
    99% of the bit patterns equal.  The cast-only rows are bit-identical."""
    th, jh, _ = pair
    want = jr.build_routing(jh.source, metric, dr=dr, seed=1)
    projection = None if dr is None else torch.from_numpy(np.array(want.projection))
    got = tr.build_routing(th.source, Metric(metric), dr=dr, projection=projection)
    assert got.metric.value == want.metric.value and got.rows.shape == want.rows.shape
    got_bits, want_bits = _bf16_bits(got.rows), np.asarray(want.rows).view(np.uint16)
    if dr is None:
        np.testing.assert_array_equal(got_bits, want_bits)
        return
    assert np.abs(got_bits.astype(np.int32) - want_bits.astype(np.int32)).max() <= 1
    assert (got_bits == want_bits).mean() >= 0.99
    # the port's own projection has the same shape and is orthonormal too
    own = tr.build_routing(th.source, Metric(metric), dr=dr, seed=1)
    assert own.projection.shape == projection.shape


def test_routing_cache_crosses_packages_both_ways(pair):
    th, jh, _ = pair
    _share_cache(th, jh, dr=8)
    projection, bits, metric = routing_to_numpy(th._routing)
    np.testing.assert_array_equal(bits, np.asarray(jh._routing.rows).view(np.uint16))
    np.testing.assert_array_equal(projection, np.asarray(jh._routing.projection))
    assert metric == jh._routing.metric.value
    back = routing_from_numpy(projection, bits, metric, "cpu")
    assert torch.equal(back.rows, th._routing.rows) and back.rows.dtype == torch.bfloat16
    th.disable_routing(), jh.disable_routing()


def test_route_queries_and_exact_rerank_match_jax(pair):
    th, jh, queries = pair
    _share_cache(th, jh, dr=8)
    want = np.asarray(jr.route_queries(jh._routing, jnp.asarray(queries), "cosine"))
    got = tr.route_queries(th._routing, torch.from_numpy(queries), Metric.COSINE)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    th.disable_routing(), jh.disable_routing()

    rng = np.random.default_rng(2)
    ids = rng.integers(0, N, size=(Q, 12)).astype(np.int32)
    ids[:, 5] = EMPTY_ID
    j_ids, j_d = jr.exact_rerank(jh.source, "cosine", jnp.asarray(queries), jnp.asarray(ids))
    t_ids, t_d = tr.exact_rerank(th.source, Metric.COSINE, torch.from_numpy(queries),
                                 torch.from_numpy(ids))
    # random candidates: no two of a row's distances lie within 1e-5
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_d.numpy()[:, :11], np.asarray(j_d)[:, :11], atol=1e-5)
    assert np.isinf(t_d.numpy()[:, 11]).all()


def _ids_equal_up_to_ties(t_ids, t_d, j_ids, j_d, tie=1e-6):
    """Equal ids, except where neighbouring distances tie within ``tie``."""
    differ = t_ids != j_ids
    if differ.any():
        np.testing.assert_allclose(t_d[differ], j_d[differ], atol=tie)
    return differ.mean()


@pytest.mark.parametrize("graph,dr", [("exact", None), ("cosine", 8)], ids=["exact-cast", "cosine-dr8"])
@pytest.mark.parametrize("slabs", [False, True], ids=["rows", "slabs"])
def test_routed_search_matches_jax_with_the_same_cache(pair, exact_pair, graph, dr, slabs):
    """Both packages route over one cache and rerank exactly.  Cast-only rows
    of the integer corpus: identical ids and distances.  Projected rows of
    the unit vectors: the same ids, except where reranked distances tie
    within 1e-6 (at most 1% of the slots); distances atol 1e-5."""
    th, jh, queries = exact_pair if graph == "exact" else pair
    _share_cache(th, jh, dr=dr)
    if slabs:
        th.enable_hop_slabs(), jh.enable_hop_slabs()
        assert th._hop_slabs.routed and jh._hop_slabs.routed
    try:
        j_ids, j_d = jh.search(jnp.asarray(queries))
        t_ids, t_d = th.search(torch.from_numpy(queries))
    finally:
        for h in (th, jh):
            h.disable_hop_slabs(), h.disable_routing()
    j_ids, j_d, t_ids, t_d = np.asarray(j_ids), np.asarray(j_d), t_ids.numpy(), t_d.numpy()
    if graph == "exact":
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_d, j_d)
        return
    assert (t_ids[:, 0] == np.arange(Q)).all()
    assert _ids_equal_up_to_ties(t_ids, t_d, j_ids, j_d) <= 0.01
    both = np.isfinite(j_d) & np.isfinite(t_d)
    np.testing.assert_allclose(t_d[both], j_d[both], atol=1e-5)


# -- hop slabs (mirrors of tests/test_hop_slabs.py, and against JAX) -------------


@pytest.mark.parametrize("graph", ["cosine", "exact"])
def test_slab_search_matches_plain_exactly(pair, exact_pair, graph):
    """Full-precision slabs are a pure memory-layout change: identical
    (ids, dists) to the per-candidate gather hop; the slab rows are JAX's on
    the unpadded part; on the integer corpus the ids are JAX's slab search's."""
    th, jh, queries = exact_pair if graph == "exact" else pair
    q = torch.from_numpy(queries)
    ids0, d0 = th.search(q)
    th.enable_hop_slabs(), jh.enable_hop_slabs()
    try:
        assert th._hop_slabs is not None and not th._hop_slabs.routed
        ids1, d1 = th.search(q)
        # JAX pads each layer to a node bucket; the port does not
        for ts, js, layer in zip(th._hop_slabs.slabs, jh._hop_slabs.slabs, th.layers):
            assert tuple(ts.shape) == (*layer.neighbors.shape, DIM)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[: layer.node_count])
        if graph == "exact":
            j_ids, j_d = jh.search(jnp.asarray(queries))
            np.testing.assert_array_equal(ids1.numpy(), np.asarray(j_ids))
            np.testing.assert_array_equal(d1.numpy(), np.asarray(j_d))
    finally:
        th.disable_hop_slabs(), jh.disable_hop_slabs()
    assert torch.equal(ids0, ids1)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), atol=0)


def test_routed_slab_rows_match_jax(pair):
    th, jh, _ = pair
    _share_cache(th, jh, dr=8)
    th.enable_hop_slabs(), jh.enable_hop_slabs()
    try:
        for ts, js, layer in zip(th._hop_slabs.slabs, jh._hop_slabs.slabs, th.layers):
            assert ts.dtype == torch.bfloat16 and tuple(ts.shape) == (*layer.neighbors.shape, 8)
            want = np.asarray(js)[: layer.node_count].view(np.uint16)
            np.testing.assert_array_equal(_bf16_bits(ts), want)
    finally:
        for h in (th, jh):
            h.disable_hop_slabs(), h.disable_routing()


def test_slab_over_routing_rows_keeps_recall(pair):
    """bf16 routed slabs + exact rerank: same contract as plain routing."""
    th, _, queries = pair
    q = torch.from_numpy(queries)
    gt, _ = th.search(q)
    th.enable_routing(dr=None)
    th.enable_hop_slabs()
    try:
        assert th._hop_slabs.routed
        ids, _ = th.search(q)
        # routed-space slabs cannot score raw queries: routed=False ignores them
        plain, _ = th.search(q, routed=False)
    finally:
        th.disable_hop_slabs(), th.disable_routing()
    assert _recall_at(ids, gt, 5) >= 0.95
    assert torch.equal(plain, gt)


@pytest.fixture(scope="module")
def small():
    source = random_unit_corpus(300, DIM, seed=5, device="cpu")
    return Hnsw.generate(source, None, BP, Metric.COSINE, seed=0)


@pytest.mark.parametrize("mutation", ["improve_neighbors", "improve_index", "promote_at_layer",
                                      "extend_layer"])
def test_mutation_invalidates_slabs(small, mutation):
    small.enable_hop_slabs()
    assert small._hop_slabs is not None
    if mutation == "promote_at_layer":
        small.promote_at_layer(small.layer_count - 1)
    elif mutation == "extend_layer":
        small.extend_layer(1, np.array([int(small.layers[-1].nodes[-1])]))
    else:
        getattr(small, mutation)()
    assert small._hop_slabs is None  # derived state dropped on graph change
    small.assert_invariants()


def test_slab_memory_budget_and_shape_are_enforced(small):
    with pytest.raises(ValueError, match="budget"):
        small.enable_hop_slabs(byte_budget=1024)
    # the budget counts the bytes as stored: N * M * D * 4 per layer
    need = sum(l.neighbors.numel() for l in small.layers) * DIM * 4
    small.enable_hop_slabs(byte_budget=need)
    with pytest.raises(ValueError, match="budget"):
        small.enable_hop_slabs(byte_budget=need - 1)
    # slabs of another graph are refused by the search itself
    stale = small._hop_slabs.slabs
    small.disable_hop_slabs()
    with pytest.raises(ValueError, match="rebuild the slabs"):
        tsearch.search(small.layers, small.source, small.metric, small.source.vectors[:4],
                       SearchParams(), slabs=[s[:-1] for s in stale])


def test_pq_code_graph_with_routed_slabs():
    """Slabs on the PQ code graph (mirrors
    tests/test_hop_slabs.py::test_pq_code_graph_with_routed_slabs): routing
    and slabs run over the densified codes, the rerank over the full
    vectors; top-1 agrees with the plain code-graph search.  ``exact_rerank``
    takes the PqSource itself and gives its densified copy's answers."""
    from parallel_hnsw_tpu_torch import PqBuildParams, PqSource, QuantizedHnsw

    source = random_unit_corpus(800, 32, seed=9, device="cpu")
    q = QuantizedHnsw.new(64, source, 8, Metric.COSINE, pqp=PqBuildParams(centroids=BP, hnsw=BP),
                          seed=0, exact_quantize=True)
    queries = source.vectors[:48]
    base_ids, _ = q.search(queries)
    q.enable_routing(dr=None)
    assert q.hnsw._routing.rows.shape == (800, 32)
    q.enable_hop_slabs()
    assert q.hnsw._hop_slabs.routed
    slab_ids, slab_d = q.search(queries)
    assert float((base_ids[:, 0] == slab_ids[:, 0]).float().mean()) >= 0.95
    pq_src = q.hnsw.source
    assert isinstance(pq_src, PqSource)
    on_codes = tr.exact_rerank(pq_src, Metric.COSINE, queries, slab_ids)
    on_dense = tr.exact_rerank(q.hnsw.compute_source, Metric.COSINE, queries, slab_ids)
    assert torch.equal(on_codes[0], on_dense[0]) and torch.equal(on_codes[1], on_dense[1])
