"""The port's beam search against the JAX package on one identical graph: a
small JAX-built index converted with ``hnsw_from_numpy``, the same queries
through both ``search`` functions.  The instrumented and host-driven searches
are held to JAX's on a corpus of small integers under squared euclidean,
where every f32 distance is exact in both packages, so ids, distances and
counters must agree exactly (on unit vectors one ulp between einsum and matmul
can flip a near-tie and the walks part in the tail of the queue)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu.graph import DenseSource as JaxSource
from parallel_hnsw_tpu.index import Hnsw as JaxHnsw
from parallel_hnsw_tpu.params import SearchParams as JaxSearchParams
from parallel_hnsw_tpu.params import params_to_dict
from parallel_hnsw_tpu.search import search as jax_search
from parallel_hnsw_tpu.search import search_host as jax_search_host
from parallel_hnsw_tpu.search import search_instrumented as jax_search_instrumented
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.convert import hnsw_from_numpy
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import (
    auto_query_block,
    search,
    search_host,
    search_instrumented,
    search_stack,
)

# one intra-op thread: the test process also runs XLA's CPU thread pool, and
# the two pools contend for the cores (30x slower searches at 8 threads each)
torch.set_num_threads(1)

N, DIM, Q = 600, 16, 96


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, (N + Q, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    corpus, queries = x[:N], x[N:]
    jh = JaxHnsw.generate(JaxSource(jnp.asarray(corpus)), metric="cosine", seed=2, improve=False)
    layers = [(np.asarray(l.nodes), np.asarray(l.neighbors)) for l in jh.layers]
    th = hnsw_from_numpy(layers, corpus, "cosine", params_to_dict(jh.build_parameters), "cpu")
    return jh, th, queries


def _both(graphs, queries, sp, exclude=None):
    jh, th, _ = graphs
    j_ids, j_d = jax_search(
        jh.layers, jh.source, jh.metric, jnp.asarray(queries), JaxSearchParams(**vars(sp)),
        exclude=None if exclude is None else jnp.asarray(exclude),
    )
    t_ids, t_d = search(
        th.layers, th.source, th.metric, torch.from_numpy(queries), sp,
        exclude=None if exclude is None else torch.from_numpy(exclude),
    )
    return np.asarray(j_ids), np.asarray(j_d), t_ids.numpy(), t_d.numpy()


def _assert_close(j_ids, j_d, t_ids, t_d, k=10):
    # ids shared per row: last-bit distance differences (einsum vs matmul)
    # can reorder near-ties or, rarely, steer one query down another path
    shared = np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(j_ids, t_ids)])
    assert shared >= 0.995, shared
    same = j_ids[:, :k] == t_ids[:, :k]
    np.testing.assert_allclose(t_d[:, :k][same], j_d[:, :k][same], atol=1e-5)


@pytest.mark.parametrize(
    "sp",
    [SearchParams(), SearchParams(number_of_candidates=24, upper_layer_candidate_count=6, beam_width=1)],
    ids=["default", "narrow"],
)
def test_search_matches_jax(graphs, sp):
    j_ids, j_d, t_ids, t_d = _both(graphs, graphs[2], sp)
    assert t_ids.dtype == np.int32 and t_ids.shape == j_ids.shape
    _assert_close(j_ids, j_d, t_ids, t_d)


def test_exclude_matches_jax(graphs):
    queries = np.asarray(graphs[1].source.vectors[:Q].numpy())  # corpus rows as queries
    exclude = np.arange(Q, dtype=np.int32)
    sp = SearchParams(number_of_candidates=32, upper_layer_candidate_count=8)
    j_ids, j_d, t_ids, t_d = _both(graphs, queries, sp, exclude)
    assert not (t_ids == exclude[:, None]).any()
    assert ((t_ids == EMPTY_ID) == (j_ids == EMPTY_ID)).mean() >= 0.995
    _assert_close(j_ids, j_d, t_ids, t_d)


def test_query_blocks_give_the_same_result(graphs):
    _, th, queries = graphs
    sp = SearchParams(number_of_candidates=32)
    q = torch.from_numpy(queries)
    whole = search(th.layers, th.source, th.metric, q, sp)
    blocked = search(th.layers, th.source, th.metric, q, sp, query_block=40)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
    assert auto_query_block(th.source, SearchParams(), 48) == 8192


# -- instrumented and host-driven searches, exact arithmetic --------------------

SP_EXACT = SearchParams(number_of_candidates=48, upper_layer_candidate_count=12)


@pytest.fixture(scope="module")
def exact_graphs(graphs):
    """The fixture's layers over integer coordinates in [-4, 4] under squared
    euclidean: any graph will do for a parity of walks, and JAX compiles
    nothing new for the build."""
    jh, th, _ = graphs
    grid = np.random.default_rng(23).integers(-4, 5, size=(N + Q, DIM)).astype(np.float32)
    layers = [(l.nodes.numpy(), l.neighbors.numpy()) for l in th.layers]
    te = hnsw_from_numpy(layers, grid[:N], "squared_euclidean",
                         params_to_dict(jh.build_parameters), "cpu")
    je = JaxHnsw(jh.layers, JaxSource(jnp.asarray(grid[:N])), "squared_euclidean",
                 jh.build_parameters)
    return je, te, grid[N:]


@pytest.mark.parametrize("excluded", [False, True], ids=["plain", "exclude"])
def test_search_instrumented_matches_jax(exact_graphs, excluded):
    je, te, queries = exact_graphs
    if excluded:
        queries = te.source.vectors[:Q].numpy()
    exclude = np.arange(Q, dtype=np.int32) if excluded else None
    j_ids, j_d, j_stats = jax_search_instrumented(
        je.layers, je.source, je.metric, jnp.asarray(queries), JaxSearchParams(**vars(SP_EXACT)),
        exclude=None if exclude is None else jnp.asarray(exclude),
    )
    t_ids, t_d, t_stats = search_instrumented(
        te.layers, te.source, te.metric, torch.from_numpy(queries), SP_EXACT,
        exclude=None if exclude is None else torch.from_numpy(exclude),
    )
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    assert t_stats["hops"] == j_stats["hops"] > 0
    assert t_stats["distance_evaluations"] == j_stats["distance_evaluations"] > 0
    assert t_stats["last_improvement_hop"].dtype == torch.int32
    np.testing.assert_array_equal(
        t_stats["last_improvement_hop"].numpy(), np.asarray(j_stats["last_improvement_hop"]))
    # the counters ride along: the plain search gives the same answer
    p_ids, p_d = search(te.layers, te.source, te.metric, torch.from_numpy(queries), SP_EXACT,
                        exclude=None if exclude is None else torch.from_numpy(exclude))
    assert torch.equal(p_ids, t_ids) and torch.equal(p_d, t_d)


def test_search_host_matches_search_stack_in_both_packages(exact_graphs):
    """16 queries: JAX's compacted batches always pad back to its smallest
    bucket, so it compiles one advance program per layer."""
    je, te, queries = exact_graphs
    queries = queries[:16]
    exclude = None
    jsp = JaxSearchParams(**vars(SP_EXACT))
    j_ids, j_d = jax_search_host(je.layers, je.source, je.metric, jnp.asarray(queries), jsp,
                                 chunk_hops=2)
    j_plain, _ = jax_search(je.layers, je.source, je.metric, jnp.asarray(queries), jsp)
    t_ids, t_d = search_host(te.layers, te.source, te.metric, torch.from_numpy(queries),
                             SP_EXACT, exclude, chunk_hops=2)
    s_ids, s_d = search_stack(te.layers, te.source, te.metric, torch.from_numpy(queries),
                              SP_EXACT)[:2]
    np.testing.assert_array_equal(np.asarray(j_ids), np.asarray(j_plain))
    assert torch.equal(t_ids, s_ids) and torch.equal(t_d, s_d)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("chunk_hops", [1, 3, 16])
def test_adaptive_search_equals_lockstep(exact_graphs, chunk_hops):
    """Retiring converged queries changes nothing, with or without
    ``exclude`` and across query blocks.  (Held on the exact corpus: a
    batched matmul may sum in another order when the batch shrinks, and on
    unit vectors that moves distances by an ulp.)"""
    _, th, queries = exact_graphs
    q = torch.from_numpy(queries)
    sp = SearchParams(number_of_candidates=40, upper_layer_candidate_count=10)
    want = search(th.layers, th.source, th.metric, q, sp)
    got = search_host(th.layers, th.source, th.metric, q, sp, chunk_hops=chunk_hops)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = th.source.vectors[:Q]
    exclude = torch.arange(Q, dtype=torch.int32)
    want = search(th.layers, th.source, th.metric, rows, sp, exclude=exclude)
    got = search(th.layers, th.source, th.metric, rows, sp, exclude=exclude, query_block=40,
                 adaptive=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not (got[0] == exclude[:, None]).any()


def test_search_stack_counters(graphs):
    _, th, queries = graphs
    q = torch.from_numpy(queries)
    sp = SearchParams(number_of_candidates=24, upper_layer_candidate_count=6)
    ids, dists, hops, evals, improve = search_stack(th.layers, th.source, th.metric, q, sp)
    assert isinstance(hops, int) and hops >= len(th.layers)
    assert evals.dtype == torch.int64 and evals.dim() == 0
    # every hop evaluates at most beam * M candidates per query
    max_m = max(l.neighborhood_size for l in th.layers)
    assert 0 < int(evals) <= hops * Q * sp.beam_width * max_m
    assert improve.shape == (Q,) and int(improve.min()) >= 0 and int(improve.max()) <= hops
    # an all-EMPTY start is done at once: no hop, no evaluation
    from parallel_hnsw_tpu_torch.ops.queues import empty_queue
    from parallel_hnsw_tpu_torch.search import search_one_layer

    state = search_one_layer(th.layers[-1], th.source, th.metric, q, *empty_queue(8, (Q,)),
                             probe_depth=2, beam_width=4, max_hops=0)
    assert state.hops == 0 and int(state.evals) == 0 and bool(state.done.all())


# -- the hop loop's spans -------------------------------------------------------


def _layer_spans(run):
    """``run()``'s result and the ``search_layer`` events it recorded."""
    from parallel_hnsw_tpu_torch.utils.trace import TRACER

    TRACER.enabled = True
    TRACER.events.clear()
    try:
        out = run()
        events = [e for e in TRACER.events if e.name == "search_layer"]
    finally:
        TRACER.enabled = False
        TRACER.events.clear()
    return out, events


def test_hnsw_search_is_the_same_with_the_tracer_on(exact_graphs):
    _, te, queries = exact_graphs
    q = torch.from_numpy(queries)
    off = te.search(q, SP_EXACT)
    on, events = _layer_spans(lambda: te.search(q, SP_EXACT))
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert len(events) == len(te.layers)


def test_layer_spans_count_the_hops_of_one_block(exact_graphs):
    """One block: one span a layer, top first, whose hops add up to
    ``search_instrumented``'s; the host's seconds fit inside each span."""
    _, te, queries = exact_graphs
    q = torch.from_numpy(queries)
    _, events = _layer_spans(lambda: search(te.layers, te.source, te.metric, q, SP_EXACT))
    stats = search_instrumented(te.layers, te.source, te.metric, q, SP_EXACT)[2]
    assert [e.counters["layer"] for e in events] == list(range(len(te.layers)))
    assert all(e.counters["queries"] == Q for e in events)
    assert sum(e.counters["hops"] for e in events) == stats["hops"] > 0
    for e in events:
        c = e.counters
        assert c["dispatch_s"] > 0 and c["wait_s"] > 0
        assert c["dispatch_s"] + c["wait_s"] <= e.seconds


def test_layer_spans_show_every_query_block(exact_graphs):
    _, te, queries = exact_graphs
    q = torch.from_numpy(queries)
    _, events = _layer_spans(lambda: te.search(q, SP_EXACT, query_block=64))
    n_layers = len(te.layers)
    assert len(events) == 2 * n_layers
    assert [e.counters["queries"] for e in events] == [64] * n_layers + [Q - 64] * n_layers
    for layer in range(n_layers):
        assert sum(e.counters["queries"] for e in events if e.counters["layer"] == layer) == Q


@pytest.mark.parametrize("chunk_hops", [2, 16])
def test_adaptive_layer_spans_count_the_lockstep_hops(exact_graphs, chunk_hops):
    """The compacting path is one span a layer over all its chunks; its
    queries retire early but the last one converges at the lockstep hop."""
    _, te, queries = exact_graphs
    q = torch.from_numpy(queries)
    want, lock = _layer_spans(lambda: search_stack(te.layers, te.source, te.metric, q, SP_EXACT))
    got, host = _layer_spans(lambda: search_host(te.layers, te.source, te.metric, q, SP_EXACT,
                                                 chunk_hops=chunk_hops))
    assert torch.equal(got[0], want[0])
    assert [e.counters["layer"] for e in host] == list(range(len(te.layers)))
    assert [e.counters["hops"] for e in host] == [e.counters["hops"] for e in lock]
    assert all(e.counters["dispatch_s"] + e.counters["wait_s"] <= e.seconds for e in host)
