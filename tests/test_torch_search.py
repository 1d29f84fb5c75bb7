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


@pytest.mark.parametrize("beam_width, max_hops", [(4, 0), (1, 0), (8, 0), (4, 3)])
def test_layer_state_with_the_carried_frontier_matches_jax(exact_graphs, beam_width, max_hops):
    """``search_one_layer`` on the bottom layer, each hop expanding the
    frontier the last merge carried: every field of JAX's final state (ids,
    distances, expanded flags, probes, done, hops, evaluations, improvement
    hops), and after 3 hops the carried frontier of the rows still searching
    is the one JAX's next hop picks by top-k."""
    from parallel_hnsw_tpu.search import search_one_layer as jax_search_one_layer
    from parallel_hnsw_tpu_torch.search import search_one_layer

    je, te, queries = exact_graphs
    cap, node = 48, 5
    start = ((queries - te.source.vectors[node].numpy()) ** 2).sum(-1).astype(np.float32)
    init_ids = np.full((Q, cap), EMPTY_ID, np.int32)
    init_d = np.full((Q, cap), np.inf, np.float32)
    init_ids[:, 0], init_d[:, 0] = node, start
    jl, tl = je.layers[-1], te.layers[-1]
    kw = dict(probe_depth=2, beam_width=beam_width, max_hops=max_hops)
    want = jax_search_one_layer(jl, je.source, je.metric, jnp.asarray(queries),
                                jnp.asarray(init_ids), jnp.asarray(init_d), **kw)
    got = search_one_layer(tl, te.source, te.metric, torch.from_numpy(queries),
                           torch.from_numpy(init_ids), torch.from_numpy(init_d), **kw)
    for field in ("ids", "dists", "expanded", "probes", "done", "improve_hop"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    assert got.hops == int(want.hops) > 0 and int(got.evals) == int(want.evals)
    searching = ~got.done
    if max_hops:
        assert bool(searching.any())
    b = min(beam_width, cap)
    rank = np.where((np.asarray(want.expanded) == 0) & (np.asarray(want.ids) != EMPTY_ID),
                    np.arange(cap), cap)
    picks = np.argsort(rank, axis=1, kind="stable")[:, :b]
    ok = np.take_along_axis(rank, picks, 1) < cap
    f, f_ok = got.frontier.numpy(), got.frontier_ok.numpy()
    for r in np.flatnonzero(searching.numpy()):
        np.testing.assert_array_equal(f_ok[r], ok[r])
        np.testing.assert_array_equal(f[r][f_ok[r]], picks[r][ok[r]])


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


def test_layer_spans_count_no_merge_kernel_hop_on_the_cpu(exact_graphs):
    """A CPU tensor's hops merge by the plain version and run as the torch
    hop: ``merge_kernel_hops`` and ``fused_hops`` are on every span, and 0."""
    _, te, queries = exact_graphs
    q = torch.from_numpy(queries)
    for adaptive in (False, True):
        _, events = _layer_spans(lambda: search(te.layers, te.source, te.metric, q, SP_EXACT,
                                                adaptive=adaptive))
        assert events and all(e.counters["merge_kernel_hops"] == e.counters["fused_hops"] == 0
                              for e in events)
        assert sum(e.counters["hops"] for e in events) > 0


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


# -- the replayed hop (hop_graph) on the CPU --------------------------------------


class _Replayer:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured hop."""

    def __init__(self, step):
        self.replay = step

    def pool(self):
        return None


def _expand_in_place(queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done,
                     evals, metric, counter=None, all_done=None):
    """``cuda_hop_expand``'s contract on the CPU, by its plain version:
    ``expanded`` and ``evals`` updated in place, the counter advanced, the
    flag set."""
    from parallel_hnsw_tpu_torch.ops.cuda_gather import plain_hop_expand

    flags, cand_ids, cand_dists, n = plain_hop_expand(
        queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done, evals, metric)
    expanded.copy_(flags)
    evals.copy_(n)
    if counter is not None:
        counter.add_(1)
    if all_done is not None:
        all_done.fill_(True)
    return expanded, cand_ids, cand_dists, evals


def _update_in_place(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok, probes,
                     improve_hop, hop, all_done=None):
    """``cuda_hop_update``'s contract on the CPU, by its plain version: the
    state updated in place, the flag cleared where a row is still going."""
    from parallel_hnsw_tpu_torch.ops.cuda_queues import plain_hop_update

    state = (ids, dists, flags, frontier, frontier_ok, probes, done, improve_hop)
    new = plain_hop_update(ids, dists, flags, cand_ids, cand_dists, done, frontier, frontier_ok,
                           probes, improve_hop, hop)
    for buf, value in zip(state, new):
        buf.copy_(value)
    if all_done is not None:
        all_done.logical_and_(done.all())
    return state


@pytest.fixture
def replayed(monkeypatch):
    """The graph path on the CPU: the two-launch hop, its kernels standing
    in by their plain versions updating in place, and the capture rule,
    both without their device check; a capture that keeps the hop
    (``HopGraph.step``, the function a CUDA graph captures) for each replay;
    and an empty cache for the test."""
    from parallel_hnsw_tpu_torch import hop_graph
    from parallel_hnsw_tpu_torch import search as search_module

    monkeypatch.setattr(hop_graph, "fuses", lambda device_type, kind: kind in hop_graph.GRAPH_KINDS)
    monkeypatch.setattr(search_module, "cuda_hop_expand", _expand_in_place)
    monkeypatch.setattr(search_module, "cuda_hop_update", _update_in_place)
    monkeypatch.setattr(hop_graph, "should_capture", lambda device_type, kind, rows, hops_run: (
        kind in hop_graph.GRAPH_KINDS and 0 < rows <= hop_graph.MAX_GRAPH_ROWS
        and hops_run >= hop_graph.CAPTURE_AFTER_HOPS))
    monkeypatch.setattr(hop_graph.HopGraph, "capture",
                        lambda self, pool: setattr(self, "graph", _Replayer(self.step)))
    cache = hop_graph.HopGraphCache()
    monkeypatch.setattr(hop_graph, "HOP_GRAPHS", cache)
    yield cache
    cache.clear()


@pytest.mark.parametrize("excluded", [False, True], ids=["plain", "exclude"])
def test_replayed_hops_match_jax(exact_graphs, replayed, excluded):
    """The device hop counter's improvement hops, the evaluations, hops, ids
    and distances of the in-place hop against the JAX package, on a first
    call that captures and a second that replays from the first hop."""
    je, te, queries = exact_graphs
    if excluded:
        queries = te.source.vectors[:Q].numpy()
    exclude = np.arange(Q, dtype=np.int32) if excluded else None
    j_ids, j_d, j_stats = jax_search_instrumented(
        je.layers, je.source, je.metric, jnp.asarray(queries), JaxSearchParams(**vars(SP_EXACT)),
        exclude=None if exclude is None else jnp.asarray(exclude),
    )
    for call in range(2):
        (t_ids, t_d, t_stats), events = _layer_spans(lambda: search_instrumented(
            te.layers, te.source, te.metric, torch.from_numpy(queries), SP_EXACT,
            exclude=None if exclude is None else torch.from_numpy(exclude)))
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        assert t_stats["hops"] == j_stats["hops"]
        assert t_stats["distance_evaluations"] == j_stats["distance_evaluations"]
        assert t_stats["last_improvement_hop"].dtype == torch.int32
        np.testing.assert_array_equal(
            t_stats["last_improvement_hop"].numpy(), np.asarray(j_stats["last_improvement_hop"]))
        captures = sum(e.counters["captures"] for e in events)
        assert captures == (1 if call == 0 else 0)
        bottom = events[-1].counters
        assert bottom["graph_hops"] > 0
        if call:
            assert bottom["graph_hops"] == bottom["hops"]


def test_replayed_search_equals_eager(graphs, replayed, monkeypatch):
    """Unit vectors in two query blocks: the replayed and the eager loop give
    the same answer; one graph a block size, found again by the next call;
    a replaced neighbor table is a new key, an in-place edit is seen."""
    from parallel_hnsw_tpu_torch import hop_graph

    _, th, queries = graphs
    q = torch.from_numpy(queries)
    sp = SearchParams()
    layers = list(th.layers)

    def run():
        return _layer_spans(lambda: search(layers, th.source, th.metric, q, sp, query_block=64))

    def eager():
        with monkeypatch.context() as m:
            m.setattr(hop_graph, "should_capture", lambda device_type, kind, rows, hops_run: False)
            return run()

    want, events = eager()
    assert all(e.counters["graph_hops"] == e.counters["captures"] == 0 for e in events)
    for call in range(2):
        got, events = run()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert sum(e.counters["captures"] for e in events) == (2 if call == 0 else 0)
    assert len(replayed) == 2
    layers[-1] = layers[-1]._replace(neighbors=layers[-1].neighbors.clone())
    got, events = run()
    assert torch.equal(got[0], want[0]) and sum(e.counters["captures"] for e in events) == 2
    layers[-1].neighbors[:, 8:] = EMPTY_ID
    want, _ = eager()
    got, events = run()
    assert sum(e.counters["captures"] for e in events) == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_search_finding_the_graphs_in_use_runs_eagerly(graphs, replayed):
    """While another search holds the device's graphs, a search runs every
    hop eagerly, with the same answer."""
    _, th, queries = graphs
    q = torch.from_numpy(queries)

    def run():
        return _layer_spans(lambda: search(th.layers, th.source, th.metric, q, SearchParams(),
                                           query_block=64))

    want, events = run()
    assert sum(e.counters["captures"] for e in events) == 2
    with replayed.lock(q.device):
        got, events = run()
    assert all(e.counters["graph_hops"] == e.counters["captures"] == 0 for e in events)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got, events = run()
    assert sum(e.counters["graph_hops"] for e in events) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
