"""The hop loop replayed from a CUDA graph (``parallel_hnsw_tpu_torch.hop_graph``).

On the CPU: the capture rule as a pure function of device, source kind, rows
and hops run, the source kinds, the bounded cache and its dropping of graphs
whose tensors are freed, and the launch counters at capture and replay.  On
the card (marked ``cuda``): the replayed loop against the eager loop, bit for
bit, in ``search_stack`` at 100 and a few thousand rows, over hop slabs and in
the bottom-layer self-search; a replaced neighbor table captures anew, an
in-place edit of a cached one is seen, a memmap source or a block above
``MAX_GRAPH_ROWS`` rows stays eager, replayed hops count their kernel
launches, two threads searching at once answer as the eager loop, and a
dropped index frees its graphs.  The eager loop is reached through the
module's rule: ``should_capture`` patched to refuse everything.

This file imports no jax, so its card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_hop_graph.py
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric, hop_graph
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import Layer, MemmapSource, PqSource
from parallel_hnsw_tpu_torch.ops import cuda_gather, cuda_queues
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.search import LayerSearchState, search, search_stack
from parallel_hnsw_tpu_torch.utils.trace import TRACER

K = hop_graph.CAPTURE_AFTER_HOPS
ROWS = hop_graph.MAX_GRAPH_ROWS


@pytest.mark.parametrize("device_type, kind, rows, hops_run, captures", [
    ("cuda", "dense", 100, K, True),
    ("cuda", "slab", ROWS, K + 50, True),
    ("cuda", "dense", 1, K, True),
    ("cuda", "dense", 100, K - 1, False),  # a layer that may still converge soon
    ("cuda", "dense", ROWS + 1, K, False),  # past the block cap
    ("cuda", "dense", 0, K, False),
    ("cuda", "memmap", 100, K, False),  # rows gathered on the host
    ("cuda", "pq", 100, K, False),
    ("cuda", "other", 100, K, False),
    ("cpu", "dense", 100, K, False),
])
def test_capture_rule(device_type, kind, rows, hops_run, captures):
    assert hop_graph.should_capture(device_type, kind, rows, hops_run) is captures


@pytest.mark.parametrize("device_type, kind, fuses", [
    ("cuda", "dense", True), ("cuda", "slab", True), ("cuda", "memmap", False),
    ("cuda", "pq", False), ("cuda", "other", False), ("cpu", "dense", False),
    ("cpu", "slab", False),
])
def test_fuse_rule(device_type, kind, fuses):
    """The two-launch hop: a dense source or a hop slab on the card; every
    hop the graph captures is one."""
    assert hop_graph.fuses(device_type, kind) is fuses
    assert not hop_graph.should_capture(device_type, kind, 100, K) or fuses


def test_source_kinds():
    vecs = torch.zeros(4, 2)
    assert hop_graph.source_kind(DenseSource(vecs), None) == "dense"
    assert hop_graph.source_kind(DenseSource(vecs), torch.zeros(4, 3, 2)) == "slab"
    assert hop_graph.source_kind(MemmapSource(np.zeros((4, 2), np.float32)), None) == "memmap"
    assert hop_graph.source_kind(PqSource(torch.zeros(4, 1, dtype=torch.int32), vecs), None) == "pq"
    assert hop_graph.source_kind(object(), None) == "other"


def test_graph_key_is_none_off_the_card():
    layer = Layer(torch.arange(4, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32))
    assert hop_graph.graph_key(layer, DenseSource(torch.zeros(4, 2)), None, torch.zeros(3, 2),
                               8, 4, Metric.EUCLIDEAN, 2) is None


class _Captured:
    """Stands in for a captured graph: records the pool it was given."""

    def __init__(self, name, device="cpu"):
        self.name = name
        self.pools = []
        self.queries = torch.zeros(1, device=device)

    def capture(self, pool):
        self.pools.append(pool)
        self.graph = self

    def pool(self):
        return ("pool", self.name)


def test_cache_keeps_the_most_recently_used():
    cache = hop_graph.HopGraphCache(capacity=2)
    a, b, c = _Captured("a"), _Captured("b"), _Captured("c")
    cache.add("a", a)
    cache.add("b", b)
    assert cache.get("a") is a  # "b" is now the least recently used
    cache.add("c", c)
    assert len(cache) == 2 and cache.get("b") is None
    assert cache.get("a") is a and cache.get("c") is c
    # every graph after the first captures into the first one's pool
    assert a.pools == [None] and b.pools == c.pools == [("pool", "a")]
    cache.clear()
    assert len(cache) == 0 and cache.get("a") is None
    # a pool lasts while a graph holds it: not past a clear, nor past the
    # eviction of its device's last graph
    d, e, f = _Captured("d"), _Captured("e", "meta"), _Captured("f", "meta")
    cache.add("d", d)
    cache.add("e", e)
    cache.add("f", f)
    assert d.pools == [None] and e.pools == [None] and f.pools == [("pool", "e")]
    g = _Captured("g")
    cache.add("g", g)
    assert g.pools == [None]


def test_cache_drops_a_graph_whose_tensors_are_freed():
    cache = hop_graph.HopGraphCache(capacity=1)
    nodes, table = torch.zeros(4), torch.zeros(4, 2)
    a = _Captured("a")
    cache.add("k", a, watch=(nodes, table))
    assert cache.get("k") is a
    del table
    gc.collect()
    assert cache.get("k") is None and len(cache) == 0
    # the pool went with the device's last graph
    b = _Captured("b")
    cache.add("k", b, watch=(nodes,))
    assert b.pools == [None]
    # an evicted graph no longer watches its tensors: their end drops no
    # later graph under the same key
    c, d = _Captured("c"), _Captured("d")
    other = torch.zeros(3)
    cache.add("j", c, watch=(other,))
    assert cache.get("k") is None
    cache.add("k", d)
    del nodes
    gc.collect()
    assert cache.get("k") is d
    del other
    gc.collect()
    assert cache.get("k") is d


class _CpuGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: captures and
    replays nothing."""

    def capture_begin(self, **kwargs):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass

    def pool(self):
        return None


def _cpu_state(q: int = 2, cap: int = 4) -> LayerSearchState:
    """A layer search's state on the CPU, at hop 3."""
    return LayerSearchState(torch.zeros(q, cap, dtype=torch.int32), torch.zeros(q, cap),
                            torch.zeros(q, cap, dtype=torch.int32), torch.ones(q, dtype=torch.int32),
                            torch.zeros(q, dtype=torch.bool), 3, torch.zeros((), dtype=torch.int64),
                            torch.zeros(q, dtype=torch.int32), torch.zeros(q, 2, dtype=torch.int64),
                            torch.zeros(q, 2, dtype=torch.bool))


def test_a_capture_counts_no_launch_and_each_replay_its_own(monkeypatch):
    """The launch counters count launches on the card: none at capture, the
    capture's at each replay; the graph keeps no hop that read the layer's
    tensors; the body is handed the graph's ``all_done`` flag and advances
    the buffers in place."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CpuGraph)
    flags = []

    def make_body(all_done):
        flags.append(all_done)

        def body(state):
            cuda_gather.LAUNCHES["hop_expand"] += 1
            cuda_gather.LAUNCHES["gather_distance"] += 2
            all_done.fill_(True)
            state.hops.add_(1)
            return state
        return body

    q, state = 2, _cpu_state()
    graph = hop_graph.HopGraph(make_body, state, torch.zeros(q, 5))
    graph.load(state, torch.ones(q, 5))
    assert not bool(graph.all_done)
    before = dict(cuda_gather.LAUNCHES)
    graph.capture(None)
    assert cuda_gather.LAUNCHES == before
    assert graph.launches[-1] == {"hop_expand": 1, "gather_distance": 2}
    assert graph._body is None and graph._make_body is None
    assert len(flags) == 1 and flags[0] is graph.all_done
    for _ in range(3):
        graph.replay()
    assert cuda_gather.LAUNCHES == {**before, "hop_expand": before["hop_expand"] + 3,
                                    "gather_distance": before["gather_distance"] + 6}
    # the capture ran the hop once on the CPU's stand-in: the counter moved
    assert int(graph.buffers.hops) == 4 and graph.state(9).hops == 9
    assert bool(graph.all_done)


def test_a_hop_that_returns_new_tensors_is_refused(monkeypatch):
    """A replay copies nothing, so a body that leaves a buffer as it was and
    returns its result in a new tensor cannot be captured."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CpuGraph)
    q, state = 2, _cpu_state()
    graph = hop_graph.HopGraph(
        lambda all_done: lambda s: s._replace(hops=s.hops + 1), state, torch.zeros(q, 5))
    graph.load(state, torch.ones(q, 5))
    with pytest.raises(RuntimeError, match="in place"):
        graph.capture(None)
    assert int(graph.buffers.hops) == 3


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def card_index():
    """20,000 x 32 unit rows on the card: a bottom layer whose searches at
    ef 300 run far past ``CAPTURE_AFTER_HOPS`` hops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(24_000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    vecs = torch.from_numpy(x).to("cuda:0")
    hnsw = Hnsw.generate(DenseSource(vecs[:20_000]), metric=Metric.NORMALIZED_COSINE, seed=3,
                         improve=False)
    return hnsw, vecs[20_000:]


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty cache of graphs for the test, dropped after it."""
    cache = hop_graph.HopGraphCache()
    monkeypatch.setattr(hop_graph, "HOP_GRAPHS", cache)
    yield cache
    cache.clear()


def _eager(monkeypatch, fn):
    """``fn()`` with the capture rule refusing every hop: the eager loop."""
    with monkeypatch.context() as m:
        m.setattr(hop_graph, "should_capture", lambda device_type, kind, rows, hops_run: False)
        return fn()


def _traced(fn):
    """``fn()`` and the (hops, graph_hops, captures) of its layer searches."""
    TRACER.enabled = True
    TRACER.events.clear()
    try:
        out = fn()
        torch.cuda.synchronize()
        spans = [(int(e.counters["hops"]), int(e.counters["graph_hops"]), int(e.counters["captures"]))
                 for e in TRACER.events if e.name == "search_layer"]
    finally:
        TRACER.enabled = False
        TRACER.events.clear()
    return out, spans


def _assert_same(got, want):
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g == w


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 3000])
def test_replayed_stack_equals_eager(device, card_index, fresh_graphs, monkeypatch, rows):
    """ids, dists, hops, evaluations and improvement hops of ``search_stack``,
    replayed against eager, on the first call (which captures) and on a
    second (which replays from the first hop)."""
    hnsw, queries = card_index
    q = torch.cat([queries] * (rows // queries.shape[0] + 1))[:rows]
    sp = SearchParams()

    def run():
        return search_stack(hnsw.layers, hnsw.source, hnsw.metric, q, sp)

    want, eager_spans = _traced(lambda: _eager(monkeypatch, run))
    assert all(g == c == 0 for _, g, c in eager_spans)
    first, spans = _traced(run)
    _assert_same(first, want)
    assert [h for h, _, _ in spans] == [h for h, _, _ in eager_spans]
    assert sum(c for _, _, c in spans) >= 1 and sum(g for _, g, _ in spans) > 0
    again, spans = _traced(run)
    _assert_same(again, want)
    assert sum(c for _, _, c in spans) == 0
    # a layer that replays, replays every hop
    assert any(h == g > 0 for h, g, _ in spans)


@pytest.mark.cuda
def test_replayed_layer_state_equals_eager(device, card_index, fresh_graphs, monkeypatch):
    """Every field of the bottom layer's final state, eager and replayed:
    ids, dists, expanded, probes, done, hops, evals and improve_hop."""
    from parallel_hnsw_tpu_torch.search import _entry_seed, _enter_layer, search_one_layer

    hnsw, queries = card_index
    layer = hnsw.layers[-1]
    init = _enter_layer(layer, *_entry_seed(hnsw.layers, hnsw.source, hnsw.metric, queries, 300))

    def run():
        return search_one_layer(layer, hnsw.source, hnsw.metric, queries, *init,
                                probe_depth=2, beam_width=4, max_hops=0)

    want = _eager(monkeypatch, run)
    for _ in range(2):
        got, spans = _traced(run)
        assert want.hops > K and spans[0][1] > 0
        _assert_same(got, want)


@pytest.mark.cuda
def test_replayed_slabs_and_self_search_equal_eager(device, card_index, fresh_graphs, monkeypatch):
    hnsw, queries = card_index
    hnsw.enable_hop_slabs()
    try:
        want = _eager(monkeypatch, lambda: hnsw.search(queries))
        got, spans = _traced(lambda: hnsw.search(queries))
        _assert_same(got, want)
        assert sum(c for _, _, c in spans) >= 1
    finally:
        hnsw.disable_hop_slabs()
    idx = torch.arange(0, 2000, device=device)
    sp = SearchParams(number_of_candidates=90, upper_layer_candidate_count=90, probe_depth=2)

    def self_search():  # as ``Hnsw.knn(30)`` runs a block
        return hnsw._bottom_layer_self_search_idx(idx, 90, sp)

    want = _eager(monkeypatch, self_search)
    got, spans = _traced(self_search)
    _assert_same(got, want)
    assert spans[0][1] > 0


@pytest.mark.cuda
def test_replaced_neighbors_capture_anew_and_edits_are_seen(device, card_index, fresh_graphs,
                                                            monkeypatch):
    hnsw, queries = card_index
    sp = SearchParams()
    layers = list(hnsw.layers)
    first, spans = _traced(lambda: search_stack(layers, hnsw.source, hnsw.metric, queries, sp))
    assert spans[-1][2] == 1
    # the same values in a new tensor are a new key: captured again
    layers[-1] = Layer(layers[-1].nodes, layers[-1].neighbors.clone())
    again, spans = _traced(lambda: search_stack(layers, hnsw.source, hnsw.metric, queries, sp))
    assert spans[-1][2] == 1
    _assert_same(again, first)
    # an edit in place of the cached table: replayed (no capture), and the
    # replay reads the edited rows, as the eager loop does
    layers[-1].neighbors[:, 24:] = EMPTY_ID
    edited, spans = _traced(lambda: search_stack(layers, hnsw.source, hnsw.metric, queries, sp))
    assert spans[-1][2] == 0 and spans[-1][1] > 0
    want = _eager(monkeypatch, lambda: search_stack(layers, hnsw.source, hnsw.metric, queries, sp))
    _assert_same(edited, want)
    assert not torch.equal(edited[0], first[0])


@pytest.mark.cuda
def test_memmap_sources_and_large_blocks_stay_eager(device, card_index, fresh_graphs):
    hnsw, queries = card_index
    sp = SearchParams()
    host = MemmapSource(hnsw.source.vectors.cpu().numpy())
    _, spans = _traced(lambda: search(hnsw.layers, host, hnsw.metric, queries, sp))
    assert spans and max(h for h, _, _ in spans) > K
    assert all(c == g == 0 for _, g, c in spans)
    rows = ROWS + 8
    q = torch.cat([queries] * (rows // queries.shape[0] + 1))[:rows]
    _, spans = _traced(lambda: search(hnsw.layers, hnsw.source, hnsw.metric, q, sp, query_block=rows))
    assert spans and max(h for h, _, _ in spans) > K
    assert all(c == g == 0 for _, g, c in spans)
    assert len(fresh_graphs) == 0


@pytest.mark.cuda
def test_replayed_hops_count_their_launches(device, card_index, fresh_graphs):
    """The hop's expand kernel once a hop, replayed hops included, and
    ``row_gather`` once for the entry vector: the hop runs neither
    ``gather_distance`` nor ``row_gather``."""
    hnsw, queries = card_index
    q = queries[:100]
    for call in range(2):  # the first captures, the second replays from the first hop
        before = dict(cuda_gather.LAUNCHES)
        _, spans = _traced(lambda: search_stack(hnsw.layers, hnsw.source, hnsw.metric, q,
                                                SearchParams()))
        ran = {k: cuda_gather.LAUNCHES[k] - before[k] for k in before}
        hops = sum(h for h, _, _ in spans)
        captures = sum(c for _, _, c in spans)
        assert sum(g for _, g, _ in spans) > 0 and (captures > 0 if call == 0 else captures == 0)
        assert ran == {"gather_distance": 0, "row_gather": 1, "hop_expand": hops}


@pytest.mark.cuda
def test_every_hop_runs_the_merge_kernel(device, card_index, fresh_graphs):
    """One ``queue_merge`` launch a hop, eager or replayed, and the spans'
    ``merge_kernel_hops`` count them."""
    hnsw, queries = card_index
    for _ in range(2):  # the first captures, the second replays from the first hop
        before = cuda_queues.LAUNCHES["queue_merge"]
        TRACER.enabled = True
        TRACER.events.clear()
        try:
            search_stack(hnsw.layers, hnsw.source, hnsw.metric, queries[:300], SearchParams())
            torch.cuda.synchronize()
            spans = [e.counters for e in TRACER.events if e.name == "search_layer"]
        finally:
            TRACER.enabled = False
            TRACER.events.clear()
        hops = sum(c["hops"] for c in spans)
        assert hops > 0 and sum(c["graph_hops"] for c in spans) > 0
        assert [c["merge_kernel_hops"] for c in spans] == [c["hops"] for c in spans]
        assert cuda_queues.LAUNCHES["queue_merge"] - before == hops


@pytest.mark.cuda
def test_layer_search_equals_the_plain_update_on_the_card(device, card_index, fresh_graphs,
                                                          monkeypatch):
    """Every field of the bottom layer's final state, with the hop as its
    two kernels (eager, and replayed) and as the torch hop whose queue
    update is the plain version, on the same CUDA tensors."""
    from parallel_hnsw_tpu_torch import search as search_module
    from parallel_hnsw_tpu_torch.search import _entry_seed, _enter_layer, search_one_layer

    hnsw, queries = card_index
    layer = hnsw.layers[-1]
    init = _enter_layer(layer, *_entry_seed(hnsw.layers, hnsw.source, hnsw.metric, queries, 300))

    def run():
        return search_one_layer(layer, hnsw.source, hnsw.metric, queries, *init,
                                probe_depth=2, beam_width=4, max_hops=0)

    with monkeypatch.context() as m:
        m.setattr(search_module, "queue_update", cuda_queues.plain_queue_update)
        m.setattr(hop_graph, "fuses", lambda device_type, kind: False)
        before = cuda_queues.LAUNCHES["queue_merge"]
        want = _eager(monkeypatch, run)
        assert cuda_queues.LAUNCHES["queue_merge"] == before
    assert want.hops > K
    _assert_same(_eager(monkeypatch, run), want)
    got, spans = _traced(run)
    assert spans[0][1] > 0
    _assert_same(got, want)


@pytest.mark.cuda
def test_concurrent_searches_answer_as_alone(device, card_index, fresh_graphs, monkeypatch):
    """Two threads, each on a stream of its own, search one index at once:
    every answer is the eager loop's, whichever thread held the graphs."""
    hnsw, queries = card_index
    sp = SearchParams()
    blocks = [queries[i * 100:(i + 1) * 100] for i in range(4)]

    def run(b):
        return search_stack(hnsw.layers, hnsw.source, hnsw.metric, b, sp)

    want = [_eager(monkeypatch, lambda b=b: run(b)) for b in blocks]
    got, errors = {}, []

    def worker(t):
        try:
            stream = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                for r in range(4):
                    for i, b in enumerate(blocks):
                        got[(t, r, i)] = run(b)
            stream.synchronize()
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert len(got) == 32 and len(fresh_graphs) > 0
    for (_, _, i), out in got.items():
        _assert_same(out, want[i])


@pytest.mark.cuda
def test_a_dropped_index_frees_its_graphs(device, fresh_graphs):
    """The cache holds no tensor a graph reads: deleting the index drops its
    graphs and frees its memory."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(20_100, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    vecs = torch.from_numpy(x).to(device)
    hnsw = Hnsw.generate(DenseSource(vecs[:20_000]), metric=Metric.NORMALIZED_COSINE, seed=4,
                         improve=False)
    q = vecs[20_000:]
    _, spans = _traced(lambda: hnsw.search(q))
    assert sum(c for _, _, c in spans) >= 1 and len(fresh_graphs) >= 1
    table = weakref.ref(hnsw.layers[-1].neighbors)
    held = torch.cuda.memory_allocated(device)
    del hnsw, vecs, q, _
    gc.collect()
    torch.cuda.synchronize()
    assert table() is None and len(fresh_graphs) == 0
    assert torch.cuda.memory_allocated(device) - base < (held - base) / 2
