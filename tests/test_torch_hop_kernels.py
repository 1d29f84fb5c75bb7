"""The hop in two launches: ``cuda_gather.cuda_hop_expand`` (frontier,
neighbor rows and distances) and ``cuda_queues.cuda_hop_update`` (the merge,
the next frontier and the termination accounting), which ``search.py`` runs
on the card over a dense source or a hop slab in place of the torch hop.

On the CPU: the plain versions, ``plain_hop_expand`` and
``plain_hop_update``, against the torch hop's pieces (its candidates as its
queue update receives them, ``evals``, the queues, the frontier and the
termination fields) after each of several hops, in normalized cosine,
euclidean and dot, over f32 rows, bf16 rows and a hop slab, with rows that
are done, neighbor rows holding ``EMPTY_ID`` and frontiers with invalid
slots; the hop number as a device counter; the input checks.  On the card
(marked ``cuda``): the two-launch hop against the torch hop on the same CUDA
tensors, field by field and bit for bit, after each of several hops, eager
and replayed from a CUDA graph, at 100 and 8,192 rows; the kernels against
their plain versions; a hop that is two device kernels and copies nothing;
one expand and one merge launch a hop in a dense search.

This file imports no jax, so its card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_hop_kernels.py
"""

import pytest
import torch

from parallel_hnsw_tpu_torch import DenseSource, Metric, hop_graph
from parallel_hnsw_tpu_torch import search as search_module
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import Layer, node_to_vec, source_distance
from parallel_hnsw_tpu_torch.ops import cuda_gather, cuda_queues
from parallel_hnsw_tpu_torch.ops.cuda_gather import plain_hop_expand
from parallel_hnsw_tpu_torch.ops.cuda_queues import plain_hop_update
from parallel_hnsw_tpu_torch.ops.queues import empty_queue, merge_queue
from parallel_hnsw_tpu_torch.search import LayerSearchState, _fresh_state, _layer_step_fns
from parallel_hnsw_tpu_torch.utils.trace import TRACER

METRICS = [Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN, Metric.DOT]
TABLES = ["f32", "bf16", "slab"]
HOPS = 6


def _setup(q, n, m, d, cap, b, table, metric, seed, device="cpu", layer=None, vectors=None):
    """``(layer, source, slab, queries, state)`` for a hop: a layer of ``n``
    nodes over ``n + 40`` vectors (or the given ``layer`` and ``vectors``),
    a fifth of its neighbor slots and every ninth row ``EMPTY_ID``, the
    queues seeded with a few of its nodes at their true distances, every
    seventh row done and probes 2.  ``table``: the source's f32 rows, its
    bf16 rows (as routing rows are) or an f32 hop slab."""
    g = torch.Generator().manual_seed(seed)
    if layer is None:
        vectors = torch.randn(n + 40, d, generator=g)
        nodes = torch.sort(torch.randperm(n + 40, generator=g)[:n]).values.int()
        neighbors = torch.randint(0, n, (n, m), generator=g, dtype=torch.int32)
        layer = Layer(nodes.to(device), neighbors.to(device))
    n, m = layer.neighbors.shape
    neighbors = layer.neighbors.clone()
    neighbors[(torch.rand(n, m, generator=g) < 0.2).to(device)] = EMPTY_ID
    neighbors[::9] = EMPTY_ID
    layer = Layer(layer.nodes, neighbors)
    vectors = vectors.to(device)
    if metric is Metric.NORMALIZED_COSINE:
        vectors = vectors / torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
    source = DenseSource(vectors.to(torch.bfloat16) if table == "bf16" else vectors)
    slab = None
    if table == "slab":
        vids = node_to_vec(layer.nodes, neighbors)
        slab = vectors[torch.clamp(vids, 0, vectors.shape[0] - 1).long()].contiguous()
    queries = torch.randn(q, d, generator=g).to(device)
    if metric is Metric.NORMALIZED_COSINE:
        queries = queries / torch.linalg.vector_norm(queries, dim=-1, keepdim=True)
    seeds = torch.randint(0, n, (q, 3), generator=g, dtype=torch.int32).to(device)
    seeds[1::11] = EMPTY_ID  # an empty queue: done from the start
    seed_d = source_distance(source, queries, node_to_vec(layer.nodes, seeds), metric)
    ids, dists, _ = merge_queue(*empty_queue(cap, (q,), device=device), seeds, seed_d)
    done = ~torch.any(ids != EMPTY_ID, dim=-1)
    done[3::7] = True
    probes = torch.full((q,), 2, dtype=torch.int32, device=device)
    expanded = torch.zeros((q, cap), dtype=torch.int32, device=device)
    state = _fresh_state(ids, dists, expanded, probes, done, b)
    return layer, source, slab, queries, state


def _clone(state: LayerSearchState) -> LayerSearchState:
    return LayerSearchState(*(v.clone() if isinstance(v, torch.Tensor) else v for v in state))


def _same(got, want, what=""):
    """Bit for bit: distances compared as their bits."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, what
        assert got.shape == want.shape, what
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), what
    else:
        assert got == want, what


def _same_state(got: LayerSearchState, want: LayerSearchState, hop: int) -> None:
    for field, g, w in zip(want._fields, got, want):
        _same(g, w, f"{field} after hop {hop}")


def _torch_hops(layer, source, slab, queries, state, metric, cap, b, hops, monkeypatch):
    """The torch hop (``hop_graph.fuses`` refused) for ``hops`` hops: the
    states after each, and the candidates its queue update received."""
    seen = []
    with monkeypatch.context() as mp:
        mp.setattr(hop_graph, "fuses", lambda device_type, kind: False)
        mp.setattr(search_module, "queue_update", _recording(seen))
        _, body = _layer_step_fns(layer, source, metric, queries, cap, b, 1000, slab=slab)
        states = []
        state = _clone(state)
        for _ in range(hops):
            state = body(state)
            states.append(_clone(state))
    return states, seen


def _recording(seen):
    """``queue_update`` that records the candidates it receives."""
    def update(ids, dists, flags, cand_ids, cand_dists, *rest):
        seen.append((cand_ids.clone(), cand_dists.clone()))
        return cuda_queues.queue_update(ids, dists, flags, cand_ids, cand_dists, *rest)
    return update


def _plain_hop(layer, source, slab, queries, state, metric):
    """One hop by the plain versions of the two kernels: the next state and
    the candidates."""
    ids, dists, expanded, probes, done, hops, evals, improve_hop, frontier, ok = state
    table = slab if slab is not None else source.vectors
    nodes = None if slab is not None else layer.nodes
    expanded, cand_ids, cand_dists, evals = plain_hop_expand(
        queries, table, nodes, layer.neighbors, ids, expanded, frontier, ok, done, evals, metric)
    ids, dists, expanded, frontier, ok, probes, done, improve_hop = plain_hop_update(
        ids, dists, expanded, cand_ids, cand_dists, done, frontier, ok, probes, improve_hop,
        hops + 1)
    nxt = LayerSearchState(ids, dists, expanded, probes, done, hops + 1, evals, improve_hop,
                           frontier, ok)
    return nxt, (cand_ids, cand_dists)


# -- on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("table", TABLES)
def test_plain_hop_is_the_torch_hop(monkeypatch, metric, table):
    """Each hop's candidates, ``evals``, expanded flags, queues, frontier,
    probes, ``done`` and improvement hops, hop after hop."""
    cap, b = 12, 4
    layer, source, slab, queries, state = _setup(40, 60, 6, 8, cap, b, table, metric, seed=7)
    want, seen = _torch_hops(layer, source, slab, queries, state, metric, cap, b, HOPS, monkeypatch)
    got = _clone(state)
    for hop in range(HOPS):
        got, cands = _plain_hop(layer, source, slab, queries, got, metric)
        _same(cands[0], seen[hop][0], f"candidate ids of hop {hop + 1}")
        _same(cands[1], seen[hop][1], f"candidate distances of hop {hop + 1}")
        _same_state(got, want[hop], hop + 1)
    # the case holds what it claims to
    assert bool(state.done.any()) and not bool(state.done.all())
    assert bool((~state.frontier_ok).any()) and bool((layer.neighbors == EMPTY_ID).any())
    assert int(want[-1].evals) > 0 and bool((want[-1].improve_hop > 1).any())


def test_plain_update_takes_the_hop_number_as_a_counter():
    cap, b = 12, 4
    layer, source, _, queries, state = _setup(30, 60, 6, 8, cap, b, "f32", Metric.EUCLIDEAN, seed=3)
    ids, dists, expanded, probes, done, _, evals, improve_hop, frontier, ok = state
    _, cand_ids, cand_dists, _ = plain_hop_expand(queries, source.vectors, layer.nodes,
                                                  layer.neighbors, ids, expanded, frontier, ok,
                                                  done, evals, Metric.EUCLIDEAN)
    args = (ids, dists, expanded, cand_ids, cand_dists, done, frontier, ok, probes, improve_hop)
    by_int = plain_hop_update(*args, 5)
    by_counter = plain_hop_update(*args, torch.tensor(5, dtype=torch.int32))
    for g, w in zip(by_counter, by_int):
        _same(g, w)
    assert bool((by_int[-1] == 5).any())


def test_hop_inputs_are_checked():
    cap, b = 12, 4
    layer, source, slab, queries, state = _setup(10, 60, 6, 8, cap, b, "slab", Metric.DOT, seed=1)
    ids, dists, expanded, probes, done, _, evals, improve_hop, frontier, ok = state
    rest = (layer.neighbors, ids, expanded, frontier, ok, done, evals, Metric.DOT)
    with pytest.raises(ValueError, match="nodes"):
        plain_hop_expand(queries, source.vectors, None, *rest)
    with pytest.raises(ValueError, match="slab"):
        plain_hop_expand(queries, slab, layer.nodes, *rest)
    with pytest.raises(ValueError, match="slab"):
        plain_hop_expand(queries, slab[:, :3], None, *rest)
    with pytest.raises(TypeError, match="int64"):
        plain_hop_expand(queries, slab, None, layer.neighbors, ids, expanded, frontier, ok, done,
                         evals.int(), Metric.DOT)
    with pytest.raises(ValueError, match="cuda"):
        cuda_gather.cuda_hop_expand(queries, slab, None, *rest)
    cands = torch.zeros((10, b * 6), dtype=torch.int32), torch.zeros((10, b * 6))
    with pytest.raises(ValueError, match="probes"):
        plain_hop_update(ids, dists, expanded, *cands, done, frontier, ok, probes.long(),
                         improve_hop, 1)
    with pytest.raises(ValueError, match="counter"):
        plain_hop_update(ids, dists, expanded, *cands, done, frontier, ok, probes, improve_hop,
                         torch.tensor(1))
    with pytest.raises(ValueError, match="cuda"):
        cuda_queues.cuda_hop_update(ids, dists, expanded, *cands, done, frontier, ok, probes,
                                    improve_hop, 1)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def card_graph():
    """The bottom layer of a 20,000 x 32 index on the card (unit rows), and
    its vectors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from parallel_hnsw_tpu_torch import Hnsw

    g = torch.Generator().manual_seed(11)
    x = torch.randn(20_000, 32, generator=g)
    x /= torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    vecs = x.to("cuda:0")
    hnsw = Hnsw.generate(DenseSource(vecs), metric=Metric.NORMALIZED_COSINE, seed=3, improve=False)
    return hnsw.layers[-1], vecs


def _graphed_hops(layer, source, slab, queries, state, metric, cap, b, hops):
    """The states after each of ``hops`` replays of the hop captured in a
    CUDA graph, each with the graph's ``all_done`` flag and device counter."""
    cache = hop_graph.HopGraphCache()
    static = torch.empty_like(queries)
    graph = hop_graph.HopGraph(
        lambda all_done: _layer_step_fns(layer, source, metric, static, cap, b, 1000, slab=slab,
                                         all_done=all_done)[1],
        state, static)
    try:
        cache.add("hop", graph)
        out = []
        with cache.on_stream(queries.device):
            graph.load(state, queries)
            for hop in range(hops):
                graph.replay()
                out.append((graph.state(hop + 1), bool(graph.all_done), int(graph.buffers.hops)))
        torch.cuda.synchronize()
        return out, graph.launches
    finally:
        cache.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [100, 8192])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("table", TABLES)
def test_two_launch_hop_equals_the_torch_hop(device, card_graph, monkeypatch, rows, metric, table):
    """Every field after each of ``HOPS`` hops, the two-launch hop eager
    and replayed against the torch hop on the same CUDA tensors; the
    replayed flag and counter beside them."""
    layer, vecs = card_graph
    cap, b = 300, 4
    m = layer.neighbors.shape[1]
    layer, source, slab, queries, state = _setup(rows, 0, m, 32, cap, b, table, metric, seed=rows,
                                                 device=device, layer=layer, vectors=vecs.cpu())
    want, seen = _torch_hops(layer, source, slab, queries, state, metric, cap, b, HOPS, monkeypatch)
    before = dict(cuda_gather.LAUNCHES)
    _, fused = _layer_step_fns(layer, source, metric, queries, cap, b, 1000, slab=slab)
    got = _clone(state)
    for hop in range(HOPS):
        got = fused(got)
        _same_state(got, want[hop], hop + 1)
    assert cuda_gather.LAUNCHES["hop_expand"] == before["hop_expand"] + HOPS
    assert cuda_gather.LAUNCHES["gather_distance"] == before["gather_distance"]
    assert cuda_gather.LAUNCHES["row_gather"] == before["row_gather"]
    replayed, launches = _graphed_hops(layer, source, slab, queries, state, metric, cap, b, HOPS)
    for hop, (got, all_done, counter) in enumerate(replayed):
        _same_state(got, want[hop], hop + 1)
        assert all_done == bool(want[hop].done.all()) and counter == hop + 1
    assert launches[-1] == {"hop_expand": 1} and launches[2] == {"queue_merge": 1}
    # the case holds what it claims to
    assert bool(state.done.any()) and bool((~state.frontier_ok).any())
    assert bool((layer.neighbors == EMPTY_ID).any()) and int(want[-1].evals) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("table", TABLES)
def test_hop_kernels_equal_their_plain_versions(device, card_graph, table):
    """One hop's expand and update on the card against the plain versions on
    the same CUDA tensors: candidates bit for bit (the plain distances are a
    batched product, within 2e-5), then the update bit for bit on the
    kernel's candidates."""
    layer, vecs = card_graph
    cap, b = 300, 4
    layer, source, slab, queries, state = _setup(
        500, 0, layer.neighbors.shape[1], 32, cap, b, table, Metric.EUCLIDEAN, seed=2,
        device=device, layer=layer, vectors=vecs.cpu())
    ids, dists, expanded, probes, done, _, evals, improve_hop, frontier, ok = _clone(state)
    t = slab if slab is not None else source.vectors
    nodes = None if slab is not None else layer.nodes
    args = (queries, t, nodes, layer.neighbors, ids, expanded, frontier, ok, done)
    p_flags, p_ids, p_d, p_evals = plain_hop_expand(*args, evals, Metric.EUCLIDEAN)
    g_flags, g_ids, g_d, g_evals = cuda_gather.cuda_hop_expand(*args, evals, Metric.EUCLIDEAN)
    for g, w in ((g_flags, p_flags), (g_ids, p_ids), (g_evals, p_evals)):
        _same(g, w)
    assert torch.equal(torch.isinf(g_d), torch.isinf(p_d))
    live = torch.isfinite(p_d)
    assert float((g_d[live] - p_d[live]).abs().max()) <= 2e-5
    upd = (ids, dists, g_flags, g_ids, g_d, done, frontier, ok, probes, improve_hop)
    want = plain_hop_update(*upd, 7)
    got = cuda_queues.cuda_hop_update(*(x.clone() for x in upd), 7)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("table", TABLES)
def test_a_hop_is_two_kernels_and_copies_nothing(device, card_graph, table):
    """One two-launch hop under the profiler: the expand and the merge and no
    other device work; over a graph's state (a device hop counter) it returns
    every buffer it was given, so a replay copies nothing."""
    layer, vecs = card_graph
    cap, b = 300, 4
    layer, source, slab, queries, state = _setup(
        100, 0, layer.neighbors.shape[1], 32, cap, b, table, Metric.NORMALIZED_COSINE, seed=4,
        device=device, layer=layer, vectors=vecs.cpu())
    flag = torch.zeros((), dtype=torch.bool, device=device)
    _, fused = _layer_step_fns(layer, source, Metric.NORMALIZED_COSINE, queries, cap, b, 1000,
                               slab=slab, all_done=flag)
    state = state._replace(hops=torch.zeros((), dtype=torch.int32, device=device))
    fused(state)  # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fused(state)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert sorted("gather_distance_kernel" in k for k in kernels) == [False, True], kernels
    assert sorted("queue_merge_kernel" in k for k in kernels) == [False, True], kernels
    assert all(o is s for o, s in zip(out, state)) and int(state.hops) == 2


@pytest.mark.cuda
def test_every_dense_hop_is_one_expand_and_one_merge(device, card_graph, monkeypatch):
    """A dense search on the card, eager and replayed: each hop one expand
    and one merge launch, no gather kernel but the entry vector's, and the
    spans' ``fused_hops`` count them."""
    from parallel_hnsw_tpu_torch import Hnsw
    from parallel_hnsw_tpu_torch.params import SearchParams
    from parallel_hnsw_tpu_torch.search import search_stack

    _, vecs = card_graph
    hnsw = Hnsw.generate(DenseSource(vecs[:19_000]), metric=Metric.NORMALIZED_COSINE, seed=5,
                         improve=False)
    queries = vecs[19_000:19_300]
    cache = hop_graph.HopGraphCache()
    monkeypatch.setattr(hop_graph, "HOP_GRAPHS", cache)
    for call in range(2):  # the first captures, the second replays from the first hop
        before = {**cuda_gather.LAUNCHES, **cuda_queues.LAUNCHES}
        TRACER.enabled = True
        TRACER.events.clear()
        try:
            search_stack(hnsw.layers, hnsw.source, hnsw.metric, queries, SearchParams())
            torch.cuda.synchronize()
            spans = [e.counters for e in TRACER.events if e.name == "search_layer"]
        finally:
            TRACER.enabled = False
            TRACER.events.clear()
        ran = {k: n - before[k] for k, n in {**cuda_gather.LAUNCHES, **cuda_queues.LAUNCHES}.items()}
        hops = sum(c["hops"] for c in spans)
        assert hops > 0 and sum(c["graph_hops"] for c in spans) > 0
        assert ran == {"row_gather": 1, "gather_distance": 0, "hop_expand": hops,
                       "queue_merge": hops}
        assert [c["fused_hops"] for c in spans] == [c["hops"] for c in spans]
    cache.clear()
