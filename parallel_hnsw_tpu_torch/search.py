"""Batched beam search over the layer stack (counterpart of ``parallel_hnsw_tpu.search``).

Reference hot loop (``Layer::closest_nodes``, src/lib.rs:175-248): pop the
nearest unvisited node, gather its neighbor row, compute distances, merge into
a sorted candidate queue; give up after ``probe_depth`` non-improving pops.

All queries of a block run in lockstep.  Per query the state is a
fixed-capacity sorted candidate queue with an "expanded" bit per slot; one
*hop* expands the ``beam_width`` nearest unexpanded candidates, gathers their
neighbor rows, computes the distances of the neighbors' feature rows to the
query, and merges them into the queue.  The merge also finds the next hop's
frontier, which the state carries, and the hop ends with the termination
accounting.  On the card, over a dense source or a hop slab
(``hop_graph.fuses``), a hop is two hand-written launches that update the
state in place: ``cuda_gather.cuda_hop_expand`` (frontier, neighbor rows,
distances) and ``cuda_queues.cuda_hop_update`` (the merge, the frontier and
the accounting).  Elsewhere (the CPU, memmap, PQ and user sources) it is
torch operations around the row-gather kernel, ``source_distance`` (the
gather-and-distance kernel where the rows are one tensor on the card) and
the queue update (``ops/cuda_queues``; on the CPU its plain version, a
masked sort); the two give the same state, bit for bit.  The hop loop runs
on the host and reads ``done.all()`` after every hop (the JAX package keeps
it inside ``lax.while_loop``); the instrumentation counters stay on the
device.  On the card a long layer search replays its hop from a CUDA graph,
one graph launch a hop (:mod:`parallel_hnsw_tpu_torch.hop_graph`), with the
same results.

With ``TRACER`` enabled, each layer search is one ``search_layer`` span with
the counters ``layer`` (from the top), ``queries`` (rows of the block),
``hops``, ``dispatch_s`` (host seconds in the hop bodies, graph launches and
captures), ``wait_s`` (host seconds in the termination reads, which wait for
the card), ``graph_hops`` (hops replayed from a graph), ``captures``
(graphs captured), ``merge_kernel_hops`` (hops whose queue update ran the
queue-merge kernel, eager or replayed: the launches counted over the span)
and ``fused_hops`` (hops that ran as the two hop launches: the expand
kernel's launches counted over the span).
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from parallel_hnsw_tpu_torch import hop_graph
from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.graph import (
    Layer,
    Source,
    node_to_vec,
    source_distance,
    source_effective_width,
    source_get,
    vec_to_node,
)
from parallel_hnsw_tpu_torch.ops import cuda_gather, cuda_queues
from parallel_hnsw_tpu_torch.ops.cuda_gather import cuda_hop_expand, gather_distance, row_gather
from parallel_hnsw_tpu_torch.ops.cuda_queues import cuda_hop_update, queue_update
from parallel_hnsw_tpu_torch.ops.distance import Metric, distance_one
from parallel_hnsw_tpu_torch.ops.queues import (
    empty_queue,
    merge_queue,
    merged_frontier,
    sort_queue,
)
from parallel_hnsw_tpu_torch.params import SearchParams
from parallel_hnsw_tpu_torch.utils.trace import TRACER


class LayerSearchState(NamedTuple):
    ids: torch.Tensor  # [Q, cap] node ids, (dist,id)-sorted
    dists: torch.Tensor  # [Q, cap]
    expanded: torch.Tensor  # [Q, cap] int32 0/1
    probes: torch.Tensor  # [Q] remaining non-improving hops
    done: torch.Tensor  # [Q] bool
    hops: int  # hops run so far
    evals: torch.Tensor  # scalar int64: total distance evaluations (instrumentation)
    improve_hop: torch.Tensor  # [Q] int32 hop index of the last head-improving
    # merge: the batched analogue of the reference's index_sum instrumentation
    # (src/lib.rs:190-229, search_layers_instrumented)
    frontier: torch.Tensor  # [Q, b] int64 the next hop's slots (ops.queues.merged_frontier)
    frontier_ok: torch.Tensor  # [Q, b] bool which of them are unexpanded live slots


def _auto_max_hops(cap: int, max_hops: int) -> int:
    return max_hops if max_hops > 0 else cap


def _layer_step_fns(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    cap: int,
    beam_width: int,
    max_hops: int,
    slab: Optional[torch.Tensor] = None,
    all_done: Optional[torch.Tensor] = None,
) -> Tuple[Callable[[LayerSearchState], bool], Callable[[LayerSearchState], LayerSearchState]]:
    """The (cond, body) of the per-layer expansion loop; shared by the
    one-shot search and the resumable host-driven advance.

    ``slab`` is an optional neighbor-major feature slab ``[N, M, width]``
    (``slab[n, j]`` = features of ``layer.neighbors[n, j]``): the hop then
    gathers ONE slab row per expanded node instead of M feature rows, at the
    price of M-fold feature duplication in device memory (see
    ``routing.build_hop_slabs`` for the memory budget).

    The body is the two hop launches where ``hop_graph.fuses`` says so, else
    torch operations around three kernels (the module docstring).  The two
    launches update the state in place, and a state whose ``hops`` is a
    device counter (a CUDA graph's) has it advanced.  ``all_done``, a bool
    scalar on the device that only the two launches take, is left reading
    whether every row is done after the hop (the flag a graph's host
    reads)."""
    q_count = queries.shape[0]
    neighbors = layer.neighbors.contiguous()  # no copy unless the layer holds a view
    n, m = neighbors.shape
    b = min(beam_width, cap)

    def cond(state: LayerSearchState) -> bool:
        return state.hops < max_hops and not bool(state.done.all())

    if hop_graph.fuses(queries.device.type, hop_graph.source_kind(source, slab)):
        table = slab if slab is not None else source.vectors
        nodes = None if slab is not None else layer.nodes

        def fused(state: LayerSearchState) -> LayerSearchState:
            ids, dists, expanded, probes, done, hops, evals, improve_hop, frontier, frontier_ok = state
            counter = hops if isinstance(hops, torch.Tensor) else None
            _, cand_ids, cand_dists, _ = cuda_hop_expand(
                queries, table, nodes, neighbors, ids, expanded, frontier, frontier_ok, done, evals,
                metric, counter=counter, all_done=all_done,
            )
            # the counter is this hop's number once the expand has advanced it
            number = counter if counter is not None else hops + 1
            cuda_hop_update(ids, dists, expanded, cand_ids, cand_dists, done, frontier, frontier_ok,
                            probes, improve_hop, number, all_done=all_done)
            return state._replace(hops=number)

        return cond, fused

    def body(state: LayerSearchState) -> LayerSearchState:
        ids, dists, expanded, probes, done, hops, evals, improve_hop, frontier, frontier_ok = state
        prev_head = ids[:, 0].clone()  # the card's merge updates ids in place
        # --- the up to `b` nearest unexpanded slots per query, from the last merge
        sel_slots = frontier  # [Q, b], distinct slots
        sel_valid = frontier_ok & ~done[:, None]
        sel_nodes = torch.gather(ids, 1, sel_slots)  # [Q, b]

        # mark selected slots expanded (non-frontier picks rewrite their own value)
        expanded.scatter_(
            1, sel_slots, torch.where(sel_valid, 1, torch.gather(expanded, 1, sel_slots))
        )

        # --- gather neighbor rows [Q, b, M]
        safe_nodes = torch.clamp(sel_nodes, 0, n - 1)
        rows = row_gather(neighbors, safe_nodes)
        rows = torch.where(sel_valid[..., None], rows, EMPTY_ID)
        flat_nodes = rows.reshape(q_count, b * m)
        valid = flat_nodes != EMPTY_ID

        # --- distances to the query (one gather-and-distance kernel; an
        # EMPTY_ID index reads nothing and gives +inf)
        if slab is not None:
            # one slab row per expanded node carries all M neighbor features;
            # its padding slots are masked below via flat_nodes == EMPTY_ID
            d = gather_distance(queries, slab, torch.where(sel_valid, sel_nodes, EMPTY_ID), metric)
        else:
            d = source_distance(source, queries, node_to_vec(layer.nodes, flat_nodes), metric)
        d = torch.where(valid, d, EMPTY_DIST)
        flat_ids = torch.where(valid, flat_nodes, EMPTY_ID)
        evals = evals + valid.sum()

        # --- merge into queues, and the next hop's frontier (done rows keep
        # theirs: the merge of no candidates leaves them as they are)
        ids, dists, expanded, changed, frontier, frontier_ok = queue_update(
            ids, dists, expanded, flat_ids, d, done, frontier, frontier_ok
        )

        # --- termination accounting (reference: probe_depth decrement on
        # non-improving rounds, src/lib.rs:233-238); a queue with no
        # unexpanded live slot has no valid first pick
        probes = torch.where(~done & ~changed, probes - 1, probes)
        newly_done = (probes <= 0) | ~frontier_ok[:, 0]
        head_improved = (ids[:, 0] != prev_head) & ~done
        improve_hop = torch.where(head_improved, hops + 1, improve_hop)
        return LayerSearchState(
            ids, dists, expanded, probes, done | newly_done, hops + 1, evals, improve_hop,
            frontier, frontier_ok,
        )

    return cond, body


def _fresh_state(
    ids: torch.Tensor, dists: torch.Tensor, expanded: torch.Tensor, probes: torch.Tensor,
    done: torch.Tensor, beam_width: int,
) -> LayerSearchState:
    """A state whose hop, evaluation and improvement counters start at 0,
    with the first hop's frontier of ``min(beam_width, cap)`` slots taken
    from the starting queue.  The hops update the state's queues in place,
    so it holds copies of ``ids`` and ``dists``."""
    dev = ids.device
    frontier, frontier_ok = merged_frontier(ids, expanded, min(beam_width, ids.shape[1]))
    return LayerSearchState(
        ids.clone(memory_format=torch.contiguous_format),
        dists.clone(memory_format=torch.contiguous_format),
        expanded, probes, done,
        hops=0,
        evals=torch.zeros((), dtype=torch.int64, device=dev),
        improve_hop=torch.zeros((ids.shape[0],), dtype=torch.int32, device=dev),
        frontier=frontier,
        frontier_ok=frontier_ok,
    )


def search_one_layer(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: torch.Tensor,  # [Q, D]
    init_ids: torch.Tensor,  # [Q, cap] node ids
    init_dists: torch.Tensor,  # [Q, cap]
    *,
    probe_depth: int,
    beam_width: int,
    max_hops: int,
    slab: Optional[torch.Tensor] = None,
    layer_index: int = 0,
) -> LayerSearchState:
    """Expand candidate queues inside one layer until convergence.

    Equivalent of ``Layer::closest_nodes`` (src/lib.rs:175-248), batched.
    ``layer_index`` (the layer's place from the top of its stack) labels the
    ``search_layer`` span.
    """
    q_count, cap = init_ids.shape
    dev = queries.device
    max_hops = _auto_max_hops(cap, max_hops)
    cond, body = _layer_step_fns(layer, source, metric, queries, cap, beam_width, max_hops, slab=slab)
    state = _fresh_state(
        init_ids,
        init_dists,
        torch.zeros((q_count, cap), dtype=torch.int32, device=dev),
        torch.full((q_count,), probe_depth, dtype=torch.int32, device=dev),
        ~torch.any(init_ids != EMPTY_ID, dim=-1),
        beam_width,
    )
    key = hop_graph.graph_key(
        layer, source, slab, queries, cap, min(beam_width, cap), metric, probe_depth
    )

    def new_graph() -> hop_graph.HopGraph:
        static_queries = torch.empty_like(queries, memory_format=torch.contiguous_format)
        return hop_graph.HopGraph(
            lambda all_done: _layer_step_fns(
                layer, source, metric, static_queries, cap, beam_width, max_hops, slab=slab,
                all_done=all_done,
            )[1],
            state,
            static_queries,
        )

    def run_hops(clock: Optional[List[float]]) -> Tuple[LayerSearchState, int, int]:
        if key is None:
            return _hops(cond, body, state, clock), 0, 0
        lock = hop_graph.HOP_GRAPHS.lock(dev)
        if not lock.acquire(blocking=False):  # another search holds the device's graphs
            return _hops(cond, body, state, clock), 0, 0
        try:
            watch = hop_graph.key_tensors(layer, source, slab)
            return _layer_hops(cond, body, state, max_hops, key, new_graph, watch, queries, clock)
        finally:
            lock.release()

    def traced(clock: Optional[List[float]]) -> Tuple[LayerSearchState, int, int, int]:
        state, graph_hops, captures = run_hops(clock)
        return state, state.hops, graph_hops, captures

    return _layer_span(layer_index, q_count, traced)


def _layer_span(layer_index: int, q_count: int, run: Callable):
    """``run(clock)``'s result, where ``run`` is a layer search that returns
    ``(result, hops, graph_hops, captures)``.  With ``TRACER`` on it runs
    inside the layer's ``search_layer`` span with a clock, and the span gets
    the counters of the module docstring; off, it runs without a clock."""
    if not TRACER.enabled:
        return run(None)[0]
    clock = [0.0, 0.0]
    with TRACER.span("search_layer", layer=layer_index, queries=q_count) as closing:
        merges = cuda_queues.LAUNCHES["queue_merge"]
        expands = cuda_gather.LAUNCHES["hop_expand"]
        out, hops, graph_hops, captures = run(clock)
        closing.update(hops=hops, dispatch_s=clock[0], wait_s=clock[1],
                       graph_hops=graph_hops, captures=captures,
                       merge_kernel_hops=cuda_queues.LAUNCHES["queue_merge"] - merges,
                       fused_hops=cuda_gather.LAUNCHES["hop_expand"] - expands)
    return out


def _timed(fn: Callable, clock: Optional[List[float]], slot: int):
    """``fn()``, its host seconds added to ``clock[slot]`` when a clock is
    given."""
    if clock is None:
        return fn()
    t = time.perf_counter()
    out = fn()
    clock[slot] += time.perf_counter() - t
    return out


def _hops(cond: Callable, body: Callable, state, clock: Optional[List[float]]):
    """The hop loop ``while cond: body``.  A ``clock`` gets the host seconds
    spent in ``body`` added to ``clock[0]`` and in ``cond`` to ``clock[1]``
    (two clock reads a hop); without one the loop reads no clock."""
    timed = clock is not None
    t = time.perf_counter() if timed else 0.0
    while True:
        going = cond(state)
        if timed:
            t_cond = time.perf_counter()
            clock[1] += t_cond - t
        if not going:
            return state
        state = body(state)
        if timed:
            t = time.perf_counter()
            clock[0] += t - t_cond


def _layer_hops(
    cond: Callable[[LayerSearchState], bool],
    body: Callable[[LayerSearchState], LayerSearchState],
    state: LayerSearchState,
    max_hops: int,
    key,
    new_graph: Callable[[], "hop_graph.HopGraph"],
    watch: Sequence[torch.Tensor],
    queries: torch.Tensor,
    clock: Optional[List[float]],
) -> Tuple[LayerSearchState, int, int]:
    """The hop loop of a layer search whose hop may be graphed (``key``, with
    the device's graphs held); returns the final state, the hops replayed
    from a graph and the graphs captured (0 or 1).

    A ``key`` with a graph replays it from the first hop.  Otherwise the
    search runs ``CAPTURE_AFTER_HOPS`` eager hops and, if it has not
    converged, captures its hop (kept until a tensor of ``watch`` is freed)
    and replays the rest.  Either way the host reads one ``done`` flag a hop
    and counts the hops for ``max_hops``; the graph's work runs on the
    device's graph stream, and capture and the state's copies in and out
    count as dispatch."""
    graphs = hop_graph.HOP_GRAPHS
    graph = graphs.get(key)
    captures = 0
    if graph is None:
        limit = hop_graph.CAPTURE_AFTER_HOPS
        state = _hops(lambda s: s.hops < limit and cond(s), body, state, clock)
        if state.hops < limit or not _timed(lambda: cond(state), clock, 1):
            return state, 0, 0
        graph = _timed(lambda: graphs.add(key, new_graph(), watch), clock, 0)
        captures = 1

    def replay(hops: int) -> int:
        graph.replay()
        return hops + 1

    with graphs.on_stream(queries.device) as caller:
        _timed(lambda: graph.load(state, queries), clock, 0)
        hops = _hops(lambda h: h < max_hops and not bool(graph.all_done), replay, state.hops, clock)
        out = _timed(lambda: graph.state(hops), clock, 0)
    if caller is not None:  # made on the graph stream, used on the caller's
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(caller)
    return out, hops - state.hops, captures


def _host_layer_search(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    init_ids: torch.Tensor,
    init_dists: torch.Tensor,
    sp: SearchParams,
    chunk_hops: int = 16,
    layer_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer search with convergence-tail compaction.

    The lockstep loop runs the whole batch until the SLOWEST query converges.
    Here the loop is chunked: every ``chunk_hops`` hops, converged queries
    retire to the output and the remainder is compacted into a smaller
    batch, so stragglers stop taxing the finished majority.  The JAX package
    pads the compacted batch to a shape bucket to reuse compiled programs;
    nothing is compiled here, so the batch is exactly the unconverged rows.
    With the tracer on, the whole layer search is one ``search_layer`` span.
    """
    def traced(clock: Optional[List[float]]):
        out_ids, out_dists, hops = _compacting_search(
            layer, source, metric, queries, init_ids, init_dists, sp, chunk_hops, clock
        )
        return (out_ids, out_dists), hops, 0, 0

    return _layer_span(layer_index, queries.shape[0], traced)


def _compacting_search(
    layer: Layer,
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    init_ids: torch.Tensor,
    init_dists: torch.Tensor,
    sp: SearchParams,
    chunk_hops: int,
    clock: Optional[List[float]],
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The chunked loop of :func:`_host_layer_search`; returns the found
    queues and the hops run.  A ``clock`` gathers the hop loop's host
    seconds as :func:`_hops` does."""
    q, cap = init_ids.shape
    dev = queries.device
    max_hops = _auto_max_hops(cap, sp.max_hops)

    out_ids = torch.full((q, cap), EMPTY_ID, dtype=ID_DTYPE, device=dev)
    out_dists = torch.full((q, cap), EMPTY_DIST, dtype=torch.float32, device=dev)

    active = torch.arange(q, device=dev)
    act_queries = queries
    state = _fresh_state(
        init_ids,
        init_dists,
        torch.zeros((q, cap), dtype=torch.int32, device=dev),
        torch.full((q,), sp.probe_depth, dtype=torch.int32, device=dev),
        ~torch.any(init_ids != EMPTY_ID, dim=-1),
        sp.beam_width,
    )
    hops_used = 0
    while True:
        cond, body = _layer_step_fns(
            layer, source, metric, act_queries, cap, sp.beam_width, chunk_hops
        )
        state = _hops(cond, body, state._replace(hops=0), clock)
        hops_used += state.hops
        done = torch.ones_like(state.done) if hops_used >= max_hops else state.done
        fin = done.nonzero()[:, 0]
        if fin.numel():
            out_ids[active[fin]] = state.ids[fin]
            out_dists[active[fin]] = state.dists[fin]
        keep = (~done).nonzero()[:, 0]
        if keep.numel() == 0:
            return out_ids, out_dists, hops_used
        active = active[keep]
        act_queries = act_queries[keep]
        state = _fresh_state(
            state.ids[keep], state.dists[keep], state.expanded[keep], state.probes[keep],
            state.done[keep], sp.beam_width,
        )


def _entry_seed(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seed the candidate queue with the entry vector — the first node of the
    top layer (reference: src/search.rs:9-11,101-111)."""
    q_count = queries.shape[0]
    entry_vec = layers[0].nodes[:1]
    ev = source_get(source, entry_vec)[0]  # [D]
    d = distance_one(queries, ev.expand_as(queries), metric)
    ids, dists = empty_queue(cap, (q_count,), device=queries.device)
    ids[:, 0] = entry_vec
    dists[:, 0] = d
    return ids, dists


def _enter_layer(
    layer: Layer, cand_ids: torch.Tensor, cand_dists: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carried candidates as this layer's initial node queue, at full
    capacity (reference uses the carried queue's capacity, src/lib.rs:264)."""
    q_count, cap = cand_ids.shape
    node_ids = vec_to_node(layer.nodes, cand_ids)
    node_dists = torch.where(node_ids == EMPTY_ID, EMPTY_DIST, cand_dists)
    init_ids, init_dists, _ = merge_queue(
        *empty_queue(cap, (q_count,), device=cand_ids.device), node_ids, node_dists
    )
    return init_ids, init_dists


def _exit_layer(
    layer: Layer,
    found_ids: torch.Tensor,
    found_dists: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    exclude: Optional[torch.Tensor],
    out_count: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the best ``out_count`` nodes a layer found into the carried
    candidates (reference: take(candidate_count), src/lib.rs:273)."""
    found_vecs = node_to_vec(layer.nodes, found_ids)
    if exclude is not None:
        drop = found_vecs == exclude[:, None]
        found_vecs = torch.where(drop, EMPTY_ID, found_vecs)
        found_dists = torch.where(drop, EMPTY_DIST, found_dists)
    if out_count < found_vecs.shape[-1]:
        found_vecs = found_vecs[:, :out_count]
        found_dists = found_dists[:, :out_count]
    out_ids, out_dists, _ = merge_queue(cand_ids, cand_dists, found_vecs, found_dists)
    return out_ids, out_dists


def _final_exclude(
    cand_ids: torch.Tensor, cand_dists: torch.Tensor, exclude: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the excluded id from the final result: the entry seed bypasses
    the per-layer filter (the reference leaks it too and re-filters at call
    sites, e.g. src/search.rs:78-82)."""
    if exclude is None:
        return cand_ids, cand_dists
    drop = cand_ids == exclude[:, None]
    cand_ids = torch.where(drop, EMPTY_ID, cand_ids)
    cand_dists = torch.where(drop, EMPTY_DIST, cand_dists)
    return sort_queue(cand_ids, cand_dists)


def search_stack(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,  # [Q, D]
    sp: SearchParams,
    exclude: Optional[torch.Tensor] = None,  # [Q] vector ids to drop from results
    slabs: Optional[Sequence[torch.Tensor]] = None,  # per-layer neighbor-major slabs
) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Descend the layer stack (reference: search_layers, src/search.rs:84-140).

    Returns ``(vector_ids [Q, noc], dists [Q, noc], hops, evals,
    bottom_improve_hop [Q])``: the queues sorted ascending by ``(dist, id)``
    with EMPTY padding, the hops run over all layers (a host integer), the
    distance evaluations (a scalar tensor on the device) and, per query, the
    hop of the bottom layer's last head-improving merge.
    """
    noc = sp.number_of_candidates
    ulcc = sp.upper_layer_candidate_count
    q_count = queries.shape[0]
    dev = queries.device

    cand_ids, cand_dists = _entry_seed(layers, source, metric, queries, noc)
    total_hops = 0
    total_evals = torch.zeros((), dtype=torch.int64, device=dev)
    bottom_improve_hop = torch.zeros((q_count,), dtype=torch.int32, device=dev)

    for i, layer in enumerate(layers):
        is_bottom = i == len(layers) - 1
        init_ids, init_dists = _enter_layer(layer, cand_ids, cand_dists)
        state = search_one_layer(
            layer,
            source,
            metric,
            queries,
            init_ids,
            init_dists,
            probe_depth=sp.probe_depth,
            beam_width=sp.beam_width,
            max_hops=sp.max_hops,
            slab=slabs[i] if slabs is not None else None,
            layer_index=i,
        )
        total_hops += state.hops
        total_evals = total_evals + state.evals
        if is_bottom:
            bottom_improve_hop = state.improve_hop
        cand_ids, cand_dists = _exit_layer(
            layer, state.ids, state.dists, cand_ids, cand_dists, exclude,
            noc if is_bottom else ulcc,
        )

    cand_ids, cand_dists = _final_exclude(cand_ids, cand_dists, exclude)
    return cand_ids, cand_dists, total_hops, total_evals, bottom_improve_hop


def search_host(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    sp: SearchParams,
    exclude: Optional[torch.Tensor] = None,
    chunk_hops: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer-stack descent with convergence-tail compaction.

    Same semantics as :func:`search_stack`; each layer's expansion retires
    converged queries between hop chunks (:func:`_host_layer_search`).
    """
    noc = sp.number_of_candidates
    ulcc = sp.upper_layer_candidate_count
    cand_ids, cand_dists = _entry_seed(layers, source, metric, queries, noc)
    for i, layer in enumerate(layers):
        is_bottom = i == len(layers) - 1
        init_ids, init_dists = _enter_layer(layer, cand_ids, cand_dists)
        found_ids, found_dists = _host_layer_search(
            layer, source, metric, queries, init_ids, init_dists, sp, chunk_hops, layer_index=i
        )
        cand_ids, cand_dists = _exit_layer(
            layer, found_ids, found_dists, cand_ids, cand_dists, exclude,
            noc if is_bottom else ulcc,
        )
    return _final_exclude(cand_ids, cand_dists, exclude)


def auto_query_block(
    source: Source, sp: SearchParams, max_m: int, budget_bytes: int = 2 << 30
) -> int:
    """Query-block size bounding the per-hop gathered candidate block
    ``[Q, beam*M, width]`` (the JAX package's budget, kept: on the card the
    fused hop writes only the ``[Q, beam*M]`` distances, on the CPU the plain
    version gathers the block)."""
    eff = source_effective_width(source)
    qb = budget_bytes // max(1, sp.beam_width * max_m * eff * 4)
    return int(max(64, min(8192, qb)))


def search(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    sp: SearchParams,
    exclude: Optional[torch.Tensor] = None,
    query_block: int = 0,
    adaptive: bool = False,
    slabs: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer search with host-side query chunking.

    ``query_block`` bounds device memory for huge query batches (the gathered
    candidate block is ``[Q, beam*M, D]`` on the CPU); 0 = auto from a byte
    budget.
    ``adaptive`` takes the convergence-tail compaction path
    (:func:`search_host`), which, as in the JAX package, does not use slabs;
    the default is the lockstep loop.  ``slabs`` are per-layer hop slabs
    ``[N, M, width]`` over the layers as they are (no node padding here).
    """
    if slabs is not None:
        for i, layer in enumerate(layers):
            if tuple(slabs[i].shape[:2]) != tuple(layer.neighbors.shape):
                raise ValueError(
                    f"hop slab {i} shape {tuple(slabs[i].shape[:2])} does not match the "
                    f"layer {tuple(layer.neighbors.shape)} — rebuild the slabs "
                    "(the graph changed since enable_hop_slabs)"
                )
    if layers and query_block <= 0:
        max_m = max(l.neighborhood_size for l in layers)
        query_block = auto_query_block(source, sp, max_m)

    def run_block(block_queries, block_exclude):
        if adaptive:
            return search_host(layers, source, metric, block_queries, sp, block_exclude)
        return search_stack(layers, source, metric, block_queries, sp, block_exclude, slabs)[:2]

    q = queries.shape[0]
    if query_block <= 0 or q <= query_block:
        return run_block(queries, exclude)

    ids, dists = [], []
    for start in range(0, q, query_block):
        stop = min(start + query_block, q)
        ex = exclude[start:stop] if exclude is not None else None
        i, d = run_block(queries[start:stop], ex)
        ids.append(i)
        dists.append(d)
    return torch.cat(ids), torch.cat(dists)


def search_instrumented(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,
    sp: SearchParams,
    exclude: Optional[torch.Tensor] = None,
):
    """Search with instrumentation (reference: search_layers_instrumented /
    Hnsw::search_instrumented, src/search.rs:93-140, src/lib.rs:667-673).

    Returns ``(ids, dists, stats)`` where stats carries the total hop count,
    total distance evaluations, and the per-query hop index of the last
    head-improving merge in the bottom layer (the analogue of the reference's
    ``index_distance``).  All queries run as one block, as in the JAX package.
    """
    ids, dists, hops, evals, improve_hop = search_stack(
        layers, source, metric, queries, sp, exclude
    )
    stats = {
        "hops": int(hops),
        "distance_evaluations": int(evals),
        "last_improvement_hop": improve_hop,
    }
    return ids, dists, stats
