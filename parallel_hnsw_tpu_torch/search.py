"""Batched beam search over the layer stack (counterpart of ``parallel_hnsw_tpu.search``).

Reference hot loop (``Layer::closest_nodes``, src/lib.rs:175-248): pop the
nearest unvisited node, gather its neighbor row, compute distances, merge into
a sorted candidate queue; give up after ``probe_depth`` non-improving pops.

All queries of a block run in lockstep.  Per query the state is a
fixed-capacity sorted candidate queue with an "expanded" bit per slot; one
*hop* expands the ``beam_width`` nearest unexpanded candidates, gathers their
neighbor rows (the hand-written row-gather kernel on a CUDA source), computes
the distances of the neighbors' feature rows to the query in one
gather-and-distance kernel (the rows are never written out; on the CPU its
plain version, a gather and one batched contraction), and merges via masked
sort.  The hop loop runs on the host and reads
``done.all()`` after every hop (the JAX package keeps it inside
``lax.while_loop``); the instrumentation counters stay on the device.

With ``TRACER`` enabled, each layer search is one ``search_layer`` span with
the counters ``layer`` (from the top), ``queries`` (rows of the block),
``hops``, ``dispatch_s`` (host seconds in the hop bodies) and ``wait_s``
(host seconds in the termination reads, which wait for the card).
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

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
from parallel_hnsw_tpu_torch.ops.cuda_gather import gather_distance, row_gather
from parallel_hnsw_tpu_torch.ops.distance import Metric, distance_one
from parallel_hnsw_tpu_torch.ops.queues import (
    empty_queue,
    merge_queue,
    merge_queue_with_flags,
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
) -> Tuple[Callable[[LayerSearchState], bool], Callable[[LayerSearchState], LayerSearchState]]:
    """The (cond, body) of the per-layer expansion loop; shared by the
    one-shot search and the resumable host-driven advance.

    ``slab`` is an optional neighbor-major feature slab ``[N, M, width]``
    (``slab[n, j]`` = features of ``layer.neighbors[n, j]``): the hop then
    gathers ONE slab row per expanded node instead of M feature rows, at the
    price of M-fold feature duplication in device memory (see
    ``routing.build_hop_slabs`` for the memory budget)."""
    q_count = queries.shape[0]
    neighbors = layer.neighbors.contiguous()  # no copy unless the layer holds a view
    n, m = neighbors.shape
    b = min(beam_width, cap)
    slot_pos = torch.arange(cap, dtype=torch.int32, device=queries.device)

    def cond(state: LayerSearchState) -> bool:
        return state.hops < max_hops and not bool(state.done.all())

    def body(state: LayerSearchState) -> LayerSearchState:
        ids, dists, expanded, probes, done, hops, evals, improve_hop = state
        prev_head = ids[:, 0]
        # --- select up to `b` nearest unexpanded slots per query
        frontier = (expanded == 0) & (ids != EMPTY_ID) & ~done[:, None]
        rank = torch.where(frontier, slot_pos[None, :], cap)
        neg_rank, sel_slots = torch.topk(-rank, b, dim=-1)  # [Q, b] smallest ranks
        sel_valid = neg_rank > -cap
        sel_nodes = torch.gather(ids, 1, sel_slots)  # [Q, b]

        # mark selected slots expanded (non-frontier picks rewrite their own value)
        expanded = expanded.scatter(
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

        # --- merge into queues
        ids, dists, expanded, changed = merge_queue_with_flags(
            ids, dists, expanded, flat_ids, d
        )

        # --- termination accounting (reference: probe_depth decrement on
        # non-improving rounds, src/lib.rs:233-238)
        probes = torch.where(~done & ~changed, probes - 1, probes)
        newly_done = (probes <= 0) | ~torch.any((expanded == 0) & (ids != EMPTY_ID), dim=-1)
        head_improved = (ids[:, 0] != prev_head) & ~done
        improve_hop = torch.where(head_improved, hops + 1, improve_hop)
        return LayerSearchState(
            ids, dists, expanded, probes, done | newly_done, hops + 1, evals, improve_hop
        )

    return cond, body


def _timed_hops(
    cond: Callable[[LayerSearchState], bool],
    body: Callable[[LayerSearchState], LayerSearchState],
    state: LayerSearchState,
    clock: List[float],
) -> LayerSearchState:
    """The hop loop ``while cond: body``, adding the host seconds spent in
    ``body`` to ``clock[0]`` and in ``cond`` to ``clock[1]`` (two clock reads
    a hop)."""
    now = time.perf_counter
    t = now()
    while True:
        going = cond(state)
        t_cond = now()
        clock[1] += t_cond - t
        if not going:
            return state
        state = body(state)
        t = now()
        clock[0] += t - t_cond


def _fresh_state(
    ids: torch.Tensor, dists: torch.Tensor, expanded: torch.Tensor, probes: torch.Tensor,
    done: torch.Tensor,
) -> LayerSearchState:
    """A state whose hop, evaluation and improvement counters start at 0."""
    dev = ids.device
    return LayerSearchState(
        ids, dists, expanded, probes, done,
        hops=0,
        evals=torch.zeros((), dtype=torch.int64, device=dev),
        improve_hop=torch.zeros((ids.shape[0],), dtype=torch.int32, device=dev),
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
    cond, body = _layer_step_fns(
        layer, source, metric, queries, cap, beam_width, _auto_max_hops(cap, max_hops), slab=slab
    )
    state = _fresh_state(
        init_ids,
        init_dists,
        torch.zeros((q_count, cap), dtype=torch.int32, device=dev),
        torch.full((q_count,), probe_depth, dtype=torch.int32, device=dev),
        ~torch.any(init_ids != EMPTY_ID, dim=-1),
    )
    if not TRACER.enabled:
        while cond(state):
            state = body(state)
        return state
    clock = [0.0, 0.0]
    with TRACER.span("search_layer", layer=layer_index, queries=q_count) as closing:
        state = _timed_hops(cond, body, state, clock)
        closing.update(hops=state.hops, dispatch_s=clock[0], wait_s=clock[1])
    return state


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
    if not TRACER.enabled:
        return _compacting_search(
            layer, source, metric, queries, init_ids, init_dists, sp, chunk_hops, None
        )[:2]
    clock = [0.0, 0.0]
    with TRACER.span("search_layer", layer=layer_index, queries=queries.shape[0]) as closing:
        out_ids, out_dists, hops = _compacting_search(
            layer, source, metric, queries, init_ids, init_dists, sp, chunk_hops, clock
        )
        closing.update(hops=hops, dispatch_s=clock[0], wait_s=clock[1])
    return out_ids, out_dists


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
    seconds as :func:`_timed_hops` does."""
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
    )
    hops_used = 0
    while True:
        cond, body = _layer_step_fns(
            layer, source, metric, act_queries, cap, sp.beam_width, chunk_hops
        )
        state = state._replace(hops=0)
        if clock is None:
            while cond(state):
                state = body(state)
        else:
            state = _timed_hops(cond, body, state, clock)
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
            state.done[keep],
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
