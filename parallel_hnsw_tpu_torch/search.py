"""Batched beam search over the layer stack (counterpart of ``parallel_hnsw_tpu.search``).

Reference hot loop (``Layer::closest_nodes``, src/lib.rs:175-248): pop the
nearest unvisited node, gather its neighbor row, compute distances, merge into
a sorted candidate queue; give up after ``probe_depth`` non-improving pops.

All queries of a block run in lockstep.  Per query the state is a
fixed-capacity sorted candidate queue with an "expanded" bit per slot; one
*hop* expands the ``beam_width`` nearest unexpanded candidates, gathers their
neighbor rows, computes all distances as one batched contraction, and merges
via masked sort.  The hop loop runs on the host and reads ``done.all()``
after every hop (the JAX package keeps it inside ``lax.while_loop``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID
from parallel_hnsw_tpu_torch.graph import (
    Layer,
    Source,
    node_to_vec,
    source_effective_width,
    source_get,
    vec_to_node,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance, distance_one
from parallel_hnsw_tpu_torch.ops.queues import (
    empty_queue,
    merge_queue,
    merge_queue_with_flags,
    sort_queue,
)
from parallel_hnsw_tpu_torch.params import SearchParams


class LayerSearchState(NamedTuple):
    ids: torch.Tensor  # [Q, cap] node ids, (dist,id)-sorted
    dists: torch.Tensor  # [Q, cap]
    expanded: torch.Tensor  # [Q, cap] int32 0/1
    probes: torch.Tensor  # [Q] remaining non-improving hops
    done: torch.Tensor  # [Q] bool
    hops: int  # hops run so far


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
) -> Tuple[Callable[[LayerSearchState], bool], Callable[[LayerSearchState], LayerSearchState]]:
    """The (cond, body) of the per-layer expansion loop."""
    q_count = queries.shape[0]
    n, m = layer.neighbors.shape
    b = min(beam_width, cap)
    slot_pos = torch.arange(cap, dtype=torch.int32, device=queries.device)

    def cond(state: LayerSearchState) -> bool:
        return state.hops < max_hops and not bool(state.done.all())

    def body(state: LayerSearchState) -> LayerSearchState:
        ids, dists, expanded, probes, done, hops = state
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
        rows = layer.neighbors[torch.clamp(sel_nodes, 0, n - 1)]
        rows = torch.where(sel_valid[..., None], rows, EMPTY_ID)
        flat_nodes = rows.reshape(q_count, b * m)
        valid = flat_nodes != EMPTY_ID

        # --- distances to the query (one batched contraction)
        cand_vecs = source_get(source, node_to_vec(layer.nodes, flat_nodes))
        d = batched_distance(queries, cand_vecs, metric)
        d = torch.where(valid, d, EMPTY_DIST)
        flat_ids = torch.where(valid, flat_nodes, EMPTY_ID)

        # --- merge into queues
        ids, dists, expanded, changed = merge_queue_with_flags(
            ids, dists, expanded, flat_ids, d
        )

        # --- termination accounting (reference: probe_depth decrement on
        # non-improving rounds, src/lib.rs:233-238)
        probes = torch.where(~done & ~changed, probes - 1, probes)
        newly_done = (probes <= 0) | ~torch.any((expanded == 0) & (ids != EMPTY_ID), dim=-1)
        return LayerSearchState(ids, dists, expanded, probes, done | newly_done, hops + 1)

    return cond, body


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
) -> LayerSearchState:
    """Expand candidate queues inside one layer until convergence.

    Equivalent of ``Layer::closest_nodes`` (src/lib.rs:175-248), batched.
    """
    q_count, cap = init_ids.shape
    dev = queries.device
    cond, body = _layer_step_fns(
        layer, source, metric, queries, cap, beam_width, _auto_max_hops(cap, max_hops)
    )
    state = LayerSearchState(
        ids=init_ids,
        dists=init_dists,
        expanded=torch.zeros((q_count, cap), dtype=torch.int32, device=dev),
        probes=torch.full((q_count,), probe_depth, dtype=torch.int32, device=dev),
        done=~torch.any(init_ids != EMPTY_ID, dim=-1),
        hops=0,
    )
    while cond(state):
        state = body(state)
    return state


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


def search_stack(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    queries: torch.Tensor,  # [Q, D]
    sp: SearchParams,
    exclude: Optional[torch.Tensor] = None,  # [Q] vector ids to drop from results
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descend the layer stack (reference: search_layers, src/search.rs:84-140).

    Returns ``(vector_ids [Q, noc], dists [Q, noc])`` sorted ascending by
    ``(dist, id)`` with EMPTY padding.  The JAX package also returns hop and
    evaluation counters; they serve only its instrumented and adaptive
    searches, which are not ported yet.
    """
    noc = sp.number_of_candidates
    ulcc = sp.upper_layer_candidate_count
    q_count = queries.shape[0]
    dev = queries.device

    cand_ids, cand_dists = _entry_seed(layers, source, metric, queries, noc)

    for i, layer in enumerate(layers):
        is_bottom = i == len(layers) - 1
        out_count = noc if is_bottom else ulcc

        node_ids = vec_to_node(layer.nodes, cand_ids)
        node_dists = torch.where(node_ids == EMPTY_ID, EMPTY_DIST, cand_dists)
        # queue for this layer at full capacity (reference uses the carried
        # queue's capacity, src/lib.rs:264)
        init_ids, init_dists, _ = merge_queue(
            *empty_queue(noc, (q_count,), device=dev), node_ids, node_dists
        )

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
        )

        found_vecs = node_to_vec(layer.nodes, state.ids)
        found_dists = state.dists
        if exclude is not None:
            drop = found_vecs == exclude[:, None]
            found_vecs = torch.where(drop, EMPTY_ID, found_vecs)
            found_dists = torch.where(drop, EMPTY_DIST, found_dists)
        # keep only the best `out_count` from this layer (reference: take(
        # candidate_count), src/lib.rs:273)
        if out_count < noc:
            found_vecs = found_vecs[:, :out_count]
            found_dists = found_dists[:, :out_count]

        cand_ids, cand_dists, _ = merge_queue(cand_ids, cand_dists, found_vecs, found_dists)

    if exclude is not None:
        # the entry seed bypasses the per-layer filter (the reference leaks it
        # too and re-filters at call sites, e.g. src/search.rs:78-82); drop it
        # from the final result for a clean exclusion contract.
        drop = cand_ids == exclude[:, None]
        cand_ids = torch.where(drop, EMPTY_ID, cand_ids)
        cand_dists = torch.where(drop, EMPTY_DIST, cand_dists)
        cand_ids, cand_dists = sort_queue(cand_ids, cand_dists)

    return cand_ids, cand_dists


def auto_query_block(
    source: Source, sp: SearchParams, max_m: int, budget_bytes: int = 2 << 30
) -> int:
    """Query-block size bounding the per-hop gathered candidate block
    ``[Q, beam*M, width]``."""
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer search with host-side query chunking.

    ``query_block`` bounds device memory for huge query batches (the gathered
    candidate block is ``[Q, beam*M, D]``); 0 = auto from a byte budget.
    """
    if layers and query_block <= 0:
        max_m = max(l.neighborhood_size for l in layers)
        query_block = auto_query_block(source, sp, max_m)

    q = queries.shape[0]
    if query_block <= 0 or q <= query_block:
        return search_stack(layers, source, metric, queries, sp, exclude)

    ids, dists = [], []
    for start in range(0, q, query_block):
        stop = min(start + query_block, q)
        ex = exclude[start:stop] if exclude is not None else None
        i, d = search_stack(layers, source, metric, queries[start:stop], sp, ex)
        ids.append(i)
        dists.append(d)
    return torch.cat(ids), torch.cat(dists)
