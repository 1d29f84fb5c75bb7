"""Structural self-repair: unreachable discovery, promotion, layer extension
(counterpart of ``parallel_hnsw_tpu.promote``).

Reference (src/lib.rs:1002-1427): nodes that cannot find themselves by search
("unreachable", src/lib.rs:1002-1037) are promoted into higher layers —
either by extending existing layers with an index remap (``extend_layer``,
src/lib.rs:1039-1068) or by regenerating a new top stack
(``promote_at_layer``, src/lib.rs:1273-1427).  Candidate selection histograms
unreachables' neighbors and greedily picks high-count nodes not covered by an
already-picked node's hypersphere (src/lib.rs:1176-1271).

The heavy phases (self-search of every node, radius searches, pairwise cover
distances) run on the device; the small combinatorial ladder/splice logic
stays on the host in numpy.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.build import calculate_partitions_from_bottom
from parallel_hnsw_tpu_torch.constants import EMPTY_ID, ID_DTYPE, MATCH_EPSILON
from parallel_hnsw_tpu_torch.graph import Layer, Source, source_get
from parallel_hnsw_tpu_torch.ops.distance import Metric, pairwise_distance
from parallel_hnsw_tpu_torch.params import BuildParams, SearchParams
from parallel_hnsw_tpu_torch.progress import ensure_monitor
from parallel_hnsw_tpu_torch.search import search
from parallel_hnsw_tpu_torch.utils.trace import TRACER


def match_within_epsilon(ids: np.ndarray, dists: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Batched reference semantics (src/search.rs:173-187): target found among
    results whose distance is < epsilon (results are sorted ascending)."""
    return np.any((ids == targets[:, None]) & (np.abs(dists) < MATCH_EPSILON), axis=-1)


def _ids_tensor(vecs: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vecs), dtype=ID_DTYPE, device=device)


def discover_unreachable_vectors(
    layers: Sequence[Layer],
    layer_id_from_top: int,
    source: Source,
    metric: Metric,
    sp: SearchParams,
    query_block: int = 0,
) -> np.ndarray:
    """Vector ids in layer ``layer_id_from_top`` that cannot find themselves
    searching the sub-stack, and are not in the layer above
    (reference: src/lib.rs:1002-1037)."""
    stack = list(layers[: layer_id_from_top + 1])
    layer = stack[-1]
    nodes = layer.nodes.cpu().numpy()
    queries = source_get(source, layer.nodes)
    ids, dists = search(stack, source, metric, queries, sp, query_block=query_block)
    found = match_within_epsilon(ids.cpu().numpy(), dists.cpu().numpy(), nodes)
    if layer_id_from_top > 0:
        above = layers[layer_id_from_top - 1].nodes.cpu().numpy()
        in_above = np.isin(nodes, above)
    else:
        in_above = np.zeros_like(found)
    return nodes[~found & ~in_above]


def _discover_orders_from_top(layers: Sequence[Layer], vecs: np.ndarray) -> np.ndarray:
    """For each vector id, the index of the topmost layer containing it."""
    orders = np.full(len(vecs), -1, dtype=np.int64)
    for i, l in enumerate(layers):
        nodes = l.nodes.cpu().numpy()
        pos = np.searchsorted(nodes, vecs)
        found = (pos < len(nodes)) & (nodes[np.clip(pos, 0, len(nodes) - 1)] == vecs)
        orders = np.where((orders < 0) & found, i, orders)
    if np.any(orders < 0):
        missing = vecs[orders < 0]
        raise ValueError(f"vector {missing[0]} does not exist in hnsw")
    return orders


def filter_promotion_candidates(
    layers: Sequence[Layer],
    layer_from_top: int,
    vecs: np.ndarray,
    source: Source,
    metric: Metric,
    sp: SearchParams,
) -> List[Tuple[int, np.ndarray]]:
    """Histogram + greedy hypersphere cover (reference: src/lib.rs:1176-1271)."""
    if layer_from_top == 0:
        return []
    device = source.device
    vecs = np.sort(np.asarray(vecs))
    orders = _discover_orders_from_top(layers, vecs)

    result: List[Tuple[int, np.ndarray]] = []
    for order in np.unique(orders):
        order = int(order)
        if order == 0:
            continue
        sel = vecs[orders == order]
        layer = layers[order]
        nodes = layer.nodes.cpu().numpy()
        node_idx = np.searchsorted(nodes, sel)
        rows = layer.neighbors.cpu().numpy()[node_idx]  # [k, M]
        flat = rows[rows != EMPTY_ID]
        # count only neighbors that are themselves unreachable (vecs is sorted)
        counted = flat[np.isin(nodes[flat], vecs)]
        uniq, counts = np.unique(counted, return_counts=True)
        # pop-highest-count-first, node id breaking ties (deterministic)
        cand_nodes = uniq[np.lexsort((uniq, -counts))]
        cand_vecs = nodes[cand_nodes].astype(np.int64)
        if len(cand_vecs) == 0:
            result.append((order, cand_vecs))
            continue

        # batched radius search: nearest distance in the stack above
        # (reference: search_upto + result[0].1, src/lib.rs:1255-1260)
        cand_feats = source_get(source, _ids_tensor(cand_vecs, device))
        _, r_dists = search(list(layers[:layer_from_top]), source, metric, cand_feats, sp)
        radii = r_dists[:, 0].cpu().numpy()

        # greedy hypersphere cover, blocked: one [picked_so_far, B] cross
        # block + one [B, B] in-block matrix per column block
        picked: List[int] = []
        block = 4096
        k_cand = len(cand_vecs)
        for bs in range(0, k_cand, block):
            be = min(bs + block, k_cand)
            feats_b = cand_feats[bs:be]
            in_block = pairwise_distance(feats_b, feats_b, metric).cpu().numpy()
            prior = np.asarray(picked, dtype=np.int64)  # all < bs by construction
            if prior.size:
                prior_feats = cand_feats[torch.as_tensor(prior, device=device)]
                cross = pairwise_distance(prior_feats, feats_b, metric).cpu().numpy()
                prior_radii = radii[prior]
            block_picks: List[int] = []
            for bi in range(be - bs):
                if prior.size and bool(np.any(cross[:, bi] < prior_radii)):
                    continue
                if block_picks and bool(
                    np.any(
                        in_block[np.asarray(block_picks), bi]
                        < radii[bs + np.asarray(block_picks)]
                    )
                ):
                    continue
                block_picks.append(bi)
            picked.extend(bs + b for b in block_picks)
        result.append((order, cand_vecs[picked]))
    return result


def extend_layer(layers: List[Layer], layer_id: int, vecs: np.ndarray) -> List[Layer]:
    """Insert vectors into an existing layer by sorted-merge index remap
    (reference: extend_layer + generate_node_maps, src/lib.rs:1039-1068,
    1727-1812).  ``layer_id`` counts from the *bottom* like the reference."""
    layer_id_from_top = len(layers) - layer_id - 1
    layer = layers[layer_id_from_top]
    old_nodes = layer.nodes.cpu().numpy()
    vecs = np.sort(np.asarray(vecs))
    if len(vecs) == 0:
        return layers
    if np.intersect1d(old_nodes, vecs).size:
        raise ValueError("tried to insert vector that already exists in this layer")

    new_nodes = np.sort(np.concatenate([old_nodes, vecs]))
    old_pos = np.searchsorted(new_nodes, old_nodes)  # old node id -> new node id

    old_neighbors = layer.neighbors.cpu().numpy()
    n_new, m = len(new_nodes), old_neighbors.shape[1]
    remapped = np.where(
        old_neighbors != EMPTY_ID,
        np.take(old_pos, np.clip(old_neighbors, 0, len(old_nodes) - 1)),
        EMPTY_ID,
    ).astype(np.int32)
    new_neighbors = np.full((n_new, m), EMPTY_ID, dtype=np.int32)
    new_neighbors[old_pos] = remapped

    device = layer.nodes.device
    out = list(layers)
    out[layer_id_from_top] = Layer(
        nodes=_ids_tensor(new_nodes, device), neighbors=_ids_tensor(new_neighbors, device)
    )
    return out


# generate_fn(vector_ids, bp) -> List[Layer]; provided by the index layer to
# regenerate top stacks (the reference recursively calls Hnsw::generate,
# src/lib.rs:1319,1382).
GenerateFn = Callable[[np.ndarray, BuildParams], List[Layer]]


def promote_at_layer(
    layers: List[Layer],
    layer_from_top: int,
    bp: BuildParams,
    source: Source,
    metric: Metric,
    generate_fn: GenerateFn,
    log: Optional[Callable[[str], None]] = None,
    monitor=None,
) -> Tuple[List[Layer], bool]:
    """Reference: promote_at_layer (src/lib.rs:1273-1427); the monitor is
    polled between phases (reference threads it, src/lib.rs:1276)."""
    monitor = ensure_monitor(monitor)
    say = log or (lambda s: None)
    monitor.alive()
    with TRACER.span("discover_unreachable", layer_from_top=float(layer_from_top)):
        vecs = discover_unreachable_vectors(
            layers, layer_from_top, source, metric, bp.optimization.search
        )
    if len(vecs) == 0:
        return layers, False
    max_proportion = bp.optimization.promotion_proportion
    if max_proportion < 1.0:
        vecs = vecs[: int(len(vecs) * max_proportion)]
        if len(vecs) == 0:
            return layers, False
    say(f"promoting {len(vecs)} unreachable vectors at layer_from_top={layer_from_top}")

    monitor.alive()
    order_vecs = filter_promotion_candidates(
        layers, layer_from_top, vecs, source, metric, bp.optimization.search
    )
    for order, ovecs in order_vecs:
        if len(ovecs) == 0:
            continue
        monitor.alive()
        say(f"promotion of {len(ovecs)} vecs into order {order}")
        # sizes of the stack strictly above the order layer, bottom-first
        sizes = [l.node_count for l in layers[:order]]
        sizes.reverse()
        new_sizes = calculate_partitions_from_bottom(sizes[0] + len(ovecs), bp.order)
        if len(new_sizes) < len(sizes):
            new_sizes.extend([0] * (len(sizes) - len(new_sizes)))
        retop_upto = len(new_sizes) - len(sizes)
        new_sizes = new_sizes[: len(sizes)]
        promotion_sizes = [max(0, s1 - s2) for s1, s2 in zip(new_sizes, sizes)]

        if retop_upto != 0:
            # the ladder grew: regenerate a whole new top stack including some
            # promotions (reference: src/lib.rs:1360-1399)
            retop_index = len(promotion_sizes) - retop_upto
            promotion_into_top = promotion_sizes[retop_index]
            promotion_sizes = promotion_sizes[:retop_index]
            top_vecs = layers[retop_upto - 1].nodes.cpu().numpy()
            top_vecs = np.unique(np.concatenate([top_vecs, ovecs[:promotion_into_top]]))
            new_bp = bp.replace(zero_layer_neighborhood_size=bp.neighborhood_size)
            new_top = generate_fn(top_vecs, new_bp)
            say(f"generated {len(new_top)} new top layers (and extending)")
            layers = list(new_top) + list(layers[retop_upto:])
            offset = len(new_top)
        else:
            offset = 0

        promotion_sizes.reverse()
        for i, size in enumerate(promotion_sizes):
            current_lft = offset + i
            layer_nodes = layers[current_lft].nodes.cpu().numpy()
            candidates = ovecs[~np.isin(ovecs, layer_nodes)][:size]
            if len(candidates) == 0:
                continue
            current_from_bottom = len(layers) - current_lft - 1
            layers = extend_layer(layers, current_from_bottom, np.asarray(candidates))
    return layers, True
