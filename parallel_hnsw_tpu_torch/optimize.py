"""Search-based graph optimization: relinking + stochastic recall + improve loops
(counterpart of ``parallel_hnsw_tpu.optimize``).

Reference (src/lib.rs:1070-1686): every node self-searches the stack and
inserts itself into the rows of its best matches
(``link_nodes_in_layer_to_better_neighbors``, src/lib.rs:1084-1154);
*stochastic recall* — the fraction of sampled nodes that can find themselves —
is both the convergence criterion and the user-visible quality metric
(src/lib.rs:1463-1505); ``improve_neighbors_upto`` / ``improve_index[_at]``
loop until recall stops improving (src/lib.rs:1507-1686).

Relinking is one batched self-search (or brute-force match scan) of all N
nodes plus a lock-free segmented top-M row rebuild.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, ID_DTYPE
from parallel_hnsw_tpu_torch.graph import (
    Layer,
    Source,
    gather_features,
    node_to_vec,
    source_effective_width,
    source_get,
    vec_to_node,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric, batched_distance
from parallel_hnsw_tpu_torch.ops.segment import rebuild_rows
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw_tpu_torch.progress import ProgressMonitor, ensure_monitor
from parallel_hnsw_tpu_torch.search import search, search_stack
from parallel_hnsw_tpu_torch.utils.trace import TRACER

# Cap on the [N, D] feature slab a fast relink may materialize; layers larger
# than this fall back to blocked graph-search relinks.  Kept at the JAX
# package's value (to be measured again on the GPU).
FAST_RELINK_BYTE_BUDGET = 2 << 30


def _row_dists(nodes, neighbors_block, block_nodes, source: Source, metric: Metric):
    """Distances of each node in ``block_nodes`` to its current row (rows
    store ids only; the reference recomputes them, src/lib.rs:1128-1132)."""
    row_vecs = source_get(source, node_to_vec(nodes, neighbors_block))
    own = source_get(source, block_nodes)
    row_d = batched_distance(own, row_vecs, metric)
    return torch.where(neighbors_block != EMPTY_ID, row_d, EMPTY_DIST)


def _rebuild_with_matches(neighbors, row_d, match_nodes, match_d):
    """New rows = best-M of (current rows) ∪ (each node inserted into the rows
    of its matches); returns ``(new_neighbors, rows changed)``."""
    n, m = neighbors.shape
    own = torch.arange(n, dtype=ID_DTYPE, device=neighbors.device)[:, None]
    all_dst = torch.cat([own.expand(n, m).reshape(-1), match_nodes.reshape(-1)])
    all_src = torch.cat([neighbors.reshape(-1), own.expand_as(match_nodes).reshape(-1)])
    all_d = torch.cat([row_d.reshape(-1), match_d.reshape(-1)])
    new_neighbors, _ = rebuild_rows(n, m, all_dst, all_src, all_d)
    changed = int(torch.any(new_neighbors != neighbors, dim=-1).sum())
    return new_neighbors, changed


def _relink_layer_jit(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    sp: SearchParams,
    match_count: int,
):
    """Batched relink of the deepest layer of ``layers`` in one self-search
    (the JAX package jits this one).

    Equivalent to link_nodes_in_layer_to_better_neighbors (src/lib.rs:1084-1154):
    every node self-searches the stack (excluding itself), then inserts itself
    into the rows of its top ``match_count`` matches; rows keep their best M.
    """
    layer = layers[-1]
    nodes, neighbors = layer.nodes, layer.neighbors
    queries = source_get(source, nodes)
    res_ids, res_d = search_stack(layers, source, metric, queries, sp, exclude=nodes)[:2]
    match_nodes = vec_to_node(nodes, res_ids[:, :match_count])
    match_d = torch.where(match_nodes == EMPTY_ID, EMPTY_DIST, res_d[:, :match_count])
    row_d = _row_dists(nodes, neighbors, nodes, source, metric)
    return _rebuild_with_matches(neighbors, row_d, match_nodes, match_d)


def _relink_layer_blocked(
    layers: List[Layer],
    source: Source,
    metric: Metric,
    sp: SearchParams,
    match_count: int,
    node_block: int,
):
    """Memory-bounded relink for huge layers: self-search and row-distance
    recomputation run in node blocks; the lock-free row rebuild runs once."""
    layer = layers[-1]
    nodes, neighbors = layer.nodes, layer.neighbors
    n = nodes.shape[0]
    match_nodes_parts, match_d_parts, row_d_parts = [], [], []
    for start in range(0, n, node_block):
        stop = min(start + node_block, n)
        block_nodes = nodes[start:stop]
        queries = gather_features(source, block_nodes)
        res_ids, res_d = search(layers, source, metric, queries, sp, exclude=block_nodes)
        mn = vec_to_node(nodes, res_ids[:, :match_count])
        match_nodes_parts.append(mn)
        match_d_parts.append(torch.where(mn == EMPTY_ID, EMPTY_DIST, res_d[:, :match_count]))
        row_d_parts.append(_row_dists(nodes, neighbors[start:stop], block_nodes, source, metric))
    return _rebuild_with_matches(
        neighbors, torch.cat(row_d_parts), torch.cat(match_nodes_parts), torch.cat(match_d_parts)
    )


def _relink_layer_exact(
    layer: Layer,
    source: Source,
    metric: Metric,
    match_count: int,
    node_block: int,
    fast: bool = False,
):
    """Exact relink: matches are the true nearest neighbors within the layer,
    computed by blocked brute force (the pairwise-distance kernel) — strictly
    better edges than the reference's approximate matches.

    ``fast=True`` is the million-row tier (see blocked_topk_pairwise); match
    distances are full-precision either way."""
    from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise

    nodes, neighbors = layer.nodes, layer.neighbors
    n = neighbors.shape[0]
    feats = gather_features(source, nodes)
    match_nodes, match_d = blocked_topk_pairwise(
        feats, feats, metric, match_count, row_block=4096, exclude_diag_offset=0,
        fast=fast,
    )
    row_d = torch.cat([
        _row_dists(nodes, neighbors[s : s + node_block], nodes[s : s + node_block], source, metric)
        for s in range(0, n, node_block)
    ])
    return _rebuild_with_matches(neighbors, row_d, match_nodes, match_d)


def link_layer_to_better_neighbors(
    layers: List[Layer],
    layer_from_top: int,
    source: Source,
    metric: Metric,
    sp: SearchParams,
    node_block: int = 0,
    exact_threshold: int = 131072,
    fast_threshold: int = 2_000_000,
) -> Tuple[List[Layer], int, str]:
    """Relink one layer.  ``node_block`` 0 = auto from a byte budget on the
    [block, M, D] row gather.  Tiering: exact brute-force matches up to
    ``exact_threshold`` nodes, fast brute-force matches up to
    ``fast_threshold`` when the feature slab fits the byte budget, graph
    search beyond (blocked when the layer exceeds one node block).

    Returns ``(layers, changed, tier)``: the updated stack, the number of
    rows changed, and the tier taken (``"exact"``/``"fast"``/``"blocked"``/
    ``"jit"``).  The exact/fast tiers are **idempotent**: their match set is
    a pure function of (nodes, source), and a fixed-capacity best-m union is
    idempotent over a fixed added set, so re-running them on their own output
    changes nothing.  Callers use that to skip confirmation sweeps."""
    from parallel_hnsw_tpu_torch.build import _auto_node_block

    stack = layers[: layer_from_top + 1]
    layer = stack[-1]
    if node_block <= 0:
        node_block = _auto_node_block(layer.neighborhood_size, source.dim)
    # match_count = neighborhood size of the *index*, not of this layer
    # (reference: self.neighborhood_size(), src/lib.rs:1093)
    match_count = min(layer.neighborhood_size, sp.number_of_candidates)
    feat_bytes = layer.node_count * source_effective_width(source) * 4
    if 0 < layer.node_count <= exact_threshold:
        tier = "exact"
        new_neighbors, changed = _relink_layer_exact(layer, source, metric, match_count, node_block)
    elif (
        fast_threshold
        and 0 < layer.node_count <= fast_threshold
        and feat_bytes <= FAST_RELINK_BYTE_BUDGET
    ):
        tier = "fast"
        new_neighbors, changed = _relink_layer_exact(
            layer, source, metric, match_count, node_block, fast=True
        )
    elif layer.node_count > node_block:
        tier = "blocked"
        new_neighbors, changed = _relink_layer_blocked(
            stack, source, metric, sp, match_count, node_block
        )
    else:
        tier = "jit"
        new_neighbors, changed = _relink_layer_jit(stack, source, metric, sp, match_count)
    if changed == 0:  # identity-preserving: callers detect no-ops by id()
        return list(layers), 0, tier
    out = list(layers)
    out[layer_from_top] = Layer(nodes=layer.nodes, neighbors=new_neighbors)
    return out, changed, tier


def stochastic_recall_at(
    layers: Sequence[Layer],
    at: int,
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    seed: int = 42,
) -> float:
    """Sampled self-findability of layer ``at``-from-top's nodes via a full
    search (reference: stochastic_recall_at, src/lib.rs:1463-1499)."""
    layer = layers[at]
    total = layer.node_count
    selection = max(1, int(total * op.recall_proportion))
    if selection >= total:
        sample = layer.nodes
    else:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(total)[:selection]
        sample = layer.nodes[torch.as_tensor(idx, device=layer.nodes.device)]
    with TRACER.span("stochastic_recall", queries=float(selection), at=float(at)):
        queries = source_get(source, sample)
        ids, _ = search(list(layers), source, metric, queries, op.search)
        found = torch.any(ids == sample[:, None], dim=-1)
        return float(found.float().mean())


def stochastic_recall(
    layers: Sequence[Layer],
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    seed: int = 42,
) -> float:
    assert len(layers) > 0
    return stochastic_recall_at(layers, len(layers) - 1, source, metric, op, seed)


def improve_neighbors_upto(
    layers: List[Layer],
    upto: int,
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    last_recall: Optional[float] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    """Relink layers 0..upto until recall stops improving (reference:
    improve_neighbors_upto, src/lib.rs:1515-1544).  The monitor is polled
    once per relink sweep so a long repair is cancellable."""
    assert 1 <= upto <= len(layers)
    monitor = ensure_monitor(monitor)
    last = last_recall if last_recall is not None else 0.0
    # only recall values measured in THIS loop are known to describe the
    # current graph; the caller's value may predate a mutation
    have_measured = False
    improvement = 1.0
    while improvement >= op.neighborhood_threshold and last < 1.0:
        total_changed = 0
        all_idempotent = True
        for lft in range(upto):
            monitor.alive()
            with TRACER.span("relink_layer", layer_from_top=lft):
                layers, changed, tier = link_layer_to_better_neighbors(
                    layers, lft, source, metric, op.search,
                    exact_threshold=op.exact_relink_threshold,
                    fast_threshold=op.fast_relink_threshold,
                )
            total_changed += changed
            all_idempotent &= tier in ("exact", "fast")
            TRACER.count("relinked", rows=float(changed))
            if log:
                log(f"layer {lft}: relinked {changed} ({tier})")
        if total_changed == 0 and have_measured:
            # no row changed, so the (deterministic, seed-42) recall measure
            # would repeat ``last`` exactly — skip the redundant search
            break
        recall = stochastic_recall_at(layers, upto - 1, source, metric, op)
        improvement = recall - last
        last = recall
        have_measured = True
        if log:
            log(f"recall at {upto}/{len(layers)}: {recall} (improvement {improvement})")
        if all_idempotent:
            # every layer took an exact/fast relink, which is idempotent: a
            # second sweep changes no rows and the re-measure repeats
            # ``recall``, so the loop would exit with improvement 0
            break
    return layers, last


def improve_neighbors(
    layers: List[Layer],
    source: Source,
    metric: Metric,
    op: OptimizationParams,
    last_recall: Optional[float] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    return improve_neighbors_upto(
        layers, len(layers), source, metric, op, last_recall, monitor=monitor
    )


# A promoter callback has signature
#   promoter(layers, layer_from_top, bp) -> (layers, did_promote: bool)
Promoter = Callable[[List[Layer], int, BuildParams], Tuple[List[Layer], bool]]


def improve_index_at(
    layers: List[Layer],
    layer_from_top: int,
    bp: BuildParams,
    source: Source,
    metric: Metric,
    last_recall: Optional[float] = None,
    promoter: Optional[Promoter] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float, int]:
    """Reference: improve_index_at (src/lib.rs:1546-1603)."""
    op = bp.optimization
    monitor = ensure_monitor(monitor)
    recall = (
        last_recall
        if last_recall is not None
        else stochastic_recall_at(layers, layer_from_top, source, metric, op)
    )
    improvement = 1.0
    bailout = 1
    while improvement >= op.promotion_threshold and recall < 1.0 and bailout != 0:
        last = recall
        current = 0
        while current <= layer_from_top and bailout != 0:
            monitor.alive()
            layer_count = len(layers)
            layers, recall = improve_neighbors_upto(
                layers, current + 1, source, metric, op, None, log, monitor
            )
            if recall == 1.0:
                current += 1
                continue
            if promoter is not None:
                layers, promoted = promoter(layers, current, bp)
                if promoted:
                    delta = len(layers) - layer_count
                    assert delta >= 0
                    current += delta
                    layer_from_top += delta
                    layers, recall = improve_neighbors_upto(
                        layers, current + 1, source, metric, op, recall, log, monitor
                    )
            current += 1
        bailout -= 1
        improvement = recall - last
    return layers, recall, layer_from_top


def improve_index(
    layers: List[Layer],
    bp: BuildParams,
    source: Source,
    metric: Metric,
    last_recall: Optional[float] = None,
    promoter: Optional[Promoter] = None,
    log: Optional[Callable[[str], None]] = None,
    monitor: Optional[ProgressMonitor] = None,
) -> Tuple[List[Layer], float]:
    """Reference: improve_index (src/lib.rs:1664-1686), without the
    reference's eager recall measure, whose value is never used (the first
    ``improve_index_at`` measures lazily; control flow is identical)."""
    monitor = ensure_monitor(monitor)
    assert len(layers) > 0
    recall = last_recall if last_recall is not None else 0.0
    layer_from_top = 0
    while layer_from_top < len(layers):
        monitor.alive()
        layers, recall, layer_from_top = improve_index_at(
            layers, layer_from_top, bp, source, metric, None, promoter, log, monitor
        )
        layer_from_top += 1
    return layers, recall
